"""The port's training ops against the JAX package's: the dropout hashes,
masking, mixup, losses, confusion counts, the learning-rate schedule and the
optimizer, and the finetune recipe preset.

Inputs come from numpy seeds and go to both sides. Hash masks are compared
bit for bit; fp32 ops within 1e-6 (the same math in another summation
order) unless a test states otherwise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from animal2vec_tpu.config import OptimizationConfig, load_config
from animal2vec_tpu.ops import losses as jax_losses, masking as jax_masking
from animal2vec_tpu.ops import mixup as jax_mixup, stats as jax_stats
from animal2vec_tpu.ops.fused_mlp import _hash_keep
from animal2vec_tpu.ops.pallas_attention import _dropout_keep
from animal2vec_tpu.train import optim as jax_optim

from animal2vec_tpu_torch.config import FinetuneTrainConfig
from animal2vec_tpu_torch.config import OptimizationConfig as PortOptimizationConfig
from animal2vec_tpu_torch.ops import losses, masking, mixup, stats
from animal2vec_tpu_torch.ops.dropout import Rngs, dropout_keep, hash_keep, keep_threshold
from animal2vec_tpu_torch.train import optim
from animal2vec_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- hashes


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_hash_masks_match_jax_bit_for_bit(rate):
    rng = np.random.default_rng(int(rate * 10))
    seeds = [int(s) for s in rng.integers(-(2**31), 2**31, size=6)] + [-1, 0, 2**31 - 1]
    rows = rng.integers(0, 2**16, size=(64, 1)).astype(np.int32)
    cols = rng.integers(0, 2**16, size=(1, 96)).astype(np.int32)
    for seed in seeds:
        bh = int(rng.integers(0, 512))
        ours = dropout_keep(seed, bh, torch.from_numpy(rows), torch.from_numpy(cols), rate)
        ref = _dropout_keep(jnp.asarray(seed, jnp.int32), jnp.asarray(bh, jnp.int32),
                            jnp.asarray(rows), jnp.asarray(cols), rate)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        ours = hash_keep(seed, torch.from_numpy(rows), torch.from_numpy(cols), rate)
        ref = _hash_keep(jnp.asarray(seed, jnp.int32), jnp.asarray(rows), jnp.asarray(cols), rate)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert abs(float(ours.mean()) - (1 - rate)) < 0.03


def test_keep_threshold_is_the_host_integer():
    for rate in (0.0, 0.1, 0.2, 0.5, 1.0 - 2**-40):
        assert keep_threshold(rate) == min(int(rate * 4294967296.0), 4294967295)
    assert keep_threshold(0.1) == 429496729


def test_rngs_int32_seeds_are_reproducible():
    a = Rngs.from_seed(3, "cpu").int32_seeds(5)
    b = Rngs.from_seed(3, "cpu").int32_seeds(5)
    assert a == b and all(-(2**31) <= s < 2**31 for s in a)


# --------------------------------------------------------------- masking


@pytest.mark.parametrize("t,p,l", [(2000, 0.825, 4), (1024, 0.5, 64), (200, 0.65, 10), (37, 1.5, 2)])
def test_expected_span_mask_tokens_matches_jax(t, p, l):
    assert masking.expected_span_mask_tokens(t, p, l) == jax_masking.expected_span_mask_tokens(t, p, l)


@pytest.mark.parametrize("b,t,p,l", [(4, 2000, 0.825, 4), (3, 1024, 0.5, 64), (2, 300, 0.2, 5)])
def test_span_mask_counts_and_spans(b, t, p, l):
    gen = torch.Generator().manual_seed(b)
    mask = masking.span_mask(b, t, p, l, gen)
    m = masking.expected_span_mask_tokens(t, p, l)
    assert mask.dtype == torch.int32 and mask.shape == (b, t)
    assert (mask.sum(dim=1) == m).all()
    # the span union before the exact-count adjustment, from the same draws
    gen = torch.Generator().manual_seed(b)
    n_spans = max(1, min(int(p * t / l + 0.5), t - l + 1))
    starts = torch.argsort(torch.rand((b, t - l + 1), generator=gen), dim=1)[:, :n_spans]
    union = torch.zeros((b, t), dtype=torch.int32)
    for s in range(l):
        union.scatter_(1, starts + s, 1)
    for row, u in zip(mask, union):
        # the adjustment keeps span tokens first: a subset of the union when
        # the union has M or more tokens, a superset otherwise
        if int(u.sum()) >= m:
            assert int((row * (1 - u)).sum()) == 0
        else:
            assert int((u * (1 - row)).sum()) == 0


def test_channel_mask_counts():
    gen = torch.Generator().manual_seed(9)
    cmask = masking.channel_mask(4, 1024, 0.5, 64, gen)
    assert (cmask.sum(dim=1) == masking.expected_span_mask_tokens(1024, 0.5, 64)).all()


def test_apply_mask_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 50, 8)).astype(np.float32)
    mask = (rng.random((3, 50)) < 0.4).astype(np.int32)
    info = jax_masking.MaskInfo(jnp.asarray(mask), None, None, None)
    ref = jax_masking.apply_mask(jnp.asarray(x), info, zero_mask=True)
    ours = masking.apply_mask(torch.from_numpy(x), torch.from_numpy(mask), zero_mask=True)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # noise fill: unmasked rows untouched, masked ones N(0, noise_std^2)
    gen = torch.Generator().manual_seed(1)
    x = torch.ones((8, 500, 64))
    mask = torch.from_numpy((rng.random((8, 500)) < 0.8).astype(np.int32))
    out = masking.apply_mask(x, mask, zero_mask=False, noise_std=0.01, generator=gen)
    keep = mask == 0
    assert torch.equal(out[keep], x[keep])
    noise = out[~keep]
    assert abs(float(noise.mean())) < 5e-4 and abs(float(noise.std()) - 0.01) < 2e-4


# ----------------------------------------------------------------- mixup


@pytest.mark.parametrize("mode", ["A_weighting", "RMSE"])
def test_compute_gain_matches_jax(mode):
    sound = np.random.default_rng(6).normal(size=(3, 8000)).astype(np.float32) * 0.3
    ours = mixup.compute_gain(torch.from_numpy(sound), 8000, 0.05, mode=mode)
    ref = jax_mixup.compute_gain(jnp.asarray(sound), 8000, 0.05, mode=mode)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-4)  # dB


@pytest.mark.parametrize("gain_mode,same,prob", [("A_weighting", True, 1.0),
                                                 ("naive_rms", False, 0.5)])
def test_bc_mixup_core_matches_jax_draws(gain_mode, same, prob):
    rng = np.random.default_rng(7)
    b = 6
    src = (rng.normal(size=(b, 8000)) * rng.uniform(0.05, 1.0, size=(b, 1))).astype(np.float32)
    tgt = (rng.random((b, 200, 4)) < 0.1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    args = (0.5, prob, same, gain_mode, 8000, 0.05, True)
    mixed_j, tgt_j = jax_mixup.bc_mixup(key, jnp.asarray(src), jnp.asarray(tgt), *args)
    # the draws bc_mixup makes (mixup.py:90-102)
    k_mask, k_r, k_perm = jax.random.split(key, 3)
    mix_mask = (np.ones((b,), bool) if prob >= 1
                else np.array(jax.random.bernoulli(k_mask, prob, (b,))))
    r = np.array(jax.random.uniform(k_r, (1,) if same else (b,), minval=0.5, maxval=1.0))
    perm = np.array(jax.random.permutation(k_perm, b))
    mixed, tgt_o = mixup.bc_mixup_core(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(perm),
        torch.from_numpy(r), torch.from_numpy(mix_mask), gain_mode, 8000, 0.05, True,
    )
    np.testing.assert_allclose(mixed.numpy(), np.asarray(mixed_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgt_o.numpy(), np.asarray(tgt_j), rtol=0, atol=1e-6)


def test_bc_mixup_draws_on_the_host_generator():
    src = torch.randn((4, 4000), generator=torch.Generator().manual_seed(0))
    a = mixup.bc_mixup(src, None, 0.5, 1.0, True, "A_weighting", 8000, 0.05, False,
                       torch.Generator().manual_seed(2))[0]
    b = mixup.bc_mixup(src, None, 0.5, 1.0, True, "A_weighting", 8000, 0.05, False,
                       torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, src)


# ------------------------------------------------------- losses, metrics


def test_losses_and_confusion_counts_match_jax():
    rng = np.random.default_rng(8)
    logits = (rng.normal(size=(2, 50, 5)) * 3).astype(np.float32)
    targets = (rng.random((2, 50, 5)) < 0.3).astype(np.float32)
    ours = losses.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    ref = jax_losses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    cls = rng.integers(0, 5, size=(100,))
    for eps in (0.0, 0.09):
        for red in ("sum", "none"):
            ours = losses.label_smoothed_nll_loss(torch.from_numpy(logits.reshape(100, 5)),
                                                  torch.from_numpy(cls), eps, red)
            ref = jax_losses.label_smoothed_nll_loss(jnp.asarray(logits.reshape(100, 5)),
                                                     jnp.asarray(cls), eps, red)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    preds = (rng.random((2, 50, 5)) < 0.5).astype(np.int32)
    w = (rng.random((2, 50, 1)) < 0.8).astype(np.float32)
    for weights in (None, w):
        ours = stats.confusion_counts(torch.from_numpy(preds), torch.from_numpy(targets),
                                      None if weights is None else torch.from_numpy(weights))
        ref = jax_stats.confusion_counts(jnp.asarray(preds), jnp.asarray(targets),
                                         None if weights is None else jnp.asarray(weights))
        assert [float(v) for v in ours] == [float(v) for v in ref]


# ------------------------------------------------ optimizer and schedule


def _opt_cfgs(**kw):
    common = dict(lr=3e-4, max_update=1000, warmup_updates=100, warmup_init_lr=1e-7,
                  min_lr=2e-5, adam_betas=(0.9, 0.98), adam_eps=1e-6, clip_norm=0.0,
                  weight_decay=0.0, update_freq=1)
    common.update(kw)
    ours = PortOptimizationConfig(**common)
    ref = OptimizationConfig(**common)
    return ours, ref


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_optax(schedule):
    ours, ref = _opt_cfgs(schedule=schedule)
    sched_o, sched_j = optim.build_lr_schedule(ours), jax_optim.build_lr_schedule(ref)
    for step in (0, 1, 99, 100, 550, 1000, 1200):
        assert abs(sched_o(step) - float(sched_j(step))) <= 1e-6 * ours.lr, step


def _jax_params(rng):
    """A small JAX FinetuneModel-shaped tree: two stacked prenet layers,
    three trunk layers, a frontend leaf, the ALiBi scale and the head."""
    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "encoder": {
            "audio_encoder": {
                "context_encoder": {"blocks": {"block": {
                    "mlp": {"fc1": {"kernel": r(2, 4, 6), "bias": r(2, 6)}},
                    "norm1": {"scale": r(2, 4), "bias": r(2, 4)},
                }}},
                "alibi_scale": r(1, 1, 2, 1, 1),
                "project_linear": {"kernel": r(3, 4), "bias": r(4)},
            },
            "blocks": {"block": {"attn": {"qkv": {"kernel": r(3, 4, 12), "bias": r(3, 12)}}}},
        },
        "proj": {"kernel": r(4, 5), "bias": r(5)},
    }


def _run_both(cfg_o, cfg_j, grads_per_step, params, layer_decay, drop_none=()):
    """Apply the given JAX-layout grads for several steps with optax and with
    the port's optimizer; ``drop_none`` names port params whose .grad stays
    None wherever their grad is all zero (the gate-closed and layerdrop
    case). Returns (port state dict, JAX params as a port state dict)."""
    scales = jax_optim.layer_decay_scales(
        params, layer_decay, ("encoder", "audio_encoder", "context_encoder", "blocks", "block"),
        ("encoder", "blocks", "block"), 2, 3,
    ) if layer_decay < 1 else None
    tx, _ = jax_optim.build_optimizer(cfg_j, params, layer_scales=scales)
    state = tx.init(params)
    p_j = params
    named = [(n, torch.nn.Parameter(t)) for n, t in params_from_jax(params).items()]
    opt = optim.OptaxAdam(
        named, cfg_o.adam_betas, cfg_o.adam_eps, cfg_o.weight_decay,
        optim.decay_mask(named),
        optim.layer_decay_scales([n for n, _ in named], layer_decay, 2, 3), cfg_o.clip_norm,
    )
    sched = optim.build_lr_schedule(cfg_o)
    for step, g in enumerate(grads_per_step):
        upd, state = tx.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        g_port = params_from_jax(g)
        for n, p in named:
            p.grad = None if (n in drop_none and not g_port[n].any()) else g_port[n].clone()
        opt.step(sched(step))
    return {n: p.detach() for n, p in named}, params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_optimizer_matches_optax(clip):
    rng = np.random.default_rng(12)
    params = _jax_params(rng)
    cfg_o, cfg_j = _opt_cfgs(weight_decay=0.05, clip_norm=clip, warmup_updates=1,
                             warmup_init_lr=1e-4)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                    params) for _ in range(3)]
    ours, ref = _run_both(cfg_o, cfg_j, grads, params, layer_decay=0.75)
    assert ours.keys() == ref.keys()
    for n in ref:
        np.testing.assert_allclose(ours[n].numpy(), ref[n].numpy(), rtol=0, atol=1e-6, err_msg=n)


def test_optimizer_zero_grad_trap():
    """A parameter with no gradient for three steps (a closed gate, or a
    layer dropped by layerdrop), then one: optax keeps one global Adam count
    and decays its moments meanwhile. The port must give the same params
    though that parameter's .grad is None in the first steps."""
    rng = np.random.default_rng(13)
    params = _jax_params(rng)
    cfg_o, cfg_j = _opt_cfgs(warmup_updates=1, warmup_init_lr=1e-4, weight_decay=0.01)
    frozen = "encoder.blocks.layers.1.attn.qkv.weight"
    grads = []
    for step in range(5):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        if step < 3:  # every trunk layer of the stacked leaf: no gradient
            g["encoder"]["blocks"]["block"]["attn"]["qkv"]["kernel"] *= 0
        grads.append(g)
    ours, ref = _run_both(cfg_o, cfg_j, grads, params, layer_decay=1.0,
                          drop_none=(frozen, frozen.replace(".1.", ".0."),
                                     frozen.replace(".1.", ".2.")))
    for n in ref:
        np.testing.assert_allclose(ours[n].numpy(), ref[n].numpy(), rtol=0, atol=1e-6, err_msg=n)
    # a per-parameter Adam count (torch.optim.Adam) would differ
    assert not np.allclose(ref[frozen].numpy(), params_from_jax(params)[frozen].numpy(), atol=1e-7)


def test_decay_mask_and_layer_scales():
    named = [("encoder.blocks.layers.2.mlp.fc1.weight", torch.ones(4, 4)),
             ("encoder.blocks.layers.2.mlp.fc1.bias", torch.ones(4)),
             ("encoder.audio_encoder.alibi_scale", torch.ones(1, 1, 2, 1, 1)),
             ("encoder.audio_encoder.local_encoder.act_0.p_swish_alpha", torch.ones(4)),
             ("encoder.audio_encoder.context_encoder.blocks.layers.0.norm1.weight", torch.ones(4)),
             ("proj.weight", torch.ones(4, 4))]
    assert list(optim.decay_mask(named).values()) == [True, False, False, False, False, True]
    scales = optim.layer_decay_scales([n for n, _ in named], 0.5, 2, 3)
    # 6 layers + 1: trunk layer 2 is layer id 5, prenet layer 0 is id 1
    assert scales["encoder.blocks.layers.2.mlp.fc1.weight"] == 0.5 ** 1
    assert scales["encoder.audio_encoder.context_encoder.blocks.layers.0.norm1.weight"] == 0.5 ** 5
    assert scales["proj.weight"] == 1.0
    assert optim.layer_decay_scales(["a"], 1.0, 2, 3) is None


# ----------------------------------------------------------- the recipe


def test_train_preset_matches_finetune_100_yaml():
    jcfg = load_config(os.path.join(REPO, "animal2vec_tpu/configs/finetune_100.yaml"))
    ft, opt, crit = jcfg.finetune, jcfg.optimization, jcfg.criterion
    mix = ft.mixup
    expected = {
        "freeze_finetune_updates": ft.freeze_finetune_updates,
        "feature_grad_mult": ft.feature_grad_mult, "apply_mask": ft.apply_mask,
        "mask_prob": ft.mask_prob, "mask_length": ft.mask_length,
        "mask_channel_prob": ft.mask_channel_prob, "mask_channel_length": ft.mask_channel_length,
        "zero_mask": ft.zero_mask, "mask_noise_std": jcfg.model.modalities.audio.mask_noise_std,
        "layer_decay": ft.layer_decay, "dropout": ft.dropout, "dropout_input": ft.dropout_input,
        "activation_dropout": ft.activation_dropout, "attention_dropout": ft.attention_dropout,
        "final_dropout": ft.final_dropout, "layerdrop": ft.layerdrop, "drop_path": ft.drop_path,
        "update_alibi": ft.update_alibi, "load_ema": ft.load_ema,
        "load_pretrain_weights": ft.load_pretrain_weights,
        "source_mixup": mix.source_mixup, "mixup_prob": mix.mixup_prob,
        "same_mixup": mix.same_mixup, "mixing_window_length": mix.mixing_window_length,
        "gain_mode": mix.gain_mode, "target_mixup": mix.target_mixup,
        "use_focal_loss": crit.use_focal_loss, "label_smoothing": crit.label_smoothing,
        "report_accuracy": crit.report_accuracy,
    }
    ours = FinetuneTrainConfig()
    assert set(expected) | {"optimization"} == {f.name for f in dataclasses.fields(ours)}
    for name, value in expected.items():
        assert getattr(ours, name) == value, name
    for f in dataclasses.fields(PortOptimizationConfig):
        want = getattr(opt, f.name)
        assert getattr(ours.optimization, f.name) == (tuple(want) if f.name == "adam_betas"
                                                      else want), f.name
    assert ft.sample_rate == jcfg.task.sample_rate
    # drop-path is ported; update_alibi=False is refused (JAX reads it nowhere)
    assert FinetuneTrainConfig(drop_path=0.1).drop_path == 0.1
    with pytest.raises(NotImplementedError, match="reads nowhere"):
        FinetuneTrainConfig(update_alibi=False)
