"""The port's pretraining options against the JAX package's ``pretrain_loss``.

The tiny audio and image models of ``tests/test_torch_pretrain_step.py``
(2 prenet + 3 trunk blocks at width 128, or 1 + 2 over 32 x 32 images in
8 x 8 patches), from the same jittered params, one mask injected on both
sides (the JAX samplers monkeypatched), each option group switched on on
both sides: the linear probe, the shared decoder and the decoders'
projection heads, each target norm, ``end_of_block_targets``,
``keep_masked_pct``, ``mask_dropout``, ``encoder_zero_mask`` False,
``local_grad_mult``, ``d2v_loss`` with ``criterion.loss_weights``, and the
image reconstruction with the inverse mask. ``jax.random`` and torch draw
differently, so where an option draws (the encoder's noise fill, BC mixup
of sources and labels) both sides are handed the same draws; the decoders'
mask tokens and every dropout are 0.

Tolerances (``test_torch_pretrain_step``'s): the loss, every loss term and
every variance metric within 1e-5 (``LOSS_TOL``), the probe's confusion
counts exactly, every gradient within 1e-5 of the largest |gradient| of its
tensor (``GRAD_TOL``; fp32 sums over a few hundred rows in another order).

Beside it: the mask samplers bit for bit on the same draws
(``keep_masked_pct``, ``mask_dropout``, ``mask_prob_adjust``,
``inverse_mask``), the JAX <-> port weight round trips and the fairseq
converter with the new parameters, the probe's handoff into finetuning,
and what JAX does where the port refuses: the label-smoothed probe, extra
tokens in a finetune model; and that JAX's audio loss ignores
``inverse_mask``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import animal2vec_tpu.models.data2vec2 as jax_d2v
import animal2vec_tpu.ops as jax_ops
import animal2vec_tpu.ops.masking as jax_masking
import animal2vec_tpu.ops.mixup as jax_mixup_mod
import animal2vec_tpu.train.pretrain as jax_pretrain
from animal2vec_tpu.config import DecoderConfig as JaxDecoderConfig, MixupConfig, resolve
from animal2vec_tpu.train.build import (
    build_pretrain_model as jax_build_pretrain_model,
    load_pretrained_into_finetune as jax_load_pretrained_into_finetune,
)
from animal2vec_tpu.train.convert import export_pretrain as jax_export_pretrain
from animal2vec_tpu.train.state import ema_subset as jax_ema_subset

import animal2vec_tpu_torch.models.data2vec2 as port_d2v
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.finetune import init_params, pretrain_rates
import animal2vec_tpu_torch.train.pretrain as port_pretrain
from animal2vec_tpu_torch.config import (
    DecoderConfig, FinetuneConfig, FinetuneTrainConfig, PretrainConfig, RunConfig, TaskConfig,
)
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.ops.masking import (
    block_mask_2d, expected_span_mask_tokens, make_mask_info_static, span_mask,
)
from animal2vec_tpu_torch.ops.mixup import bc_mixup_core
from animal2vec_tpu_torch.recipes import RECIPES, load_config
from animal2vec_tpu_torch.train.build import load_pretrained_into_finetune
from animal2vec_tpu_torch.train.convert import export_pretrain, pretrain_state_dicts
from animal2vec_tpu_torch.train.pretrain import mask_tokens, pretrain_loss
from animal2vec_tpu_torch.train.state import PretrainState
from animal2vec_tpu_torch.weights import params_from_jax, params_to_jax

from tests.test_torch_model import TINY, _jittered
from tests.test_torch_pretrain_step import DEC, IMAGE, LOSS_TOL, _jax_cfg, _mask, _port_cfg, _source

GRAD_TOL = 1e-5
LABELS = ("a", "b", "c")
T = {"AUDIO": 200, "IMAGE": 16}
SHARED = dict(DEC, decoder_dim=24, decoder_groups=4, decoder_kernel=5)
PROBE = dict(with_labels=True, final_dropout=0.0, metric_threshold=0.3)


def _jax_options(modality, model_kw=None, modality_kw=None, probe=False, focal=True,
                 loss_weights=None):
    """``_both``'s JAX keyword changes, and a function that finishes the
    JAX config (labels, the probe's loss, ``criterion.loss_weights``)."""
    def finish(cfg):
        if probe:
            cfg.task.with_labels = True
            cfg.task.unique_labels = repr(list(LABELS))
            cfg.criterion.use_focal_loss = focal
            cfg.model.metric_threshold = PROBE["metric_threshold"]
        cfg.criterion.loss_weights = loss_weights
        return resolve(cfg)
    return dict(model_kw=model_kw or {}, modality_kw=modality_kw or {}), finish


# group -> (modality, JAX ModelConfig changes, JAX modality changes, port
# PretrainConfig changes, port encoder changes, extra: probe / mixup / noise
# / criterion.loss_weights)
GROUPS = {
    "probe focal, target mixup, d2v loss and loss weights": (
        "AUDIO", dict(mixup=MixupConfig(source_mixup=0.5, mixup_prob=1.0, target_mixup=True,
                                        mixing_window_length=0.05), d2v_loss=0.7), {},
        dict(PROBE, target_mixup=True, source_mixup=0.5, mixup_prob=1.0, d2v_loss=0.7,
             loss_weights=(("AUDIO_regression", 0.4), ("linear_eval_loss", 2.5))),
        dict(labels=LABELS), dict(probe=True, mixup=True, loss_weights={
            "AUDIO_regression": 0.4, "linear_eval_loss": 2.5})),
    "shared decoder and projection heads, probe": (
        "AUDIO", dict(shared_decoder=JaxDecoderConfig(**SHARED, projection_layers=2)),
        dict(decoder=JaxDecoderConfig(**DEC, projection_layers=3, projection_ratio=1.5)),
        dict(PROBE, shared_decoder=DecoderConfig(**SHARED, projection_layers=2),
             decoder=DecoderConfig(**DEC, projection_layers=3, projection_ratio=1.5)),
        dict(labels=LABELS), dict(probe=True)),
    "shared decoder alone, local grad mult 0": (
        "AUDIO", dict(shared_decoder=JaxDecoderConfig(**SHARED)),
        dict(decoder=None, local_grad_mult=0.0),
        dict(shared_decoder=DecoderConfig(**SHARED), decoder=None, local_grad_mult=0.0), {},
        {}),
    "batch norm target layer, layer norm targets, end of block targets": (
        "AUDIO", dict(batch_norm_target_layer=True, layer_norm_targets=True,
                      end_of_block_targets=True), {},
        dict(batch_norm_target_layer=True, layer_norm_targets=True),
        dict(end_of_block_targets=True), {}),
    "layer norm target layer without instance norm, instance norm targets": (
        "AUDIO", dict(layer_norm_target_layer=True, instance_norm_target_layer=False,
                      instance_norm_targets=True), {},
        dict(layer_norm_target_layer=True, instance_norm_target_layer=False,
             instance_norm_targets=True), {}, {}),
    "keep masked pct, mask dropout, encoder zero mask false, local grad mult 0.5": (
        "AUDIO", {}, dict(keep_masked_pct=0.1, mask_dropout=0.1, encoder_zero_mask=False,
                          mask_noise_std=0.5, local_grad_mult=0.5),
        dict(keep_masked_pct=0.1, mask_dropout=0.1, encoder_zero_mask=False,
             mask_noise_std=0.5, local_grad_mult=0.5), {}, dict(noise=True)),
    "image recon, inverse mask, local grad mult 0": (
        "IMAGE", dict(recon_loss=1.0),
        dict(inverse_mask=True, mask_prob_adjust=0.05, local_grad_mult=0.0),
        dict(recon_loss=1.0, inverse_mask=True, mask_prob_adjust=0.05, local_grad_mult=0.0),
        {}, {}),
}


def _pair(modality, jax_kw, finish, port_kw):
    """(modality, JAX model, JAX cfg, params, EMA params, port model, port
    cfg): the port model's seeded weights, jittered, are the params of both
    sides (through ``params_to_jax``, whose round trip is tested below)."""
    jcfg = finish(_jax_cfg(modality, **jax_kw))
    jmodel = jax_build_pretrain_model(jcfg)
    pcfg = _port_cfg(modality, **port_kw)
    model = Data2VecMulti(pcfg.model, pretrain=pcfg, **pretrain_rates(pcfg))
    init_params(model, torch.Generator().manual_seed(0))
    params = _jittered(params_to_jax(model.state_dict()), seed=1)
    model.load_state_dict(params_from_jax(params), strict=True)
    ema = jax_ema_subset(params, jcfg.model.ema_encoder_only)
    return modality, jmodel, jcfg, params, ema, model, pcfg


def _build(group):
    modality, jm, jmod, pkw, pmodel, extra = GROUPS[group]
    jax_kw, finish = _jax_options(modality, jm, jmod, extra.get("probe", False),
                                  loss_weights=extra.get("loss_weights"))
    return _pair(modality, jax_kw, finish, dict(model_kw=pmodel, **pkw)), extra


def _fixed_draws(monkeypatch, extra, rows, t, mask, src):
    """The draws of both sides made equal: the mask, the encoder's noise
    fill, BC mixup's ratio and permutation; the decoders' mask tokens 0."""
    fixed = lambda *args, **kw: jnp.asarray(mask)  # noqa: E731
    monkeypatch.setattr(jax_pretrain, "span_mask", fixed)
    monkeypatch.setattr(jax_ops, "block_mask_2d", fixed)
    real_scatter, real_port_scatter = jax_d2v.scatter_with_mask_tokens, \
        port_d2v.scatter_with_mask_tokens
    monkeypatch.setattr(jax_d2v, "scatter_with_mask_tokens",
                        lambda x, info, rng, noise_std, num_extra=0:
                        real_scatter(x, info, rng, 0.0, num_extra))
    monkeypatch.setattr(port_d2v, "scatter_with_mask_tokens",
                        lambda x, info, noise_std, gen=None, num_extra=0:
                        real_port_scatter(x, info, 0.0, None, num_extra))
    if extra.get("noise"):
        c = TINY["embed_dim"]
        noise = np.random.default_rng(21).normal(size=(rows, t, c)).astype(np.float32)

        def jax_fill(x, info, rng=None, zero_mask=True, noise_std=0.01):
            m = info.mask[..., None].astype(x.dtype)
            return x * (1 - m) + noise_std * jnp.asarray(noise).astype(x.dtype) * m

        def port_fill(x, mask, zero_mask=True, noise_std=0.01, generator=None):
            m = mask[..., None].to(x.dtype)
            return x * (1 - m) + noise_std * torch.from_numpy(noise).to(x.dtype) * m

        monkeypatch.setattr(jax_d2v, "apply_mask", jax_fill)
        monkeypatch.setattr(port_d2v, "apply_mask", port_fill)
    if extra.get("mixup"):
        b = src.shape[0]
        perm, r = np.array([1, 0]), np.array([0.7], np.float32)
        shim = types.SimpleNamespace(random=types.SimpleNamespace(
            split=jax.random.split, uniform=lambda *a, **k: jnp.asarray(r),
            permutation=lambda *a, **k: jnp.asarray(perm)))
        monkeypatch.setattr(jax_mixup_mod, "jax", shim)

        def port_mixup(source, target, source_mixup, mixup_prob, same_mixup, gain_mode,
                       sample_rate, window, target_mixup, generator):
            return bc_mixup_core(source, target, torch.from_numpy(perm), torch.from_numpy(r),
                                 torch.ones((b,), dtype=torch.bool), gain_mode, sample_rate,
                                 window, target_mixup)

        monkeypatch.setattr(port_pretrain, "bc_mixup", port_mixup)


def _loss_and_grads(group, monkeypatch):
    (modality, jmodel, jcfg, params, jema, model, pcfg), extra = _build(group)
    t = T[modality]
    rows = 2 * pcfg.clone_batch
    m = mask_tokens(pcfg, t)
    mask = _mask(rows, t, m, seed=7)
    src = _source(modality, np.random.default_rng(6))
    batch = {"source": src}
    if extra.get("probe"):
        batch["target"] = (np.random.default_rng(8).random((2, t, len(LABELS))) < 0.3
                           ).astype(np.float32)
    _fixed_draws(monkeypatch, extra, rows, t, mask, src)
    grad_fn = jax.jit(lambda p, e, b, r: jax.value_and_grad(
        jax_pretrain.pretrain_loss, has_aux=True)(p, e, b, r, jmodel, jcfg, True))
    (jloss, jmetrics), jgrads = grad_fn(params, jema,
                                        {k: jnp.asarray(v) for k, v in batch.items()},
                                        jax.random.PRNGKey(3))
    state = PretrainState.create(model, pcfg)
    loss, metrics = pretrain_loss(model, state.ema, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()},
                                  Rngs.from_seed(0, "cpu"), pcfg, True,
                                  lambda r, s, g: torch.from_numpy(mask))
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return (float(jloss), jmetrics, params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads)),
            float(loss), metrics, grads, pcfg)


@pytest.mark.parametrize("group", GROUPS)
def test_pretrain_options_match_jax(group, monkeypatch):
    jloss, jmetrics, jgrads, loss, metrics, grads, pcfg = _loss_and_grads(group, monkeypatch)
    assert abs(loss - jloss) <= LOSS_TOL, (loss, jloss)
    assert sorted(metrics) == sorted(jmetrics)
    for key, value in jmetrics.items():
        if key.startswith("pretrain/"):
            assert float(metrics[key]) == float(value), key
        else:
            assert abs(float(metrics[key]) - float(value)) <= LOSS_TOL, key
    assert grads.keys() == jgrads.keys()
    for name, ref in jgrads.items():
        ref = ref.numpy()
        atol = GRAD_TOL * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=0, atol=atol, err_msg=name)
    # the option acted: its parameters got gradients, its terms are there
    if pcfg.with_labels:
        assert float(metrics["loss_linear_eval_loss"]) > 0
        assert grads["linear_eval_projection.weight"].abs().sum() > 0
        assert float(metrics["pretrain/total"]) > 0
    if pcfg.shared_decoder is not None:
        assert grads["shared_decoder.blocks.0.weight"].abs().sum() > 0
    if pcfg.recon_loss:
        assert float(metrics["loss_recon"]) > 0 and grads["recon_proj.weight"].abs().sum() > 0
    if pcfg.local_grad_mult == 0.0:
        frontend = [n for n in grads if n.split(".")[1] in ("local_encoder", "patch_embed")]
        assert frontend and all(not grads[n].abs().sum() for n in frontend)


def test_probe_nll_is_refused_where_jax_fails(monkeypatch):
    """JAX's label-smoothed probe (``use_focal_loss`` False) fails on both
    label layouts its loader gives: the (B, T, n) multi-hot labels (float
    indices) and the (B, T) class labels (a rank mismatch in the gather at
    the masked ids). The port refuses the setting."""
    jax_kw, finish = _jax_options("AUDIO", probe=True, focal=False)
    _, jmodel, jcfg, params, jema, _, _ = _pair("AUDIO", jax_kw, finish, dict(
        model_kw=dict(labels=LABELS), **PROBE))
    mask = _mask(4, 200, expected_span_mask_tokens(200, 1.5, 2), seed=7)
    monkeypatch.setattr(jax_pretrain, "span_mask", lambda *a, **k: jnp.asarray(mask))
    src = jnp.asarray(_source("AUDIO", np.random.default_rng(6)))
    rng = np.random.default_rng(8)
    for target, err in (((rng.random((2, 200, 3)) < 0.3).astype(np.float32), TypeError),
                        (rng.integers(0, 3, (2, 200)).astype(np.int32), ValueError)):
        with pytest.raises(err):  # at trace time
            jax.eval_shape(lambda p, e, b: jax_pretrain.pretrain_loss(
                p, e, b, jax.random.PRNGKey(3), jmodel, jcfg, True), params, jema,
                {"source": src, "target": jnp.asarray(target)})
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        PretrainConfig(with_labels=True, use_focal_loss=False)


def test_audio_inverse_mask_is_read_nowhere(monkeypatch):
    """JAX's audio ``pretrain_loss`` is the same computation with
    ``inverse_mask`` true and false (the span sampler does not read it: one
    jaxpr, so one loss on every seed), and the port's recipe reader accepts
    the key and ignores it."""
    traces = []
    (_, jmodel, jcfg, params, jema, _, _), _ = _build(
        "layer norm target layer without instance norm, instance norm targets")
    src = jnp.asarray(_source("AUDIO", np.random.default_rng(6)))
    for inverse in (False, True):
        jcfg.model.modalities.audio.inverse_mask = inverse
        traces.append(str(jax.make_jaxpr(lambda p, e, b: jax_pretrain.pretrain_loss(
            p, e, b, jax.random.PRNGKey(3), jmodel, jcfg, True))(params, jema, {"source": src})))
    assert traces[0] == traces[1]
    base = load_config(str(RECIPES["a2v_large_pretrain"]))
    run = load_config(str(RECIPES["a2v_large_pretrain"]),
                      ["model.modalities.audio.inverse_mask=true"])
    assert run == base


@pytest.mark.parametrize("pct", [0.1, 0.37])
def test_mask_samplers_match_jax(pct, monkeypatch):
    """``make_mask_info_static`` with ``keep_masked_pct``,
    ``expected_span_mask_tokens`` and ``span_mask`` with ``mask_dropout``,
    ``block_mask_2d`` with ``mask_prob_adjust`` and ``inverse_mask``: bit
    for bit JAX's on the same uniform draws."""
    b, t = 6, 90
    m = expected_span_mask_tokens(t, 1.5, 2, pct)
    assert m == jax_masking.expected_span_mask_tokens(t, 1.5, 2, pct) < \
        expected_span_mask_tokens(t, 1.5, 2)
    mask = _mask(b, t, m, seed=9)
    ours = make_mask_info_static(torch.from_numpy(mask), m, pct)
    ref = jax_masking.make_mask_info_static(jnp.asarray(mask), m, pct)
    for a, j in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert ours.ids_keep.shape[1] == t - m + round(m * pct)
    # the samplers on the port generator's draws, replayed into JAX's
    for name in ("span", "block", "block inverse"):
        gen, replay = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        if name == "span":
            ours = span_mask(b, t, 1.5, 2, gen, pct)
            shapes = [(b, t - 1), (b, t)]
        else:
            ours = block_mask_2d(b, 196, 0.6, 3, gen, pct, name == "block inverse")
            shapes = [(b, 196)] * 2
        draws = [torch.rand(s, generator=replay).numpy() for s in shapes]
        monkeypatch.setattr(jax_masking.jax.random, "uniform",
                            lambda key, shape, *a, **k: jnp.asarray(draws.pop(0)))
        if name == "span":
            ref = jax_masking.span_mask(jax.random.PRNGKey(0), b, t, 1.5, 2, pct)
            assert (ours.sum(1) == m).all()
        else:
            ref = jax_masking.block_mask_2d(jax.random.PRNGKey(0), b, 196, 0.6, 3, pct,
                                            name == "block inverse")
            want = int(196 * 0.6)
            assert (ours.sum(1) == (196 - want if name == "block inverse" else want)).all()
        monkeypatch.undo()
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=name)
    cfg = PretrainConfig.vit_b16(mask_prob=0.6, inverse_mask=True)
    assert mask_tokens(cfg, 196) == 196 - int(196 * 0.6)


def _new_params_model():
    """The tiny audio model with every new parameter: a shared decoder with
    a 2-layer projection head, a 3-layer head on the audio decoder, the
    probe, and ``recon_proj`` (built for audio too, as JAX builds it)."""
    (_, jmodel, jcfg, params, _, model, pcfg), _ = _build(
        "shared decoder and projection heads, probe")
    return jmodel, jcfg, params, model, pcfg


def test_new_parameters_round_trip_jax_and_fairseq():
    """``params_from_jax`` / ``params_to_jax`` carry the shared decoder, the
    projection layers (``proj_{i}``) and the probe both ways; the fairseq
    export equals JAX's export of the same params, and imports back to the
    same state dict."""
    jmodel, jcfg, params, model, pcfg = _new_params_model()
    sd = model.state_dict()
    names = set(sd)
    for want in ("shared_decoder.proj_0.weight", "shared_decoder.proj_1.bias",
                 "audio_encoder.decoder.proj_2.weight", "linear_eval_projection.weight"):
        assert want in names, want
    back = params_to_jax(sd)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, params))[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_ref[path], err_msg=str(path))
    ours = export_pretrain(sd, pcfg.model)
    ref = jax_export_pretrain(params, jcfg.model)
    assert ours.keys() == ref.keys()
    assert any(k.startswith("shared_decoder.proj.2") for k in ours)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    imported, _ = pretrain_state_dicts(ours, pcfg.model, pcfg.decoder.decoder_layers,
                                       pcfg.shared_decoder.decoder_layers)
    assert imported.keys() == sd.keys()
    for k in sd:
        assert torch.equal(imported[k], sd[k]), k
    # recon_proj: an image model's, both ways
    (_, _, _, iparams, _, imodel, _), _ = _build("image recon, inverse mask, local grad mult 0")
    isd = imodel.state_dict()
    assert isd["recon_proj.weight"].shape == (8 * 8 * 3, IMAGE["embed_dim"])
    again = params_from_jax(params_to_jax(isd))
    assert all(torch.equal(again[k], isd[k]) for k in isd)
    np.testing.assert_array_equal(params_to_jax(isd)["recon_proj"]["kernel"],
                                  np.asarray(iparams["recon_proj"]["kernel"]))


def test_probe_handoff_matches_jax_build():
    """``load_pretrain_weights``: the pretraining probe becomes the finetune
    head, as JAX's ``load_pretrained_into_finetune`` hands it over; without
    the flag the head keeps its own weights."""
    jmodel, jcfg, params, model, pcfg = _new_params_model()
    ft_cfg = dataclasses.replace(pcfg.model)
    ft = FinetuneModel(ft_cfg, train=FinetuneTrainConfig(load_pretrain_weights=True))
    ft_state = ft.state_dict()
    jft = {"encoder": params_to_jax({k[len("encoder."):]: v for k, v in ft_state.items()
                                     if k.startswith("encoder.")}),
           "proj": params_to_jax({k: v for k, v in ft_state.items()
                                  if k.startswith("proj.")})["proj"]}
    jcfg.finetune = types.SimpleNamespace(load_pretrain_weights=True)
    ref = params_from_jax(jax_load_pretrained_into_finetune(
        jft, jax.tree_util.tree_map(np.asarray, params), jcfg))
    ours = load_pretrained_into_finetune(ft_state, model.state_dict(), True)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    assert torch.equal(ours["proj.weight"], model.state_dict()["linear_eval_projection.weight"])
    kept = load_pretrained_into_finetune(ft_state, model.state_dict(), False)
    assert torch.equal(kept["proj.weight"], ft_state["proj.weight"])


def test_finetune_extra_tokens_stay_refused_as_jax_fails():
    """JAX's finetune step with one extra token: its logits have T + 1
    frames against T label frames, and the loss fails to broadcast. The
    port's finetune model keeps its refusal (ROADMAP C)."""
    from animal2vec_tpu.config import OptimizationConfig as JaxOpt
    from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model
    from animal2vec_tpu.train.finetune_step import make_finetune_train_step as jax_make_step
    from animal2vec_tpu.train.optim import build_optimizer as jax_build_optimizer
    from animal2vec_tpu.train.state import FinetuneState as JaxFinetuneState
    from tests.test_parity import _finetune_cfg
    from tests.test_torch_model import TINY_LAYERS
    from tests.test_torch_train_step import OPT, _batch

    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{x}]" for x in TINY_LAYERS), avg_k=3, **TINY)
    jcfg.optimization = JaxOpt(**OPT)
    jcfg.model.modalities.audio.num_extra_tokens = 1
    jmodel = jax_build_finetune_model(jcfg)
    params = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 800))))["params"]
    params = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), params)
    out = jax.eval_shape(lambda p: jmodel.apply({"params": p}, jnp.zeros((2, 800))), params)
    assert out["encoder_out"].shape == (2, 201, 4)
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    batch = {k: jnp.asarray(v) for k, v in _batch(seed=2).items()}
    with pytest.raises(TypeError, match="incompatible shapes"):  # at trace time
        jax.eval_shape(lambda st, b: jax_make_step(jmodel, jcfg)(st, b, jax.random.PRNGKey(3)),
                       JaxFinetuneState.create(params, tx), batch)
    with pytest.raises(NotImplementedError, match="extra tokens"):
        FinetuneModel(dataclasses.replace(FinetuneConfig(), num_extra_tokens=1))


def test_run_config_takes_the_probe():
    """A pretraining run with labels: ``task.with_labels`` and the probe
    must agree."""
    pcfg = PretrainConfig(with_labels=True)
    run = RunConfig(pretrain=pcfg, task=TaskConfig(with_labels=True))
    assert run.pretrain.with_labels
    with pytest.raises(ValueError, match="must agree"):
        RunConfig(pretrain=pcfg)
