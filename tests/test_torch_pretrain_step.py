"""The port's data2vec-2 pretraining step against the JAX package's.

A tiny audio model (the embed-128 config of ``tests/test_torch_model.py``: 2
prenet + 3 trunk blocks, a 2-layer ``Decoder1d`` of 16 in 4 groups,
``ema_encoder_only`` False as in the a2v recipe) and a tiny image model
(32 x 32 images in 8 x 8 patches, embed 128, 1 prenet + 2 trunk blocks, the
2-D ALiBi bias with its learned scale, a 2-layer ``Decoder2d``,
``ema_encoder_only`` True as the ``ModelConfig`` default), both from the
same jittered params, with ``clone_batch`` 2 and ``update_freq`` 2, global
norm clipping 1.0 and weight decay 0.01. ``jax.random`` and torch draw
differently, so one numpy mask is injected on both sides (the JAX mask
samplers are monkeypatched) and the noise fills, the decoders' input
dropout, mixup and every dropout are 0.

Tolerances: the loss and the teacher targets within 1e-5, every parameter
and every EMA parameter after the step within 1e-6. The first Adam update
is about lr * sign(g) with lr 1e-4, so a wrong gradient sign moves a
parameter by 2e-4; a gradient near 0 sees its fp32 rounding amplified by
Adam's normalization (at lr 1e-3 this test saw one image weight of 1024
land 2.7e-6 apart), and lr 1e-4 keeps that under the tolerance. The EMA
moves by (1 - d) of the update. The step's option variants and the int8
teachers' targets are in ``tests/test_torch_pretrain_step_variants.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import animal2vec_tpu.ops as jax_ops
import animal2vec_tpu.train.pretrain as jax_pretrain
from animal2vec_tpu.config import (
    AudioModalityConfig, Config, DecoderConfig as JaxDecoderConfig, ImageModalityConfig,
    MixupConfig, ModalitiesConfig, ModelConfig, OptimizationConfig, TaskConfig, resolve,
)
from animal2vec_tpu.models.data2vec2 import (
    Data2VecMulti as JaxData2VecMulti, finish_targets as jax_finish_targets,
)
from animal2vec_tpu.train.build import build_pretrain_model as jax_build_pretrain_model
from animal2vec_tpu.train.optim import build_optimizer as jax_build_optimizer
from animal2vec_tpu.train.state import PretrainState as JaxPretrainState
from animal2vec_tpu.train.state import merge_params as jax_merge_params

from animal2vec_tpu_torch.config import (
    DecoderConfig, FinetuneConfig, ImageConfig, OptimizationConfig, PretrainConfig,
)
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.finetune import build_pretrain_model, pretrain_rates
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.train.pretrain import (
    make_pretrain_eval_step, make_pretrain_train_step, mask_tokens, teacher_targets,
)
from animal2vec_tpu_torch.train.state import PretrainState
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_torch_model import TINY, TINY_LAYERS, _jittered

LOSS_TOL = 1e-5
TARGET_TOL = 1e-5
PARAM_TOL = 1e-6
ACCUM = 2
OPT = dict(lr=1e-4, max_update=100, warmup_updates=0, warmup_init_lr=0.0, min_lr=0.0,
           clip_norm=1.0, weight_decay=0.01, adam_eps=1e-6, adam_betas=(0.9, 0.98),
           update_freq=ACCUM)
EMA = dict(ema_decay=0.99, ema_end_decay=0.999, ema_anneal_end_step=100)
DEC = dict(decoder_dim=16, decoder_groups=4, decoder_kernel=3, decoder_layers=2,
           input_dropout=0.0)
IMAGE = dict(input_size=32, patch_size=8, patch_embed_dim=32, embed_dim=128, num_heads=4,
             prenet_depth=1, depth=2, use_alibi_encoder=True)


def _jax_cfg(modality, model_kw=None, modality_kw=None):
    """The tiny JAX config; ``model_kw`` and ``modality_kw`` change fields of
    its ``ModelConfig`` and of its modality's config."""
    cfg = Config()
    model = dict(embed_dim=128, num_heads=4, clone_batch=2, instance_norm_target_layer=True,
                 encoder_dropout=0.0, attention_dropout=0.0, post_mlp_drop=0.0, remat=False,
                 supported_modality=modality, mixup=MixupConfig(source_mixup=-1.0), **EMA)
    if modality == "AUDIO":
        conv = " + ".join(f"[{layer}]" for layer in TINY_LAYERS)
        cfg.task = TaskConfig(conv_feature_layers=conv, sample_rate=8000)
        audio = AudioModalityConfig(
            prenet_depth=2, conv_pos_depth=2, conv_pos_width=10, conv_pos_groups=2,
            sinc_norm="layer_norm", use_pswish=True, use_alibi_encoder=True,
            learned_alibi_scale=True, learned_alibi_scale_per_head=True, mask_prob=1.5,
            mask_length=2, mask_noise_std=0.0, decoder=JaxDecoderConfig(**DEC))
        cfg.model = ModelConfig(depth=3, norm_eps=1e-5, average_top_k_layers=3,
                                ema_encoder_only=False,
                                modalities=ModalitiesConfig(audio=audio), **model)
    else:
        image = ImageModalityConfig(
            prenet_depth=1, input_size=32, patch_size=8, embed_dim=32, use_alibi_encoder=True,
            learned_alibi_scale=True, mask_prob=0.6, mask_length=2, mask_noise_std=0.0,
            decoder=JaxDecoderConfig(**DEC))
        cfg.model = ModelConfig(depth=2, average_top_k_layers=2,
                                modalities=ModalitiesConfig(image=image), **model)
    cfg.optimization = OptimizationConfig(**OPT)
    for key, value in (model_kw or {}).items():
        setattr(cfg.model, key, value)
    mod = getattr(cfg.model.modalities, modality.lower())
    for key, value in (modality_kw or {}).items():
        setattr(mod, key, value)
    return resolve(cfg)


def _port_cfg(modality, model_kw=None, **kw):
    """The tiny port config; ``model_kw`` changes fields of its encoder
    config, ``kw`` of the PretrainConfig."""
    cfg = _port_cfg_base(modality)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **(model_kw or {})),
                               **kw)


def _port_cfg_base(modality):
    common = dict(decoder=DecoderConfig(**DEC), clone_batch=2, mask_noise_std=0.0,
                  encoder_dropout=0.0, attention_dropout=0.0, post_mlp_drop=0.0,
                  prenet_dropout=0.0, source_mixup=-1.0, optimization=OptimizationConfig(**OPT),
                  **EMA)
    if modality == "AUDIO":
        model = FinetuneConfig(conv_layers=TINY_LAYERS, average_top_k_layers=3, **TINY)
        return PretrainConfig(model=model, average_top_k_layers=3, **common)
    return PretrainConfig.vit_b16(model=ImageConfig(**IMAGE), average_top_k_layers=2,
                                  mask_prob=0.6, mask_length=2, **common)


def _source(modality, rng, lead=()):
    shape = (2, 800) if modality == "AUDIO" else (2, 32, 32, 3)
    return rng.normal(size=lead + shape).astype(np.float32)


def _batch(modality, seed):
    """``ACCUM`` micro-batches."""
    return {"source": _source(modality, np.random.default_rng(seed), (ACCUM,))}


def _mask(rows, t, m, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((rows, t), np.int32)
    for r in range(rows):
        mask[r, rng.permutation(t)[:m]] = 1
    return mask


def _both(modality, jax_kw=None, port_kw=None):
    """(modality, JAX model, cfg, jittered params, initial JAX state, port
    model loaded from the params, port cfg); ``jax_kw`` and ``port_kw`` are
    ``_jax_cfg``'s and ``_port_cfg``'s keyword changes."""
    jcfg = _jax_cfg(modality, **(jax_kw or {}))
    jmodel = jax_build_pretrain_model(jcfg)
    example = jnp.zeros((1, 800)) if modality == "AUDIO" else jnp.zeros((1, 32, 32, 3))
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "mask_noise": jax.random.fold_in(key, 1)}, example,
                         modality)["params"]
    params = _jittered(params, seed=1)
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    jstate = JaxPretrainState.create(params, tx, jcfg.model)
    pcfg = _port_cfg(modality, **(port_kw or {}))
    model = Data2VecMulti(pcfg.model, pretrain=pcfg, **pretrain_rates(pcfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    return modality, jmodel, jcfg, params, jstate, model, pcfg


@pytest.fixture(scope="module", params=["AUDIO", "IMAGE"])
def both(request):
    return _both(request.param)


def test_teacher_targets_match_jax(both):
    modality, jmodel, jcfg, params, jstate, model, pcfg = both
    src = _source(modality, np.random.default_rng(5))
    local_j = jmodel.apply({"params": params}, jnp.asarray(src), modality, True,
                           method=JaxData2VecMulti.local_features)
    merged = jax_merge_params(params, jstate.ema_params)
    _, t_acc, _, _ = jmodel.apply({"params": merged}, local_j, modality, None, False, None, None,
                                  True, True, True, method=JaxData2VecMulti.encode)
    want = jax_finish_targets(t_acc / jcfg.model.average_top_k_layers, jcfg.model)
    state = PretrainState.create(model, pcfg)
    with torch.no_grad():
        local = model.local_features(torch.from_numpy(src))
    got = teacher_targets(model, state.ema, local)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TARGET_TOL)


def test_train_step_matches_jax(both, monkeypatch):
    _check_step(both, monkeypatch)


def _check_step(both, monkeypatch):
    """One step of update_freq 2 on both sides under one injected mask: the
    loss and its terms, the metrics, every parameter and EMA parameter."""
    modality, jmodel, jcfg, params, jstate, model, pcfg = both
    rows, t = 2 * pcfg.clone_batch, (200 if modality == "AUDIO" else 16)
    mask = _mask(rows, t, mask_tokens(pcfg, t), seed=7)
    fixed = lambda *args, **kw: jnp.asarray(mask)  # noqa: E731
    monkeypatch.setattr(jax_pretrain, "span_mask", fixed)
    monkeypatch.setattr(jax_ops, "block_mask_2d", fixed)
    batch = _batch(modality, 6)
    jnew, jmetrics = jax_pretrain.make_pretrain_train_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3))

    model = Data2VecMulti(pcfg.model, pretrain=pcfg, **pretrain_rates(pcfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = PretrainState.create(model, pcfg)
    ema0 = {n: v.clone() for n, v in state.ema.items()}
    step = make_pretrain_train_step(pcfg, draw_mask=lambda r, s, g: torch.from_numpy(mask))
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                   Rngs.from_seed(0, "cpu"))
    assert state.step == 1
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= LOSS_TOL
    for key in ("sample_size", "masked_pct", "ema_decay"):
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-6), key
    terms = [k for k in jmetrics if k.startswith("loss_")]
    assert sorted(terms) == sorted(k for k in metrics if k.startswith("loss_"))
    for key in ("pred_var", "target_var", *terms):
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= LOSS_TOL, key
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jnew.params))
    ours = state.model.state_dict()
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
    ref_ema = params_from_jax(jax.tree_util.tree_map(np.asarray, jnew.ema_params))
    assert state.ema.keys() == ref_ema.keys()
    for name in ref_ema:
        np.testing.assert_allclose(state.ema[name].numpy(), ref_ema[name].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
    # the teacher moved, and only towards the student
    assert any(not torch.equal(ema0[n], state.ema[n]) for n in ema0)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    scale = ("image_encoder" if modality == "IMAGE" else "audio_encoder") + ".alibi_scale"
    assert grads[scale].abs().sum() > 0
    assert grads[scale.split(".")[0] + ".decoder.proj.weight"].abs().sum() > 0
    return metrics, grads


def test_eval_step_and_recipe_draws():
    """The recipe's own draws on the tiny audio model (mixup, span masks,
    every dropout, noise fills and mask tokens): finite
    loss, the same Rngs seed repeats the step exactly, the teacher moves; the
    eval step runs in eval mode."""
    pcfg = dataclasses.replace(_port_cfg("AUDIO"), source_mixup=0.5, mixup_prob=1.0,
                               mask_noise_std=0.01, encoder_dropout=0.1,
                               attention_dropout=0.1, post_mlp_drop=0.1, prenet_dropout=0.1,
                               decoder=DecoderConfig(**dict(DEC, input_dropout=0.1)))
    batch = {k: torch.from_numpy(v) for k, v in _batch("AUDIO", 8).items()}
    runs = []
    for _ in range(2):
        model = build_pretrain_model(pcfg, seed=0, device="cpu")
        state = PretrainState.create(model, pcfg)
        ema0 = {n: v.clone() for n, v in state.ema.items()}
        rngs = Rngs.from_seed(5, "cpu")
        losses = [float(make_pretrain_train_step(pcfg)(state, batch, rngs)["loss"])
                  for _ in range(2)]
        runs.append((losses, {n: v.clone() for n, v in state.ema.items()}))
    (losses, ema), (losses2, ema2) = runs
    assert np.isfinite(losses).all() and losses == losses2
    assert all(torch.equal(ema[n], ema2[n]) for n in ema)
    assert any(not torch.equal(ema0[n], ema[n]) for n in ema)
    metrics = make_pretrain_eval_step(pcfg)(state, {k: v[0] for k, v in batch.items()},
                                            Rngs.from_seed(1, "cpu"))
    assert np.isfinite(float(metrics["loss"])) and not state.model.training
    assert float(metrics["sample_size"]) == 2 * pcfg.clone_batch * mask_tokens(pcfg, 200) == 752


INT8_DIMS = dict(embed_dim=128, num_heads=2)  # the int8 kernels' lane-aligned widths


@pytest.mark.parametrize("mode", ["int8", "int8_attn"])
def test_int8_teacher_follows_the_ema_step(mode):
    """After a step, the int8 teacher's targets equal bit for bit those of a
    model in that mode freshly loaded from the merged (student + EMA)
    weights, whose int8 weights its load quantizes: no stale int8 weights
    (ROADMAP A.7.1). The targets moved with the step."""
    from animal2vec_tpu_torch.train.state import merge_params

    pcfg = _port_cfg("AUDIO", model_kw=INT8_DIMS, teacher_matmul_impl=mode)
    model = build_pretrain_model(pcfg, seed=0, device="cpu")
    state = PretrainState.create(model, pcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch("AUDIO", 14).items()}
    with torch.no_grad():
        local = model.local_features(batch["source"][0])
    before = teacher_targets(model, state.ema, local, mode)
    make_pretrain_train_step(pcfg)(state, batch, Rngs.from_seed(2, "cpu"))
    after = teacher_targets(model, state.ema, local, mode)
    fresh = Data2VecMulti(dataclasses.replace(model.cfg, matmul_impl=mode), pretrain=pcfg).eval()
    fresh.load_state_dict(merge_params(model, state.ema), strict=True)
    with torch.no_grad():
        _, _, _, _, t_sum = fresh.encode(local, reduce_targets=True)
    assert torch.equal(after, t_sum / pcfg.average_top_k_layers)
    assert not torch.equal(before, after)
