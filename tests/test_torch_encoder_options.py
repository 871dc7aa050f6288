"""The encoder's architecture and regularizer options against the JAX
package: PCEN with its learned smoother, the learnable-kernel sinc, a plain
first conv and the "default" extractor mode, the LayerNorm before the
positional convs, pre-LN audio blocks, norms without affine, ALiBi-free
and shared-scale attention (tiny models, logits within 1e-4 with every
rate at 0), a pretraining step with these options, the weights' round
trips and the fairseq converter; the activation dropout of the plain fused
MLP (#8) and drop-path, with their masks.

JAX draws its drop-path and its composed MLP's dropout with
``jax.random``, so those are held to JAX's hash (the MLP's sites) and to
their definition (drop-path), and the model-level parity runs with the
rates at 0.

Two faults of the JAX package are recorded here, and the port copies
neither: its learnable-kernel sinc cannot be applied under flax 0.12 (flax
re-traces every parameter initializer at apply to check its shape, and
the sinc's initializer calls ``np.asarray`` on the traced filters; the
tests give it ``jnp.asarray`` for that call), and its "default" extractor
mode runs in fp32 only (flax's GroupNorm returns fp32, which the next bf16
conv refuses). ``finetune.update_alibi`` False freezes nothing in JAX.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as tu

import animal2vec_tpu.models.frontend as jax_frontend
from animal2vec_tpu.config import OptimizationConfig as JaxOptimizationConfig
from animal2vec_tpu.config import resolve
from animal2vec_tpu.models.frontend import ConvFeatureExtractor as JaxExtractor
from animal2vec_tpu.models.frontend import ExponentialMovingAverageSmoother as JaxSmoother
from animal2vec_tpu.models.frontend import PCEN as JaxPCEN
from animal2vec_tpu.models.frontend import SincConv as JaxSincConv
from animal2vec_tpu.ops.fused_mlp import _hash_keep as jax_hash_keep
from animal2vec_tpu.train.build import build_finetune_encoder_cfg
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model
from animal2vec_tpu.train.convert import convert_pretrain as jax_convert_pretrain
from animal2vec_tpu.train.convert import export_pretrain as jax_export_pretrain
from animal2vec_tpu.train.finetune_step import make_finetune_train_step as jax_make_step
from animal2vec_tpu.train.optim import build_optimizer as jax_build_optimizer
from animal2vec_tpu.train.state import FinetuneState as JaxFinetuneState

from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.models.frontend import (
    PCEN, ConvFeatureExtractor, ExponentialMovingAverageSmoother, SincConv,
)
from animal2vec_tpu_torch.models.modules import (
    AltBlock, BlockStack, apply_drop_path, drop_path_scale,
)
from animal2vec_tpu_torch.ops import fused_mlp as fm
from animal2vec_tpu_torch.ops.dropout import Rngs, hash_keep, keep_scale
from animal2vec_tpu_torch.train.convert import convert_pretrain, export_pretrain
from animal2vec_tpu_torch.weights import params_from_jax, params_to_jax, serving_cast

from tests.test_parity import _finetune_cfg
from tests.test_torch_model import TINY, TINY_LAYERS, _jittered, _port_cfg
from tests.test_torch_pretrain_step import _both, _check_step

TOL = 1e-4
PCEN_TOL = 1e-5

# the two variants that run on the card at a2v-large width, and one more:
# (audio modality changes, model changes), JAX names = the port's fields
VARIANTS = {
    "P": (dict(sinc_norm="pcen", apply_window_to_root=True, conv_pos_pre_ln=True,
               learned_alibi_scale_per_head=False),
          dict(layer_norm_first=True, norm_affine=False)),
    "N": (dict(use_alibi_encoder=False, sinc_input=False, extractor_mode="default"), {}),
    "per-layer shared scales, learnable sinc + instance norm, no affine": (
        dict(learned_alibi_scale_per_head=False, learned_alibi_scale_per_layer=True,
             sinc_norm="instance", use_pswish=False, apply_window_to_root=True),
        dict(norm_affine=False)),
}


@pytest.fixture
def eager_sinc_init(monkeypatch):
    """JAX's learnable-kernel sinc initializer with ``jnp.asarray`` for its
    ``np.asarray`` (the module docstring's fault; the values are the same)."""
    monkeypatch.setattr(jax_frontend, "np", types.SimpleNamespace(asarray=jnp.asarray))


def _jax_finetune(variant):
    audio, model = VARIANTS[variant]
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3, **TINY)
    for key, value in audio.items():
        setattr(jcfg.model.modalities.audio, key, value)
    for key, value in model.items():
        setattr(jcfg.model, key, value)
    return resolve(jcfg)


def _both_finetune(variant):
    jcfg = _jax_finetune(variant)
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 800)))["params"]
    params = _jittered(params, seed=1)
    audio, model = VARIANTS[variant]
    cfg = dataclasses.replace(_port_cfg(jcfg, **TINY), **audio, **model)
    port = FinetuneModel(cfg)
    port.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, jmodel, params, port.eval()


# ---------------------------------------------------------------- frontend


def _pcen_params(c, seed):
    """PCEN parameters off their init, past the clamps: alpha above 1 and
    root below 1 in some channels, smoother weights outside [0, 1]."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"alpha": f32(rng.uniform(0.5, 1.2, c)), "delta": f32(rng.uniform(0.5, 3.0, c)),
            "root": f32(rng.uniform(0.8, 3.0, c)),
            "ema": {"weights": f32(np.resize([-0.1, 0.04, 0.5, 1.3, 0.9], c))}}


def _load_pcen(port, params):
    with torch.no_grad():
        for name in ("alpha", "delta", "root"):
            getattr(port, name).copy_(torch.from_numpy(params[name]))
        port.ema.weights.copy_(torch.from_numpy(params["ema"]["weights"]))


@pytest.mark.parametrize("t", [37, 4099])
def test_pcen_and_smoother_match_jax(t):
    """PCEN and its smoother in fp32 against JAX's associative scan, within
    1e-5: at T >= 4096 the two scans sum in different orders; the clamps of
    alpha, root and the smoother's weights are in reach."""
    c = 5
    x = np.abs(np.random.default_rng(t).normal(size=(2, t, c))).astype(np.float32)
    params = _pcen_params(c, seed=t)
    ref = JaxPCEN().apply({"params": params}, jnp.asarray(x))
    ref_s = JaxSmoother().apply({"params": params["ema"]}, jnp.asarray(x))
    port = PCEN(c)
    _load_pcen(port, params)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
        smooth = port.ema(torch.from_numpy(x))
    np.testing.assert_allclose(smooth.numpy(), np.asarray(ref_s), rtol=PCEN_TOL, atol=PCEN_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=PCEN_TOL)


def test_pcen_gradients_match_jax_and_the_scan_keeps_two_tensors():
    """The scan's backward (the reverse recurrence as a scan) against
    ``jax.grad`` of JAX's PCEN, for the input and every parameter; autograd
    keeps the scan's input and output alone of its (B, T, C) tensors."""
    c, t = 4, 300
    rng = np.random.default_rng(3)
    x = np.abs(rng.normal(size=(2, t, c))).astype(np.float32) + 0.1
    g = rng.normal(size=(2, t, c)).astype(np.float32)
    params = _pcen_params(c, seed=4)
    params["ema"]["weights"] = np.asarray([0.04, 0.3, 0.7, 0.95], np.float32)

    def loss(p, xx):
        return jnp.sum(JaxPCEN().apply({"params": p}, xx) * g)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    port = PCEN(c)
    _load_pcen(port, params)
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    for name in ("alpha", "delta", "root"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(), np.asarray(gp[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(port.ema.weights.grad.numpy(), np.asarray(gp["ema"]["weights"]),
                               rtol=1e-4, atol=1e-4)

    full = []
    smoother = ExponentialMovingAverageSmoother(c)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda v: full.append(v.numel() == x.size) or v, lambda v: v):
        smoother(torch.from_numpy(x).requires_grad_())
    assert sum(full) == 2


@pytest.mark.parametrize("window", [False, True])
def test_learnable_sinc_matches_jax(window, eager_sinc_init):
    """The learnable-kernel sinc with and without the full Hamming window:
    the port's init equals JAX's, and the conv of jittered taps agrees."""
    jmod = JaxSincConv(out_channels=9, kernel_size=7, learnable_filters=True,
                       apply_window_to_root=window)
    x = np.random.default_rng(5).normal(size=(2, 300)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = SincConv(9, 7, learnable_filters=True, apply_window_to_root=window)
    np.testing.assert_allclose(port.kernel.detach().numpy(), np.asarray(params["kernel"]),
                               rtol=0, atol=1e-6)
    params = _jittered(params, seed=6)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    port.load_state_dict({"kernel": torch.from_numpy(np.asarray(params["kernel"]))})
    with torch.no_grad():
        out = port(torch.from_numpy(x)[..., None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_jax_learnable_sinc_apply_fails_under_flax():
    """The JAX package's fault: flax traces the initializer at apply, and its
    ``np.asarray`` refuses the tracer."""
    jmod = JaxSincConv(out_channels=4, kernel_size=7, learnable_filters=True,
                       apply_window_to_root=True)
    x = jnp.zeros((1, 50))
    with jax.disable_jit():
        params = jmod.init(jax.random.PRNGKey(0), x)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jmod.apply(params, x)


def _extractor_pair(**kw):
    jmod = JaxExtractor(conv_layers=TINY_LAYERS, **kw)
    x = np.random.default_rng(8).normal(size=(2, 800)).astype(np.float32)
    params = _jittered(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], seed=9)
    port = ConvFeatureExtractor(TINY_LAYERS, **kw)
    port.load_state_dict(params_from_jax(params), strict=True)
    return jmod, params, port, x


@pytest.mark.parametrize("kw", [
    dict(sinc_input=False, mode="default"),
    dict(sinc_input=False, sinc_norm="pcen", use_pswish=True),
    dict(sinc_input=False, apply_window_to_root=True, use_pswish=True),
], ids=["plain conv + default mode", "plain conv + pcen", "window without sinc_input"])
def test_extractor_variants_match_jax(kw):
    """A plain first conv (he-normal, GELU: PSwish follows only a sinc
    layer) with the per-channel GroupNorm of the "default" mode (epsilon
    1e-6) or PCEN on its output; and JAX's quirk: ``apply_window_to_root``
    without ``sinc_input`` builds the parametric sinc."""
    jmod, params, port, x = _extractor_pair(**kw)
    if kw.get("apply_window_to_root"):
        assert set(params["conv_0"]) == {"low_hz", "band_hz"} and port.conv_0.kernel is None
    else:
        assert "conv_0_kernel" in params and "act_0" not in params
    if kw.get("mode") == "default":
        assert set(params) == {"conv_0_kernel", "conv_1_kernel", "conv_2_kernel", "norm_0"}
        assert port.norm_0.eps == 1e-6
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_default_mode_in_bf16_runs_where_jax_fails():
    """JAX's "default" mode in bf16 raises (fp32 GroupNorm output beside a
    bf16 kernel); the port casts the norm's output back and stays within
    bf16's reach of the fp32 result."""
    _, params, port, x = _extractor_pair(sinc_input=False, mode="default")
    jmod = JaxExtractor(conv_layers=TINY_LAYERS, sinc_input=False, mode="default",
                        dtype=jnp.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.bfloat16)
        ref = port(torch.from_numpy(x), torch.float32)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref).norm() / ref.norm()) < 2e-2


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_logits_match_jax(variant, eager_sinc_init):
    """Tiny FinetuneModels of each variant: the port's state dict is JAX's
    (no key more or less), the logits agree within 1e-4 and the relative
    positions (through the LayerNorm before them) within 1e-4."""
    jcfg, jmodel, params, model = _both_finetune(variant)
    src = np.random.default_rng(2).normal(size=(2, 800)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(src))["encoder_out"])
    with torch.no_grad():
        out = model(torch.from_numpy(src))["encoder_out"].numpy()
    assert out.shape == ref.shape == (2, 200, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    enc = model.encoder.audio_encoder
    audio, blocks = VARIANTS[variant]
    assert hasattr(enc, "pos_pre_ln") == audio.get("conv_pos_pre_ln", False)
    assert (enc.alibi_scale is None) == (not audio.get("use_alibi_encoder", True))
    if enc.alibi_scale is not None:
        assert enc.alibi_scale.shape[2] == (1 if "learned_alibi_scale_per_head" in audio else 4)
    norms = [m for name, m in model.named_modules()
             if name.endswith(("norm1", "norm2", "context_encoder.norm", "encoder.norm"))]
    assert len(norms) == 2 * 5 + 1 + blocks.get("layer_norm_first", False)
    assert all((m.weight is None) == (not blocks.get("norm_affine", True)) for m in norms)
    local = jmodel.apply({"params": params}, jnp.asarray(src),
                         method=lambda m, s: m.encoder.local_features(s))
    pos = jmodel.apply({"params": params}, local,
                       method=lambda m, x: m.encoder.audio_encoder.relative_positions(x))
    with torch.no_grad():
        ours = enc.relative_positions(torch.from_numpy(np.asarray(local)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(pos), rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", ["P", "N"])
def test_variant_weights_round_trip(variant, eager_sinc_init):
    """``params_from_jax`` and ``params_to_jax`` over every new parameter
    (PCEN's, the learnable taps, the GroupNorm, the LayerNorm before the
    positional convs, the shared scale) give JAX's tree back exactly;
    ``serving_cast`` keeps the learnable taps in fp32."""
    _, _, params, model = _both_finetune(variant)
    back = tu.flatten_dict(params_to_jax(model.state_dict()))
    ref = tu.flatten_dict(jax.tree_util.tree_map(np.asarray, params))
    assert back.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=str(key))
    sd = model.state_dict()
    new = {"P": ["encoder.audio_encoder.local_encoder.conv_0.kernel",
                 "encoder.audio_encoder.local_encoder.norm_0.ema.weights",
                 "encoder.audio_encoder.local_encoder.norm_0.root",
                 "encoder.audio_encoder.pos_pre_ln.weight"],
           "N": ["encoder.audio_encoder.local_encoder.conv_0.weight",
                 "encoder.audio_encoder.local_encoder.norm_0.weight"]}[variant]
    assert all(name in sd for name in new)
    cast = serving_cast(sd)
    assert cast["encoder.blocks.layers.0.mlp.fc1.weight"].dtype == torch.bfloat16
    if variant == "P":
        assert cast["encoder.audio_encoder.local_encoder.conv_0.kernel"].dtype == torch.float32
        assert "encoder.blocks.layers.0.norm1.weight" not in sd  # no affine, no entry


@pytest.mark.parametrize("variant", ["P", "N"])
def test_converter_maps_what_jax_maps(variant, eager_sinc_init):
    """A fairseq state dict from JAX's ``export_pretrain`` of the variant's
    encoder: the port's import equals JAX's on every entry JAX maps (neither
    names PCEN's parameters or the LayerNorm before the positional convs),
    and maps the blocks without affine norms that JAX drops; the port's
    export -> import gives every parameter that fairseq names back bit for
    bit."""
    jcfg, _, params, model = _both_finetune(variant)
    enc_params = jax.tree_util.tree_map(np.asarray, params["encoder"])
    fairseq = jax_export_pretrain(enc_params, jcfg.model)
    ours, _ = convert_pretrain(fairseq, model.cfg)
    ref, _ = jax_convert_pretrain(fairseq, jcfg.model)
    ours, ref = tu.flatten_dict(ours), tu.flatten_dict(jax.tree_util.tree_map(np.asarray, ref))
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=str(key))
    unnamed = ("norm_0", "pos_pre_ln") if variant == "P" else ()
    assert not any(part in "/".join(key) for key in ours for part in unnamed)
    # JAX's converter stops a block stack at its first absent leaf, so
    # without affine norms it drops every block; the port maps them
    blocks = {key for key in ours if "block" in key}
    assert ours.keys() - ref.keys() == (blocks if variant == "P" else set())
    assert len(blocks) == 2 * (8 if variant == "P" else 12)
    enc_sd = {k[len("encoder."):]: v for k, v in model.state_dict().items()
              if k.startswith("encoder.")}
    back, _ = convert_pretrain(export_pretrain(enc_sd, model.cfg), model.cfg)
    back = params_from_jax(back)
    for name, value in back.items():
        assert torch.equal(value, enc_sd[name]), name
    missing = set(enc_sd) - set(back)
    assert all(any(part in name for part in unnamed) for name in missing)


def test_pretrain_step_with_the_options_matches_jax(monkeypatch):
    """A tiny pretraining step of variant P's encoder with the A.7 dropouts
    (activation, input, layerdrop, prenet layerdrop) at 0, against JAX's
    step under one injected mask: the loss within 1e-5, every parameter and
    EMA parameter within 1e-6 (``_check_step``)."""
    monkeypatch.setattr(jax_frontend, "np", types.SimpleNamespace(asarray=jnp.asarray))
    audio, model = VARIANTS["P"]
    a7 = dict(activation_dropout=0.0, dropout_input=0.0, layerdrop=0.0)
    both = _both("AUDIO", dict(model_kw=dict(model, **a7),
                               modality_kw=dict(audio, prenet_layerdrop=0.0)),
                 dict(model_kw=dict(audio, **model), prenet_layerdrop=0.0, **a7))
    _check_step(both, monkeypatch)


def test_update_alibi_false_freezes_nothing_in_jax():
    """``finetune.update_alibi`` False: JAX's ``build_finetune_encoder_cfg``
    changes ``audio.learned_alibi_scale`` alone, which nothing reads, and
    its finetune step still moves the ALiBi scale; the port refuses the key
    rather than train a scale that the user asked to freeze."""
    from animal2vec_tpu_torch.config import FinetuneTrainConfig

    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3, **TINY)
    on = build_finetune_encoder_cfg(jcfg.model, jcfg.finetune)
    jcfg.finetune.update_alibi = False
    off = build_finetune_encoder_cfg(jcfg.model, jcfg.finetune)
    diff = [k for k, v in tu.flatten_dict(dataclasses.asdict(on)).items()
            if tu.flatten_dict(dataclasses.asdict(off))[k] != v]
    assert diff == [("modalities", "audio", "learned_alibi_scale")]
    jcfg.optimization = JaxOptimizationConfig(lr=1e-3, max_update=10, warmup_updates=0)
    jcfg.finetune.freeze_finetune_updates = 0
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 800)))["params"]
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    rng = np.random.default_rng(2)
    batch = {"source": jnp.asarray(rng.normal(size=(1, 2, 800)).astype(np.float32)),
             "target": jnp.asarray((rng.random((1, 2, 200, 4)) < 0.2).astype(np.float32))}
    new, _ = jax_make_step(jmodel, jcfg)(JaxFinetuneState.create(params, tx), batch,
                                         jax.random.PRNGKey(1))
    scale = ("encoder", "audio_encoder", "alibi_scale")
    moved = np.abs(np.asarray(tu.flatten_dict(new.params)[scale])
                   - np.asarray(tu.flatten_dict(params)[scale]))
    assert moved.max() > 0
    with pytest.raises(NotImplementedError, match="reads nowhere"):
        FinetuneTrainConfig(update_alibi=False)


# ----------------------------------------------------- #8 dropout, drop-path


def _mlp_inputs(n, c, m, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    make = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return make(n, c).to(dtype), (make(m, c) * 0.2).to(dtype), (make(c, m) * 0.1).to(dtype), \
        make(m) * 0.1, make(c) * 0.1


def test_fused_mlp_dropout_sites_use_jax_hash():
    """#8's plain twin with the activation dropout: both sites' masks are
    JAX's ``_hash_keep`` bit for bit over (seed, row0 + row, column), and
    the output is exactly the masked math on those masks."""
    n, c, m, row0, rate = 37, 16, 24, 1000, 0.3
    seeds = (123456789, -987654321)
    x, w1, w2, b1, b2 = _mlp_inputs(n, c, m, seed=11)
    rows = np.arange(row0, row0 + n, dtype=np.int32)[:, None]
    masks = []
    for seed, width in zip(seeds, (m, c)):
        cols = np.arange(width, dtype=np.int32)[None, :]
        ref = np.asarray(jax_hash_keep(jnp.int32(seed), jnp.asarray(rows), jnp.asarray(cols),
                                       rate))
        ours = hash_keep(seed, torch.from_numpy(rows).long(), torch.from_numpy(cols).long(),
                         rate)
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert 0 < ref.mean() < 1
        masks.append(torch.from_numpy(ref))
    h = torch.nn.functional.gelu(torch.matmul(x, w1.t()) + b1) * (masks[0] / (1.0 - rate))
    want = (torch.matmul(h, w2.t()) + b2) * (masks[1] / (1.0 - rate))
    got = fm.fused_mlp_plain(x, w1, w2, b1, b2, seeds, rate, row0)
    assert torch.equal(got, want)
    assert torch.equal(fm.fused_mlp(x, w1, w2, b1, b2, seeds, rate, row0), want)
    with pytest.raises(ValueError, match="two int32 seeds"):
        fm.fused_mlp_plain(x, w1, w2, b1, b2, None, rate)


def test_fused_mlp_function_gradients_with_dropout(monkeypatch):
    """#8's autograd Function (its forward the plain twin here, on the
    CPU) with dropout: the backward's recompute regenerates both masks, and
    its gradients equal autograd through the masked plain math."""
    monkeypatch.setattr(fm, "_launch_mlp", fm.fused_mlp_plain)
    seeds, rate, row0 = (7, -9), 0.25, 40
    vals = _mlp_inputs(29, 16, 32, seed=12)
    g = torch.from_numpy(np.random.default_rng(13).normal(size=(29, 16)).astype(np.float32))
    leaves = [v.clone().requires_grad_() for v in vals]
    got = torch.autograd.grad(fm._FusedMlp.apply(*leaves, seeds, rate, row0), leaves, g)
    ref_leaves = [v.clone().requires_grad_() for v in vals]
    ref = torch.autograd.grad(fm.fused_mlp_plain(*ref_leaves, seeds, rate, row0), ref_leaves, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    plain = torch.autograd.grad(fm.fused_mlp_plain(*ref_leaves), ref_leaves, g)
    assert not torch.equal(plain[0], ref[0])  # the masks reach the gradients


def test_drop_path_draws_and_rates():
    """Each sample's factor is exactly 0 or 1 / (1 - rate), dropped with a
    frequency inside 5 binomial sigmas; a branch times its factor is 0 or
    exactly ``bf16(fp32(y) * s)``; the per-layer rates are JAX's
    ``linspace(start, end, depth)``; rate 0 draws nothing."""
    rate, b = 0.1, 20_000
    s = drop_path_scale(b, rate, Rngs.from_seed(3, "cpu"), "cpu")
    assert set(s.unique().tolist()) == {0.0, float(np.float32(keep_scale(rate)))}
    dropped = int((s == 0).sum())
    assert abs(dropped - b * rate) < 5 * np.sqrt(b * rate * (1 - rate))
    y = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(1)).bfloat16()
    s4 = torch.tensor([0.0, keep_scale(0.3), keep_scale(0.3), 0.0])
    out = apply_drop_path(y, s4)
    assert not out[0].any() and not out[3].any()
    assert torch.equal(out[1], (y[1].float() * s4[1]).bfloat16())
    stack = BlockStack(5, 32, 4, 4.0, 1e-5, drop_path=(0.0, 0.2))
    assert [blk.drop_path for blk in stack.layers] == np.asarray(
        jnp.asarray(np.linspace(0.0, 0.2, 5), dtype=jnp.float32)).tolist()
    blk = AltBlock(32, 4, drop_path=0.0).train()
    rngs = Rngs.from_seed(0, "cpu")
    before = rngs.device.get_state()
    assert blk.draws(torch.zeros(2, 5, 32), rngs)[2] is None
    assert torch.equal(rngs.device.get_state(), before)


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post-LN", "pre-LN"])
def test_drop_path_branches_in_a_block(pre_ln):
    """A block in training with drop-path and no other rate: a sample whose
    two branches are dropped gives what the block gives for x with both
    branches at 0 (post-LN: LN2(LN1(x)); pre-LN: r = mlp(norm2(x)), the
    reference's residual-free branch); every other sample is the evaluation block's only where both are
    kept at scale 1 (checked with the factors set by hand); and the post-LN
    block's MLP branch scale is #6's ``branch_scale`` (the plain twin)."""
    torch.manual_seed(0)
    blk = AltBlock(32, 4, layer_norm_first=pre_ln, drop_path=0.5).train()
    x = torch.randn(3, 7, 32)
    zero, one = torch.zeros(3), torch.ones(3)
    real = blk.draws

    def fixed(scales):
        return lambda xx, rngs: real(xx, rngs)[:2] + (scales,)

    blk.draws = fixed((zero, zero))
    dropped, _ = blk(x, None, None, Rngs.from_seed(0, "cpu"))
    blk.draws = fixed((one, one))
    kept, _ = blk(x, None, None, Rngs.from_seed(0, "cpu"))
    blk.eval()
    with torch.no_grad():
        ref, _ = blk(x, None, None)
        if pre_ln:
            torch.testing.assert_close(dropped, blk.mlp(blk.norm2(x)), rtol=1e-6, atol=1e-6)
        else:
            torch.testing.assert_close(dropped, blk.norm2(blk.norm1(x)), rtol=1e-6, atol=1e-6)
    assert torch.equal(kept.detach(), ref)
    x2 = x.reshape(-1, 32)
    args = (x, blk.norm1.weight, blk.norm1.bias, blk.mlp.fc1.weight.t(), blk.mlp.fc2.weight.t(),
            blk.mlp.fc1.bias, blk.mlp.fc2.bias, blk.norm2.weight, blk.norm2.bias)
    with torch.no_grad():
        plain, tap = fm.fused_block_plain(*args)
        assert torch.equal(fm.fused_block_plain(*args, branch_scale=one)[0], plain)
        s = torch.tensor([0.0, 2.0, 1.25])
        out, tap_s = fm.fused_block_plain(*args, branch_scale=s)
        r = fm._ln(x2, blk.norm1.weight, blk.norm1.bias, 1e-5)
        want = fm._ln(r + tap.reshape(-1, 32) * s.repeat_interleave(7)[:, None],
                      blk.norm2.weight, blk.norm2.bias, 1e-5)
    assert torch.equal(tap_s, tap)
    torch.testing.assert_close(out.reshape(-1, 32), want, rtol=1e-6, atol=1e-6)
