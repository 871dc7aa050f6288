"""Every trunk width the JAX package runs, in the port: JAX's width rule at
the three kernel call sites, and JAX's XLA route where the rule fails.

JAX takes its Pallas MLP, block and int8 dense kernels where every width is
a multiple of 128 (``pallas_serving_ok``) and composes the same function in
XLA elsewhere; the port's ``models.modules.kernel_widths`` is its copy of
that test. Held here on the CPU:

* the rule against ``pallas_serving_ok`` (forced on, ``A2V_PALLAS_SERVE=1``)
  over a grid of widths;
* at DeiT-Ti's widths (C 192, 3 heads of 64, MLP 768) in fp32: the composed
  post-LN block, a pre-LN ``Mlp`` and the int8 dense product against JAX's
  XLA modules, with the weights carried across by ``params_from_jax``:
  forward and gradient (1e-5 of each tensor's largest value, at least
  1e-5); the int8 product is serving-only in the port (as are the int8
  modes) and is held forward only, bit for bit, with its quantizers and
  its exact int32 sums;
* model level: a 2-block finetune model (1 prenet + 1 trunk block, post-LN
  with ALiBi) and a 2-block pre-LN image model at C 192 against JAX's
  logits / features within 1e-4 in fp32, in ``int8`` and ``int8_attn`` at
  the tolerances of ``tests/test_torch_int8_model.py`` (3x the JAX model's
  own response to a one-ulp change of its input), and one finetune step at
  rates 0 against JAX's (loss 1e-5, updated parameters 1e-6, as
  ``tests/test_torch_train_step.py``);
* the route: at C 192 no model calls the fused block, fused MLP or int8
  dense ops, at C 256 every block does; in training the composed route
  draws the kernels' seeds and drops the elements that the kernels' plain
  versions drop; tensor parallelism, which keeps the split fused block, is
  refused off its widths by shape alone;
* the LayerNorm of the fused blocks past C 1024 (C 1280 and 2048, where the
  kernel takes its wide instance): the plain versions of #6 and #7 against
  JAX's references of its kernels, with the residual add, the hash dropout
  and the int8 quantization, and LN1 against JAX's ``Fp32LayerNorm``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.config import (
    ImageModalityConfig, ModalitiesConfig, ModelConfig, OptimizationConfig as JaxOptConfig,
)
from animal2vec_tpu.models.data2vec2 import Data2VecMulti as JaxData2VecMulti
from animal2vec_tpu.models.modules import (
    AltBlock as JaxAltBlock, BlockConfig, Fp32LayerNorm as JaxLayerNorm,
    Int8Dense as JaxInt8Dense, Mlp as JaxMlp, pallas_serving_ok,
    quantized_matmul as jax_quantized_matmul,
)
from animal2vec_tpu.ops.fused_mlp import _ref_block_bf16
from animal2vec_tpu.ops.fused_mlp import fused_block_mlp as jax_fused_block_mlp
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model
from animal2vec_tpu.train.finetune_step import make_finetune_train_step as jax_make_step
from animal2vec_tpu.train.optim import build_optimizer as jax_build_optimizer
from animal2vec_tpu.train.state import FinetuneState as JaxFinetuneState

from animal2vec_tpu_torch.config import ImageConfig, OptimizationConfig
from animal2vec_tpu_torch.models import modules
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.models.modules import (
    AltBlock, Mlp, _xla_quantize, int32_product, kernel_widths, quantized_matmul,
)
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.ops.fused_mlp import (
    block_fc1, fused_block_int8_plain, fused_block_plain, fused_mlp_plain, hidden_chunk,
)
from animal2vec_tpu_torch.ops.int8_mm import quantize_weight
from animal2vec_tpu_torch.train.finetune_step import make_finetune_train_step
from animal2vec_tpu_torch.train.state import FinetuneState
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import _finetune_cfg
from tests.test_torch_int8_model import STEP
from tests.test_torch_int8_ops import ROWS_OFF, _rows_off
from tests.test_torch_model import TINY_LAYERS, _jittered, _port_cfg
from tests.test_torch_train_step import OPT, _batch, _train_cfg

TOL = 1e-4  # logits and features, fp32 (PERF.md section 2)
GRAD_TOL = 1e-5  # of each gradient's largest magnitude, at least 1e-5
C, H, M = 192, 3, 768  # DeiT-Ti (facebookresearch/deit, deit_tiny_patch16_224)
AUDIO = dict(embed_dim=C, num_heads=H, depth=1, prenet_depth=1, conv_pos_depth=2,
             conv_pos_width=10, conv_pos_groups=2)
IMAGE = dict(input_size=32, patch_size=8, embed_dim=C, num_heads=H, mlp_ratio=4.0,
             prenet_depth=1, depth=1, use_alibi_encoder=True, learned_alibi_scale_per_head=True,
             layer_norm_first=True)
MODES = ("int8", "int8_attn")
KERNEL_OPS = ("fused_block_mlp", "fused_block_int8", "fused_mlp", "fused_mlp_int8", "int8_dense")


@pytest.fixture(autouse=True)
def pallas_route(monkeypatch):
    """JAX's Pallas serving routes forced on where the widths allow them,
    so that the width rule alone decides."""
    monkeypatch.setenv("A2V_PALLAS_SERVE", "1")


def _rnd(rng, *shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _close_grads(ours, refs, names):
    for name, got, want in zip(names, ours, refs):
        want = np.asarray(want)
        tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol, err_msg=name)


# the width rule


@pytest.mark.parametrize("c", [192, 576, 1024, 1280, 1536])
def test_kernel_widths_is_jax_rule(c):
    for m in (768, 2304, 3072, 4 * c, 5120, 100):
        assert kernel_widths(c, m) == pallas_serving_ok(c, m), (c, m)
        assert kernel_widths(c, m, c) == pallas_serving_ok(c, m, c), (c, m)
    assert kernel_widths(c) == (c % 128 == 0)


# the composed modules against JAX's XLA modules


def _port_params(module, jparams):
    module.load_state_dict(params_from_jax(jparams), strict=True)
    return [p for _, p in module.named_parameters()], [n for n, _ in module.named_parameters()]


def test_composed_post_ln_block_matches_jax():
    """The post-LN block at C 192 (no ALiBi bias: the attention's XLA
    route on both sides) in training mode at rates 0: x_out and the tap,
    and every gradient of a seeded cotangent."""
    rng = np.random.default_rng(1)
    x = _rnd(rng, 2, 40, C)
    cot = (_rnd(rng, 2, 40, C), _rnd(rng, 2, 40, C))
    blk = JaxAltBlock(cfg=BlockConfig(dim=C, num_heads=H, norm_eps=1e-5))
    params = _jittered(jax.jit(blk.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
                       ["params"], 2)
    ours = AltBlock(C, H, eps=1e-5).train()
    leaves, names = _port_params(ours, params)
    xt = torch.from_numpy(x).requires_grad_()
    xo, tap = ours(xt, None, None, Rngs.from_seed(0, "cpu"))
    grads = torch.autograd.grad((xo, tap), [xt] + leaves, tuple(map(torch.from_numpy, cot)))

    (xo_j, tap_j), vjp = jax.vjp(jax.jit(lambda p, v: blk.apply({"params": p}, v)), params,
                                 jnp.asarray(x))
    gp_j, gx_j = vjp(tuple(map(jnp.asarray, cot)))
    np.testing.assert_allclose(xo.detach().numpy(), np.asarray(xo_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(tap.detach().numpy(), np.asarray(tap_j), rtol=0, atol=TOL)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    _close_grads(grads, [gx_j] + [ref[n].numpy() for n in names], ["x"] + names)


def test_composed_mlp_matches_jax():
    """A pre-LN block's Mlp at C 192, M 768: forward and gradients."""
    rng = np.random.default_rng(3)
    x = _rnd(rng, 2, 30, C)
    cot = _rnd(rng, 2, 30, C)
    mlp = JaxMlp(hidden_dim=M, out_dim=C)
    params = _jittered(jax.jit(mlp.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))
                       ["params"], 4)
    ours = Mlp(C, M)
    leaves, names = _port_params(ours, params)
    xt = torch.from_numpy(x).requires_grad_()
    y = ours(xt)
    grads = torch.autograd.grad(y, [xt] + leaves, torch.from_numpy(cot))
    y_j, vjp = jax.vjp(jax.jit(lambda p, v: mlp.apply({"params": p}, v)), params,
                       jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    _close_grads(grads, [gx_j] + [ref[n].numpy() for n in names], ["x"] + names)


def _int8_inputs(rows, k, n, seed):
    """x (rows, K) and a JAX kernel (K, N) with a zero row of x, a zero
    column of the kernel and values on rounding ties of their scales."""
    rng = np.random.default_rng(seed)
    x = _rnd(rng, rows, k)
    x[1] = 0.0
    x[2, :5] = (127.0, 0.5, -1.5, 2.5, -3.5)
    x[2, 5:] = 0.25
    kernel = _rnd(rng, k, n, scale=0.05)
    kernel[:, 3] = 0.0
    return x, kernel


@jax.jit
def _jax_xla_quantize(x, kernel):
    """The quantizers of ``quantized_matmul``'s XLA branch, as written at
    ``modules.py:88-93``, under jit as the model runs them."""
    w32 = kernel.astype(jnp.float32)
    w_scale = jnp.max(jnp.abs(w32), axis=0, keepdims=True) / 127.0
    w_q = jnp.round(w32 / jnp.maximum(w_scale, 1e-12)).astype(jnp.int8)
    x32 = x.astype(jnp.float32)
    x_scale = jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0
    x_q = jnp.round(x32 / jnp.maximum(x_scale, 1e-12)).astype(jnp.int8)
    return x_q, x_scale, w_q, w_scale


@pytest.mark.parametrize("rows,k,n", [(40, C, 3 * C), (40, C, C), (7, M, C), (5, 100, 36)])
def test_int8_quantizers_and_product_are_jax_bit_for_bit(rows, k, n):
    """The composed int8 product against ``quantized_matmul``'s XLA branch
    (widths off 128, so JAX composes it): the int8 values and fp32 scales
    equal, the product's fp32 result equal bit for bit (its int32 sums are
    exact on both sides); the shapes take both routes of
    ``int32_product``."""
    assert not pallas_serving_ok(k, n)
    x, kernel = _int8_inputs(rows, k, n, seed=k + n)
    xq_j, xs_j, wq_j, ws_j = map(np.asarray, _jax_xla_quantize(jnp.asarray(x), jnp.asarray(kernel)))
    weight = torch.from_numpy(kernel.T.copy())
    x_q, x_s = _xla_quantize(torch.from_numpy(x), -1)
    w_q, w_s = _xla_quantize(weight, 1)
    np.testing.assert_array_equal(x_q.numpy(), xq_j)
    np.testing.assert_array_equal(x_s.numpy(), xs_j)
    np.testing.assert_array_equal(w_q.numpy(), wq_j.T)
    np.testing.assert_array_equal(w_s.numpy(), ws_j.T)
    assert w_s[3].item() == 0.0  # floored only in the divisor
    ref = np.asarray(jax.jit(jax_quantized_matmul)(jnp.asarray(x), jnp.asarray(kernel)))
    np.testing.assert_array_equal(quantized_matmul(torch.from_numpy(x), weight).numpy(), ref)
    # Int8Dense: the product, then the bias in the compute dtype
    dense = JaxInt8Dense(features=n)
    params = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(_rnd(np.random.default_rng(0),
                                                                     n))}
    ref = np.asarray(jax.jit(dense.apply)({"params": params}, jnp.asarray(x)))
    layer = torch.nn.Linear(k, n)
    with torch.no_grad():
        layer.weight.copy_(weight)
        layer.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    # XLA contracts the last product and the bias add into one fma, so the
    # port's product, rounded before the add, may lie half an ulp of the
    # product apart (one ulp of the largest product bounds it)
    product = quantized_matmul(torch.from_numpy(x), weight).numpy()
    np.testing.assert_allclose(modules._dense(torch.from_numpy(x), layer, True).detach().numpy(),
                               ref, rtol=0, atol=np.spacing(np.abs(product).max()))


@pytest.mark.parametrize("rows,k,n", [(20, C, 3 * C), (300, 4096, 24), (5, 100, 36),
                                      (17, 8, 8)])
def test_int32_product_is_exact(rows, k, n):
    """Both routes of ``int32_product`` (``torch._int_mm`` where its shape
    rules hold, else float64) give the exact int32 sums, at the int8 range's
    ends too (all 127 and -127 over K 4096)."""
    rng = np.random.default_rng(rows + k)
    a = rng.integers(-127, 128, size=(rows, k), dtype=np.int8)
    b = rng.integers(-127, 128, size=(n, k), dtype=np.int8)
    a[0], b[0], b[1] = 127, 127, -127
    got = int32_product(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


# model level


def _audio_cfg(mode="bf16"):
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=1,
                         **AUDIO)
    jcfg.model.matmul_impl = mode
    return jcfg


@functools.lru_cache(maxsize=None)
def _audio_params():
    """The audio model's seeded JAX weights, shared by every mode (the int8
    modes quantize the same kernels) and by the step."""
    params = jax.jit(jax_build_finetune_model(_audio_cfg()).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 800)))["params"]
    return _jittered(params, seed=1)


def _audio_models(mode="bf16"):
    jcfg = _audio_cfg(mode)
    jmodel = jax_build_finetune_model(jcfg)
    params = _audio_params()
    model = FinetuneModel(dataclasses.replace(_port_cfg(jcfg, TINY_LAYERS, **AUDIO),
                                              matmul_impl=mode))
    model.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, jmodel, params, model.eval()


def _image_jax_model(mode="bf16"):
    cfg = ImageConfig(**IMAGE, matmul_impl=mode)
    image = ImageModalityConfig(
        prenet_depth=cfg.prenet_depth, input_size=cfg.input_size, patch_size=cfg.patch_size,
        in_chans=cfg.in_chans, embed_dim=cfg.patch_embed_dim,
        use_alibi_encoder=cfg.use_alibi_encoder,
        learned_alibi_scale_per_head=cfg.learned_alibi_scale_per_head,
        alibi_distance=cfg.alibi_distance, num_alibi_heads=cfg.num_heads,
        model_depth=cfg.depth, decoder=None)
    jcfg = ModelConfig(
        depth=cfg.depth, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads,
        mlp_ratio=cfg.mlp_ratio, layer_norm_first=cfg.layer_norm_first,
        matmul_impl=cfg.matmul_impl, supported_modality="IMAGE", encoder_dropout=0.0,
        attention_dropout=0.0, post_mlp_drop=0.0, remat=False,
        modalities=ModalitiesConfig(image=image))
    return cfg, JaxData2VecMulti(cfg=jcfg)


@functools.lru_cache(maxsize=None)
def _image_params():
    """The image model's seeded JAX weights, shared by every mode."""
    jmodel = _image_jax_model()[1]
    init = jax.jit(lambda key, x: jmodel.init({"params": key}, x, "IMAGE",
                                              method=JaxData2VecMulti.extract_features))
    return _jittered(init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"], seed=1)


def _image_models(mode="bf16"):
    cfg, jmodel = _image_jax_model(mode)
    params = _image_params()
    model = Data2VecMulti(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return jmodel, params, model.eval()


def _audio_logits(jmodel, params, model, src):
    apply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x)["encoder_out"])
    with torch.no_grad():
        ours = model(torch.from_numpy(src))["encoder_out"].numpy()
    return ours, lambda s: np.asarray(apply(params, jnp.asarray(s)))


def _image_features(jmodel, params, model, imgs):
    apply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, "IMAGE",
                                              method=JaxData2VecMulti.extract_features)["x"])
    with torch.no_grad():
        ours = model.extract_features(torch.from_numpy(imgs), "IMAGE")["x"].numpy()
    return ours, lambda s: np.asarray(apply(params, jnp.asarray(s)))


def _inputs(kind):
    rng = np.random.default_rng(12)
    if kind == "audio":
        return rng.normal(size=(2, 800)).astype(np.float32)
    return rng.normal(size=(2, 32, 32, 3)).astype(np.float32)


def _run(kind, mode):
    if kind == "audio":
        _, jmodel, params, model = _audio_models(mode)
        return _audio_logits(jmodel, params, model, _inputs(kind))
    jmodel, params, model = _image_models(mode)
    return _image_features(jmodel, params, model, _inputs(kind))


@pytest.mark.parametrize("kind", ["audio", "image"])
def test_model_matches_jax_fp32(kind):
    """The post-LN ALiBi finetune model's logits and the pre-LN image
    model's features at C 192 against JAX's, within 1e-4."""
    ours, jax_run = _run(kind, "bf16")
    ref = jax_run(_inputs(kind))
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["audio", "image"])
@pytest.mark.parametrize("mode", MODES)
def test_model_int8_matches_jax(kind, mode, monkeypatch):
    """The int8 modes at C 192 (JAX's XLA int8 products in the MLPs and,
    in int8_attn, the projections; the int8 ALiBi attention kernel in the
    audio int8_attn trunk): the output's relative norm error at most 3x
    the JAX model's own response to a one-ulp change of its input, as
    ``tests/test_torch_int8_model.py`` holds the lane-aligned model (and,
    as it does, with JAX's int8 attention kernel in interpret mode)."""
    monkeypatch.setenv("A2V_FLASH_INTERPRET", "1")
    ours, jax_run = _run(kind, mode)
    src = _inputs(kind)
    ref = jax_run(src)
    ref_ulp = jax_run(np.nextafter(src, np.float32(np.inf)))
    rel = lambda a: np.linalg.norm(a - ref) / np.linalg.norm(ref)  # noqa: E731
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert rel(ours) <= 3 * rel(ref_ulp), (rel(ours), rel(ref_ulp))


def test_int8_block_on_jax_inputs():
    """One composed int8_attn post-LN block at C 192 (no bias) against JAX's
    on the same inputs, at the op tolerances of the int8 tests: at most 5 %
    of rows beyond 1e-5, the largest error a quantization step."""
    rng = np.random.default_rng(7)
    x = _rnd(rng, 2, 40, C)
    blk = JaxAltBlock(cfg=BlockConfig(dim=C, num_heads=H, norm_eps=1e-5, matmul_impl="int8_attn"))
    params = _jittered(jax.jit(blk.init)({"params": jax.random.PRNGKey(5)}, jnp.asarray(x))
                       ["params"], 6)
    refs = jax.jit(lambda p, v: blk.apply({"params": p}, v))(params, jnp.asarray(x))
    ours = AltBlock(C, H, eps=1e-5, matmul_impl="int8_attn")
    ours.load_state_dict(params_from_jax(params), strict=True)
    ours.quantize_weights()
    with torch.no_grad():
        outs = ours.eval()(torch.from_numpy(x), None, None)
    for got, ref in zip(outs, refs):
        share, worst = _rows_off(got.numpy(), ref)
        assert share <= ROWS_OFF and worst <= STEP * np.abs(ref).max(), (share, worst)


def test_finetune_step_matches_jax():
    """One finetune step of the C 192 audio model at rates 0 (update_freq
    1, clipping, weight decay) against JAX's: the loss within 1e-5, every
    updated parameter within 1e-6, and the trunk's gradients nonzero."""
    jcfg = _audio_cfg()
    opt = dict(OPT, update_freq=1)
    jcfg.optimization = JaxOptConfig(**opt)
    jcfg.finetune.freeze_finetune_updates = 0
    jmodel = jax_build_finetune_model(jcfg)
    params = _audio_params()
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    batch = {k: v[:1] for k, v in _batch(seed=2).items()}
    jstate, jmetrics = jax_make_step(jmodel, jcfg)(
        JaxFinetuneState.create(params, tx), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    tcfg = dataclasses.replace(_train_cfg(0), optimization=OptimizationConfig(**opt))
    model = FinetuneModel(_port_cfg(jcfg, TINY_LAYERS, **AUDIO), train=tcfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = FinetuneState.create(model, tcfg)
    metrics = make_finetune_train_step(tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, Rngs.from_seed(0, "cpu"))
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    ours = state.model.state_dict()
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    grads = dict(state.model.named_parameters())
    assert grads["encoder.blocks.layers.0.mlp.fc1.weight"].grad.abs().sum() > 0


# the route


class _Calls:
    """Count the calls of the kernel ops where ``models.modules`` looks
    them up."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(KERNEL_OPS, 0)
        for name in KERNEL_OPS:
            monkeypatch.setattr(modules, name, self._wrap(name, getattr(modules, name)))

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.n[name] += 1
            return fn(*args, **kwargs)
        return counted


def _tiny_model(kind, c, heads, mode):
    if kind == "audio":
        from animal2vec_tpu_torch.config import FinetuneConfig

        cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS,
                                  average_top_k_layers=1, matmul_impl=mode,
                                  **dict(AUDIO, embed_dim=c, num_heads=heads))
        model = FinetuneModel(cfg, train=_train_cfg(0)).eval()
        return model, lambda: model(torch.from_numpy(_inputs(kind)))
    cfg = ImageConfig(**dict(IMAGE, embed_dim=c, num_heads=heads), matmul_impl=mode)
    model = Data2VecMulti(cfg).eval()
    return model, lambda: model.extract_features(torch.from_numpy(_inputs(kind)), "IMAGE")


# each block's calls of the kernel ops at kernel widths, per mode and layout
_ROUTE = {("audio", "bf16"): {"fused_block_mlp": 1},
          ("audio", "int8"): {"fused_block_int8": 1},
          ("audio", "int8_attn"): {"fused_block_int8": 1, "int8_dense": 2},
          ("image", "bf16"): {"fused_mlp": 1},
          ("image", "int8"): {"fused_mlp_int8": 1},
          ("image", "int8_attn"): {"fused_mlp_int8": 1, "int8_dense": 2}}


@pytest.mark.parametrize("kind", ["audio", "image"])
@pytest.mark.parametrize("mode", ("bf16",) + MODES)
def test_route_follows_the_width_rule(kind, mode, monkeypatch):
    """At C 192 (H 3) no block calls a kernel op; at C 256 (H 4) each of
    the two blocks calls its ops once per product, in serving and (bf16)
    in training."""
    calls = _Calls(monkeypatch)
    for c, heads in ((192, 3), (256, 4)):
        model, run = _tiny_model(kind, c, heads, mode)
        model.quantize_weights()
        for n in calls.n:
            calls.n[n] = 0
        with torch.no_grad():
            run()
        want = dict.fromkeys(KERNEL_OPS, 0)
        if c == 256:
            want.update({k: 2 * v for k, v in _ROUTE[kind, mode].items()})
        assert calls.n == want, (c, calls.n)
    if mode == "bf16" and kind == "audio":
        for c, heads in ((192, 3), (256, 4)):
            model, _ = _tiny_model(kind, c, heads, mode)
            for n in calls.n:
                calls.n[n] = 0
            model.train()(torch.from_numpy(_inputs(kind)), rngs=Rngs.from_seed(0, "cpu"))
            assert calls.n["fused_block_mlp"] == (2 if c == 256 else 0), calls.n


def test_composed_dropout_takes_the_kernels_masks():
    """In training with dropout off the kernels' widths, the composed route
    draws nothing of its own: a post-LN block takes the fused block's three
    int32 seeds and a pre-LN block its MLP's two, and each dropout site
    drops what the kernel's plain version drops from those seeds (the fp32
    values within 1e-5); a microbatch's slice of the draws drops its rows'
    elements of the whole batch's masks."""
    torch.manual_seed(0)
    x = torch.randn(2, 10, C)
    post = AltBlock(C, H, activation_dropout=0.5, post_mlp_drop=0.25).train()
    draws = post.draws(x, Rngs.from_seed(0, "cpu"))
    seeds, row0 = draws[1]
    assert len(seeds) == 3 and row0 == 0
    xo, tap = post(x, None, None, draws=draws)
    a = x + post.attn(x, None, None, draws=draws[0])
    fc1, fc2 = post.mlp.fc1, post.mlp.fc2
    xo_p, tap_p = fused_block_plain(a, post.norm1.weight, post.norm1.bias, fc1.weight.t(),
                                    fc2.weight.t(), fc1.bias, fc2.bias, post.norm2.weight,
                                    post.norm2.bias, 1e-5, seeds, 0.5, 0.25)
    assert torch.equal(tap == 0, tap_p == 0) and (tap == 0).float().mean() > 0.3
    torch.testing.assert_close(tap, tap_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(xo, xo_p, rtol=0, atol=1e-5)
    sliced = post.slice_draws(draws, 1, 2, 10)
    _, tap_1 = post(x[1:2], None, None, draws=sliced)
    assert torch.equal(tap_1 == 0, tap[1:2] == 0)
    pre = AltBlock(C, H, activation_dropout=0.5, layer_norm_first=True).train()
    _, (residual, (seeds, row0)), _ = pre.draws(x, Rngs.from_seed(1, "cpu"))
    assert residual is None and len(seeds) == 2
    y = pre.mlp(x, None, seeds, 0.5, 20)
    y_p = fused_mlp_plain(x, pre.mlp.fc1.weight, pre.mlp.fc2.weight, pre.mlp.fc1.bias,
                          pre.mlp.fc2.bias, seeds, 0.5, 20)
    assert torch.equal(y == 0, y_p == 0) and (y == 0).float().mean() > 0.3
    torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)


def test_tensor_parallelism_off_128_is_refused():
    """Tensor parallelism needs the split of #6, which keeps its kernels'
    widths (C and each rank's M / model_parallel multiples of 128): off
    them it is refused by shape alone, in the config and in
    ``apply_layout``, on any device (ROADMAP A.10)."""
    from animal2vec_tpu_torch import recipes
    from animal2vec_tpu_torch.config import FinetuneConfig, load_config
    from animal2vec_tpu_torch.parallel import mesh
    from animal2vec_tpu_torch.parallel.layout import apply_layout
    from animal2vec_tpu_torch.parallel.mesh import Axis

    ft = str(recipes.RECIPES["finetune_100"])
    for dims in (["model.embed_dim=192", "model.num_heads=3"],
                 ["model.embed_dim=128", "model.num_heads=4", "model.mlp_ratio=3.0"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
            load_config(ft, ["distributed.model_parallel=2", *dims])
    assert load_config(ft, ["distributed.model_parallel=2", "model.embed_dim=128",
                            "model.num_heads=4"]).distributed.model_parallel == 2
    cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS, average_top_k_layers=1,
                              **AUDIO)
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        apply_layout(FinetuneModel(cfg), mesh.DataParallel(model=Axis(0, 2)))


# the fused blocks' LayerNorm past C 1024


def _block_args(n, c, m, seed):
    rng = np.random.default_rng(seed)
    w = (2.0 / (c + m)) ** 0.5
    return (_rnd(rng, n, c), _rnd(rng, c, scale=0.1, shift=1.0), _rnd(rng, c, scale=0.1),
            _rnd(rng, c, m, scale=w), _rnd(rng, m, c, scale=w), _rnd(rng, m, scale=0.1),
            _rnd(rng, c, scale=0.1), _rnd(rng, c, scale=0.1, shift=1.0), _rnd(rng, c, scale=0.1))


@pytest.mark.parametrize("c", [1280, 2048])
def test_wide_block_plain_matches_jax_reference(c):
    """#6's plain version at C 1280 / 2048 (M 4C, 24 rows) with the three
    dropout sites (the residual add and the hash dropout of LN2) against
    JAX's ``_ref_block_bf16`` in fp32 (1e-5; JAX's GELU takes the A&S erf);
    its LN1 (``block_fc1``'s r) against JAX's ``Fp32LayerNorm`` in fp32
    (1e-5) and bf16 (one bf16 ulp)."""
    args = _block_args(24, c, 4 * c, seed=c)
    seeds = (7, -9, 2**31 - 3)
    xo, t = fused_block_plain(*map(torch.from_numpy, args), 1e-5, seeds, 0.1, 0.2)
    xo_j, t_j = jax.jit(lambda *a: _ref_block_bf16(
        *a[:4], a[5], a[4], *a[6:], 1e-5, jnp.asarray(seeds, jnp.int32), 0.1, 0.2))(
        *map(jnp.asarray, args))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xo.numpy(), np.asarray(xo_j), rtol=0, atol=1e-5)
    assert (t.numpy() == 0).any()  # the fc2 site dropped
    ln = JaxLayerNorm(epsilon=1e-5)
    p = {"scale": jnp.asarray(args[1]), "bias": jnp.asarray(args[2])}
    x, s, b, w1 = (torch.from_numpy(a) for a in args[:4])
    for dtype in (torch.float32, torch.bfloat16):
        r = block_fc1(x.to(dtype), s, b, w1.to(dtype), None)[0]
        xj = jnp.asarray(x.to(dtype).float().numpy())
        if dtype == torch.bfloat16:
            xj = xj.astype(jnp.bfloat16)
        ref = np.asarray(ln.apply({"params": p}, xj).astype(jnp.float32))
        # bf16: within one ulp (2^-7 of the value)
        rtol = 0.0 if dtype == torch.float32 else 2.0**-7
        np.testing.assert_allclose(r.float().numpy(), ref, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("c", [1280, 2048])
def test_wide_int8_block_plain_matches_jax_kernel(c):
    """#7's plain version at C 1280 / 2048 (M 4C: hidden chunks of 1024, r
    quantized per row over the whole C) against JAX's int8 block kernel in
    interpret mode, at the op tolerances of ``tests/test_torch_int8_ops.py``."""
    x, l1s, l1b, w1, w2, b1, b2, l2s, l2b = _block_args(16, c, 4 * c, seed=c + 1)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1.T.copy()))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2.T.copy()))
    assert hidden_chunk(4 * c) == 1024
    t = torch.from_numpy
    xo, tap = fused_block_int8_plain(t(x), t(l1s), t(l1b), w1_q, w1_s, t(b1), w2_q, w2_s, t(b2),
                                     t(l2s), t(l2b), 1e-5)
    j = jnp.asarray
    xo_j, tap_j = jax_fused_block_mlp(
        j(x), j(l1s), j(l1b), j(w1_q.numpy().T), j(w2_q.numpy().T), j(b1), j(b2), j(l2s),
        j(l2b), 1e-5, j(w1_s.numpy()), j(w2_s.numpy()))
    for ours, ref, step in ((tap, tap_j, 5e-3), (xo, xo_j, 5e-2)):
        share, worst = _rows_off(ours.numpy(), ref)
        assert share <= ROWS_OFF and worst <= step, (share, worst)


def test_int8_configs_take_every_width():
    """The int8 modes are taken at widths off 128 in every configuration
    that names them, as JAX serves them there: the audio and image
    encoders' and the EMA teacher's."""
    from animal2vec_tpu_torch.config import FinetuneConfig, PretrainConfig

    for mode in MODES:
        assert FinetuneConfig(embed_dim=C, num_heads=H, matmul_impl=mode).matmul_impl == mode
        assert ImageConfig(embed_dim=96, num_heads=2, matmul_impl=mode).embed_dim == 96
        teacher = PretrainConfig(model=FinetuneConfig(embed_dim=C, num_heads=H),
                                 teacher_matmul_impl=mode)
        assert teacher.teacher_matmul_impl == mode
