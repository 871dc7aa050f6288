"""The image modality's ops in the port against the JAX package's: the helper
copies (2-D ALiBi bias, sin-cos table, patchify), the dense-bias attention
(``xla_attention``, and jax's stock TPU flash kernel in interpret mode,
whose bias scaling the port does not copy) and the plain fused MLP in bf16
and int8 (``fused_mlp``'s Pallas kernels in interpret mode).

Tolerances: fp32 1e-5 max-abs (the same math in another summation order;
the JAX kernels' A&S erf is within 1.5e-7 of erf). int8: at most 5 % of the
output rows beyond 1e-5, each within one quantization step of the next
product (a value within ~1e-7 of an int8 rounding boundary lands one step
apart), as ``tests/test_torch_int8_ops.py`` holds the int8 block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.config import ImageModalityConfig, ModelConfig
from animal2vec_tpu.models.attention import flash_attention_tpu, xla_attention
from animal2vec_tpu.models.images import patchify as jax_patchify
from animal2vec_tpu.models.images import sincos_pos_embed_2d as jax_sincos
from animal2vec_tpu.models.images import unpatchify as jax_unpatchify
from animal2vec_tpu.ops.alibi import alibi_bias_2d as jax_alibi_bias_2d
from animal2vec_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from animal2vec_tpu.ops.int8_mm import quantize_weight as jax_quantize_weight

from animal2vec_tpu_torch.config import ImageConfig
from animal2vec_tpu_torch.models.images import patchify, sincos_pos_embed_2d, unpatchify
from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d
from animal2vec_tpu_torch.ops.bias_attention import bias_attention_plain, bias_flash_attention
from animal2vec_tpu_torch.ops.fused_mlp import (
    fused_mlp, fused_mlp_int8, fused_mlp_int8_plain, fused_mlp_plain, hidden_chunk,
)
from animal2vec_tpu_torch.ops.int8_mm import quantize_weight

from tests.test_torch_image_kernels import _mlp_inputs
from tests.test_torch_int8_ops import ROWS_OFF, _rows_off

TOL = 1e-5


def _rnd(rng, *shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def test_config_defaults_match_jax():
    """ImageConfig's defaults are the JAX ModelConfig's and
    ImageModalityConfig's, one ALiBi head per trunk head (``resolve``)."""
    m, img = ModelConfig(), ImageModalityConfig()
    expected = {
        "input_size": img.input_size, "patch_size": img.patch_size, "in_chans": img.in_chans,
        "patch_embed_dim": img.embed_dim, "fixed_positions": img.fixed_positions,
        "prenet_depth": img.prenet_depth, "depth": m.depth, "embed_dim": m.embed_dim,
        "num_heads": m.num_heads, "mlp_ratio": m.mlp_ratio, "norm_eps": m.norm_eps,
        "layer_norm_first": m.layer_norm_first, "end_of_block_targets": m.end_of_block_targets,
        "matmul_impl": m.matmul_impl, "use_alibi_encoder": img.use_alibi_encoder,
        "alibi_scale": img.alibi_scale,
        "learned_alibi_scale_per_head": img.learned_alibi_scale_per_head,
        "learned_alibi_scale_per_layer": img.learned_alibi_scale_per_layer,
        "alibi_distance": img.alibi_distance, "num_extra_tokens": img.num_extra_tokens,
        "remat": m.remat, "remat_scope": m.remat_scope, "remat_decoder": m.remat_decoder,
    }
    ours = ImageConfig()
    assert set(expected) == {f.name for f in dataclasses.fields(ours)}
    for name, value in expected.items():
        assert getattr(ours, name) == value, name
    assert ours.norm_eps == 1e-6 and ours.num_patches == 196 and ours.n_blocks == 12
    assert m.norm_affine and img.alibi_dims == 2


@pytest.mark.parametrize("kw,err", [
    (dict(num_extra_tokens=1), NotImplementedError),
    (dict(remat_scope="layer"), ValueError),
    (dict(alibi_distance="chebyshev"), ValueError),
    (dict(input_size=100), ValueError),
    (dict(matmul_impl="int4"), ValueError),
])
def test_config_refuses(kw, err):
    with pytest.raises(err):
        ImageConfig(**kw)


@pytest.mark.parametrize("distance", ["manhattan", "euclidean"])
@pytest.mark.parametrize("patches,heads", [(196, 12), (16, 2), (49, 5)])
def test_helper_copies_equal_originals(distance, patches, heads):
    np.testing.assert_array_equal(alibi_bias_2d(patches, heads, distance),
                                  np.asarray(jax_alibi_bias_2d(patches, heads, distance)))
    grid = int(patches**0.5)
    np.testing.assert_array_equal(sincos_pos_embed_2d(4 * heads * 8, grid),
                                  jax_sincos(4 * heads * 8, grid))
    imgs = np.random.default_rng(patches).normal(size=(2, grid * 8, grid * 8, 3))
    imgs = imgs.astype(np.float32)
    ours = patchify(torch.from_numpy(imgs), 8)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_patchify(jnp.asarray(imgs), 8)))
    np.testing.assert_array_equal(unpatchify(ours, 8).numpy(), imgs)
    np.testing.assert_array_equal(
        unpatchify(ours, 8).numpy(), np.asarray(jax_unpatchify(jnp.asarray(ours.numpy()), 8)))


def _attention_inputs(b, t, h, seed, bias="uniform"):
    rng = np.random.default_rng(seed)
    q, k, v = (_rnd(rng, b, t, h, 64) for _ in range(3))
    dense = None
    if bias == "uniform":
        dense = alibi_bias_2d(t, h)[None] * 0.7
    elif bias == "per-row":
        dense = _rnd(rng, b, h, t, t)
    return q, k, v, dense


@pytest.mark.parametrize("bias", ["uniform", "per-row", None])
@pytest.mark.parametrize("masked", [False, True])
def test_bias_attention_plain_matches_xla_attention(bias, masked):
    """With a batch-uniform 2-D ALiBi bias, a per-batch bias or none; with a
    key mask whose last batch row masks every key (that row is the mean of
    V, finite)."""
    b, t, h = 3, 49, 2
    q, k, v, dense = _attention_inputs(b, t, h, seed=40, bias=bias)
    mask = None
    if masked:
        mask = np.zeros((b, t), bool)
        mask[0, -9:] = True
        mask[2] = True
    t_ = lambda a: None if a is None else torch.from_numpy(a)
    j_ = lambda a: None if a is None else jnp.asarray(a)
    ours = bias_flash_attention(t_(q), t_(k), t_(v), t_(dense), t_(mask)).numpy()
    ref = np.asarray(xla_attention(j_(q), j_(k), j_(v),
                                   None if dense is None else jnp.broadcast_to(j_(dense),
                                                                               (b, h, t, t)),
                                   j_(mask)))
    assert ours.shape == (b, t, h, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    if masked:
        np.testing.assert_allclose(ours[2], np.broadcast_to(v[2].mean(0), ours[2].shape),
                                   rtol=0, atol=TOL)


def test_bias_attention_bf16_matches_xla_attention():
    b, t, h = 2, 64, 2
    q, k, v, dense = _attention_inputs(b, t, h, seed=41)
    ours = bias_attention_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                torch.from_numpy(dense)).float().numpy()
    ref = xla_attention(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                        jnp.broadcast_to(jnp.asarray(dense), (b, h, t, t)))
    # one bf16 rounding of the output apart at most (values up to ~3)
    assert np.abs(ours - np.asarray(ref.astype(jnp.float32))).max() <= 2**-7 * 4


def test_stock_tpu_flash_kernel_scales_the_bias():
    """jax's stock TPU flash kernel (``flash_attention_tpu`` at T >= 1024 or
    ``attn_impl=flash`` on a TPU), run in TPU interpret mode, computes
    softmax((q.k + bias) * D^-0.5): it equals the port given bias * D^-0.5,
    and is far from the port given the bias (the ``xla_attention``
    contract, which the port follows)."""
    from jax.experimental.pallas import tpu as pltpu

    b, t, h = 1, 128, 2
    rng = np.random.default_rng(42)
    q, k, v = (_rnd(rng, b, t, h, 64) for _ in range(3))
    bias = _rnd(rng, b, h, t, t)
    with pltpu.force_tpu_interpret_mode():
        stock = np.asarray(flash_attention_tpu(*map(jnp.asarray, (q, k, v, bias))))
    ours = lambda bb: bias_flash_attention(*map(torch.from_numpy, (q, k, v, bb))).numpy()
    np.testing.assert_allclose(stock, ours(bias * np.float32(64**-0.5)), rtol=0, atol=TOL)
    assert np.abs(stock - ours(bias)).max() > 100 * TOL


@pytest.mark.parametrize("n", [300, 64])
def test_fused_mlp_plain_matches_jax_kernel(n):
    """fp32 rows through the port's plain version and the Pallas
    ``_kernel_bf16`` (interpret mode), nn.Linear layout on the port's side."""
    x, w1, w2, b1, b2 = _mlp_inputs(n, 128, 512, seed=43)
    ours = fused_mlp(*map(torch.from_numpy, (x, w1, w2, b1, b2))).numpy()
    ref = jax_fused_mlp(jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(w2.T), jnp.asarray(b1),
                        jnp.asarray(b2), block_n=512, block_m=256)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=TOL)


def test_fused_mlp_bf16_and_leading_dims():
    x, w1, w2, b1, b2 = _mlp_inputs(2 * 33, 128, 256, seed=44)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = [torch.from_numpy(w).to(torch.bfloat16) for w in (w1, w2)]
    ours = fused_mlp_plain(xb.reshape(2, 33, 128), *wb, torch.from_numpy(b1),
                           torch.from_numpy(b2))
    assert ours.shape == (2, 33, 128) and ours.dtype == torch.bfloat16
    ref = jax_fused_mlp(jnp.asarray(x).astype(jnp.bfloat16),
                        jnp.asarray(w1.T).astype(jnp.bfloat16),
                        jnp.asarray(w2.T).astype(jnp.bfloat16), jnp.asarray(b1), jnp.asarray(b2))
    # one bf16 rounding of outputs up to ~2 apart, plus h's rounding flips
    err = np.abs(ours.reshape(-1, 128).float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert err.max() <= 2**-7 * 2


@pytest.mark.parametrize("m", [2048, 512])
def test_fused_mlp_int8_plain_matches_jax_kernel(m):
    """The Pallas ``_kernel_int8`` in interpret mode against the port's plain
    version on the same int8 weights: M 2048 re-quantizes h in two 1024-wide
    chunks, M 512 in one."""
    x, w1, w2, b1, b2 = _mlp_inputs(300, 128, m, seed=45)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2))
    # under jit, as the JAX model quantizes: XLA multiplies by fp32(1/127)
    jw1_q, jw1_s = jax.jit(jax_quantize_weight)(jnp.asarray(w1.T))
    jw2_q, jw2_s = jax.jit(jax_quantize_weight)(jnp.asarray(w2.T))
    np.testing.assert_array_equal(w1_q.numpy().T, np.asarray(jw1_q))
    np.testing.assert_array_equal(w2_s.numpy(), np.asarray(jw2_s))
    assert hidden_chunk(m) == min(m, 1024)
    ours = fused_mlp_int8(torch.from_numpy(x), w1_q, w1_s, torch.from_numpy(b1), w2_q, w2_s,
                          torch.from_numpy(b2)).numpy()
    ref = np.asarray(jax_fused_mlp(jnp.asarray(x), jw1_q, jw2_q, jnp.asarray(b1),
                                   jnp.asarray(b2), jw1_s, jw2_s, block_n=512, block_m=1024))
    share, worst = _rows_off(ours, ref)
    assert share <= ROWS_OFF and worst <= 2e-2 * np.abs(ref).max(), (share, worst)
    plain = fused_mlp_int8_plain(torch.from_numpy(x), w1_q, w1_s, torch.from_numpy(b1), w2_q,
                                 w2_s, torch.from_numpy(b2))
    np.testing.assert_array_equal(plain.numpy(), ours)


def test_other_devices_raise():
    x = torch.empty((4, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bias_flash_attention(x, x, x)
    w = torch.empty((256, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_mlp(torch.empty((4, 128), device="meta"), w, w.t())
    w8 = torch.empty((256, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_mlp_int8(torch.empty((4, 128), device="meta"), w8, None, None, w8.t(), None, None)
