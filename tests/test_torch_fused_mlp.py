"""The port's fused post-LN block against the JAX package's.

On the CPU the port's ``fused_block_mlp`` runs its plain version; the JAX
``fused_block_mlp`` runs ``_kernel_bf16_block`` in interpret mode. C=128,
M=512 and N=300 rows, which do not fill the JAX kernel's 256-row block.
fp32 tolerance 1e-5 max-abs (the JAX kernel's A&S erf is within 1.5e-7 of
erf; sums in another order); bf16 6e-2 max-abs (LN and GELU outputs round
to bf16, a few ulps of values up to ~4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.ops.fused_mlp import fused_block_mlp as jax_fused_block_mlp

from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_block_plain

FP32_TOL = 1e-5
BF16_TOL = 6e-2


def _inputs(n, c, m, seed, affine=True):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    x = rnd(n, c)
    w1 = rnd(c, m, scale=(2.0 / (c + m)) ** 0.5)
    w2 = rnd(m, c, scale=(2.0 / (c + m)) ** 0.5)
    b1, b2 = rnd(m, scale=0.1), rnd(c, scale=0.1)
    if affine:
        ln = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
              rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1))
    else:
        ln = (None, None, None, None)
    return x, ln, w1, w2, b1, b2


def _run_port(x, ln, w1, w2, b1, b2, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(a)
    xo, tap = fused_block_mlp(
        t(x).to(dtype), t(ln[0]), t(ln[1]), t(w1).to(dtype), t(w2).to(dtype),
        t(b1), t(b2), t(ln[2]), t(ln[3]), 1e-5,
    )
    return xo.float().numpy(), tap.float().numpy()


def _run_jax(x, ln, w1, w2, b1, b2, dtype=jnp.float32):
    j = lambda a: None if a is None else jnp.asarray(a)
    xo, tap = jax_fused_block_mlp(
        j(x).astype(dtype), j(ln[0]), j(ln[1]), j(w1).astype(dtype), j(w2).astype(dtype),
        j(b1), j(b2), j(ln[2]), j(ln[3]), 1e-5,
    )
    return np.asarray(xo.astype(jnp.float32)), np.asarray(tap.astype(jnp.float32))


@pytest.mark.parametrize("affine", [True, False])
def test_matches_jax_kernel_fp32(affine):
    args = _inputs(300, 128, 512, seed=10, affine=affine)
    xo, tap = _run_port(*args)
    xo_j, tap_j = _run_jax(*args)
    assert xo.shape == tap.shape == (300, 128)
    np.testing.assert_allclose(tap, tap_j, rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(xo, xo_j, rtol=0, atol=FP32_TOL)


def test_matches_jax_kernel_bf16():
    args = _inputs(300, 128, 512, seed=11)
    xo, tap = _run_port(*args, dtype=torch.bfloat16)
    xo_j, tap_j = _run_jax(*args, dtype=jnp.bfloat16)
    assert np.abs(tap - tap_j).max() <= BF16_TOL
    assert np.abs(xo - xo_j).max() <= BF16_TOL


def test_leading_dims_and_no_count_on_cpu():
    x, ln, w1, w2, b1, b2 = _inputs(2 * 37, 128, 256, seed=12)
    before = fused_block_mlp.launches
    xo, tap = fused_block_mlp(
        torch.from_numpy(x).reshape(2, 37, 128), *map(torch.from_numpy, ln[:2]),
        torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(b1),
        torch.from_numpy(b2), *map(torch.from_numpy, ln[2:]),
    )
    assert fused_block_mlp.launches == before
    assert xo.shape == tap.shape == (2, 37, 128)
    flat = _run_port(x, ln, w1, w2, b1, b2)
    np.testing.assert_array_equal(xo.reshape(-1, 128).numpy(), flat[0])


def test_other_devices_raise():
    x = torch.empty((4, 128), device="meta")
    w = torch.empty((128, 256), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_block_mlp(x, None, None, w, w.t(), None, None, None, None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 1024, 4096), (333, 768, 3072)])
@pytest.mark.parametrize("affine", [True, False])
def test_kernel_matches_plain_on_card(cuda, affine, shape):
    """a2v-large's and ViT-B/16's widths, at row counts that leave the last
    128-row tile of the GEMMs part empty."""
    x, ln, w1, w2, b1, b2 = _inputs(*shape, seed=13, affine=affine)
    t = lambda a, dt=torch.float32: None if a is None else torch.from_numpy(a).to(cuda, dt)
    args = (t(x, torch.bfloat16), t(ln[0]), t(ln[1]), t(w1, torch.bfloat16),
            t(w2, torch.bfloat16), t(b1), t(b2), t(ln[2]), t(ln[3]), 1e-5)
    before = fused_block_mlp.launches
    xo, tap = fused_block_mlp(*args)
    torch.cuda.synchronize()
    assert fused_block_mlp.launches == before + 1
    xo_p, tap_p = fused_block_plain(*args)
    for got, want in ((tap, tap_p), (xo, xo_p)):
        err = (got.float() - want.float()).abs()
        assert (err <= 3e-2 + 2e-2 * want.float().abs()).all(), err.max().item()
