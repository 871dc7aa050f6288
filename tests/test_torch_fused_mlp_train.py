"""The port's fused post-LN block in training (three hash-dropout sites)
against the JAX package's.

On the CPU autograd runs through the port's plain version; the JAX side runs
``_kernel_bf16_block`` with its dropout in interpret mode forward and its
custom_vjp recompute through ``_ref_block_bf16`` backward. C=128, M=512,
N=300 rows, act and post rates 0.1, seeds with a negative one. fp32
tolerance 1e-5 max-abs on the outputs, and on each gradient 1e-5 times
its largest magnitude when that exceeds 1 (the JAX kernel's A&S erf
differs from erf by <= 1.5e-7; sums in another order; the gradients of the
weights, biases and LN vectors are sums over the N rows and reach ~50).

On the card (``gpu`` marker) the kernel with dropout is held against its
plain version, and its autograd Function's backward against autograd of the
plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.ops.fused_mlp import fused_block_mlp as jax_fused_block_mlp

from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_block_plain

TOL = 1e-5
SEEDS = (11, -22, 2**31 - 5)
NAMES = ("x", "ln1_scale", "ln1_bias", "w1", "w2", "b1", "b2", "ln2_scale", "ln2_bias")


def _inputs(n, c, m, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    w = (2.0 / (c + m)) ** 0.5
    args = (rnd(n, c), rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1), rnd(c, m, scale=w),
            rnd(m, c, scale=w), rnd(m, scale=0.1), rnd(c, scale=0.1),
            rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1))
    cot = (rnd(n, c), rnd(n, c))
    return args, cot


@pytest.mark.parametrize("act_rate,post_rate", [(0.1, 0.1), (0.0, 0.3)])
def test_training_block_matches_jax_kernel(act_rate, post_rate):
    args, cot = _inputs(300, 128, 512, seed=21)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    xo, t = fused_block_mlp(*leaves, 1e-5, SEEDS, act_rate, post_rate)
    grads = torch.autograd.grad((xo, t), leaves, tuple(map(torch.from_numpy, cot)))

    def jax_block(*a):
        return jax_fused_block_mlp(*a, 1e-5, seeds=jnp.asarray(SEEDS, jnp.int32),
                                   act_rate=act_rate, post_rate=post_rate)

    (xo_j, t_j), vjp = jax.vjp(jax_block, *map(jnp.asarray, args))
    grads_j = vjp(tuple(map(jnp.asarray, cot)))
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(t_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(xo.detach().numpy(), np.asarray(xo_j), rtol=0, atol=TOL)
    for name, g, g_j in zip(NAMES, grads, grads_j):
        scale = max(1.0, float(np.abs(np.asarray(g_j)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0, atol=TOL * scale,
                                   err_msg=name)


def test_dropout_sites_and_tap():
    """The tap t is taken before the post-mlp dropout; the residual branch
    sees it dropped."""
    args, _ = _inputs(64, 128, 256, seed=22)
    a = [torch.from_numpy(v) for v in args]
    xo0, t0 = fused_block_plain(*a, 1e-5, SEEDS, 0.0, 0.5)
    xo1, t1 = fused_block_plain(*a, 1e-5, None, 0.0, 0.0)
    assert torch.equal(t0, t1) and not torch.equal(xo0, xo1)
    with pytest.raises(ValueError, match="three int32 seeds"):
        fused_block_plain(*a, 1e-5, None, 0.1, 0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 1024, 4096), (333, 768, 3072)])
def test_kernel_with_dropout_matches_plain_on_card(cuda, shape):
    """Tolerances: forward 3e-2 + 2e-2 |plain| (bf16 storage, as serving);
    backward a 1e-2 relative norm per gradient (the recompute runs its
    products as bf16 GEMMs, the plain version in fp32). The tap's zeros, the
    elements the fc2 dropout drops, are where the plain version's are: the
    kernel's hash masks are the plain version's bit for bit. Row counts
    leave the last 128-row GEMM tile part empty."""
    args, cot = _inputs(*shape, seed=23)
    dt = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16, torch.bfloat16,
          torch.float32, torch.float32, torch.float32, torch.float32)
    a = [torch.from_numpy(v).to(cuda, d) for v, d in zip(args, dt)]
    before = fused_block_mlp.launches
    xo, t = fused_block_mlp(*a, 1e-5, SEEDS, 0.1, 0.1)
    assert fused_block_mlp.launches == before + 1
    xo_p, t_p = fused_block_plain(*a, 1e-5, SEEDS, 0.1, 0.1)
    assert torch.equal(t == 0, t_p == 0)
    for got, want in ((t, t_p), (xo, xo_p)):
        assert ((got.float() - want.float()).abs() <= 3e-2 + 2e-2 * want.float().abs()).all()
    g = tuple(torch.from_numpy(c).to(cuda, torch.bfloat16) for c in cot)
    l1 = [v.clone().requires_grad_() for v in a]
    g1 = torch.autograd.grad(fused_block_mlp(*l1, 1e-5, SEEDS, 0.1, 0.1), l1, g)
    l2 = [v.clone().requires_grad_() for v in a]
    g2 = torch.autograd.grad(fused_block_plain(*l2, 1e-5, SEEDS, 0.1, 0.1), l2, g)
    for name, x, y in zip(NAMES, g1, g2):
        assert ((x.float() - y.float()).norm() / y.float().norm()) < 1e-2, name
