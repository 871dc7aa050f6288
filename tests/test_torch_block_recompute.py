"""The fused block's backward recompute (``ops.fused_mlp.fused_block_recompute``,
the backward of the kernel's autograd Function) on bf16 inputs against the
JAX ``_fused_block_bf16_bwd`` on the same inputs.

JAX recomputes through ``_ref_block_bf16``: each product is the fp32 sum of
the bf16 operands, kept in fp32 through its bias, GELU and the dropouts, and
its transpose multiplies the fp32 cotangent by the bf16 operand in fp32 and
rounds once. The port's recompute does the same with bf16 GEMMs (the
cotangent as two bf16 halves). What is left is fp32 summation order, which
now and then moves a bf16 rounding by one step: on these inputs at most 8 %
of a gradient's elements lie more than one bf16 step (2^-8 relative) from
JAX's, and the largest error is below 3e-3 of the gradient's range. A
recompute that rounds the products to bf16 before their biases (as the
CUDA arm once did) puts 16-62 % of the elements of every gradient that
depends on them beyond one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.ops.fused_mlp import fused_block_mlp as jax_fused_block_mlp

from animal2vec_tpu_torch.ops.fused_mlp import fused_block_recompute

SEEDS = (11, -22, 2**31 - 5)
NAMES = ("x", "ln1_scale", "ln1_bias", "w1", "w2", "b1", "b2", "ln2_scale", "ln2_bias")
BF16 = (0, 3, 4)  # x, w1, w2 are stored in bf16, the vectors in fp32
SHARE_OFF = 0.1  # share of a gradient's elements allowed beyond one bf16 step
WORST = 2**-7  # largest error, as a share of the gradient's largest magnitude


def _inputs(n, c, m, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    w = (2.0 / (c + m)) ** 0.5
    args = (rnd(n, c), rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1), rnd(c, m, scale=w),
            rnd(m, c, scale=w), rnd(m, scale=0.1), rnd(c, scale=0.1),
            rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1))
    return args, (rnd(n, c), rnd(n, c))


@pytest.mark.parametrize("act_rate,post_rate", [(0.1, 0.1), (0.0, 0.0)])
def test_recompute_matches_jax_backward_in_bf16(act_rate, post_rate):
    args, cot = _inputs(300, 128, 512, seed=31)
    ours = fused_block_recompute(
        [torch.from_numpy(a).to(torch.bfloat16 if i in BF16 else torch.float32)
         for i, a in enumerate(args)],
        (1e-5, SEEDS, act_rate, post_rate),
        tuple(torch.from_numpy(c).to(torch.bfloat16) for c in cot),
    )

    def jax_block(*a):
        return jax_fused_block_mlp(*a, 1e-5, seeds=jnp.asarray(SEEDS, jnp.int32),
                                   act_rate=act_rate, post_rate=post_rate)

    _, vjp = jax.vjp(jax_block, *[jnp.asarray(a).astype(jnp.bfloat16 if i in BF16 else
                                                          jnp.float32)
                                  for i, a in enumerate(args)])
    refs = vjp(tuple(jnp.asarray(c).astype(jnp.bfloat16) for c in cot))
    for name, g, ref in zip(NAMES, ours, refs):
        ref = np.asarray(ref.astype(jnp.float32))
        assert g.dtype == (torch.bfloat16 if name in ("x", "w1", "w2") else torch.float32)
        err = np.abs(g.float().numpy() - ref)
        scale = np.abs(ref).max()
        share = (err > 2**-8 * np.maximum(np.abs(ref), 1e-3 * scale)).mean()
        assert share <= SHARE_OFF and err.max() <= WORST * scale, (name, share, err.max() / scale)


def test_recompute_skips_unwanted_and_absent_inputs():
    args, cot = _inputs(40, 128, 256, seed=32)
    inputs = [torch.from_numpy(a) for a in args]
    inputs[1] = inputs[2] = None  # no LN1 affine
    needs = (True, False, False, False, True, True, False, False, False)
    grads = fused_block_recompute(inputs, (1e-5, None, 0.0, 0.0),
                                  tuple(map(torch.from_numpy, cot)), needs)
    assert [g is not None for g in grads] == [True] + [False] * 3 + [True, True] + [False] * 3
    assert grads[4].shape == (256, 128) and grads[5].shape == (256,)
