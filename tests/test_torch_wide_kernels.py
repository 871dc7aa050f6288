"""The fused post-LN blocks past C 1024: #6 (``fused_block_mlp``), its
tensor-parallel split #6s (``block_fc1``, ``block_fc2_partial``,
``block_ln2``) and #7 (``fused_block_int8``), whose row LayerNorm takes its
wide instance there (``csrc/layernorm.cuh``: the row re-read from global
memory for each pass, where C <= 1024 holds it in registers).

On the CPU the split's plain versions give the fused block's plain version
at C 1280 and 2048 (one rank), dropout included. On the card (``gpu``
marker, skipped here) each kernel at the Whisper large-v3 encoder's widths
(C 1280, M 5120) and at C 2048, M 8192 against its plain version, at the
tolerances of the kernel tests at C 1024 (3e-2 + 2e-2 |plain|, bf16
storage). This file imports no flax, so that it collects on the card's
machine.
"""

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.ops.fused_mlp import (
    block_fc1, block_fc2_partial, block_ln2, fused_block_int8, fused_block_int8_plain,
    fused_block_mlp, fused_block_plain,
)
from animal2vec_tpu_torch.ops.int8_mm import quantize_weight

SEEDS = (7, -9, 2**31 - 3)
WIDE = [(1280, 5120), (2048, 8192)]


def _block_args(n, c, m, seed, dev="cpu", dtype=torch.float32):
    """x, ln1 (scale, bias), w1 (C, M), w2 (M, C), b1, b2, ln2 (scale,
    bias): x and the weights in ``dtype``, the vectors fp32."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=shape) * scale + shift).astype(np.float32))

    w = (2.0 / (c + m)) ** 0.5
    args = [rnd(n, c), rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1), rnd(c, m, scale=w),
            rnd(m, c, scale=w), rnd(m, scale=0.1), rnd(c, scale=0.1),
            rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)]
    args = [a.to(dev) for a in args]
    for i in (0, 3, 4):
        args[i] = args[i].to(dtype)
    return args


def _split(args, seeds, act_rate, post_rate):
    x, l1s, l1b, w1, w2, b1, b2, l2s, l2b = args
    r, h = block_fc1(x, l1s, l1b, w1, b1, 1e-5, seeds[0], act_rate)
    return block_ln2(block_fc2_partial(h, w2), b2, r, l2s, l2b, 1e-5, seeds[1:], act_rate,
                     post_rate)


@pytest.mark.parametrize("c,m", WIDE)
def test_split_plain_is_the_block_past_1024(c, m):
    """One rank of the split (the fc1 half, the fp32 partial, the LN2 half)
    computes the fused block at C 1280 and 2048 with its three dropout
    sites: the same values within 1e-6 (fp32), and the same dropped
    elements."""
    args = _block_args(64, c, m, seed=c)
    xo, t = fused_block_plain(*args, 1e-5, SEEDS, 0.1, 0.2)
    xo_s, t_s = _split(args, SEEDS, 0.1, 0.2)
    assert torch.equal(t == 0, t_s == 0) and (t == 0).any()
    torch.testing.assert_close(t_s, t, rtol=0, atol=1e-6)
    torch.testing.assert_close(xo_s, xo, rtol=0, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= 3e-2 + 2e-2 * want.float().abs()).all(), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("c,m", WIDE)
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)], ids=["serving", "dropout"])
def test_wide_block_kernel_matches_plain_on_card(cuda, c, m, rates):
    """#6 at N 1000 (the last 128-row tile part empty), serving and with
    its three dropout sites: the tap's dropped elements where the plain
    version's are."""
    args = _block_args(1000, c, m, seed=c + 1, dev=cuda, dtype=torch.bfloat16)
    seeds = SEEDS if rates[0] else None
    before = fused_block_mlp.launches
    with torch.no_grad():
        xo, t = fused_block_mlp(*args, 1e-5, seeds, *rates)
    torch.cuda.synchronize()
    assert fused_block_mlp.launches == before + 1
    xo_p, t_p = fused_block_plain(*args, 1e-5, seeds, *rates)
    assert torch.equal(t == 0, t_p == 0)
    _close(t, t_p)
    _close(xo, xo_p)


@pytest.mark.gpu
@pytest.mark.parametrize("c,m", WIDE)
def test_wide_split_kernels_match_plain_on_card(cuda, c, m):
    """#6s (three launches, one rank) with dropout against the fused
    block's plain version."""
    args = _block_args(1000, c, m, seed=c + 2, dev=cuda, dtype=torch.bfloat16)
    counters = (block_fc1, block_fc2_partial, block_ln2)
    before = [f.launches for f in counters]
    with torch.no_grad():
        xo, t = _split(args, SEEDS, 0.1, 0.1)
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [b + 1 for b in before]
    xo_p, t_p = fused_block_plain(*args, 1e-5, SEEDS, 0.1, 0.1)
    _close(t, t_p)
    _close(xo, xo_p)


@pytest.mark.gpu
@pytest.mark.parametrize("c,m", WIDE)
def test_wide_int8_block_kernel_matches_plain_on_card(cuda, c, m):
    """#7 at N 1000: r quantized per row over the whole C by the wide
    LayerNorm, h in chunks of 1024."""
    x, l1s, l1b, w1, w2, b1, b2, l2s, l2b = _block_args(1000, c, m, seed=c + 3, dev=cuda)
    w1_q, w1_s = quantize_weight(w1.t())
    w2_q, w2_s = quantize_weight(w2.t())
    args = (x.to(torch.bfloat16), l1s, l1b, w1_q, w1_s, b1, w2_q, w2_s, b2, l2s, l2b, 1e-5)
    before = fused_block_int8.launches
    xo, t = fused_block_int8(*args)
    torch.cuda.synchronize()
    assert fused_block_int8.launches == before + 1
    xo_p, t_p = fused_block_int8_plain(*args)
    _close(t, t_p)
    _close(xo, xo_p)
