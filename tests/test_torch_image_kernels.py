"""The image modality's hand-written kernels against their plain versions on
the card (``gpu`` marker; they skip without CUDA): the dense-bias flash
attention (#11), its backward kernels (#11b: dq with the bias gradient,
and dk/dv, and the single launch for T <= 64) and their autograd Function,
and the plain fused MLP in bf16 (#8, also its training Function) and int8
(#9, also at three hidden chunks and its refusal of a hidden width off 128). This
file imports no JAX module, so that it runs on a card's machine without
flax: ``python3 -m pytest tests/test_torch_image_kernels.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d
from animal2vec_tpu_torch.ops.bias_attention import (
    bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv, bias_attention_dq,
    bias_attention_forward, bias_attention_plain, bias_flash_attention,
)
from animal2vec_tpu_torch.ops.fused_mlp import (
    fused_mlp, fused_mlp_int8, fused_mlp_int8_plain, fused_mlp_plain, hidden_chunk,
)
from animal2vec_tpu_torch.ops.int8_mm import quantize_weight


def _mlp_inputs(n, c, m, seed):
    rng = np.random.default_rng(seed)
    w = (2.0 / (c + m)) ** 0.5

    def rnd(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return rnd(n, c), rnd(m, c, scale=w), rnd(c, m, scale=w), rnd(m, scale=0.1), rnd(c, scale=0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bias", ["uniform", "per-row", None])
@pytest.mark.parametrize("t", [25, 144, 196, 1024])
def test_bias_attention_kernel_matches_plain_on_card(cuda, bias, t):
    """The kernel on the q, k, v views of one (B, T, 3, H, D) projection at T
    196 (not a multiple of 64) and 1024, and at the narrow last key tiles of
    T 25 (one tile, bias rows not 16-byte aligned) and T 144 (16 keys), a
    key mask with one fully masked row; tolerance 1e-2 + 1e-2 |plain|
    against the plain version in fp32."""
    b, h = 4, 12
    gen = torch.Generator(device=cuda).manual_seed(46)
    qkv = torch.randn((b, t, 3, h, 64), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    dense = None
    if bias == "uniform":
        dense = torch.from_numpy(alibi_bias_2d(t, h)[None]).to(cuda)
    elif bias == "per-row":
        dense = torch.randn((b, h, t, t), generator=gen, device=cuda)
    if dense is not None and t == 1024:
        dense = dense * 0.1  # the 2-D grid of 1024 patches reaches distances of 62
    mask = torch.zeros((b, t), dtype=torch.bool, device=cuda)
    mask[1, -50:] = True
    mask[3] = True
    before = bias_flash_attention.launches
    got = bias_flash_attention(q, k, v, dense, mask)
    torch.cuda.synchronize()
    assert bias_flash_attention.launches == before + 1
    want = bias_attention_plain(q.float(), k.float(), v.float(), dense, mask)
    assert torch.isfinite(got).all()
    assert ((got.float() - want).abs() <= 1e-2 + 1e-2 * want.abs()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bias", ["per-row", None])
def test_bias_attention_kernel_with_lse_at_student_length_on_card(cuda, bias):
    """The ViT-B/16 pretraining student's 59 kept patches (one key tile, not
    a multiple of 4: the bias rows are not 16-byte aligned) with the lse the
    backward reads, and a key mask with one fully masked row: out 1e-2 +
    1e-2 |plain| against the plain version in fp32, lse 1e-3 + 1e-5 |plain|."""
    b, h, t = 16, 12, 59
    gen = torch.Generator(device=cuda).manual_seed(51)
    qkv = torch.randn((b, t, 3, h, 64), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    dense = None if bias is None else torch.randn((b, h, t, t), generator=gen, device=cuda)
    mask = torch.zeros((b, t), dtype=torch.bool, device=cuda)
    mask[1, -20:] = True
    mask[3] = True
    before = bias_flash_attention.launches
    out, lse = bias_attention_forward(q, k, v, dense, mask, with_lse=True)
    torch.cuda.synchronize()
    assert bias_flash_attention.launches == before + 1
    out_p, lse_p = bias_attention_plain(q.float(), k.float(), v.float(), dense, mask,
                                        return_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert ((out.float() - out_p).abs() <= 1e-2 + 1e-2 * out_p.abs()).all()
    assert ((lse - lse_p).abs() <= 1e-3 + 1e-5 * lse_p.abs()).all()


@pytest.mark.gpu
def test_fused_mlp_kernels_match_plain_on_card(cuda):
    """#8 and #9 at C 768, M 3072 (three hidden chunks): tolerance 3e-2 +
    2e-2 |plain| in bf16 storage, as the fused block; one launch a call."""
    x, w1, w2, b1, b2 = _mlp_inputs(1000, 768, 3072, seed=47)
    xc = torch.from_numpy(x).to(cuda, torch.bfloat16)
    w1c, w2c = (torch.from_numpy(w).to(cuda, torch.bfloat16) for w in (w1, w2))
    b1c, b2c = torch.from_numpy(b1).to(cuda), torch.from_numpy(b2).to(cuda)
    w1_q, w1_s = quantize_weight(w1c)
    w2_q, w2_s = quantize_weight(w2c)
    before = fused_mlp.launches
    for got, want in ((fused_mlp(xc, w1c, w2c, b1c, b2c), fused_mlp_plain(xc, w1c, w2c, b1c, b2c)),
                      (fused_mlp_int8(xc, w1_q, w1_s, b1c, w2_q, w2_s, b2c),
                       fused_mlp_int8_plain(xc, w1_q, w1_s, b1c, w2_q, w2_s, b2c))):
        torch.cuda.synchronize()
        assert fused_mlp.launches == before + 1
        assert ((got.float() - want.float()).abs() <= 3e-2 + 2e-2 * want.float().abs()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [3072, 1536, 384])
def test_int8_mlp_kernel_at_three_chunks_on_card(cuda, m):
    """#9 on the int8 wgmma core at hidden chunks of 1024 (M 3072), 512 (M
    1536) and 384 (M 384, one chunk), C 768: tolerance 3e-2 + 2e-2 |plain|
    in bf16 storage, one launch a call."""
    x, w1, w2, b1, b2 = _mlp_inputs(1000, 768, m, seed=53)
    xc = torch.from_numpy(x).to(cuda, torch.bfloat16)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1).to(cuda, torch.bfloat16))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2).to(cuda, torch.bfloat16))
    b1c, b2c = torch.from_numpy(b1).to(cuda), torch.from_numpy(b2).to(cuda)
    args = (xc, w1_q, w1_s, b1c, w2_q, w2_s, b2c)
    assert hidden_chunk(m) == {3072: 1024, 1536: 512, 384: 384}[m]
    before = fused_mlp_int8.launches
    got = fused_mlp_int8(*args)
    torch.cuda.synchronize()
    assert fused_mlp_int8.launches == before + 1
    want = fused_mlp_int8_plain(*args)
    assert torch.isfinite(got).all()
    assert ((got.float() - want.float()).abs() <= 3e-2 + 2e-2 * want.float().abs()).all()


@pytest.mark.gpu
def test_int8_mlp_kernel_refuses_hidden_width_off_128_on_card(cuda):
    """The int8 wgmma core's fc1 epilogue writes whole 128-column tiles: the
    wrapper raises on M % 128 != 0 (M 320) and launches nothing."""
    x, w1, w2, b1, b2 = _mlp_inputs(64, 768, 320, seed=54)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1).to(cuda, torch.bfloat16))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2).to(cuda, torch.bfloat16))
    before = fused_mlp_int8.launches
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_mlp_int8(torch.from_numpy(x).to(cuda, torch.bfloat16), w1_q, w1_s,
                       torch.from_numpy(b1).to(cuda), w2_q, w2_s, torch.from_numpy(b2).to(cuda))
    assert fused_mlp_int8.launches == before


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,bias", [(32, 59, "per-row"), (8, 196, "uniform"), (8, 196, None),
                                      (4, 1024, "uniform"), (8, 100, "per-row")])
def test_bias_attention_backward_kernels_match_plain_on_card(cuda, b, t, bias):
    """#11 with lse, dq + dbias and dk/dv against their plain versions on
    the same bf16 inputs, lse and delta (a key mask with a fully masked row
    at T 100 and 1024): 5e-3 + 1e-2 |plain| (lse 1e-3), and the fp32 dbias
    1e-5 + 1e-2 |plain| (far below a typical |dS| of about 8 / T); then the
    autograd Function (the single launch at T 59) against autograd of the
    plain version in fp32, 1e-2 relative norm."""
    h = 12
    gen = torch.Generator(device=cuda).manual_seed(48)
    qkv = torch.randn((b, t, 3, h, 64), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    dense = None
    if bias == "uniform":
        dense = torch.from_numpy(alibi_bias_2d(t, h)[None]).to(cuda) * (0.1 if t == 1024 else 1)
    elif bias == "per-row":
        dense = torch.randn((b, h, t, t), generator=gen, device=cuda)
    mask = None
    if t in (100, 1024):
        mask = torch.zeros((b, t), dtype=torch.bool, device=cuda)
        mask[1, -50:] = True
        mask[3] = True
    out, lse = bias_attention_forward(q, k, v, dense, mask, with_lse=True)
    out_p, lse_p = bias_attention_plain(q.float(), k.float(), v.float(), dense, mask,
                                        return_lse=True)
    assert ((out.float() - out_p).abs() <= 1e-2 + 1e-2 * out_p.abs()).all()
    assert ((lse - lse_p).abs() <= 1e-3 + 1e-5 * lse_p.abs()).all()
    dout = torch.randn((b, t, h, 64), generator=gen, device=cuda).to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
    args = (q, k, v, dout, lse, delta, dense, mask)
    before = (bias_attention_dq.launches, bias_attention_dkv.launches)
    dq, dbias = bias_attention_dq(*args)
    dk, dv = bias_attention_dkv(*args)
    torch.cuda.synchronize()
    assert (bias_attention_dq.launches, bias_attention_dkv.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want = bias_attention_bwd_plain(*args)
    gots = (dq, dk, dv) + (() if dense is None else (dbias,))
    for got, ref, atol in zip(gots, want, (5e-3, 5e-3, 5e-3, 1e-5)):
        assert torch.isfinite(got).all()
        assert ((got.float() - ref.float()).abs() <= atol + 1e-2 * ref.float().abs()).all()
    leaves = [qkv.clone().requires_grad_()] + ([] if dense is None else
                                               [dense.clone().requires_grad_()])
    leaves_p = [qkv.float().requires_grad_()] + ([] if dense is None else
                                                 [dense.clone().requires_grad_()])
    got = torch.autograd.grad(bias_flash_attention(*leaves[0].unbind(2), *leaves[1:], mask),
                              leaves, dout)
    ref = torch.autograd.grad(bias_attention_plain(*leaves_p[0].unbind(2), *leaves_p[1:], mask),
                              leaves_p, dout.float())
    assert all(_rel(g, r) <= 1e-2 for g, r in zip(got, ref))
    if dense is not None:
        assert got[1].shape == dense.shape


@pytest.mark.gpu
@pytest.mark.parametrize("t,bias,masked", [(59, "per-row", False), (59, "per-row", True),
                                           (59, None, True), (49, "uniform", False),
                                           (25, "per-row", True)])
def test_bias_attention_single_backward_matches_plain_on_card(cuda, t, bias, masked):
    """#11b's single launch (T <= 64) against the plain version and against
    the two-launch route on the same inputs: dq, dk, dv 5e-3 + 1e-2 |plain|,
    dbias 1e-5 + 1e-2 |plain|, with a key mask whose row 3 masks every key;
    the autograd Function takes it (one launch, none of dq or dk/dv)."""
    b, h = 16, 12
    gen = torch.Generator(device=cuda).manual_seed(55)
    qkv = torch.randn((b, t, 3, h, 64), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    dense = None
    if bias == "uniform":
        dense = torch.from_numpy(alibi_bias_2d(t, h)[None]).to(cuda)
    elif bias == "per-row":
        dense = torch.randn((b, h, t, t), generator=gen, device=cuda)
    mask = None
    if masked:
        mask = torch.zeros((b, t), dtype=torch.bool, device=cuda)
        mask[1, -9:] = True
        mask[3] = True
    out, lse = bias_attention_forward(q, k, v, dense, mask, with_lse=True)
    dout = torch.randn((b, t, h, 64), generator=gen, device=cuda).to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
    args = (q, k, v, dout, lse, delta, dense, mask)
    before = bias_attention_bwd_single.launches
    got = bias_attention_bwd_single(*args)
    torch.cuda.synchronize()
    assert bias_attention_bwd_single.launches == before + 1
    two = bias_attention_dq(*args) + bias_attention_dkv(*args)
    want = bias_attention_bwd_plain(*args)
    for i, atol in enumerate((5e-3, 5e-3, 5e-3) + (() if dense is None else (1e-5,))):
        ref = want[i].float()
        for g in (got[i], two[(0, 2, 3, 1)[i]]):
            assert torch.isfinite(g).all()
            assert ((g.float() - ref).abs() <= atol + 1e-2 * ref.abs()).all()
    if dense is None:
        assert got[3] is None
    counts = (bias_attention_bwd_single.launches, bias_attention_dq.launches,
              bias_attention_dkv.launches)
    leaves = [qkv.clone().requires_grad_()]
    torch.autograd.grad(bias_flash_attention(*leaves[0].unbind(2), dense, mask), leaves, dout)
    assert (bias_attention_bwd_single.launches, bias_attention_dq.launches,
            bias_attention_dkv.launches) == (counts[0] + 1,) + counts[1:]


@pytest.mark.gpu
def test_fused_mlp_training_function_matches_plain_on_card(cuda):
    """#8's autograd Function (kernel forward, recompute backward in bf16
    GEMMs with fp32 sums) against autograd of the plain version in fp32 on
    the same bf16 inputs: 1e-2 relative norm per gradient."""
    x, w1, w2, b1, b2 = _mlp_inputs(1000, 768, 3072, seed=49)
    vals = [torch.from_numpy(a).to(cuda) for a in (x, w1, w2, b1, b2)]
    vals[:3] = [a.to(torch.bfloat16) for a in vals[:3]]
    g = torch.randn((1000, 768), generator=torch.Generator(device=cuda).manual_seed(50),
                    device=cuda).to(torch.bfloat16)
    leaves = [a.clone().requires_grad_() for a in vals]
    before = fused_mlp.launches
    got = torch.autograd.grad(fused_mlp(*leaves), leaves, g)
    assert fused_mlp.launches == before + 1
    leaves_p = [a.float().requires_grad_() for a in vals]
    ref = torch.autograd.grad(fused_mlp_plain(*leaves_p), leaves_p, g.float())
    assert all(_rel(a, r) <= 1e-2 for a, r in zip(got, ref))
