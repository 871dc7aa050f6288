"""The attention kernels' head dims (1 to 128) against their plain versions.

The kernels (#1-#5, #5q, #11, #11b) take a head of D columns as one 64-
column tile (D 64) or two (any other D up to 128), columns past D zero; their C
entries take D a multiple of 8, and the wrappers run any other D on copies
zero-padded to the next multiple of 8 (``ops/attention.kernel_head_dim``)
with the scale D^-0.5 of the true D, keeping the first D columns of each
output.

On the CPU (no flax, no card): the wrappers' kernel route, padded copies
and all, on a fake card (``FakeCard``), whose C entries read their
arguments from the pointers, strides and sizes the wrappers pass and compute
the plain versions at the head dim and scale passed, against the plain
versions at the true D: the padded path of the ALiBi forward and backward
(#2, #3, #4), the int8 quantization pass and attention (#5q, #5, bit for
bit) and the dense-bias forward and backward (#11, #11b, both routes), in
fp32 within two bf16 ulps of each output's largest value (the C entries
write bf16); and D > 128 raising, naming ROADMAP A.11.

On the card (``gpu`` marker), at D 32, 80, 96, 120, 128 and 36, each kernel
against its plain version on the same bf16 inputs, at the tolerances the
D 64 instances meet (``tests/test_torch_attention_train.py``,
``tests/test_torch_int8_ops.py``, ``tests/test_torch_image_kernels.py``).
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.ops import attention, bias_attention
from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d, alibi_slopes
from animal2vec_tpu_torch.ops.attention import (
    INV_127, alibi_attention_btc_plain, alibi_attention_int8_plain, alibi_attention_plain,
    alibi_flash_attention_btc, alibi_flash_attention_int8, alibi_flash_attention_packed,
    alibi_flash_attention_serve, attention_bwd_plain, attention_dkv, attention_dq,
    attention_int8_quantized_plain, btc_to_packed, int8_row_len, int8_spans, kernel_head_dim,
    quantize_qkv_int8_pass, quantize_qkv_int8_pass_plain, v8t_key_order,
)
from animal2vec_tpu_torch.ops.bias_attention import (
    bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv, bias_attention_dq,
    bias_attention_forward, bias_attention_plain, bias_flash_attention,
)
from animal2vec_tpu_torch.ops.int8_mm import quantize_rows

HEAD_DIMS = (32, 80, 96, 120, 128, 36)
SEED = -123457
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# the fake card: the C entries emulated on host memory
# ---------------------------------------------------------------------------


def _view(ptr, dtype, shape, strides):
    """The C entry's view of a pointer argument: ``shape`` with element
    ``strides`` over host memory."""
    if ptr is None:
        return None
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    size = torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * (n * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=n).as_strided(shape, strides)


def _dense(ptr, dtype, *shape):
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return _view(ptr, dtype, shape, strides)


def _side(slopes, pos, pos_per_row, mask, mask_per_row, b, h, t):
    mask_v = _dense(mask, torch.uint8, b if mask_per_row else 1, t)
    pos_v = _dense(pos, torch.int32, b if pos_per_row else 1, t)
    return (_dense(slopes, torch.float32, h), pos_v,
            None if mask_v is None else mask_v.bool().expand(b, t))


class FakeCard:
    """The attention kernels' C entries over host memory: each checks its
    head dim as the C entry does (a multiple of 8 up to 128), reads its
    inputs where the wrapper points, runs the plain version with the scale
    passed (q scaled by scale * sqrt(D) before the plain version's D^-0.5)
    and writes its outputs; no dropout. The ``_f32`` entries of #1-#4, #11
    and #11b read and write fp32 where the others read and write bf16
    (``dt``).
    ``head_dims`` records the D of every call."""

    def __init__(self):
        self.head_dims = []

    def _d(self, d):
        assert d % 8 == 0 and 0 < d <= 128, d
        self.head_dims.append(d)

    def a2v_alibi_attention_fwd(self, q, k, v, sb, st, sh, slopes, pos, pos_per_row, pos_k,
                                posk_per_row, mask, mask_per_row, out, ob, ot, oh, lse, b, h, t,
                                d, sentinel, scale, seed, thresh, keep, h0, hash_heads, stream,
                                dt=BF16):
        self._d(d)
        assert thresh == 0 and pos_k is None
        qv, kv, vv = (_view(p, dt, (b, t, h, d), (sb, st, sh, 1)).float() for p in (q, k, v))
        sl, p, m = _side(slopes, pos, pos_per_row, mask, mask_per_row, b, h, t)
        packed = torch.stack([qv * (scale * d**0.5), kv, vv]).transpose(2, 3)
        o, ls = alibi_attention_plain(packed, sl, p, m, bool(sentinel), return_lse=True)
        _view(out, dt, (b, t, h, d), (ob, ot, oh, 1)).copy_(o.transpose(1, 2))
        if lse is not None:
            _dense(lse, torch.float32, b * h, t).copy_(ls)
        return 0

    def _alibi_bwd(self, qkv, dout, lse, delta, slopes, pos, pos_per_row, mask, mask_per_row,
                   b, h, t, d, sentinel, scale, dt):
        self._d(d)
        packed = _dense(qkv, dt, 3, b, h, t, d).float()
        c = scale * d**0.5
        packed = torch.stack([packed[0] * c, packed[1], packed[2]])
        sl, p, m = _side(slopes, pos, pos_per_row, mask, mask_per_row, b, h, t)
        dqkv, parts = attention_bwd_plain(
            packed, _dense(dout, dt, b, h, t, d).float(), _dense(lse, torch.float32, b * h, t),
            _dense(delta, torch.float32, b * h, t), sl, p, m, bool(sentinel))
        return dqkv[0] * c, dqkv[1], dqkv[2], parts

    def a2v_alibi_attention_bwd_dq(self, qkv, dout, lse, delta, slopes, pos, pos_per_row, mask,
                                   mask_per_row, dq, parts, b, h, t, d, sentinel, scale, seed,
                                   thresh, keep, h0, hash_heads, stream, dt=BF16):
        assert thresh == 0
        g = self._alibi_bwd(qkv, dout, lse, delta, slopes, pos, pos_per_row, mask, mask_per_row,
                            b, h, t, d, sentinel, scale, dt)
        _dense(dq, dt, b, h, t, d).copy_(g[0])
        _dense(parts, torch.float32, b, h, -(-t // 64)).copy_(g[3])
        return 0

    def a2v_alibi_attention_bwd_dkv(self, qkv, dout, lse, delta, slopes, pos, pos_per_row, mask,
                                    mask_per_row, dk, dv, b, h, t, d, sentinel, scale, seed,
                                    thresh, keep, h0, hash_heads, stream, dt=BF16):
        assert thresh == 0
        g = self._alibi_bwd(qkv, dout, lse, delta, slopes, pos, pos_per_row, mask, mask_per_row,
                            b, h, t, d, sentinel, scale, dt)
        _dense(dk, dt, b, h, t, d).copy_(g[1])
        _dense(dv, dt, b, h, t, d).copy_(g[2])
        return 0

    def a2v_alibi_attention_fwd_f32(self, *args):
        return self.a2v_alibi_attention_fwd(*args, dt=torch.float32)

    def a2v_alibi_attention_bwd_dq_f32(self, *args):
        return self.a2v_alibi_attention_bwd_dq(*args, dt=torch.float32)

    def a2v_alibi_attention_bwd_dkv_f32(self, *args):
        return self.a2v_alibi_attention_bwd_dkv(*args, dt=torch.float32)

    def a2v_quantize_qkv_int8(self, q, k, v, sb, st, sh, q8, qs, k8, ks, v8t, vsc, b, h, t, d,
                              t_pad, q_scale, stream):
        self._d(d)
        qv, kv, vv = (_view(p, BF16, (b, t, h, d), (sb, st, sh, 1)).float() for p in (q, k, v))
        q8_, qs_ = quantize_rows(qv * torch.tensor(q_scale, dtype=torch.float32))
        k8_, ks_ = quantize_rows(kv)
        vs = torch.clamp_min(vv.abs().amax(dim=1) * INV_127, 1e-12)
        v8 = torch.round(vv / vs[:, None]).to(torch.int8)
        rows = int8_row_len(d)
        pad = lambda x: torch.nn.functional.pad(x, (0, rows - d))  # noqa: E731
        _dense(q8, torch.int8, b, h, t, rows).copy_(pad(q8_).transpose(1, 2))
        _dense(k8, torch.int8, b, h, t, rows).copy_(pad(k8_).transpose(1, 2))
        _dense(qs, torch.float32, b, h, t).copy_(qs_.transpose(1, 2))
        _dense(ks, torch.float32, b, h, t).copy_(ks_.transpose(1, 2))
        v8t_ = torch.nn.functional.pad(v8.permute(0, 2, 3, 1), (0, t_pad - t, 0, rows - d))
        _dense(v8t, torch.int8, b, h, rows, t_pad).copy_(v8t_[..., v8t_key_order(t_pad)])
        _dense(vsc, torch.float32, b, h, d).copy_(vs * INV_127)
        return 0

    def a2v_alibi_attention_int8(self, q8, qs, k8, ks, v8t, vsc, slopes, pos, pos_per_row, mask,
                                 mask_per_row, out, o_acc, b, h, t, d, t_pad, span, sentinel,
                                 stream):
        self._d(d)
        rows = int8_row_len(d)
        sl, p, m = _side(slopes, pos, pos_per_row, mask, mask_per_row, b, h, t)
        o = attention_int8_quantized_plain(
            _dense(q8, torch.int8, b, h, t, rows), _dense(qs, torch.float32, b, h, t),
            _dense(k8, torch.int8, b, h, t, rows), _dense(ks, torch.float32, b, h, t),
            _dense(v8t, torch.int8, b, h, rows, t_pad), _dense(vsc, torch.float32, b, h, d),
            sl, p, m, bool(sentinel), span, BF16)
        _dense(out, BF16, b, t, h, d).copy_(o)
        return 0

    def _bias_inputs(self, q, k, v, sb, st, bias, uniform, mask, b, h, t, d, scale, dt):
        self._d(d)
        qv, kv, vv = (_view(p, dt, (b, t, h, d), (sb, st, d, 1)).float() for p in (q, k, v))
        dense = _dense(bias, torch.float32, 1 if uniform else b, h, t, t)
        m = _dense(mask, torch.uint8, b, t)
        return qv * (scale * d**0.5), kv, vv, dense, None if m is None else m.bool()

    def a2v_bias_attention(self, q, k, v, sb, st, bias, uniform, mask, out, lse, b, h, t, d,
                           scale, seed, thresh, keep, stream, dt=BF16):
        assert thresh == 0
        qv, kv, vv, dense, m = self._bias_inputs(q, k, v, sb, st, bias, uniform, mask, b, h, t,
                                                 d, scale, dt)
        o, ls = bias_attention_plain(qv, kv, vv, dense, m, return_lse=True)
        _dense(out, dt, b, t, h, d).copy_(o)
        if lse is not None:
            _dense(lse, torch.float32, b * h, t).copy_(ls)
        return 0

    def _bias_bwd(self, q, k, v, sb, st, dout, lse, delta, bias, uniform, mask, b, h, t, d,
                  scale, dq, dk, dv, osb, ost, dbias, dt):
        qv, kv, vv, dense, m = self._bias_inputs(q, k, v, sb, st, bias, uniform, mask, b, h, t,
                                                 d, scale, dt)
        c = scale * d**0.5
        g = bias_attention_bwd_plain(qv, kv, vv, _dense(dout, dt, b, t, h, d).float(),
                                     _dense(lse, torch.float32, b * h, t),
                                     _dense(delta, torch.float32, b * h, t), dense, m)
        for ptr, x in ((dq, g[0] * c), (dk, g[1]), (dv, g[2])):
            if ptr is not None:
                _view(ptr, dt, (b, t, h, d), (osb, ost, d, 1)).copy_(x)
        if dbias is not None:
            _dense(dbias, torch.float32, b, h, t, t).copy_(g[3])
        return 0

    def a2v_bias_attention_bwd_dq(self, q, k, v, sb, st, dout, lse, delta, bias, uniform, mask,
                                  dq, osb, ost, dbias, b, h, t, d, scale, seed, thresh, keep,
                                  stream, dt=BF16):
        return self._bias_bwd(q, k, v, sb, st, dout, lse, delta, bias, uniform, mask, b, h, t, d,
                              scale, dq, None, None, osb, ost, dbias, dt)

    def a2v_bias_attention_bwd_dkv(self, q, k, v, sb, st, dout, lse, delta, bias, uniform, mask,
                                   dk, dv, osb, ost, b, h, t, d, scale, seed, thresh, keep,
                                   stream, dt=BF16):
        return self._bias_bwd(q, k, v, sb, st, dout, lse, delta, bias, uniform, mask, b, h, t, d,
                              scale, None, dk, dv, osb, ost, None, dt)

    def a2v_bias_attention_bwd_single(self, q, k, v, sb, st, dout, lse, delta, bias, uniform,
                                      mask, dq, dk, dv, osb, ost, dbias, b, h, t, d, scale, seed,
                                      thresh, keep, stream, dt=BF16):
        assert t <= 64
        return self._bias_bwd(q, k, v, sb, st, dout, lse, delta, bias, uniform, mask, b, h, t, d,
                              scale, dq, dk, dv, osb, ost, dbias, dt)

    def a2v_bias_attention_f32(self, *args):
        return self.a2v_bias_attention(*args, dt=torch.float32)

    def a2v_bias_attention_bwd_dq_f32(self, *args):
        return self.a2v_bias_attention_bwd_dq(*args, dt=torch.float32)

    def a2v_bias_attention_bwd_dkv_f32(self, *args):
        return self.a2v_bias_attention_bwd_dkv(*args, dt=torch.float32)

    def a2v_bias_attention_bwd_single_f32(self, *args):
        return self.a2v_bias_attention_bwd_single(*args, dt=torch.float32)


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the kernel route, whose C entries ``FakeCard``
    runs; custom ops still dispatch by device (the tests call their card
    implementations directly)."""
    card = FakeCard()
    for module in (attention, bias_attention):
        monkeypatch.setattr(module, "_on_cpu", lambda x: False)
        monkeypatch.setattr(module, "_check_device", lambda x, what: None)
    monkeypatch.setattr(attention, "library", lambda: card)  # every entry of both modules
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return card


def _close(got, want, ulps=2):
    """Within ``ulps`` bf16 ulps (2^-8 relative) of the reference's largest
    magnitude: the C entries write bf16."""
    want = want.float()
    tol = ulps * 2.0**-8 * max(1.0, want.abs().max().item())
    assert got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= tol


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(BF16)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_kernel_head_dim_rounds_up_to_eight_and_stops_at_128():
    for d in range(1, 129):
        dk = kernel_head_dim(d)
        assert dk % 8 == 0 and d <= dk < d + 8
        assert int8_row_len(d) == int8_row_len(dk) == (64 if dk == 64 else 128)
    for d in (0, 129, 160):
        with pytest.raises(ValueError, match="A.11"):
            kernel_head_dim(d)


@pytest.mark.parametrize("d", [36, 80, 4])
def test_alibi_padded_path_equals_plain(fake_card, d):
    """The training entry (#2 with its lse, then #3 and #4) at D 36 and 4
    (zero-padded to 40 and 8) and 80 (read in place): out, dqkv and the
    slope gradient against autograd of the plain version at the true D."""
    rng = np.random.default_rng(d)
    b, h, t = 2, 2, 70
    x = _bf16(rng, b, t, 3 * h * d).requires_grad_()
    g = _bf16(rng, b, t, h * d)
    slopes = torch.from_numpy((alibi_slopes(h) * 0.8).astype(np.float32)).requires_grad_()
    pos = torch.arange(t, dtype=torch.int32)[None]
    mask = torch.zeros((b, t), dtype=torch.bool)
    mask[1, -11:] = True
    launches = (alibi_flash_attention_packed.launches, attention_dq.launches,
                attention_dkv.launches)
    out = alibi_flash_attention_btc(x, h, slopes, pos, mask)
    gx, gs = torch.autograd.grad(out, (x, slopes), g)
    assert (alibi_flash_attention_packed.launches, attention_dq.launches,
            attention_dkv.launches) == tuple(n + 1 for n in launches)
    assert fake_card.head_dims == [kernel_head_dim(d)] * 3
    xf = x.detach().float().requires_grad_()
    sf = slopes.detach().clone().requires_grad_()
    of = alibi_attention_btc_plain(xf, h, sf, pos, mask)
    gxf, gsf = torch.autograd.grad(of, (xf, sf), g.float())
    _close(out, of)
    _close(gx, gxf, ulps=4)  # dO and delta in bf16 on the kernel route
    torch.testing.assert_close(gs, gsf, rtol=2e-2, atol=2e-2 * gsf.abs().max().item())


@pytest.mark.parametrize("d", [36, 80])
def test_int8_padded_path_equals_plain(fake_card, d):
    """#5q and #5 through their card implementations: the quantization
    pass bit for bit its plain version (q scaled by D^-0.5 of the true D,
    rows of ``int8_row_len(D)`` zero past D), the attention bit for bit the
    plain version on those layouts."""
    rng = np.random.default_rng(10 + d)
    b, t, h = 2, 150, 2
    qkv = _bf16(rng, b, t, 3, h, d, scale=1.5)
    q, k, v = qkv.unbind(2)
    span, t_pad = int8_spans(t)
    got = attention._quantize_op._init_fn(q, k, v, t_pad)
    want = quantize_qkv_int8_pass_plain(q, k, v, t_pad)
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and torch.equal(a, r)
    slopes = torch.from_numpy(alibi_slopes(h).astype(np.float32))
    pos = torch.arange(t, dtype=torch.int32)[None]
    mask = torch.zeros((b, t), dtype=torch.bool)
    mask[0, -20:] = True
    out = attention._attention_int8_op._init_fn(*got, slopes, pos, mask, True, span, BF16)
    assert torch.equal(out, alibi_attention_int8_plain(q, k, v, slopes, pos, mask, True))
    assert fake_card.head_dims == [kernel_head_dim(d)] * 2


@pytest.mark.parametrize("d,t", [(36, 49), (36, 81), (80, 81)])
def test_bias_padded_path_equals_plain(fake_card, d, t):
    """#11 with lse and #11b through the autograd Function (the single
    launch at T 49, dq + dbias and dk/dv at T 81) with a batch-uniform
    bias and a padded key: out and the gradients of q, k, v and the bias
    against autograd of the plain version at the true D."""
    rng = np.random.default_rng(20 + d + t)
    b, h = 2, 2
    q, k, v = (_bf16(rng, b, t, h, d).requires_grad_() for _ in range(3))
    dout = _bf16(rng, b, t, h, d)
    bias = torch.from_numpy(alibi_bias_2d(t, h)[None] * np.float32(0.7)).requires_grad_()
    mask = torch.zeros((b, t), dtype=torch.bool)
    mask[1, -6:] = True
    out = bias_flash_attention(q, k, v, bias, mask)
    got = torch.autograd.grad(out, (q, k, v, bias), dout)
    dk_ = kernel_head_dim(d)
    assert fake_card.head_dims == [dk_] * (2 if t <= 64 else 3)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)] + [bias.detach().clone()
                                                                          .requires_grad_()]
    of = bias_attention_plain(*leaves[:3], leaves[3], mask)
    want = torch.autograd.grad(of, leaves, dout.float())
    _close(out, of)
    for a, r in zip(got, want):
        _close(a, r, ulps=4)  # dO and delta in bf16 on the kernel route


def test_head_offset_attention_at_d80_equals_the_heads_slice():
    """Tensor parallelism's head offset at D 80: each rank's heads (h0 = 2 r
    of H = 4) through #2's and #3 / #4's plain versions with ``h0`` and
    ``hash_heads`` equal the unsharded call's heads, dropout 0.25 (the
    D 64 twin: ``tests/test_torch_parallel.py``)."""
    g = torch.Generator().manual_seed(80)
    b, h, t, d, rate = 2, 4, 48, 80, 0.25
    qkv = torch.randn(3, b, h, t, d, generator=g)
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625])
    pos = torch.arange(t, dtype=torch.int32)[None]
    pad = torch.zeros(b, t, dtype=torch.bool)
    pad[1, 40:] = True
    out, lse = alibi_attention_plain(qkv, slopes, pos, pad, False, rate, SEED, True)
    dout = torch.randn(b, h, t, d, generator=g)
    delta = (dout * out).sum(-1).reshape(b * h, t)
    dqkv, parts = attention_bwd_plain(qkv, dout, lse, delta, slopes, pos, pad, False, rate, SEED)
    for r in range(2):
        hs = slice(2 * r, 2 * r + 2)
        sub = qkv[:, :, hs].contiguous()
        o, l = alibi_attention_plain(sub, slopes[hs], pos, pad, False, rate, SEED, True,
                                     h0=2 * r, hash_heads=h)
        torch.testing.assert_close(o, out[:, hs], rtol=0, atol=1e-6)
        dl = delta.reshape(b, h, t)[:, hs].reshape(-1, t)
        dq, pr = attention_bwd_plain(sub, dout[:, hs].contiguous(), l, dl, slopes[hs], pos, pad,
                                     False, rate, SEED, h0=2 * r, hash_heads=h)
        torch.testing.assert_close(dq, dqkv[:, :, hs], rtol=0, atol=1e-6)
        torch.testing.assert_close(pr, parts[:, hs], rtol=0, atol=1e-5)


def test_head_dims_past_128_raise(fake_card):
    x = torch.zeros((1, 16, 2, 136), dtype=BF16)
    slopes, pos = torch.ones(2), torch.arange(16, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="A.11"):
        alibi_flash_attention_packed(btc_to_packed(x.reshape(1, 16, -1).repeat(1, 1, 3), 2),
                                     slopes, pos, return_lse=True)
    with pytest.raises(ValueError, match="A.11"):
        bias_attention_forward(x, x, x)
    with pytest.raises(ValueError, match="A.11"):
        attention._quantize_op._init_fn(x, x, x, 64)
    assert fake_card.head_dims == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _within(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= atol + rtol * want.float().abs()).all(), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_alibi_kernels_match_plain_on_card(cuda, d):
    """#1 on the projection's thirds, #2 with lse and dropout 0.2, #3 with
    the slope partials and #4 at T 333 (six 64-row tiles, the last
    partial): forward 2e-2 + 2e-2 |plain|, lse 1e-3, the backward 5e-3 +
    1e-2 |plain| and 1e-3 relative norm per (b, h)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, h, t = 2, 4, 333
    qkv_btc = torch.randn((b, t, 3 * h * d), generator=gen, device=cuda).to(BF16)
    sl = torch.from_numpy((alibi_slopes(h) * 0.8).astype(np.float32)).to(cuda)
    p = torch.arange(t, dtype=torch.int32, device=cuda)[None]
    m = torch.zeros((b, t), dtype=torch.bool, device=cuda)
    m[1, -40:] = True
    q, k, v = qkv_btc.reshape(b, t, 3, h, d).unbind(2)
    before = alibi_flash_attention_serve.launches
    served = alibi_flash_attention_serve(q, k, v, sl, p, m)
    assert alibi_flash_attention_serve.launches == before + 1
    packed = btc_to_packed(qkv_btc, h)
    _within(served.transpose(1, 2), alibi_attention_plain(packed.float(), sl, p, m), 2e-2, 2e-2)
    out, lse = alibi_flash_attention_packed(packed, sl, p, m, False, 0.2, SEED, return_lse=True)
    out_p, lse_p = alibi_attention_plain(packed.float(), sl, p, m, False, 0.2, SEED,
                                         return_lse=True)
    _within(out, out_p, 2e-2, 2e-2)
    _within(lse, lse_p, 1e-3, 0.0)
    dout = torch.randn((b, h, t, d), generator=gen, device=cuda).to(BF16)
    delta = (dout.float() * out.float()).sum(-1).reshape(b * h, t)
    dq, parts = attention_dq(packed, dout, lse, delta, sl, p, m, False, 0.2, SEED)
    dk, dv = attention_dkv(packed, dout, lse, delta, sl, p, m, False, 0.2, SEED)
    want, parts_p = attention_bwd_plain(packed, dout, lse, delta, sl, p, m, False, 0.2, SEED)
    for got, ref in zip((dq, dk, dv), want.float()):
        _within(got, ref, 5e-3, 1e-2)
        per_head = ((got.float() - ref).flatten(2).norm(dim=-1)
                    / ref.flatten(2).norm(dim=-1).clamp_min(1e-3))
        assert (per_head <= 1e-3).all()
    assert torch.allclose(parts, parts_p, rtol=1e-3, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_int8_kernels_match_plain_on_card(cuda, d):
    """#5q bit for bit its plain version on the thirds of one projection at
    an unaligned T, and #5 2e-2 + 2e-2 |plain| against its plain version
    on those layouts, with a padded tail in row 1."""
    gen = torch.Generator(device=cuda).manual_seed(100 + d)
    b, t, h = 2, 1000, 16
    qkv = (1.5 * torch.randn((b, t, 3, h, d), generator=gen, device=cuda)).to(BF16)
    q, k, v = qkv.unbind(2)
    span, t_pad = int8_spans(t)
    got = quantize_qkv_int8_pass(q, k, v, t_pad)
    for a, r in zip(got, quantize_qkv_int8_pass_plain(q, k, v, t_pad)):
        assert a.shape == r.shape and torch.equal(a, r)
    sl = torch.from_numpy(alibi_slopes(h).astype(np.float32)).to(cuda)
    p = torch.arange(t, dtype=torch.int32, device=cuda)[None]
    m = torch.zeros((b, t), dtype=torch.bool, device=cuda)
    m[1, -300:] = True
    before = alibi_flash_attention_int8.launches
    out = alibi_flash_attention_int8(q, k, v, sl, p, m)
    torch.cuda.synchronize()
    assert alibi_flash_attention_int8.launches == before + 1
    _within(out, attention_int8_quantized_plain(*got, sl, p, m, True, span, BF16), 2e-2, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bias_kernels_match_plain_on_card(cuda, d):
    """#11 with and without lse, with the 2-D ALiBi bias (T 196) or a
    per-row bias (T 59) and with none; #11b's single launch (T 59) and dq + dbias and dk/dv (T
    196) with a key mask: out 1e-2 + 1e-2 |plain|, lse 1e-3, dq, dk, dv
    5e-3 + 1e-2 |plain|, dbias 1e-5 + 1e-2 |plain|."""
    gen = torch.Generator(device=cuda).manual_seed(200 + d)
    h = 4
    for b, t in ((8, 196), (16, 59)):
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device=cuda).to(BF16)
        q, k, v = qkv.unbind(2)
        mask = torch.zeros((b, t), dtype=torch.bool, device=cuda)
        mask[1, -9:] = True
        grid = (torch.from_numpy(alibi_bias_2d(t, h)[None]).to(cuda) if t == 196 else
                torch.randn((b, h, t, t), generator=gen, device=cuda))  # a student's keep-set
        for dense in (grid, None):
            out = bias_attention_forward(q, k, v, dense, mask)
            out_p = bias_attention_plain(q.float(), k.float(), v.float(), dense, mask)
            _within(out, out_p, 1e-2, 1e-2)
        out, lse = bias_attention_forward(q, k, v, dense, mask, with_lse=True)
        out_p, lse_p = bias_attention_plain(q.float(), k.float(), v.float(), dense, mask,
                                            return_lse=True)
        _within(out, out_p, 1e-2, 1e-2)
        _within(lse, lse_p, 1e-3, 1e-5)
        dense = torch.randn((b, h, t, t), generator=gen, device=cuda)
        out, lse = bias_attention_forward(q, k, v, dense, mask, with_lse=True)
        dout = torch.randn((b, t, h, d), generator=gen, device=cuda).to(BF16)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
        args = (q, k, v, dout, lse, delta, dense, mask)
        if t <= 64:
            dq, dk, dv, dbias = bias_attention_bwd_single(*args)
        else:
            (dq, dbias), (dk, dv) = bias_attention_dq(*args), bias_attention_dkv(*args)
        want = bias_attention_bwd_plain(*args)
        for got, ref, atol in zip((dq, dk, dv, dbias), want, (5e-3, 5e-3, 5e-3, 1e-5)):
            _within(got, ref, atol, 1e-2)
