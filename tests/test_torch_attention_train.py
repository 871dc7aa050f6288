"""The port's ALiBi attention training entry against the JAX package's.

``alibi_flash_attention_btc`` on the CPU runs autograd through the plain
version; the JAX entry of the same name runs, in interpret mode, the Pallas
forward ``_kernel`` with the lse output and the hash dropout, then the
backward kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. Inputs come
from numpy seeds; both sides get the same cotangent. fp32 tolerance: 1e-5
max-abs on the output and the qkv gradient (the same math in another
summation order), and 1e-5 relative on the slope gradient, a sum over
B * H * T^2 scores of terms up to T in size.

On the card (``gpu`` marker) each kernel is held against its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.ops.pallas_attention import (
    _pallas_forward_packed, alibi_flash_attention_btc as jax_btc,
)

from animal2vec_tpu_torch.ops.alibi import alibi_slopes
from animal2vec_tpu_torch.ops.attention import (
    alibi_attention_plain, alibi_flash_attention_btc, alibi_flash_attention_packed,
    attention_bwd_plain, attention_dkv, attention_dq, btc_to_packed,
)

TOL = 1e-5
SEED = -123457  # a negative int32 dropout seed


def _case(name, e=16):
    """(qkv_btc, heads, slopes, positions, mask, has_sentinel, rate, cotangent)
    with head width ``e`` (the kernels are built for 64)."""
    rng = np.random.default_rng(len(name))
    b, h = (3, 2) if name == "dead_row" else (2, 2)
    t = {"dropout": 128, "dead_row": 128, "short": 40, "keep_set": 125, "t190": 190}.get(name, 200)
    qkv = rng.normal(size=(b, t, 3 * h * e)).astype(np.float32)
    slopes = (alibi_slopes(h) * 0.8).astype(np.float32)
    pos, mask, sentinel, rate = np.arange(t, dtype=np.int32)[None], None, False, 0.0
    g = rng.normal(size=(b, t, h * e)).astype(np.float32)
    if name == "dropout":
        rate = 0.2
    elif name == "dead_row":
        mask = np.zeros((b, t), bool)
        mask[0, -37:] = True
        mask[2] = True  # every key of row 2 padded
        # the TPU backward passes gradient through the -1e9 fill of a row
        # whose keys are all padded (exp(-1e9 - lse) = 1 there); the port
        # gives the true gradient, zero for q, k and the slopes. The rows
        # agree when that row's cotangent is zero.
        g[2] = 0.0
        rate = 0.2
    elif name == "sentinel":
        rows = [np.sort(rng.choice(2 * t, t - 3, replace=False)) for _ in range(b)]
        pos = np.stack([np.concatenate([[-1, -1, -1], r]) for r in rows]).astype(np.int32)
        sentinel, rate = True, 0.2
    elif name in ("short", "no_lse", "t190"):  # T under one 64-row tile; T 200; T 190
        rate = 0.2
    elif name == "keep_set":  # the audio student's kept tokens at their own positions
        pos = np.stack([np.sort(rng.choice(2000, t, replace=False))
                        for _ in range(b)]).astype(np.int32)
        rate = 0.1
    return qkv, h, slopes, pos, mask, sentinel, rate, g


def _port(qkv, h, slopes, pos, mask, sentinel, rate, g):
    q = torch.from_numpy(qkv).requires_grad_()
    s = torch.from_numpy(slopes).requires_grad_()
    out = alibi_flash_attention_btc(q, h, s, torch.from_numpy(pos),
                                    None if mask is None else torch.from_numpy(mask),
                                    sentinel, rate, SEED if rate else None)
    dq, ds = torch.autograd.grad(out, (q, s), torch.from_numpy(g))
    return out.detach().numpy(), dq.numpy(), ds.numpy()


def _jax(qkv, h, slopes, pos, mask, sentinel, rate, g):
    m = None if mask is None else jnp.asarray(mask)
    seed = jnp.asarray(SEED, jnp.int32) if rate else None
    out, vjp = jax.vjp(
        lambda q, s: jax_btc(q, h, s, jnp.asarray(pos), m, sentinel, rate, seed),
        jnp.asarray(qkv), jnp.asarray(slopes),
    )
    dq, ds = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dq), np.asarray(ds)


@pytest.mark.parametrize("name", ["dropout", "dead_row", "sentinel", "unaligned"])
def test_training_entry_matches_jax_kernels(name):
    args = _case(name)
    out, dq, ds = _port(*args)
    out_j, dq_j, ds_j = _jax(*args)
    assert np.isfinite(dq).all() and np.isfinite(ds).all()
    np.testing.assert_allclose(out, out_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(dq, dq_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(ds, ds_j, rtol=TOL, atol=0)
    if name == "dead_row":  # the true gradient of an all-padded row
        qkv, h = args[0], args[1]
        g = args[-1].copy()
        g[:2] = 0.0
        g[2] = 1.0
        _, dq2, ds2 = _port(*args[:-1], g)
        c = qkv.shape[-1] // 3
        assert np.all(dq2[:, :, :2 * c] == 0.0) and np.all(ds2 == 0.0)


def test_lse_matches_jax_kernel():
    qkv, h, slopes, pos, mask, sentinel, rate, _ = _case("dead_row")
    packed = btc_to_packed(torch.from_numpy(qkv), h)
    _, lse = alibi_attention_plain(packed, torch.from_numpy(slopes), torch.from_numpy(pos),
                                   torch.from_numpy(mask), sentinel, rate, SEED, return_lse=True)
    _, lse_j = _pallas_forward_packed(jnp.asarray(packed.numpy()), jnp.asarray(slopes),
                                      jnp.asarray(pos), jnp.asarray(mask),
                                      has_sentinel=sentinel, dropout_rate=rate,
                                      seed=jnp.asarray(SEED, jnp.int32))
    b, t = mask.shape
    lse_j = np.asarray(lse_j).reshape(b * h, -1)[:, :t]
    assert lse.shape == (b * h, t)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0, atol=TOL)


def test_explicit_backward_matches_autograd_of_plain():
    """``attention_bwd_plain`` (the backward kernels' reference, written out
    with an lse and delta) is the gradient of the plain forward; its slope
    partials sum to the slope gradient."""
    qkv, h, slopes, pos, mask, sentinel, rate, g = _case("dead_row")
    b, t, _ = qkv.shape
    packed = btc_to_packed(torch.from_numpy(qkv), h).requires_grad_()
    s = torch.from_numpy(slopes).requires_grad_()
    p, m = torch.from_numpy(pos), torch.from_numpy(mask)
    out, lse = alibi_attention_plain(packed, s, p, m, sentinel, rate, SEED, return_lse=True)
    dout = torch.from_numpy(g).reshape(b, t, h, -1).permute(0, 2, 1, 3)
    want_qkv, want_s = torch.autograd.grad(out, (packed, s), dout)
    delta = (dout * out.detach()).sum(-1).reshape(b * h, t)
    dqkv, parts = attention_bwd_plain(packed.detach(), dout, lse.detach(), delta, s.detach(),
                                      p, m, sentinel, rate, SEED)
    np.testing.assert_allclose(dqkv.numpy(), want_qkv.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(parts.sum((0, 2)).numpy(), want_s.numpy(), rtol=TOL, atol=0)
    # the CPU entries of the two kernels run the same reference
    dq, parts_q = attention_dq(packed.detach(), dout, lse.detach(), delta, s.detach(), p, m,
                               sentinel, rate, SEED)
    dk, dv = attention_dkv(packed.detach(), dout, lse.detach(), delta, s.detach(), p, m,
                           sentinel, rate, SEED)
    assert torch.equal(torch.stack([dq, dk, dv]), dqkv) and torch.equal(parts_q, parts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name", ["dropout", "dead_row", "sentinel", "short", "unaligned", "keep_set", "no_lse",
             "t190"])
def test_kernels_match_plain_on_card(cuda, name):
    """Forward (out, lse), dq with the slope partials and dk/dv against their
    plain versions on the same bf16 inputs, and the autograd Function's
    gradients against autograd of the plain version, at the edges of the
    kernels' 64-row tiles and their ring of staged tiles: T 128 (two whole
    tiles), T 40 (under one tile), T 200 (four tiles, the last partial:
    the ring wraps and drains), T 125 with per-row positions and T 190
    (the forward's last block of 128 query rows holds 62 rows, so its
    second warpgroup holds only rows past T). ``no_lse`` also makes the
    dropout launches without an lse, through the packed entry and the
    training entry without a gradient, held as the forward. Tolerances: a bf16
    forward output, a few bf16 ulps (2e-2 + 2e-2 |plain|). The backward
    reference rounds P * f, dS and its outputs to bf16 where the kernels
    do, leaving fp32 summation order: 5e-3 + 1e-2 |plain| (one bf16 ulp is
    under the rtol) and a 1e-3 relative norm per (b, h), the tolerances of
    ``chip_smoke.py`` phase 3b, which prints the errors at the training
    shape (norms under 1e-3, the all-zero heads of the zero-cotangent row,
    count as 1e-3). Against fp32 autograd of the plain version: 1e-2
    relative norm for qkv, 1e-3 for the slopes."""
    qkv, h, slopes, pos, mask, sentinel, rate, g = _case(name, e=64)
    b, t, _ = qkv.shape
    packed = btc_to_packed(torch.from_numpy(qkv), h).to(cuda, torch.bfloat16)
    sl, p = torch.from_numpy(slopes).to(cuda), torch.from_numpy(pos).to(cuda)
    m = None if mask is None else torch.from_numpy(mask).to(cuda)
    seed = SEED if rate else None
    before = alibi_flash_attention_packed.launches
    out, lse = alibi_flash_attention_packed(packed, sl, p, m, sentinel, rate, seed,
                                            return_lse=True)
    assert alibi_flash_attention_packed.launches == before + 1
    out_p, lse_p = alibi_attention_plain(packed.float(), sl, p, m, sentinel, rate, seed,
                                         return_lse=True)
    assert ((out.float() - out_p).abs() <= 2e-2 + 2e-2 * out_p.abs()).all()
    assert ((lse - lse_p).abs() <= 1e-3).all()
    if name == "no_lse":
        x = torch.from_numpy(qkv).to(cuda, torch.bfloat16)
        with torch.no_grad():
            got = [alibi_flash_attention_packed(packed, sl, p, m, sentinel, rate, seed),
                   alibi_flash_attention_btc(x, h, sl, p, m, sentinel, rate, seed)
                   .reshape(b, t, h, -1).transpose(1, 2)]
        assert alibi_flash_attention_packed.launches == before + 3
        for o in got:
            assert ((o.float() - out_p).abs() <= 2e-2 + 2e-2 * out_p.abs()).all()
    dout = torch.from_numpy(g).reshape(b, t, h, -1).permute(0, 2, 1, 3).contiguous()
    dout = dout.to(cuda, torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).reshape(b * h, t)
    dq, parts = attention_dq(packed, dout, lse, delta, sl, p, m, sentinel, rate, seed)
    dk, dv = attention_dkv(packed, dout, lse, delta, sl, p, m, sentinel, rate, seed)
    want, parts_p = attention_bwd_plain(packed, dout, lse, delta, sl, p, m, sentinel, rate,
                                        seed)
    for got, ref in zip((dq, dk, dv), want.float()):
        assert ((got.float() - ref).abs() <= 5e-3 + 1e-2 * ref.abs()).all()
        per_head = ((got.float() - ref).flatten(2).norm(dim=-1)
                    / ref.flatten(2).norm(dim=-1).clamp_min(1e-3))
        assert (per_head <= 1e-3).all()
    assert torch.allclose(parts, parts_p, rtol=1e-3, atol=1e-2)
    # the autograd Function against autograd of the plain version
    x = torch.from_numpy(qkv).to(cuda, torch.bfloat16).requires_grad_()
    s = sl.clone().requires_grad_()
    o = alibi_flash_attention_btc(x, h, s, p, m, sentinel, rate, seed)
    gx, gs = torch.autograd.grad(o, (x, s), torch.from_numpy(g).to(cuda, torch.bfloat16))
    xf = x.detach().float().requires_grad_()  # the same bf16 inputs, in fp32
    sf = sl.clone().requires_grad_()
    of = alibi_attention_plain(btc_to_packed(xf, h), sf, p, m, sentinel, rate, seed)
    gxf, gsf = torch.autograd.grad(of, (xf, sf), dout.float())
    assert ((gx.float() - gxf).norm() / gxf.norm()) < 1e-2
    assert ((gs - gsf).norm() / gsf.norm()) < 1e-3
