"""The fp32 instances of the ALiBi attention kernels (#1-#4) and of the fused
post-LN block (#6): JAX's default compute dtype on the card.

Each fp32 product of these kernels is three bf16 products of the operands'
split parts, ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` with ``hi = bf16(x)`` and
``lo = bf16(x - hi)``, summed into one fp32 accumulator
(``csrc/sm90.cuh`` ``split_pair``; the block's GEMMs take the same sum as
one product along K three times as long). On the CPU:

* (a) that arithmetic in plain PyTorch (``mm3`` below) through #2's forward
  with its lse and dropout, #3 / #4 and the slope partials, and the block's
  fc1 / fc2 (the plain block's math with ``mm3`` as its product), against
  the JAX package's Pallas kernels in fp32, interpreted on the CPU as the
  JAX package's own tests run them, at B 2, H 2, T 70, D 64 and 80; C 128,
  M 512: within the gates ``chip_smoke.py`` phase 22k holds the card's
  fp32 instances to (a tenth of each bf16 gate), so the design can meet
  them (the slope partials against float64: the plain version's own fp32
  error exceeds a tenth of their bf16 gate at the card's shape);
* (b) the wrappers' kernel route on a fake card (``FakeCard`` of
  ``tests/test_torch_head_dim_kernels.py`` and a fake of the block's and
  the MLP's entries): fp32 tensors take the ``_f32`` entries, each launch
  counter moves by one, the outputs are fp32 and equal the plain versions;
  the kernels without an fp32 instance raise on fp32, naming ROADMAP A.13,
  where #8, #11 and #11b (whose fp32 instances came later:
  ``tests/test_torch_fp32_dense_bias.py``) take their ``_f32`` entries;
* the configurations whose paths run such a kernel refused at build on a
  CUDA device, naming A.13 (``config.check_card_dtype``), the others
  admitted, and the port's ``CommonConfig()`` default dtype equal to JAX's
  (``float32``).

On the card (``gpu`` marker; this file imports no JAX, flax or other test
module at module level), each fp32 instance against its plain version at small shapes, at
the phase 22k gates.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.config import (
    CommonConfig, DistributedConfig, FinetuneConfig, ImageConfig, RunConfig, apply_overrides,
    check_card_dtype,
)
from animal2vec_tpu_torch.ops import attention, bias_attention, fused_mlp, int8_mm
from animal2vec_tpu_torch.ops.alibi import alibi_slopes
from animal2vec_tpu_torch.ops.attention import (
    Q_TILE, alibi_attention_btc_plain, alibi_attention_plain, alibi_flash_attention_btc,
    alibi_flash_attention_packed, alibi_flash_attention_serve, attention_bwd_plain,
    attention_dkv, attention_dq,
)
from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_block_plain, fused_mlp_plain

F32 = torch.float32
SEED = -123457
RATE = 0.2
# phase 22k's gates (chip_smoke.py): a tenth of each bf16 tolerance, as
# (atol, rtol) against |reference|; the slope partials' is the bf16 gate,
# against float64: this arithmetic's partials lie 3.7-4.3x the tenth away
# from float64 at b4 H 16 T 2000 with a padded row (the plain version's in
# fp32 16.4x), and 4x that passes the bf16 gate, the cap
ATTN_TOL = (1e-3, 1e-3)
LSE_TOL = (1e-4, 1e-6)
BWD_TOL = (5e-4, 1e-3)
SLOPE_PART_TOL = (1e-2, 1e-3)
BLOCK_TOL = (3e-3, 2e-3)
HEAD_DIMS = (64, 80)


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the fp32 instances take it: the three bf16 products of the
    split parts (each exact in fp32), summed in fp32."""
    (ah, al), (bh, bl) = _split(a.float()), _split(b.float())
    return ah @ bh + ah @ bl + al @ bh


def _within(name, got, want, tol):
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    assert torch.isfinite(got).all(), name
    assert (err <= bound).all(), f"{name}: worst ratio {(err / bound).max().item():.3f}"
    return (err / bound).max().item()


# ---------------------------------------------------------------------------
# (a) the split arithmetic against JAX's Pallas kernels in fp32
# ---------------------------------------------------------------------------


def _attention_case(d):
    """fp32 (3, B, H, T, D) qkv, slopes, per-row positions, a padded row's
    tail, and a cotangent (B, H, T, D), from numpy."""
    rng = np.random.default_rng(2400 + d)
    b, h, t = 2, 2, 70
    qkv = rng.normal(size=(3, b, h, t, d)).astype(np.float32)
    slopes = (alibi_slopes(h) * 0.8).astype(np.float32)
    pos = np.stack([np.sort(rng.choice(2 * t, t, replace=False)) for _ in range(b)])
    mask = np.zeros((b, t), bool)
    mask[1, -11:] = True
    g = rng.normal(size=(b, h, t, d)).astype(np.float32)
    return qkv, slopes, pos.astype(np.int32), mask, g


def _emulated_forward(qkv, slopes, pos, mask, rate, seed):
    """#2's fp32 instance: S by mm3, the scalar pass in fp32 (the bias
    rounded first), P f's split parts against V's; (out, lse)."""
    q, k, v = qkv.unbind(0)
    b, h, t, d = q.shape
    _, dist = attention._scores(qkv, slopes, pos, mask, False)
    logits = mm3(q, k.transpose(-1, -2)) * d**-0.5 - dist[:, None] * slopes[None, :, None, None]
    logits = logits.masked_fill(mask[:, None, None, :], attention.NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l_sum = p.sum(-1, keepdim=True)
    f = attention._keep_factor(b, h, t, rate, seed, q.device)
    out = mm3(p * f, v) / l_sum
    return out, (m + torch.log(l_sum)).reshape(b * h, t)


def _emulated_backward(qkv, dout, lse, delta, slopes, pos, mask, rate, seed):
    """#3 / #4's fp32 instances: S, dP, dq, dk, dv by mm3, the slope
    partials as the fp32 dq kernel sums them (``attention_bwd_plain``'s
    rule with P normalized by its row sum S: -(a - d b / S) / S); (dq, dk,
    dv, partials (B, H, ceil(T / 64)))."""
    q, k, v = qkv.unbind(0)
    b, h, t, d = q.shape
    scale = d**-0.5
    _, dist = attention._scores(qkv, slopes, pos, mask, False)
    logits = mm3(q, k.transpose(-1, -2)) * scale - dist[:, None] * slopes[None, :, None, None]
    p = torch.exp((logits - lse.reshape(b, h, t, 1)).masked_fill(mask[:, None, None, :],
                                                                 -torch.inf))
    f = attention._keep_factor(b, h, t, rate, seed, q.device)
    dpf = mm3(dout, v.transpose(-1, -2)) * f
    ds = p * (dpf - delta.reshape(b, h, t, 1))
    dq = scale * mm3(ds, k)
    dk = scale * mm3(ds.transpose(-1, -2), q)
    dv = mm3((p * f).transpose(-1, -2), dout)
    pdp = p * dpf
    s = p.sum(-1)
    per_row = -((pdp * dist[:, None]).sum(-1) - pdp.sum(-1) * (p * dist[:, None]).sum(-1) / s) / s
    n_qt = -(-t // Q_TILE)
    per_row = torch.nn.functional.pad(per_row, (0, n_qt * Q_TILE - t))
    return dq, dk, dv, per_row.reshape(b, h, n_qt, Q_TILE).sum(-1)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_split_attention_forward_matches_jax_kernel(d, monkeypatch):
    """#2's fp32 arithmetic with dropout 0.2 against ``_kernel`` in fp32:
    out within ATTN_TOL, lse within LSE_TOL."""
    import jax.numpy as jnp
    from animal2vec_tpu.ops.pallas_attention import _pallas_forward_packed

    monkeypatch.setenv("A2V_FLASH_INTERPRET", "1")
    qkv, slopes, pos, mask, _ = _attention_case(d)
    out, lse = _emulated_forward(torch.from_numpy(qkv), torch.from_numpy(slopes),
                                 torch.from_numpy(pos), torch.from_numpy(mask), RATE, SEED)
    out_j, lse_j = _pallas_forward_packed(
        jnp.asarray(qkv), jnp.asarray(slopes), jnp.asarray(pos), jnp.asarray(mask),
        has_sentinel=False, dropout_rate=RATE, seed=jnp.asarray(SEED, jnp.int32))
    t = qkv.shape[3]
    _within("out", out, torch.from_numpy(np.asarray(out_j)), ATTN_TOL)
    _within("lse", lse, torch.from_numpy(np.asarray(lse_j))[..., :t].reshape(lse.shape), LSE_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_split_attention_backward_matches_jax_kernels(d, monkeypatch):
    """#3 / #4's fp32 arithmetic with dropout 0.2 against the VJP of JAX's
    packed entry (``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` in fp32): dq, dk,
    dv within BWD_TOL; the slope gradient (the partials summed) and each
    partial against float64 within SLOPE_PART_TOL (the card's check)."""
    import jax
    import jax.numpy as jnp
    from animal2vec_tpu.ops.pallas_attention import alibi_flash_attention_packed as jax_packed

    monkeypatch.setenv("A2V_FLASH_INTERPRET", "1")
    qkv, slopes, pos, mask, g = _attention_case(d)
    tq, ts, tp, tm, tg = map(torch.from_numpy, (qkv, slopes, pos, mask, g))
    out, lse = _emulated_forward(tq, ts, tp, tm, RATE, SEED)
    delta = (tg * out).sum(-1).reshape(-1, out.shape[2])
    dq, dk, dv, parts = _emulated_backward(tq, tg, lse, delta, ts, tp, tm, RATE, SEED)
    _, vjp = jax.vjp(lambda x, sl: jax_packed(x, sl, jnp.asarray(pos), jnp.asarray(mask), False,
                                              RATE, jnp.asarray(SEED, jnp.int32)),
                     jnp.asarray(qkv), jnp.asarray(slopes))
    dqkv_j, dsl_j = (torch.from_numpy(np.asarray(x)) for x in vjp(jnp.asarray(g)))
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), dqkv_j.unbind(0)):
        _within(name, got, want, BWD_TOL)
    _within("slope gradient", parts.sum(dim=(0, 2)), dsl_j, SLOPE_PART_TOL)
    _within("slope partials", parts, _partials_fp64(tq, tg, ts, tp, tm), SLOPE_PART_TOL)


def _partials_fp64(qkv, dout, slopes, pos, mask):
    """The slope partials in float64 from the fp32 values (softmax, dP and
    the row sums in float64), ``RATE`` and ``SEED``'s dropout."""
    q, k, v = (x.double() for x in qkv.unbind(0))
    b, h, t, d = q.shape
    _, dist = attention._scores(qkv, slopes, pos, mask, False)
    dist = dist.double()[:, None]
    logits = q @ k.transpose(-1, -2) * d**-0.5 - dist * slopes.double()[None, :, None, None]
    p = torch.softmax(logits.masked_fill(mask[:, None, None, :], -torch.inf), -1)
    f = attention._keep_factor(b, h, t, RATE, SEED, q.device).double()
    pdp = p * (dout.double() @ v.transpose(-1, -2)) * f
    per_row = -((pdp * dist).sum(-1) - pdp.sum(-1) * (p * dist).sum(-1))
    n_qt = -(-t // Q_TILE)
    per_row = torch.nn.functional.pad(per_row, (0, n_qt * Q_TILE - t))
    return per_row.reshape(b, h, n_qt, Q_TILE).sum(-1)


def test_split_block_matches_jax_kernel(monkeypatch):
    """#6's fp32 arithmetic (the plain block's math with ``mm3`` as its two
    products; r, h, t and the residual in fp32) with its three dropout
    sites against JAX's ``fused_block_mlp`` in fp32 (``_kernel_bf16_block``
    interpreted): x_out and the tap within BLOCK_TOL."""
    import jax.numpy as jnp
    from animal2vec_tpu.ops.fused_mlp import fused_block_mlp as jax_block

    monkeypatch.setenv("A2V_PALLAS_SERVE", "1")
    rng = np.random.default_rng(2406)
    n, c, m = 140, 128, 512
    arrays = [rng.normal(size=(n, c)).astype(np.float32),
              (rng.uniform(0.5, 1.5, c)).astype(np.float32), (rng.normal(size=c) * 0.1),
              rng.normal(size=(c, m)) * (2 / (c + m)) ** 0.5,
              rng.normal(size=(m, c)) * (2 / (c + m)) ** 0.5, rng.normal(size=m) * 0.1,
              rng.normal(size=c) * 0.1, rng.uniform(0.5, 1.5, c), rng.normal(size=c) * 0.1]
    arrays = [a.astype(np.float32) for a in arrays]
    seeds = (11, -12, 13)
    xo, tap = fused_mlp._block_math(*map(torch.from_numpy, arrays), 1e-5, seeds, 0.1, 0.1, mm3)
    x, l1s, l1b, w1, w2, b1, b2, l2s, l2b = map(jnp.asarray, arrays)
    xo_j, tap_j = jax_block(x, l1s, l1b, w1, w2, b1, b2, l2s, l2b, 1e-5,
                            seeds=jnp.asarray(seeds, jnp.int32), act_rate=0.1, post_rate=0.1)
    _within("tap", tap, torch.from_numpy(np.asarray(tap_j)), BLOCK_TOL)
    _within("x_out", xo, torch.from_numpy(np.asarray(xo_j)), BLOCK_TOL)


# ---------------------------------------------------------------------------
# (b) the kernel route on a fake card
# ---------------------------------------------------------------------------


class FakeBlockCard:
    """The fused block's and the fused MLP's fp32 C entries over host
    memory: each reads x, the weights (nn.Linear layout) and the vectors
    where the wrapper points, checks the scratch it was handed, writes the
    plain version's outputs; no dropout. ``calls`` and ``mlp_calls`` count
    their launches."""

    calls = 0
    mlp_calls = 0

    def a2v_fused_mlp_f32(self, x, w1, b1, w2, b2, xs, w1s, w2s, hs, out, n, c, m, c2, s0, s1,
                          thresh, keep_scale, row0, stream):
        from tests.test_torch_head_dim_kernels import _dense

        assert thresh == 0 and all(p is not None for p in (xs, w1s, w2s, hs))
        _dense(out, F32, n, c2).copy_(fused_mlp_plain(
            _dense(x, F32, n, c), _dense(w1, F32, m, c), _dense(w2, F32, c2, m),
            _dense(b1, F32, m), _dense(b2, F32, c2)))
        self.mlp_calls += 1
        return 0

    def a2v_fused_block_f32(self, x, l1s, l1b, w1t, b1, w2t, b2, l2s, l2b, r, rs, w1s, w2s, hs,
                            t, x_out, n, c, m, eps, s0, s1, s2, act_t, act_scale, post_t,
                            post_scale, row0, branch_scale, rows_per_scale, stream):
        from tests.test_torch_head_dim_kernels import _dense

        assert act_t == 0 and post_t == 0 and branch_scale is None
        assert all(p is not None for p in (r, rs, w1s, w2s, hs))
        vec = lambda p, size: _dense(p, F32, size)  # noqa: E731
        xo, tap = fused_block_plain(
            _dense(x, F32, n, c), vec(l1s, c), vec(l1b, c), _dense(w1t, F32, m, c).t(),
            _dense(w2t, F32, c, m).t(), vec(b1, m), vec(b2, c), vec(l2s, c), vec(l2b, c), eps)
        _dense(x_out, F32, n, c).copy_(xo)
        _dense(t, F32, n, c).copy_(tap)
        self.calls += 1
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the kernel route of the attention and block
    wrappers, whose C entries ``FakeCard`` and ``FakeBlockCard`` run (the
    helpers of a CPU test file, imported here: the card's runs collect this
    file for its ``gpu`` tests alone)."""
    from tests.test_torch_head_dim_kernels import FakeCard

    card = FakeCard()
    block = FakeBlockCard()
    for module in (attention, bias_attention):
        monkeypatch.setattr(module, "_on_cpu", lambda x: False)
        monkeypatch.setattr(module, "_check_device", lambda x, what: None)
    monkeypatch.setattr(attention, "library", lambda: card)  # every entry of both modules
    monkeypatch.setattr(fused_mlp, "library", lambda: block)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return types.SimpleNamespace(attention=card, block=block)


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _close32(got, want):
    assert got.dtype == F32 and got.shape == want.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fp32_attention_takes_the_fp32_entries(fake_card, d):
    """The training entry on fp32 tensors: #2 with its lse, then #3 and #4,
    each launched once through its ``_f32`` entry, fp32 out and gradients
    equal to autograd of the plain version; #1 (the serving op's card
    implementation) on the projection's thirds, fp32 out."""
    rng = np.random.default_rng(d)
    b, h, t = 2, 2, 70
    x = _f32(rng, b, t, 3 * h * d).requires_grad_()
    g = _f32(rng, b, t, h * d)
    slopes = torch.from_numpy((alibi_slopes(h) * 0.8).astype(np.float32)).requires_grad_()
    pos = torch.arange(t, dtype=torch.int32)[None]
    mask = torch.zeros((b, t), dtype=torch.bool)
    mask[1, -11:] = True
    called = []
    for name in ("a2v_alibi_attention_fwd_f32", "a2v_alibi_attention_bwd_dq_f32",
                 "a2v_alibi_attention_bwd_dkv_f32"):
        fn = getattr(fake_card.attention, name)
        setattr(fake_card.attention, name,
                lambda *a, _fn=fn, _name=name: called.append(_name) or _fn(*a))
    launches = (alibi_flash_attention_packed.launches, attention_dq.launches,
                attention_dkv.launches)
    out = alibi_flash_attention_btc(x, h, slopes, pos, mask)
    gx, gs = torch.autograd.grad(out, (x, slopes), g)
    assert (alibi_flash_attention_packed.launches, attention_dq.launches,
            attention_dkv.launches) == tuple(n + 1 for n in launches)
    assert called == ["a2v_alibi_attention_fwd_f32", "a2v_alibi_attention_bwd_dq_f32",
                      "a2v_alibi_attention_bwd_dkv_f32"]
    xf = x.detach().clone().requires_grad_()
    sf = slopes.detach().clone().requires_grad_()
    of = alibi_attention_btc_plain(xf, h, sf, pos, mask)
    gxf, gsf = torch.autograd.grad(of, (xf, sf), g)
    _close32(out, of)
    _close32(gx, gxf)
    torch.testing.assert_close(gs, gsf, rtol=1e-4, atol=1e-4 * gsf.abs().max().item())
    q, k, v = x.detach().reshape(b, t, 3, h, d).unbind(2)
    before = alibi_flash_attention_serve.launches
    served = attention._serve_op._init_fn(q, k, v, slopes.detach(), pos, mask, False)
    assert alibi_flash_attention_serve.launches == before + 1
    assert called[-1] == "a2v_alibi_attention_fwd_f32"
    _close32(served.transpose(1, 2),
             alibi_attention_plain(torch.stack([q, k, v]).transpose(2, 3), slopes.detach(), pos,
                                   mask))


def test_fp32_block_takes_the_fp32_entry(fake_card):
    """#6 on fp32 tensors: the serving op's card implementation and the
    autograd Function each launch the fp32 entry once (fp32 x_out and tap
    equal to the plain version); the Function's backward recomputes in
    fp32 against autograd of the plain version."""
    rng = np.random.default_rng(2407)
    n, c, m = 70, 128, 512
    x = _f32(rng, 2, n, c)
    args = [_f32(rng, c, scale=0.1) + 1, _f32(rng, c, scale=0.1), _f32(rng, c, m, scale=0.06),
            _f32(rng, m, c, scale=0.06), _f32(rng, m, scale=0.1), _f32(rng, c, scale=0.1),
            _f32(rng, c, scale=0.1) + 1, _f32(rng, c, scale=0.1)]
    before = fused_block_mlp.launches
    xo, tap = fused_mlp._block_op._init_fn(x, *args, 1e-5)
    assert fused_block_mlp.launches == before + 1 and fake_card.block.calls == 1
    xp, tp = fused_block_plain(x, *args, 1e-5)
    _close32(xo, xp)
    _close32(tap, tp)
    leaves = [v.clone().requires_grad_() for v in [x] + args]
    xo, tap = fused_mlp._FusedBlock.apply(*leaves, 1e-5, None, 0.0, 0.0, 0, None)
    assert fake_card.block.calls == 2
    cot = (_f32(rng, 2, n, c), _f32(rng, 2, n, c))
    grads = torch.autograd.grad((xo, tap), leaves, cot)
    plain_leaves = [v.detach().clone().requires_grad_() for v in leaves]
    grads_p = torch.autograd.grad(fused_block_plain(*plain_leaves, 1e-5), plain_leaves, cot)
    for got, want in zip(grads, grads_p):
        _close32(got, want)


def _raises_a13(fn):
    with pytest.raises(ValueError, match="A.13"):
        fn()


# the kernels whose fp32 instances tests/test_torch_fp32_dense_bias.py
# holds (ROADMAP A.13): their wrappers take the ``_f32`` entries
GAINED_FP32 = ("#8", "#11", "#11b")


@pytest.mark.parametrize("kernel", ["#5q", "#5", "#6s fc1", "#6s fc2", "#6s ln2", "#7", "#8",
                                    "#10", "#11", "#11b"])
def test_kernels_without_an_fp32_instance_raise(fake_card, kernel):
    """Each wrapper whose kernel has no fp32 instance yet raises on fp32
    operands, naming ROADMAP A.13, before any launch (#9's wrapper checks
    its device first: its case is the ``gpu`` test at the end). The
    kernels that have one since (``GAINED_FP32``: #8, #11 and #11b's
    backward launch) take their ``_f32`` entry on the same fp32 operands
    instead, once, and return fp32 equal to the plain version."""
    rng = np.random.default_rng(7)
    x = _f32(rng, 64, 128)
    w = _f32(rng, 128, 128)
    q = k = v = _f32(rng, 1, 64, 2, 64)
    w_q, w_s = torch.zeros((128, 128), dtype=torch.int8), torch.ones(128)
    if kernel in GAINED_FP32:
        called = []
        for name in ("a2v_bias_attention_f32", "a2v_bias_attention_bwd_single_f32"):
            fn = getattr(fake_card.attention, name)
            setattr(fake_card.attention, name,
                    lambda *a, _fn=fn, _name=name: called.append(_name) or _fn(*a))
        if kernel == "#8":
            _close32(fused_mlp._launch_mlp(x, w, w, None, None), fused_mlp_plain(x, w, w))
            assert fake_card.block.mlp_calls == 1
            return
        out, lse = bias_attention.bias_attention_plain(q, k, v, return_lse=True)
        if kernel == "#11":
            _close32(bias_attention.bias_attention_forward(q, k, v), out)
            assert called == ["a2v_bias_attention_f32"]
            return
        dout = _f32(rng, 1, 64, 2, 64)
        delta = (dout * out).sum(-1).transpose(1, 2).reshape(2, 64).contiguous()
        got = bias_attention.bias_attention_bwd_single(q, k, v, dout, lse, delta)
        want = bias_attention.bias_attention_bwd_plain(q, k, v, dout, lse, delta)
        for g, ref in zip(got[:3], want[:3]):
            _close32(g, ref)
        assert called == ["a2v_bias_attention_bwd_single_f32"]
        return
    calls = {
        "#5q": lambda: attention._quantize_op._init_fn(q, k, v, 64),
        "#5": lambda: attention._attention_int8_op._init_fn(
            *attention._quantized_layouts(q, 64), torch.ones(2), torch.zeros((1, 64),
                                                                              dtype=torch.int32),
            None, True, 64, F32),
        "#6s fc1": lambda: fused_mlp._launch_fc1(x, None, None, w, None, 1e-5, None, 0.0, 0, 0),
        "#6s fc2": lambda: fused_mlp._launch_fc2_partial(x, w),
        "#6s ln2": lambda: fused_mlp._launch_ln2(x, None, x, None, None, 1e-5, None, 0.0, 0.0, 0,
                                                 None),
        "#7": lambda: fused_mlp._block_int8_op._init_fn(x, None, None, w_q, w_s, None, w_q, w_s,
                                                        None, None, None, 1e-5),
        "#10": lambda: int8_mm._dense_op._init_fn(x, w_q, w_s, None),
    }
    _raises_a13(calls[kernel])


# ---------------------------------------------------------------------------
# the configurations: JAX's default dtype, and the refusals at build
# ---------------------------------------------------------------------------


def test_common_config_default_dtype_is_jax_default():
    """The port's ``CommonConfig()`` computes in JAX's default dtype."""
    from animal2vec_tpu.config import CommonConfig as JaxCommonConfig

    assert CommonConfig().compute_dtype == JaxCommonConfig().compute_dtype == "float32"
    assert RunConfig(model=FinetuneConfig(), finetune=RunConfig.finetune_100().finetune
                     ).common.compute_dtype == "float32"


# each configuration with the kernel its path runs without an fp32
# instance, or None where every kernel of its path has one (pre-LN trunks
# on #8, the image modality and ALiBi-free encoders on #11 / #11b)
_LEFT_OUT = {
    "pre-LN": (dataclasses.replace(FinetuneConfig(), layer_norm_first=True), "", 1, None),
    "image": (dataclasses.replace(ImageConfig(), layer_norm_first=True), "", 1, None),
    "no ALiBi": (dataclasses.replace(FinetuneConfig(), use_alibi_encoder=False), "", 1, None),
    "int8": (dataclasses.replace(FinetuneConfig(), matmul_impl="int8"), "", 1, "#7"),
    "int8_attn": (dataclasses.replace(FinetuneConfig(), matmul_impl="int8_attn"), "", 1, "#5"),
    "int8 teacher": (FinetuneConfig(), "int8", 1, "#10"),
    "tensor parallel": (FinetuneConfig(), "", 2, "#6's split"),
}


@pytest.mark.parametrize("case", sorted(_LEFT_OUT))
def test_fp32_on_the_card_refuses_what_this_slice_leaves_out(case):
    """fp32 on a CUDA device raises at build for each configuration whose
    path runs a kernel without an fp32 instance, naming the kernel and
    ROADMAP A.13, and passes for those whose kernels all have one (a pre-LN
    trunk, the pre-LN image model, an ALiBi-free encoder); bf16 there, and
    fp32 on the CPU, pass."""
    enc, teacher, mp, kernel = _LEFT_OUT[case]
    if kernel is None:
        check_card_dtype(enc, "float32", "cuda", teacher, mp)
    else:
        with pytest.raises(NotImplementedError, match="A.13") as err:
            check_card_dtype(enc, "float32", "cuda", teacher, mp)
        assert kernel in str(err.value)
    check_card_dtype(enc, "bfloat16", "cuda", teacher, mp)
    check_card_dtype(enc, "float32", "cpu", teacher, mp)


def test_fp32_on_the_card_takes_the_recipes_trunk():
    """a2v-large's recipes in fp32 pass the check on a CUDA device; their
    tensor-parallel layout and an int8 teacher raise."""
    for run in (RunConfig.finetune_100(), RunConfig.a2v_large_pretrain()):
        run = apply_overrides(run, ["common.compute_dtype=float32"])
        run.check_card_dtype("cuda")
        with pytest.raises(NotImplementedError, match="A.13"):
            dataclasses.replace(run, distributed=DistributedConfig(model_parallel=2)
                                ).check_card_dtype("cuda")
    pre = apply_overrides(RunConfig.a2v_large_pretrain(), ["common.compute_dtype=float32"])
    with pytest.raises(NotImplementedError, match="A.13"):
        dataclasses.replace(pre, pretrain=dataclasses.replace(
            pre.pretrain, teacher_matmul_impl="int8_attn")).check_card_dtype("cuda")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS + (128,))
def test_fp32_attention_kernels_match_plain_on_card(cuda, d):
    """#1 on the projection's thirds, #2 with lse and dropout 0.2, #3 and #4
    at b2 H4 T333, fp32, against the plain versions in fp32 (the slope
    partials against float64) at phase 22k's gates."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, h, t = 2, 4, 333
    qkv_btc = torch.randn((b, t, 3 * h * d), generator=gen, device=cuda)
    sl = torch.from_numpy((alibi_slopes(h) * 0.8).astype(np.float32)).to(cuda)
    p = torch.arange(t, dtype=torch.int32, device=cuda)[None]
    m = torch.zeros((b, t), dtype=torch.bool, device=cuda)
    m[1, -40:] = True
    q, k, v = qkv_btc.reshape(b, t, 3, h, d).unbind(2)
    served = alibi_flash_attention_serve(q, k, v, sl, p, m)
    packed = attention.btc_to_packed(qkv_btc, h)
    assert served.dtype == F32
    _within("#1", served.transpose(1, 2), alibi_attention_plain(packed, sl, p, m), ATTN_TOL)
    out, lse = alibi_flash_attention_packed(packed, sl, p, m, False, RATE, SEED, return_lse=True)
    out_p, lse_p = alibi_attention_plain(packed, sl, p, m, False, RATE, SEED, return_lse=True)
    _within("#2", out, out_p, ATTN_TOL)
    _within("#2 lse", lse, lse_p, LSE_TOL)
    dout = torch.randn((b, h, t, d), generator=gen, device=cuda)
    delta = (dout * out).sum(-1).reshape(b * h, t)
    dq, parts = attention_dq(packed, dout, lse, delta, sl, p, m, False, RATE, SEED)
    dk, dv = attention_dkv(packed, dout, lse, delta, sl, p, m, False, RATE, SEED)
    want, _ = attention_bwd_plain(packed, dout, lse, delta, sl, p, m, False, RATE, SEED)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == F32
        _within(name, got, ref, BWD_TOL)
    _within("slope partials", parts, _partials_fp64(packed, dout, sl, p, m), SLOPE_PART_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("c, m", [(256, 512), (1024, 4096), (1280, 5120)])
def test_fp32_block_matches_plain_on_card(cuda, c, m):
    """#6's fp32 instance with its three dropout sites at N 333 (C 1280:
    the wide LayerNorm) against the plain version in fp32 at BLOCK_TOL;
    the bf16 scratch planes' launch and the drop-path scale too."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    n = 2 * 333
    x = torch.randn((2, 333, c), generator=gen, device=cuda)
    w1 = torch.randn((c, m), generator=gen, device=cuda) * (2 / (c + m)) ** 0.5
    w2 = torch.randn((m, c), generator=gen, device=cuda) * (2 / (c + m)) ** 0.5
    vecs = [torch.randn((size,), generator=gen, device=cuda) * 0.1 + add
            for size, add in ((c, 1), (c, 0), (m, 0), (c, 0), (c, 1), (c, 0))]
    args = (x, vecs[0], vecs[1], w1, w2, vecs[2], vecs[3], vecs[4], vecs[5], 1e-5, (3, -4, 5),
            0.1, 0.1)
    for scale in (None, torch.tensor([0.0, 1.25], device=cuda)):
        with torch.no_grad():
            got = fused_block_mlp(*args, 0, scale)
        want = fused_block_plain(*args, 0, scale)
        for name, a, b in zip(("x_out", "tap"), got, want):
            assert a.dtype == F32 and a.shape == (2, 333, c)
            _within(name, a, b, BLOCK_TOL)
    assert n == x.numel() // c


@pytest.mark.gpu
def test_int8_mlp_refuses_fp32_on_card(cuda):
    """#9's wrapper on a CUDA fp32 x raises, naming ROADMAP A.13."""
    x = torch.zeros((64, 128), device=cuda)
    w_q = torch.zeros((128, 128), dtype=torch.int8, device=cuda)
    w_s = torch.ones(128, device=cuda)
    _raises_a13(lambda: fused_mlp.fused_mlp_int8(x, w_q, w_s, None, w_q, w_s, None))
