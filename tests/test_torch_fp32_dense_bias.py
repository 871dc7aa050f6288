"""The fp32 instances of the fused pre-LN MLP (#8) and of the dense-bias
attention with its backward (#11, #11b): JAX's default compute dtype on the
card for pre-LN trunks, ALiBi-free encoders and the image modality.

Each fp32 product of these kernels is three bf16 products of the operands'
split parts, ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` with ``hi = bf16(x)`` and
``lo = bf16(x - hi)``, summed into one fp32 accumulator (``mm3`` of
``tests/test_torch_fp32_kernels.py``). On the CPU:

* (a) that arithmetic in plain PyTorch against the JAX package in fp32:
  #8's two products (GELU, fc2 + b2 in fp32) against ``fused_mlp``'s Pallas
  ``_kernel_bf16`` interpreted on the CPU; #11's forward with its lse, a
  2-D ALiBi bias and a padded key against ``xla_attention`` at D 64 and 80;
  #11b's dq, dk, dv and dbias against ``jax.vjp`` of ``xla_attention`` with
  the bias as an input, at T 49 (the single launch's T <= 64) and T 81 (dq
  and dk/dv). The tolerances are ``chip_smoke.py`` phase 23k's gates, a
  tenth of each bf16 gate, save dbias's (``test_split_dbias_gate``): dS =
  P (dP - delta) cancels where dP is near delta, and there the split
  products' 2^-17 of dP, times P, outgrows a tenth of the bf16 gate and,
  at a few elements, the bf16 gate itself; so dbias is held at the bf16
  gate for all but DBIAS_FLIP_SHARE of the elements, those within 4x this
  arithmetic's worst ratio to it, and every (b, h) plane within a tenth
  of the bf16 per-head bound in relative norm;
* (b) the wrappers' kernel route on a fake card (``FakeCard`` of
  ``tests/test_torch_head_dim_kernels.py``, the MLP fake of
  ``tests/test_torch_fp32_kernels.py``): fp32 tensors take the ``_f32``
  entries, each launch counter moves by one, the outputs and gradients are
  fp32 and equal the plain versions (also at batch 1, where rowsum(dO * O)
  reshapes to a strided view that the backward must make contiguous);
* (c) the small-width fp32 models of the three families these kernels run
  are held against JAX in fp32 by existing tests, through the plain
  versions the kernel route computes (variants P and N:
  ``test_torch_encoder_options.py::test_variant_logits_match_jax``; the
  pre-LN ViT: ``test_torch_widths.py``, ``test_torch_image_model.py``);
  ``test_torch_fp32_kernels.py``'s ``_LEFT_OUT`` cases hold that their
  configurations pass ``config.check_card_dtype`` in fp32 on a CUDA device.

On the card (``gpu`` marker; this file imports no JAX, flax or other test
module at module level), each fp32 instance against its plain version in
fp32 at small shapes, at phase 23k's gates.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.ops import attention, bias_attention, fused_mlp
from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d
from animal2vec_tpu_torch.ops.bias_attention import (
    DEAD_LSE, NEG_INF, attention_keep, bias_attention_bwd_plain, bias_attention_bwd_single,
    bias_attention_dkv, bias_attention_dq, bias_attention_forward, bias_attention_plain,
    bias_flash_attention,
)
from animal2vec_tpu_torch.ops.dropout import keep_scale
from animal2vec_tpu_torch.ops.fused_mlp import fused_mlp_plain

F32 = torch.float32
SEED = 20261019
RATE = 0.1
# phase 23k's gates (chip_smoke.py), (atol, rtol) against |reference|: a
# tenth of each bf16 gate (ATTN_TOL, LSE_TOL, BWD_TOL, BLOCK_TOL); dbias:
# the bf16 gate DBIAS_TOL (the cap of the rule of 4x) for all but
# DBIAS_FLIP_SHARE of the elements, none beyond DBIAS_FLIP_FACTOR of it (4x
# this arithmetic's worst ratio, 2.127 in test_split_dbias_gate, rounded
# up), every (b, h) plane within DBIAS_REL_HEAD (a tenth of REL_HEAD)
ATTN_TOL = (1e-3, 1e-3)
LSE_TOL = (1e-4, 1e-6)
BWD_TOL = (5e-4, 1e-3)
BLOCK_TOL = (3e-3, 2e-3)
DBIAS_TENTH = (1e-6, 1e-3)
DBIAS_TOL = (1e-5, 1e-2)
DBIAS_FLIP_SHARE, DBIAS_FLIP_FACTOR, DBIAS_REL_HEAD = 1e-5, 9.0, 1e-4
HEAD_DIMS = (64, 80)


def _within(name, got, want, tol):
    """Every element within atol + rtol |want|; returns the worst ratio."""
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    ratio = (err / (atol + rtol * want.float().abs())).max().item()
    assert torch.isfinite(got).all(), name
    assert ratio <= 1.0, f"{name}: worst ratio {ratio:.3f}"
    return ratio


# ---------------------------------------------------------------------------
# the kernels' fp32 arithmetic in plain PyTorch
# ---------------------------------------------------------------------------


def _mm3(a, b):
    """``mm3`` of ``tests/test_torch_fp32_kernels.py``, imported at the call
    (the card's runs collect this file for its ``gpu`` tests alone)."""
    from tests.test_torch_fp32_kernels import mm3

    return mm3(a, b)


def emulated_forward(q, k, v, bias=None, mask=None, keep=None, rate=0.0):
    """#11's fp32 instance on (B, T, H, D) q, k, v: S by ``mm3``, scaled
    after the sum, then the fp32 bias; padded keys -1e10; the scalar pass in
    fp32; P f's split parts against V's. Returns out (B, T, H, D) and lse
    (B*H, T)."""
    b, t, h, d = q.shape
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))
    s = _mm3(qh, kh.transpose(-1, -2)) * d**-0.5
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(mask[:, None, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(-1, keepdim=True)
    if keep is not None:
        p = p * keep * keep_scale(rate)
    out = _mm3(p, vh) * (1.0 / l_sum)
    return out.transpose(1, 2), (m + torch.log(l_sum)).reshape(b * h, t)


def emulated_backward(q, k, v, dout, lse, delta, bias=None, mask=None, keep=None, rate=0.0):
    """#11b's fp32 instances on their inputs (the forward's lse, delta =
    rowsum(dO * O)): S and dP by ``mm3``, P = exp(s - lse) (0 at padded
    keys and in rows whose keys are all padded, where P f takes 1/T), dS =
    P (dP f - delta) in fp32, dq, dk, dv by ``mm3``. Returns dq, dk, dv (B,
    T, H, D) and dbias = dS (B, H, T, T)."""
    b, t, h, d = q.shape
    scale = d**-0.5
    qh, kh, vh, gh = (x.transpose(1, 2).float() for x in (q, k, v, dout))
    s = _mm3(qh, kh.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    lse = lse.reshape(b, h, t, 1)
    dead = lse < DEAD_LSE
    padded = torch.zeros((b, 1, 1, t), dtype=torch.bool)
    if mask is not None:
        padded = mask[:, None, None, :]
    p = torch.exp(s - lse).masked_fill(dead | padded, 0.0)
    p_v = torch.where(dead & padded, 1.0 / t, p)
    dp = _mm3(gh, vh.transpose(-1, -2))
    if keep is not None:
        f = keep * keep_scale(rate)
        p_v, dp = p_v * f, dp * f
    ds = p * (dp - delta.reshape(b, h, t, 1))
    dq = scale * _mm3(ds, kh)
    dk = scale * _mm3(ds.transpose(-1, -2), qh)
    dv = _mm3(p_v.transpose(-1, -2), gh)
    return (*(x.transpose(1, 2) for x in (dq, dk, dv)), ds)


def emulated_mlp(x, w1, w2, b1=None, b2=None, seeds=None, rate=0.0):
    """#8's fp32 instance: the plain version's math with ``mm3`` as its two
    products (h kept in fp32 between them); w1 (M, C), w2 (C2, M)."""
    return fused_mlp._mlp_math(x, w1, w2, b1, b2, seeds, rate, 0, _mm3)


def _attention_case(b, t, h, d, seed):
    """fp32 (B, T, H, D) q, k, v and a cotangent, the per-row (B, H, T, T)
    bias of the 2-D ALiBi grid with a seeded jitter, and a key mask padding
    row 1's last 7 keys, from numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(4))
    bias = (alibi_bias_2d(t, h)[None] + rng.normal(size=(b, h, t, t)) * 0.1).astype(np.float32)
    mask = np.zeros((b, t), bool)
    mask[1, -7:] = True
    return q, k, v, g, bias, mask


# ---------------------------------------------------------------------------
# (a) the split arithmetic against the JAX package in fp32
# ---------------------------------------------------------------------------


def test_split_mlp_matches_jax_kernel():
    """#8's fp32 arithmetic (C 128, M 512, C2 256; 140 rows) against JAX's
    ``fused_mlp`` on fp32 input, ``_kernel_bf16`` interpreted on the CPU:
    within BLOCK_TOL."""
    import jax.numpy as jnp
    from animal2vec_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp

    rng = np.random.default_rng(SEED)
    n, c, m, c2 = 140, 128, 512, 256
    x = rng.normal(size=(n, c)).astype(np.float32)
    w1 = (rng.normal(size=(m, c)) * (2 / (c + m)) ** 0.5).astype(np.float32)
    w2 = (rng.normal(size=(c2, m)) * (2 / (c2 + m)) ** 0.5).astype(np.float32)
    b1, b2 = (rng.normal(size=s).astype(np.float32) * 0.1 for s in (m, c2))
    ours = emulated_mlp(*map(torch.from_numpy, (x, w1, w2, b1, b2)))
    ref = jax_fused_mlp(jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(w2.T), jnp.asarray(b1),
                        jnp.asarray(b2), block_n=64, block_m=256)
    assert ours.dtype == F32 and ours.shape == (n, c2)
    _within("out", ours, torch.from_numpy(np.asarray(ref)), BLOCK_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_split_attention_forward_matches_xla_attention(d):
    """#11's fp32 arithmetic at B 2, H 2, T 81 (a 9 x 9 grid's 2-D ALiBi
    bias with a per-row jitter, row 1's last keys padded) against
    ``xla_attention`` in fp32: out within ATTN_TOL, lse (JAX's logsumexp
    of the same logits) within LSE_TOL."""
    import jax
    import jax.numpy as jnp
    from animal2vec_tpu.models.attention import NEG_INF as JAX_NEG_INF
    from animal2vec_tpu.models.attention import xla_attention

    q, k, v, _, bias, mask = _attention_case(2, 81, 2, d, SEED + d)
    out, lse = emulated_forward(*map(torch.from_numpy, (q, k, v, bias, mask)))
    jq, jk, jv, jb, jm = map(jnp.asarray, (q, k, v, bias, mask))
    ref = xla_attention(jq, jk, jv, jb, jm)
    logits = jnp.einsum("bqhd,bkhd->bhqk", jq * d**-0.5, jk) + jb
    logits = jnp.where(jm[:, None, None, :], JAX_NEG_INF, logits)
    ref_lse = jax.nn.logsumexp(logits, axis=-1).reshape(-1, 81)
    _within("out", out, torch.from_numpy(np.asarray(ref)), ATTN_TOL)
    _within("lse", lse, torch.from_numpy(np.asarray(ref_lse)), LSE_TOL)


@pytest.mark.parametrize("t", [49, 81])
def test_split_backward_matches_jax_vjp(t):
    """#11b's fp32 arithmetic (on the emulated forward's lse and delta) at B
    2, H 2, D 64 with the per-row bias and row 1's last keys padded, at T 49
    (the single launch's) and T 81 (dq and dk/dv's), against ``jax.vjp`` of
    ``xla_attention`` in fp32 with the bias as an input: dq, dk, dv within
    BWD_TOL, dbias within DBIAS_TOL."""
    import jax
    import jax.numpy as jnp
    from animal2vec_tpu.models.attention import xla_attention

    q, k, v, g, bias, mask = _attention_case(2, t, 2, 64, SEED + t)
    tq, tk, tv, tg, tb, tm = map(torch.from_numpy, (q, k, v, g, bias, mask))
    out, lse = emulated_forward(tq, tk, tv, tb, tm)
    delta = (tg * out).sum(-1).transpose(1, 2).reshape(-1, t)
    got = emulated_backward(tq, tk, tv, tg, lse, delta, tb, tm)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b_, c, bb: xla_attention(a, b_, c, bb, jm),
                     *map(jnp.asarray, (q, k, v, bias)))
    want = [torch.from_numpy(np.asarray(x)) for x in vjp(jnp.asarray(g))]
    for name, a, b_ in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        _within(name, a, b_, BWD_TOL)
    _within("dbias", got[3], want[3], DBIAS_TOL)


def test_split_dbias_gate():
    """dbias's gate by the rule of 4x: this arithmetic's dS against the
    plain version's in fp32 at the card's single-launch shape (the ViT-B/16
    student's H 12 T 59, per-row keep-set bias, dropout 0.1; 4 of its 128
    rows: the error is per element) lies past a tenth of the bf16 gate, and
    at one element of 167 088 past the bf16 gate itself (2.127 of it; at all
    128 rows of another draw 1 of 5 346 816, 1.069), where P is 0.58 and dS
    -8.8e-4: dP - delta cancels. The gate (dbias_within): DBIAS_TOL, the
    bf16 gate, for all but DBIAS_FLIP_SHARE of the elements, none beyond
    DBIAS_FLIP_FACTOR >= 4x the worst ratio, and every (b, h) plane within
    DBIAS_REL_HEAD relative norm. dq, dk and dv there within BWD_TOL."""
    rng = np.random.default_rng(SEED + 59)
    b, h, t, d = 4, 12, 59, 64
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
                  for _ in range(4))
    ids = np.stack([np.sort(rng.choice(196, t, replace=False)) for _ in range(b)])
    grid = torch.from_numpy(alibi_bias_2d(196, h))
    bias = torch.stack([grid[:, i][:, :, i] for i in ids]) * 0.7
    keep = attention_keep(b, h, t, RATE, SEED)
    worst, dbias = 0.0, []
    for rows in (slice(0, 2), slice(2, 4)):
        args = (q[rows], k[rows], v[rows])
        out, lse = bias_attention_plain(*args, bias[rows], None, True, keep[rows], RATE)
        delta = (g[rows] * out).sum(-1).transpose(1, 2).reshape(-1, t)
        got = emulated_backward(*args, g[rows], lse, delta, bias[rows], None, keep[rows], RATE)
        want = bias_attention_bwd_plain(*args, g[rows], lse, delta, bias[rows], None, keep[rows],
                                        RATE)
        for name, a, b_ in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            _within(name, a, b_, BWD_TOL)
        err = (got[3] - want[3]).abs()
        worst = max(worst, (err / (DBIAS_TENTH[0] + DBIAS_TENTH[1] * want[3].abs())).max().item())
        dbias.append((got[3], want[3]))
    dbias_within("dbias", *(torch.cat(x) for x in zip(*dbias)))
    assert worst > 1.0  # a tenth of the bf16 gate does not hold
    assert DBIAS_TOL == pytest.approx(tuple(10 * x for x in DBIAS_TENTH))
    assert 4 * worst / 10 <= DBIAS_FLIP_FACTOR, worst


def dbias_within(name, got, want):
    """dbias's gate: DBIAS_TOL for all but DBIAS_FLIP_SHARE of the elements,
    none beyond DBIAS_FLIP_FACTOR of it; every (b, h) plane within
    DBIAS_REL_HEAD relative norm (planes of norm below 1e-3 count as
    1e-3)."""
    atol, rtol = DBIAS_TOL
    ratio = (got - want).abs() / (atol + rtol * want.abs())
    assert torch.isfinite(got).all(), name
    assert ratio.max().item() <= DBIAS_FLIP_FACTOR, f"{name}: {ratio.max().item():.3f}"
    assert (ratio > 1).sum().item() <= DBIAS_FLIP_SHARE * ratio.numel(), name
    rel = (got - want).flatten(2).norm(dim=-1) / want.flatten(2).norm(dim=-1).clamp_min(1e-3)
    assert rel.max().item() <= DBIAS_REL_HEAD, f"{name}: per-plane {rel.max().item():.3e}"


# ---------------------------------------------------------------------------
# (b) the kernel route on a fake card
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the dense-bias wrappers' kernel route, whose C
    entries ``FakeCard`` runs; the MLP's entry is ``FakeBlockCard``'s.
    ``called`` lists the attention entries in launch order."""
    from tests.test_torch_fp32_kernels import FakeBlockCard
    from tests.test_torch_head_dim_kernels import FakeCard

    card, mlp = FakeCard(), FakeBlockCard()
    called = []
    for name in ("a2v_bias_attention", "a2v_bias_attention_bwd_dq", "a2v_bias_attention_bwd_dkv",
                 "a2v_bias_attention_bwd_single"):
        entry = name + "_f32"  # (each calls its bf16 twin's fake with fp32 views)
        fn = getattr(card, entry)
        setattr(card, entry, lambda *a, _fn=fn, _n=entry: called.append(_n) or _fn(*a))
    for module in (attention, bias_attention):
        monkeypatch.setattr(module, "_on_cpu", lambda x: False)
        monkeypatch.setattr(module, "_check_device", lambda x, what: None)
    monkeypatch.setattr(attention, "library", lambda: card)
    monkeypatch.setattr(fused_mlp, "library", lambda: mlp)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return types.SimpleNamespace(called=called, mlp=mlp)


def _close32(got, want):
    assert got.dtype == F32 and got.shape == want.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b, t", [(2, 81), (2, 49), (1, 81)])
def test_fp32_attention_takes_the_fp32_entries(fake_card, b, t):
    """The autograd entry on fp32 views of one (B, T, 3, H, D) projection
    with a per-row bias that requires grad and a key mask: the forward
    through ``a2v_bias_attention_f32``, the backward through the dq and
    dk/dv ``_f32`` entries (T 81) or the single launch's (T 49), each
    counter up by one; out, dqkv and dbias fp32 and equal to autograd of
    the plain version, at B 1 too (delta contiguous there)."""
    q, k, v, g, bias, mask = _attention_case(2, t, 2, 64, SEED + 7 * t)
    qkv = torch.from_numpy(np.stack((q, k, v), axis=2)[:b]).requires_grad_()
    tb = torch.from_numpy(bias[:b]).requires_grad_()
    tm, tg = torch.from_numpy(mask[:b]), torch.from_numpy(g[:b])
    counters = (bias_flash_attention, bias_attention_dq, bias_attention_dkv,
                bias_attention_bwd_single)
    before = [f.launches for f in counters]
    out = bias_flash_attention(*qkv.unbind(2), tb, tm)
    grads = torch.autograd.grad(out, (qkv, tb), tg)
    pair = t > 64
    assert [f.launches - n for f, n in zip(counters, before)] == [1, pair, pair, not pair]
    assert fake_card.called == ["a2v_bias_attention_f32"] + (
        ["a2v_bias_attention_bwd_dq_f32", "a2v_bias_attention_bwd_dkv_f32"] if pair
        else ["a2v_bias_attention_bwd_single_f32"])
    leaves = (qkv.detach().clone().requires_grad_(), tb.detach().clone().requires_grad_())
    out_p = bias_attention_plain(*leaves[0].unbind(2), leaves[1], tm)
    _close32(out, out_p)
    for got, want in zip(grads, torch.autograd.grad(out_p, leaves, tg)):
        _close32(got, want)


def test_backward_at_batch_one_reaches_the_kernels(fake_card):
    """ROADMAP C's repair: at batch 1 rowsum(dO * O) reshapes to a strided
    view, which the kernels' argument checks refuse; the autograd
    Function's backward on bf16 operands hands them a contiguous delta, and
    dqkv and dbias equal autograd of the plain version within bf16
    rounding."""
    q, k, v, g, bias, _ = _attention_case(2, 81, 2, 64, SEED + 1)
    qkv = torch.from_numpy(np.stack((q, k, v), axis=2)[:1]).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(bias[:1]).requires_grad_()
    tg = torch.from_numpy(g[:1]).to(torch.bfloat16)
    before = bias_attention_dq.launches
    grads = torch.autograd.grad(bias_flash_attention(*qkv.unbind(2), tb), (qkv, tb), tg)
    assert bias_attention_dq.launches == before + 1
    leaves = (qkv.detach().float().requires_grad_(), tb.detach().clone().requires_grad_())
    want = torch.autograd.grad(bias_attention_plain(*leaves[0].unbind(2), leaves[1]), leaves,
                               tg.float())
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2)


def test_fp32_attention_dropout_reaches_the_fp32_entries(fake_card):
    """The forward with lse and dropout 0.1 on fp32 operands hands the
    ``_f32`` entry the hash dropout's seed, threshold and keep scale (the
    fake card checks them against the plain version's mask: the C entry
    draws the same one), and the backward entries the same."""
    q, k, v, g, bias, _ = _attention_case(2, 49, 2, 64, SEED + 3)
    tq, tk, tv, tg, tb = map(torch.from_numpy, (q, k, v, g, bias))
    seen = []
    card = attention.library()
    for name in ("a2v_bias_attention_f32", "a2v_bias_attention_bwd_single_f32"):
        setattr(card, name, lambda *a, _n=name: seen.append((_n, a[-4:-1])) or 0)
    out, lse = bias_attention_forward(tq, tk, tv, tb, None, True, RATE, SEED)
    assert out.dtype == F32 and lse.dtype == F32
    delta = torch.zeros((4, 49))
    bias_attention_bwd_single(tq, tk, tv, tg, lse, delta, tb, rate=RATE, seed=SEED)
    drop = bias_attention._drop_args(RATE, SEED)
    assert seen == [("a2v_bias_attention_f32", drop), ("a2v_bias_attention_bwd_single_f32", drop)]
    assert drop[1] != 0 and drop[2] == pytest.approx(1 / (1 - RATE))


def test_fp32_mlp_takes_the_fp32_entry(fake_card):
    """#8 on fp32 operands (C 128, M 512, C2 256): the launch takes
    ``a2v_fused_mlp_f32`` once with its four scratch planes, fp32 out equal
    to the plain version; the autograd Function's forward takes it too and
    its backward recomputes in fp32 (no bf16 halves of the fp32 cotangent)
    against autograd of the plain version."""
    rng = np.random.default_rng(SEED + 8)
    n, c, m, c2 = 70, 128, 512, 256
    make = lambda *s: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))  # noqa
    x, w1, w2, b1, b2 = make(2, n, c), make(m, c), make(c2, m), make(m), make(c2)
    before = fused_mlp.fused_mlp.launches
    _close32(fused_mlp._launch_mlp(x, w1, w2, b1, b2), fused_mlp_plain(x, w1, w2, b1, b2))
    assert fake_card.mlp.mlp_calls == 1 and fused_mlp.fused_mlp.launches == before + 1
    leaves = [t.clone().requires_grad_() for t in (x, w1, w2, b1, b2)]
    out = fused_mlp._FusedMlp.apply(*leaves, None, 0.0, 0)
    assert fake_card.mlp.mlp_calls == 2 and out.dtype == F32
    cot = make(2, n, c2)
    halves = []
    real = fused_mlp._halves
    fused_mlp._halves = lambda *a: halves.append(a) or real(*a)
    try:
        grads = torch.autograd.grad(out, leaves, cot)
    finally:
        fused_mlp._halves = real
    assert not halves
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    for got, want in zip(grads, torch.autograd.grad(fused_mlp_plain(*plain), plain, cot)):
        _close32(got, want)


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c, m, c2", [(768, 3072, 768), (1024, 4096, 1024), (256, 1024, 128)])
def test_fp32_mlp_matches_plain_on_card(cuda, c, m, c2):
    """#8's fp32 instance at N 666 (C2 128: an output narrower than C) with
    and without its two dropout sites at 0.1 against the plain version in
    fp32 at BLOCK_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(c + c2)
    x = torch.randn((2, 333, c), generator=gen, device=cuda)
    w1 = torch.randn((m, c), generator=gen, device=cuda) * (2 / (c + m)) ** 0.5
    w2 = torch.randn((c2, m), generator=gen, device=cuda) * (2 / (c2 + m)) ** 0.5
    b1 = torch.randn((m,), generator=gen, device=cuda) * 0.1
    b2 = torch.randn((c2,), generator=gen, device=cuda) * 0.1
    for drop in ((), ((5, -6), RATE)):
        with torch.no_grad():
            got = fused_mlp.fused_mlp(x, w1, w2, b1, b2, *drop)
        assert got.dtype == F32 and got.shape == (2, 333, c2)
        _within(f"#8 {drop}", got, fused_mlp_plain(x, w1, w2, b1, b2, *drop), BLOCK_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS + (128,))
def test_fp32_bias_attention_matches_plain_on_card(cuda, d):
    """#11 at b2 H4 T196 (2-D ALiBi, uniform; row 1's last keys padded) and
    at T 59 per-row with lse and dropout 0.1; #11b's dq, dk/dv at T 196 and
    its single launch at T 59 with the same dropout, fp32, against the plain
    versions in fp32 at phase 23k's gates."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    h = 4
    for t, per_row, rate in ((196, False, 0.0), (59, True, RATE)):
        b = 2
        q, k, v = torch.randn((b, t, 3, h, d), generator=gen, device=cuda).unbind(2)
        grid = torch.from_numpy(alibi_bias_2d(196, h)).to(cuda)
        bias = (grid[None, :, :t, :t] + 0.1 * torch.randn((b, h, t, t), generator=gen,
                                                          device=cuda)) if per_row \
            else grid[None]
        mask = torch.zeros((b, t), dtype=torch.bool, device=cuda)
        mask[1, -9:] = True
        keep = attention_keep(b, h, t, rate, SEED, cuda) if rate else None
        out, lse = bias_attention_forward(q, k, v, bias, mask, True, rate, SEED)
        out_p, lse_p = bias_attention_plain(q, k, v, bias, mask, True, keep, rate)
        assert out.dtype == F32
        _within(f"#11 T {t} out", out, out_p, ATTN_TOL)
        _within(f"#11 T {t} lse", lse, lse_p, LSE_TOL)
        dout = torch.randn((b, t, h, d), generator=gen, device=cuda)
        delta = (dout * out).sum(-1).transpose(1, 2).reshape(b * h, t).contiguous()
        args = (q, k, v, dout, lse, delta, bias, mask)
        want = bias_attention_bwd_plain(*args, keep, rate)
        if t <= 64:
            got = bias_attention_bwd_single(*args, rate=rate, seed=SEED)
        else:
            dq, dbias = bias_attention_dq(*args, rate=rate, seed=SEED)
            got = (dq, *bias_attention_dkv(*args, rate=rate, seed=SEED), dbias)
        for name, a, b_ in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            assert a.dtype == F32
            _within(f"#11b T {t} {name}", a, b_, BWD_TOL)
        dbias_within(f"#11b T {t} dbias", got[3], want[3])
