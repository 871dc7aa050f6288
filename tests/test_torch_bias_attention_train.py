"""The training arm of the port's dense-bias attention against the JAX
package: the plain version of the backward kernels (#11b,
``bias_attention_bwd_plain``) and autograd through the model's entry
(``bias_flash_attention``, the plain version on the CPU) against
``jax.grad`` of ``xla_attention``, the function the port computes: dq, dk,
dv and dbias; and against the backward of jax's stock TPU flash kernel
(``flash_attention_tpu``, TPU interpret mode), which differentiates
softmax((q.k + bias) * D^-0.5): the port given bias * D^-0.5 has its dq,
dk, dv and D^-0.5 times its bias gradient.

The bias cases: per-row (B, H, T, T), as a pretraining student's keep-set
bias; batch-uniform (1, H, T, T), whose gradient is the batch sum (the
transpose of the broadcast); none. With a key mask whose last row masks
every key (that row's gradients are 0 but for dv, which gets 1/T of every
row's dO). Tolerance 1e-5 max-abs in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.models.attention import flash_attention_tpu, xla_attention

from animal2vec_tpu_torch.models.attention import multihead_attention
from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d
from animal2vec_tpu_torch.ops.bias_attention import (
    attention_keep, bias_attention_bwd_plain, bias_attention_bwd_single, bias_attention_dkv,
    bias_attention_dq, bias_attention_forward, bias_attention_plain, bias_flash_attention,
)
from animal2vec_tpu_torch.ops.dropout import dropout_keep

TOL = 1e-5


def _inputs(b, t, h, bias, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(b, t, h, 64)).astype(np.float32) for _ in range(4))
    dense = None
    if bias == "uniform":
        dense = alibi_bias_2d(t, h)[None] * np.float32(0.7)
    elif bias == "per-row":
        dense = rng.normal(size=(b, h, t, t)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((b, t), bool)
        mask[0, -7:] = True
        mask[-1] = True
    return q, k, v, dout, dense, mask


def _jax_grads(q, k, v, dout, dense, mask):
    b, _, h, _ = q.shape
    t = q.shape[1]
    args = [jnp.asarray(a) for a in (q, k, v)]
    if dense is not None:
        args.append(jnp.asarray(dense))
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v, bias=None):
        if bias is not None:
            bias = jnp.broadcast_to(bias, (b, h, t, t))
        return jnp.sum(xla_attention(q, k, v, bias, m) * jnp.asarray(dout))

    return [np.asarray(g) for g in jax.grad(f, argnums=tuple(range(len(args))))(*args)]


CASES = [(bias, masked) for bias in ("per-row", "uniform", None) for masked in (False, True)]


@pytest.mark.parametrize("bias,masked", CASES)
def test_backward_plain_matches_jax_grad_of_xla_attention(bias, masked):
    q, k, v, dout, dense, mask = _inputs(3, 49, 2, bias, masked, seed=50)
    want = _jax_grads(q, k, v, dout, dense, mask)
    t_ = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    qt, kt, vt, dt, bt, mt = map(t_, (q, k, v, dout, dense, mask))
    out, lse = bias_attention_forward(qt, kt, vt, bt, mt, with_lse=True)
    b, t, h, _ = q.shape
    delta = (dt * out).sum(-1).transpose(1, 2).reshape(b * h, t)
    args = (qt, kt, vt, dt, lse, delta, bt, mt)
    dq, dk, dv, ds = bias_attention_bwd_plain(*args)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL, err_msg=name)
    # the CPU entries of the two kernels are this plain version
    dq2, ds2 = bias_attention_dq(*args)
    dk2, dv2 = bias_attention_dkv(*args)
    assert all(torch.equal(a, c) for a, c in ((dq, dq2), (dk, dk2), (dv, dv2)))
    if dense is None:
        assert ds2 is None
        return
    assert torch.equal(ds, ds2) and ds.shape == (b, h, t, t)
    dbias = ds.sum(0, keepdim=True) if bias == "uniform" else ds
    np.testing.assert_allclose(dbias.numpy(), want[3], rtol=0, atol=TOL, err_msg="dbias")
    if masked:  # padded keys get no bias gradient; a fully masked row none at all
        assert not ds[:, :, :, -7:][0].any() and not ds[-1].any()


@pytest.mark.parametrize("bias,masked", CASES)
def test_single_launch_cpu_entry_is_the_plain_version(bias, masked):
    """The single backward launch's entry (T <= 64) on CPU tensors returns
    the plain version's dq, dk, dv and, with a bias, its dbias (else None),
    bit for bit."""
    q, k, v, dout, dense, mask = _inputs(2, 49, 2, bias, masked, seed=52)
    t_ = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    qt, kt, vt, dt, bt, mt = map(t_, (q, k, v, dout, dense, mask))
    out, lse = bias_attention_forward(qt, kt, vt, bt, mt, with_lse=True)
    b, t, h, _ = q.shape
    delta = (dt * out).sum(-1).transpose(1, 2).reshape(b * h, t)
    args = (qt, kt, vt, dt, lse, delta, bt, mt)
    want = bias_attention_bwd_plain(*args)
    got = bias_attention_bwd_single(*args)
    assert all(torch.equal(a, c) for a, c in zip(got[:3], want[:3]))
    assert (got[3] is None) if dense is None else torch.equal(got[3], want[3])
    assert bias_attention_bwd_single(*args, want_dbias=False)[3] is None


@pytest.mark.parametrize("bias,masked", CASES)
def test_autograd_entry_matches_jax_grad_of_xla_attention(bias, masked):
    """The model's entry on the q, k, v views of one (B, T, 3C) projection
    (``multihead_attention``), the bias a leaf requiring grad in its own
    shape."""
    q, k, v, dout, dense, mask = _inputs(2, 36, 2, bias, masked, seed=51)
    want = _jax_grads(q, k, v, dout, dense, mask)
    b, t, h, d = q.shape
    qkv = torch.from_numpy(np.stack((q, k, v), axis=2).reshape(b, t, 3 * h * d))
    qkv.requires_grad_()
    leaves = [qkv]
    bt = None
    if dense is not None:
        bt = torch.from_numpy(dense).requires_grad_()
        leaves.append(bt)
    out = multihead_attention(qkv, h, bt, None if mask is None else torch.from_numpy(mask))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout).reshape(b, t, h * d))
    dqkv = grads[0].reshape(b, t, 3, h, d)
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(dqkv[:, :, i].numpy(), want[i], rtol=0, atol=TOL,
                                   err_msg=name)
    if dense is not None:
        assert grads[1].shape == bt.shape
        np.testing.assert_allclose(grads[1].numpy(), want[3], rtol=0, atol=TOL)


@pytest.mark.parametrize("bias", ["per-row", "uniform"])
def test_stock_tpu_kernel_backward_given_scaled_bias(bias):
    """jax's stock flash kernel's backward (dq and dk/dv kernels, dq
    emitting ds) in TPU interpret mode, at T 256 (two of its 128-key blocks,
    a 16 x 16 patch grid), against the port given bias * D^-0.5: the same
    dq, dk, dv, and the stock bias gradient D^-0.5 times the port's."""
    from jax.experimental.pallas import tpu as pltpu

    b, t, h = 1, 256, 2
    q, k, v, dout, dense, _ = _inputs(b, t, h, bias, False, seed=52)
    dense = np.broadcast_to(dense, (b, h, t, t)).copy()
    scale = np.float32(64**-0.5)

    def f(q, k, v, ab):
        return jnp.sum(flash_attention_tpu(q, k, v, ab) * jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        stock = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, dense)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, dense * scale)]
    ours = torch.autograd.grad(bias_flash_attention(*leaves), leaves, torch.from_numpy(dout))
    for name, got, ref in zip(("dq", "dk", "dv"), ours[:3], stock[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_allclose(ours[3].numpy() * scale, np.asarray(stock[3]), rtol=0, atol=TOL)


def test_dense_bias_attention_dropout_still_raises():
    """Attention dropout with a dense bias no longer raises: the model's
    entry at rate 0.1 is the plain twin under the kernels' hash mask
    (``attention_keep``), forward and backward, and the mask keeps 1 - rate
    of the weights."""
    b, t, h, rate, seed = 2, 40, 2, 0.1, 77
    q, k, v, dout, dense, _ = _inputs(b, t, h, "per-row", False, seed=53)
    qkv = torch.from_numpy(np.stack((q, k, v), axis=2).reshape(b, t, 3 * h * 64))
    qkv.requires_grad_()
    bt = torch.from_numpy(dense).requires_grad_()
    out = multihead_attention(qkv, h, bt, None, rate, seed)
    got = torch.autograd.grad(out, (qkv, bt), torch.from_numpy(dout).reshape(b, t, h * 64))
    keep = attention_keep(b, h, t, rate, seed)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, dense)]
    want_out = bias_attention_plain(*leaves[:3], leaves[3], None, False, keep, rate)
    want = torch.autograd.grad(want_out, leaves, torch.from_numpy(dout))
    assert torch.equal(out.reshape(b, t, h, 64), want_out.detach())
    assert torch.equal(got[0].reshape(b, t, 3, h, 64), torch.stack(want[:3], dim=2))
    assert torch.equal(got[1], want[3])
    assert abs(keep.mean().item() - (1 - rate)) < 0.01


def _jax_mask(b, h, t, rate, seed):
    """JAX's own dropout mask: the bernoulli draw ``xla_attention`` makes
    with the rng it is given."""
    rng = jax.random.PRNGKey(seed)
    return rng, np.asarray(jax.random.bernoulli(rng, 1.0 - rate, (b, h, t, t)))


@pytest.mark.parametrize("bias,masked", [("per-row", False), ("uniform", True), (None, False)])
def test_dropout_twin_matches_xla_attention_under_jax_mask(bias, masked):
    """The plain twin given JAX's own bernoulli mask against
    ``xla_attention`` with that rng at rate 0.1: the forward and the
    gradients (dq, dk, dv, dbias through ``jax.vjp``); the backward plain
    version of the kernels (on the forward's lse and delta) gives the same
    gradients. Tolerance 1e-5 max-abs in fp32."""
    b, t, h, rate = 2, 36, 2, 0.1
    q, k, v, dout, dense, mask = _inputs(b, t, h, bias, masked, seed=54)
    rng, keep_np = _jax_mask(b, h, t, rate, 5)
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v, bias=None):
        if bias is not None:
            bias = jnp.broadcast_to(bias, (b, h, t, t))
        return xla_attention(q, k, v, bias, m, rate, rng)

    args = [jnp.asarray(a) for a in (q, k, v)] + ([] if dense is None else [jnp.asarray(dense)])
    out_j, vjp = jax.vjp(f, *args)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    keep = torch.from_numpy(keep_np.copy())
    t_ = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    bt = None if dense is None else torch.from_numpy(dense).requires_grad_()
    out = bias_attention_plain(*leaves, bt, t_(mask), False, keep, rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=TOL)
    grads = torch.autograd.grad(out, leaves + ([] if bt is None else [bt]), t_(dout))
    for name, got, ref in zip(("dq", "dk", "dv", "dbias"), grads, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL, err_msg=name)
    # the backward kernels' plain version on the forward's lse and delta
    with torch.no_grad():
        qt, kt, vt, dt = map(t_, (q, k, v, dout))
        out2, lse = bias_attention_plain(qt, kt, vt, t_(dense), t_(mask), True, keep, rate)
        delta = (dt * out2).sum(-1).transpose(1, 2).reshape(b * h, t)
        dq, dk, dv, ds = bias_attention_bwd_plain(qt, kt, vt, dt, lse, delta, t_(dense),
                                                  t_(mask), keep, rate)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL, err_msg=name)
    if dense is not None:
        dbias = ds.sum(0, keepdim=True) if bias == "uniform" else ds
        np.testing.assert_allclose(dbias.numpy(), want[3], rtol=0, atol=TOL, err_msg="dbias")


def test_attention_keep_is_the_alibi_kernels_hash():
    """The dense-bias kernels' mask is the hash #2 uses (``dropout_keep`` at
    (seed + (b*H + h) * 0xC2B2AE3D, query, key)); the CPU entries draw it
    from the seed, the keep rate is 1 - rate, and rate 0 is no dropout."""
    b, h, t, rate, seed = 3, 4, 50, 0.1, -1234567
    keep = attention_keep(b, h, t, rate, seed)
    bh = torch.arange(b * h).reshape(b, h, 1, 1)
    idx = torch.arange(t)
    assert torch.equal(keep, dropout_keep(seed, bh, idx[:, None], idx[None, :], rate))
    assert abs(keep.mean().item() - 0.9) < 0.01
    q, k, v, dout, dense, _ = _inputs(b, t, h, "per-row", False, seed=55)
    qt, kt, vt, bt = map(torch.from_numpy, (q, k, v, dense))
    got = bias_attention_forward(qt, kt, vt, bt, None, True, rate, seed)
    want = bias_attention_plain(qt, kt, vt, bt, None, True, keep, rate)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(bias_attention_forward(qt, kt, vt, bt, None, False, 0.0, None),
                       bias_attention_plain(qt, kt, vt, bt))
