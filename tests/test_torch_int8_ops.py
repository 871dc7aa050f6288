"""The port's int8 serving ops against the JAX package's.

On the CPU the port's ops run their plain versions, which accumulate the
int8 products exactly in float64; the JAX side runs its Pallas kernels in
interpret mode (``int8_dense``, the int8 arm of ``fused_block_mlp``,
``alibi_flash_attention_int8``). Inputs come from numpy seeds.

Tolerances. The quantizers are bit-exact. In fp32 the rest agrees to
about 1e-6, except where one side's transcendental lands a value on the
other side of an int8 rounding boundary: the JAX kernels take the A&S erf
in GELU (1.5e-7 from erf) and XLA's exp, the port erf and torch's exp. One
such flip moves a whole output row by up to one quantization step of the
next product: for the block, an h step times a w2 column, ~1e-3; for the
attention, one 1/127 step of P times the largest |v|, ~3e-2 at unit-normal
inputs. So each test bounds the largest error by that step, and the share
of rows that differ beyond 1e-5 by 5 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.ops.fused_mlp import fused_block_mlp as jax_fused_block_mlp
from animal2vec_tpu.ops.int8_mm import int8_dense as jax_int8_dense
from animal2vec_tpu.ops.int8_mm import quantize_weight as jax_quantize_weight
from animal2vec_tpu.ops.pallas_attention import alibi_flash_attention_int8 as jax_attention_int8

from animal2vec_tpu_torch.ops.alibi import alibi_slopes
from animal2vec_tpu_torch.ops.attention import (
    alibi_attention_int8_plain, alibi_flash_attention_int8, int8_spans, quantize_qkv_int8,
    quantize_qkv_int8_pass, quantize_qkv_int8_pass_plain, v8t_key_order,
)
from animal2vec_tpu_torch.ops.fused_mlp import (
    fused_block_int8, fused_block_int8_plain, hidden_chunk, quantize_chunks_plain,
)
from animal2vec_tpu_torch.ops.int8_mm import (
    int8_dense, int8_dense_plain, quantize_rows, quantize_weight,
)

FP32_TOL = 1e-5
ROWS_OFF = 0.05  # share of output rows allowed beyond FP32_TOL (rounding flips)


def _rows_off(ours, ref, tol=FP32_TOL):
    err = np.abs(np.asarray(ours, np.float32) - np.asarray(ref, np.float32))
    return (err.reshape(-1, err.shape[-1]) > tol).any(axis=-1).mean(), err.max()


def _rnd(rng, *shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


# the JAX quantizers as the reference writes them (int8_mm.py:53-57 weights,
# :76-78 rows of x, pallas_attention.py:816-831 q, k, v), under jit as the
# model runs them: XLA then multiplies by fp32(1/127) where the code divides
# by 127
@jax.jit
def _jax_rows(x):
    s = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0, 1e-12)
    return jnp.round(x / s).astype(jnp.int8), s[..., 0]


@jax.jit
def _jax_qkv(q, k, v):
    d = q.shape[-1]
    q8, qs = _jax_rows(q.astype(jnp.float32) * d**-0.5)
    k8, ks = _jax_rows(k.astype(jnp.float32) * 1.0)
    v32 = v.astype(jnp.float32)
    vs = jnp.maximum(jnp.max(jnp.abs(v32), axis=1) / 127.0, 1e-12)
    return q8, qs, k8, ks, jnp.round(v32 / vs[:, None]).astype(jnp.int8), vs


class TestQuantizers:
    def test_weight_matches_jax_bitwise(self):
        rng = np.random.default_rng(40)
        w = _rnd(rng, 384, 256, scale=0.05)  # nn.Linear layout (M, K)
        w[7] = 0.0  # an all-zero channel takes the 1e-12 floor
        q, s = quantize_weight(torch.from_numpy(w))
        q_j, s_j = jax.jit(jax_quantize_weight)(jnp.asarray(w.T))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_j).T)
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
        assert q.dtype == torch.int8 and s.dtype == torch.float32

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rows_match_jax_bitwise(self, dtype):
        rng = np.random.default_rng(41)
        x = torch.from_numpy(_rnd(rng, 3, 50, 256, scale=2.0)).to(dtype)
        q, s = quantize_rows(x)
        q_j, s_j = _jax_rows(jnp.asarray(x.float().numpy()))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
        assert s.shape == (3, 50)

    def test_attention_quantizers_match_jax_bitwise(self):
        rng = np.random.default_rng(42)
        q, k, v = (_rnd(rng, 2, 96, 4, 64) for _ in range(3))
        ours = quantize_qkv_int8(*map(torch.from_numpy, (q, k, v)))
        ref = _jax_qkv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for a, r in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


    def test_attention_pass_layouts_match_jax_bitwise(self):
        """The plain version of #5's quantization pass on the (B, T, H, D)
        thirds of one (B, T, 3, H, D) projection at an unaligned T: with v8^T's
        key order undone, its q8, k8, v8 and scales equal quantize_qkv_int8's
        and the JAX wrapper's bit for bit; v8^T is zero past T."""
        rng = np.random.default_rng(43)
        b, t, h = 2, 300, 4
        qkv = _rnd(rng, b, t, 3, h, 64, scale=1.5)
        qkv[0, 7, 1, 2] = 0.0  # an all-zero k row takes the 1e-12 floor
        q, k, v = torch.from_numpy(qkv).unbind(2)
        t_pad = int8_spans(t)[1]
        assert t_pad == 384 and q.stride(1) == 3 * h * 64
        q8, qs, k8, ks, v8t, vsc = quantize_qkv_int8_pass(q, k, v, t_pad)
        order = v8t_key_order(t_pad)
        assert torch.equal(order.sort().values, torch.arange(t_pad))
        assert torch.equal(order // 32, torch.arange(t_pad) // 32)  # within each 32 keys
        v8 = v8t[..., order.argsort()]
        assert not v8[..., t:].any()
        ours = (q8.transpose(1, 2), qs.transpose(1, 2), k8.transpose(1, 2), ks.transpose(1, 2),
                v8[..., :t].permute(0, 3, 1, 2))
        ref_t = quantize_qkv_int8(q, k, v)
        ref_j = _jax_qkv(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
        for a, rt, rj in zip(ours, ref_t, ref_j):
            np.testing.assert_array_equal(a.numpy(), rt.numpy())
            np.testing.assert_array_equal(a.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(vsc.numpy(), (ref_t[5] * (1.0 / 127.0)).numpy())
        np.testing.assert_array_equal(
            vsc.numpy(), np.asarray(ref_j[5]) * np.float32(1.0 / 127.0))

    def test_block_chunk_scales_from_partial_maxima(self):
        """#7's h quantizer: each chunk's scale from the max of its
        128-column partial maxima (what fc1's epilogue writes) equals
        _int8_mlp's quantize_rows of the chunk, values and scales bit for
        bit, for the a2v-large and ViT-B/16 hidden widths."""
        rng = np.random.default_rng(46)
        for m in (4096, 3072):
            h = torch.from_numpy(_rnd(rng, 40, m) * rng.uniform(0.01, 8.0, size=(40, 1)))
            h = torch.nn.functional.gelu(h.float())
            h[3, 1024:2048] = 0.0  # an all-zero chunk takes the 1e-12 floor
            chunk = hidden_chunk(m)
            h_q, h_s = quantize_chunks_plain(h, chunk)
            assert h_s.shape == (40, m // chunk)
            for j in range(0, m, chunk):
                q_ref, s_ref = quantize_rows(h[:, j:j + chunk])
                assert torch.equal(h_q[:, j:j + chunk], q_ref)
                assert torch.equal(h_s[:, j // chunk], s_ref)


@pytest.mark.parametrize("n,k,m,bias", [(300, 256, 384, True), (64, 128, 1024, False)])
def test_int8_dense_matches_jax_kernel(n, k, m, bias):
    """#10 against int8_mm._kernel in interpret mode (N not a multiple of
    its 256-row block)."""
    rng = np.random.default_rng(n + m)
    x = _rnd(rng, n, k, scale=1.5)
    w = _rnd(rng, m, k, scale=(2.0 / (k + m)) ** 0.5)
    b = _rnd(rng, m, scale=0.1) if bias else None
    w_q, w_s = quantize_weight(torch.from_numpy(w))
    ours = int8_dense(torch.from_numpy(x), w_q, w_s, None if b is None else torch.from_numpy(b))
    ref = jax_int8_dense(jnp.asarray(x), jnp.asarray(w_q.numpy().T), jnp.asarray(w_s.numpy()),
                         None if b is None else jnp.asarray(b))
    assert ours.shape == (n, m) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=FP32_TOL)


def test_int8_dense_bf16_and_leading_dims():
    rng = np.random.default_rng(43)
    x = torch.from_numpy(_rnd(rng, 2, 37, 128)).to(torch.bfloat16)
    w_q, w_s = quantize_weight(torch.from_numpy(_rnd(rng, 256, 128, scale=0.1)))
    before = int8_dense.launches
    y = int8_dense(x, w_q, w_s)
    assert int8_dense.launches == before  # the plain version on CPU tensors
    assert y.shape == (2, 37, 256) and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.reshape(-1, 256), int8_dense_plain(x.reshape(-1, 128), w_q, w_s),
                               rtol=0, atol=0)


def _block_inputs(n, c, m, seed):
    rng = np.random.default_rng(seed)
    x = _rnd(rng, n, c)
    w1 = _rnd(rng, m, c, scale=(2.0 / (c + m)) ** 0.5)
    w2 = _rnd(rng, c, m, scale=(2.0 / (c + m)) ** 0.5)
    vecs = (_rnd(rng, c, scale=0.1, shift=1.0), _rnd(rng, c, scale=0.1), _rnd(rng, m, scale=0.1),
            _rnd(rng, c, scale=0.1), _rnd(rng, c, scale=0.1, shift=1.0), _rnd(rng, c, scale=0.1))
    return x, w1, w2, vecs


def test_int8_block_matches_jax_kernel():
    """#7 against _kernel_int8_block in interpret mode: C 128, M 2048 (two
    hidden chunks of 1024, so h has two scales per row), N 300 rows (not a
    multiple of the 256-row block)."""
    n, c, m = 300, 128, 2048
    x, w1, w2, (l1s, l1b, b1, b2, l2s, l2b) = _block_inputs(n, c, m, seed=44)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2))
    assert hidden_chunk(m) == 1024
    t = torch.from_numpy
    xo, tap = fused_block_int8(t(x), t(l1s), t(l1b), w1_q, w1_s, t(b1), w2_q, w2_s, t(b2),
                               t(l2s), t(l2b), 1e-5)
    j = jnp.asarray
    xo_j, tap_j = jax_fused_block_mlp(
        j(x), j(l1s), j(l1b), j(w1_q.numpy().T), j(w2_q.numpy().T), j(b1), j(b2), j(l2s),
        j(l2b), 1e-5, j(w1_s.numpy()), j(w2_s.numpy()),
    )
    assert xo.shape == tap.shape == (n, c)
    for ours, ref, step in ((tap, tap_j, 5e-3), (xo, xo_j, 5e-2)):
        share, worst = _rows_off(ours.numpy(), ref)
        assert share <= ROWS_OFF and worst <= step, (share, worst)


def test_int8_block_one_chunk_is_the_whole_width():
    """A chunk of the whole hidden width gives one h scale per row: the
    plain version with chunk M against chunk M / 2 differs, so the chunk
    is the JAX block and not a free parameter."""
    n, c, m = 64, 128, 512
    x, w1, w2, vecs = _block_inputs(n, c, m, seed=45)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2))
    l1s, l1b, b1, b2, l2s, l2b = map(torch.from_numpy, vecs)
    args = (torch.from_numpy(x), l1s, l1b, w1_q, w1_s, b1, w2_q, w2_s, b2, l2s, l2b, 1e-5)
    whole = fused_block_int8_plain(*args, chunk=m)[1]
    torch.testing.assert_close(fused_block_int8(*args)[1], whole, rtol=0, atol=0)
    assert not torch.equal(fused_block_int8_plain(*args, chunk=m // 2)[1], whole)


def _attention_inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (_rnd(rng, b, t, h, 64) for _ in range(3))
    slopes = alibi_slopes(h).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    return q, k, v, slopes, pos


def _check_attention(ours, ref, worst_step=4e-2):
    share, worst = _rows_off(ours, ref)
    assert share <= ROWS_OFF and worst <= worst_step, (share, worst)


def _run_both(q, k, v, slopes, pos, mask=None, block_k=2048, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(a)
    ours = alibi_flash_attention_int8(t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), t(slopes),
                                      t(pos), t(mask), True, block_q=128, block_k=block_k)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_attention_int8(jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd),
                             jnp.asarray(v).astype(jd), jnp.asarray(slopes), jnp.asarray(pos),
                             None if mask is None else jnp.asarray(mask), True,
                             block_q=128, block_k=block_k)
    assert ours.shape == q.shape and ours.dtype == dtype
    return ours.float().numpy(), np.asarray(ref.astype(jnp.float32))


def test_int8_attention_two_spans():
    """T 256 with block_k 128: two key spans, P quantized against the
    running max after each."""
    q, k, v, slopes, pos = _attention_inputs(2, 256, 4, seed=46)
    assert int8_spans(256, 128, 128) == (128, 256)
    ours, ref = _run_both(q, k, v, slopes, pos, block_k=128)
    _check_attention(ours, ref)
    one_span = alibi_attention_int8_plain(*map(torch.from_numpy, (q, k, v, slopes, pos)),
                                          block_q=256, block_k=256).numpy()
    assert np.abs(one_span - ours).max() > 1e-4  # the span changes the rounding


def test_int8_attention_mask_and_unaligned_length():
    """T 200 pads to 256 (padded keys with zero v); keys 180+ masked in
    row 0, every key masked in row 1 (finite, as the JAX kernel gives)."""
    q, k, v, slopes, pos = _attention_inputs(2, 200, 4, seed=47)
    mask = np.zeros((2, 200), bool)
    mask[0, 180:] = True
    mask[1] = True
    ours, ref = _run_both(q, k, v, slopes, pos, mask)
    assert np.isfinite(ours).all()
    _check_attention(ours, ref)


def test_int8_attention_sentinel_and_gathered_positions():
    q, k, v, slopes, _ = _attention_inputs(2, 256, 4, seed=48)
    rng = np.random.default_rng(5)
    pos = np.stack([np.sort(rng.choice(2000, size=256, replace=False)) for _ in range(2)])
    pos = pos.astype(np.int32)
    pos[:, 0] = -1  # CLS sentinel: zero bias in its row and column
    ours, ref = _run_both(q, k, v, slopes, pos)
    _check_attention(ours, ref)


def test_int8_attention_bf16_inputs():
    """bf16 q, k, v: the same int8 values, the output rounded to bf16 (2^-9
    relative, atop the flips)."""
    q, k, v, slopes, pos = _attention_inputs(2, 256, 4, seed=49)
    ours, ref = _run_both(q, k, v, slopes, pos, dtype=torch.bfloat16)
    share, worst = _rows_off(ours, ref, tol=1e-2)
    assert share <= ROWS_OFF and worst <= 4e-2, (share, worst)


def test_other_devices_raise():
    x = torch.empty((4, 128), device="meta")
    w_q = torch.empty((256, 128), dtype=torch.int8, device="meta")
    w_s = torch.empty((256,), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8_dense(x, w_q, w_s)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_block_int8(x, None, None, w_q, w_s, None, w_q.t(), w_s[:128], None, None, None)
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        alibi_flash_attention_int8(q, q, q, torch.empty(2, device="meta"),
                                   torch.empty((1, 8), dtype=torch.int32, device="meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close_on_card(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= atol + rtol * want.float().abs()).all(), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [3072, 1024])
def test_int8_dense_kernel_matches_plain_on_card(cuda, m):
    """The qkv and out projections of a2v-large at N 2000: the kernel's
    int32 sums are exact, so only the fp32 dequant order and the bf16 output
    rounding (one ulp) differ."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(_rnd(rng, 2000, 1024)).to(cuda, torch.bfloat16)
    w_q, w_s = quantize_weight(torch.from_numpy(_rnd(rng, m, 1024, scale=0.03)).to(cuda))
    bias = torch.from_numpy(_rnd(rng, m, scale=0.1)).to(cuda)
    before = int8_dense.launches
    y = int8_dense(x, w_q, w_s, bias)
    torch.cuda.synchronize()
    assert int8_dense.launches == before + 1
    _close_on_card(y, int8_dense_plain(x, w_q, w_s, bias), 1e-2, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(1024, 3072), (1024, 1024), (768, 2304), (768, 768)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_dense_kernel_is_bit_exact_on_card(cuda, k, m, with_bias):
    """a2v-large's and ViT-B/16's qkv and out projections at N 2100 (a
    partial row tile): the int32 sums are exact and the epilogue rounds each
    product and sum on its own, ((acc * xs) * ws) + bias, as the plain
    version does, so the bf16 outputs are equal bit for bit."""
    rng = np.random.default_rng(k + m)
    x = torch.from_numpy(_rnd(rng, 2100, k)).to(cuda, torch.bfloat16)
    w_q, w_s = quantize_weight(torch.from_numpy(_rnd(rng, m, k, scale=0.03)).to(cuda))
    bias = torch.from_numpy(_rnd(rng, m, scale=0.1)).to(cuda) if with_bias else None
    y = int8_dense(x, w_q, w_s, bias)
    torch.cuda.synchronize()
    assert torch.equal(y, int8_dense_plain(x, w_q, w_s, bias))


@pytest.mark.gpu
def test_int8_block_kernel_matches_plain_on_card(cuda):
    x, w1, w2, vecs = _block_inputs(1000, 1024, 4096, seed=50)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1).to(cuda))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2).to(cuda))
    l1s, l1b, b1, b2, l2s, l2b = (torch.from_numpy(a).to(cuda) for a in vecs)
    args = (torch.from_numpy(x).to(cuda, torch.bfloat16), l1s, l1b, w1_q, w1_s, b1, w2_q, w2_s,
            b2, l2s, l2b, 1e-5)
    before = fused_block_int8.launches
    xo, tap = fused_block_int8(*args)
    torch.cuda.synchronize()
    assert fused_block_int8.launches == before + 1
    xo_p, tap_p = fused_block_int8_plain(*args)
    _close_on_card(tap, tap_p, 3e-2, 2e-2)
    _close_on_card(xo, xo_p, 3e-2, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [2000, 4000])
def test_int8_attention_kernel_matches_plain_on_card(cuda, t):
    """One and two key spans; row 1 pads its last 300 keys."""
    q, k, v, slopes, pos = _attention_inputs(2, t, 16, seed=t)
    mask = np.zeros((2, t), bool)
    mask[1, -300:] = True
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, slopes, pos[:1], mask)]
    for i in range(3):
        args[i] = args[i].to(torch.bfloat16)
    before = alibi_flash_attention_int8.launches
    out = alibi_flash_attention_int8(*args)
    torch.cuda.synchronize()
    assert alibi_flash_attention_int8.launches == before + 1
    _close_on_card(out, alibi_attention_int8_plain(*args), 2e-2, 2e-2)


@pytest.mark.gpu
def test_int8_quantization_pass_is_bit_exact_on_card(cuda):
    """#5's quantization pass on the thirds of a (B, T, 3, H, D) projection
    at an unaligned T equals its plain version bit for bit."""
    rng = np.random.default_rng(51)
    qkv = torch.from_numpy(_rnd(rng, 2, 300, 3, 16, 64, scale=1.5)).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    t_pad = int8_spans(300)[1]
    before = quantize_qkv_int8_pass.launches
    got = quantize_qkv_int8_pass(q, k, v, t_pad)
    torch.cuda.synchronize()
    assert quantize_qkv_int8_pass.launches == before + 1
    for a, r in zip(got, quantize_qkv_int8_pass_plain(q, k, v, t_pad)):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert torch.equal(a, r)


@pytest.mark.gpu
def test_int8_block_kernel_matches_plain_at_b32_rows_on_card(cuda):
    """#7 at the b32 serving grid, N 64 000 (500 row tiles)."""
    x, w1, w2, vecs = _block_inputs(64_000, 1024, 4096, seed=52)
    w1_q, w1_s = quantize_weight(torch.from_numpy(w1).to(cuda))
    w2_q, w2_s = quantize_weight(torch.from_numpy(w2).to(cuda))
    l1s, l1b, b1, b2, l2s, l2b = (torch.from_numpy(a).to(cuda) for a in vecs)
    args = (torch.from_numpy(x).to(cuda, torch.bfloat16), l1s, l1b, w1_q, w1_s, b1, w2_q, w2_s,
            b2, l2s, l2b, 1e-5)
    xo, tap = fused_block_int8(*args)
    torch.cuda.synchronize()
    xo_p, tap_p = fused_block_int8_plain(*args)
    _close_on_card(tap, tap_p, 3e-2, 2e-2)
    _close_on_card(xo, xo_p, 3e-2, 2e-2)


@pytest.mark.gpu
def test_int8_attention_kernel_matches_plain_padded_2048_on_card(cuda):
    """#5 as the int8_attn model calls it: the thirds of one projection at
    the trunk's padded T 2048, the padding mask covering the 48 pad frames of
    every row and the last 500 of row 1."""
    rng = np.random.default_rng(53)
    qkv = torch.from_numpy(_rnd(rng, 2, 2048, 3, 16, 64)).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    slopes = torch.from_numpy(alibi_slopes(16).astype(np.float32)).to(cuda)
    pos = torch.arange(2048, dtype=torch.int32, device=cuda)[None]
    mask = torch.zeros((2, 2048), dtype=torch.bool, device=cuda)
    mask[:, 2000:] = True
    mask[1, 1500:] = True
    out = alibi_flash_attention_int8(q, k, v, slopes, pos, mask)
    torch.cuda.synchronize()
    _close_on_card(out, alibi_attention_int8_plain(q, k, v, slopes, pos, mask), 2e-2, 2e-2)
