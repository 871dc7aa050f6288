"""The port's ALiBi attention against the JAX package's.

On the CPU the port's ``alibi_flash_attention_packed`` runs its plain
version; the JAX ``alibi_flash_attention_packed`` runs its Pallas kernels in
interpret mode (uniform (1, T) positions route to ``_kernel_serve_nk1``,
per-row positions to ``_kernel``). Inputs come from numpy seeds and go to
both sides. fp32 tolerance 1e-5 max-abs (the same math in another summation
order); bf16 5e-2 max-abs (P and the output round to bf16 at different
points: the JAX kernel rounds the unnormalized weights, the plain version
the normalized ones, each worth a few bf16 ulps of |out| <= 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.ops import alibi_slopes as jax_alibi_slopes
from animal2vec_tpu.ops.pallas_attention import (
    _reference_attention,
    alibi_flash_attention_packed as jax_packed,
)

from animal2vec_tpu_torch.ops.alibi import alibi_slopes
from animal2vec_tpu_torch.ops.attention import (
    alibi_attention_plain,
    alibi_flash_attention_btc,
    alibi_flash_attention_packed,
    alibi_flash_attention_serve,
    btc_to_packed,
)

FP32_TOL = 1e-5
BF16_TOL = 5e-2


def _inputs(b, h, t, d, seed, scale=0.8):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(3, b, h, t, d)).astype(np.float32)
    slopes = (alibi_slopes(h) * scale).astype(np.float32)
    return qkv, slopes


def _port(qkv, slopes, pos, mask=None, sentinel=False, dtype=torch.float32):
    out = alibi_flash_attention_packed(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(slopes), torch.from_numpy(pos),
        None if mask is None else torch.from_numpy(mask), sentinel,
    )
    return out.float().numpy()


def _jax(qkv, slopes, pos, mask=None, sentinel=False, dtype=jnp.float32):
    out = jax_packed(
        jnp.asarray(qkv).astype(dtype), jnp.asarray(slopes), jnp.asarray(pos),
        None if mask is None else jnp.asarray(mask), sentinel, 0.0, None,
    )
    return np.asarray(out.astype(jnp.float32))


def _gathered_positions(b, t, seed, sentinels=0):
    """Sorted per-row keep-sets of 0..2t (the masked-student layout), with
    optional -1 sentinel (extra-token) positions in front."""
    rng = np.random.default_rng(seed)
    rows = [np.sort(rng.choice(2 * t, t - sentinels, replace=False)) for _ in range(b)]
    return np.stack([np.concatenate([[-1] * sentinels, r]) for r in rows]).astype(np.int32)


def test_slopes_match_jax():
    for h in (1, 3, 4, 6, 12, 16):
        np.testing.assert_array_equal(alibi_slopes(h), jax_alibi_slopes(h))


@pytest.mark.parametrize(
    "case", ["uniform_unaligned", "per_row_positions", "sentinel_positions"]
)
def test_matches_jax_kernel_fp32(case):
    b, h, t, d = 2, 2, 200, 16
    qkv, slopes = _inputs(b, h, t, d, seed=1)
    if case == "uniform_unaligned":
        pos, sentinel = np.arange(t, dtype=np.int32)[None], False
    elif case == "per_row_positions":
        pos, sentinel = _gathered_positions(b, t, seed=2), False
    else:
        pos, sentinel = _gathered_positions(b, t, seed=3, sentinels=3), True
    ours = _port(qkv, slopes, pos, sentinel=sentinel)
    ref = _jax(qkv, slopes, pos, sentinel=sentinel)
    assert ours.shape == (b, h, t, d)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=FP32_TOL)


def test_padding_mask_with_fully_padded_row():
    b, h, t, d = 3, 2, 200, 16
    qkv, slopes = _inputs(b, h, t, d, seed=4)
    pos = np.arange(t, dtype=np.int32)[None]
    mask = np.zeros((b, t), bool)
    mask[0, -37:] = True
    mask[2] = True  # every key of row 2 padded
    ours = _port(qkv, slopes, pos, mask)
    assert np.isfinite(ours).all()
    ref = _jax(qkv, slopes, pos, mask)
    np.testing.assert_allclose(ours[:2], ref[:2], rtol=0, atol=FP32_TOL)
    # a fully padded row averages V over the T keys, as the JAX reference
    # math does (the TPU kernel also averages its zero pad keys there)
    q, k, v = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in qkv)
    dense = _reference_attention(
        q, k, v, jnp.asarray(slopes), jnp.broadcast_to(jnp.asarray(pos), (b, t)),
        jnp.asarray(mask),
    )
    np.testing.assert_allclose(
        ours[2], np.swapaxes(np.asarray(dense), 1, 2)[2], rtol=0, atol=FP32_TOL
    )
    np.testing.assert_allclose(ours[2], qkv[2, 2].mean(axis=1, keepdims=True).repeat(t, 1),
                               rtol=0, atol=FP32_TOL)


def test_matches_jax_kernel_bf16():
    b, h, t, d = 2, 2, 200, 64
    qkv, slopes = _inputs(b, h, t, d, seed=5)
    pos = np.arange(t, dtype=np.int32)[None]
    ours = _port(qkv, slopes, pos, dtype=torch.bfloat16)
    ref = _jax(qkv, slopes, pos, dtype=jnp.bfloat16)
    assert np.abs(ours - ref).max() <= BF16_TOL


def test_cpu_runs_plain_version_without_counting():
    qkv, slopes = _inputs(1, 2, 40, 8, seed=6)
    pos = np.arange(40, dtype=np.int32)[None]
    before = alibi_flash_attention_packed.launches
    ours = _port(qkv, slopes, pos)
    assert alibi_flash_attention_packed.launches == before
    plain = alibi_attention_plain(
        torch.from_numpy(qkv), torch.from_numpy(slopes), torch.from_numpy(pos)
    ).numpy()
    np.testing.assert_array_equal(ours, plain)


@pytest.mark.parametrize("layout", ["uniform", "per_row_masked_sentinel"])
def test_btc_serving_reads_the_projection_in_place(layout):
    """Without a gradient the model's entry hands the q, k, v thirds of the
    (B, T, 3C) projection to the serving entry and views its (B, T, H, D)
    output as (B, T, C): the layout the serving kernel reads and writes in
    place. It equals the plain version on the packed copy, reshaped."""
    b, h, t, d = 3, 3, 50, 16
    qkv, slopes = _inputs(b, h, t, d, seed=9)
    qkv_btc = torch.from_numpy(qkv).permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h * d)
    mask, sentinel = None, False
    if layout == "uniform":
        pos = torch.arange(t, dtype=torch.int32)[None]
    else:
        pos = torch.from_numpy(_gathered_positions(b, t, seed=10, sentinels=2))
        m = np.zeros((b, t), bool)
        m[1, -13:] = True
        m[2] = True
        mask, sentinel = torch.from_numpy(m), True
    before = alibi_flash_attention_serve.launches
    with torch.no_grad():
        got = alibi_flash_attention_btc(qkv_btc, h, torch.from_numpy(slopes), pos, mask,
                                        sentinel)
    assert alibi_flash_attention_serve.launches == before
    assert got.shape == (b, t, h * d) and got.is_contiguous()
    want = alibi_attention_plain(btc_to_packed(qkv_btc, h), torch.from_numpy(slopes), pos,
                                 mask, sentinel)
    want = want.permute(0, 2, 1, 3).reshape(b, t, h * d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FP32_TOL)


def test_other_devices_raise():
    qkv = torch.empty((3, 1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        alibi_flash_attention_packed(
            qkv, torch.ones(2), torch.zeros((1, 8), dtype=torch.int32)
        )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["packed", "btc_in_place"])
@pytest.mark.parametrize("t", [40, 333, 2000])
@pytest.mark.parametrize("layout", ["uniform", "per_row_masked_sentinel"])
def test_kernel_matches_plain_on_card(cuda, layout, t, entry):
    """The serving kernel through the packed entry and through the model's
    (B, T, 3C) entry, which it reads in place: T below one key tile, a
    ragged one and the 10-s window's; per-row positions with two sentinels
    and a mask that pads part of row 1 and all of row 2."""
    b, h, d = 3, 4, 64
    qkv, slopes = _inputs(b, h, t, d, seed=7)
    qkv_t = torch.from_numpy(qkv).to(cuda, torch.bfloat16)
    slopes_t = torch.from_numpy(slopes).to(cuda)
    mask, sentinel = None, False
    if layout == "uniform":
        pos = torch.arange(t, dtype=torch.int32, device=cuda)[None]
    else:
        pos = torch.from_numpy(_gathered_positions(b, t, seed=8, sentinels=2)).to(cuda)
        m = np.zeros((b, t), bool)
        m[1, -t // 4:] = True
        m[2] = True
        mask, sentinel = torch.from_numpy(m).to(cuda), True
    before = alibi_flash_attention_serve.launches
    if entry == "packed":
        got = alibi_flash_attention_packed(qkv_t, slopes_t, pos, mask, sentinel)
    else:
        qkv_btc = qkv_t.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h * d)
        with torch.no_grad():
            got = alibi_flash_attention_btc(qkv_btc, h, slopes_t, pos, mask, sentinel)
        got = got.reshape(b, t, h, d).transpose(1, 2)
    torch.cuda.synchronize()
    assert alibi_flash_attention_serve.launches == before + 1
    want = alibi_attention_plain(qkv_t.float(), slopes_t, pos, mask, sentinel)
    err = (got.float() - want).abs()
    assert (err <= 1e-2 + 1e-2 * want.abs()).all(), err.max().item()
