"""The #12 probes' plain twins (``animal2vec_tpu_torch/probes``) against the
TPU tuning probes of ``bench/`` run in TPU interpret mode on the same
inputs, made with numpy from a seed and rounded to bf16 once on the JAX
side: ``attn_v2`` (bench/kernels.py) in its four variants, every row
compared, the padded query rows too; ``pallas_mm`` (bench/pallas_mm.py);
and ``probe`` (bench/attn_probe.py), which returns only its time, so its
kernel's inputs and output are captured by wrapping ``pl.pallas_call``
under ``jax.disable_jit()``. Each twin is reached through its wrapper,
which takes the plain twin for a CPU tensor. Also: a device other than
the CPU or CUDA and a wrong layout raise, and each probe's ``main`` exits
1 without CUDA."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench.attn_probe as bench_attn_probe
import bench.kernels as bench_kernels
import bench.pallas_mm as bench_pallas_mm
from animal2vec_tpu_torch.probes.attn_probe import mma_probe
from animal2vec_tpu_torch.probes.kernels import VARIANTS, attn_v2
from animal2vec_tpu_torch.probes.pallas_mm import row_gemm

# bf16 outputs of fp32 sums taken in another order: one bf16 step (2^-8
# relative) where a sum lands on the other side of a rounding
TOL = dict(atol=1e-2, rtol=1e-2)


def _torch_bf16(x) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(torch.bfloat16)


def _attention_inputs(b=1, h=2, t=256, d=64, n_pad=16, seed=0):
    rng = np.random.default_rng(seed)
    qkv = jnp.asarray(rng.normal(size=(3, b, h, t, d)).astype(np.float32) * 0.3, jnp.bfloat16)
    slopes = np.asarray([2.0**-4, 2.0**-8], np.float32)[:h]
    sp = slopes[None, :, None] * np.arange(t, dtype=np.float32)[None, None, :]
    sp = np.broadcast_to(sp, (b, h, t)).copy()
    sp[..., t - n_pad:] = 1e9
    return qkv, sp


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("block_q,block_k", [(128, 128), (128, 256)])
def test_attn_v2_matches_bench_kernel(variant, block_q, block_k):
    """Every row at B1 H2 T256 D64 with the last 16 positions at +1e9: the
    padded query rows attend to the padded keys alone. The online variants
    follow JAX's key block (block_k); no_softmax's outputs reach ~1e10 and
    are held by relative error."""
    qkv, sp = _attention_inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(bench_kernels.attn_v2(qkv, jnp.asarray(sp), block_q, block_k, variant)
                         .astype(jnp.float32))
    got = attn_v2(_torch_bf16(qkv), torch.from_numpy(sp), variant, block_k).float().numpy()
    assert got.shape == ref.shape == (1, 2, 256, 64)
    if variant == "no_softmax":
        assert np.abs(ref).min() > 1e6  # every row sums scores of about -1e9
        rel = np.abs(got - ref) / np.abs(ref)
        assert rel.max() <= 1e-2, rel.max()
    else:
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("block_m", [128, 256])
def test_row_gemm_matches_bench_pallas_mm(block_m):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(256, 128)) * 0.1, jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(128, 128)) * 0.05, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(bench_pallas_mm.pallas_mm(x, w, block_m).astype(jnp.float32))
    wt = _torch_bf16(w).t().contiguous()  # the kernel's K-major (N, K) weight
    got = row_gemm(_torch_bf16(x), wt.t(), block_m).float().numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("m,k,n", [(64, 64, 128), (64, 256, 64)])
def test_mma_probe_matches_bench_probe(monkeypatch, m, k, n):
    """bench/attn_probe.probe draws a, then b, from default_rng(0) and runs
    ``iters`` grid steps of acc += a @ b; its kernel's inputs and output are
    taken from inside its pallas_call. Beside rtol 1e-5, an atol of 1e-7 a
    step: the dot's fp32 sums of up to 256 products of ~1e-2 run in
    another order than XLA's and differ by a few ulps of their partial sums
    (7.5e-9 at 0.1; measured 4.5e-8 over 4 steps where a sum cancels)."""
    calls = []
    real = pl.pallas_call

    def capture(*args, **kwargs):
        kernel = real(*args, **kwargs)

        def run(*inputs):
            res = kernel(*inputs)
            calls.append((*map(np.asarray, inputs), np.asarray(res)))
            return res

        return run

    monkeypatch.setattr(pl, "pallas_call", capture)
    with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
        bench_attn_probe.probe("probe", m, k, n, iters=4)
    assert calls
    for a, b, ref in calls:
        bt = _torch_bf16(b).t().contiguous()
        got = mma_probe(_torch_bf16(a), bt.t(), 4).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=4 * 1e-7)


def test_wrappers_refuse_other_devices_and_layouts():
    qkv = torch.zeros((3, 1, 2, 64, 64), dtype=torch.bfloat16)
    sp = torch.zeros((1, 2, 64))
    x = torch.zeros((64, 64), dtype=torch.bfloat16)
    wt = torch.zeros((128, 64), dtype=torch.bfloat16)
    for call in (lambda: attn_v2(qkv.to("meta"), sp.to("meta")),
                 lambda: row_gemm(x.to("meta"), wt.to("meta").t()),
                 lambda: mma_probe(x.to("meta"), wt.to("meta").t(), 2)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()
    bad_layouts = (
        lambda: attn_v2(qkv.transpose(3, 4).contiguous().transpose(3, 4), sp),  # not contiguous
        lambda: attn_v2(qkv, sp.double()),
        lambda: attn_v2(qkv, sp, "softmax"),
        lambda: row_gemm(x, wt.t().contiguous()),  # w read MN-major
        lambda: row_gemm(x, wt[:, :32].t()),  # K mismatch
        lambda: mma_probe(x, wt.t().contiguous(), 2),
        lambda: mma_probe(x, wt.t(), 2, "mma"),
    )
    for call in bad_layouts:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("name", ["kernels", "pallas_mm", "attn_probe", "kernels2"])
def test_probe_main_exits_1_without_cuda(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"animal2vec_tpu_torch.probes.{name}")
    assert module.main() == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
