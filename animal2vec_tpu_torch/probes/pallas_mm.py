"""#12b: the row-blocked bf16 GEMM probe, the counterpart of
``bench/pallas_mm.py`` (``pallas_mm`` at :18, its ``pallas_call`` at :28).

``row_gemm(x, w, block_m)`` computes bf16(x @ w) with fp32 sums for bf16 x
(M, K) and w (K, N), no bias and no epilogue. On a CUDA tensor one launch
of ``csrc/probe_gemm.cu``: the bf16 GEMM core under #6 and #8
(``csrc/bf16_gemm_sm90.cuh``) in its bias-free instance, ``block_m`` its
row tile (64, 128 or 256 rows by 128 columns). The core reads w K-major,
as nn.Linear's (N, K) weight: the kernel takes w as a (K, N) view of a
contiguous (N, K) tensor (``w = wt.t()``) and raises on any other layout;
the probes make wt once, outside the timed calls. On a CPU tensor
``row_gemm_plain``; any other device raises.

    python -m animal2vec_tpu_torch.probes.pallas_mm

checks every shape and tile against the plain twin and prints, for the
TPU probe's frontend (65536, 512) @ (512, 512), #6's fc1 and fc2 at b32
(64 000 x 1024 -> 4096 -> 1024) and #8's at the ViT-B/16 widths (12 544 x
768 -> 3072 -> 768), each tile's ms, device ms, TFLOP/s and share of the
bound beside torch.matmul (cuBLAS) and the device time of #6's and #8's
own GEMM launches with their epilogues at those shapes.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional

import torch

from animal2vec_tpu_torch.kernels.build import check as check_launch, library
from animal2vec_tpu_torch.probes.timing import (
    bound, card_line, check_close, cuda_ms, device_ms, ms_text, num_text, per_ms, require_cuda,
)

BLOCK_MS = (64, 128, 256)  # the core's row tiles: one, two or four warpgroups
# (label, M, K, N): the TPU probe's frontend, #6's fc1 and fc2 at b32, #8's
# at the ViT-B/16 widths
SHAPES = (
    ("frontend", 65536, 512, 512),
    ("#6 fc1 b32", 64000, 1024, 4096),
    ("#6 fc2 b32", 64000, 4096, 1024),
    ("#8 fc1 ViT-B/16", 12544, 768, 3072),
    ("#8 fc2 ViT-B/16", 12544, 3072, 768),
)
# against the plain twin on the card: fp32 sums in another order, one bf16
# rounding each (a rounding that lands a step apart: 2^-8 relative)
TOL = (1e-2, 1e-2)
KERNEL = "gemm_bf16_sm90_kernel"


def row_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16(x @ w) with fp32 sums (any device)."""
    return (x.float() @ w.float()).to(torch.bfloat16)


def row_gemm(x: torch.Tensor, w: torch.Tensor, block_m: int = 128) -> torch.Tensor:
    """The probe (module docstring): one launch of csrc/probe_gemm.cu on
    CUDA, ``row_gemm_plain`` on CPU."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x (M, K) and w (K, N) must agree, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or w.device != x.device:
        raise ValueError("x and w must be bf16 on one device")
    if w.stride() != (1, w.shape[0]):
        raise ValueError(f"w must be the (K, N) view of a contiguous (N, K) tensor (wt.t(), "
                         f"K-major), got strides {w.stride()}")
    if x.device.type == "cpu":
        return row_gemm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"the GEMM probe runs on cuda or cpu tensors, got {x.device}")
    (m, k), n = x.shape, w.shape[1]
    if block_m not in BLOCK_MS or k % 64 or n % 8 or not x.is_contiguous() \
            or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"the kernel takes block_m in {BLOCK_MS}, K % 64 == 0, N % 8 == 0 "
                         f"and 16-byte aligned contiguous rows; got block_m {block_m}, K {k}, "
                         f"N {n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = library().a2v_probe_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                                       block_m, torch.cuda.current_stream().cuda_stream)
    check_launch(err, "GEMM probe kernel")
    row_gemm.launches += 1
    return out


row_gemm.launches = 0


def gemm_bound(m: int, k: int, n: int):
    """(ms, what bounds it): 2 M K N operations; x and w read, C written."""
    return bound(2 * m * k * n, 2 * (m * k + k * n + m * n))


def gemm_inputs(m: int, k: int, n: int, dev, seed: int = 0):
    """x (M, K) of N(0, 0.1^2) and wt (N, K) of N(0, 0.05^2), bf16
    (bench/pallas_mm.py's scales); w = wt.t() is the probe's argument."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    wt = (torch.randn((n, k), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    return x, wt


def check(dev, shapes=SHAPES, out: Callable = print) -> Dict[str, dict]:
    """Every tile at every shape against the plain twin; returns {label:
    {"max_abs_err", "plain_ms"}}."""
    res = {}
    for label, m, k, n in shapes:
        x, wt = gemm_inputs(m, k, n, dev, seed=m + n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = row_gemm_plain(x, wt.t())
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max(check_close(f"row_gemm {label} ({m}, {k}) @ ({k}, {n}), block_m {bm} (plain "
                              f"twin {plain_ms:.3f} ms)", row_gemm(x, wt.t(), bm), want, *TOL, out)
                  for bm in BLOCK_MS)
        res[label] = {"max_abs_err": err, "plain_ms": plain_ms}
        del x, wt, want
    return res


def fused_gemm_device_ms(dev, label: str) -> Optional[float]:
    """Device ms of the GEMM launch of #6 (fused_block_mlp at b32) or #8
    (fused_mlp at the ViT-B/16 widths) that ``label`` names, with its bias,
    GELU (fc1) and stores, at the probe's shape."""
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp, fused_mlp

    _, m, k, n = next(s for s in SHAPES if s[0] == label)
    c, hid = (k, n) if "fc1" in label else (n, k)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((m, c), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    w1 = (torch.randn((c, hid), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    w2 = (torch.randn((hid, c), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    b1, b2 = torch.zeros(hid, device=dev), torch.zeros(c, device=dev)
    name = KERNEL + ("<true" if "fc1" in label else "<false")
    if label.startswith("#6"):
        ones = torch.ones(c, device=dev)
        return device_ms(lambda: fused_block_mlp(x, ones, b2, w1, w2, b1, b2, ones, b2), name)
    w1l, w2l = w1.t().contiguous(), w2.t().contiguous()  # nn.Linear layout
    return device_ms(lambda: fused_mlp(x, w1l, w2l, b1, b2), name)


def sweep(dev, out: Callable = print) -> Dict[str, dict]:
    """Each shape at each tile (host ms, device ms, TFLOP/s, share of the
    bound) beside torch.matmul and the fused GEMM launch of #6 or #8 at the
    same shape. Returns the rows by label."""
    rows: Dict[str, dict] = {}
    with torch.inference_mode():
        for label, m, k, n in SHAPES:
            x, wt = gemm_inputs(m, k, n, dev)
            w = wt.t()
            flops = 2 * m * k * n
            bnd = gemm_bound(m, k, n)
            lib = lambda: torch.matmul(x, w)
            lib_ms, lib_dev = cuda_ms(lib), device_ms(lib)
            fused = None if label == "frontend" else fused_gemm_device_ms(dev, label)
            out(f"#12b {label} ({m}, {k}) @ ({k}, {n}): bound {bnd[0]:.4f} ms ({bnd[1]}); "
                f"torch.matmul {lib_ms:.4f} ms, device {ms_text(lib_dev)} "
                f"({num_text(per_ms(flops, lib_dev))} TFLOP/s)"
                + ("" if label == "frontend" else
                   f"; the fused GEMM launch {ms_text(fused)} device "
                   f"({num_text(per_ms(flops, fused))} TFLOP/s)"))
            for bm in BLOCK_MS:
                fn = lambda bm=bm: row_gemm(x, w, bm)
                ms, dev_ms = cuda_ms(fn), device_ms(fn, KERNEL)
                rate = per_ms(flops, dev_ms)
                share = None if dev_ms is None else bnd[0] / dev_ms
                rows[f"{label}, block_m {bm}"] = {
                    "ms": ms, "device_ms": dev_ms, "tflops": rate, "bound_ms": bnd[0],
                    "bound_by": bnd[1], "bound_share": share, "library_ms": lib_ms,
                    "library_device_ms": lib_dev, "fused_device_ms": fused}
                out(f"  block_m {bm}: {ms:.4f} ms, device {ms_text(dev_ms)}, "
                    f"{num_text(rate)} TFLOP/s, {num_text(share, '.3f')} of the bound")
            del x, wt, w
    return rows


def main() -> int:
    if not require_cuda("probes.pallas_mm"):
        return 1
    print(card_line())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    check(dev)
    sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
