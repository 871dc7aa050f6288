"""#12c: the tensor-core rate probe at flash-attention tile shapes, the
counterpart of ``bench/attn_probe.py`` (``probe`` at :25, its kernel at :29,
its ``pallas_call`` at :49), which asked whether head dim 64 runs the
matrix unit at half rate.

``mma_probe(a, b, iters, route)`` returns the fp32 sum over ``iters`` of a
@ b for bf16 a (M, K) and b (K, N): ``iters * (a @ b)`` up to the order of
the sums. On a CUDA tensor one launch of ``csrc/probe_mma.cu`` by
``route`` "wgmma" (SS wgmma m64nBNk16) or "mma.sync" (m16n8k16), one block
per 64 x BN output tile (``block_n``), the K steps resident in shared
memory where they fit (``resident``) and streamed from L2 in every
iteration where they do not. The kernel reads b K-major: it takes b as the
(K, N) view of a contiguous (N, K) tensor (``b = bt.t()``) and raises on
any other layout. On a CPU tensor ``mma_probe_plain``; any other device
raises.

    python -m animal2vec_tpu_torch.probes.attn_probe

checks both routes at every shape against the plain twin and prints, for
bench/attn_probe.py's six shapes and iters, each route's ms, device ms,
TFLOP/s over the card and per busy SM (a block per output tile: 16 to 128
of the 132 SMs; iters is not split across blocks), whether the operands
stayed resident, and one torch.matmul of a @ b times iters.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict

import torch

from animal2vec_tpu_torch.kernels.build import check as check_launch, library
from animal2vec_tpu_torch.probes.timing import (
    PEAK_BF16_FLOPS, SMS, bound, card_line, cuda_ms, device_ms, ms_text, num_text, per_ms,
    require_cuda,
)

ROUTES = ("wgmma", "mma.sync")
TILE_M = 64  # output rows per block: wgmma's M
SMEM_MAX = 232448  # dynamic shared memory a block can have on an H100
# (label, M, K, N, iters): bench/attn_probe.py:76-81
SHAPES = (
    ("QKt D64", 1024, 64, 2048, 512),
    ("QKt D128", 1024, 128, 2048, 512),
    ("QKt D256", 1024, 256, 2048, 256),
    ("PV D64", 1024, 2048, 64, 512),
    ("PV D128", 1024, 2048, 128, 512),
    ("square", 1024, 1024, 1024, 512),
)
# relative norm against the plain twin on the card: the kernel sums iters x
# K products into one fp32 register whose value grows to iters times the
# product (the tensor cores' sums truncate), the plain twin adds one fp32
# product iters times. Measured on an H100: 4.6e-5 (QK^T D64) to 1.16e-3
# (PV, 512 x 2048 terms); a wrong tile or fragment is off by order 1.
REL_TOL = 1e-2


def block_n(n: int) -> int:
    """The output tile's columns: the widest of 256, 128, 64 dividing N."""
    for bn in (256, 128, 64):
        if n % bn == 0:
            return bn
    raise ValueError(f"N must be a multiple of 64, got {n}")


def resident(k: int, n: int) -> bool:
    """Whether every K step of a block's a and b slices (64 + BN rows of K
    bf16) fits in shared memory beside the 1024-byte alignment slack."""
    return k * (TILE_M + block_n(n)) * 2 + 1024 <= SMEM_MAX


def busy_sms(m: int, n: int) -> int:
    """SMs with a block: one block per 64 x BN output tile."""
    return min(SMS, -(-m // TILE_M) * (n // block_n(n)))


def mma_probe_plain(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """fp32 a @ b added to an fp32 accumulator ``iters`` times (any
    device): the TPU kernel's arithmetic, the same dot in every step."""
    d = a.float() @ b.float()
    acc = torch.zeros_like(d)
    for _ in range(iters):
        acc += d
    return acc


def mma_probe(a: torch.Tensor, b: torch.Tensor, iters: int, route: str = "wgmma") -> torch.Tensor:
    """The probe (module docstring): one launch of csrc/probe_mma.cu on
    CUDA, ``mma_probe_plain`` on CPU."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or iters <= 0:
        raise ValueError(f"a (M, K) and b (K, N) must agree and iters be positive, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {iters}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or b.device != a.device:
        raise ValueError("a and b must be bf16 on one device")
    if b.stride() != (1, b.shape[0]):
        raise ValueError(f"b must be the (K, N) view of a contiguous (N, K) tensor (bt.t(), "
                         f"K-major), got strides {b.stride()}")
    if a.device.type == "cpu":
        return mma_probe_plain(a, b, iters)
    if a.device.type != "cuda":
        raise ValueError(f"the MMA probe runs on cuda or cpu tensors, got {a.device}")
    (m, k), n = a.shape, b.shape[1]
    if k % 64 or n % 64 or not a.is_contiguous() or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"the kernel takes K and N in multiples of 64 and 16-byte aligned "
                         f"contiguous rows; got K {k}, N {n}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = library().a2v_probe_mma(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, iters,
                                      ROUTES.index(route), block_n(n), int(resident(k, n)),
                                      torch.cuda.current_stream().cuda_stream)
    check_launch(err, "MMA probe kernel")
    mma_probe.launches += 1
    return out


mma_probe.launches = 0


def probe_inputs(m: int, k: int, n: int, dev, seed: int = 0):
    """a (M, K) and bt (N, K) bf16 of N(0, 0.1^2) (bench/attn_probe.py's
    scale); b = bt.t() is the probe's argument."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    bt = (torch.randn((n, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    return a, bt


def check(dev, out: Callable = print) -> Dict[str, dict]:
    """Both routes at every shape against the plain twin (relative norm);
    returns {label: {"max_abs_err", "rel", "plain_ms"}}."""
    res = {}
    for label, m, k, n, iters in SHAPES:
        a, bt = probe_inputs(m, k, n, dev, seed=k + n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = mma_probe_plain(a, bt.t(), iters)
        end.record()
        torch.cuda.synchronize()
        res[label] = {"max_abs_err": 0.0, "rel": 0.0, "plain_ms": start.elapsed_time(end)}
        for route in ROUTES:
            got = mma_probe(a, bt.t(), iters, route)
            err = (got - want).abs().max().item()
            rel = ((got - want).norm() / want.norm()).item()
            out(f"mma_probe {label} ({m}, {k}) @ ({k}, {n}) x {iters}, {route}: max_abs_err "
                f"{err:.3e}, relative norm error {rel:.3e} (tolerance {REL_TOL}); plain twin "
                f"{res[label]['plain_ms']:.3f} ms")
            if not torch.isfinite(got).all() or not rel <= REL_TOL:
                raise AssertionError(f"mma_probe {label} {route}: kernel disagrees with its "
                                     f"plain twin")
            res[label]["max_abs_err"] = max(res[label]["max_abs_err"], err)
            res[label]["rel"] = max(res[label]["rel"], rel)
        del a, bt, want
    return res


def sweep(dev, out: Callable = print) -> Dict[str, dict]:
    """Each shape by each route: host ms, device ms, TFLOP/s over the card
    and per busy SM, the bound at the busy SMs, residency; beside one
    torch.matmul times iters. Returns the rows by label."""
    rows: Dict[str, dict] = {}
    per_sm_peak = PEAK_BF16_FLOPS / SMS / 1e12
    with torch.inference_mode():
        for label, m, k, n, iters in SHAPES:
            a, bt = probe_inputs(m, k, n, dev)
            b = bt.t()
            flops = 2 * m * k * n * iters
            busy = busy_sms(m, n)
            card = bound(flops, 2 * (m * k + k * n) + 4 * m * n)
            lib = lambda: torch.matmul(a, b)
            lib_ms, lib_dev = cuda_ms(lib), device_ms(lib)
            lib_ms, lib_dev = lib_ms * iters, None if lib_dev is None else lib_dev * iters
            out(f"#12c {label} ({m}, {k}) @ ({k}, {n}) x {iters}: {busy} busy SMs, operands "
                f"{'resident' if resident(k, n) else 'streamed from L2 in every iteration'}; "
                f"bound {card[0]:.4f} ms over the card, {card[0] * SMS / busy:.4f} ms over the "
                f"busy SMs; torch.matmul x {iters} {lib_ms:.4f} ms, device {ms_text(lib_dev)}")
            for route in ROUTES:
                fn = lambda route=route: mma_probe(a, b, iters, route)
                ms, dev_ms = cuda_ms(fn), device_ms(fn, "probe_mma_kernel")
                rate = per_ms(flops, dev_ms)
                per_sm = None if rate is None else rate / busy
                rows[f"{label}, {route}"] = {
                    "ms": ms, "device_ms": dev_ms, "tflops": rate, "tflops_per_busy_sm": per_sm,
                    "busy_sms": busy, "resident": resident(k, n), "block_n": block_n(n),
                    "bound_ms": card[0], "bound_by": card[1],
                    "busy_bound_ms": card[0] * SMS / busy,
                    "library_ms": lib_ms, "library_device_ms": lib_dev}
                out(f"  {route}: {ms:.4f} ms, device {ms_text(dev_ms)}, {num_text(rate)} "
                    f"TFLOP/s, {num_text(per_sm, '.3f')} per busy SM (peak {per_sm_peak:.3f})")
            del a, bt, b
    return rows


def main() -> int:
    if not require_cuda("probes.attn_probe"):
        return 1
    print(card_line())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    check(dev)
    sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
