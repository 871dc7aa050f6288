"""Time the dense-bias attention forward (#11, ``csrc/bias_attention.cu``)
of this checkout against the same entry built from another checkout's
``csrc/`` (for example an archive of the parent commit), on the same
inputs, in turns (other, this, this, other, this, other).

Two shapes: the ViT-B/16 pretraining student (b128, H 12, T 59, a per-row
bias, with the lse the backward reads) and image serving (b64, T 196, the
2-D ALiBi bias). For each launch: device time (torch.profiler, the kernels
named ``bias_attention_kernel``) and CUDA events around a bare launch
through ctypes, so that neither includes the Python wrapper's host work.
Prints the card, each time, and the largest differences between the two
builds' outputs and lse.

    python3 -m animal2vec_tpu_torch.tools.compare_bias_attention --other-csrc DIR
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from animal2vec_tpu_torch.kernels.build import (
    BUILD_ROOT, NVCC_FLAGS, SIGNATURES, build, check, find_nvcc,
)
from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d
from animal2vec_tpu_torch.tools.device_time import device_ms

ENTRY = "a2v_bias_attention"
ORDER = ("other", "this", "this", "other", "this", "other")


def load(path: Path):
    fn = getattr(ctypes.CDLL(str(path)), ENTRY)
    fn.argtypes = list(SIGNATURES[ENTRY])
    fn.restype = ctypes.c_int
    return fn


def build_other(csrc: Path) -> Path:
    """bias_attention.cu of ``csrc`` alone, as a shared library in _build/."""
    out_dir = BUILD_ROOT / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "bias_attention_other.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(lib),
           str(csrc / "bias_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return lib


def launcher(fn, q, k, v, bias, uniform, lse):
    """A bare launch of ``fn`` on (B, T, H, 64) views; returns (go, out)."""
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)

    def go():
        check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
                 None if bias is None else bias.data_ptr(), int(uniform), None,
                 out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, t, d,
                 d ** -0.5, torch.cuda.current_stream().cuda_stream), ENTRY)

    return go, out


def event_ms(go, iters: int) -> float:
    go()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        go()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--other-csrc", type=Path, required=True,
                        help="csrc/ directory of the other checkout")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_bias_attention needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    libs = {"this": load(build()), "other": load(build_other(args.other_csrc.resolve()))}

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    h = 12
    cases = []
    for label, b, t in (("b128 T 59, per-row bias, with lse", 128, 59),
                        ("b64 T 196, 2-D ALiBi bias", 64, 196)):
        qkv = torch.randn((b, t, 3, h, 64), generator=gen, device=dev).to(torch.bfloat16)
        if t == 59:
            bias, uniform = torch.randn((b, h, t, t), generator=gen, device=dev), False
        else:
            bias, uniform = torch.from_numpy(alibi_bias_2d(t, h)[None]).to(dev), True
        cases.append((label, *qkv.unbind(2), bias, uniform, t == 59))

    for label, q, k, v, bias, uniform, with_lse in cases:
        times, outs = {}, {}
        for name in ORDER:
            lse = (torch.empty((q.shape[0] * h, q.shape[1]), device=dev) if with_lse
                   else None)
            go, out = launcher(libs[name], q, k, v, bias, uniform, lse)
            times.setdefault(name, []).append(
                (device_ms(go, "bias_attention_kernel", args.iters), event_ms(go, args.iters)))
            outs[name] = (out, lse)
        print(label)
        for name, vals in times.items():
            print(f"  {name}: device ms {[d if d is None else round(d, 5) for d, _ in vals]}, "
                  f"CUDA-event ms {[round(e, 5) for _, e in vals]}")
        (o0, l0), (o1, l1) = outs["other"], outs["this"]
        diff = f"  out max abs diff {(o0.float() - o1.float()).abs().max().item():.3e}"
        if with_lse:
            diff += f", lse max abs diff {(l0 - l1).abs().max().item():.3e}"
        print(diff)


if __name__ == "__main__":
    main()
