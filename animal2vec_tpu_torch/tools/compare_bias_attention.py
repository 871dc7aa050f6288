"""Time the dense-bias attention forward (#11, ``csrc/bias_attention.cu``)
and its backward (#11b, ``csrc/bias_attention_bwd.cu``) of this checkout
against the same entries built from another checkout's ``csrc/`` (for
example an archive of the parent commit), on the same inputs, in turns
(other, this, this, other, this, other).

The forward at two shapes: the ViT-B/16 pretraining student (b128, H 12, T
59, a per-row bias, with the lse the backward reads) and image serving
(b64, T 196, the 2-D ALiBi bias). The backward at the student's shape, on
this checkout's forward: the dq + dbias and dk/dv launches of both builds,
and this checkout's single launch for T <= 64, in turns (other, this,
single, single, this, other). For each launch: device time (torch.profiler,
the kernels named ``bias_attention_kernel``, ``bias_attention_dq_kernel``,
``bias_attention_dkv_kernel``, ``bias_attention_bwd_single``) and CUDA
events around a bare launch through ctypes, so that neither includes the
Python wrapper's host work. Prints the card, each time, and the largest
differences between the builds' outputs (out, lse; dq, dk, dv, dbias).

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
NO_DROPOUT = (0, 0, 1.0)  # the entries' seed, keep threshold and keep scale: no dropout
DQ, DKV, SINGLE = ("a2v_bias_attention_bwd_dq", "a2v_bias_attention_bwd_dkv",
                   "a2v_bias_attention_bwd_single")
ORDER = ("other", "this", "this", "other", "this", "other")
BWD_ORDER = ("other", "this", "single", "single", "this", "other")


def load(path: Path, entry: str):
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.argtypes = list(SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


def build_other(csrc: Path, source: str) -> Path:
    """``source`` (a .cu of ``csrc``) alone, as a shared library in _build/."""
    out_dir = BUILD_ROOT / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{Path(source).stem}_other.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(lib),
           str(csrc / source)]
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
                 d ** -0.5, *NO_DROPOUT, torch.cuda.current_stream().cuda_stream), ENTRY)

    return go, out


def bwd_launcher(fns, q, k, v, dout, lse, delta, bias):
    """Bare launches of the backward on (B, T, H, 64) views and a per-row
    bias: ``fns`` is (dq entry, dk/dv entry) or (single entry,). Returns
    (go, (dq, dk, dv, dbias))."""
    b, t, h, d = q.shape
    grad = torch.empty((b, t, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = grad.unbind(2)
    dbias = torch.empty((b, h, t, t), device=q.device)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), bias.data_ptr(), 0, None)
    tail = (b, h, t, d, d ** -0.5, *NO_DROPOUT)

    def go():
        stream = torch.cuda.current_stream().cuda_stream
        if len(fns) == 1:
            check(fns[0](*common, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq.stride(0),
                         dq.stride(1), dbias.data_ptr(), *tail, stream), SINGLE)
            return
        check(fns[0](*common, dq.data_ptr(), dq.stride(0), dq.stride(1), dbias.data_ptr(), *tail,
                     stream), DQ)
        check(fns[1](*common, dk.data_ptr(), dv.data_ptr(), dq.stride(0), dq.stride(1), *tail,
                     stream), DKV)

    return go, (dq, dk, dv, dbias)


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
    other_csrc = args.other_csrc.resolve()
    libs = {"this": load(build(), ENTRY),
            "other": load(build_other(other_csrc, "bias_attention.cu"), ENTRY)}
    other_bwd = build_other(other_csrc, "bias_attention_bwd.cu")
    bwd_fns = {"this": (load(build(), DQ), load(build(), DKV)),
               "other": (load(other_bwd, DQ), load(other_bwd, DKV)),
               "single": (load(build(), SINGLE),)}

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

    # the backward at the student's shape, on this build's forward
    label, q, k, v, bias, _, _ = cases[0]
    b, t = q.shape[:2]
    lse = torch.empty((b * h, t), device=dev)
    go, out = launcher(libs["this"], q, k, v, bias, False, lse)
    go()
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t).contiguous()
    kernels = {"other": ("bias_attention_dq_kernel", "bias_attention_dkv_kernel"),
               "this": ("bias_attention_dq_kernel", "bias_attention_dkv_kernel"),
               "single": ("bias_attention_bwd_single",)}
    times, grads = {}, {}
    for name in BWD_ORDER:
        go, grads[name] = bwd_launcher(bwd_fns[name], q, k, v, dout, lse, delta, bias)
        times.setdefault(name, []).append(
            ([device_ms(go, kernel, args.iters) for kernel in kernels[name]],
             event_ms(go, args.iters)))
    print(f"backward, {label}")
    for name, vals in times.items():
        dev_ms = [[d if d is None else round(d, 5) for d in ds] for ds, _ in vals]
        print(f"  {name} ({' + '.join(kernels[name])}): device ms {dev_ms}, CUDA-event ms "
              f"{[round(e, 5) for _, e in vals]}")
    for a, c in (("other", "this"), ("this", "single")):
        print(f"  {a} vs {c}: max abs diff " + ", ".join(
            f"{what} {(x.float() - y.float()).abs().max().item():.3e}"
            for what, x, y in zip(("dq", "dk", "dv", "dbias"), grads[a], grads[c])))


if __name__ == "__main__":
    main()
