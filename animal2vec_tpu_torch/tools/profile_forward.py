"""Profile one a2v-large FinetuneModel forward on a CUDA card.

Prints the card (nvidia-smi name and power limit), the frontend's time
against the whole forward (CUDA events), and from one torch.profiler run
the wall time, the device's busy time and idle share, and the device time
per kernel name (the 30 largest). Weights are random from seed 0 (mel sinc
init, bf16 serving cast), as in ``chip_smoke.py``; the input is ``--batch``
windows of ``--seconds`` of noise; ``--matmul-impl`` picks the serving
numerics (bf16, int8, int8_attn).

  python -m animal2vec_tpu_torch.tools.profile_forward [--batch 32] \
      [--seconds 10] [--matmul-impl int8] [--trace trace.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from animal2vec_tpu_torch.config import MATMUL_IMPLS, FinetuneConfig
from animal2vec_tpu_torch.kernels.build import library
from animal2vec_tpu_torch.models.finetune import build_finetune_model
from animal2vec_tpu_torch.weights import serving_cast


def cuda_ms(fn, iters: int = 5) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def self_device_us(event) -> float:
    # the attribute's name differs between torch releases
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def kernel_rows(prof):
    """(device us, calls, name) of each kernel, largest first. Only device
    rows that are not annotations count: a host row (an aten op, an
    autograd Function) and the device span of a range (an optimizer step)
    repeat the device time of the kernels inside them."""
    return sorted(
        ((self_device_us(e), e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
         and self_device_us(e) > 0),
        reverse=True,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seconds", type=float, default=10.0, help="window length")
    parser.add_argument("--matmul-impl", default="bf16", choices=MATMUL_IMPLS)
    parser.add_argument("--trace", default="", help="write a chrome trace here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    library()

    cfg = dataclasses.replace(FinetuneConfig(), matmul_impl=args.matmul_impl)
    model = build_finetune_model(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    model.load_state_dict(serving_cast(model.state_dict()), strict=True, assign=True)
    wav_len = round(args.seconds * cfg.sample_rate)
    src = torch.from_numpy(
        np.random.default_rng(0).normal(size=(args.batch, wav_len)).astype(np.float32)
    ).to(dev)

    with torch.inference_mode():
        for _ in range(2):
            model(src)
        torch.cuda.synchronize()
        frontend = cuda_ms(lambda: model.encoder.audio_encoder.local_features(src, torch.bfloat16))
        forward = cuda_ms(lambda: model(src))
        print(f"{args.matmul_impl} b{args.batch} x {args.seconds:g}-s windows: frontend (local_features) "
              f"{frontend:.2f} ms of a {forward:.2f} ms forward (CUDA events, 5 runs each)")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(src)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"profiled forward: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for us, n, key in rows[:30]:
        print(f"{us / 1e3:9.2f} ms {n:5d}x  {key[:110]}")


if __name__ == "__main__":
    main()
