"""Profile one serving forward on a CUDA card: the a2v-large FinetuneModel
(``--modality audio``, the default) or the ViT-B/16 image model's
``extract_features(imgs, "IMAGE")`` (``--modality image``: the repo's image
defaults with the 2-D ALiBi bias on; ``--layer-norm-first`` for pre-LN
blocks).

Prints the card (nvidia-smi name and power limit), the frontend's time
(the sinc/conv stack, or the patch embedding) against the whole forward
(CUDA events), and from one torch.profiler window that kept every kernel
record (tools/device_time.py) the wall time, the device's
busy time, and the device time per kernel name (the 30 largest). The idle
share is 1 - busy / the unprofiled forward's CUDA-event time: the
profiler's own host work stretches the wall time of a short forward (an
11-ms image forward takes 25 ms of wall time under it). Weights are random from seed 0 (bf16 serving cast), as in
``chip_smoke.py``; the input is ``--batch`` (32 windows, 64 images) windows
of ``--seconds`` of noise or 224 x 224 noise images; ``--matmul-impl`` picks
the serving numerics (bf16, int8, int8_attn).

  python -m animal2vec_tpu_torch.tools.profile_forward [--modality image] \
      [--batch 64] [--seconds 10] [--layer-norm-first] [--matmul-impl int8] \
      [--trace trace.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from animal2vec_tpu_torch.config import MATMUL_IMPLS, FinetuneConfig, ImageConfig
from animal2vec_tpu_torch.kernels.build import library
from animal2vec_tpu_torch.models.finetune import build_finetune_model, build_image_model
from animal2vec_tpu_torch.tools.device_time import MARKER, profile_complete
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
    repeat the device time of the kernels inside them. The window's two
    markers (tools/device_time.py) do not count either."""
    return sorted(
        ((self_device_us(e), e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
         and self_device_us(e) > 0 and MARKER not in e.key),
        reverse=True,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--modality", default="audio", choices=("audio", "image"))
    parser.add_argument("--batch", type=int, default=None, help="32 windows or 64 images")
    parser.add_argument("--seconds", type=float, default=10.0, help="window length")
    parser.add_argument("--layer-norm-first", action="store_true", help="pre-LN image blocks")
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

    rng = np.random.default_rng(0)
    if args.modality == "image":
        batch = args.batch or 64
        cfg = dataclasses.replace(ImageConfig(), use_alibi_encoder=True,
                                  layer_norm_first=args.layer_norm_first,
                                  matmul_impl=args.matmul_impl)
        model = build_image_model(cfg, dtype=torch.bfloat16, seed=0, device=dev)
        size = (batch, cfg.input_size, cfg.input_size, cfg.in_chans)
        what = f"{'pre' if cfg.layer_norm_first else 'post'}-LN ViT-B/16 b{batch} images"

        def forward_fn():
            return model.extract_features(src, "IMAGE")

        def frontend_fn():
            return model.image_encoder.local_features(src, torch.bfloat16)
    else:
        batch = args.batch or 32
        cfg = dataclasses.replace(FinetuneConfig(), matmul_impl=args.matmul_impl)
        model = build_finetune_model(cfg, dtype=torch.bfloat16, seed=0, device=dev)
        size = (batch, round(args.seconds * cfg.sample_rate))
        what = f"b{batch} x {args.seconds:g}-s windows"

        def forward_fn():
            return model(src)

        def frontend_fn():
            return model.encoder.audio_encoder.local_features(src, torch.bfloat16)
    model.load_state_dict(serving_cast(model.state_dict()), strict=True, assign=True)
    src = torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(dev)

    with torch.inference_mode():
        for _ in range(2):
            forward_fn()
        torch.cuda.synchronize()
        frontend = cuda_ms(frontend_fn)
        forward = cuda_ms(forward_fn)
        print(f"{args.matmul_impl} {what}: frontend (local_features) {frontend:.2f} ms of a "
              f"{forward:.2f} ms forward (CUDA events, 5 runs each), {batch / forward * 1e3:.1f} "
              f"per s")

        walls = []

        def timed_forward():
            t0 = time.perf_counter()
            forward_fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

        prof = profile_complete(timed_forward, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        if prof is None:
            raise SystemExit("profile_forward: every profiled window lost kernel records")
        wall = walls[-1]
    if args.trace:
        prof.export_chrome_trace(args.trace)

    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"profiled forward: wall {wall:.1f} ms, device busy {busy:.1f} ms; idle share "
          f"{1 - busy / forward:.3f} of the {forward:.2f}-ms forward")
    for us, n, key in rows[:30]:
        print(f"{us / 1e3:9.2f} ms {n:5d}x  {key[:110]}")


if __name__ == "__main__":
    main()
