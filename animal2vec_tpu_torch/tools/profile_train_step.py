"""Profile the a2v-large finetune train step on a CUDA card.

Builds the full model with the ``finetune_100.yaml`` recipe at
``update_freq`` 1, with the state at the step where the freeze gate opens
(so the encoder's backward runs), on a batch of ``--batch`` windows of
``--seconds`` of noise with frame labels at 10 % ones. Prints the card
(nvidia-smi name and power limit), ms per step on the host clock, the
step's split into loss (forward), backward and optimizer update by CUDA
events, and from one torch.profiler step the wall time, the device's busy
time and idle share, and the device time per kernel name (the 30 largest).

  python -m animal2vec_tpu_torch.tools.profile_train_step [--batch 4] \
      [--seconds 10] [--trace trace.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from animal2vec_tpu_torch.config import FinetuneConfig, FinetuneTrainConfig
from animal2vec_tpu_torch.kernels.build import library
from animal2vec_tpu_torch.models.finetune import build_finetune_model
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.tools.profile_forward import kernel_rows
from animal2vec_tpu_torch.train.finetune_step import finetune_loss, make_finetune_train_step
from animal2vec_tpu_torch.train.state import FinetuneState


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seconds", type=float, default=10.0, help="window length")
    parser.add_argument("--trace", default="", help="write a chrome trace here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA card")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    library()

    cfg = FinetuneConfig()
    tcfg = dataclasses.replace(FinetuneTrainConfig(), update_freq=1)
    model = build_finetune_model(cfg, dtype=torch.bfloat16, seed=0, device=dev, train=tcfg)
    state = FinetuneState.create(model, tcfg)
    state.step = tcfg.freeze_finetune_updates
    step_fn = make_finetune_train_step(tcfg)
    rng = np.random.default_rng(0)
    wav_len = round(args.seconds * cfg.sample_rate)
    frames = wav_len // 40
    batch = {
        "source": torch.from_numpy(
            rng.normal(size=(1, args.batch, wav_len)).astype(np.float32)).to(dev),
        "target": torch.from_numpy(
            (rng.random((1, args.batch, frames, len(cfg.labels))) < 0.1).astype(np.float32)
        ).to(dev),
    }
    rngs = Rngs.from_seed(0, dev)

    for _ in range(2):
        step_fn(state, batch, rngs)
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(state, batch, rngs)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"b{args.batch} x {args.seconds:g}-s windows: {step_ms:.2f} ms per train step "
          f"(host clock, {iters} steps), {args.batch / step_ms * 1e3:.2f} clips/s")

    # the step's three parts, as make_finetune_train_step runs them
    mb = {k: v[0] for k, v in batch.items()}
    split = np.zeros(3)
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state.zero_grad()
        ev[0].record()
        loss, _ = finetune_loss(state.model, mb, rngs, state.step, tcfg, True)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        torch.cuda.synchronize()
        split += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    split /= iters
    print(f"split (CUDA events, {iters} steps): loss (forward) {split[0]:.2f} ms, "
          f"backward {split[1]:.2f} ms, optimizer {split[2]:.2f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch, rngs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    # the profiler slows the host's launches, so its wall time overstates
    # the idle share; the unprofiled step time bounds it from the other side
    print(f"profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f} ({1 - busy / step_ms:.3f} against the "
          f"unprofiled {step_ms:.1f} ms)")
    for us, n, key in rows[:30]:
        print(f"{us / 1e3:9.2f} ms {n:5d}x  {key[:110]}")


if __name__ == "__main__":
    main()
