"""Profile a train step on a CUDA card: the a2v-large finetune step, or with
``--pretrain`` a data2vec-2 pretraining step.

Finetuning: the full model with the ``finetune_100.yaml`` recipe at
``update_freq`` 1, with the state at the step where the freeze gate opens
(so the encoder's backward runs), on a batch of ``--batch`` windows of
``--seconds`` of noise with frame labels at 10 % ones. ``--pretrain
audio``: a2v-large with the ``a2v_large_pretrain.yaml`` recipe
(``PretrainConfig()``, ``update_freq`` 5, clone 12; ``--batch`` 5 windows
per micro-batch by default); ``--pretrain image``: ViT-B/16
(``PretrainConfig.vit_b16()``, clone 2; ``--batch`` 64 images by default);
the state at the end of the warmup (its first learning rate is 0).

Prints the card (nvidia-smi name and power limit), ms per step on the host
clock, the split of one micro-batch by CUDA events (finetuning: loss
forward, backward, optimizer; pretraining: student forward with the loss,
of which the EMA teacher's forward, backward, optimizer + EMA update), and
from one torch.profiler step that kept every kernel record
(tools/device_time.py) the wall time, the device's busy time and
idle share, and the device time per kernel name (the 30 largest).

  python -m animal2vec_tpu_torch.tools.profile_train_step [--batch 4] \
      [--seconds 10] [--pretrain audio|image] [--trace trace.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity

from animal2vec_tpu_torch.config import FinetuneConfig, FinetuneTrainConfig, PretrainConfig
from animal2vec_tpu_torch.kernels.build import library
from animal2vec_tpu_torch.models.finetune import build_finetune_model, build_pretrain_model
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.tools.device_time import profile_complete
from animal2vec_tpu_torch.tools.profile_forward import kernel_rows
from animal2vec_tpu_torch.train.finetune_step import finetune_loss, make_finetune_train_step
from animal2vec_tpu_torch.train.pretrain import (
    make_pretrain_train_step, pretrain_loss, teacher_targets,
)
from animal2vec_tpu_torch.train.state import FinetuneState, PretrainState


class _Timer:
    """CUDA events between named parts of one micro-batch."""

    def __init__(self):
        self.marks = [("start", self._event())]

    @staticmethod
    def _event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self, name):
        self.marks.append((name, self._event()))

    def ms(self):
        torch.cuda.synchronize()
        return {name: a.elapsed_time(b) for (_, a), (name, b) in zip(self.marks, self.marks[1:])}


def _finetune(args, dev):
    cfg = FinetuneConfig()
    base = FinetuneTrainConfig()
    tcfg = dataclasses.replace(base, optimization=dataclasses.replace(base.optimization,
                                                                       update_freq=1))
    model = build_finetune_model(cfg, dtype=torch.bfloat16, seed=0, device=dev, train=tcfg)
    state = FinetuneState.create(model, tcfg)
    state.step = tcfg.freeze_finetune_updates
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

    def parts():
        mb = {k: v[0] for k, v in batch.items()}
        state.zero_grad()
        timer = _Timer()
        loss, _ = finetune_loss(state.model, mb, rngs, state.step, tcfg, True)
        timer.mark("loss (forward)")
        loss.backward()
        timer.mark("backward")
        state.apply_gradients()
        timer.mark("optimizer")
        return timer.ms()

    label = f"b{args.batch} x {args.seconds:g}-s windows"
    return make_finetune_train_step(tcfg), state, batch, rngs, parts, label, args.batch


def _pretrain(args, dev):
    image = args.pretrain == "image"
    cfg = PretrainConfig.vit_b16() if image else PretrainConfig()
    b = args.batch or (64 if image else 5)
    model = build_pretrain_model(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    state = PretrainState.create(model, cfg)
    state.step = cfg.optimization.warmup_updates
    accum = cfg.optimization.update_freq
    rng = np.random.default_rng(0)
    one = (cfg.model.input_size, cfg.model.input_size, 3) if image else (
        round(args.seconds * cfg.model.sample_rate),)
    batch = {"source": torch.from_numpy(
        rng.normal(size=(accum, b) + one).astype(np.float32)).to(dev)}
    rngs = Rngs.from_seed(0, dev)

    def parts():
        mb = {k: v[0] for k, v in batch.items()}
        state.zero_grad()
        timer = _Timer()
        loss, _ = pretrain_loss(state.model, state.ema, mb, rngs, cfg, True)
        timer.mark("student forward + loss (teacher included)")
        loss.backward()
        timer.mark("backward")
        state.apply_gradients()
        timer.mark("optimizer + EMA")
        with torch.no_grad():
            local = state.model.local_features(mb["source"])
        timer.mark("local features (again, for the teacher's share)")
        teacher_targets(state.model, state.ema, local)
        timer.mark("EMA teacher forward (part of the forward above)")
        return timer.ms()

    what = "images" if image else f"{args.seconds:g}-s windows"
    label = (f"{args.pretrain} pretrain b{b} {what} x clone {cfg.clone_batch} x update_freq "
             f"{accum}")
    return make_pretrain_train_step(cfg), state, batch, rngs, parts, label, b * accum


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch", type=int, default=0,
                        help="windows or images per micro-batch (finetune 4, pretrain audio 5, "
                             "image 64)")
    parser.add_argument("--seconds", type=float, default=10.0, help="window length")
    parser.add_argument("--pretrain", choices=("audio", "image"), default=None,
                        help="profile a data2vec-2 pretraining step instead")
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
    if args.pretrain:
        setup = _pretrain(args, dev)
    else:
        args.batch = args.batch or 4
        setup = _finetune(args, dev)
    step_fn, state, batch, rngs, parts, label, per_step = setup

    for _ in range(2):
        step_fn(state, batch, rngs)
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(state, batch, rngs)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"{label}: {step_ms:.2f} ms per train step (host clock, {iters} steps), "
          f"{per_step / step_ms * 1e3:.2f} per s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    split = {}
    for _ in range(iters):
        for name, ms in parts().items():
            split[name] = split.get(name, 0.0) + ms / iters
    print(f"split of one micro-batch (CUDA events, mean of {iters}): "
          + ", ".join(f"{name} {ms:.2f} ms" for name, ms in split.items()))

    walls = []

    def timed_step():
        t0 = time.perf_counter()
        step_fn(state, batch, rngs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    prof = profile_complete(timed_step, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if prof is None:
        raise SystemExit("profile_train_step: every profiled window lost kernel records")
    wall = walls[-1]
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
