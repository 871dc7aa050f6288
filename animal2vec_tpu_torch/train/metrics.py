"""Host-side metrics: the port of ``animal2vec_tpu/train/metrics.py``.

Steps return dicts of scalars (torch tensors or numbers); the accumulator
averages most keys, sums the confusion counters and sizes, derives
P/R/F1 from the summed counts, and concatenates the ``_``-prefixed
prediction tensors. The sink fans out to tensorboard (through
``torch.utils.tensorboard``, when it imports and a log directory is set),
wandb (with ``WANDB_PROJECT`` or ``WANDB_API_KEY``) and aim (with
``AIM_REPO``), each only when its package imports.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from animal2vec_tpu_torch.evalx.reports import derived_prf

_SUM_KEYS = ("tp", "fp", "tn", "fn", "n_correct", "total", "sample_size")


def _is_sum_key(name: str) -> bool:
    return name.split("/")[-1] in _SUM_KEYS


def to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
    return np.asarray(v)


class MetricsAccumulator:
    """Accumulate per-step scalar dicts; average most keys, sum counters."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._tensors: Dict[str, List[np.ndarray]] = defaultdict(list)
        self._t0 = time.time()
        self._n_steps = 0

    def update(self, metrics: Dict):
        self._n_steps += 1
        for k, v in metrics.items():
            if k.startswith("_"):
                self._tensors[k].append(to_numpy(v))
                continue
            self._sums[k] += float(to_numpy(v))
            self._counts[k] += 1

    def totals(self) -> Tuple[Dict[str, float], Dict[str, int]]:
        """The summed values and their counts, by key."""
        return dict(self._sums), dict(self._counts)

    def set_totals(self, parts: Iterable[Tuple[Dict[str, float], Dict[str, int]]]) -> None:
        """Replace the sums and counts with those of ``parts`` (``totals``
        of several accumulators, e.g. one per data-parallel rank) added up."""
        self._sums, self._counts = defaultdict(float), defaultdict(int)
        for sums, counts in parts:
            for k, v in sums.items():
                self._sums[k] += v
                self._counts[k] += counts[k]

    def summary(self, prefix: str = "") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, total in self._sums.items():
            out[prefix + k] = total if _is_sum_key(k) else total / max(1, self._counts[k])
        # derived metrics from summed confusion counts
        for group in ("finetune", "pretrain"):
            if f"{group}/tp" in self._sums:
                prf = derived_prf(*(self._sums.get(f"{group}/{c}", 0.0)
                                    for c in ("tp", "fp", "tn", "fn")))
                for name, val in prf.items():
                    out[f"{prefix}metrics/{group}/{name}"] = val
        if self._n_steps:
            out[prefix + "ups"] = self._n_steps / max(time.time() - self._t0, 1e-9)
        return out

    def tensors(self) -> Dict[str, np.ndarray]:
        return {k: np.concatenate(v, axis=0) for k, v in self._tensors.items() if v}


class TensorboardSink:
    """Metric fan-out to tensorboard, wandb and aim, each when configured and
    importable."""

    def __init__(self, logdir: Optional[str], project: str = "animal2vec_tpu"):
        self.writer = None
        self._wandb = None
        self._aim_run = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(logdir)
            except Exception:
                self.writer = None
        if os.environ.get("WANDB_PROJECT") or os.environ.get("WANDB_API_KEY"):
            try:
                import wandb

                wandb.init(project=os.environ.get("WANDB_PROJECT", project))
                self._wandb = wandb
            except Exception:
                self._wandb = None
        if os.environ.get("AIM_REPO"):
            try:
                import aim

                self._aim_run = aim.Run(repo=os.environ["AIM_REPO"])
            except Exception:
                self._aim_run = None

    def log(self, metrics: Dict[str, float], step: int):
        scalars = {k: v for k, v in metrics.items()
                   if isinstance(v, (int, float)) and np.isfinite(v)}
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, step)
            self.writer.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self._aim_run is not None:
            for k, v in scalars.items():
                self._aim_run.track(v, name=k, step=step)

    def close(self):
        if self.writer is not None:
            self.writer.close()
