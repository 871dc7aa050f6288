"""Metrics: the port of ``animal2vec_tpu/ops/stats.py`` (``confusion_counts``
for finetuning; ``compute_var`` and ``get_annealed_rate`` for pretraining)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def confusion_counts(
    preds: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Micro-averaged TP/FP/TN/FN for binary {0, 1} tensors of equal shape;
    ``weights`` (broadcastable) masks elements out of the counts."""
    p = preds.to(torch.int32) == 1
    t = targets.to(torch.int32) == 1
    cells = (p & t, p & ~t, ~p & ~t, ~p & t)
    if weights is None:
        return tuple(c.sum() for c in cells)
    return tuple((c * weights).sum() for c in cells)


def compute_var(y: torch.Tensor) -> torch.Tensor:
    """Mean over channels of sqrt(var + 1e-6), the unbiased variance over
    every row of the flattened (..., C) ``y``, in fp32."""
    y = y.reshape(-1, y.shape[-1]).float()
    return torch.sqrt(torch.var(y, dim=0, unbiased=True) + 1e-6).mean()


def get_annealed_rate(start: float, end: float, curr_step: int, total_steps: int) -> float:
    """Linear anneal from ``start`` to ``end`` over ``total_steps``, then
    ``end``; in fp32, as JAX computes it."""
    if curr_step >= total_steps:
        return float(np.float32(end))
    pct_remaining = np.float32(1.0) - np.float32(curr_step) / np.float32(total_steps)
    return float(np.float32(end) - np.float32(end - start) * pct_remaining)
