"""Finetune metrics: the port of ``animal2vec_tpu/ops/stats.confusion_counts``."""

from __future__ import annotations

from typing import Optional, Tuple

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
