"""Losses: the port of ``animal2vec_tpu/ops/losses.py``
(``sigmoid_focal_loss``, RetinaNet alpha 0.25 gamma 2, and
``label_smoothed_nll_loss`` for finetuning; ``d2v_regression_loss`` for
pretraining), computed in fp32."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def sigmoid_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
    reduction: str = "none",
) -> torch.Tensor:
    logits = logits.float()
    targets = targets.float()
    p = torch.sigmoid(logits)
    # binary cross-entropy with logits, numerically stable
    ce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return _reduce(loss, reduction)


def label_smoothed_nll_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    epsilon: float = 0.0,
    reduction: str = "sum",
) -> torch.Tensor:
    """Label-smoothed cross-entropy over integer class targets."""
    lprobs = F.log_softmax(logits.float(), dim=-1)
    lprobs = lprobs.reshape(-1, lprobs.shape[-1])
    targets = targets.reshape(-1).long()
    nll = -lprobs.gather(1, targets[:, None])[:, 0]
    smooth = -lprobs.mean(dim=-1)
    return _reduce((1.0 - epsilon) * nll + epsilon * smooth, reduction)


def d2v_regression_loss(x: torch.Tensor, y: torch.Tensor, loss_beta: float = 0.0,
                        loss_scale: Optional[float] = None) -> torch.Tensor:
    """Per-element regression loss of student predictions ``x`` against
    teacher targets ``y``, (N, D) fp32 out: the squared error, or with
    ``loss_beta`` > 0 the smooth L1 loss (quadratic below ``loss_beta``),
    times ``loss_scale`` (None: 1/sqrt(D))."""
    d = x.shape[-1]
    diff = x.reshape(-1, d).float() - y.reshape(-1, d).float()
    if loss_beta == 0:
        loss = diff**2
    else:
        a = diff.abs()
        loss = torch.where(a < loss_beta, 0.5 * a**2 / loss_beta, a - 0.5 * loss_beta)
    return loss * (loss_scale if loss_scale is not None else 1.0 / math.sqrt(d))
