"""Evaluation reports: frame-wise and segmented classification metrics.

The port of ``animal2vec_tpu/evalx/reports.py``. The JAX module calls
sklearn's ``classification_report`` and ``average_precision_score``; the
port computes the same numbers in numpy (sklearn is not a dependency):
per-class, micro, macro, support-weighted and per-sample precision, recall
and F1 of thresholded multi-label frames with ``zero_division=0``, and the
macro average of each class's step-wise average precision.
``tests/test_torch_reports.py`` holds them to sklearn's within 1e-12.
Figures, PR curves and histograms go to a writer only when one exists.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger("animal2vec_tpu_torch")


def derived_prf(tp: float, fp: float, tn: float, fn: float) -> Dict[str, float]:
    """Accuracy/precision/recall/F1 in percent from summed counts, rounded
    to 3 decimals, nan on an empty denominator."""
    def safe(num, den):
        return round(num / den, 3) if den > 0 else float("nan")

    total = tp + fp + tn + fn
    return {
        "accuracy": safe((tp + tn) * 100.0, total),
        "precision": safe(tp * 100.0, tp + fp),
        "recall": safe(tp * 100.0, tp + fn),
        "f1": safe(tp * 200.0, 2 * tp + fn + fp),
    }


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den with 0 where den is 0 (``zero_division=0``)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = num / np.where(den == 0, 1.0, den)
    return np.where(den == 0, 0.0, out)


def _prf(tp: np.ndarray, pred: np.ndarray, true: np.ndarray):
    return _divide(tp, pred), _divide(tp, true), _divide(2.0 * tp, true + pred)


def _weighted(values: np.ndarray, weights: np.ndarray) -> float:
    if weights.sum() == 0:  # sklearn then averages without the weights
        return float(np.mean(values))
    return float(np.average(values, weights=weights))


def multilabel_report(labels: np.ndarray, preds: np.ndarray,
                      class_names: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """sklearn's ``classification_report(labels, preds, output_dict=True,
    zero_division=0)`` of (N, C) 0/1 indicator arrays."""
    y = np.asarray(labels).astype(bool)
    p = np.asarray(preds).astype(bool)
    tp = (y & p).sum(0).astype(np.int64)
    pred, true = p.sum(0).astype(np.int64), y.sum(0).astype(np.int64)
    prec, rec, f1 = _prf(tp, pred, true)
    support = float(true.sum())
    out: Dict[str, Dict[str, float]] = {}
    for i, name in enumerate(class_names):
        out[name] = {"precision": float(prec[i]), "recall": float(rec[i]),
                     "f1-score": float(f1[i]), "support": float(true[i])}
    mp, mr, mf = _prf(tp.sum(), pred.sum(), true.sum())
    out["micro avg"] = {"precision": float(mp), "recall": float(mr), "f1-score": float(mf),
                        "support": support}
    out["macro avg"] = {"precision": float(np.mean(prec)), "recall": float(np.mean(rec)),
                        "f1-score": float(np.mean(f1)), "support": support}
    out["weighted avg"] = {"precision": _weighted(prec, true), "recall": _weighted(rec, true),
                           "f1-score": _weighted(f1, true), "support": support}
    sp, sr, sf = _prf((y & p).sum(1), p.sum(1), y.sum(1))
    out["samples avg"] = {"precision": float(np.mean(sp)), "recall": float(np.mean(sr)),
                          "f1-score": float(np.mean(sf)), "support": support}
    return out


def classification_report_frames(
    labels: np.ndarray,
    probs: np.ndarray,
    class_names: Sequence[str],
    threshold: float,
) -> Dict[str, Dict[str, float]]:
    """Per-class + micro/macro P/R/F1 on thresholded sigmoid probabilities."""
    labels = labels.reshape(-1, labels.shape[-1])
    preds = (probs.reshape(-1, probs.shape[-1]) >= threshold).astype(np.int64)
    return multilabel_report(labels, preds, class_names)


def average_precision(y: np.ndarray, score: np.ndarray) -> float:
    """sklearn's step-wise average precision of one class: the sum over
    descending score thresholds of (recall step) x precision, recall 1 at
    every threshold when the class has no positive."""
    y = np.asarray(y).astype(np.float64)
    score = np.asarray(score)
    order = np.argsort(score, kind="mergesort")[::-1]
    s, y = score[order], y[order]
    idx = np.r_[np.where(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    precision = tps / (tps + fps)
    recall = np.full(tps.shape, 1.0) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate((precision[::-1], [1.0]))
    recall = np.concatenate((recall[::-1], [0.0]))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def mean_average_precision(labels: np.ndarray, probs: np.ndarray) -> float:
    """The macro mean over classes of ``average_precision``."""
    labels = labels.reshape(-1, labels.shape[-1])
    probs = probs.reshape(-1, probs.shape[-1])
    return float(np.mean([average_precision(labels[:, c], probs[:, c])
                          for c in range(labels.shape[-1])]))


def confusion_matrix_figure(
    labels: np.ndarray,
    probs: np.ndarray,
    class_names: Sequence[str],
    threshold: float,
):
    """Predicted-class x true-class co-activation heatmap as a matplotlib
    figure."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    labels = labels.reshape(-1, labels.shape[-1]).astype(np.int64)
    preds = (probs.reshape(-1, probs.shape[-1]) >= threshold).astype(np.int64)
    n = len(class_names)
    mat = labels.T @ preds  # (true, predicted) co-activations
    fig, ax = plt.subplots(figsize=(max(4, 0.6 * n), max(4, 0.6 * n)))
    im = ax.imshow(mat, cmap="GnBu", origin="upper")
    short = [c[:5] for c in class_names]
    ax.set_xticks(range(n), labels=short, rotation=45, fontsize=8)
    ax.set_yticks(range(n), labels=short, fontsize=8)
    ax.set_xlabel("Prediction")
    ax.set_ylabel("Truth")
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{mat[i, j]:.0f}", ha="center", va="center", fontsize=6)
    fig.colorbar(im, shrink=0.8)
    fig.tight_layout()
    return fig


def log_eval_report(
    labels: np.ndarray,
    probs: np.ndarray,
    class_names: Sequence[str],
    threshold: float,
    step: int,
    writer=None,
    prefix: str = "valid",
    segmented: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, float]:
    """The verbose eval report: micro and macro P/R/F1 of the frames, mAP,
    and with ``segmented`` the events' mAP; with a writer also the confusion
    figure, PR curves and the IoU/split/merge histograms."""
    report = classification_report_frames(labels, probs, class_names, threshold)
    out: Dict[str, float] = {}
    for avg in ("micro avg", "macro avg"):
        for k in ("precision", "recall", "f1-score"):
            out[f"{prefix}/{avg.split()[0]}_{k}"] = float(report[avg][k])
    out[f"{prefix}/mAP"] = mean_average_precision(labels, probs)
    if segmented is not None:
        out[f"{prefix}/segmented_mAP"] = mean_average_precision(segmented["targets"],
                                                                segmented["probs"])

    if writer is not None:
        flat_l = labels.reshape(-1, labels.shape[-1])
        flat_p = probs.reshape(-1, probs.shape[-1])
        try:
            writer.add_figure(f"{prefix}/confusion",
                              confusion_matrix_figure(labels, probs, class_names, threshold),
                              step)
        except Exception:  # plotting must never break eval
            pass
        writer.add_pr_curve(f"{prefix}/micro_average", flat_l, flat_p, global_step=step)
        writer.add_scalar(f"{prefix}/mAP", out[f"{prefix}/mAP"], step)
        for ci, name in enumerate(class_names):
            writer.add_pr_curve(f"{prefix}/class_{ci}_{name}", flat_l[:, ci], flat_p[:, ci],
                                global_step=step)
        for key, value in out.items():
            if not key.endswith("mAP"):
                writer.add_scalar(f"metrics/{key}", value, step)
        if segmented is not None:
            writer.add_pr_curve(f"{prefix}/segmented_micro_average", segmented["targets"],
                                segmented["probs"], global_step=step)
            for ci, name in enumerate(class_names):
                for hist_key, bins in (("iou", "auto"), ("splits", None), ("mergers", None)):
                    if hist_key not in segmented:
                        continue
                    vals = segmented[hist_key][:, ci]
                    vals = vals[vals != 0]
                    if vals.size > 1:
                        writer.add_histogram(f"{prefix}/{hist_key}_{ci}_{name}", vals,
                                             global_step=step,
                                             bins=bins or max(1, len(np.unique(vals))))
        writer.flush()

    logger.info("[step %d] frame report: %s", step, {k: out[k] for k in sorted(out)})
    return out
