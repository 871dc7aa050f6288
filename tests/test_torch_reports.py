"""The port's evaluation reports and segmented metrics against the JAX
package's (whose reports call sklearn), within 1e-12, on random
probabilities and targets with classes that never fire."""

import numpy as np
import pytest

from animal2vec_tpu.evalx import reports as jax_reports
from animal2vec_tpu.evalx.segmentation import intervals_from_binary
from animal2vec_tpu.evalx.segmentation import segmented_probs_and_targets as jax_segmented
from animal2vec_tpu.train.metrics import MetricsAccumulator as JaxAccumulator

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.evalx import reports
from animal2vec_tpu_torch.evalx.segmentation import segmented_probs_and_targets
from animal2vec_tpu_torch.train.metrics import MetricsAccumulator

TOL = 1e-12
NAMES = ["a", "b", "c", "d", "e"]


def _data(seed, b=3, t=400, c=5, quantize=False):
    """(B, T, C) 0/1 targets in runs, classes 1 and 3 never on; probabilities
    that follow them loosely (coarse values with ties when ``quantize``)."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((b, t, c), np.int32)
    for bi in range(b):
        for ci in (0, 2, 4):
            for s in rng.integers(0, t - 40, 3):
                targets[bi, s:s + rng.integers(3, 40), ci] = 1
    probs = np.clip(0.6 * targets + 0.5 * rng.random((b, t, c)), 0, 1).astype(np.float32)
    if quantize:
        probs = np.round(probs * 8) / 8
    return targets, probs


def _close(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _close(ours[k], theirs[k], f"{path}/{k}")
    else:
        assert abs(float(ours) - float(theirs)) <= TOL, (path, ours, theirs)


@pytest.mark.parametrize("seed,quantize", [(0, False), (1, True), (2, False)])
def test_frame_reports_match_sklearn(seed, quantize):
    targets, probs = _data(seed, quantize=quantize)
    for thr in (0.175, 0.5, 0.99):
        _close(reports.classification_report_frames(targets, probs, NAMES, thr),
               jax_reports.classification_report_frames(targets, probs, NAMES, thr))
    assert abs(reports.mean_average_precision(targets, probs)
               - jax_reports.mean_average_precision(targets, probs)) <= TOL
    # one frame per row, every class at every threshold
    y = (np.random.default_rng(seed).random((60, 5)) < 0.2).astype(np.int64)
    y[:, 1] = 0
    p = np.random.default_rng(seed + 9).random((60, 5))
    _close(reports.classification_report_frames(y, p, NAMES, 0.5),
           jax_reports.classification_report_frames(y, p, NAMES, 0.5))
    assert abs(reports.mean_average_precision(y, p)
               - jax_reports.mean_average_precision(y, p)) <= TOL


@pytest.mark.parametrize("counts", [(5, 2, 90, 3), (0, 0, 10, 0), (0, 0, 0, 0), (7.0, 1.0, 0, 2.5)])
def test_derived_prf_matches_jax(counts):
    ours, theirs = reports.derived_prf(*counts), jax_reports.derived_prf(*counts)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert (np.isnan(ours[k]) and np.isnan(theirs[k])) or ours[k] == theirs[k], k


def _segmented(fn, targets, probs, method):
    md = FinetuneConfig().criterion(0.5)
    seg_idx = [[intervals_from_binary(targets[b, :, c]) for c in range(targets.shape[-1])]
               for b in range(targets.shape[0])]
    return fn(targets, seg_idx, probs, md, 8000, 16_000, method=method)


@pytest.mark.parametrize("method", ["avg", "max", "canny"])
def test_segmented_and_eval_report_match_jax(method):
    targets, probs = _data(3)
    ours = _segmented(segmented_probs_and_targets, targets, probs, method)
    theirs = _segmented(jax_segmented, targets, probs, method)
    for a, b in zip(ours, theirs, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    seg = dict(zip(("probs", "targets", "iou", "splits", "mergers"), ours))
    assert seg["targets"].any()
    ft, fp = targets.reshape(-1, 5), probs.reshape(-1, 5)
    out = reports.log_eval_report(ft, fp, NAMES, 0.5, 3, segmented=seg)
    ref = jax_reports.log_eval_report(ft, fp, NAMES, 0.5, 3, segmented=seg)
    assert out.keys() == ref.keys() and "valid/segmented_mAP" in out
    _close(out, ref)


def test_metrics_accumulator_matches_jax():
    rng = np.random.default_rng(4)
    ours, theirs = MetricsAccumulator(), JaxAccumulator()
    for _ in range(3):
        m = {"loss": rng.random(), "finetune/tp": float(rng.integers(0, 9)),
             "finetune/fp": float(rng.integers(0, 9)), "finetune/tn": 40.0,
             "finetune/fn": float(rng.integers(0, 9)), "sample_size": 200.0,
             "_predictions": rng.random((2, 3))}
        ours.update(m)
        theirs.update(m)
    a, b = ours.summary("train/"), theirs.summary("train/")
    a.pop("train/ups"), b.pop("train/ups")
    assert a == b
    np.testing.assert_array_equal(ours.tensors()["_predictions"],
                                  theirs.tensors()["_predictions"])
