"""Temporal event segmentation for long-file inference: frame probabilities
-> [onset, offset] events.

The port's own copy of the parts of ``animal2vec_tpu/evalx/segmentation.py``
that ``fuse_predict`` needs (avg/max-pool and Canny-edge fusing) and that
validation scores events with (``segmented_probs_and_targets``: IoU
matching with split and merge counts), numpy and scipy only; the port
imports nothing of the JAX package.
``tests/test_torch_modules.py`` holds it equal to the original.

Conventions follow the reference: intervals are (start_idx, end_idx) pairs
over frames, inclusive of the first frame and clipped to len-1; pooled
fusing pads the valid-mode pooled signal back to length with zeros on the
right and shifts intervals by round(kernel/2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.ndimage import (
    gaussian_filter1d,
    gaussian_laplace,
    maximum_filter1d,
    minimum_filter1d,
)


# ---------------------------------------------------------------------------
# Interval extraction
# ---------------------------------------------------------------------------


def intervals_from_binary(data: np.ndarray, shift: int = 0) -> List[Tuple[int, int]]:
    """Runs of ones -> [(start+shift, min(len-1, end+shift))]
    (nn/utils.py:418-422 semantics, vectorized)."""
    data = np.asarray(data).astype(bool).astype(np.int8)
    if data.size == 0:
        return []
    diff = np.diff(np.concatenate([[0], data, [0]]))
    starts = np.flatnonzero(diff == 1)
    ends = np.flatnonzero(diff == -1) - 1
    n = len(data)
    return [(int(s) + shift, min(n - 1, int(e) + shift)) for s, e in zip(starts, ends)]


def _pool_intervals(
    preds: np.ndarray, kernel: int, threshold: float, pool: str
) -> List[Tuple[int, int]]:
    preds = np.asarray(preds, dtype=np.float64)
    n = len(preds)
    if kernel < 1:
        kernel = 1
    if n < kernel:
        return []
    if pool == "avg":
        pooled = np.convolve(preds, np.ones(kernel) / kernel, mode="valid")
    else:
        # sliding max, valid mode
        pooled = maximum_filter1d(preds, size=kernel, mode="nearest")
        off = (kernel - 1) // 2
        pooled = pooled[off: off + (n - kernel + 1)]
    padded = np.zeros(n)
    padded[: len(pooled)] = pooled
    binary = (padded >= threshold).astype(np.int8)
    return intervals_from_binary(binary, shift=round(kernel / 2))


def avg_pool_intervals(preds, fe_sample_rate: float, sigma_s: float, threshold: float):
    """Average-pool + threshold fusing (nn/utils.py:425-438)."""
    k = round(fe_sample_rate * sigma_s)
    return _pool_intervals(preds, k, threshold, "avg")


def max_pool_intervals(preds, fe_sample_rate: float, sigma_s: float, threshold: float):
    """Max-pool + threshold fusing (nn/utils.py:441-454)."""
    k = round(fe_sample_rate * sigma_s)
    return _pool_intervals(preds, k, threshold, "max")


# ---------------------------------------------------------------------------
# Canny-style edge detection
# ---------------------------------------------------------------------------


def threshold_otsu(x: np.ndarray, nbins: int = 256) -> float:
    """Otsu's threshold (replaces skimage.filters.threshold_otsu)."""
    x = np.asarray(x).ravel()
    lo, hi = float(x.min()), float(x.max())
    if hi <= lo:
        return lo
    hist, edges = np.histogram(x, bins=nbins, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2
    hist = hist.astype(np.float64)
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    mu0 = np.divide(m0, w0, out=np.zeros_like(m0), where=w0 > 0)
    mu1 = np.divide(m0[-1] - m0, w1, out=np.zeros_like(m0), where=w1 > 0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    return float(centers[np.argmax(between[:-1])])


def _extrema_per_region(signal: np.ndarray, indicator: np.ndarray, mode: str) -> List[int]:
    """One extremum index per contiguous True region of ``indicator``
    (nn/utils.py:493-533 semantics): argmax/argmin of ``signal`` within the
    region (the reference evaluates over [start, last+1))."""
    idx = []
    for s, e in intervals_from_binary(indicator.astype(np.int8)):
        seg = signal[s: e + 1]
        if seg.size == 0:
            continue
        pick = int(np.argmax(seg) if mode == "max" else np.argmin(seg))
        idx.append(s + pick)
    return idx


def canny_intervals(
    time_s: np.ndarray,
    signal: np.ndarray,
    sigma_s: float,
    maxfilt_s: float,
    max_duration_s: float,
    lowP: float,
) -> np.ndarray:
    """Canny-style onset/offset detection (nn/utils.py:536-685 behavior):

    1. Gaussian-smooth the probability curve; take its LoG derivative.
    2. Otsu-threshold |derivative| -> tau.
    3. Onset candidates: min-filtered derivative < -tau; offsets: > tau.
    4. Pick one extremum per region; prune peaks below lowP.
    5. Pair each peak with the nearest valley on each side; resolve
       duplicate/overlong intervals (split at midpoints, drop minor peaks);
       truncate detections longer than max_duration_s by walking out from
       the peak until the signal drops below lowP.
    Returns an (N, 2) index array.
    """
    signal = np.asarray(signal, dtype=np.float64)
    n = signal.shape[0]
    if n < 3:
        return np.zeros((0, 2), dtype=int)
    adv = float(time_s[1] - time_s[0])
    sigma_n = max(1.0, sigma_s // adv)
    smoothed = gaussian_filter1d(signal, sigma=sigma_n)
    deriv = gaussian_laplace(smoothed, sigma=sigma_n)
    tau = threshold_otsu(np.abs(deriv))
    filt_n = max(1, int(maxfilt_s // adv))

    onset_ind = minimum_filter1d(deriv, filt_n) < -tau
    offset_ind = maximum_filter1d(deriv, filt_n) > tau
    valleys = _extrema_per_region(deriv, offset_ind, "max")
    peaks = np.asarray(_extrema_per_region(deriv, onset_ind, "min"), dtype=int)
    if peaks.size:
        peaks = peaks[smoothed[peaks] >= lowP]
    if peaks.size == 0:
        return np.zeros((0, 2), dtype=int)
    valley_arr = np.asarray(sorted({0, n - 1, *valleys}), dtype=int)

    left = np.searchsorted(valley_arr, peaks, side="left") - 1
    right = np.searchsorted(valley_arr, peaks, side="right")
    left = np.clip(left, 0, len(valley_arr) - 1)
    right = np.clip(right, 0, len(valley_arr) - 1)
    intervals = np.stack([valley_arr[left], valley_arr[right]], axis=1)

    # resolve duplicate intervals from multiple peaks in one valley pair
    keep = np.ones(len(peaks), dtype=bool)
    max_dur_n = max_duration_s / adv
    i = 0
    while i < len(peaks) - 1:
        j = i
        while j + 1 < len(peaks) and np.array_equal(intervals[j + 1], intervals[i]):
            j += 1
        if j > i:
            group = list(range(i, j + 1))
            for a, b in zip(group[:-1], group[1:]):
                if peaks[b] - peaks[a] > max_dur_n:
                    mid = (peaks[a] + peaks[b]) // 2
                    cur = peaks[a]
                    while cur <= mid and smoothed[cur] > lowP:
                        cur += 1
                    intervals[a, 1] = cur
                    cur = peaks[b]
                    while cur > mid and smoothed[cur] > lowP:
                        cur -= 1
                    intervals[b, 0] = cur
                else:
                    minor = a if smoothed[peaks[a]] <= smoothed[peaks[b]] else b
                    keep[minor] = False
        i = j + 1
    peaks = peaks[keep]
    intervals = intervals[keep]

    # repair overlong detections by walking out from the peak
    durations = (intervals[:, 1] - intervals[:, 0]).astype(float)
    for idx in np.flatnonzero(durations * adv > max_duration_s):
        pk = peaks[idx]
        prev_end = 0 if idx == 0 else int(intervals[:idx, 1].max())
        nxt_start = n if idx + 1 >= len(intervals) else int(intervals[idx + 1, 0])
        lo = pk
        cur = pk
        while cur >= prev_end and signal[cur] >= lowP:
            lo = cur
            cur -= 1
        hi = pk
        cur = pk
        while cur < nxt_start and signal[cur] >= lowP:
            hi = cur
            cur += 1
        max_frames = int(max_duration_s // adv)
        if hi - lo > max_frames:
            lo = max(lo, pk - max_frames // 2)
            hi = min(hi, pk + max_frames // 2)
        intervals[idx] = [lo, hi]
    return intervals


# ---------------------------------------------------------------------------
# Fusing API
# ---------------------------------------------------------------------------


def fuse_to_segmented_predictions(
    time: np.ndarray,
    preds: np.ndarray,
    method_dict: Dict,
    method: str = "avg",
) -> Tuple[List[List[float]], List[Tuple[int, int]]]:
    """Per-class probability curve -> ([t_on, t_off] list, index interval
    list) (nn/utils.py:457-490)."""
    if method == "avg":
        idx_intervals = avg_pool_intervals(
            preds, method_dict["fe_sample_rate"], method_dict["sigma_s"],
            method_dict["metric_threshold"],
        )
    elif method == "max":
        idx_intervals = max_pool_intervals(
            preds, method_dict["fe_sample_rate"], method_dict["sigma_s"],
            method_dict["metric_threshold"],
        )
    elif method == "canny":
        idx_intervals = [
            (int(a), int(b))
            for a, b in canny_intervals(
                np.asarray(time), np.asarray(preds),
                method_dict["sigma_s"], method_dict["maxfilt_s"],
                method_dict["max_duration_s"], method_dict["lowP"],
            )
        ]
    else:
        raise NotImplementedError(method)
    time = np.asarray(time)
    time_intervals = []
    for a, b in idx_intervals:
        hi = time[b + 1] if b != len(time) - 1 else time[-1]
        time_intervals.append([float(time[a]), float(hi)])
    return time_intervals, idx_intervals


def fuse_predict(
    sample_size: int,
    probs: np.ndarray,
    method_dict: Dict,
    sample_rate: int,
    method: str = "avg",
    multiplier: int = 0,
    bs: int | None = None,
):
    """Batched fusing with absolute time bookkeeping for chunked long-file
    inference (nn/utils.py:860-922): ``multiplier`` shifts the time/index
    axes by whole batches so event stamps stay absolute; ``bs`` corrects the
    final (smaller) batch. Returns (time_intervals, idx_intervals,
    likelihoods), each nested [batch][class][event]."""
    probs = np.asarray(probs)
    if probs.ndim == 2:
        probs = probs[:, :, None]
    b, t, c = probs.shape
    base_time = b * sample_size / sample_rate
    if bs is not None:
        start_time = bs * sample_size / sample_rate * multiplier
    else:
        start_time = base_time * multiplier
    end_time = base_time + start_time
    tv_len = b * t
    time = np.linspace(start_time, end_time, tv_len).reshape(b, t)
    indexes = np.arange(tv_len * multiplier, tv_len * (multiplier + 1)).reshape(b, t)
    fe_sample_rate = t / sample_size * sample_rate
    md = dict(method_dict)
    md["fe_sample_rate"] = fe_sample_rate
    md["sample_rate"] = sample_rate
    kernel = round(fe_sample_rate * md["sigma_s"])

    time_intervals, idx_intervals, likelihoods = [], [], []
    for bp, bt, ind in zip(probs, time, indexes):
        if len(bt) < kernel:
            continue
        bti, bii, bli = [], [], []
        for ci in range(bp.shape[-1]):
            curve = bp[:, ci]
            ti, ii = fuse_to_segmented_predictions(bt, curve, md, method=method)
            bti.append(ti)
            bii.append([[int(ind[x]) for x in y] for y in ii])
            bli.append([float(curve[y[0]: y[1]].mean()) if y[1] > y[0] else float(curve[y[0]]) for y in ii])
        time_intervals.append(bti)
        idx_intervals.append(bii)
        likelihoods.append(bli)
    return time_intervals, idx_intervals, likelihoods


# ---------------------------------------------------------------------------
# Segmented metrics (IoU matching + split/merge accounting)
# ---------------------------------------------------------------------------


def _iou(a: Tuple[int, int], b: Tuple[int, int]) -> float:
    """IoU over half-open spans [s, e) (nn/utils.py:703-709)."""
    la = a[1] - a[0]
    lb = b[1] - b[0]
    overlap = max(0, min(a[1], b[1]) - max(a[0], b[0]))
    union = la + lb - overlap
    return overlap / union if union else 1.0


def _sanitize(iv: Tuple[int, int]) -> Tuple[int, int]:
    """Widen zero-length (x, x) events to (x, x+1) (nn/utils.py:786-802)."""
    return (iv[0], iv[1] + 1) if iv[0] == iv[1] else tuple(iv)


def segmented_probs_and_targets(
    targets: np.ndarray,
    seg_target_idx: Sequence[Sequence[Sequence[Tuple[int, int]]]],
    probs: np.ndarray,
    method_dict: Dict,
    sample_rate: int,
    source_size: int,
    method: str = "avg",
):
    """Event-level scoring (nn/utils.py:711-858).

    For every (batch, class): fuse predictions into events, match against
    ground-truth events by span overlap, and emit
      seg_probs/seg_target: one row per matched/unmatched event (mean prob
        over the event span vs 0/1 truth),
      seg_iou: IoU per overlapping pair,
      seg_splits / seg_mergers: counts of 1->N and N->1 matchings above the
        IoU threshold.
    Returns five (B*, C) arrays flattened the reference's way (rows = event
    slots, zero-padded).
    """
    targets = np.asarray(targets)
    probs = np.asarray(probs)
    b, t, c = targets.shape
    _, fused_preds, _ = fuse_predict(
        sample_size=source_size,
        probs=probs,
        method_dict=method_dict,
        sample_rate=sample_rate,
        method=method,
    )
    iou_thr = method_dict["iou_threshold"]

    seg_target = np.zeros((b, t, c), dtype=np.int64)
    seg_probs = np.zeros((b, t, c), dtype=np.float32)
    seg_iou = np.zeros((b, round(t / 2), c), dtype=np.float32)
    seg_splits = np.zeros((b, int(t // 3 * 2), c), dtype=np.int64)
    seg_mergers = np.zeros((b, int(t // 3 * 2), c), dtype=np.int64)

    for bi in range(b):
        for ci in range(c):
            truths = [_sanitize(iv) for iv in seg_target_idx[bi][ci]]
            preds_iv = [
                _sanitize((iv[0] - bi * t, iv[1] - bi * t))
                for iv in fused_preds[bi][ci]
            ]
            si = bi_i = soi = smi = -1
            for gt in truths:
                overlaps = [p for p in preds_iv if p[0] < gt[1] and gt[0] < p[1]]
                if overlaps:
                    valid = 0
                    for p in overlaps:
                        bi_i += 1
                        si += 1
                        iou = _iou(gt, p)
                        seg_iou[bi, bi_i, ci] = iou
                        if iou > iou_thr:
                            valid += 1  # true positive
                            seg_target[bi, si, ci] = 1
                            seg_probs[bi, si, ci] = probs[bi, p[0]: p[1], ci].mean()
                        else:  # overlap too weak -> false positive slot
                            seg_target[bi, si, ci] = 0
                            seg_probs[bi, si, ci] = probs[bi, gt[0]: gt[1], ci].mean()
                    if valid > 1:
                        soi += 1
                        seg_splits[bi, soi, ci] += valid
                else:  # missed truth -> false negative
                    si += 1
                    seg_target[bi, si, ci] = 1
                    seg_probs[bi, si, ci] = probs[bi, gt[0]: gt[1], ci].mean()
            for p in preds_iv:
                overlaps = [g for g in truths if g[0] < p[1] and p[0] < g[1]]
                if overlaps:
                    valid = sum(1 for g in overlaps if _iou(p, g) > iou_thr)
                    if valid > 1:
                        smi += 1
                        seg_mergers[bi, smi, ci] += valid
                else:  # spurious prediction -> false positive
                    si += 1
                    seg_target[bi, si, ci] = 0
                    seg_probs[bi, si, ci] = probs[bi, p[0]: p[1], ci].mean()

    flat = lambda x: x.reshape(-1, x.shape[-1])
    return flat(seg_probs), flat(seg_target), flat(seg_iou), flat(seg_splits), flat(seg_mergers)
