"""Multilabel stratified splitting (replaces iterstrat's
MultilabelStratifiedShuffleSplit used at scripts/animal2vec_manifest.py:205).
A copy of ``animal2vec_tpu/data/stratify.py``.

Implements the iterative stratification algorithm (Sechidis, Tsoumakas &
Vlahavas 2011): repeatedly take the rarest remaining label, and distribute
its examples to the split whose desired count for that label is largest
(ties -> larger overall remaining capacity, then random).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def multilabel_stratified_split(
    y: np.ndarray,
    test_size: float,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """y: (N, L) binary indicator matrix. Returns (train_idx, test_idx)."""
    y = np.asarray(y, dtype=bool)
    n, n_labels = y.shape
    rng = np.random.default_rng(seed)
    ratios = np.asarray([1.0 - test_size, test_size])
    desired_total = ratios * n
    desired_label = ratios[:, None] * y.sum(axis=0)[None, :]  # (2, L)

    assign = np.full(n, -1, dtype=int)
    remaining = np.ones(n, dtype=bool)

    while remaining.any():
        counts = y[remaining].sum(axis=0)
        active = np.flatnonzero(counts > 0)
        if active.size == 0:
            # label-free leftovers: fill by remaining capacity
            for i in np.flatnonzero(remaining):
                s = int(np.argmax(desired_total))
                assign[i] = s
                desired_total[s] -= 1
                remaining[i] = False
            break
        lbl = active[np.argmin(counts[active])]
        idxs = np.flatnonzero(remaining & y[:, lbl])
        rng.shuffle(idxs)
        for i in idxs:
            cap = desired_label[:, lbl]
            best = np.flatnonzero(cap == cap.max())
            if len(best) > 1:
                tot = desired_total[best]
                best = best[np.flatnonzero(tot == tot.max())]
                s = int(rng.choice(best))
            else:
                s = int(best[0])
            assign[i] = s
            desired_label[s] -= y[i]
            desired_total[s] -= 1
            remaining[i] = False
    return np.flatnonzero(assign == 0), np.flatnonzero(assign == 1)


def multilabel_stratified_kfold(
    y: np.ndarray, n_splits: int, test_size: float, seed: int = 0
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """n_splits independent shuffle splits (the reference uses
    MultilabelStratifiedShuffleSplit, not disjoint folds)."""
    return [
        multilabel_stratified_split(y, test_size, seed=seed + 1000 * k)
        for k in range(n_splits)
    ]
