"""Frame-label rasterization and downsampling to feature rate: a copy of
``animal2vec_tpu/ops/frames.py`` (``tests/test_torch_data.py`` holds it
equal to the original).

Reproduces the dataset-side target construction of nn/audio_tasks.py:347-381:
labels given as (start_frame, end_frame, class[, focal]) become a multi-hot
vector per *waveform* sample, then are linearly interpolated down to the conv
feature rate. Implemented with numpy (host input pipeline) — this is not
device code in the reference either.

A fast path rasterizes directly at the feature rate (identical result for the
shipped conv stacks, see tests) to avoid allocating the 80k x 12 intermediate
per clip.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from animal2vec_tpu_torch.ops.conv_arith import label_frame_length


def rasterize_labels(
    wav_len: int,
    num_classes: int,
    starts: Sequence[int],
    ends: Sequence[int],
    cats: Sequence[int],
    focal: Sequence[int] | None = None,
    multilabel: bool = True,
    do_focal_prediction: bool = True,
) -> np.ndarray:
    """Multi-hot (wav_len, C) target at waveform rate
    (nn/audio_tasks.py:356-377). When ``multilabel`` is False (CE path) the
    output is (wav_len,) integer classes offset by +1."""
    if multilabel:
        out = np.zeros((wav_len, num_classes), dtype=np.int64)
        for i, (s, e, c) in enumerate(zip(starts, ends, cats)):
            out[int(s): int(e), int(c)] = 1
            if do_focal_prediction and focal is not None and int(focal[i]) == 1:
                out[int(s): int(e), -1] = 1
    else:
        out = np.zeros((wav_len,), dtype=np.int64)
        for s, e, c in zip(starts, ends, cats):
            out[int(s): int(e)] = int(c) + 1
    return out


def downsample_targets(
    source_vector: np.ndarray,
    wav_len: int,
    conv_layers: Sequence[Tuple[int, int, int]],
) -> np.ndarray:
    """Linear-interp downsample to the feature frame rate
    (nn/audio_tasks.py:347-365,379-381): sample the waveform-rate raster at
    round(linspace(0, wav_len, T_feat, endpoint=False)) and round to int."""
    t_feat = label_frame_length(wav_len, conv_layers)
    idx = np.round(np.linspace(0, wav_len, t_feat, endpoint=False)).astype(np.int64)
    idx = np.clip(idx, 0, wav_len - 1)
    # linear interpolation at integer query points == direct indexing
    return np.round(source_vector[idx].astype(np.float64)).astype(np.int64)


def frame_targets(
    wav_len: int,
    num_classes: int,
    starts: Sequence[int],
    ends: Sequence[int],
    cats: Sequence[int],
    conv_layers: Sequence[Tuple[int, int, int]],
    focal: Sequence[int] | None = None,
    multilabel: bool = True,
    do_focal_prediction: bool = True,
) -> np.ndarray:
    """Fast path: rasterize directly at feature rate. Equivalent to
    rasterize_labels + downsample_targets because the query points are integer
    sample indices."""
    t_feat = label_frame_length(wav_len, conv_layers)
    idx = np.round(np.linspace(0, wav_len, t_feat, endpoint=False)).astype(np.int64)
    idx = np.clip(idx, 0, wav_len - 1)
    if multilabel:
        out = np.zeros((t_feat, num_classes), dtype=np.int64)
        for i, (s, e, c) in enumerate(zip(starts, ends, cats)):
            sel = (idx >= int(s)) & (idx < int(e))
            out[sel, int(c)] = 1
            if do_focal_prediction and focal is not None and int(focal[i]) == 1:
                out[sel, -1] = 1
    else:
        out = np.zeros((t_feat,), dtype=np.int64)
        for s, e, c in zip(starts, ends, cats):
            sel = (idx >= int(s)) & (idx < int(e))
            out[sel] = int(c) + 1
    return out
