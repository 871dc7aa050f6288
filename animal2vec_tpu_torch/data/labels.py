"""Label file IO: HDF5 event annotations per 10-s clip. A copy of
``animal2vec_tpu/data/labels.py``.

Schema matches the reference prep script output
(scripts/prepare_arb_data_for_audio_pretraining.py:243-253): datasets
start_time_lbl / start_frame_lbl / end_time_lbl / end_frame_lbl / lbl /
lbl_cat / foc. Reads h5 when h5py is present; an .npz mirror format is
supported for h5py-free environments.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np

try:
    import h5py

    _HAVE_H5 = True
except Exception:  # pragma: no cover
    _HAVE_H5 = False

_FIELDS = (
    "start_time_lbl",
    "start_frame_lbl",
    "end_time_lbl",
    "end_frame_lbl",
    "lbl",
    "lbl_cat",
    "foc",
)

# .../wav/.../name.<ext> -> .../<lbldir>/.../name.<lblext>
# (mirror of the reference's audio2label regex, nn/audio_tasks.py:294)
_AUDIO_RE = re.compile(r"(?P<pre>.*)(?P<dir>wav)(?P<post>/.*\.)(?P<ext>[a-z0-9]+)$", re.IGNORECASE)


def audio_path_to_label_path(audio_path: str, lbldir: str = "lbl", lblext: str = "h5") -> str:
    m = _AUDIO_RE.match(audio_path.replace(os.sep, "/"))
    if m is None:
        raise ValueError(f"cannot derive label path from {audio_path!r}")
    return f"{m.group('pre')}{lbldir}{m.group('post')}{lblext}"


def read_label_file(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=True)
        return {k: np.asarray(data[k]) for k in _FIELDS if k in data.files}
    assert _HAVE_H5, "h5py unavailable; use .npz label files"
    out = {}
    with h5py.File(path, "r") as f:
        for k in _FIELDS:
            if k in f:
                out[k] = np.asarray(f[k])
    return out


def write_label_file(
    path: str,
    start_time,
    start_frame,
    end_time,
    end_frame,
    lbl,
    lbl_cat,
    foc,
):
    values = {
        "start_time_lbl": np.asarray(start_time, dtype=np.float64),
        "start_frame_lbl": np.asarray(start_frame, dtype=np.int64),
        "end_time_lbl": np.asarray(end_time, dtype=np.float64),
        "end_frame_lbl": np.asarray(end_frame, dtype=np.int64),
        "lbl": np.asarray([str(x) for x in lbl], dtype="S"),
        "lbl_cat": np.asarray(lbl_cat, dtype=np.int64),
        "foc": np.asarray(foc, dtype=np.int64),
    }
    if path.endswith(".npz"):
        np.savez(path, **values)
        return
    assert _HAVE_H5, "h5py unavailable; write .npz label files"
    with h5py.File(path, "w") as f:
        for k, v in values.items():
            f.create_dataset(k, data=v)
