"""Synthetic MeerKAT-like dataset generator for tests and smoke runs:
10-s 8 kHz WAV clips with chirp 'calls', matching label files, and manifests
in the reference's on-disk layout (wav/ + lbl/ trees + split tsvs). A copy
of ``animal2vec_tpu/data/synthetic.py``: the same seed writes the same
files."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from animal2vec_tpu_torch.data.labels import write_label_file
from animal2vec_tpu_torch.data.manifest import write_manifest
from animal2vec_tpu_torch.data.wavio import write_wav

DEFAULT_LABELS = [
    "beep", "synch", "sn", "cc", "ld", "oth", "mo", "al", "soc", "agg",
    "eating", "focal",
]


def generate(
    root: str,
    n_clips: int = 8,
    clip_seconds=10.0,  # float seconds, or (lo, hi) for variable lengths
    sample_rate: int = 8_000,
    labels: Sequence[str] = DEFAULT_LABELS,
    events_per_clip: int = 3,
    seed: int = 0,
    label_ext: str = "h5",
    splits: bool = True,
) -> str:
    rng = np.random.default_rng(seed)
    n_classes = len(labels) - 1  # last is 'focal'
    rate_dir = f"{sample_rate:05d}Hz"
    wav_dir = os.path.join(root, "wav", rate_dir)
    lbl_dir = os.path.join(root, "lbl", rate_dir)
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    entries = []
    for i in range(n_clips):
        # clip_seconds may be a (lo, hi) range -> variable-length clips
        # (NIPS4Bplus-style material; exercises the pad/crop + padding-mask
        # path instead of MeerKAT's uniform 10-s segments)
        if isinstance(clip_seconds, (tuple, list)):
            secs = float(rng.uniform(*clip_seconds))
        else:
            secs = float(clip_seconds)
        t_len = int(secs * sample_rate)
        wav = 0.02 * rng.standard_normal(t_len).astype(np.float32)
        starts, ends, cats, focs = [], [], [], []
        for _ in range(events_per_clip):
            dur = int(rng.uniform(0.05, min(0.5, secs / 2)) * sample_rate)
            s = int(rng.integers(0, t_len - dur))
            f0 = rng.uniform(200, 3000)
            tt = np.arange(dur) / sample_rate
            wav[s: s + dur] += 0.4 * np.sin(
                2 * np.pi * (f0 * tt + 0.5 * f0 * tt**2 / (dur / sample_rate))
            ).astype(np.float32)
            starts.append(s)
            ends.append(s + dur)
            cats.append(int(rng.integers(0, n_classes)))
            focs.append(int(rng.integers(0, 2)))
        name = f"clip_{i:04d}"
        write_wav(os.path.join(wav_dir, name + ".wav"), wav, sample_rate)
        write_label_file(
            os.path.join(lbl_dir, name + "." + label_ext),
            start_time=[s / sample_rate for s in starts],
            start_frame=starts,
            end_time=[e / sample_rate for e in ends],
            end_frame=ends,
            lbl=[labels[c] for c in cats],
            lbl_cat=cats,
            foc=focs,
        )
        entries.append((os.path.join("wav", rate_dir, name + ".wav"), t_len))

    if splits:
        write_manifest(os.path.join(root, "pretrain.tsv"), root, entries)
        n_val = max(1, n_clips // 4)
        write_manifest(os.path.join(root, "train_0.tsv"), root, entries[:-n_val])
        write_manifest(os.path.join(root, "valid_0.tsv"), root, entries[-n_val:])
    return root
