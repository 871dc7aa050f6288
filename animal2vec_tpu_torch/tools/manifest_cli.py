"""Manifest generation: wav/lbl tree -> pretrain/train/valid (+few-shot) tsvs.
A copy of ``animal2vec_tpu/tools/manifest_cli.py`` over the port's data
modules.

Mirrors scripts/animal2vec_manifest.py: scan audio files, read their label
files, build multilabel-stratified train/valid splits per fold, few-shot
subsets at 1/10/25/50/75%, a pretrain manifest covering everything, and an
optional leave-p-out split grouped by source recording.

Usage:
  python -m animal2vec_tpu_torch.tools.manifest_cli --root data_root --dest manifests \
      [--ext wav --valid-percent 0.15 --n-split 2 --few-shot --leave-p-out --seed 42]
"""

from __future__ import annotations

import argparse
import os
import re
from typing import List

import numpy as np


def collect(root: str, ext: str, path_must_contain: str = ""):
    from animal2vec_tpu_torch.data.labels import audio_path_to_label_path, read_label_file
    from animal2vec_tpu_torch.data.wavio import wav_info

    ext_re = re.compile(rf".*\.{ext}$", re.IGNORECASE)
    labeled, label_sets, unlabeled = [], [], []
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            if not ext_re.match(path):
                continue
            if path_must_contain and path_must_contain not in path:
                continue
            frames = wav_info(path)["frames"]
            try:
                lp = audio_path_to_label_path(path)
                cats = read_label_file(lp).get("lbl_cat", np.zeros(0)) if os.path.isfile(lp) else np.zeros(0)
            except ValueError:
                cats = np.zeros(0)
            if len(cats) > 0:
                labeled.append((path, frames))
                label_sets.append(np.unique(np.asarray(cats, dtype=int)))
            else:
                unlabeled.append((path, frames))
    return labeled, label_sets, unlabeled


def indicator(label_sets: List[np.ndarray]) -> np.ndarray:
    n_classes = max((int(s.max()) for s in label_sets if s.size), default=-1) + 1
    y = np.zeros((len(label_sets), n_classes), dtype=bool)
    for i, s in enumerate(label_sets):
        y[i, s] = True
    return y


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", required=True)
    parser.add_argument("--dest", required=True)
    parser.add_argument("--ext", default="wav")
    parser.add_argument("--valid-percent", type=float, default=0.15)
    parser.add_argument("--n-split", type=int, default=1)
    parser.add_argument("--few-shot", action="store_true")
    parser.add_argument("--leave-p-out", action="store_true")
    parser.add_argument("--path-must-contain", default="")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    from animal2vec_tpu_torch.data.manifest import write_manifest
    from animal2vec_tpu_torch.data.stratify import (
        multilabel_stratified_kfold,
        multilabel_stratified_split,
    )

    root = os.path.realpath(args.root)
    labeled, label_sets, unlabeled = collect(root, args.ext, args.path_must_contain)
    assert labeled or unlabeled, "no audio files found"
    rel = lambda p: os.path.relpath(p, root)
    os.makedirs(args.dest, exist_ok=True)

    # pretrain = everything (scripts/animal2vec_manifest.py:209-217)
    all_entries = [(rel(p), f) for p, f in unlabeled + labeled]
    write_manifest(os.path.join(args.dest, "pretrain.tsv"), root, all_entries)
    print(f"pretrain.tsv: {len(all_entries)} files "
          f"({len(labeled)} labeled, {len(unlabeled)} unlabeled)")

    if labeled and args.valid_percent > 0:
        y = indicator(label_sets)
        folds = multilabel_stratified_kfold(
            y, args.n_split, args.valid_percent, seed=args.seed
        )
        for k, (train_idx, valid_idx) in enumerate(folds):
            tr = [(rel(labeled[i][0]), labeled[i][1]) for i in train_idx]
            va = [(rel(labeled[i][0]), labeled[i][1]) for i in valid_idx]
            write_manifest(os.path.join(args.dest, f"train_{k}.tsv"), root, tr)
            write_manifest(os.path.join(args.dest, f"valid_{k}.tsv"), root, va)
            print(f"fold {k}: {len(tr)} train / {len(va)} valid")
            if args.few_shot:
                # 1/10/25/50/75% stratified subsets (manifest.py:228-234)
                for j, frac in enumerate([0.01, 0.1, 0.25, 0.5, 0.75]):
                    sub, _ = multilabel_stratified_split(
                        y[train_idx], 1.0 - frac, seed=args.seed + j
                    )
                    entries = [
                        (rel(labeled[train_idx[i]][0]), labeled[train_idx[i]][1])
                        for i in sub
                    ]
                    write_manifest(
                        os.path.join(args.dest, f"train_{k}_few_{j}.tsv"), root, entries
                    )
                    print(f"  few_{j} ({frac:.0%}): {len(entries)} files")

    if args.leave_p_out and labeled:
        # group by source recording prefix; hold out ~20% of recordings
        rng = np.random.default_rng(args.seed)
        base = lambda p: os.path.basename(p)[:-18] if len(os.path.basename(p)) > 18 else os.path.basename(p)
        groups = sorted({base(p) for p, _ in labeled})
        p_count = max(1, round(0.2 * len(groups)))
        held = set(rng.choice(groups, p_count, replace=False).tolist())
        tr, va = [], []
        for p, f in labeled:
            (va if base(p) in held else tr).append((rel(p), f))
        write_manifest(os.path.join(args.dest, "train_lof.tsv"), root, tr)
        write_manifest(os.path.join(args.dest, "valid_lof.tsv"), root, va)
        pretrain_lof = tr + [(rel(p), f) for p, f in unlabeled if base(p) not in held]
        write_manifest(os.path.join(args.dest, "pretrain_lof.tsv"), root, pretrain_lof)
        print(f"leave-p-out: held {p_count} recordings -> {len(va)} valid clips")


if __name__ == "__main__":
    main()
