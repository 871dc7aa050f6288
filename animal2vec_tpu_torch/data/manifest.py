"""Manifest (tsv) IO: first line = root dir, then ``relpath\\tnum_frames``
(the fairseq manifest convention). A copy of
``animal2vec_tpu/data/manifest.py``."""

from __future__ import annotations

import os
from typing import List, Tuple


def read_manifest(path: str) -> Tuple[str, List[Tuple[str, int]]]:
    with open(path) as f:
        root = f.readline().strip()
        entries = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            assert len(parts) == 2, f"malformed manifest line: {line!r}"
            entries.append((parts[0], int(parts[1])))
    return root, entries


def write_manifest(path: str, root: str, entries: List[Tuple[str, int]]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        print(root, file=f)
        for rel, frames in entries:
            print(f"{rel}\t{frames}", file=f)
