"""Raw-recording segmentation: long recordings + label table -> 10-s wav/lbl
tree. A copy of ``animal2vec_tpu/tools/prepare_data_cli.py`` over the port's
data modules.

Mirrors scripts/prepare_arb_data_for_audio_pretraining.py: split each
recording into fixed-length segments, resample to the target rate
(scipy polyphase instead of librosa), pick the meerkat channel for stereo
files, intersect the label table with each segment window, and write the
wav/<rate>/ + lbl/<rate>/ tree (optionally with randomized file names and a
name-mapping json). The label table is a CSV with columns
AudioFile,StartRelative,EndRelative,Name,Focal (seconds).

Usage:
  python -m animal2vec_tpu_torch.tools.prepare_data_cli --input-folder recs \
      --output-folder out --labels labels.csv \
      --unique-labels "['beep',...]" [--segment-length 10 --resample-rate 8000]
"""

from __future__ import annotations

import argparse
import ast
import json
import math
import os
import string
from typing import Dict, List, Optional


def resample(wav, orig_sr: int, target_sr: int):
    import numpy as np
    from scipy.signal import resample_poly

    if orig_sr == target_sr:
        return wav
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def load_label_table(path: str):
    import csv

    table: Dict[str, List[dict]] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            table.setdefault(row["AudioFile"], []).append(
                {
                    "start": float(row["StartRelative"]),
                    "end": float(row["EndRelative"]),
                    "name": row["Name"],
                    "focal": str(row.get("Focal", "")).lower() == "focal",
                }
            )
    return table


def segment_file(
    path: str,
    out_wav_dir: str,
    out_lbl_dir: str,
    labels: List[dict],
    unique_labels: List[str],
    segment_length: float,
    resample_rate: int,
    channel: int = 0,
    randomize: bool = False,
    rng=None,
    used_names: Optional[set] = None,
) -> List[dict]:
    import numpy as np

    from animal2vec_tpu_torch.data.labels import write_label_file
    from animal2vec_tpu_torch.data.wavio import read_wav, write_wav

    wav, sr = read_wav(path)
    if wav.ndim == 2:
        wav = wav[:, channel]
    if len(wav) == 0:
        return []
    wav = resample(wav, sr, resample_rate)
    seg_n = int(segment_length * resample_rate)
    base = os.path.basename(path)[:-4]
    os.makedirs(out_wav_dir, exist_ok=True)
    os.makedirs(out_lbl_dir, exist_ok=True)
    mapping = []
    n_segments = len(wav) // seg_n
    for si in range(n_segments):
        lo, hi = si * seg_n, (si + 1) * seg_n
        from_sec, to_sec = lo / resample_rate, hi / resample_rate
        fname = f"{base}_{from_sec:05.0f}s_{to_sec:05.0f}s"
        if randomize:
            alphabet = string.ascii_letters + string.digits
            new = "".join(rng.choice(list(alphabet)) for _ in range(32))
            while used_names is not None and new in used_names:
                new = "".join(rng.choice(list(alphabet)) for _ in range(32))
            if used_names is not None:
                used_names.add(new)
            mapping.append({"random": new, "original": fname})
            fname = new
        write_wav(os.path.join(out_wav_dir, fname + ".wav"), wav[lo:hi], resample_rate)
        st, sf, et, ef, ln, lc, fo = [], [], [], [], [], [], []
        for lab in labels:
            s, e = lab["start"], lab["end"]
            if s < from_sec < e or s < to_sec < e or (from_sec < s < e < to_sec):
                rs = max(s - from_sec, 0.0)
                re_ = min(e - from_sec, segment_length)
                st.append(rs)
                sf.append(int(np.floor(rs * resample_rate)) if rs > 0 else 0)
                et.append(re_)
                ef.append(int(np.ceil(re_ * resample_rate)))
                ln.append(lab["name"])
                lc.append(unique_labels.index(lab["name"]))
                fo.append(1 if lab["focal"] else 0)
        write_label_file(
            os.path.join(out_lbl_dir, fname + ".h5"), st, sf, et, ef, ln, lc, fo
        )
    return mapping


def main(argv=None):
    import numpy as np

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input-folder", required=True)
    parser.add_argument("--output-folder", required=True)
    parser.add_argument("--labels", default="", help="label table csv")
    parser.add_argument("--unique-labels", required=True)
    parser.add_argument("--segment-length", type=float, default=10.0)
    parser.add_argument("--resample-rate", type=int, default=8000)
    parser.add_argument("--base-name", default="dataset")
    parser.add_argument("--randomize-file-names", action="store_true")
    parser.add_argument("--channel", type=int, default=0)
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)

    unique_labels = list(ast.literal_eval(args.unique_labels))
    table = load_label_table(args.labels) if args.labels else {}
    out_root = os.path.join(args.output_folder, f"{args.base_name}_{args.segment_length:02.0f}s")
    rate_dir = f"{args.resample_rate:05.0f}Hz"
    out_wav = os.path.join(out_root, "wav", rate_dir)
    out_lbl = os.path.join(out_root, "lbl", rate_dir)

    files = []
    for dirpath, _, names in os.walk(args.input_folder):
        files.extend(
            os.path.join(dirpath, n) for n in sorted(names) if n.lower().endswith(".wav")
        )
    print(f"segmenting {len(files)} recordings -> {out_root}")
    rng = np.random.default_rng(0)
    used: set = set()
    mapping = []
    from concurrent.futures import ThreadPoolExecutor

    def work(path):
        return segment_file(
            path, out_wav, out_lbl,
            table.get(os.path.basename(path), []),
            unique_labels, args.segment_length, args.resample_rate,
            channel=args.channel, randomize=args.randomize_file_names,
            rng=rng, used_names=used,
        )

    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for m in pool.map(work, files):
            mapping.extend(m)
    if args.randomize_file_names:
        with open(os.path.join(out_root, "name_mapping.json"), "w") as f:
            json.dump(mapping, f)
    print("done")


if __name__ == "__main__":
    main()
