"""Serve the seeded a2v-large model of ``chip_smoke.py`` phases 5-7 in this
checkout and in another (for example an archive of the parent commit), each
tree in its own process, in turns (other, this, this, other): a digest of
the b32 logits' bits in bf16, ``int8`` and ``int8_attn`` (equal in two trees
whose serving outputs agree bit for bit) and the b32 clips/s of each mode
(CUDA-synchronized host clock over 5 forwards after 2, as phase 7). The
weights come from seed 0 on the host and the batch from numpy seed 2, so
both trees see the same ones. Prints the card's name and power limit.

    python3 -m animal2vec_tpu_torch.tools.compare_serving --other-root DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

THIS_ROOT = Path(__file__).resolve().parents[2]
ORDER = ("other", "this", "this", "other")
MODES = ("bf16", "int8", "int8_attn")
BATCH, WAV_LEN = 32, 80_000


def measure(label: str) -> None:
    """The measurements of the package importable from sys.path."""
    from animal2vec_tpu_torch.config import FinetuneConfig
    from animal2vec_tpu_torch.models.finetune import FinetuneModel, build_finetune_model
    from animal2vec_tpu_torch.weights import serving_cast

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = FinetuneConfig()
    base = build_finetune_model(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    base.load_state_dict(serving_cast(base.state_dict()), strict=True, assign=True)
    src = torch.from_numpy(np.random.default_rng(2).normal(size=(BATCH, WAV_LEN))
                           .astype(np.float32)).to(dev)
    for mode in MODES:
        if mode == "bf16":
            model = base
        else:
            model = FinetuneModel(dataclasses.replace(cfg, matmul_impl=mode), torch.bfloat16)
            model.load_state_dict(base.state_dict(), strict=True, assign=True)
            model = model.to(dev).eval()
        with torch.inference_mode():
            logits = model(src)["encoder_out"]
            model(src)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                model(src)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 5
        digest = hashlib.sha256(logits.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                ).hexdigest()[:16]
        print(f"{label} {mode} b{BATCH}: logits sha256 {digest}, {BATCH / dt:.2f} 10-s clips/s "
              f"({dt * 1e3:.1f} ms per batch)", flush=True)
        if model is not base:
            del model
            torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other-root", help="the other checkout's root")
    parser.add_argument("--root", help=argparse.SUPPRESS)  # one tree, in this process
    parser.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_serving: needs a CUDA card")
    if args.root:
        sys.path.insert(0, args.root)
        measure(args.label)
        return
    if not args.other_root:
        parser.error("--other-root is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    roots = {"this": str(THIS_ROOT), "other": str(Path(args.other_root).resolve())}
    for label in ORDER:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--root", roots[label], "--label",
               label]
        subprocess.run(cmd, check=True, cwd=roots[label])


if __name__ == "__main__":
    main()
