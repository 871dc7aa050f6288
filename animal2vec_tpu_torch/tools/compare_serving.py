"""Serve the seeded a2v-large model of ``chip_smoke.py`` phases 5-7 in this
checkout and in another (for example an archive of the parent commit), each
tree in its own process, in turns (other, this, this, other): a digest of
the b32 logits' bits in bf16, ``int8`` and ``int8_attn`` (equal in two trees
whose serving outputs agree bit for bit) and the b32 clips/s of each mode
(CUDA-synchronized host clock over 5 forwards after 2, as phase 7); then
the same of the bf16 ViT-B/16 image model's b64 features (phase 9's model,
post-LN and pre-LN) and its images/s. The weights come from seed 0 on the
host and the batches from numpy seeds 2 and 11, so both trees see the same
ones. Prints the card's name and power limit.

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
IMAGE_BATCH = 64


def digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def timed(fn) -> float:
    """Seconds per call of fn: CUDA-synchronized host clock over 5 calls
    after 2."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 5


def measure_image(label: str, dev) -> None:
    """The bf16 ViT-B/16 image model's b64 features, post-LN and pre-LN."""
    from animal2vec_tpu_torch.config import ImageConfig
    from animal2vec_tpu_torch.models.finetune import build_image_model
    from animal2vec_tpu_torch.weights import serving_cast

    imgs = torch.from_numpy(np.random.default_rng(11).normal(size=(IMAGE_BATCH, 224, 224, 3))
                            .astype(np.float32)).to(dev)
    for pre_ln in (False, True):
        cfg = dataclasses.replace(ImageConfig(), use_alibi_encoder=True, layer_norm_first=pre_ln)
        model = build_image_model(cfg, dtype=torch.bfloat16, seed=0, device=dev)
        model.load_state_dict(serving_cast(model.state_dict()), strict=True, assign=True)
        with torch.inference_mode():
            x = model.extract_features(imgs, "IMAGE")["x"]
            dt = timed(lambda: model.extract_features(imgs, "IMAGE"))
        print(f"{label} ViT-B/16 {'pre-LN' if pre_ln else 'post-LN'} bf16 b{IMAGE_BATCH}: "
              f"features sha256 {digest(x)}, {IMAGE_BATCH / dt:.1f} images/s "
              f"({dt * 1e3:.2f} ms per forward)", flush=True)
        del model
        torch.cuda.empty_cache()


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
            dt = timed(lambda: model(src))
        print(f"{label} {mode} b{BATCH}: logits sha256 {digest(logits)}, {BATCH / dt:.2f} 10-s "
              f"clips/s ({dt * 1e3:.1f} ms per batch)", flush=True)
        if model is not base:
            del model
            torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    measure_image(label, dev)


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
