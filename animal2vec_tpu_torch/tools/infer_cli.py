"""Long-file inference CLI: wav -> per-class [onset, offset, likelihood].

The port of ``animal2vec_tpu/tools/infer_cli.py``: chunk an arbitrarily long
recording into windows, batched forward, sigmoid frame probabilities, fuse
into events with absolute timestamps.

Usage:
  python -m animal2vec_tpu_torch.tools.infer_cli --wav rec.wav \
      (--weights params.npz | --checkpoint <dir>) \
      [--method avg --threshold 0.175 --out events.json] [field=value ...]

``params.npz`` holds the JAX FinetuneModel params keyed by their "/"-joined
paths; ``--checkpoint`` reads a finetune checkpoint of this package (a
manager's directory, a ``step_*`` directory or ``best``, as
``tools/train_cli.py`` writes them). ``field=value`` overrides fields of the
a2v-large preset
(``animal2vec_tpu_torch.config.FinetuneConfig``), e.g. ``matmul_impl=int8``
or ``matmul_impl=int8_attn`` for the int8 serving numerics.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from animal2vec_tpu_torch.evalx.segmentation import fuse_predict
from animal2vec_tpu_torch.config import FinetuneConfig, apply_overrides
from animal2vec_tpu_torch.data.wavio import read_wav
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.ops.audio import chunk_and_normalize
from animal2vec_tpu_torch.weights import load_params_npz, params_from_jax, serving_cast


def window_probabilities(model: FinetuneModel, batch: np.ndarray,
                         device: torch.device) -> np.ndarray:
    """(B, T_wav) windows -> (B, T, n_classes) fp32 sigmoid probabilities."""
    src = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    with torch.inference_mode():
        logits = model(src)["encoder_out"]
        return torch.sigmoid(logits.float()).cpu().numpy()


def infer_long_file(
    wav_path: str,
    model: FinetuneModel,
    cfg: FinetuneConfig,
    method: str = "avg",
    threshold: Optional[float] = None,
    max_batch_size: int = 16,
    segment_length: Optional[float] = None,
    device: Optional[torch.device] = None,
) -> dict:
    """Events {label: [{"onset_s", "offset_s", "likelihood"}, ...]} for one
    recording. ``segment_length`` defaults to ``cfg.segment_length``; the
    model runs on ``device`` (default: where its parameters are)."""
    if device is None:
        device = next(model.parameters()).device
    if segment_length is None:
        segment_length = cfg.segment_length
    wav, sr = read_wav(wav_path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    if sr != cfg.sample_rate:
        raise ValueError(f"resample {wav_path} to {cfg.sample_rate} Hz first (got {sr})")
    batches = chunk_and_normalize(wav, segment_length, sr, cfg.normalize, max_batch_size)
    md = cfg.criterion(threshold)
    sample_size = round(segment_length * sr)
    events = {name: [] for name in cfg.labels}
    first_bs = batches[0].shape[0]
    for bi, batch in enumerate(batches):
        probs = window_probabilities(model, batch, device)
        ti, _, li = fuse_predict(
            sample_size, probs, md, sr, method=method, multiplier=bi, bs=first_bs
        )
        for b in range(len(ti)):
            for ci, name in enumerate(cfg.labels):
                for (on, off), like in zip(ti[b][ci], li[b][ci]):
                    events[name].append(
                        {"onset_s": round(on, 4), "offset_s": round(off, 4),
                         "likelihood": round(like, 4)}
                    )
    return events


def load_finetuned(weights: str, cfg: FinetuneConfig, device: torch.device,
                   checkpoint: bool = False) -> FinetuneModel:
    """FinetuneModel computing in bf16 from an npz of JAX params, or with
    ``checkpoint`` from a finetune checkpoint directory of this package,
    weights stored as ``serving_cast`` leaves them; with ``cfg.matmul_impl``
    int8 the load quantizes them (from the bf16 weights, as JAX serving
    quantizes its cast tree)."""
    if checkpoint:
        from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir

        sd = load_checkpoint_dir(weights)["model"]
    else:
        sd = params_from_jax(load_params_npz(weights))
    model = FinetuneModel(cfg, dtype=torch.bfloat16)
    model.load_state_dict(serving_cast(sd), strict=True, assign=True)
    return model.to(device).eval()


def parse_overrides(cfg: FinetuneConfig, overrides) -> FinetuneConfig:
    """``cfg`` with ``field=value`` overrides (``config.apply_overrides``)."""
    return apply_overrides(cfg, overrides)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--wav", required=True)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--weights", help="npz of JAX FinetuneModel params")
    source.add_argument("--checkpoint", help="finetune checkpoint directory of this package")
    parser.add_argument("--method", default="avg", choices=["avg", "max", "canny"])
    parser.add_argument("--threshold", type=float, default=None)
    parser.add_argument("--max-batch-size", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = parse_overrides(FinetuneConfig(), args.overrides)
    device = torch.device(args.device)
    model = load_finetuned(args.checkpoint or args.weights, cfg, device,
                           checkpoint=bool(args.checkpoint))
    events = infer_long_file(
        args.wav, model, cfg, method=args.method, threshold=args.threshold,
        max_batch_size=args.max_batch_size, device=device,
    )
    payload = json.dumps(events, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        total = sum(len(v) for v in events.values())
        print(f"wrote {total} events to {args.out}")
    else:
        print(payload)
    return events


if __name__ == "__main__":
    main()
