"""Long-file inference CLI: wav -> per-class [onset, offset, likelihood].

The port of ``animal2vec_tpu/tools/infer_cli.py``: chunk an arbitrarily long
recording into windows, batched forward, sigmoid frame probabilities, fuse
into events with absolute timestamps.

Usage:
  python -m animal2vec_tpu_torch.tools.infer_cli --wav rec.wav \
      (--weights params.npz | --checkpoint <dir>) [--data-parallel -1] \
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
from animal2vec_tpu_torch.config import FinetuneConfig, apply_overrides, check_card_dtype
from animal2vec_tpu_torch.data.wavio import read_wav
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.ops.audio import chunk_and_normalize
from animal2vec_tpu_torch.parallel.serving import DataParallelServing
from animal2vec_tpu_torch.weights import load_params_npz, params_from_jax, serving_cast


def sigmoid_probabilities(model: FinetuneModel, src: torch.Tensor) -> torch.Tensor:
    """(B, T_wav) windows on the model's device -> (B, T, n_classes) fp32
    sigmoid probabilities there."""
    with torch.inference_mode():
        return torch.sigmoid(model(src)["encoder_out"].float())


def window_probabilities(model: FinetuneModel, batch: np.ndarray,
                         device: torch.device) -> np.ndarray:
    """(B, T_wav) windows -> (B, T, n_classes) fp32 sigmoid probabilities."""
    src = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    return sigmoid_probabilities(model, src).cpu().numpy()


def serving_devices(device: torch.device, devices=None):
    """The devices a data-parallel run spreads over: ``devices`` where
    given, else every CUDA device (``device`` first) for a model on the
    card, or ``device`` alone."""
    if devices is not None:
        return devices
    return None if device.type == "cuda" else [device]


def infer_long_file(
    wav_path: str,
    model: FinetuneModel,
    cfg: FinetuneConfig,
    method: str = "avg",
    threshold: Optional[float] = None,
    max_batch_size: int = 16,
    segment_length: Optional[float] = None,
    device: Optional[torch.device] = None,
    data_parallel: int = 1,
    devices=None,
) -> dict:
    """Events {label: [{"onset_s", "offset_s", "likelihood"}, ...]} for one
    recording. ``segment_length`` defaults to ``cfg.segment_length``; the
    model runs on ``device`` (default: where its parameters are).
    ``data_parallel``: shard each window batch over this many devices (-1 =
    all of ``serving_devices``; ``parallel/serving.py``); the batch size is
    floored to a device multiple and the final partial batch zero-padded,
    its padded rows dropped before event fusing, so the events do not depend
    on the device count."""
    if device is None:
        device = next(model.parameters()).device
    if segment_length is None:
        segment_length = cfg.segment_length
    dp = DataParallelServing(model, data_parallel, serving_devices(device, devices))
    # floor, not ceil: --max-batch-size is a memory cap the user tuned
    max_batch_size = dp.floor_batch(max_batch_size)
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
        shards, n_valid = dp.pad_and_shard(batch)
        probs = dp.run(sigmoid_probabilities, shards).numpy()[:n_valid]
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
                   checkpoint: bool = False, dtype: torch.dtype = torch.bfloat16
                   ) -> FinetuneModel:
    """FinetuneModel from an npz of JAX params, or with ``checkpoint`` from
    a finetune checkpoint directory of this package (``convert_cli import``
    writes one from a fairseq ``.pt``), on ``device`` (raises for a card
    that is not there). It computes in bf16 with the weights stored as
    ``serving_cast`` leaves them (``dtype`` float32 keeps the fp32 weights
    and computes in fp32); with ``cfg.matmul_impl`` int8 the load quantizes
    them (from the bf16 weights, as JAX serving quantizes its cast tree)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_finetuned: CUDA is not available; pass --device cpu to serve "
                           "on the CPU")
    if checkpoint:
        from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir

        sd = load_checkpoint_dir(weights)["model"]
    else:
        sd = params_from_jax(load_params_npz(weights))
    check_card_dtype(cfg, str(dtype).removeprefix("torch."), device.type)
    model = FinetuneModel(cfg, dtype=dtype)
    if dtype == torch.bfloat16:
        sd = serving_cast(sd)
    model.load_state_dict(sd, strict=True, assign=True)
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
    parser.add_argument(
        "--data-parallel", type=int, default=-1,
        help="shard each window batch over this many CUDA devices (-1 = all visible, 1 = the "
        "one of --device); on --device cpu the CPU alone")
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
        max_batch_size=args.max_batch_size, device=device, data_parallel=args.data_parallel,
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
