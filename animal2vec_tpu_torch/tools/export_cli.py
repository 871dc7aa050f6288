"""Batch eval + embedding/prediction export over a manifest split: the port of
``animal2vec_tpu/tools/export_cli.py`` (the reference's
``get_results_for_single_manifest_split.py``).

Runs the finetuned model over every clip of a split and exports per-clip
likelihoods, segmented likelihoods and targets, and the layer-averaged
embeddings, one group per clip index holding its source file name:

* ``predictions_FinetuneModel_<tag>.h5``: ``fname``, ``likelihood``,
  ``segmented_likelihood`` and ``segmented_target`` (without
  ``--use-softmax``), ``target``;
* ``embeddings_FinetuneModel_<tag>.h5``: ``fname``, ``embedding`` (the fp32
  mean of the taps ``--average-start-k-layers`` to
  ``--average-end-k-layers``), ``target``;

with ``<tag>`` = ``<start>_<end>_<split>_<checkpoint name>``. HDF5 goes
through h5py, as in JAX; ``--output-format npz`` writes the same groups and
datasets to ``.npz`` files instead (entries ``<group>/<dataset>``, written
as they come), for machines without h5py.

Each batch is split over ``--data-parallel`` devices (``parallel/
serving.py``); ``--batch-size`` is a memory cap, floored to a device
multiple. The last line is a JSON object with the aggregate clips/s of the
forward and the sigmoid (host to device, the model, device to host), real
clips only (the loader's repeated tail rows excluded), the first batch
(warm-up) excluded.

Usage:
  python -m animal2vec_tpu_torch.tools.export_cli --manifest-path dir \\
      --split valid_0 (--weights params.npz | --checkpoint ckpt) --out-path out \\
      [--export-embeddings] [--export-predictions] [--data-parallel -1] \\
      [--average-start-k-layers 0 --average-end-k-layers 16] [--label-ext h5] \\
      [--output-format h5] [--dtype bfloat16] [--device cuda] [field=value ...]

``field=value`` overrides fields of ``config.FinetuneConfig`` as
``infer_cli`` takes them (``max_sample_size=80000``, ``matmul_impl=int8``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zipfile

import numpy as np
import torch

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.data.dataset import AudioLabelDataset, BatchLoader
from animal2vec_tpu_torch.evalx.segmentation import (
    intervals_from_binary, segmented_probs_and_targets,
)
from animal2vec_tpu_torch.parallel.serving import DataParallelServing, gather
from animal2vec_tpu_torch.tools.infer_cli import load_finetuned, parse_overrides, serving_devices


class H5Groups:
    """Groups of datasets in an HDF5 file (h5py)."""

    def __init__(self, path: str):
        import h5py

        self.file = h5py.File(path, "w")

    def write(self, group: str, name: str, value) -> None:
        self.file.require_group(group).create_dataset(name, data=value)

    def close(self) -> None:
        self.file.close()


class NpzGroups:
    """The same groups as ``.npz`` entries ``<group>/<name>``, each written to
    the archive as it comes (``np.load`` reads them back)."""

    def __init__(self, path: str):
        self.zip = zipfile.ZipFile(path, "w", allowZip64=True)

    def write(self, group: str, name: str, value) -> None:
        with self.zip.open(f"{group}/{name}.npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(value), allow_pickle=False)

    def close(self) -> None:
        self.zip.close()


WRITERS = {"h5": H5Groups, "npz": NpzGroups}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def forward_outputs(model, src, start: int, end: int, use_softmax: bool):
    """(probabilities fp32, fp32 mean of the taps start:end) on the model's
    device for (B, T_wav) windows ``src``."""
    with torch.inference_mode():
        out = model(src)
        logits = out["encoder_out"].float()
        probs = torch.softmax(logits, dim=-1) if use_softmax else torch.sigmoid(logits)
        taps = out["layer_results"][start:end]
        emb = torch.stack([t.float() for t in taps]).mean(dim=0) if taps else None
        return probs, emb


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--manifest-path", required=True)
    parser.add_argument("--split", default="valid_0")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--weights", help="npz of JAX FinetuneModel params")
    source.add_argument("--checkpoint", help="finetune checkpoint directory of this package")
    parser.add_argument("--out-path", required=True)
    parser.add_argument("--batch-size", type=int, default=12)
    parser.add_argument("--export-embeddings", action="store_true")
    parser.add_argument("--export-predictions", action="store_true")
    parser.add_argument("--average-start-k-layers", type=int, default=0)
    parser.add_argument("--average-end-k-layers", type=int, default=16)
    parser.add_argument("--method", default="avg")
    parser.add_argument("--use-softmax", action="store_true")
    parser.add_argument(
        "--data-parallel", type=int, default=-1,
        help="shard each batch over this many CUDA devices (-1 = all visible); --batch-size "
        "is a memory cap, floored to a device multiple (it grows only below one row per "
        "device); on --device cpu the CPU alone")
    parser.add_argument("--label-ext", default="h5", choices=["h5", "npz"],
                        help="the label files' format (task.label_ext)")
    parser.add_argument("--output-format", default="h5", choices=sorted(WRITERS))
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                        help="compute dtype (bfloat16: the serving cast's weights)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    return run(parser.parse_args(argv))


def run(args):
    """The export of parsed ``args``; returns the throughput line's dict (None
    with one batch)."""
    cfg = parse_overrides(FinetuneConfig(), args.overrides)
    device = torch.device(args.device)
    checkpoint = args.checkpoint or args.weights
    model = load_finetuned(checkpoint, cfg, device, checkpoint=bool(args.checkpoint),
                           dtype=DTYPES[args.dtype])
    os.makedirs(args.out_path, exist_ok=True)

    dp = DataParallelServing(model, args.data_parallel, serving_devices(device))
    batch_size = dp.floor_batch(args.batch_size)
    if batch_size != args.batch_size:
        print(f"batch size {args.batch_size} -> {batch_size} ({dp.n_devices}-device "
              "data-parallel layout" + (", minimum one row per device"
                                         if batch_size > args.batch_size else "") + ")")

    ds = AudioLabelDataset(
        os.path.join(args.manifest_path, f"{args.split}.tsv"),
        sample_rate=cfg.sample_rate,
        min_sample_size=1612,
        normalize=cfg.normalize,
        return_labels=True,
        unique_labels=cfg.labels,
        use_focal_loss=True,
        conv_layers=cfg.conv_layers,
        label_ext=args.label_ext,
    )
    # pad/crop length follows the config (the reference uses the dataset's
    # max_sample_size, nn/audio_tasks.py:392-394); default 10 s
    target_len = cfg.max_sample_size or 10 * cfg.sample_rate
    loader = BatchLoader(ds, target_len=target_len, batch_size=batch_size, shuffle=False,
                         train=False, drop_last=False, num_workers=2,
                         batch_multiple=dp.n_devices)

    md = cfg.criterion()
    tag = "{}_{}_{}_{}".format(args.average_start_k_layers, args.average_end_k_layers,
                               args.split, os.path.basename(os.path.normpath(checkpoint)))
    ext = args.output_format
    writer = WRITERS[ext]
    f_pred = (writer(os.path.join(args.out_path, f"predictions_FinetuneModel_{tag}.{ext}"))
              if args.export_predictions else None)
    f_emb = (writer(os.path.join(args.out_path, f"embeddings_FinetuneModel_{tag}.{ext}"))
             if args.export_embeddings else None)
    start, end = args.average_start_k_layers, args.average_end_k_layers

    def fn(replica, src):
        return forward_outputs(replica, src, start, end, args.use_softmax)

    n_written = 0
    n_clips_timed = 0
    fwd_seconds = 0.0
    try:
        for n_batch, batch in enumerate(loader):
            t0 = time.perf_counter()
            shards = dp.shard(batch["source"])
            outs = dp.map(fn, shards)
            probs = gather([o[0] for o in outs]).numpy()
            # true item count: the loader pads the final short group by
            # repeating items; padded rows are neither exported (their ids
            # duplicate real rows) nor counted in the throughput line
            n_valid = int(batch.get("n_valid", probs.shape[0]))
            if n_batch > 0:  # the first batch pays the warm-up
                fwd_seconds += time.perf_counter() - t0
                n_clips_timed += n_valid
            targets = batch["target"].numpy()
            ids = batch["id"].numpy().ravel()[:n_valid]
            if f_pred is not None:
                if not args.use_softmax:
                    seg_idx = [
                        [intervals_from_binary(targets[b, :, c]) for c in range(targets.shape[-1])]
                        for b in range(targets.shape[0])
                    ]
                    pr, ta, *_ = segmented_probs_and_targets(
                        targets, seg_idx, probs, md, cfg.sample_rate, target_len,
                        method=args.method)
                    bs, tdim = probs.shape[0], probs.shape[1]
                    seg_like = pr.reshape(bs, tdim, -1)
                    seg_tar = ta.reshape(bs, tdim, -1)
                else:
                    seg_like, seg_tar = probs.copy(), targets.copy()
                assert probs.shape == targets.shape == seg_like.shape == seg_tar.shape
                for i, idx in enumerate(ids):
                    group = f"{int(idx):06.0f}"
                    f_pred.write(group, "fname", ds.names[int(idx)])
                    f_pred.write(group, "likelihood", probs[i].astype(np.float32))
                    if not args.use_softmax:
                        f_pred.write(group, "segmented_likelihood", seg_like[i].astype(np.float32))
                        f_pred.write(group, "segmented_target", seg_tar[i].astype(np.float32))
                    f_pred.write(group, "target", targets[i].astype(np.float32))
                    n_written += 1
            if f_emb is not None:
                emb = gather([o[1] for o in outs]).numpy()
                assert emb.shape[:2] == targets.shape[:2]
                for i, idx in enumerate(ids):
                    group = f"{int(idx):06.0f}"
                    f_emb.write(group, "fname", ds.names[int(idx)])
                    f_emb.write(group, "embedding", emb[i].astype(np.float32))
                    f_emb.write(group, "target", targets[i].astype(np.float32))
    finally:
        for f in (f_pred, f_emb):
            if f is not None:
                f.close()
    print(f"exported {n_written} clips to {args.out_path}")
    result = None
    if fwd_seconds > 0:
        agg = n_clips_timed / fwd_seconds
        print(f"aggregate eval throughput (transfer+forward+sigmoid): {agg:.1f} clips/s over "
              f"{dp.n_devices} device(s) ({agg / dp.n_devices:.1f} clips/s/device)")
        result = {
            "metric": "manifest eval aggregate throughput",
            "clips_per_sec": round(agg, 2),
            "devices": dp.n_devices,
            "clips_per_sec_per_chip": round(agg / dp.n_devices, 2),
            "clips_timed": n_clips_timed,
        }
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
