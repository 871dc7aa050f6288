"""Serving-bundle CLI: a finetuned model -> an exported inference bundle. The
port of ``animal2vec_tpu/tools/aot_cli.py``.

Exports the finetuned frame-logit forward at a fixed batch x wav_len (and
further shapes with ``--shape``) through ``torch.export`` with the weights
in ``params.npz`` beside it (``serve.py``). A serving process then needs
torch, numpy and ``animal2vec_tpu_torch.kernels.ops``, no model code:

  python -m animal2vec_tpu_torch.tools.aot_cli \\
      (--weights params.npz | --checkpoint ckpt_dir) --out bundle_dir \\
      [--batch 16] [--seconds 10] [--shape 32x5 ...] [--device cuda] [field=value ...]

  # later, on a machine with the same device type:
  from animal2vec_tpu_torch.serve import ServingBundle
  probs = ServingBundle("bundle_dir").predict_probs(batch)

The weights are served as ``infer_cli`` loads them (bf16 after the serving
cast; ``matmul_impl=int8`` or ``int8_attn`` quantizes them at load). A bundle
exported on the card calls the CUDA kernels; ``--device cpu`` exports one
that runs their plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--weights", help="npz of JAX FinetuneModel params")
    source.add_argument("--checkpoint", help="finetune checkpoint directory of this package")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=None,
                        help="clip length in seconds (default: max_sample_size)")
    parser.add_argument(
        "--shape", action="append", default=None, metavar="BATCHxSECONDS",
        help="extra (batch x seconds) entries, repeatable: one exported program per shape in "
        "the same bundle (e.g. --shape 32x5 for a short-clip bucket)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from animal2vec_tpu_torch.config import FinetuneConfig
    from animal2vec_tpu_torch.serve import export_serving
    from animal2vec_tpu_torch.tools.infer_cli import load_finetuned, parse_overrides

    cfg = parse_overrides(FinetuneConfig(), args.overrides)
    model = load_finetuned(args.checkpoint or args.weights, cfg, torch.device(args.device),
                           checkpoint=bool(args.checkpoint))
    wav_len = int(args.seconds * cfg.sample_rate) if args.seconds else None
    shapes = None
    if args.shape:
        base = wav_len or int(cfg.max_sample_size or 10 * cfg.sample_rate)
        shapes = [(args.batch, base)]
        for s in args.shape:
            b, sec = s.lower().split("x")
            shapes.append((int(b), int(float(sec) * cfg.sample_rate)))
    t0 = time.perf_counter()
    out = export_serving(model, args.out, batch_size=args.batch, wav_len=wav_len, shapes=shapes)
    print(f"serving bundle written to {out} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
