"""Checkpoint converter CLI: fairseq animal2vec ``.pt`` <-> this package. The
port of ``animal2vec_tpu/tools/convert_cli.py``.

Import: load the fairseq checkpoint (classes that cannot be imported load as
stubs: only the tensors are needed), map its names and layouts onto the
port's state dict (``train/convert.py``), check every tensor against a
freshly initialized model of the configuration, and write a checkpoint of
this package (``train/checkpoint.py``, step 0). A finetune checkpoint is
served by ``infer_cli``, ``export_cli`` and ``aot_cli --checkpoint``; a
pretraining one (with its EMA teacher where the ``.pt`` has ``_ema``) starts
``train_cli --pretrained``.

Export: write a fairseq-named state dict (an npz of torch-layout arrays)
from a checkpoint of this package, for the reference's tooling.

Usage:
  python -m animal2vec_tpu_torch.tools.convert_cli import --pt model.pt \\
      --out ckpt_dir [--kind auto|finetune|pretrain] [--strict] [key=value ...]
  python -m animal2vec_tpu_torch.tools.convert_cli export --checkpoint ckpt_dir \\
      --out state_dict.npz [key=value ...]

``key=value`` overrides change the fields of ``config.FinetuneConfig`` for a
finetune checkpoint (``depth=4``) or of ``config.PretrainConfig`` for a
pretraining one (``model.depth=4``, ``decoder.decoder_layers=2``). The
conversion is file work on the host: it runs no model.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from animal2vec_tpu_torch.config import FinetuneConfig, PretrainConfig, apply_overrides


def do_import(args) -> int:
    from animal2vec_tpu_torch.models.finetune import build_finetune_model, build_pretrain_model
    from animal2vec_tpu_torch.train.checkpoint import CheckpointManager
    from animal2vec_tpu_torch.train.convert import (
        finetune_state_dict, load_torch_checkpoint, pretrain_state_dicts, state_dict_to_numpy,
        verify_tree_shapes,
    )

    state = load_torch_checkpoint(args.pt)
    sd = state_dict_to_numpy(state.get("model", state))
    kind = args.kind
    if kind == "auto":
        kind = "finetune" if any(k.startswith("w2v_encoder.") for k in sd) else "pretrain"
    print(f"loaded {len(sd)} tensors from {args.pt} (kind={kind})")

    ema = None
    if kind == "finetune":
        cfg = apply_overrides(FinetuneConfig(), args.overrides)
        converted = finetune_state_dict(sd, cfg)
        ref = build_finetune_model(cfg, device="cpu").state_dict()
    else:
        pcfg = apply_overrides(PretrainConfig(), args.overrides)
        converted, ema = pretrain_state_dicts(
            sd, pcfg.model, *(None if d is None else d.decoder_layers
                              for d in (pcfg.decoder, pcfg.shared_decoder)))
        ref = build_pretrain_model(pcfg, device="cpu").state_dict()
    missing, unexpected, mismatched = verify_tree_shapes(converted, ref)
    for name, items in (("missing", missing), ("unexpected", unexpected),
                        ("mismatched", mismatched)):
        if items:
            print(f"{name} ({len(items)}):")
            for p in items[:20]:
                print("   ", ".".join(p))
    if args.strict and (missing or unexpected or mismatched):
        print("strict mode: conversion incomplete", file=sys.stderr)
        return 1
    # fill anything missing from the fresh init so the state dict loads
    full = {k: converted.get(k, v) for k, v in ref.items()}
    mgr = CheckpointManager(args.out, keep_last=1)
    mgr.save_snapshot(0, {"step": 0, "model": full,
                          "optimizer": {"count": 0, "mu": {}, "nu": {}},
                          "ema": ema, "extra": {"converted_from": args.pt, "kind": kind}})
    mgr.wait()
    print(f"wrote converted checkpoint to {args.out}")
    return 0


def do_export(args) -> int:
    from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir
    from animal2vec_tpu_torch.train.convert import export_finetune, export_pretrain

    sd = load_checkpoint_dir(args.checkpoint)["model"]
    if any(k.startswith("encoder.") for k in sd):
        out = export_finetune(sd, apply_overrides(FinetuneConfig(), args.overrides))
    else:
        out = export_pretrain(sd, apply_overrides(PretrainConfig(), args.overrides).model)
    np.savez(args.out, **out)
    print(f"exported {len(out)} tensors to {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_imp = sub.add_parser("import")
    p_imp.add_argument("--pt", required=True)
    p_imp.add_argument("--out", required=True)
    p_imp.add_argument("--kind", default="auto", choices=["auto", "pretrain", "finetune"])
    p_imp.add_argument("--strict", action="store_true")
    p_imp.add_argument("overrides", nargs="*")
    p_exp = sub.add_parser("export")
    p_exp.add_argument("--checkpoint", required=True)
    p_exp.add_argument("--out", required=True)
    p_exp.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    return do_import(args) if args.cmd == "import" else do_export(args)


if __name__ == "__main__":
    sys.exit(main())
