"""Training CLI: the port of ``animal2vec_tpu/tools/train_cli.py``.

Usage:
  python -m animal2vec_tpu_torch.tools.train_cli --recipe finetune_100 \\
      --data <manifest dir> --save-dir <checkpoint dir> [--max-steps N] \\
      [--patience N] [--pretrained <checkpoint dir>] [--device cuda] [key=value ...]

``--recipe`` picks ``config.RunConfig.finetune_100`` or
``RunConfig.a2v_large_pretrain``; dotted ``key=value`` overrides change any
field of the run (``dataset.batch_size=4``, ``model.depth=8``,
``pretrain.model.depth=8``, ``finetune.optimization.update_freq=1``).
A finetune run starts from a pretraining checkpoint of this package with
``--pretrained`` (a manager's directory, a ``step_*`` directory or
``best``); a fairseq ``.pt`` goes through ``tools/convert_cli import --kind
pretrain`` first.
A run resumes from the latest checkpoint in its save directory. The run
goes on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import logging

from animal2vec_tpu_torch.config import RECIPES, apply_overrides


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    parser.add_argument("--data", default=None, help="manifest directory (task.data)")
    parser.add_argument("--save-dir", default=None, help="checkpoint directory")
    parser.add_argument("--max-steps", type=int, default=None, help="stop after this step")
    parser.add_argument("--patience", type=int, default=None,
                        help="override checkpoint.patience (early-stop validations)")
    parser.add_argument("--pretrained", default="",
                        help="pretraining checkpoint directory to start a finetune run from")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    overrides = list(args.overrides)
    if args.data is not None:
        overrides.append(f"task.data={args.data}")
    if args.save_dir is not None:
        overrides.append(f"checkpoint.save_dir={args.save_dir}")
    run = apply_overrides(RECIPES[args.recipe](), overrides)

    from animal2vec_tpu_torch.train.loop import run_finetune, run_pretrain

    if run.finetune is None:
        if args.pretrained:
            raise ValueError("--pretrained starts a finetune run; the recipe is pretraining")
        return run_pretrain(run, max_steps=args.max_steps, device=args.device)
    pretrained = load_pretrained(args.pretrained) if args.pretrained else None
    return run_finetune(run, pretrained=pretrained, max_steps=args.max_steps,
                        patience=args.patience, device=args.device)


def load_pretrained(path: str):
    """The student's state dict of a pretraining checkpoint of this package."""
    if path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: convert a fairseq .pt first (tools/convert_cli import --kind pretrain, "
            "ROADMAP A.6) and pass the checkpoint directory it writes")
    from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir

    return load_checkpoint_dir(path)["model"]


if __name__ == "__main__":
    main()
