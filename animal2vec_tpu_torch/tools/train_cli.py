"""Training CLI: the port of ``animal2vec_tpu/tools/train_cli.py``.

Usage:
  python -m animal2vec_tpu_torch.tools.train_cli --config <recipe.yaml> \\
      [--data <manifest dir>] [--save-dir <checkpoint dir>] [--max-steps N] \\
      [--patience N] [--pretrained <checkpoint dir or fairseq .pt>] \\
      [--device cuda] [--dist-backend nccl|gloo] [key=value ...]
  python -m animal2vec_tpu_torch.tools.train_cli --recipe finetune_100 ...

``--config`` reads a YAML recipe in the JAX package's schema
(``config.load_config``; the six shipped recipes are in
``animal2vec_tpu_torch/configs/``), with dotted overrides in its key names
(``model.depth=8``, ``model.remat_scope=attn``,
``model.teacher_matmul_impl=int8``, ``optimization.update_freq=1``); a
``finetune`` section makes a finetune run. ``--recipe`` names one of two
copies (``finetune_100``, ``a2v_large_pretrain``, as
``config.RunConfig``'s presets) and takes overrides in the port's own field
names (``dataset.batch_size=4``, ``model.depth=8``,
``pretrain.model.depth=8``, ``finetune.optimization.update_freq=1``).
``common.profile`` traces the run with ``torch.profiler`` into
``common.tensorboard_logdir`` (or ``trace``); ``common.suppress_crashes``
logs an exception of the run and returns None.
A finetune run starts from ``--pretrained``: a pretraining checkpoint of
this package (a manager's directory, a ``step_*`` directory or ``best``)
or a fairseq ``.pt``, converted on load (with ``finetune.load_ema`` its
EMA weights).
A run resumes from the latest checkpoint in its save directory. The run
goes on the card unless ``--device cpu`` asks for the CPU.

Data parallelism (``distributed.data_parallel``, -1 in every recipe: every
visible card). Under ``torchrun`` (RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT set) the CLI joins the group it is given, one rank per
process. Otherwise it starts the ranks itself: ``data_parallel`` worker
processes of this CLI over a local TCP store (-1: one per visible card; one
rank on the CPU), or with one rank it runs in this process in a group of
one. ``--dist-backend`` is NCCL on the card and gloo with ``--device cpu``;
gloo may also place several ranks on one card
(``distributed.data_parallel=2 --dist-backend gloo``). Each rank loads
``dataset.max_tokens`` of items a micro-batch, so the global batch is the
world size times that (``data/dataset.py``); a checkpoint records the world
size, and resuming it under another raises.

The other axes of JAX's mesh (``distributed.model_parallel``,
``pipeline_parallel``, ``fsdp``): the CLI starts data x stage x model
ranks (``parallel/mesh.py``) and lays the model over them
(``parallel/layout.py``): Megatron tensor parallelism of the blocks over
"model", the trunk as a GPipe over "stage" (``model.pipeline_microbatches``
microbatches), FSDP2 of the blocks' dense kernels over "data". Checkpoints
hold whole tensors, so a run saved under one layout resumes under another
with the same data-parallel world (``distributed.model_parallel=2`` then
one rank, for example). On the CPU: ``--device cpu
distributed.model_parallel=2``; on one card: add ``--dist-backend gloo``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from animal2vec_tpu_torch.config import RECIPES, apply_overrides, load_config
from animal2vec_tpu_torch.parallel import mesh


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--config", help="YAML recipe (the JAX package's schema)")
    source.add_argument("--recipe", choices=sorted(RECIPES))
    parser.add_argument("--data", default=None, help="manifest directory (task.data)")
    parser.add_argument("--save-dir", default=None, help="checkpoint directory")
    parser.add_argument("--max-steps", type=int, default=None, help="stop after this step")
    parser.add_argument("--patience", type=int, default=None,
                        help="override checkpoint.patience (early-stop validations)")
    parser.add_argument("--pretrained", default="",
                        help="pretraining checkpoint directory or fairseq .pt to start a "
                             "finetune run from")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist-backend", default=None, choices=mesh.BACKENDS,
                        help="process group backend (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    argv = sys.argv[1:] if argv is None else [str(a) for a in argv]
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    overrides = list(args.overrides)
    if args.data is not None:
        overrides.append(f"task.data={args.data}")
    if args.save_dir is not None:
        overrides.append(f"checkpoint.save_dir={args.save_dir}")
    if args.config:
        run = load_config(args.config, overrides)
    else:
        run = apply_overrides(RECIPES[args.recipe](), overrides)
    if run.finetune is None and args.pretrained:
        raise ValueError("--pretrained starts a finetune run; the recipe is pretraining")
    backend = args.dist_backend or mesh.default_backend(args.device)
    world = mesh.resolve_world(run.distributed, args.device, backend)
    if not mesh.from_env() and world > 1:
        mesh.launch(["-m", "animal2vec_tpu_torch.tools.train_cli", *argv], world)
        return None

    from animal2vec_tpu_torch.train.loop import run_finetune, run_pretrain

    dp = mesh.init_data_parallel(args.device, backend, run.distributed)
    if not dp.is_main:  # rank 0 logs
        logging.getLogger("animal2vec_tpu_torch").setLevel(logging.WARNING)

    def _run():
        if run.distributed.data_parallel not in (-1, dp.world):
            raise ValueError(f"distributed.data_parallel={run.distributed.data_parallel} but the "
                             f"group has {dp.world} rank(s)")
        if run.finetune is None:
            return run_pretrain(run, max_steps=args.max_steps, dp=dp)
        pretrained = load_pretrained(args.pretrained, run) if args.pretrained else None
        return run_finetune(run, pretrained=pretrained, max_steps=args.max_steps,
                            patience=args.patience, dp=dp)

    def _profiled():
        if not run.common.profile:
            return _run()
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if torch.device(args.device).type == "cuda" else [])
        with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
                run.common.tensorboard_logdir or "trace", worker_name=f"rank{dp.global_rank}")):
            return _run()

    try:
        if run.common.suppress_crashes:
            try:
                return _profiled()
            except Exception:  # noqa: BLE001 - the recipe's opt-in
                logging.getLogger("animal2vec_tpu_torch").exception("run crashed (suppressed)")
                return None
        return _profiled()
    finally:
        dp.close()


def load_pretrained(path: str, run=None):
    """The pretrained student's state dict that a finetune run starts from
    (``_load_pretrained``, ``animal2vec_tpu/tools/train_cli.py:76-95``): a
    fairseq ``.pt`` through ``train/convert.py`` (the tolerant unpickler,
    ``convert_pretrain`` onto ``run.model``'s architecture and
    ``params_from_jax``; with ``finetune.load_ema`` the ``_ema.*`` weights
    where the file has them), else a checkpoint directory of this package."""
    if path.endswith(".pt"):
        from animal2vec_tpu_torch.train.convert import (
            load_torch_checkpoint, pretrain_state_dicts, state_dict_to_numpy,
        )

        state = load_torch_checkpoint(path)
        sd = state_dict_to_numpy(state.get("model", state))
        if run.finetune.load_ema and any(k.startswith("_ema.") for k in sd):
            # the EMA weights as the encoder (nn/wav2vec2.py:187-192)
            for k in list(sd):
                if k.startswith("_ema."):
                    sd[k[len("_ema."):]] = sd[k]
        return pretrain_state_dicts(sd, run.model)[0]
    from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir

    return load_checkpoint_dir(path)["model"]


if __name__ == "__main__":
    main()
