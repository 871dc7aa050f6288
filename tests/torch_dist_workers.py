"""Rank processes of the port's data-parallel CPU tests (gloo), jax-free.

``python -m tests.torch_dist_workers <scenario,...> <dir>`` runs as one rank
of the group that ``parallel.mesh.launch`` starts: it reads
``<dir>/inputs.pt`` (configs, weights and global batches that the test
made, with JAX, in its own process), runs each scenario through the port's
data-parallel code and writes ``<dir>/result_<rank>.pt``. A scenario that
compares with one rank on the global batch runs that too, on rank 0.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from animal2vec_tpu_torch.config import (
    CheckpointConfig, CommonConfig, DatasetConfig, FinetuneConfig, RunConfig,
    SegmentationConfig, TaskConfig,
)
from animal2vec_tpu_torch.models.finetune import build_finetune_model
from animal2vec_tpu_torch.models.modules import AltBlock
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.parallel import mesh

WAV = 800
NAMES = ("a", "b", "c", "focal")
TINY = dict(embed_dim=128, num_heads=4, depth=3, prenet_depth=2, conv_pos_depth=2,
            conv_pos_width=10, conv_pos_groups=2)
TINY_LAYERS = ((9, 7, 1), (16, 4, 2), (16, 3, 2))


def tiny_run(train_cfg, data: str, save_dir: str) -> RunConfig:
    """The tiny finetune run of the loop tests: validation of 3 clips."""
    model = FinetuneConfig(conv_layers=TINY_LAYERS, average_top_k_layers=3, labels=NAMES,
                           max_sample_size=WAV, metric_threshold=0.25, **TINY)
    return RunConfig(
        model=model, finetune=train_cfg,
        common=CommonConfig(compute_dtype="float32", log_interval=1),
        task=TaskConfig(data=data, with_labels=True, max_sample_size=WAV,
                        verbose_tensorboard_logging=True),
        dataset=DatasetConfig(batch_size=2, num_workers=1, train_subset="train_0",
                              validate_interval_updates=2, validate_after_updates=0),
        checkpoint=CheckpointConfig(save_dir=save_dir, save_interval_updates=1000),
        criterion=SegmentationConfig(segmentation_metrics=True),
    )


def _rows(x: torch.Tensor, dp, axis: int) -> torch.Tensor:
    b = x.shape[axis] // dp.world
    return x.narrow(axis, dp.rank * b, b).contiguous()


def _checksum(tensors) -> float:
    return float(sum(t.detach().double().sum() for t in tensors))


def finetune_step(dp, inp):
    from animal2vec_tpu_torch.models.finetune import FinetuneModel
    from animal2vec_tpu_torch.train.finetune_step import make_finetune_train_step
    from animal2vec_tpu_torch.train.state import FinetuneState

    model = FinetuneModel(inp["ft_cfg"], train=inp["ft_train"])
    model.load_state_dict(inp["ft_params"], strict=True)
    state = FinetuneState.create(model, inp["ft_train"])
    batch = {k: _rows(v, dp, 1) for k, v in inp["ft_batch"].items()}
    metrics = make_finetune_train_step(inp["ft_train"], dp)(state, batch,
                                                            Rngs.from_seed(0, "cpu", dp.rank))
    return {"params": state.model.state_dict(), "metrics": {k: float(v)
                                                            for k, v in metrics.items()},
            "checksum": _checksum(state.model.parameters())}


def pretrain_step(dp, inp):
    from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
    from animal2vec_tpu_torch.models.finetune import pretrain_rates
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step
    from animal2vec_tpu_torch.train.state import PretrainState

    pcfg, mask = inp["pt_cfg"], inp["pt_mask"]
    model = Data2VecMulti(pcfg.model, pretrain=pcfg, **pretrain_rates(pcfg))
    model.load_state_dict(inp["pt_params"], strict=True)
    state = PretrainState.create(model, pcfg)
    draw = lambda rows, t, rngs: mask[rngs.row0: rngs.row0 + rows]  # noqa: E731
    batch = {k: _rows(v, dp, 1) for k, v in inp["pt_batch"].items()}
    metrics = make_pretrain_train_step(pcfg, draw, dp)(state, batch,
                                                       Rngs.from_seed(0, "cpu", dp.rank))
    return {"params": state.model.state_dict(), "ema": dict(state.ema),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "checksum": (_checksum(state.model.parameters()), _checksum(state.ema.values()))}


def masks(dp, inp):
    """One post-LN block in training with hash dropout at every site on the
    same 2 rows on each rank; rank 0 also runs it as one rank on the rows
    stacked once per rank. Its widths (C 128, M 512) are the kernels',
    where the block takes the fused block's hash dropout (off them it takes
    JAX's composed route, whose masks come from the rank's generator)."""
    torch.manual_seed(3)
    block = AltBlock(128, 4, attention_dropout=0.3, activation_dropout=0.2,
                     post_mlp_drop=0.2).train()
    x = torch.randn(2, 40, 128, generator=torch.Generator().manual_seed(4))
    spec = build_finetune_model(dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS,
                                                    average_top_k_layers=3, **TINY),
                                device="cpu").encoder.audio_encoder.alibi_spec(
        torch.arange(40, dtype=torch.int32)[None])

    def run(xs, group):
        rngs = Rngs.from_seed(7, "cpu", group.rank)
        rngs.row0 = group.row_offset(xs.shape[0])
        with torch.no_grad():
            return block(xs, None, spec, rngs)[0]

    out = {"y": run(x, dp)}
    if dp.is_main:
        out["ref"] = run(torch.cat([x] * dp.world), mesh.DataParallel())
    return out


def validation(dp, inp):
    from animal2vec_tpu_torch.train import loop
    from animal2vec_tpu_torch.train.finetune_step import make_finetune_eval_step
    from animal2vec_tpu_torch.train.state import FinetuneState

    run = tiny_run(inp["val_train"], inp["val_data"], inp["dir"])
    model = build_finetune_model(run.model, seed=0, device="cpu", train=run.finetune)
    state = FinetuneState.create(model, run.finetune)
    return {"valid": loop.validate_finetune(run, state, make_finetune_eval_step(run.finetune),
                                            loop._NullSink(), 2, torch.device("cpu"), dp)}


def collapse(dp, inp):
    """A pretraining run whose variance floors no run meets: each rank
    records the step at which it raised ``CollapseError``."""
    from animal2vec_tpu_torch.train import loop

    loop.COLLAPSE_AFTER = 0
    run = RunConfig(pretrain=dataclasses.replace(inp["pt_cfg"], min_target_var=1e9),
                    common=CommonConfig(compute_dtype="float32", log_interval=1),
                    task=TaskConfig(data=inp["val_data"], max_sample_size=WAV),
                    dataset=DatasetConfig(batch_size=2, num_workers=1, train_subset="train_0",
                                          disable_validation=True),
                    checkpoint=CheckpointConfig(save_dir=os.path.join(inp["dir"], "collapse"),
                                                save_interval_updates=1000))
    try:
        loop.run_pretrain(run, max_steps=3, dp=dp)
    except loop.CollapseError as e:
        return {"collapsed_at": e.step, "error": str(e)}
    return {"collapsed_at": None}


def ring(dp, inp):
    from animal2vec_tpu_torch.ops.ring_attention import ring_attention_dist

    q, k, v, pos, pad = (_rows(inp["ring"][n], dp, 1) for n in ("q", "k", "v", "pos", "pad"))
    out = ring_attention_dist(q, k, v, inp["ring"]["slopes"], pos, pad)
    return {"ring": torch.cat(dp.all_gather_object(out), dim=1)}


SCENARIOS = {"finetune_step": finetune_step, "pretrain_step": pretrain_step, "masks": masks,
             "validation": validation, "collapse": collapse, "ring": ring}


def main():
    names, out_dir = sys.argv[1].split(","), sys.argv[2]
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    inp["dir"] = out_dir
    dp = mesh.init_data_parallel("cpu", "gloo")
    try:
        result = {"world": dp.world}
        for name in names:
            result[name] = SCENARIOS[name](dp, inp)
        torch.save(result, os.path.join(out_dir, f"result_{dp.rank}.pt"))
    finally:
        dp.close()


if __name__ == "__main__":
    main()
