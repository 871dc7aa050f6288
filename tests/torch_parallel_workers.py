"""Rank processes of the port's sharded-layout CPU tests (gloo), jax-free.

``python -m tests.torch_parallel_workers <scenario,...> <dir>`` runs as one
rank of the group that ``parallel.mesh.launch`` starts: it reads
``<dir>/inputs.pt`` (configs, weights and global batches that the test
made, with JAX, in its own process), lays each scenario's mesh over the
group (``parallel.mesh.layout``) and writes ``<dir>/result_<rank>.pt``. A
scenario is a layout and what runs under it: a finetune step, a pretraining
step with the EMA teacher, or the training forward of one block or of a
model with every dropout site on beside the one-rank call on rank 0.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from animal2vec_tpu_torch.config import DistributedConfig
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.parallel import mesh
from animal2vec_tpu_torch.parallel.layout import apply_layout, full_state, in_trunk
from animal2vec_tpu_torch.parallel.tensor import tp_rule

LAYOUTS = {
    "fsdp": DistributedConfig(data_parallel=2, fsdp=True),
    "tp": DistributedConfig(data_parallel=1, model_parallel=2),
    "pp": DistributedConfig(data_parallel=1, pipeline_parallel=2),
    "fsdp_tp": DistributedConfig(data_parallel=2, model_parallel=2, fsdp=True),
    "pp_tp": DistributedConfig(data_parallel=1, pipeline_parallel=2, model_parallel=2),
}


def _rows(x: torch.Tensor, dp, axis: int) -> torch.Tensor:
    b = x.shape[axis] // dp.world
    return x.narrow(axis, dp.rank * b, b).contiguous()


def replicated_checksum(dp, named) -> float:
    """The sum of the parameters every rank holds whole (not a shard of
    "model", FSDP or another stage): equal on every rank after a step."""
    from torch.distributed.tensor import DTensor

    total = 0.0
    for name, p in named:
        if isinstance(p, DTensor) or (dp.model.size > 1 and tp_rule(name)) or (
                dp.stage.size > 1 and in_trunk(name)):
            continue
        total += float(p.detach().double().sum())
    return total


def finetune(dp, inp):
    from animal2vec_tpu_torch.models.finetune import FinetuneModel
    from animal2vec_tpu_torch.train.finetune_step import make_finetune_train_step
    from animal2vec_tpu_torch.train.state import FinetuneState

    model = FinetuneModel(inp["ft_cfg"], train=inp["ft_train"])
    model.load_state_dict(inp["ft_params"], strict=True)
    apply_layout(model, dp)
    state = FinetuneState.create(model, inp["ft_train"], dp)
    batch = {k: _rows(v, dp, 1) for k, v in inp["ft_batch"].items()}
    metrics = make_finetune_train_step(inp["ft_train"], dp)(state, batch,
                                                            Rngs.from_seed(0, "cpu", dp.rank))
    return {"params": full_state(dp, state.model.state_dict(keep_vars=True)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "checksum": replicated_checksum(dp, state.model.named_parameters())}


def pretrain(dp, inp):
    from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
    from animal2vec_tpu_torch.models.finetune import pretrain_rates
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step
    from animal2vec_tpu_torch.train.state import PretrainState

    pcfg, mask = inp["pt_cfg"], inp["pt_mask"]
    model = Data2VecMulti(pcfg.model, pretrain=pcfg, **pretrain_rates(pcfg))
    model.load_state_dict(inp["pt_params"], strict=True)
    apply_layout(model, dp)
    state = PretrainState.create(model, pcfg, dp)
    draw = lambda rows, t, rngs: mask[rngs.row0: rngs.row0 + rows]  # noqa: E731
    batch = {k: _rows(v, dp, 1) for k, v in inp["pt_batch"].items()}
    metrics = make_pretrain_train_step(pcfg, draw, dp)(state, batch,
                                                       Rngs.from_seed(0, "cpu", dp.rank))
    return {"params": full_state(dp, state.model.state_dict(keep_vars=True)),
            "ema": full_state(dp, state.ema),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "checksum": replicated_checksum(dp, state.model.named_parameters())}


def block_dropout(dp, inp):
    """One post-LN block in training with hash dropout at every site and
    drop-path on both branches, sharded over "model", beside the whole
    block on rank 0, on the same rows and the same draws. Its widths (C
    128, M 512) are the kernels', where the whole block takes the fused
    block's hash dropout too (off them it takes JAX's composed route)."""
    from animal2vec_tpu_torch.models.attention import AlibiSpec
    from animal2vec_tpu_torch.models.modules import AltBlock

    torch.manual_seed(3)
    block = AltBlock(128, 4, attention_dropout=0.3, activation_dropout=0.2, post_mlp_drop=0.2,
                     encoder_dropout=0.1, drop_path=0.25).train()
    whole = {k: v.clone() for k, v in block.state_dict().items()}
    x = torch.randn(2, 40, 128, generator=torch.Generator().manual_seed(4), requires_grad=True)
    spec = AlibiSpec(torch.tensor([0.5, 0.25, 0.125, 0.0625], requires_grad=True),
                     torch.arange(40, dtype=torch.int32)[None])

    def run(b, group):
        rngs = Rngs.from_seed(7, "cpu", group.rank)
        y, tap = b(x, None, spec, rngs)
        gx, gs = torch.autograd.grad((y * y).sum() + tap.sum(), (x, spec.slopes))
        # a rank's slopes see its heads only: the step sums them over "model"
        return y.detach(), gx, group.model.all_reduce(gs)

    out = {}
    if dp.is_main:
        out["ref"] = run(block, mesh.DataParallel())
    block.load_state_dict(whole)
    apply_layout(block, dp)
    out["y"] = run(block, dp)
    return out


def model_dropout(dp, inp):
    """The tiny finetune model's training forward and backward with every
    dropout site, layerdrop and drop-path on, pipelined (and sharded) as the
    layout says, beside the plain model on rank 0 from the same seeds."""
    from animal2vec_tpu_torch.models.finetune import FinetuneModel

    train = dataclasses.replace(inp["ft_train"], dropout=0.1, attention_dropout=0.2,
                                activation_dropout=0.1, layerdrop=0.3, drop_path=0.2,
                                final_dropout=0.0)

    def run(group):
        model = FinetuneModel(inp["ft_cfg"], train=train).train()
        model.load_state_dict(inp["ft_params"], strict=True)
        apply_layout(model, group)
        src = inp["ft_batch"]["source"][0]
        logits = model(src, rngs=Rngs.from_seed(11, "cpu", group.rank))["encoder_out"]
        logits.square().sum().backward()
        slopes = [p for n, p in model.named_parameters() if n.endswith("alibi_scale")][0]
        return logits.detach(), slopes.grad.clone()

    out = {}
    if dp.is_main:
        out["ref"] = run(mesh.DataParallel())
    out["y"] = run(dp)
    return out


PARTS = {"finetune": finetune, "pretrain": pretrain, "block_dropout": block_dropout,
         "model_dropout": model_dropout}


def main():
    names, out_dir = sys.argv[1].split(","), sys.argv[2]
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    base = mesh.init_data_parallel("cpu", "gloo")
    try:
        result = {"world": base.global_world}
        for name in names:
            layout, part = name.split(":")
            dp = mesh.layout(base, LAYOUTS[layout])
            result[name] = PARTS[part](dp, inp)
            base.barrier()
        torch.save(result, os.path.join(out_dir, f"result_{base.global_rank}.pt"))
    finally:
        base.close()


if __name__ == "__main__":
    main()
