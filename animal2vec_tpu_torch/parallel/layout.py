"""A model laid over the mesh: the port of ``param_partition_spec`` and
``param_sharding`` (``animal2vec_tpu/parallel/mesh.py:98-159``) and of the
JAX loop's resharding of its state (``train/loop.py:186-199, 310``).

``partition_plan`` is JAX's rule on the port's parameter names: under
"model" the qkv and fc1 of every transformer block are column-parallel and
proj and fc2 row-parallel (``parallel/tensor.py``); under "stage" the
trunk's layers split by depth; with ``fsdp`` the blocks' dense kernels
(qkv, proj, fc1, fc2) are sharded over "data". ``apply_layout`` puts a
built model (its whole weights loaded) into that layout on one rank: it
keeps the rank's tensor-parallel shards (``shard_block``), splits the trunk
into its pipeline stage (``pipeline.split_trunk``) and shards the blocks'
dense kernels with FSDP2 (``fully_shard`` per block over the "data"
``DeviceMesh``, the biases and norms left out, the gradient summed as the
data-parallel step sums it). Three differences from JAX's plan, which
change where a tensor lives and no number: FSDP2 shards dim 0 where JAX
picks the largest axis; the dense layers outside the blocks (the finetune
head, ``project_linear``, the decoders' projections, the probe) stay
replicated, since the port runs them through their weights directly, not
through a module's forward, which is where FSDP2 gathers; and under
"model" only the blocks' four layers split (JAX's rule also names the head
and the decoders' ``proj``, where GSPMD reshards).

The rest of a step's collectives follow from the plan: the gradients of
replicated parameters are all-reduced over "data" (``DataParallel.
reduce_gradients``) and those of parameters every "model" rank sees only in
part (the ALiBi scale behind the rank's slopes) over "model"
(``reduce_model_partials``); the clipping norm sums each parameter's
squares once over every rank (``grad_sq_norm``). A checkpoint holds whole
tensors, whatever the layout (``full_state`` gathers them to the main rank,
``load_full_state`` slices a rank's part), so a run saved under one layout
resumes under another.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import DTensor

from animal2vec_tpu_torch.models.modules import AltBlock, kernel_widths
from animal2vec_tpu_torch.parallel.mesh import DataParallel
from animal2vec_tpu_torch.parallel.tensor import (
    COLUMN_PARALLEL, ROW_PARALLEL, shard_block, shard_param, tp_rule, unshard_param,
)

_BLOCK = re.compile(r"(^|\.)blocks\.layers\.\d+\.")
_TRUNK = re.compile(r"^(encoder\.)?blocks\.layers\.\d+\.")
DENSE = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight", "mlp.fc2.weight")


def in_block(name: str) -> bool:
    """Whether ``name`` is a parameter of a transformer block (prenet or
    trunk)."""
    return bool(_BLOCK.search(name))


def in_trunk(name: str) -> bool:
    """Whether ``name`` is a parameter of the trunk's blocks (the pipelined
    ones)."""
    return bool(_TRUNK.search(name))


def partition_plan(names: Iterable[str], model_parallel: int = 1, fsdp: bool = False,
                   stages: int = 1) -> Dict[str, Tuple[Optional[str], bool, bool]]:
    """Each parameter's (tensor-parallel role "column", "row" or None, FSDP
    sharded, split over "stage") under a layout of ``model_parallel`` x
    ``stages`` with or without ``fsdp``."""
    out = {}
    for name in names:
        tp = None
        if model_parallel > 1 and in_block(name) and tp_rule(name) is not None:
            layer = name.rsplit(".", 2)[-2]
            tp = "column" if layer in COLUMN_PARALLEL else "row" if layer in ROW_PARALLEL else None
        sharded = fsdp and in_block(name) and name.endswith(DENSE)
        out[name] = (tp, sharded, stages > 1 and in_trunk(name))
    return out


def _encoder(model: nn.Module) -> nn.Module:
    return getattr(model, "encoder", model)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def apply_layout(model: nn.Module, dp: DataParallel, microbatches: int = 0) -> nn.Module:
    """Put ``model`` (a ``FinetuneModel`` or ``Data2VecMulti`` holding its
    whole weights) into ``dp``'s layout, in place; returns it. Raises on a
    layout the port leaves out: tensor parallelism of pre-LN blocks, of the
    image modality or without ALiBi (the dense-bias kernels are not split
    by head), where C or a rank's M is off a multiple of 128 (the split of
    #6 keeps its kernels' widths), and the int8 modes under any sharding
    (ROADMAP A.10)."""
    if not dp.sharded:
        return model
    enc = _encoder(model)
    blocks = [m for m in model.modules() if isinstance(m, AltBlock)]
    if any(b.int8 or b.attn.int8 for b in blocks):
        raise NotImplementedError("the int8 matmul_impl modes under a sharded layout are not "
                                  "ported (ROADMAP A.10)")
    if dp.model.size > 1:
        cfg = getattr(enc, "cfg", None)
        if getattr(enc, "mode", None) == "IMAGE" or any(b.layer_norm_first for b in blocks) \
                or (cfg is not None and not cfg.use_alibi_encoder):
            raise NotImplementedError("tensor parallelism of the image modality, of pre-LN "
                                      "blocks or without ALiBi is not ported (ROADMAP A.10)")
        size = dp.model.size
        if not all(kernel_widths(b.mlp.fc1.in_features, b.mlp.fc1.out_features / size)
                   for b in blocks):
            raise NotImplementedError("tensor parallelism of blocks whose C or M / "
                                      "model_parallel is not a multiple of 128 is not ported "
                                      "(ROADMAP A.10)")
        for block in blocks:
            shard_block(block, dp.model)
    if dp.stage.size > 1:
        from animal2vec_tpu_torch.parallel.pipeline import split_trunk

        split_trunk(enc.blocks, dp, microbatches)
    if dp.fsdp:
        from torch.distributed.fsdp import fully_shard

        for block in (m for m in model.modules() if isinstance(m, AltBlock)):
            dense = {block.attn.qkv.weight, block.attn.proj.weight, block.mlp.fc1.weight,
                     block.mlp.fc2.weight}
            fully_shard(block, mesh=dp.mesh, reshard_after_forward=True,
                        ignored_params={p for p in block.parameters() if p not in dense})
            # a plain sum, as reduce_gradients sums (gloo has no AVG or PREMUL_SUM)
            block.set_gradient_divide_factor(1.0)
            block.set_force_sum_reduction_for_comms(True)
    return model


def reshard(model: nn.Module) -> None:
    """Free every FSDP2 block's gathered parameters (the next forward or
    backward gathers them again from the shards)."""
    from torch.distributed.fsdp import FSDPModule

    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.reshard()


def _tp_sharded(name: str, dp: DataParallel) -> bool:
    return dp.model.size > 1 and in_block(name) and tp_rule(name) is not None


def reduce_model_partials(dp: DataParallel, named: Iterable[Tuple[str, nn.Parameter]]) -> None:
    """Sum over "model" the gradients of the parameters a tensor-parallel
    rank sees only through its heads (the ALiBi scale behind its slopes;
    the other ranks' heads contribute zeros on each rank)."""
    if dp.model.size == 1:
        return
    for name, p in named:
        if name.endswith("alibi_scale") and p.grad is not None:
            dp.model.all_reduce(p.grad)


def grad_sq_norm(dp: DataParallel, named: List[Tuple[str, nn.Parameter]],
                 grads: List[torch.Tensor]) -> torch.Tensor:
    """The squared global norm of the gradients ``grads`` (local shards) of
    the parameters ``named``: each element counted once over every shard,
    every stage and every replica."""
    total = torch.zeros((), dtype=torch.float32, device=dp.device)
    for (name, p), g in zip(named, grads):
        owned = (isinstance(p, DTensor) or dp.rank == 0) \
            and (dp.model.rank == 0 or _tp_sharded(name, dp)) \
            and (dp.stage.rank == 0 or (dp.stage.size > 1 and in_trunk(name)))
        if owned:
            total = total + g.float().square().sum().to(total.device)
    if dp.global_world > 1:
        dist.all_reduce(total, group=dp.world_group)
    return total


def _gather_rows(dp: DataParallel, t: DTensor) -> torch.Tensor:
    """The whole host tensor of an FSDP2 (dim-0) shard: every data rank's
    rows, gathered as host tensors over the data axis' gloo group (the
    same order on every rank). DTensor's own ``full_tensor`` waits on a
    functional collective that faulted under gloo on CUDA tensors (an
    H100 with torch 2.11)."""
    rows = t.to_local().detach().to("cpu", copy=True)
    if dp.world == 1:
        return rows
    pieces = [None] * dp.world
    dist.all_gather_object(pieces, rows, group=dp.host_group)
    return torch.cat(pieces, dim=0)


def full_state(dp: DataParallel, tensors: Dict[str, torch.Tensor]
               ) -> Optional[Dict[str, torch.Tensor]]:
    """The whole host tensors of every rank's ``tensors`` (a model's or an
    optimizer's tensors by parameter name, each rank its own shards) on the
    main rank, None elsewhere; every rank takes part."""
    local = {}
    for name, t in tensors.items():
        if isinstance(t, DTensor):
            local[name] = _gather_rows(dp, t)
        else:
            local[name] = t.detach().to("cpu", copy=True)
    if dp.global_world == 1:
        return local
    gathered = [None] * dp.global_world if dp.is_main else None
    payload = (dp.model.rank, local) if dp.rank == 0 else None
    dist.gather_object(payload, gathered, dst=0, group=dp.world_host_group)
    if not dp.is_main:
        return None
    pieces: Dict[str, Dict[int, torch.Tensor]] = {}
    for item in gathered:
        if item is not None:
            for name, t in item[1].items():
                pieces.setdefault(name, {})[item[0]] = t
    out = {}
    for name, by_rank in pieces.items():
        if _tp_sharded(name, dp):
            out[name] = unshard_param(tp_rule(name), [by_rank[r] for r in range(dp.model.size)])
        else:
            out[name] = next(iter(by_rank.values()))
    return out


def local_part(dp: DataParallel, name: str, full: torch.Tensor, like: torch.Tensor
               ) -> torch.Tensor:
    """This rank's part of the whole tensor ``full`` of ``name``, shaped as
    its local tensor ``like`` (a tensor-parallel shard, then FSDP's rows)."""
    if _tp_sharded(name, dp):
        full = shard_param(tp_rule(name), full, dp.model.rank, dp.model.size)
    if isinstance(like, DTensor):
        chunks = full.chunk(dp.world, dim=0)
        full = chunks[dp.rank] if dp.rank < len(chunks) else full[:0]
    return full


@torch.no_grad()
def load_full_state(dp: DataParallel, targets: Dict[str, torch.Tensor],
                    full: Dict[str, torch.Tensor]) -> None:
    """Copy each rank's part of the whole tensors ``full`` into ``targets``
    (this rank's tensors by name, in place); raises on a name missing from
    ``full`` or one of ``full`` that no rank of the layout holds here (other
    stages' trunk layers are held elsewhere)."""
    missing = sorted(set(targets) - set(full))
    extra = sorted(n for n in set(full) - set(targets)
                   if not (dp.stage.size > 1 and in_trunk(n)))
    if missing or extra:
        raise KeyError(f"state names differ: missing {missing[:4]}, unexpected {extra[:4]}")
    for name, t in targets.items():
        part = local_part(dp, name, full[name], t)
        _local(t).copy_(part.to(_local(t).device, _local(t).dtype))
