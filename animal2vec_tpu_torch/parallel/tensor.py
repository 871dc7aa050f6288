"""Megatron tensor parallelism over the mesh's "model" axis: the port of the
Megatron layout that ``animal2vec_tpu/parallel/mesh.py`` gives GSPMD
(``_TP_COL``, ``_TP_ROW``, ``param_partition_spec``, ``mesh.py:85-86,
98-143``).

JAX shards the kernels of ``qkv`` and ``fc1`` by output features
(column-parallel) and of ``proj`` and ``fc2`` by input features
(row-parallel), and XLA places the collectives. The port holds the shards
in the modules of a post-LN ``AltBlock`` (``shard_block``) and runs them
with the operators of Megatron-LM written out as autograd Functions, since
the kernels take plain tensors:

* f, ``copy_to_model``: the identity forward and an all-reduce of the
  gradient over "model", where a replicated activation enters a
  column-parallel product (the block input into qkv, LN1's r into fc1);
* g, ``reduce_from_model``: an all-reduce forward over "model" and the
  identity backward, of the row-parallel products' fp32 partial sums.

``qkv`` is column-parallel by head: a rank of mp holds the q, k and v rows
of its H / mp heads from ``h0`` (not a contiguous 3C / mp slice of
columns), so that its attention runs on whole heads; that is the function
of JAX's layout, whose contiguous split GSPMD reshards for the attention.
The rank's ALiBi slopes are its heads' slice, and the attention's dropout
hashes its heads at their unsharded index (``ops.attention.hash_heads_of``).
``fc1`` holds the rank's M / mp hidden columns from ``col0`` and ``fc2``
the same rows; ``proj`` and ``fc2`` keep their whole biases, added after
the all-reduce. The shards' slicing and their reassembly are
``shard_param`` and ``unshard_param`` (checkpoints hold whole tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from animal2vec_tpu_torch.parallel.mesh import Axis

# the sharded leaves of a block: name suffix -> how they split
#   "heads": dim 0 in three equal parts (q, k, v), each by heads
#   "rows":  dim 0 (output features)
#   "cols":  dim 1 (input features)
TP_RULES = {
    "attn.qkv.weight": "heads", "attn.qkv.bias": "heads",
    "attn.proj.weight": "cols",
    "mlp.fc1.weight": "rows", "mlp.fc1.bias": "rows",
    "mlp.fc2.weight": "cols",
}
COLUMN_PARALLEL = ("qkv", "fc1")  # JAX _TP_COL
ROW_PARALLEL = ("proj", "fc2")    # JAX _TP_ROW


def tp_rule(name: str):
    """The split of the parameter ``name`` of a block under tensor
    parallelism, or None (replicated)."""
    return next((kind for suffix, kind in TP_RULES.items() if name.endswith(suffix)), None)


def shard_param(kind: str, full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the whole tensor ``full`` under ``kind``."""
    if kind == "heads":
        parts = full.chunk(3, dim=0)
        return torch.cat([p.chunk(size, dim=0)[rank] for p in parts], dim=0)
    return full.chunk(size, dim=0 if kind == "rows" else 1)[rank]


def unshard_param(kind: str, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor of the ranks' shards ``pieces`` (in model rank
    order) under ``kind``."""
    if kind == "heads":
        thirds = [p.chunk(3, dim=0) for p in pieces]
        return torch.cat([torch.cat([t[i] for t in thirds], dim=0) for i in range(3)], dim=0)
    return torch.cat(list(pieces), dim=0 if kind == "rows" else 1)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its gradient summed over ``axis``."""
    return x if axis.size == 1 else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``axis``, its gradient as it is."""
    return x if axis.size == 1 else _ReduceFromModel.apply(x, axis)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A block's shard: the "model" axis, its heads (``h0`` .. ``h0 +
    heads`` of ``hash_heads``) and its hidden columns (``col0`` ..
    ``col0 + hidden``)."""

    axis: Axis
    h0: int
    heads: int
    hash_heads: int
    col0: int
    hidden: int

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(x, self.axis)


def _replace(linear: nn.Linear, weight: torch.Tensor, bias: torch.Tensor) -> None:
    linear.weight = nn.Parameter(weight.detach().clone(), requires_grad=linear.weight.requires_grad)
    linear.bias = nn.Parameter(bias.detach().clone(), requires_grad=linear.bias.requires_grad)
    linear.out_features, linear.in_features = weight.shape


def shard_block(block: nn.Module, axis: Axis) -> None:
    """Keep rank ``axis.rank``'s shard of a post-LN ``AltBlock``'s qkv,
    proj, fc1 and fc2 in place and give the block and its attention their
    ``TensorParallel``."""
    attn, mlp = block.attn, block.mlp
    heads, size = attn.num_heads, axis.size
    hidden = mlp.fc1.out_features
    if heads % size or hidden % size:
        raise ValueError(f"model_parallel={size} must divide the heads ({heads}) and the MLP "
                         f"width ({hidden})")
    tp = TensorParallel(axis, axis.rank * heads // size, heads // size, heads,
                        axis.rank * hidden // size, hidden // size)
    params: Dict[str, nn.Linear] = {"attn.qkv": attn.qkv, "attn.proj": attn.proj,
                                    "mlp.fc1": mlp.fc1, "mlp.fc2": mlp.fc2}
    for name, lin in params.items():
        w_kind, b_kind = tp_rule(name + ".weight"), tp_rule(name + ".bias")
        weight = shard_param(w_kind, lin.weight, axis.rank, size)
        bias = lin.bias if b_kind is None else shard_param(b_kind, lin.bias, axis.rank, size)
        _replace(lin, weight, bias)
    block.tp = attn.tp = tp
