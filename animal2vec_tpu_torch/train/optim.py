"""Optimizer and learning-rate schedule: the port of
``animal2vec_tpu/train/optim.py`` with optax's semantics.

``build_optimizer`` returns an ``OptaxAdam``, the chain
``[clip_by_global_norm] -> scale_by_adam -> add_decayed_weights(mask) ->
[layer-decay scale] -> -lr`` as one ``torch.optim.Optimizer``:

* Adam keeps **one global step count**, as optax does, and updates every
  parameter at every step. A parameter whose ``.grad`` is None (frozen by
  the finetune gate, skipped by layerdrop, or behind the frontend's stopped
  gradient) takes a zero gradient: its moments decay and the bias
  correction counts the step, exactly as in JAX. ``torch.optim.Adam``
  skips such a parameter and keeps a step count per parameter, so its first
  update after the gate opens would be lr * sign(g) where optax gives about
  0.71 * lr * sign(g) at step 10 000.
* eps is added outside the square root; weight decay is decoupled and
  applies to the decay-masked parameters (``decay_mask``); the layer-decay
  multiplier (``layer_decay_scales``) scales the whole update of a layer's
  parameters.

The moments are fp32 on the parameter's device; the update runs in fp32.
Under a sharded layout (``parallel/layout.py``) every parameter, gradient
and moment is the rank's own shard (an FSDP2 parameter's local tensor), and
``grad_sq_norm`` takes the clipping norm over every shard, stage and
replica (``layout.grad_sq_norm``), as JAX's ``clip_by_global_norm`` takes it
over the whole sharded tree.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from animal2vec_tpu_torch.config import OptimizationConfig

Schedule = Callable[[int], float]
# (the (name, parameter) pairs, their fp32 local gradients) -> the squared
# global norm
SqNorm = Callable[[List[Tuple[str, torch.Tensor]], List[torch.Tensor]], torch.Tensor]

PRENET_PREFIX = "encoder.audio_encoder.context_encoder.blocks.layers."
TRUNK_PREFIX = "encoder.blocks.layers."


def build_lr_schedule(cfg: OptimizationConfig) -> Schedule:
    """step -> lr: linear warmup from ``warmup_init_lr`` to ``lr`` over
    ``warmup_updates`` steps, then optax's ``cosine_decay_schedule`` from
    ``lr`` to ``min_lr`` over ``max_update - warmup_updates`` steps (or a
    constant ``lr``)."""
    warm = max(1, cfg.warmup_updates)
    decay_steps = max(1, cfg.max_update - cfg.warmup_updates)
    alpha = cfg.min_lr / cfg.lr if cfg.lr > 0 else 0.0

    def schedule(step: int) -> float:
        if step < cfg.warmup_updates:
            frac = 1.0 - min(max(step, 0), warm) / warm
            return (cfg.warmup_init_lr - cfg.lr) * frac + cfg.lr
        if cfg.schedule == "constant":
            return cfg.lr
        count = min(step - cfg.warmup_updates, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return cfg.lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def decays(name: str, param: torch.Tensor) -> bool:
    """The JAX ``_no_decay`` rule (``optim.py:48-62``) on a port parameter
    name: no weight decay for biases, norms and other 1-D params, the ALiBi
    scales and PSwish's parameters."""
    if "alibi_scale" in name or "p_swish" in name:
        return False
    if name.rsplit(".", 1)[-1] == "bias":
        return False
    return param.dim() > 1


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    return {n: decays(n, p) for n, p in named_params}


def layer_decay_scales(names: Iterable[str], layer_decay: float, prenet_depth: int,
                       trunk_depth: int) -> Optional[Dict[str, float]]:
    """Per-parameter lr multipliers of layer-wise decay (``optim.py:71-105``):
    prenet layer i is layer id 1 + i, trunk layer i is 1 + prenet_depth + i,
    and layer id l gets ``layer_decay ** (prenet_depth + trunk_depth + 1 - l)``;
    every other parameter 1. None when ``layer_decay >= 1``."""
    if layer_decay >= 1.0:
        return None
    num_layers = prenet_depth + trunk_depth + 1
    out = {}
    for name in names:
        scale = 1.0
        for prefix, base in ((PRENET_PREFIX, 1), (TRUNK_PREFIX, 1 + prenet_depth)):
            if name.startswith(prefix):
                lid = base + int(name[len(prefix):].split(".", 1)[0])
                scale = layer_decay ** (num_layers - lid)
        out[name] = scale
    return out


class OptaxAdam(torch.optim.Optimizer):
    """optax ``chain(clip_by_global_norm?, scale_by_adam, add_decayed_weights,
    scale_by_tree?, scale_by_learning_rate)`` over named parameters. Each
    parameter group holds one parameter with its ``weight_decay`` (0 where the
    mask is off) and ``scale`` (the layer-decay multiplier). ``step`` takes
    the learning rate of this update."""

    def __init__(self, named_params, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 decay: Optional[Dict[str, bool]] = None,
                 scales: Optional[Dict[str, float]] = None, clip_norm: float = 0.0):
        groups = []
        for name, p in named_params:
            wd = weight_decay if (decay is None or decay[name]) else 0.0
            groups.append({"params": [p], "name": name, "weight_decay": wd,
                           "scale": 1.0 if scales is None else scales[name]})
        super().__init__(groups, {"betas": betas, "eps": eps})
        self.clip_norm = clip_norm
        self.count = 0  # the global Adam step count of optax
        self.grad_sq_norm: Optional[SqNorm] = None  # a sharded layout's global norm

    @torch.no_grad()
    def step(self, lr: float):
        params = [g["params"][0] for g in self.param_groups]
        for p in params:  # optax updates every leaf: absent grads are zeros
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [_local(p.grad).float() for p in params]
        if self.clip_norm > 0 and self.grad_sq_norm is not None:
            norm = self.grad_sq_norm([(g["name"], g["params"][0]) for g in self.param_groups],
                                     grads).sqrt()
        elif self.clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
        if self.clip_norm > 0:
            factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                 self.clip_norm / norm)
            grads = [g * factor.to(g.device) for g in grads]
        self.count += 1
        b1, b2 = self.defaults["betas"]
        eps = self.defaults["eps"]
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for group, p, g in zip(self.param_groups, params, grads):
            state = self.state[p]
            if not state:
                state["mu"] = torch.zeros_like(p, dtype=torch.float32)
                state["nu"] = torch.zeros_like(p, dtype=torch.float32)
            mu, nu, p = _local(state["mu"]), _local(state["nu"]), _local(p)
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (mu / c1) / ((nu / c2).sqrt() + eps)
            if group["weight_decay"]:
                update.add_(p.float(), alpha=group["weight_decay"])
            p.add_((update * (-lr * group["scale"])).to(p.dtype))


def _local(t: torch.Tensor) -> torch.Tensor:
    """An FSDP2 parameter's (or gradient's, or moment's) local shard; any
    other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def build_optimizer(cfg: OptimizationConfig, model: torch.nn.Module, prenet_depth: int = 0,
                    trunk_depth: int = 0, layer_decay: float = 1.0) -> Tuple[OptaxAdam, Schedule]:
    """The optimizer over the model's trainable parameters and its schedule
    (``build_optimizer``): global-norm clipping at ``clip_norm``, Adam, the
    decay mask, and with ``layer_decay`` < 1 ``init_finetune``'s layer
    scales over the prenet and trunk layers (finetuning; pretraining has
    none)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    scales = layer_decay_scales([n for n, _ in named], layer_decay, prenet_depth, trunk_depth)
    opt = OptaxAdam(named, cfg.adam_betas, cfg.adam_eps, cfg.weight_decay,
                    decay_mask(named), scales, cfg.clip_norm)
    return opt, build_lr_schedule(cfg)
