"""Train states: the port of ``animal2vec_tpu/train/state.py``.

JAX keeps (step, params, opt_state[, ema_params]) as one pytree; the port
keeps the step, the model (fp32 master weights), the optimizer
(``train.optim.OptaxAdam``, which holds the Adam moments) and the schedule,
and for pretraining the EMA teacher's parameters: a dict of fp32 copies of
the student's parameters that ``ema_param_label`` selects. The teacher is
the student module run by ``torch.func.functional_call`` over its own
parameters overlaid with these (``merge_params``): the parameters outside
the subset (the frontend, and with ``ema_encoder_only`` everything but the
trunk) come from the live student, as in JAX.

Under a sharded layout (``parallel/layout.py``) the model holds the rank's
shards, and so do the EMA copies: an FSDP2 parameter's copy is a DTensor of
the same placement, so the EMA step runs on local shards without a
collective (``ema_step``), and the teacher sees whole parameters through
FSDP2's own gathers (``train/pretrain.teacher_encode``). ``create`` with a
``dp`` gives the optimizer the layout's global clipping norm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from animal2vec_tpu_torch.config import FinetuneTrainConfig, PretrainConfig
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti, ema_param_label
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.ops.stats import get_annealed_rate
from animal2vec_tpu_torch.parallel.mesh import DataParallel
from animal2vec_tpu_torch.train.optim import OptaxAdam, Schedule, _local, build_optimizer


def _sharded_norm(opt: OptaxAdam, dp: Optional[DataParallel]) -> OptaxAdam:
    if dp is not None and dp.sharded:
        from animal2vec_tpu_torch.parallel.layout import grad_sq_norm

        opt.grad_sq_norm = lambda named, grads: grad_sq_norm(dp, named, grads)
    return opt


@dataclasses.dataclass
class FinetuneState:
    step: int
    model: FinetuneModel
    optimizer: OptaxAdam
    schedule: Schedule

    @classmethod
    def create(cls, model: FinetuneModel, cfg: FinetuneTrainConfig,
               dp: Optional[DataParallel] = None) -> "FinetuneState":
        opt, schedule = build_optimizer(cfg.optimization, model, model.cfg.prenet_depth,
                                        model.cfg.depth, cfg.layer_decay)
        return cls(step=0, model=model, optimizer=_sharded_norm(opt, dp), schedule=schedule)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad`` (None counts
        as zero) at this step's learning rate; then the step advances."""
        self.optimizer.step(self.schedule(self.step))
        self.step += 1


def ema_subset(model: torch.nn.Module, ema_encoder_only: bool) -> Dict[str, torch.Tensor]:
    """fp32 copies of the teacher's parameters (``ema_subset``)."""
    return {n: p.detach().float().clone() for n, p in model.named_parameters()
            if ema_param_label(n, ema_encoder_only)}


def merge_params(model: torch.nn.Module, overlay: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The student's parameters, detached, overlaid with ``overlay``: the
    teacher's parameters (``merge_params``)."""
    merged = {n: p.detach() for n, p in model.named_parameters()}
    merged.update(overlay)
    return merged


def ema_decay_at(cfg: PretrainConfig, step: int) -> float:
    """The EMA decay at ``step``: ``ema_decay`` annealed linearly to
    ``ema_end_decay`` over ``ema_anneal_end_step`` steps (fp32)."""
    if cfg.ema_decay == cfg.ema_end_decay:
        return float(np.float32(cfg.ema_decay))
    return get_annealed_rate(cfg.ema_decay, cfg.ema_end_decay, step, cfg.ema_anneal_end_step)


@torch.no_grad()
def ema_step(ema: Dict[str, torch.Tensor], model: torch.nn.Module, decay: float) -> None:
    """t += (1 - d) (s - t) for every teacher parameter t and its student
    parameter s, in place, in fp32 (on the local shards of a sharded
    layout)."""
    params = dict(model.named_parameters())
    names = list(ema)
    torch._foreach_lerp_([_local(ema[n]) for n in names],
                         [_local(params[n].detach()).float() for n in names], 1.0 - decay)


@dataclasses.dataclass
class PretrainState:
    step: int
    model: Data2VecMulti
    optimizer: OptaxAdam
    schedule: Schedule
    ema: Dict[str, torch.Tensor]
    cfg: PretrainConfig

    @classmethod
    def create(cls, model: Data2VecMulti, cfg: PretrainConfig,
               dp: Optional[DataParallel] = None) -> "PretrainState":
        opt, schedule = build_optimizer(cfg.optimization, model)
        return cls(step=0, model=model, optimizer=_sharded_norm(opt, dp), schedule=schedule,
                   ema=ema_subset(model, cfg.ema_encoder_only), cfg=cfg)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One optimizer update at this step's learning rate; the step
        advances; then the teacher takes one EMA step at the new step's
        decay, unless the decay has reached 1 (``apply_gradients``)."""
        self.optimizer.step(self.schedule(self.step))
        self.step += 1
        decay = ema_decay_at(self.cfg, self.step)
        if decay < 1.0:
            ema_step(self.ema, self.model, decay)
