"""Finetune train state: the port of ``animal2vec_tpu/train/state.FinetuneState``.

JAX keeps (step, params, opt_state) as one pytree; the port keeps the step,
the model (fp32 master weights), the optimizer (``train.optim.OptaxAdam``,
which holds the Adam moments) and the schedule.
"""

from __future__ import annotations

import dataclasses

from animal2vec_tpu_torch.config import FinetuneTrainConfig
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.train.optim import OptaxAdam, Schedule, build_optimizer


@dataclasses.dataclass
class FinetuneState:
    step: int
    model: FinetuneModel
    optimizer: OptaxAdam
    schedule: Schedule

    @classmethod
    def create(cls, model: FinetuneModel, cfg: FinetuneTrainConfig) -> "FinetuneState":
        opt, schedule = build_optimizer(cfg, model, model.cfg.prenet_depth, model.cfg.depth)
        return cls(step=0, model=model, optimizer=opt, schedule=schedule)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad`` (None counts
        as zero) at this step's learning rate; then the step advances."""
        self.optimizer.step(self.schedule(self.step))
        self.step += 1
