"""Model and state factories of a training run: the port of
``animal2vec_tpu/train/build.py``.

``build_finetune_encoder_cfg`` turns a pretraining configuration and a
finetune model and recipe into the finetuned model's configuration (the
pretrained encoder's architecture with the finetune run's head, labels and
thresholds) and recipe (the pretrained encoder's mask-token noise);
``load_pretrained_into_finetune`` copies a pretrained student's encoder
into a finetune model's state dict (the finetune model's ``encoder.*`` are
the pretraining model's names; its decoders and the EMA teacher stay
behind); ``init_finetune`` / ``init_pretrain`` build a run's model on its
device with seeded weights and its train state (Adam with the recipe's
layer-decay scales, ``train.optim.layer_decay_scales``), laid over a
``DataParallel``'s mesh where one is given (``parallel.layout.apply_layout``
after the weights are loaded; ``with_pipeline`` copies
``distributed.pipeline_parallel`` into the encoder's ``pipeline_stages``,
JAX's ``_with_pipeline``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from animal2vec_tpu_torch.config import (
    FinetuneConfig, FinetuneTrainConfig, PretrainConfig, RunConfig,
)
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.finetune import (
    FinetuneModel, build_finetune_model, build_pretrain_model,
)
from animal2vec_tpu_torch.parallel.layout import apply_layout
from animal2vec_tpu_torch.parallel.mesh import DataParallel
from animal2vec_tpu_torch.train.state import FinetuneState, PretrainState

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the encoder's architecture: what a finetune model takes from its pretraining
ENCODER_FIELDS = ("conv_layers", "sample_rate", "sinc_norm", "use_pswish", "conv_pos_width",
                  "conv_pos_groups", "conv_pos_depth", "prenet_depth", "depth", "embed_dim",
                  "num_heads", "mlp_ratio", "norm_eps", "alibi_scale", "end_of_block_targets")


def with_pipeline(model: FinetuneConfig, run: RunConfig) -> FinetuneConfig:
    """``model`` with ``distributed.pipeline_parallel`` as its
    ``pipeline_stages`` (``_with_pipeline``, ``train/build.py:40-47``), so
    that one key sets both the mesh axis and the trunk's schedule."""
    pp = run.distributed.pipeline_parallel
    if pp > 1 and model.pipeline_stages == 1:
        return dataclasses.replace(model, pipeline_stages=pp)
    return model


def _laid_out(model, run: RunConfig, cfg: FinetuneConfig, dp: Optional[DataParallel]):
    """``model`` in ``dp``'s layout; the trunk's stages are the config's
    (``with_pipeline``), which must be the mesh's "stage" axis."""
    stages = 1 if dp is None else dp.stage.size
    if cfg.pipeline_stages != stages:
        raise ValueError(
            f"model.pipeline_stages={cfg.pipeline_stages} but the mesh has {stages} stage(s): "
            "JAX warns and runs the plain scan there (models/modules.py:797-824), the port "
            "raises; set distributed.pipeline_parallel")
    return model if dp is None else apply_layout(model, dp, cfg.pipeline_microbatches)


def build_finetune_encoder_cfg(pre: PretrainConfig, model: FinetuneConfig,
                               recipe: FinetuneTrainConfig
                               ) -> Tuple[FinetuneConfig, FinetuneTrainConfig]:
    """The finetuned model's configuration and recipe for an encoder
    pretrained with ``pre``: the encoder architecture of ``pre.model``,
    the head (top-k taps, labels), thresholds and serving numerics of
    ``model``; ``recipe`` with the pretrained encoder's mask-token noise.
    The recipe's dropouts, layerdrop and frontend gradient scale then reach
    the encoder as ``models.finetune.encoder_rates`` maps them; the
    decoders are not built and the EMA is not kept."""
    arch = {name: getattr(pre.model, name) for name in ENCODER_FIELDS}
    return (dataclasses.replace(model, **arch),
            dataclasses.replace(recipe, mask_noise_std=pre.mask_noise_std))


def load_pretrained_into_finetune(ft_state: Mapping[str, torch.Tensor],
                                  pre_state: Mapping[str, torch.Tensor],
                                  load_pretrain_weights: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """``ft_state`` (a finetune model's state dict) with every entry of the
    pretrained student's ``pre_state`` that the finetune encoder has
    (``encoder.`` + its name) copied in; the rest (the decoders, the
    reconstruction head) is dropped. With ``load_pretrain_weights`` the
    pretraining probe's ``linear_eval_projection`` becomes the head
    ``proj`` where the pretrained model has one (``build.py:151-155``).
    Raises if a shape differs or nothing matched."""
    out = dict(ft_state)
    loaded = 0
    for name, value in pre_state.items():
        target = "encoder." + name
        if target in out:
            if out[target].shape != value.shape:
                raise ValueError(f"{name}: pretrained shape {tuple(value.shape)} != finetune "
                                 f"{tuple(out[target].shape)}")
            out[target] = value.to(out[target].dtype)
            loaded += 1
    if load_pretrain_weights:
        for leaf in ("weight", "bias"):
            probe = pre_state.get(f"linear_eval_projection.{leaf}")
            if probe is not None and f"proj.{leaf}" in out:
                out[f"proj.{leaf}"] = probe.to(out[f"proj.{leaf}"].dtype)
    if not loaded:
        raise ValueError("no pretrained weights matched the finetune encoder")
    return out


def init_finetune(run: RunConfig, device, pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                  dp: Optional[DataParallel] = None) -> Tuple[FinetuneModel, FinetuneState]:
    """The run's finetune model (weights from ``common.seed``, or the
    pretrained encoder's where given) on ``device`` in ``dp``'s layout, and
    its state."""
    run.check_card_dtype(torch.device(device).type)
    cfg = with_pipeline(run.model, run)
    model = build_finetune_model(cfg, dtype=DTYPES[run.common.compute_dtype],
                                 seed=run.common.seed, device=device, train=run.finetune)
    if pretrained is not None:
        model.load_state_dict(load_pretrained_into_finetune(
            model.state_dict(), pretrained, run.finetune.load_pretrain_weights), strict=True)
    model = _laid_out(model, run, cfg, dp)
    return model, FinetuneState.create(model, run.finetune, dp)


def init_pretrain(run: RunConfig, device, dp: Optional[DataParallel] = None
                  ) -> Tuple[Data2VecMulti, PretrainState]:
    """The run's pretraining model (weights from ``common.seed``) on
    ``device`` in ``dp``'s layout, and its state with the EMA teacher."""
    run.check_card_dtype(torch.device(device).type)
    cfg = with_pipeline(run.pretrain.model, run)
    pcfg = dataclasses.replace(run.pretrain, model=cfg)
    model = build_pretrain_model(pcfg, dtype=DTYPES[run.common.compute_dtype],
                                 seed=run.common.seed, device=device)
    model = _laid_out(model, run, cfg, dp)
    return model, PretrainState.create(model, pcfg, dp)
