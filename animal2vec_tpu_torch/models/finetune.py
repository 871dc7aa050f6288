"""Frame-level multi-label finetune model: the port of
``animal2vec_tpu/models/finetune.FinetuneModel`` and
``train/build.build_finetune_model``; ``build_image_model``, the image
modality's serving model (a ``Data2VecMulti`` of an ``ImageConfig``); and
``build_pretrain_model`` (``train/build.build_pretrain_model``), the
data2vec-2 model that pretraining trains.

encoder -> fp32 mean of the last k kept trunk MLP taps, cast back -> freeze
gate -> final dropout -> Linear.

``cfg.matmul_impl`` selects the serving numerics of the blocks (bf16,
``int8`` or ``int8_attn``); the int8 weights are quantized from the stored
weights after every ``load_state_dict`` and are not part of the state dict,
so one set of weights serves all three modes.

With ``train`` (a ``FinetuneTrainConfig``) the encoder gets the recipe's
dropouts, layerdrop, trunk drop-path (``drop_path`` at both ends) and
frontend gradient scale as ``train/build.build_finetune_encoder_cfg`` maps
them; without it every rate is 0 (inference). The freeze gate (``finetune.py:69-76``): with
``finetune_encoder`` False the encoder runs under ``torch.no_grad()``, so
only the head gets gradients and no encoder backward runs; JAX returns
zero gradients there, which the optimizer reproduces by filling zeros
(``train.optim``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from animal2vec_tpu_torch.config import (
    FinetuneConfig, FinetuneTrainConfig, ImageConfig, PretrainConfig, check_card_dtype,
)
from animal2vec_tpu_torch.models.audio_encoder import PosConvBlock
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.images import PatchEmbed
from animal2vec_tpu_torch.models.modules import Conv1dBlockNorm, Conv2dBlockNorm
from animal2vec_tpu_torch.ops.dropout import Rngs, dropout


def encoder_rates(train: Optional[FinetuneTrainConfig]) -> dict:
    """The encoder's keyword rates for a training recipe (all 0 for None),
    as ``build_finetune_encoder_cfg`` (``train/build.py:56-82``) sets them."""
    if train is None:
        return {}
    return dict(
        local_grad_mult=train.feature_grad_mult, layerdrop=train.layerdrop,
        prenet_dropout=train.dropout, dropout_input=train.dropout_input,
        mask_noise_std=train.mask_noise_std, encoder_dropout=train.dropout,
        attention_dropout=train.attention_dropout,
        activation_dropout=train.activation_dropout, post_mlp_drop=train.dropout,
    )


class FinetuneModel(nn.Module):
    def __init__(self, cfg: FinetuneConfig, dtype: torch.dtype = torch.float32,
                 train: Optional[FinetuneTrainConfig] = None):
        super().__init__()
        if cfg.num_extra_tokens:
            # JAX's FinetuneModel keeps them in its taps: T + E logits frames
            # against T label frames, on which its finetune step fails
            # (models/finetune.py:57)
            raise NotImplementedError("extra tokens in a finetune model are refused: JAX's "
                                      "finetune step fails on their T + E logits frames "
                                      "(ROADMAP C)")
        self.cfg = cfg
        self.final_dropout = 0.0 if train is None else train.final_dropout
        self.zero_mask = True if train is None else train.zero_mask
        if train is not None:  # the trunk's drop-path is the recipe's at both ends
            cfg = dataclasses.replace(cfg, start_drop_path_rate=train.drop_path,
                                      end_drop_path_rate=train.drop_path)
        # the encoder quantizes the int8 modes' weights after every load
        self.encoder = Data2VecMulti(cfg, dtype, **encoder_rates(train))
        self.proj = nn.Linear(cfg.embed_dim, len(cfg.labels))

    def quantize_weights(self) -> None:
        """Quantize the int8 modes' weights (``cfg.matmul_impl``) of every
        block from the stored ones, into non-persistent buffers; a no-op in
        bf16. Runs after ``load_state_dict``; call it after changing the
        weights any other way."""
        self.encoder.quantize_weights()

    def forward(self, source: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                channel_mask: Optional[torch.Tensor] = None,
                finetune_encoder: bool = True,
                rngs: Optional[Rngs] = None) -> dict:
        """(B, T_wav) -> {"encoder_out": (B, T, n_classes) logits in the
        compute dtype, "padding_mask", "layer_results": per-layer taps (None
        from a pipelined trunk)}. ``mask``/``channel_mask`` apply masking as
        regularization; ``finetune_encoder`` is the freeze gate."""
        k = self.cfg.average_top_k_layers
        with torch.set_grad_enabled(torch.is_grad_enabled() and finetune_encoder):
            res = self.encoder.extract_features(source, "AUDIO", padding_mask, mask,
                                                channel_mask, self.zero_mask, rngs, top_k=k)
            x = res["top_k_mean"].to(res["x"].dtype)
        if self.training and self.final_dropout > 0.0:
            x = dropout(x, self.final_dropout, rngs.device)
        logits = F.linear(x, self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype))
        return {
            "encoder_out": logits,
            "padding_mask": res["padding_mask"],
            "layer_results": res["layer_results"],
        }


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in the JAX package's scheme: xavier-uniform dense
    kernels and patch embeddings, he-normal convs, zero biases; norms,
    PSwish, the sinc filterbank (mel-spaced) and the ALiBi scales keep their
    constructor values; extra tokens N(0, 1), the first 0 where the config
    says so."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, PatchEmbed):
                d, c, p, _ = mod.weight.shape
                bound = math.sqrt(6.0 / ((c + d) * p * p))
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.zero_()
            elif hasattr(mod, "init_extra_tokens"):
                mod.init_extra_tokens(generator)
            if isinstance(mod, (nn.Conv1d, PosConvBlock, Conv1dBlockNorm, Conv2dBlockNorm)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()


def _on(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: CUDA is not available; pass device='cpu' to build on the CPU")
    return device


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def build_finetune_model(cfg: FinetuneConfig, dtype: torch.dtype = torch.float32,
                         seed: int = 0, device="cuda",
                         train: Optional[FinetuneTrainConfig] = None) -> FinetuneModel:
    """An fp32 FinetuneModel on ``device`` (the card unless the caller asks
    for the CPU) that computes in ``dtype``, in eval mode. The weights are
    drawn from ``seed`` on a CPU generator, so they do not depend on the
    device. ``train`` gives the training recipe's rates; ``cfg.matmul_impl``
    int8 modes get their quantized weights."""
    device = _on(device, "build_finetune_model")
    check_card_dtype(cfg, _dtype_name(dtype), device.type)
    model = FinetuneModel(cfg, dtype, train)
    init_params(model, torch.Generator().manual_seed(seed))
    model.quantize_weights()
    return model.to(device).eval()


def pretrain_rates(cfg: PretrainConfig) -> dict:
    """The model's keyword rates of a pretraining recipe (the JAX
    ``ModelConfig`` and modality fields that ``Data2VecMulti`` reads: the
    dropouts, the mask tokens' noise and the frontend's gradient scale)."""
    return dict(
        prenet_dropout=cfg.prenet_dropout, mask_noise_std=cfg.mask_noise_std,
        encoder_dropout=cfg.encoder_dropout, attention_dropout=cfg.attention_dropout,
        activation_dropout=cfg.activation_dropout, post_mlp_drop=cfg.post_mlp_drop,
        dropout_input=cfg.dropout_input, layerdrop=cfg.layerdrop,
        prenet_layerdrop=cfg.prenet_layerdrop, local_grad_mult=cfg.local_grad_mult,
    )


def build_pretrain_model(cfg: PretrainConfig, dtype: torch.dtype = torch.float32, seed: int = 0,
                         device="cuda") -> Data2VecMulti:
    """The data2vec-2 model of ``cfg.model``'s modality with its decoder and
    the recipe's rates: fp32 weights drawn from ``seed`` on a CPU generator
    (so they do not depend on the device), computing in ``dtype``, on
    ``device`` (the card unless the caller asks for the CPU), in train
    mode."""
    device = _on(device, "build_pretrain_model")
    check_card_dtype(cfg.model, _dtype_name(dtype), device.type, cfg.teacher_matmul_impl)
    model = Data2VecMulti(cfg.model, dtype, pretrain=cfg, **pretrain_rates(cfg))
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device).train()


def build_image_model(cfg: ImageConfig, dtype: torch.dtype = torch.float32, seed: int = 0,
                      device="cuda") -> Data2VecMulti:
    """The image modality's serving model, ``extract_features(imgs, "IMAGE")``
    on (B, H, W, 3) images: fp32 weights drawn from ``seed`` on a CPU
    generator (so they do not depend on the device), computing in ``dtype``,
    on ``device`` (the card unless the caller asks for the CPU), in eval
    mode, with ``cfg.matmul_impl``'s int8 weights quantized."""
    device = _on(device, "build_image_model")
    check_card_dtype(cfg, _dtype_name(dtype), device.type)
    model = Data2VecMulti(cfg, dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    model.quantize_weights()
    return model.to(device).eval()
