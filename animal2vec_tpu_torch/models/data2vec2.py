"""The data2vec-2 encoder: the port of
``animal2vec_tpu/models/data2vec2.Data2VecMulti.extract_features`` and
``encode`` without keep-set removal (``data2vec2.py:215-374``, ``:443-478``),
for one modality per model, as the JAX package's ``supported_modality``: the
audio encoder of the finetune model (a ``FinetuneConfig``), or the image
encoder of the image serving model (an ``ImageConfig``,
``build_image_model``).

The image arm (serving only): patches, the fixed 2-D sin-cos positions, the
2-D ALiBi bias when ``use_alibi_encoder`` (one dense fp32 (1, H, P, P) bias
for every block), the prenet, the trunk, and with pre-LN blocks the trunk's
final LayerNorm (``data2vec2.py:117-120, 203-213, 247-248, 293-302, 368-369``).

Training applies masking as regularization in place: masked time steps are
zeroed or, with ``zero_mask`` False, filled with ``mask_noise_std * N(0, 1)``,
and a channel mask zeroes whole feature channels, before the relative
positions (``data2vec2.py:250-272``). Positions stay batch-uniform (1, T).

The JAX trunk pads the sequence to the TPU kernel's block length
(``data2vec2.py:318-344``). In bf16 and ``int8`` the pad rows change no real
row (they are masked keys, and every other op is per row), so the port does
not pad and the attention kernels mask the ragged tail by bounds. In
``int8_attn`` they do: the per-channel v scales of the int8 attention span
every row of the padded sequence. There the port pads as JAX does (zero
rows at position 0, masked as keys, run through prenet and trunk, cut off
after it), so that its scales are JAX's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from animal2vec_tpu_torch.config import FinetuneConfig, ImageConfig
from animal2vec_tpu_torch.models.audio_encoder import AudioEncoder
from animal2vec_tpu_torch.models.images import ImageEncoder
from animal2vec_tpu_torch.models.modules import AltBlock, BlockStack, Fp32LayerNorm
from animal2vec_tpu_torch.ops.attention import int8_spans
from animal2vec_tpu_torch.ops.dropout import Rngs, dropout
from animal2vec_tpu_torch.ops.masking import apply_mask


class Data2VecMulti(nn.Module):
    """The encoder of the modality ``cfg`` describes ("AUDIO" for a
    ``FinetuneConfig``, "IMAGE" for an ``ImageConfig``). ``rates`` are the
    audio encoder's training dropouts (all 0 for inference):
    ``encoder_dropout``, ``attention_dropout``, ``activation_dropout`` and
    ``post_mlp_drop`` for every block, ``layerdrop`` and ``prenet_dropout``,
    ``dropout_input`` after the prenet, ``local_grad_mult`` for the frontend
    and ``mask_noise_std`` for the noise fill."""

    def __init__(self, cfg: Union[FinetuneConfig, ImageConfig],
                 dtype: torch.dtype = torch.float32,
                 local_grad_mult: float = 1.0, layerdrop: float = 0.0,
                 prenet_dropout: float = 0.0, dropout_input: float = 0.0,
                 mask_noise_std: float = 0.01, **rates: float):
        super().__init__()
        self.dtype = dtype
        self.mode = "IMAGE" if isinstance(cfg, ImageConfig) else "AUDIO"
        self.pad_trunk = cfg.matmul_impl == "int8_attn" and self.mode == "AUDIO"
        self.dropout_input, self.mask_noise_std = dropout_input, mask_noise_std
        block_kw = dict(rates)
        if self.mode == "IMAGE":
            block_kw.update(layer_norm_first=cfg.layer_norm_first,
                            ffn_targets=not cfg.end_of_block_targets)
            self.image_encoder = ImageEncoder(cfg)
            self.norm = Fp32LayerNorm(cfg.embed_dim, cfg.norm_eps) if cfg.layer_norm_first else None
        else:
            self.audio_encoder = AudioEncoder(cfg, local_grad_mult, prenet_dropout, layerdrop,
                                              **rates)
        self.blocks = BlockStack(
            cfg.depth, cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.norm_eps, layerdrop,
            cfg.matmul_impl, **block_kw,
        )
        # the int8 modes' buffers follow every load of the weights
        self.register_load_state_dict_post_hook(lambda module, _: module.quantize_weights())

    def quantize_weights(self) -> None:
        """Quantize the int8 modes' weights (``cfg.matmul_impl``) of every
        block from the stored ones, into non-persistent buffers; a no-op in
        bf16. Runs after every ``load_state_dict``; call it after changing
        the weights any other way."""
        for mod in self.modules():
            if isinstance(mod, AltBlock):
                mod.quantize_weights()

    def encode(self, local: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               channel_mask: Optional[torch.Tensor] = None, zero_mask: bool = True,
               rngs: Optional[Rngs] = None):
        """Masking, relative positions, prenet and trunk on (B, T, C) local
        features; returns (x, per-layer taps, padding_mask, layer keeps)."""
        enc = self.audio_encoder
        x = local
        if mask is not None:
            x = apply_mask(x, mask.to(x.device), zero_mask, self.mask_noise_std,
                           None if zero_mask else rngs.device)
        if channel_mask is not None:
            x = x * (1 - channel_mask.to(x.device, x.dtype)[:, None, :])
        x = x + enc.relative_positions(x)
        # (1, T): batch-uniform contiguous positions (the kernel's uniform case)
        t = x.shape[1]
        positions = torch.arange(t, dtype=torch.int32, device=x.device)[None]
        run_mask = padding_mask
        pad = int8_spans(t)[1] - t if self.pad_trunk else 0
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            positions = F.pad(positions, (0, pad))
            if run_mask is None:
                run_mask = torch.zeros((x.shape[0], t), dtype=torch.bool, device=x.device)
            run_mask = F.pad(run_mask.bool(), (0, pad), value=True)
        bias = enc.alibi_spec(positions)
        x = enc.prenet(x, run_mask, bias, rngs)
        if self.training and self.dropout_input > 0.0:
            x = dropout(x, self.dropout_input, rngs.device)
        x, taps, keeps = self.blocks(x, run_mask, bias, rngs)
        if pad:
            x, taps = x[:, :t], [tap[:, :t] for tap in taps]
        return x, taps, padding_mask, keeps

    def encode_image(self, local: torch.Tensor):
        """Positions, the 2-D ALiBi bias, prenet, trunk and the pre-LN final
        norm on (B, P, C) patch features; returns (x, per-layer taps)."""
        enc = self.image_encoder
        x = enc.fixed_positions(local)
        bias = enc.scaled_alibi()
        x = enc.prenet(x, bias)
        x, taps, _ = self.blocks(x, None, bias)
        if self.norm is not None:
            x = self.norm(x)
        return x, taps

    def extract_features(self, source: torch.Tensor, mode: str = "AUDIO",
                         padding_mask: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         channel_mask: Optional[torch.Tensor] = None,
                         zero_mask: bool = True, rngs: Optional[Rngs] = None) -> dict:
        """The model's modality ``mode`` ("AUDIO" or "IMAGE", as the JAX
        method takes it) -> {"x", "layer_results" (list of taps),
        "padding_mask", "layer_keeps"}.

        AUDIO: a (B, T_wav) waveform; ``mask`` (B, T_feat) and
        ``channel_mask`` (B, C) are 0/1, 1 = masked. IMAGE (serving): (B, H,
        W, C) images, no masks."""
        if mode.upper() != self.mode:
            raise ValueError(f"this model encodes {self.mode}, not {mode!r}")
        if self.mode == "IMAGE":
            if self.training or padding_mask is not None or mask is not None \
                    or channel_mask is not None:
                raise NotImplementedError("the image modality is ported for serving only: "
                                          "eval(), no masks")
            x, taps = self.encode_image(self.image_encoder.local_features(source, self.dtype))
            return {"x": x, "layer_results": taps, "padding_mask": None, "layer_keeps": None}
        enc = self.audio_encoder
        local = enc.local_features(source, self.dtype)
        if padding_mask is not None:
            padding_mask = enc.convert_padding_mask(padding_mask, local.shape[1])
        x, taps, pad, keeps = self.encode(local, padding_mask, mask, channel_mask, zero_mask,
                                          rngs)
        return {"x": x, "layer_results": taps, "padding_mask": pad, "layer_keeps": keeps}
