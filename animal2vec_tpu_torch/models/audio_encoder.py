"""Audio modality encoder: the port of ``animal2vec_tpu/models/audio_encoder.py``
(conv frontend, feature projection, grouped-conv relative positions with an
optional LayerNorm before them, prenet, the learned ALiBi scale (per head or
shared by the heads, for all blocks or one per block) or no ALiBi, the
extra (CLS) tokens and the pretraining ``Decoder1d``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from animal2vec_tpu_torch.config import DecoderConfig, FinetuneConfig
from animal2vec_tpu_torch.models.attention import AlibiSpec
from animal2vec_tpu_torch.models.frontend import ConvFeatureExtractor
from animal2vec_tpu_torch.models.modules import (
    Decoder1d, Fp32LayerNorm, PrenetEncoder, conv1d_same,
)
from animal2vec_tpu_torch.ops.alibi import alibi_slopes
from animal2vec_tpu_torch.ops.conv_arith import strided_pad_1d


class PosConvBlock(nn.Module):
    """Grouped conv (k, groups) -> LayerNorm (no affine, fp32) -> GELU. The
    conv pads (k//2, k//2 - (k even)): a k//2 conv pad followed by SamePad."""

    def __init__(self, dim: int, kernel: int, groups: int):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight = nn.Parameter(torch.zeros(dim, dim // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.norm = Fp32LayerNorm(dim, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        pad = (k // 2, k // 2 - (1 if k % 2 == 0 else 0))
        y = conv1d_same(x, self.weight, self.bias, 1, self.groups, pad=pad)
        return F.gelu(self.norm(y))


class AudioEncoder(nn.Module):
    """``local_grad_mult`` scales the gradient into the conv frontend
    (``grad_multiply``, ``audio_encoder.py:32-39, 169-177``); at 0 the frontend
    runs under ``torch.no_grad()``, which stops the gradient as JAX's
    ``stop_gradient`` does and keeps no activations for a backward. The
    prenet takes ``prenet_dropout``, ``layerdrop``, the block rates and the
    config's ``matmul_impl``, as the trunk does (one ``BlockConfig``,
    ``data2vec2.py:52-68``). ``decoder`` adds the pretraining ``Decoder1d``.
    With ``remat_frontend`` a training forward recomputes the conv frontend
    in the backward (``torch.utils.checkpoint``; the frontend draws
    nothing)."""

    def __init__(self, cfg: FinetuneConfig, local_grad_mult: float = 1.0,
                 prenet_dropout: float = 0.0, layerdrop: float = 0.0,
                 decoder: Optional[DecoderConfig] = None, **rates):
        super().__init__()
        self.local_grad_mult = local_grad_mult
        self.remat_frontend = cfg.remat_frontend
        self.conv_layers = [tuple(c) for c in cfg.conv_layers]
        feature_dim = self.conv_layers[-1][0]
        self.local_encoder = ConvFeatureExtractor(
            self.conv_layers, cfg.sample_rate, cfg.sinc_norm, cfg.use_pswish, cfg.sinc_input,
            cfg.apply_window_to_root, cfg.extractor_mode,
        )
        self.project_norm = Fp32LayerNorm(feature_dim)
        self.project_linear = nn.Linear(feature_dim, cfg.embed_dim)
        k = max(3, cfg.conv_pos_width // cfg.conv_pos_depth)
        if cfg.conv_pos_pre_ln:
            self.pos_pre_ln = Fp32LayerNorm(cfg.embed_dim)
        self.pos_blocks = nn.ModuleList(
            PosConvBlock(cfg.embed_dim, k, cfg.conv_pos_groups)
            for _ in range(cfg.conv_pos_depth)
        )
        self.context_encoder = PrenetEncoder(
            cfg.prenet_depth, cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.norm_eps,
            prenet_dropout, layerdrop, cfg.matmul_impl, layer_norm_first=cfg.layer_norm_first,
            norm_affine=cfg.norm_affine,
            drop_path=(cfg.prenet_start_drop_path_rate, cfg.prenet_end_drop_path_rate),
            **rates,
        )
        # a learned scale per head, or one shared by the heads, for all
        # layers or one per block (prenet, then trunk): (1 or n_blocks, 1, H
        # or 1, 1, 1); none without ALiBi
        self.alibi_scale = None
        if cfg.use_alibi_encoder:
            n_scales = cfg.n_blocks if cfg.learned_alibi_scale_per_layer else 1
            n_heads = cfg.num_heads if cfg.learned_alibi_scale_per_head else 1
            self.alibi_scale = nn.Parameter(
                torch.full((n_scales, 1, n_heads, 1, 1), float(cfg.alibi_scale)))
        self.init_extra_token_zero = cfg.init_extra_token_zero
        if cfg.num_extra_tokens:
            self.extra_tokens = nn.Parameter(torch.zeros(1, cfg.num_extra_tokens, cfg.embed_dim))
        self.register_buffer(
            "base_slopes", torch.from_numpy(alibi_slopes(cfg.num_heads).copy()),
            persistent=False,
        )
        if decoder is not None:
            self.decoder = Decoder1d(cfg.embed_dim, cfg.embed_dim, decoder.decoder_dim,
                                     decoder.decoder_kernel, decoder.decoder_groups,
                                     decoder.decoder_layers, decoder.decoder_residual,
                                     decoder.projection_layers, decoder.projection_ratio)

    def local_features(self, source: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, T_wav) -> (B, T_feat, embed): conv stack + fp32 LN + linear."""
        mult = self.local_grad_mult
        if mult == 0.0:
            with torch.no_grad():
                x = self.local_encoder(source, dtype)
        elif self.remat_frontend and self.training and torch.is_grad_enabled():
            x = checkpoint(self.local_encoder, source, dtype, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = self.local_encoder(source, dtype)
            if mult != 1.0:
                x = x * mult + x.detach() * (1.0 - mult)
        x = self.project_norm(x)
        w = self.project_linear
        return F.linear(x, w.weight.to(x.dtype), w.bias.to(x.dtype))

    def relative_positions(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "pos_pre_ln"):
            x = self.pos_pre_ln(x)
        for blk in self.pos_blocks:
            x = blk(x)
        return x

    def prenet(self, x, padding_mask, bias: AlibiSpec, rngs=None, scales=None) -> torch.Tensor:
        return self.context_encoder(x, padding_mask, bias, rngs, scales)

    def init_extra_tokens(self, generator: torch.Generator) -> None:
        """The extra tokens' seeded init (``audio_encoder.py:154-163``): N(0,
        1), the first token 0 with ``init_extra_token_zero``."""
        if hasattr(self, "extra_tokens"):
            tok = self.extra_tokens
            tok.normal_(0.0, 1.0, generator=generator)
            if self.init_extra_token_zero:
                tok[:, 0] = 0.0

    def alibi_spec(self, positions: torch.Tensor,
                   has_sentinel: bool = False) -> Optional[AlibiSpec]:
        """Structured ALiBi (``alibi_spec``): one learned scale, clipped at
        0, folded into the slopes (per head, or one value for every head);
        with one scale per block the slopes stay unscaled (``layer_scales``).
        ``positions`` (1, T) batch-uniform, or (B, K) int32 per row (a
        pretraining student's keep-set ids, ``data2vec2.py:280-281``), the
        extra tokens' at the -1 sentinel (``has_sentinel``). None without
        ALiBi: the attention takes no bias."""
        if self.alibi_scale is None:
            return None
        scale = torch.clamp(self.alibi_scale.float(), min=0.0)
        slopes = self.base_slopes if scale.shape[0] > 1 else \
            self.base_slopes * scale[0].reshape(-1)
        return AlibiSpec(slopes, positions, has_sentinel)

    def layer_scales(self) -> Optional[torch.Tensor]:
        """The (n_blocks, H or 1) per-block scales clipped at 0 (prenet,
        then trunk) for ``BlockStack``, or None with one scale or none."""
        if self.alibi_scale is None or self.alibi_scale.shape[0] == 1:
            return None
        return torch.clamp(self.alibi_scale.float(), min=0.0).reshape(
            self.alibi_scale.shape[0], -1)

    def convert_padding_mask(self, padding_mask: torch.Tensor, t_feat: int) -> torch.Tensor:
        """(B, T_wav) bool pad mask -> (B, T_feat) through the strided layers'
        length arithmetic."""
        out_len = (~padding_mask.bool()).sum(dim=-1)
        for _, k, s in self.conv_layers:
            if s == 1:
                continue
            p = strided_pad_1d(s)[0]
            out_len = torch.div(out_len + 2 * p - k, s, rounding_mode="floor") + 1
        idx = torch.arange(t_feat, device=padding_mask.device)[None, :]
        return idx >= out_len[:, None]
