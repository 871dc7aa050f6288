"""The image modality's encoder: the port of ``animal2vec_tpu/models/images.py``
(``sincos_pos_embed_2d``, ``PatchEmbed``, ``patchify``/``unpatchify`` and
``ImageEncoder`` with its ``Decoder2d`` for pretraining).

Images come in NHWC, (B, H, W, C), as in JAX. ``local_features`` cuts them
into p x p patches with a stride-p conv (a stock conv, as XLA composed it)
and projects them to the model width when the patch width differs; the trunk
and the prenet are the port's AltBlocks. With ``use_alibi_encoder`` every
attention of the model takes one fp32 (1, H, P, P) bias: the 2-D ALiBi bias
of the patch grid times the learned scale, clipped at 0. A pretraining
student takes it per row at its keep-set (``masked_alibi``): (B, H, K, K)
fp32, the gathered grid bias times the scale, so that the attention's bias
gradient reaches the learned scale.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from animal2vec_tpu_torch.config import DecoderConfig, ImageConfig
from animal2vec_tpu_torch.models.modules import Decoder2d, PrenetEncoder
from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d
from animal2vec_tpu_torch.ops.masking import MaskInfo, masked_alibi


def sincos_pos_embed_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2-D sin-cos positional table, (grid * grid, embed_dim) fp32,
    computed in float64 (``images.py:29-41``)."""
    def embed_1d(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (embed_dim / 4.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w first, as the reference
    emb = np.concatenate([embed_1d(grid[0]), embed_1d(grid[1])], axis=1)
    return emb.astype(np.float32)


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, P, p * p * C) (``images.py:73-80``)."""
    b, hh, ww, c = imgs.shape
    p = patch_size
    h, w = hh // p, ww // p
    x = imgs.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Inverse of ``patchify`` (``images.py:83-91``)."""
    b, t, d = x.shape
    p = patch_size
    h = w = int(np.sqrt(t))
    c = d // (p * p)
    x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, c)


class PatchEmbed(nn.Module):
    """Conv2d patchifier, (B, H, W, C) -> (B, P, D) (``images.py:44-70``):
    weight (D, C, p, p), the bias added after the conv in the compute dtype."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.zeros(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def forward(self, imgs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = imgs.permute(0, 3, 1, 2).to(dtype)  # NCHW
        y = F.conv2d(x, self.weight.to(dtype), stride=self.patch_size)
        return y.flatten(2).transpose(1, 2) + self.bias.to(dtype)


class ImageEncoder(nn.Module):
    """The image branch's parameters and sub-computations (``ImageEncoder``,
    ``images.py:94-193``); the orchestration is ``models/data2vec2.py``'s.
    The prenet takes ``prenet_dropout``, ``layerdrop`` and the block rates;
    ``decoder`` adds the pretraining ``Decoder2d`` (JAX's has no projection
    head: ``projection_layers`` is read by ``Decoder1d`` only)."""

    def __init__(self, cfg: ImageConfig, prenet_dropout: float = 0.0, layerdrop: float = 0.0,
                 decoder: Optional[DecoderConfig] = None, local_grad_mult: float = 1.0,
                 **rates: float):
        super().__init__()
        self.cfg, self.local_grad_mult = cfg, local_grad_mult
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, cfg.patch_embed_dim)
        if cfg.patch_embed_dim != cfg.embed_dim:
            self.patch_proj = nn.Linear(cfg.patch_embed_dim, cfg.embed_dim)
        self.register_buffer("pos_embed", torch.from_numpy(
            sincos_pos_embed_2d(cfg.embed_dim, cfg.grid_size))[None], persistent=False)
        self.context_encoder = PrenetEncoder(
            cfg.prenet_depth, cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.norm_eps,
            prenet_dropout, layerdrop, matmul_impl=cfg.matmul_impl,
            layer_norm_first=cfg.layer_norm_first, ffn_targets=not cfg.end_of_block_targets,
            **rates,
        )
        if decoder is not None:
            self.decoder = Decoder2d(cfg.embed_dim, cfg.embed_dim, decoder.decoder_dim,
                                     decoder.decoder_kernel, decoder.decoder_groups,
                                     decoder.decoder_layers, cfg.grid_size,
                                     decoder.decoder_residual)
        if cfg.use_alibi_encoder:
            n_heads = cfg.num_heads if cfg.learned_alibi_scale_per_head else 1
            n_scales = cfg.n_blocks if cfg.learned_alibi_scale_per_layer else 1
            self.alibi_scale = nn.Parameter(torch.full((n_scales, 1, n_heads, 1, 1),
                                                       cfg.alibi_scale))
            self.register_buffer("alibi_bias", torch.from_numpy(alibi_bias_2d(
                cfg.num_patches, cfg.num_heads, cfg.alibi_distance)), persistent=False)

    def local_features(self, imgs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) -> (B, P, embed_dim) in ``dtype``; with
        ``local_grad_mult`` 0 without gradient (any other value leaves the
        gradient as it is, as in JAX, ``images.py:167-174``)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.local_grad_mult != 0.0):
            x = self.patch_embed(imgs, dtype)
            if self.cfg.patch_embed_dim != self.cfg.embed_dim:
                x = F.linear(x, self.patch_proj.weight.to(dtype), self.patch_proj.bias.to(dtype))
        return x

    def fixed_positions(self, x: torch.Tensor) -> torch.Tensor:
        if not self.cfg.fixed_positions:
            return x
        return x + self.pos_embed.to(x.dtype)

    def scaled_alibi(self, mask_info: Optional[MaskInfo] = None) -> Optional[torch.Tensor]:
        """The fp32 attention bias of every block, or None (``scaled_alibi``,
        ``images.py:158-165``): (1, H, P, P), or with ``mask_info`` each
        row's (B, H, K, K) keep-set bias (``masked_alibi``,
        ``data2vec2.py:295-298``), times the learned scale clipped at 0; with
        one scale per block unscaled (``layer_scales``)."""
        if not self.cfg.use_alibi_encoder:
            return None
        bias = self.alibi_bias[None] if mask_info is None else masked_alibi(
            self.alibi_bias[None], mask_info)
        if self.alibi_scale.shape[0] > 1:
            return bias
        return bias * self.alibi_scale.float().clamp_min(0.0)[0].reshape(-1, 1, 1)

    def layer_scales(self) -> Optional[torch.Tensor]:
        """The (n_blocks, H or 1) per-block scales clipped at 0, or None
        with one scale (or no ALiBi)."""
        if not self.cfg.use_alibi_encoder or self.alibi_scale.shape[0] == 1:
            return None
        return self.alibi_scale.float().clamp_min(0.0).reshape(self.alibi_scale.shape[0], -1)

    def prenet(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], rngs=None, scales=None) -> torch.Tensor:
        return self.context_encoder(x, padding_mask, bias, rngs, scales)
