"""Attention dispatch: the port of ``animal2vec_tpu/models/attention.py``
(``AlibiSpec`` and ``multihead_attention``).

A structured ``AlibiSpec`` goes to the ALiBi flash kernels, which compute
the bias inline; a dense bias (the image modality's 2-D ALiBi) or no bias
goes to the dense-bias flash kernel. The JAX package sends a dense bias to
its TPU flash kernel only at T >= 1024 on a TPU and to ``xla_attention``
otherwise; the port takes its kernel for every CUDA tensor and computes
``xla_attention``'s function at every length (``ops/bias_attention.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_btc
from animal2vec_tpu_torch.ops.bias_attention import bias_flash_attention


@dataclasses.dataclass(frozen=True)
class AlibiSpec:
    """``bias[b, h, i, j] = -slopes[h] * |pos[b, i] - pos[b, j]|`` (zero when
    either position is a negative sentinel and ``has_sentinel``). Carrying
    (slopes, positions) instead of a dense (B, H, T, T) tensor lets the kernel
    compute the bias inline. ``positions`` with leading dim 1 marks the
    batch-uniform layout."""

    slopes: torch.Tensor     # (H,) fp32, learned scale folded in
    positions: torch.Tensor  # (1 or B, T) int32
    has_sentinel: bool = False


# None, a structured ALiBi bias, or a dense fp32 (1 or B, H, T, T) bias
Bias = Union[AlibiSpec, torch.Tensor, None]


def multihead_attention(
    qkv: torch.Tensor,
    heads: int,
    bias: Bias = None,
    padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    h0: int = 0,
    hash_heads: Optional[int] = None,
) -> torch.Tensor:
    """Attention of the (B, T, 3C) qkv projection -> (B, T, C). An
    ``AlibiSpec`` takes ``alibi_flash_attention_btc`` (serving and training,
    with its hash dropout; a tensor-parallel rank's ``heads`` are heads
    ``h0`` .. of ``hash_heads`` there); a dense bias or None takes
    ``bias_flash_attention`` on the q, k, v views of ``qkv`` (serving and
    training, differentiable in the bias too, with the same hash dropout)."""
    if isinstance(bias, AlibiSpec):
        return alibi_flash_attention_btc(qkv, heads, bias.slopes, bias.positions, padding_mask,
                                         bias.has_sentinel, dropout_rate, seed, h0, hash_heads)
    b, t, c3 = qkv.shape
    q, k, v = qkv.reshape(b, t, 3, heads, c3 // (3 * heads)).unbind(2)
    return bias_flash_attention(q, k, v, bias, padding_mask, dropout_rate,
                                seed).reshape(b, t, c3 // 3)
