"""Static-count masking: the port of ``animal2vec_tpu/ops/masking.py``
(``expected_span_mask_tokens``, ``span_mask``, ``exactify_mask``,
``channel_mask`` and ``apply_mask`` for finetuning; ``block_mask_2d``,
``MaskInfo``, ``make_mask_info_static``, ``gather_keep``,
``scatter_with_mask_tokens`` and ``masked_alibi`` for pretraining).

Every row gets exactly M masked tokens, M a function of the hyper-
parameters (``expected_span_mask_tokens``): n_spans distinct starts per row
are dilated to length-L spans, then each row is adjusted to M tokens by a
top-k over ``mask + uniform noise`` that prefers the span-masked tokens.
Each sampler takes an explicit ``torch.Generator``; the masks are drawn
where the generator lives (the training step draws them on the host).
``jax.random`` and torch give different draws from one seed, so the tests
hold the samplers to their invariants and the deterministic parts to JAX.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch


@lru_cache(maxsize=128)
def expected_span_mask_tokens(
    time_steps: int,
    mask_prob: float,
    mask_length: int,
    mask_dropout: float = 0.0,
    require_min: int = 1,
) -> int:
    """Static number of masked tokens M per row: the expected union coverage
    of n_spans = int(mask_prob * T / L + 0.5) length-L spans."""
    n_spans = int(mask_prob * time_steps / float(mask_length) + 0.5)
    n_spans = max(require_min, min(n_spans, time_steps - mask_length + 1))
    q = n_spans / float(time_steps - mask_length + 1)
    coverage = 1.0 - (1.0 - q) ** mask_length
    m = int(round(time_steps * coverage * (1.0 - mask_dropout)))
    return int(np.clip(m, require_min, time_steps - 1))


def exactify_mask(mask: torch.Tensor, m_tokens: int, generator: torch.Generator) -> torch.Tensor:
    """Force exactly ``m_tokens`` ones per row of a (B, T) 0/1 mask,
    preferring existing ones; int32 out."""
    b, t = mask.shape
    noise = torch.rand((b, t), generator=generator, device=generator.device)
    priority = mask.to(noise.device, torch.float32) + noise
    top_idx = torch.topk(priority, m_tokens, dim=1).indices
    out = torch.zeros((b, t), dtype=torch.int32, device=noise.device)
    return out.scatter_(1, top_idx, 1)


def span_mask(
    batch: int,
    time_steps: int,
    mask_prob: float,
    mask_length: int,
    generator: torch.Generator,
    mask_dropout: float = 0.0,
) -> torch.Tensor:
    """(B, T) int32 span mask with exactly M masked tokens per row."""
    m_tokens = expected_span_mask_tokens(time_steps, mask_prob, mask_length, mask_dropout)
    n_spans = int(mask_prob * time_steps / float(mask_length) + 0.5)
    n_spans = max(1, min(n_spans, time_steps - mask_length + 1))
    dev = generator.device
    noise = torch.rand((batch, time_steps - mask_length + 1), generator=generator, device=dev)
    starts = torch.argsort(noise, dim=1)[:, :n_spans]  # distinct starts per row
    base = torch.zeros((batch, time_steps), dtype=torch.int32, device=dev).scatter_(1, starts, 1)
    # dilate: position t masked if any start in [t-L+1, t]
    mask = base.clone()
    for shift in range(1, mask_length):
        mask[:, shift:] = torch.maximum(mask[:, shift:], base[:, :-shift])
    return exactify_mask(mask, m_tokens, generator)


def channel_mask(
    batch: int,
    channels: int,
    mask_channel_prob: float,
    mask_channel_length: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """(B, C) channel-span mask (SpecAugment-style)."""
    return span_mask(batch, channels, mask_channel_prob, mask_channel_length, generator)


def apply_mask(
    x: torch.Tensor,
    mask: torch.Tensor,
    zero_mask: bool = True,
    noise_std: float = 0.01,
    generator: torch.Generator = None,
) -> torch.Tensor:
    """Zero (``zero_mask``) or fill with ``noise_std * N(0, 1)`` the masked
    positions of (B, T, C) ``x``; ``mask`` (B, T), 1 = masked."""
    m = mask[..., None].to(x.dtype)
    if zero_mask:
        return x * (1 - m)
    if generator is None:
        raise ValueError("the noise fill needs a generator")
    noise = noise_std * torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x * (1 - m) + noise * m


def block_mask_2d(
    batch: int,
    num_patches: int,
    mask_prob: float,
    mask_length: int,
    generator: torch.Generator,
    mask_prob_adjust: float = 0.0,
    inverse_mask: bool = False,
) -> torch.Tensor:
    """(B, P) int32 2-D block mask of a square patch grid with a static count:
    int((mask_prob + mask_prob_adjust) * P / L^2) block seeds drawn on the
    grid, dilated to L x L blocks down and to the right, then exactified to
    int(P * mask_prob) tokens, or with ``inverse_mask`` the complement
    exactified to P less that, clipped to [1, P - 1] (JAX's
    ``block_mask_2d``)."""
    n = int(np.sqrt(num_patches))
    if n * n != num_patches:
        raise ValueError(f"num_patches={num_patches} is not a square grid")
    target = int(num_patches * mask_prob)
    n_seeds = max(1, int((mask_prob + mask_prob_adjust) * num_patches / (mask_length**2)))
    dev = generator.device
    noise = torch.rand((batch, num_patches), generator=generator, device=dev)
    seeds = torch.argsort(noise, dim=1)[:, :n_seeds]
    grid = torch.zeros((batch, num_patches), dtype=torch.int32, device=dev).scatter_(1, seeds, 1)
    grid = grid.reshape(batch, n, n)
    out = grid.clone()
    for di in range(mask_length):
        for dj in range(mask_length):
            out[:, di:, dj:] = torch.maximum(out[:, di:, dj:], grid[:, :n - di, :n - dj])
    mask = out.reshape(batch, num_patches)
    if inverse_mask:
        mask, target = 1 - mask, num_patches - target
    return exactify_mask(mask, max(1, min(target, num_patches - 1)), generator)


class MaskInfo(NamedTuple):
    """A static-count mask and its bookkeeping: ``mask`` (B, T) int32, 1 =
    masked; ``ids_shuffle`` (B, T), the stable argsort of the mask (kept
    positions first, in order); ``ids_restore`` (B, T), its inverse;
    ``ids_keep`` (B, K), the kept positions (``ids_shuffle[:, :K]``, with
    ``keep_masked_pct`` the first masked ones too)."""

    mask: torch.Tensor
    ids_shuffle: torch.Tensor
    ids_restore: torch.Tensor
    ids_keep: torch.Tensor


def make_mask_info_static(mask: torch.Tensor, m_tokens: int,
                          keep_masked_pct: float = 0.0) -> MaskInfo:
    """The ``MaskInfo`` of a (B, T) mask with ``m_tokens`` masked per row;
    ``keep_masked_pct`` keeps round(m_tokens * pct) of the masked tokens
    (the first in position order) in the keep-set."""
    t = mask.shape[1]
    mask = mask.to(torch.int32)
    ids_shuffle = torch.argsort(mask, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    len_keep = t - m_tokens
    if keep_masked_pct > 0:
        len_keep += round((t - len_keep) * keep_masked_pct)
    return MaskInfo(mask, ids_shuffle, ids_restore, ids_shuffle[:, :len_keep])


def take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) at the (B, K) time indices ``ids`` -> (B, K, C)."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def gather_keep(x: torch.Tensor, mask_info: MaskInfo) -> torch.Tensor:
    """The kept tokens: (B, T, C) -> (B, K, C)."""
    return take_rows(x, mask_info.ids_keep)


def scatter_with_mask_tokens(
    x_keep: torch.Tensor,
    mask_info: MaskInfo,
    noise_std: float,
    generator: Optional[torch.Generator] = None,
    num_extra: int = 0,
) -> torch.Tensor:
    """The decoder's input: (B, K, C) kept tokens back at their positions of
    a (B, T, C) sequence whose masked positions hold ``noise_std * N(0, 1)``
    mask tokens (zeros when ``noise_std`` is 0); the first ``num_extra``
    tokens (extra tokens) are dropped first."""
    x_keep = x_keep[:, num_extra:]
    b, k, d = x_keep.shape
    shape = (b, mask_info.ids_restore.shape[1] - k, d)
    if noise_std:
        if generator is None:
            raise ValueError("mask tokens with noise need a generator")
        tokens = noise_std * torch.randn(shape, generator=generator, device=x_keep.device,
                                         dtype=x_keep.dtype)
    else:
        tokens = x_keep.new_zeros(shape)
    return take_rows(torch.cat([x_keep, tokens], dim=1), mask_info.ids_restore)


def masked_alibi(alibi_bias: torch.Tensor, mask_info: MaskInfo) -> torch.Tensor:
    """The (B, H, K, K) rows and columns of a (B or 1, H, T, T) bias at each
    row's kept positions."""
    idx = mask_info.ids_keep
    b, k = idx.shape
    bias = alibi_bias.expand(b, -1, -1, -1)
    h, t = bias.shape[1], bias.shape[2]
    bias = torch.gather(bias, 2, idx[:, None, :, None].expand(b, h, k, t))
    return torch.gather(bias, 3, idx[:, None, None, :].expand(b, h, k, k))
