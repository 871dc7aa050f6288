"""Static-count span masking for finetuning: the port of
``animal2vec_tpu/ops/masking.py`` (``expected_span_mask_tokens``,
``span_mask``, ``exactify_mask``, ``channel_mask`` and ``apply_mask``).

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
