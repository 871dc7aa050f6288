"""BC-learning mixup with A-weighted gain matching: the port of
``animal2vec_tpu/ops/mixup.py``.

Two waveforms are mixed with a ratio derived from their perceptual
(A-weighted) loudness difference (Tokozume et al. 2017, BC learning).
``bc_mixup_core`` is the deterministic part: given the permutation, the
ratio ``r`` and which rows mix, it returns the mixed batch and targets, so a
test can feed it the draws JAX makes. ``bc_mixup`` draws those on the host
generator of the training step.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


@lru_cache(maxsize=16)
def a_weighting_table(fs: int, n_fft: int, min_db: float = -80.0) -> np.ndarray:
    """Linear-power A-weighting curve over rfft bins."""
    freq = np.linspace(0, fs // 2, n_fft // 2 + 1)
    freq_sq = freq**2
    freq_sq[0] = 1.0
    weight = 2.0 + 20.0 * (
        2 * np.log10(12194)
        + 2 * np.log10(freq_sq)
        - np.log10(freq_sq + 12194**2)
        - np.log10(freq_sq + 20.6**2)
        - 0.5 * np.log10(freq_sq + 107.7**2)
        - 0.5 * np.log10(freq_sq + 737.9**2)
    )
    weight = np.maximum(weight, min_db)
    return np.power(10.0, weight / 10.0).astype(np.float32)


def compute_gain(
    sound: torch.Tensor,
    fs: int = 8_000,
    wl: float = 0.1,
    min_db: float = -80.0,
    mode: str = "A_weighting",
) -> torch.Tensor:
    """Per-frame gain in dB of (..., T) audio, shape (..., F): frames of
    round(fs * wl) samples at half-frame hops."""
    n_fft = round(fs * wl)
    frames = sound.float().unfold(-1, n_fft, n_fft // 2)
    if mode == "RMSE":
        g = frames.square().mean(dim=-1)
    elif mode == "A_weighting":
        window = torch.hann_window(n_fft, periodic=True, device=sound.device)
        power = torch.fft.rfft(window * frames).abs().square()
        table = torch.from_numpy(a_weighting_table(fs, n_fft, min_db)).to(sound.device)
        g = (power * table).sum(dim=-1)
    else:
        raise ValueError(mode)
    gain = torch.clamp(g, min=10.0 ** (min_db / 10.0))
    return 10.0 * torch.log10(gain)


def bc_mixup_core(
    source: torch.Tensor,
    target: Optional[torch.Tensor],
    perm: torch.Tensor,
    r: torch.Tensor,
    mix_mask: torch.Tensor,
    gain_mode: str,
    sample_rate: int,
    mixing_window_length: float,
    target_mixup: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mix (B, T) ``source`` with ``source[perm]`` at ratio ``r`` ((1,) or
    (B,)) where ``mix_mask`` (B,) bool is set; targets (B, T', n) mix with
    ``r`` when ``target_mixup``."""
    b = source.shape[0]
    r = r.to(source.dtype)
    s2 = source[perm]
    if gain_mode == "none":
        p = r.expand(b)[:, None]
    else:
        if gain_mode == "naive_rms":
            g1 = source.float().square().mean(dim=-1).sqrt()
        else:
            g1 = compute_gain(source, fs=sample_rate, wl=mixing_window_length,
                              mode=gain_mode).amax(dim=-1)
        g1 = g1.to(source.dtype)
        g2 = g1[perm]
        p = (1.0 / (1.0 + 10.0 ** ((g1 - g2) / 20.0) * (1.0 - r) / r))[:, None]
    mixed = (p * source + (1 - p) * s2) / torch.sqrt(p**2 + (1 - p) ** 2)
    mixed = torch.where(mix_mask[:, None], mixed, source)
    if target is not None and target_mixup:
        r_t = r.expand(b)[:, None, None].to(target.dtype)
        mixed_t = target * r_t + (1 - r_t) * target[perm]
        target = torch.where(mix_mask[:, None, None], mixed_t, target)
    return mixed, target


def bc_mixup(
    source: torch.Tensor,
    target: Optional[torch.Tensor],
    source_mixup: float,
    mixup_prob: float,
    same_mixup: bool,
    gain_mode: str,
    sample_rate: int,
    mixing_window_length: float,
    target_mixup: bool,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mix a batch with a random permutation of itself; the permutation,
    ratio and row choice are drawn on ``generator`` (a CPU generator in the
    training step) and moved to the source's device."""
    if source_mixup < 0 or mixup_prob <= 0:
        return source, target
    b = source.shape[0]
    if mixup_prob >= 1:
        mix_mask = torch.ones((b,), dtype=torch.bool)
    else:
        mix_mask = torch.rand((b,), generator=generator) < mixup_prob
    lo = max(1e-6, source_mixup)
    r = lo + (1.0 - lo) * torch.rand((1,) if same_mixup else (b,), generator=generator)
    perm = torch.randperm(b, generator=generator)
    dev = source.device
    return bc_mixup_core(source, target, perm.to(dev), r.to(dev), mix_mask.to(dev), gain_mode,
                         sample_rate, mixing_window_length, target_mixup)
