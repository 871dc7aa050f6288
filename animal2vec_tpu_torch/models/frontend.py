"""Waveform frontend: the port of ``animal2vec_tpu/models/frontend.py``, the
sinc filterbank (parametric, or its learnable-kernel mode) or a plain conv
as layer 0, its norm (LayerNorm, instance norm or PCEN with its learned
smoother), and the conv feature stack.

Activations are (B, T, C). The waveform is cast to the compute dtype first;
the sinc conv then runs in fp32 on the card with TF32 off (TF32 keeps about
three digits), reflect-padded by k//2 on both sides. PCEN runs in fp32.

``extractor_mode`` "layer_norm" puts a norm after every conv (layer 0's is
``sinc_norm``); "default" puts a GroupNorm with one group per channel after
layer 0 only (flax's ``GroupNorm``: epsilon 1e-6, the variance as E[x^2] -
E[x]^2 clipped at 0, fp32 statistics). Flax returns that norm's output in
fp32, which the JAX package's next conv then refuses beside its bf16 kernel,
so the JAX frontend of this mode runs in fp32 only; the port casts the
output back to the compute dtype, as its other norms do. In fp32 the two
agree.

PCEN's smoother is a first-order linear recurrence, ``s[t] = (1 - w) s[t-1]
+ w x[t]`` with ``s[0] = x[0]``, which JAX runs as ``lax.associative_scan``.
Here it is a log-depth (Hillis-Steele) scan in torch ops: with the
recurrence's coefficient constant over time, step d adds ``(1 - w)^d``
times the partial sum d steps back, so only the partial sums are kept. The
scan is a ``torch.autograd.Function`` that saves its input and output
alone, and its backward runs the reverse recurrence as the same scan: at
a2v-large's layer 0 (127 channels at stride 1, T = 80 000 a 10-s clip) the
17 steps of the naive scan would each keep a full (B, T, 127) fp32 tensor
for autograd.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from animal2vec_tpu_torch.models.modules import Fp32LayerNorm, conv1d_same
from animal2vec_tpu_torch.ops.sinc import full_hamming_window, mel_init_filterbank, sinc_filters


class PSwish(nn.Module):
    """alpha * x * sigmoid(beta * x), per channel."""

    def __init__(self, dim: int):
        super().__init__()
        self.p_swish_alpha = nn.Parameter(torch.full((dim,), 2.0))
        self.p_swish_beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.p_swish_alpha.to(x.dtype)
        beta = self.p_swish_beta.to(x.dtype)
        return x * alpha * torch.sigmoid(beta * x)


class SincConv(nn.Module):
    """Band-pass FIR filterbank with mel-spaced init. Parametric: learns
    (low_hz, band_hz) and rebuilds the filters each call. Learnable kernel
    (``learnable_filters``): the (C, K) taps are the parameter ``kernel``,
    initialized as the parametric filters; with ``apply_window_to_root`` the
    full Hamming window multiplies them at every call."""

    def __init__(self, out_channels: int, kernel_size: int, stride: int = 1,
                 sample_rate: int = 8_000, return_abs: bool = False,
                 learnable_filters: bool = False, apply_window_to_root: bool = False):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.sample_rate, self.return_abs = sample_rate, return_abs
        self.apply_window_to_root = apply_window_to_root
        low, band = mel_init_filterbank(out_channels, kernel_size, sample_rate)
        low, band = torch.from_numpy(low), torch.from_numpy(band)
        if learnable_filters:
            self.kernel = nn.Parameter(sinc_filters(low, band, kernel_size, sample_rate))
            self.register_buffer("window", torch.from_numpy(full_hamming_window(kernel_size)),
                                 persistent=False)
        else:
            self.kernel = None
            self.low_hz = nn.Parameter(low)
            self.band_hz = nn.Parameter(band)

    def filters(self) -> torch.Tensor:
        """The (C, K) fp32 filters of this call."""
        if self.kernel is None:
            return sinc_filters(self.low_hz, self.band_hz, self.kernel_size, self.sample_rate)
        kern = self.kernel.float()
        return kern * self.window[None, :] if self.apply_window_to_root else kern

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, 1) -> (B, T', C)
        filters = self.filters()
        pad = self.kernel_size // 2
        xp = F.pad(x.transpose(1, 2), (pad, pad), mode="reflect")
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            out = F.conv1d(xp.float(), filters[:, None, :], stride=self.stride)
        out = out.transpose(1, 2).to(x.dtype)
        return out.abs() if self.return_abs else out


def _scan(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y[t] = b[t] + c * y[t-1] along dim 1 of (B, T, C) ``b`` with y[0] =
    b[0], for a per-channel coefficient ``c`` (C,) or (1,): a Hillis-Steele
    scan in ceil(log2 T) steps, step d adding c^d times y d steps back. Two
    buffers take turns, so that a step reads each element twice and writes
    it once."""
    bufs = (torch.empty_like(b), torch.empty_like(b))
    y, i = b, 0
    cd, d = c, 1
    while d < b.shape[1]:
        out = bufs[i]
        out[:, :d] = y[:, :d]
        torch.addcmul(y[:, d:], y[:, :-d], cd, out=out[:, d:])
        y, i = out, 1 - i
        cd, d = cd * cd, 2 * d
    return y if y is not b else b.clone()


class _EmaScan(torch.autograd.Function):
    """s[t] = (1 - w) s[t-1] + w x[t], s[0] = x[0], for fp32 (B, T, C) x and
    a clipped per-channel (or single) weight w. Saves x and s; the backward
    runs the reverse recurrence lam[t] = g[t] + (1 - w) lam[t+1] as a scan,
    then dx[0] = lam[0], dx[t] = w lam[t] and dw = sum over t >= 1 of lam[t]
    (x[t] - s[t-1])."""

    @staticmethod
    def forward(ctx, x, w):
        b = torch.cat([x[:, :1], w * x[:, 1:]], dim=1)
        s = _scan(b, 1.0 - w)
        ctx.save_for_backward(x, w, s)
        return s

    @staticmethod
    def backward(ctx, g):
        x, w, s = ctx.saved_tensors
        lam = _scan(g.flip(1), 1.0 - w).flip(1)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.cat([lam[:, :1], w * lam[:, 1:]], dim=1)
        if ctx.needs_input_grad[1]:
            dw = (lam[:, 1:] * (x[:, 1:] - s[:, :-1])).sum(dim=(0, 1))
            if w.numel() == 1:
                dw = dw.sum().reshape(w.shape)
        return dx, dw


class ExponentialMovingAverageSmoother(nn.Module):
    """PCEN's learned first-order IIR smoother (``frontend.py:125-152``): the
    weights clipped to [0, 1], one per channel or one in all."""

    def __init__(self, dim: int, per_channel: bool = True, coeff_init: float = 0.04):
        super().__init__()
        self.weights = nn.Parameter(torch.full((dim if per_channel else 1,), coeff_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        w = torch.clamp(self.weights, 0.0, 1.0).to(x.dtype)
        return _EmaScan.apply(x, w)


class PCEN(nn.Module):
    """Per-channel energy normalization (``frontend.py:155-183``), fp32
    inside: ``(x / (floor + s)^alpha + delta)^(1/root) - delta^(1/root)``
    with s the smoother's output, alpha at most 1 and root at least 1."""

    def __init__(self, dim: int, alpha: float = 0.96, smooth_coef: float = 0.04,
                 delta: float = 2.0, root: float = 2.0, floor: float = 1e-12,
                 per_channel_smooth_coef: bool = True):
        super().__init__()
        self.floor = floor
        self.alpha = nn.Parameter(torch.full((dim,), alpha))
        self.delta = nn.Parameter(torch.full((dim,), delta))
        self.root = nn.Parameter(torch.full((dim,), root))
        self.ema = ExponentialMovingAverageSmoother(dim, per_channel_smooth_coef, smooth_coef)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        alpha = torch.clamp(self.alpha.float(), max=1.0)
        one_over_root = 1.0 / torch.clamp(self.root.float(), min=1.0)
        delta = self.delta.float()
        s = self.ema(x32)
        out = (x32 / (self.floor + s) ** alpha + delta) ** one_over_root \
            - delta ** one_over_root
        return out.to(x.dtype)


class Fp32InstanceNorm(nn.Module):
    """Instance norm over time of (B, T, C), fp32 statistics, affine."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = x32.var(dim=1, unbiased=False, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class ChannelGroupNorm(nn.Module):
    """flax's ``GroupNorm`` with one group per channel on (B, T, C): fp32
    statistics over time, the variance E[x^2] - E[x]^2 clipped at 0,
    epsilon 1e-6, affine; cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = torch.clamp_min(x32.square().mean(dim=1, keepdim=True) - mean.square(), 0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (y + self.bias.float()).to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """Raw (B, T) waveform -> (B, T/40, C) features: layer i is
    conv(dim, k, stride) -> norm -> activation. Layer 0 is the sinc conv
    (``sinc_input`` or ``apply_window_to_root``; the learnable-kernel mode
    needs both, as JAX's ``learnable_filters = apply_window_to_root and
    sinc_input``), whose output is rectified for the "pcen" and "instance"
    norms and which PSwish follows with ``use_pswish``; otherwise layer 0 is
    a bias-free conv with GELU, as the other layers are. The norms follow
    ``extractor_mode`` (module docstring)."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]],
                 sample_rate: int = 8_000, sinc_norm: str = "layer_norm",
                 use_pswish: bool = False, sinc_input: bool = True,
                 apply_window_to_root: bool = False, mode: str = "layer_norm"):
        super().__init__()
        self.conv_layers = [tuple(c) for c in conv_layers]
        sinc = sinc_input or apply_window_to_root
        self.pswish = sinc and use_pswish
        self.sinc = sinc
        in_dim = 1
        for i, (dim, k, stride) in enumerate(self.conv_layers):
            if i == 0 and sinc:
                conv = SincConv(dim, k, stride, sample_rate,
                                return_abs=sinc_norm in ("pcen", "instance"),
                                learnable_filters=apply_window_to_root and sinc_input,
                                apply_window_to_root=apply_window_to_root)
            else:
                conv = nn.Conv1d(in_dim, dim, k, stride=stride, bias=False)
            self.add_module(f"conv_{i}", conv)
            kind = sinc_norm if i == 0 else "layer_norm"
            if mode == "default":
                norm = ChannelGroupNorm(dim) if i == 0 else None
            elif kind == "pcen":
                norm = PCEN(dim)
            elif kind == "instance":
                norm = Fp32InstanceNorm(dim)
            else:
                norm = Fp32LayerNorm(dim)
            if norm is not None:
                self.add_module(f"norm_{i}", norm)
            in_dim = dim
        if self.pswish:
            self.act_0 = PSwish(self.conv_layers[0][0])

    def forward(self, source: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = source[..., None].to(dtype)  # (B, T, 1)
        for i, (_, _, stride) in enumerate(self.conv_layers):
            conv = getattr(self, f"conv_{i}")
            if i == 0 and self.sinc:
                x = conv(x)
            else:
                x = conv1d_same(x, conv.weight, None, stride=stride)
            norm = getattr(self, f"norm_{i}", None)
            if norm is not None:
                x = norm(x)
            x = self.act_0(x) if i == 0 and self.pswish else F.gelu(x)
        return x
