"""Transformer building blocks: the port of ``animal2vec_tpu/models/modules.py``
(AltBlock post-LN and, for serving, pre-LN; feature-last (B, T, C) layout),
with its serving and training arms.

Each module computes in the dtype of its input and casts its weights to it
at use (a no-op once ``weights.serving_cast`` stored them in bf16; in
training the fp32 master weights are cast, and autograd carries the
gradient back to them); LayerNorm statistics are fp32. The per-block work
goes through ops with CUDA kernels: the attention through
``models.attention.multihead_attention`` (the ALiBi kernels for an
``AlibiSpec``, the dense-bias kernel for the image modality's dense bias or
none), the post-LN MLP sub-block through ``ops.fused_mlp.fused_block_mlp``
and a pre-LN block's MLP through ``ops.fused_mlp.fused_mlp``; the ALiBi
attention and the post-LN block launch their bare forward when no gradient
is wanted and their autograd Function otherwise. Where JAX scans over
stacked per-layer params, the port loops over one module per layer.

``matmul_impl`` selects the serving numerics of every block: "int8" runs
the MLP sub-block through ``ops.fused_mlp.fused_block_int8`` (post-LN) or
``fused_mlp_int8`` (pre-LN), "int8_attn" also the qkv and out projections
through ``ops.int8_mm.int8_dense`` and an ``AlibiSpec`` attention through
``ops.attention.alibi_flash_attention_int8`` (``modules.py:506-541``); a
dense-bias attention stays bf16 there, as in JAX (``modules.py:387,
433-444``). The int8 weights are quantized once from the stored weights by
``quantize_weights`` into non-persistent buffers, so one state dict serves
every mode; a module quantizes when its weights are loaded (the encoder,
``models.data2vec2.Data2VecMulti``, calls it after ``load_state_dict``). The int8
modes are serving-only: ``train()`` forwards raise, as the JAX int8
kernels have no vjp.

Widths. JAX takes its Pallas MLP, block and int8 dense kernels only where
every width is a multiple of 128 (``pallas_serving_ok``, ``modules.py:
49-62``) and composes the same function in XLA otherwise. The port's copy
of that test is ``kernel_widths``, and three call sites read it: the
post-LN MLP sub-block (``AltBlock._post_ln``: #6 / #7 iff
``kernel_widths(C, M)``, ``modules.py:598-600``), a pre-LN block's MLP
(``Mlp.forward``: #8 / #9 iff ``kernel_widths(C, M, C)``, ``:235-237``)
and the int8 projections (``AltAttention``: #10 iff ``kernel_widths(K,
N)``, ``quantized_matmul``, ``:83``). Off those widths they compute JAX's
XLA route with stock ops: ``Fp32LayerNorm`` norm1, the composed MLP (each
Dense a product in the compute dtype plus its bias cast to it, exact-erf
GELU, the two activation dropouts), ``r + dp(post_drop(t))``, norm2; in the
int8 modes each Dense is ``quantized_matmul`` (``modules.py:88-99``),
which quantizes its weight at every call (no int8 buffers are kept for
a layer off the kernels' widths). Training runs through autograd of those
ops, each dropout under the kernels' hash keep mask from the block's int32
seeds (``_hash_dropout``), so both routes draw the same masks.

Training arms run when the module is in ``train()`` mode. Their random
draws come from an explicit ``ops.dropout.Rngs``: layerdrop decisions and
the int32 hash seeds of the kernels on its host generator, elementwise
dropout masks on its device generator. A dense-bias attention (the image
modality) trains through the dense-bias kernels' autograd Function, with
the kernels' hash dropout (JAX draws that mask with ``jax.random``), a
pre-LN block's MLP through the fused MLP's, with its activation dropout as
the kernel's two hash-dropout sites (after GELU and after fc2; JAX leaves
its fused MLP for the composed one there). Drop-path (``drop_path``, the
block's rate; ``BlockStack`` gives its blocks ``linspace(start, end,
depth)``) keeps or drops each sample's residual branch: a per-sample keep
drawn on the device generator for each of the two branches, a kept sample
scaled by 1 / (1 - rate) in fp32 and rounded once, a dropped one 0; the
identity in evaluation. The post-LN block's MLP branch takes that scale
inside the fused block's LN2 pass (JAX sends a drop-path block to its
composed XLA block, ``modules.py:581-586``; the port keeps its kernel and
computes the same function).

Rematerialization (``remat_scope``, JAX's ``BlockStack``/``AltBlock``
remat, ``modules.py:514-518, 711-728``): "attn" runs each attention
sub-block (qkv, the attention kernel, the out projection and its dropout)
under ``torch.utils.checkpoint``, "block" each whole block, so that their
backward recomputes the forward from the sub-block's input instead of
keeping its activations. "mlp" changes nothing: the fused blocks' autograd
Functions (``ops/fused_mlp.py``) keep only their inputs and recompute h in
their backward already. A checkpointed region draws nothing: a block draws
its randomness first (``AltBlock.draws``: the host's hash seeds and the
device generator's keep masks, in the order the region would draw them)
and hands the draws in, so that the recompute replays the forward's masks
and the results equal those without remat bit for bit.

The decoders of data2vec-2 pretraining (``Decoder1d`` for audio,
``Decoder2d`` for images) are grouped convs, each followed by a LayerNorm
without affine in fp32 and exact GELU, as ``F.conv1d`` / ``F.conv2d``
compose them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from animal2vec_tpu_torch.config import MATMUL_IMPLS
from animal2vec_tpu_torch.models.attention import AlibiSpec, Bias, multihead_attention
from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_int8
from animal2vec_tpu_torch.ops.conv_arith import same_pad_1d, strided_pad_1d
from animal2vec_tpu_torch.ops.dropout import (
    Rngs, apply_dropout, dropout, dropout_mask, fold_bh_offset, hash_keep, keep_scale,
)
from animal2vec_tpu_torch.ops.fused_mlp import (
    _ln, block_fc1, block_fc2_partial, block_ln2, fp32_sum_matmul, fused_block_int8,
    fused_block_mlp, fused_mlp, fused_mlp_int8,
)
from animal2vec_tpu_torch.ops.int8_mm import INV_127, int8_dense, quantize_weight


def kernel_widths(*dims: int) -> bool:
    """True iff every dim is a multiple of 128: the width test of JAX's
    ``pallas_serving_ok`` (``modules.py:49-62``), which picks a Pallas
    kernel over the XLA route. It reads shapes only."""
    return all(d % 128 == 0 for d in dims)


def _xla_quantize(v: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and fp32 scales of fp32 ``v`` over ``dim``, as
    ``quantized_matmul``'s XLA branch takes them: s = max|v| * fp32(1/127)
    (XLA's rewrite of ``/ 127.0`` under ``jit``), q = round(v / max(s,
    1e-12)) half to even; the scale itself is not floored."""
    s = v.abs().amax(dim=dim, keepdim=True) * INV_127
    return torch.round(v / torch.clamp_min(s, 1e-12)).to(torch.int8), s


def int32_product(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of int8 a (R, K) times int8 b_t (N, K)^T:
    ``torch._int_mm`` (int32 accumulation) where its shape rules hold (R >
    16, K and N multiples of 8), else a float64 product, exact while K *
    127^2 < 2^53."""
    r, k = a.shape
    if r > 16 and k % 8 == 0 and b_t.shape[0] % 8 == 0:
        return torch._int_mm(a, b_t.t())
    return torch.matmul(a.double(), b_t.double().t()).to(torch.int32)


def quantized_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., K) times an nn.Linear ``weight`` (N, K) in int8: JAX's
    ``quantized_matmul`` off the kernel's widths (``modules.py:88-99``).
    The weight quantized per output channel and x per row over the whole K
    (``_xla_quantize``), the int8 product summed exactly in int32
    (``int32_product``), then ``fp32(y) * x_scale * w_scale`` cast to x's
    dtype. Stock ops only; the weight is quantized at every call, as the
    XLA route does."""
    k = x.shape[-1]
    w_q, w_s = _xla_quantize(weight.detach().float(), 1)
    x_q, x_s = _xla_quantize(x.float(), -1)
    y = int32_product(x_q.reshape(-1, k), w_q).float().reshape(*x.shape[:-1], -1)
    return (y * x_s * w_s.reshape(-1)).to(x.dtype)


def _dense(x: torch.Tensor, layer: nn.Linear, int8: bool) -> torch.Tensor:
    """JAX's ``nn.Dense`` / ``Int8Dense`` in x's dtype: the product (int8:
    ``quantized_matmul``) rounded to x's dtype, then the bias cast to it."""
    if int8:
        y = quantized_matmul(x, layer.weight)
    else:
        y = torch.matmul(x, layer.weight.to(x.dtype).t())
    return y + layer.bias.to(x.dtype)


def _layer_norm(norm: "Fp32LayerNorm", x: torch.Tensor) -> torch.Tensor:
    """``norm`` applied as JAX's ``Fp32LayerNorm`` writes it (``modules.py:
    101-119``): the fp32 mean and mean squared deviation, ``(x - mean) *
    rsqrt(var + eps)``, then the affine (``ops.fused_mlp._ln``), cast back
    to x's dtype."""
    return _ln(x, norm.weight, norm.bias, norm.eps).to(x.dtype)


def _hash_dropout(v: torch.Tensor, seed: int, rate: float, row0: int) -> torch.Tensor:
    """Inverted dropout of ``v`` (..., K) under the fused kernels' keep mask
    ``hash_keep(seed, row0 + row, column)`` over its flattened rows, in v's
    dtype: the composed route's dropout sites take the masks that the
    kernel route draws from the same seeds."""
    k = v.shape[-1]
    rows = row0 + torch.arange(v.numel() // k, device=v.device)[:, None]
    keep = hash_keep(seed, rows, torch.arange(k, device=v.device)[None, :], rate)
    return apply_dropout(v, keep.bool().reshape(v.shape), rate)


class Fp32LayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 statistics, cast back to the
    input dtype (``Fp32LayerNorm``, ``modules.py:101-119``)."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.weight = nn.Parameter(torch.ones(dim)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), (self.dim,), w, b, self.eps).to(x.dtype)


def conv1d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    groups: int = 1,
    pad: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Grouped 1-D conv on (B, T, C) with explicit (left, right) zero padding.

    weight: (C_out, C_in/groups, K). pad defaults to torch "same" for stride
    1 (asymmetric for even K) and ceil(stride/2) on both sides otherwise."""
    k = weight.shape[-1]
    if pad is None:
        pad = same_pad_1d(k) if stride == 1 else strided_pad_1d(stride)
    xb = F.pad(x.transpose(1, 2), pad)
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return F.conv1d(xb, w, b, stride=stride, groups=groups).transpose(1, 2)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _need(rngs: Optional[Rngs], what: str) -> Rngs:
    if rngs is None:
        raise ValueError(f"{what} in training mode needs an Rngs")
    return rngs


def _serving(module: nn.Module) -> None:
    """Raises when an int8 mode's ``module`` is in training."""
    if module.training:
        raise RuntimeError("the int8 matmul_impl modes are serving-only: call eval() "
                           "(their kernels have no backward)")


def _quantized(module: nn.Module, *names: str) -> List[torch.Tensor]:
    """The int8 buffers of a serving module; raises in training or before
    ``quantize_weights``."""
    _serving(module)
    bufs = [getattr(module, n) for n in names]
    if any(b is None for b in bufs):
        raise RuntimeError("int8 weights are not quantized: call quantize_weights() "
                           "after changing the weights")
    return bufs


def _int8_buffers(module: nn.Module, *names: str) -> None:
    for n in names:
        module.register_buffer(n, None, persistent=False)


def drop_path_scale(batch: int, rate: float, rngs: Optional[Rngs], device) -> torch.Tensor:
    """One residual branch's drop-path draw: the fp32 (B,) factor of each
    sample, 1 / (1 - rate) where it is kept (with probability 1 - rate, on
    the device generator) and 0 where it is dropped."""
    keep = dropout_mask((batch,), rate, _need(rngs, "drop-path").device, device)
    return keep.float() * keep_scale(rate)


def apply_drop_path(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``y`` (B, ...) times its sample's ``drop_path_scale`` in fp32,
    rounded once to ``y``'s dtype."""
    return (y.float() * scale.reshape(-1, *(1,) * (y.dim() - 1))).to(y.dtype)


class AltAttention(nn.Module):
    """Multi-head self-attention (``AltAttention``, ``modules.py:374-446``)
    through ``multihead_attention`` on the (B, T, 3C) projection; in training with
    ``proj_drop`` after the out projection and, for structured ALiBi, the
    in-kernel hash dropout at ``attn_drop`` (one int32 seed per call, for
    the dense-bias kernels too). With
    ``int8`` (serving) the projections run int8 with their biases added after,
    in the storage dtype, and an ``AlibiSpec`` attention takes int8 products
    (``modules.py:409-421``); a dense bias keeps the bf16 attention. Under
    tensor parallelism (``tp``, ``parallel.tensor.shard_block``) qkv holds
    the rank's heads, the attention runs them with their slopes and their
    unsharded index in the dropout hash, and proj's fp32 partial sum is
    all-reduced over "model" before the bias and the cast."""

    def __init__(self, dim: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, int8: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.int8 = int8
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.tp = None  # parallel.tensor.TensorParallel of a sharded block
        _int8_buffers(self, "qkv_q", "qkv_s", "proj_q", "proj_s")

    @property
    def int8_kernel(self) -> bool:
        """Whether the int8 projections take #10 (``_int8_linear``) and so
        keep quantized weights: qkv (C, 3C) and proj (C, C) both do iff C
        is a multiple of 128."""
        return self.int8 and kernel_widths(self.qkv.in_features)

    @torch.no_grad()
    def quantize_weights(self) -> None:
        if self.int8_kernel:
            self.qkv_q, self.qkv_s = quantize_weight(self.qkv.weight)
            self.proj_q, self.proj_s = quantize_weight(self.proj.weight)

    def draws(self, x: torch.Tensor, rngs: Optional[Rngs]):
        """A training call's draws, as the call makes them: the attention's
        hash seed (host) and the out projection's keep mask (device)."""
        seed = keep = None
        if self.training and not self.int8:
            if self.attn_drop > 0.0:
                seed = _need(rngs, "attention dropout").attention_seed(self.num_heads)
            if self.proj_drop > 0.0:
                keep = dropout_mask(x.shape, self.proj_drop, _need(rngs, "dropout").device,
                                    x.device)
        return seed, keep

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor], bias: Bias,
        rngs: Optional[Rngs] = None, draws=None,
    ) -> torch.Tensor:
        alibi = isinstance(bias, AlibiSpec)
        if self.int8:
            _serving(self)
            b, t, c = x.shape
            qkv = self._int8_linear(x, "qkv")
            if alibi:
                q, k, v = qkv.view(b, t, 3, self.num_heads, c // self.num_heads).unbind(2)
                out = alibi_flash_attention_int8(q, k, v, bias.slopes, bias.positions,
                                                 padding_mask, bias.has_sentinel).reshape(b, t, c)
            else:
                out = multihead_attention(qkv, self.num_heads, bias, padding_mask)
            return self._int8_linear(out, "proj")
        seed, keep = self.draws(x, rngs) if draws is None else draws
        rate = 0.0 if seed is None else self.attn_drop
        if self.tp is not None:
            out = self._sharded(x, padding_mask, bias, rate, seed)
        else:
            out = multihead_attention(_linear(x, self.qkv), self.num_heads, bias, padding_mask,
                                      rate, seed)
            out = _linear(out, self.proj)
        if keep is not None:
            out = apply_dropout(out, keep, self.proj_drop)
        return out

    def _int8_linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The int8 projection ``name`` ("qkv" or "proj") plus its bias in
        x's dtype: #10 iff ``kernel_widths(K, N)`` (``quantized_matmul``,
        ``modules.py:83``), else the composed int8 product."""
        layer = getattr(self, name)
        if kernel_widths(x.shape[-1], layer.out_features):
            y = int8_dense(x, *_quantized(self, f"{name}_q", f"{name}_s"))
        else:
            y = quantized_matmul(x, layer.weight)
        return y + layer.bias.to(x.dtype)

    def _sharded(self, x, padding_mask, bias, rate, seed):
        tp = self.tp
        local = dataclasses.replace(bias, slopes=bias.slopes[tp.h0:tp.h0 + tp.heads])
        out = multihead_attention(_linear(tp.to_model(x), self.qkv), tp.heads, local,
                                  padding_mask, rate, seed, tp.h0, tp.hash_heads)
        part = fp32_sum_matmul(out.reshape(-1, out.shape[-1]),
                               self.proj.weight.to(x.dtype).t())
        out = tp.reduce(part) + self.proj.bias.float()
        return out.to(x.dtype).reshape(x.shape)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (``Mlp``, ``modules.py:210-272``). A post-LN
    block consumes the parameters fused with its LayerNorms where its
    widths take the kernel; otherwise, and in a pre-LN block, it calls the
    module. At ``kernel_widths(C, M, C)``: the fused MLP (in training its
    autograd Function, with the activation dropout at ``rate`` from two
    int32 ``seeds`` over rows from ``row0``), or with ``int8_weights``
    (w1_q, w1_s, w2_q, w2_s, serving; ``int8``) its int8 twin. At other
    widths: JAX's XLA route, ``composed``, its two dropout sites under the
    same seeds' hash masks (with ``int8`` its products quantize the weights
    themselves)."""

    def __init__(self, dim: int, hidden: int, int8: bool = False):
        super().__init__()
        self.int8 = int8
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def kernel_route(self, c: int) -> bool:
        """Whether an input of width ``c`` takes the fused MLP and block
        kernels: ``kernel_widths(C, M, C)``, which is the post-LN block's
        ``kernel_widths(C, M)`` too."""
        return kernel_widths(c, self.fc1.out_features, self.fc2.out_features)

    def forward(self, x: torch.Tensor,
                int8_weights: Optional[Sequence[torch.Tensor]] = None,
                seeds: Optional[Sequence[int]] = None, rate: float = 0.0,
                row0: int = 0) -> torch.Tensor:
        fc1, fc2 = self.fc1, self.fc2
        if not self.kernel_route(x.shape[-1]):
            return self.composed(x, seeds, rate, row0)
        if self.int8:
            w1_q, w1_s, w2_q, w2_s = int8_weights
            return fused_mlp_int8(x, w1_q, w1_s, fc1.bias, w2_q, w2_s, fc2.bias)
        return fused_mlp(x, fc1.weight.to(x.dtype), fc2.weight.to(x.dtype), fc1.bias, fc2.bias,
                         seeds, rate, row0)

    def composed(self, x: torch.Tensor, seeds: Optional[Sequence[int]] = None,
                 rate: float = 0.0, row0: int = 0) -> torch.Tensor:
        """JAX's XLA ``Mlp`` (``modules.py:255-270``): Dense, exact GELU,
        dropout, Dense, dropout, in x's dtype; the dropouts at ``rate``
        from ``seeds[0]`` and ``seeds[1]``, rows from ``row0``."""
        h = F.gelu(_dense(x, self.fc1, self.int8))
        if rate > 0.0:
            h = _hash_dropout(h, seeds[0], rate, row0)
        y = _dense(h, self.fc2, self.int8)
        if rate > 0.0:
            y = _hash_dropout(y, seeds[1], rate, row0)
        return y


class AltBlock(nn.Module):
    """Transformer block returning (x, layer tap) (``AltBlock``,
    ``modules.py:546-643``). The tap is the MLP output ``t`` with
    ``ffn_targets``, else the block output.

    Post-LN (the default): attention, then the fused MLP sub-block with both
    LayerNorms. In training the fused block applies the hash dropout at its
    three sites (after GELU and after fc2 at ``activation_dropout``, on the
    residual branch at ``post_mlp_drop``) from three int32 seeds.
    ``matmul_impl`` "int8" or "int8_attn" runs the MLP sub-block through the
    int8 fused block (serving). Where ``kernel_widths(C, M)`` fails, the
    sub-block is JAX's XLA route instead (``_composed_post_ln``), its
    dropouts at the same three sites under the same seeds' hash masks.

    Pre-LN (``layer_norm_first``): ``x + attn(norm1(x))``, then the MLP of
    ``norm2`` of that (in int8 through the int8 fused MLP), in training with
    ``activation_dropout`` at the fused MLP's two hash sites from two int32
    seeds and ``post_mlp_drop`` on its residual branch.

    ``norm_affine`` False gives both LayerNorms no parameters. In training
    with ``drop_path`` > 0 each residual branch (the attention's, the MLP's)
    is kept or dropped per sample (``drop_path_scale``).

    ``remat_scope`` "attn" or "block" runs the attention sub-block or the
    whole block under ``torch.utils.checkpoint`` in training (None or
    "mlp": as without remat); the block's draws come first (``draws``).

    Under tensor parallelism (``tp``, post-LN bf16 blocks only) the MLP
    sub-block runs as the split of #6: ``block_fc1`` on the rank's hidden
    columns, ``block_fc2_partial``, the all-reduce of the fp32 partial sums
    over "model", ``block_ln2``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 eps: float = 1e-5, encoder_dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 post_mlp_drop: float = 0.0, matmul_impl: str = "bf16",
                 layer_norm_first: bool = False, ffn_targets: bool = True,
                 remat_scope: Optional[str] = None, norm_affine: bool = True,
                 drop_path: float = 0.0):
        super().__init__()
        self.remat_scope = remat_scope
        self.drop_path = drop_path
        if matmul_impl not in MATMUL_IMPLS:
            raise ValueError(f"matmul_impl={matmul_impl!r}: expected one of {MATMUL_IMPLS}")
        self.layer_norm_first, self.ffn_targets = layer_norm_first, ffn_targets
        self.eps = eps
        self.act_rate, self.post_rate = activation_dropout, post_mlp_drop
        self.int8 = matmul_impl != "bf16"
        self.attn = AltAttention(dim, num_heads, attention_dropout, encoder_dropout,
                                 int8=matmul_impl == "int8_attn")
        self.norm1 = Fp32LayerNorm(dim, eps, norm_affine)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), self.int8)
        self.norm2 = Fp32LayerNorm(dim, eps, norm_affine)
        self.tp = None  # parallel.tensor.TensorParallel of a sharded block
        _int8_buffers(self, "w1_q", "w1_s", "w2_q", "w2_s")

    @property
    def int8_kernel(self) -> bool:
        """Whether the MLP sub-block takes #7 / #9 and so keeps quantized
        weights (``Mlp.kernel_route``)."""
        return self.int8 and self.mlp.kernel_route(self.mlp.fc1.in_features)

    @torch.no_grad()
    def quantize_weights(self) -> None:
        """Quantize the int8 kernels' weights from the stored ones (a no-op
        in bf16 and for layers on the composed route)."""
        self.attn.quantize_weights()
        if self.int8_kernel:
            self.w1_q, self.w1_s = quantize_weight(self.mlp.fc1.weight)
            self.w2_q, self.w2_s = quantize_weight(self.mlp.fc2.weight)

    def _remat(self, scope: str) -> bool:
        return self.remat_scope == scope and self.training and torch.is_grad_enabled()

    def draws(self, x: torch.Tensor, rngs: Optional[Rngs], drop_path: Optional[float] = None):
        """The block's training draws, as an unrematerialized forward makes
        them: the attention's (``AltAttention.draws``); then the post-LN
        fused block's three int32 hash seeds with its first global row, or
        the pre-LN block's keep mask of its residual branch and its fused
        MLP's two hash seeds with their first global row (the same on
        either route); then the two branches' drop-path scales (at
        ``drop_path``, default the block's rate). Only ``x``'s shape and
        device are read."""
        drop_path = self.drop_path if drop_path is None else drop_path
        attn = self.attn.draws(x, rngs)
        train = self.training and not self.int8
        row0 = None if rngs is None else rngs.row0 * x.shape[1]
        if self.layer_norm_first:
            post = seeds = None
            if train and self.post_rate > 0.0:
                post = dropout_mask(x.shape, self.post_rate, _need(rngs, "dropout").device,
                                    x.device)
            if train and self.act_rate > 0.0:
                seeds = (_need(rngs, "activation dropout").int32_seeds(2), row0)
            block = (post, seeds)
        else:
            block = None
            if train and (self.act_rate > 0.0 or self.post_rate > 0.0):
                block = (_need(rngs, "block dropout").int32_seeds(3), row0)
        dp = None
        if train and drop_path > 0.0:
            dp = tuple(drop_path_scale(x.shape[0], drop_path, rngs, x.device)
                       for _ in range(2))
        return attn, block, dp

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor], bias: Bias,
        rngs: Optional[Rngs] = None, draws=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, tap); ``draws`` (``draws``'s, e.g. a microbatch's slice,
        ``slice_draws``) in place of drawing from ``rngs``."""
        if draws is None:
            draws = self.draws(x, rngs)
        if self._remat("block"):
            return checkpoint(self._body, x, padding_mask, bias, draws, use_reentrant=False,
                              preserve_rng_state=False)
        return self._body(x, padding_mask, bias, draws)

    def _body(self, x, padding_mask, bias, draws):
        if self.layer_norm_first:
            x, t = self._pre_ln(x, padding_mask, bias, draws)
        else:
            x, t = self._post_ln(x, padding_mask, bias, draws)
        return x, (t if self.ffn_targets else x)

    def _attention(self, x, padding_mask, bias, draws):
        if self._remat("attn"):
            return checkpoint(self.attn, x, padding_mask, bias, None, draws, use_reentrant=False,
                              preserve_rng_state=False)
        return self.attn(x, padding_mask, bias, None, draws)

    def _pre_ln(self, x, padding_mask, bias, draws):
        attn_draws, (post, mlp_seeds), dp = draws
        a = self._attention(self.norm1(x), padding_mask, bias, attn_draws)
        x = x + (a if dp is None else apply_drop_path(a, dp[0]))
        int8_weights = None
        if self.int8_kernel:
            int8_weights = _quantized(self, "w1_q", "w1_s", "w2_q", "w2_s")
        elif self.int8:
            _serving(self)
        # The reference's pre-LN branch (modules.py:551-554, after fairseq's
        # AltBlock) reads ``r = t = mlp(norm2(x)); x = r + dp(post_drop(t))``:
        # the residual x is not added back, and with dropout off the block
        # gives 2 * mlp(norm2(x)). The port computes what the reference
        # computes.
        seeds, row0 = (None, 0) if mlp_seeds is None else mlp_seeds
        t = self.mlp(self.norm2(x), int8_weights, seeds, self.act_rate if seeds else 0.0, row0)
        td = t if post is None else apply_dropout(t, post, self.post_rate)
        if dp is not None:
            td = apply_drop_path(td, dp[1])
        return t + td, t

    def _post_ln(self, x, padding_mask, bias, draws):
        attn_draws, block_seeds, dp = draws
        a = self._attention(x, padding_mask, bias, attn_draws)
        x = x + (a if dp is None else apply_drop_path(a, dp[0]))
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        if not self.mlp.kernel_route(x.shape[-1]):
            return self._composed_post_ln(x, block_seeds, dp)
        if self.int8:
            w1_q, w1_s, w2_q, w2_s = _quantized(self, "w1_q", "w1_s", "w2_q", "w2_s")
            return fused_block_int8(
                x, self.norm1.weight, self.norm1.bias, w1_q, w1_s, fc1.bias, w2_q, w2_s,
                fc2.bias, self.norm2.weight, self.norm2.bias, self.eps,
            )
        seeds, row0, act_rate, post_rate = None, 0, 0.0, 0.0
        if block_seeds is not None:
            (seeds, row0), act_rate, post_rate = block_seeds, self.act_rate, self.post_rate
        if self.tp is not None:
            return self._split_mlp(x, seeds, row0, act_rate, post_rate,
                                   None if dp is None else dp[1])
        return fused_block_mlp(
            x, self.norm1.weight, self.norm1.bias, fc1.weight.to(x.dtype).t(),
            fc2.weight.to(x.dtype).t(), fc1.bias, fc2.bias, self.norm2.weight,
            self.norm2.bias, self.eps, seeds, act_rate, post_rate, row0=row0,
            branch_scale=None if dp is None else dp[1],
        )

    def _composed_post_ln(self, x, block_seeds, dp):
        """JAX's XLA route of the post-LN MLP sub-block (``modules.py:
        632-637``): r = norm1(x), t = mlp(r), x_out = norm2(r +
        dp(post_drop(t))); the tap is t. The norms take JAX's formula
        (``_layer_norm``), as the fused block's plain version does; the
        three dropout sites take the fused block's seeds and masks."""
        if self.int8:
            _serving(self)
        seeds, row0 = (None, 0) if block_seeds is None else block_seeds
        r = _layer_norm(self.norm1, x)
        t = self.mlp.composed(r, seeds, self.act_rate if seeds else 0.0, row0)
        td = t
        if seeds and self.post_rate > 0.0:
            td = _hash_dropout(t, seeds[2], self.post_rate, row0)
        if dp is not None:
            td = apply_drop_path(td, dp[1])
        return _layer_norm(self.norm2, r + td), t

    def slice_draws(self, draws, lo: int, hi: int, t: int):
        """``draws`` of a batch of ``t``-step rows cut to its rows ``lo`` ..
        ``hi`` (a pipeline's microbatch): the keep masks and drop-path
        scales sliced, the attention seed folded by ``lo`` rows of heads and
        the fused sites' first row moved by ``lo`` rows, so that the
        microbatch draws the batch's masks at its rows."""
        (seed, keep), block, dp = draws
        attn = (None if seed is None else fold_bh_offset(seed, lo * self.attn.num_heads),
                None if keep is None else keep[lo:hi])
        if self.layer_norm_first:  # (residual keep mask, (two seeds, row0))
            post, mlp = block
            block = (None if post is None else post[lo:hi],
                     None if mlp is None else (mlp[0], mlp[1] + lo * t))
        elif block is not None:  # (three seeds, row0)
            block = (block[0], block[1] + lo * t)
        return attn, block, None if dp is None else tuple(d[lo:hi] for d in dp)

    def _split_mlp(self, x, seeds, row0, act_rate, post_rate, branch_scale):
        """The post-LN MLP sub-block as the tensor-parallel split of #6."""
        tp, fc1, fc2 = self.tp, self.mlp.fc1, self.mlp.fc2
        x2 = x.reshape(-1, x.shape[-1])
        r, h = block_fc1(x2, self.norm1.weight, self.norm1.bias, fc1.weight.to(x.dtype).t(),
                         fc1.bias, self.eps, None if seeds is None else seeds[0], act_rate,
                         row0, tp.col0, tp.to_model)
        s = tp.reduce(block_fc2_partial(h, fc2.weight.to(x.dtype).t()))
        x_out, t = block_ln2(s, fc2.bias, r, self.norm2.weight, self.norm2.bias, self.eps,
                             None if seeds is None else seeds[1:], act_rate, post_rate, row0,
                             branch_scale)
        return x_out.reshape(x.shape), t.reshape(x.shape)


def scale_bias(bias: Bias, scale: torch.Tensor) -> Bias:
    """A block's bias under its learned per-layer ALiBi scale (``scale``: one
    value per head, or one value): the slopes of an ``AlibiSpec`` times the
    scale, a dense (B, H, T, T) bias times it per head (``modules.py:
    757-760``)."""
    if bias is None:
        return None
    if isinstance(bias, AlibiSpec):
        return dataclasses.replace(bias, slopes=bias.slopes * scale)
    return bias * scale.reshape(1, -1, 1, 1)


class BlockStack(nn.Module):
    """``depth`` AltBlocks run in a loop (``BlockStack``), each given the same
    bias, or with ``scales`` ((depth, H) or (depth, 1), the learned
    per-layer ALiBi scales) layer i the bias under scale i; returns (x,
    taps, keeps, streamed) with one (B, T, C) tap per layer. In training
    with ``layerdrop`` each layer is kept with probability 1 - layerdrop,
    drawn on the host: a dropped layer is skipped, its tap is its input x
    and its keep is 0 (``modules.py:768-775``). ``keeps`` is None when no
    layer can drop. ``drop_path`` = (start, end): layer i's drop-path rate
    is ``linspace(start, end, depth)[i]`` (``modules.py:698-701``).
    ``streamed`` is the fp32 sum or mean of the taps that a
    ``parallel.pipeline.Stream`` asks for (None without one).

    A trunk split over the mesh's "stage" axis (``pipeline``, set by
    ``parallel.pipeline.split_trunk``) holds its stage's layers only (as a
    ``ModuleDict`` under their stack indices, so the parameter names stay)
    and runs the GPipe schedule (``parallel.pipeline.GPipe.run``): its
    taps stay on their stages (None), and ``streamed`` is the same value
    the plain loop gives."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float,
                 eps: float, layerdrop: float = 0.0, matmul_impl: str = "bf16",
                 drop_path: Tuple[float, float] = (0.0, 0.0), **block_kw):
        super().__init__()
        self.layerdrop = layerdrop
        self.depth = depth
        self.rates = [float(r) for r in np.linspace(drop_path[0], drop_path[1], depth,
                                                    dtype=np.float32)]
        self.layers = nn.ModuleList(
            AltBlock(dim, num_heads, mlp_ratio, eps, matmul_impl=matmul_impl,
                     drop_path=self.rates[i], **block_kw)
            for i in range(depth)
        )
        self.pipeline = None  # parallel.pipeline.GPipe of a trunk split over stages

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor], bias: Bias,
        rngs: Optional[Rngs] = None, scales: Optional[torch.Tensor] = None, stream=None,
    ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]], Optional[List[float]],
               Optional[torch.Tensor]]:
        if self.pipeline is not None:
            return self.pipeline.run(self, x, padding_mask, bias, rngs, scales, stream)
        drop = self.training and self.layerdrop > 0.0
        if drop:
            draws = torch.rand((len(self.layers),), generator=_need(rngs, "layerdrop").host)
        taps, keeps = [], []
        for i, block in enumerate(self.layers):
            if drop and float(draws[i]) < self.layerdrop:
                taps.append(x)
                keeps.append(0.0)
                continue
            x, tap = block(x, padding_mask, bias if scales is None else
                           scale_bias(bias, scales[i]), rngs)
            taps.append(tap)
            keeps.append(1.0)
        keeps = keeps if drop else None
        return x, taps, keeps, None if stream is None else stream.of(taps, keeps)


def top_k_tap_average(taps: Sequence[torch.Tensor], k: int,
                      keeps: Optional[Sequence[float]] = None) -> torch.Tensor:
    """fp32 mean of the last ``k`` kept layer taps (``top_k_tap_average``,
    ``modules.py:915-933``): layer i counts when it is kept and at most k - 1
    kept layers follow it; ``keeps`` None keeps every layer. The taps are
    summed in layer order, as a pipelined trunk's stream sums them."""
    if keeps is None:
        return torch.stack(list(taps[-k:])).float().mean(dim=0)
    chosen, later = [], 0.0
    for tap, keep in zip(reversed(taps), reversed(keeps)):
        later += keep
        if keep and later <= k:
            chosen.append(tap)
    if not chosen:  # every layer dropped: the JAX weights are all 0
        return torch.zeros_like(taps[-1], dtype=torch.float32)
    return torch.stack(chosen[::-1]).float().sum(dim=0) / len(chosen)


class PrenetEncoder(nn.Module):
    """The prenet: dropout and the block stack, with its LayerNorm before
    them (post-LN blocks) or after them (pre-LN); its taps are discarded
    (``PrenetEncoder``, ``modules.py:936-974``)."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_ratio: float,
                 eps: float, prenet_dropout: float = 0.0, layerdrop: float = 0.0,
                 matmul_impl: str = "bf16", layer_norm_first: bool = False,
                 norm_affine: bool = True, **block_kw):
        super().__init__()
        self.prenet_dropout = prenet_dropout
        self.layer_norm_first = layer_norm_first
        self.norm = Fp32LayerNorm(dim, eps, norm_affine)
        self.blocks = BlockStack(depth, dim, num_heads, mlp_ratio, eps, layerdrop,
                                 matmul_impl, layer_norm_first=layer_norm_first,
                                 norm_affine=norm_affine, **block_kw)

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor], bias: Bias,
        rngs: Optional[Rngs] = None, scales: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if not self.layer_norm_first:
            x = self.norm(x)
        if self.training and self.prenet_dropout > 0.0:
            x = dropout(x, self.prenet_dropout, _need(rngs, "prenet dropout").device)
        x = self.blocks(x, padding_mask, bias, rngs, scales)[0]
        if self.layer_norm_first:
            x = self.norm(x)
        return x


def fp32_instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the time axis of (B, T, C) with fp32 statistics,
    no affine, cast back (``fp32_instance_norm``, ``modules.py:122-128``)."""
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    var = (x32 - mean).square().mean(dim=1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _same_pad(k: int) -> Tuple[int, int]:
    """A k//2 conv pad followed by SamePad: (k//2, k//2 - (k even))."""
    return k // 2, k // 2 - (1 if k % 2 == 0 else 0)


class Conv1dBlockNorm(nn.Module):
    """Grouped conv -> LayerNorm (no affine, fp32) -> exact GELU, one block of
    ``Decoder1d`` (``Conv1dBlockNorm``, ``modules.py:1033-1065``); weight (out,
    in/groups, k), the bias added in the compute dtype."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, groups: int):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.norm = Fp32LayerNorm(out_dim, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv1d_same(x, self.weight, self.bias, 1, self.groups, pad=_same_pad(self.kernel))
        return F.gelu(self.norm(y))


class Conv2dBlockNorm(nn.Module):
    """The 2-D twin of ``Conv1dBlockNorm`` on (B, H, W, C) (``Conv2dBlockNorm``,
    ``modules.py:1105-1136``); weight (out, in/groups, k, k). The bias is
    added in the compute dtype, as ``Conv1dBlockNorm`` adds it: JAX adds its
    fp32 bias to the conv output, which turns a bf16 block's output fp32, and
    the next block's conv then refuses the mixed dtypes, so the JAX image
    decoder runs in fp32 only. In fp32 the two agree."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, groups: int):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.norm = Fp32LayerNorm(out_dim, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = _same_pad(self.kernel)
        xb = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
        y = F.conv2d(xb, self.weight.to(x.dtype), self.bias.to(x.dtype), groups=self.groups)
        return F.gelu(self.norm(y.permute(0, 2, 3, 1)))


def _decode(blocks: nn.ModuleList, x: torch.Tensor, residual_on: bool) -> torch.Tensor:
    residual = x
    for blk in blocks:
        y = blk(x)
        if residual_on and residual.shape[-1] == y.shape[-1]:
            y = y + residual
        residual = x = y
    return x


class Decoder1d(nn.Module):
    """The audio and the shared decoder (``Decoder1d``, ``modules.py:
    1068-1109``): conv blocks with residuals where the widths agree, then
    the projection head: ``projection_layers`` - 1 Linear + exact GELU
    layers ``proj_{i}`` (the first widening by ``projection_ratio``) and the
    output Linear to ``out_dim`` (``proj`` alone, else the last
    ``proj_{i}``); (B, T, C) in and out."""

    def __init__(self, in_dim: int, out_dim: int, decoder_dim: int, kernel: int, groups: int,
                 layers: int, residual: bool = True, projection_layers: int = 1,
                 projection_ratio: float = 2.0):
        super().__init__()
        self.residual = residual
        self.blocks = nn.ModuleList(
            Conv1dBlockNorm(in_dim if i == 0 else decoder_dim, decoder_dim, kernel, groups)
            for i in range(layers)
        )
        if projection_layers == 1:
            self.proj = nn.Linear(decoder_dim, out_dim)
            self.head = ["proj"]
            return
        self.head, curr = [], decoder_dim
        for i in range(projection_layers - 1):
            nxt = int(curr * projection_ratio) if i == 0 else curr
            setattr(self, f"proj_{i}", nn.Linear(curr, nxt))
            self.head.append(f"proj_{i}")
            curr = nxt
        setattr(self, f"proj_{projection_layers - 1}", nn.Linear(curr, out_dim))
        self.head.append(f"proj_{projection_layers - 1}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _decode(self.blocks, x, self.residual)
        for name in self.head[:-1]:
            x = F.gelu(_linear(x, getattr(self, name)))
        return _linear(x, getattr(self, self.head[-1]))


class Decoder2d(nn.Module):
    """The image decoder (``Decoder2d``, ``modules.py:1139-1181``): the (B, P,
    C) patches as a (B, h, w, C) grid through 2-D conv blocks, then ``proj``."""

    def __init__(self, in_dim: int, out_dim: int, decoder_dim: int, kernel: int, groups: int,
                 layers: int, grid: int, residual: bool = True):
        super().__init__()
        self.residual, self.grid = residual, grid
        self.blocks = nn.ModuleList(
            Conv2dBlockNorm(in_dim if i == 0 else decoder_dim, decoder_dim, kernel, groups)
            for i in range(layers)
        )
        self.proj = nn.Linear(decoder_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        y = _decode(self.blocks, x.reshape(b, self.grid, self.grid, c), self.residual)
        return _linear(y.reshape(b, t, -1), self.proj)
