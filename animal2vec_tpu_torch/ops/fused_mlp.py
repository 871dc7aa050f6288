"""Fused post-LN MLP sub-block: the port of
``animal2vec_tpu/ops/fused_mlp.fused_block_mlp`` (bf16 path, with the
training hash dropout; its int8 serving twin below), and the plain fused
MLP of pre-LN blocks, ``fused_mlp`` (bf16, fp32 and int8, at the end).

    r = LN1(x);  h = drop_a(GELU(fc1 r));  t = drop_b(fc2 h)
    x_out = LN2(r + dp(drop_c(t)))  ->  (x_out, t)

``t`` is the layer tap (the ffn target), taken before the post-mlp dropout
``drop_c``. ``dp`` is drop-path on the branch: with ``branch_scale`` (an
fp32 (B,) factor per sample of x (B, T, C), 0 or 1 / (1 - rate)) the
branch times its sample's factor in fp32, rounded once to the storage
dtype; None leaves the kernel's launches as they were. Weights come in the JAX layout, ``w1`` (C, M) and ``w2`` (M, C);
the model passes ``Linear.weight.t()`` views, which the kernel reads without
a copy. On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/fused_block.cu``: bf16, or fp32 with each product taken as three
bf16 products of the operands' split parts); on a CPU tensor it runs
``fused_block_plain``, a transcription of the JAX ``_ref_block_bf16``; any
other device raises. Serving (no gradient wanted, no dropout) goes through
the torch custom op ``a2v::fused_block`` (the kernel for CUDA tensors, the
plain version for CPU tensors, a fake for tracing), as the int8 block goes
through ``a2v::fused_block_int8``.

Numerics (both versions): fp32 LayerNorm statistics, r cast back to the
storage dtype before fc1, fp32 accumulation, bias + exact-erf GELU and the
first dropout in fp32, h cast to the storage dtype before fc2, the second
dropout on the fp32 fc2 sum, the post dropout on t rounded back to the
storage dtype, and the residual add ``r + drop_c(t)`` in the storage dtype
before LN2.

Dropout (``seeds`` = three int32, ``act_rate`` for the first two sites,
``post_rate`` for the third): keep masks from ``ops.dropout.hash_keep``
over (seed, row0 + row, column), rows of the flattened (N, C) input, offset
by ``row0`` (a data-parallel rank's first global row, ``ops.dropout``). The JAX
finetune trunk runs on sequences padded to the TPU kernel's block length, so
its rows are b * T_pad + t; the port does not pad and its rows are b * T +
t. The masks are the same function of (seed, row, column), with the same
statistics, but realize differently at model level: mask equality is tested
on this op.

Training: on CUDA the wrapper is a ``torch.autograd.Function``. Its forward
launches the kernel and saves only the inputs; its backward
(``fused_block_recompute``) recomputes the block through
``fused_block_plain``'s math under autograd, as the JAX
``_fused_block_bf16_bwd`` recomputes through ``_ref_block_bf16``. The two
products are ``_Fp32SumMatmul``: the fp32 sum of the storage-dtype operands
(a bf16 GEMM with an fp32 output on CUDA), kept in fp32 through the bias,
GELU and the dropouts, as JAX's ``dot_general(..., preferred_element_type=
float32)``. Their backward takes JAX's transpose rule (the fp32 cotangent
times the bf16 operand, summed in fp32, rounded once to the operand's
dtype) with bf16 GEMMs only: the fp32 cotangent is split into a bf16 head
and a bf16 tail (``g = hi + lo`` to about 2^-17), two products whose fp32
sums add up. The recompute regenerates the three keep masks with
``hash_keep``'s int64 torch arithmetic over (N, M) and twice (N, C) per
call: on an H100 that is the largest cost of an a2v-large train step
(``PERF.md`` section 5), and it is meant to move into a kernel, with the
torch version kept for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from animal2vec_tpu_torch.kernels.build import check, library, require_bf16
from animal2vec_tpu_torch.ops.dropout import hash_keep, keep_scale, keep_threshold
from animal2vec_tpu_torch.ops.int8_mm import INV_127, int_matmul, quantize_rows


def _ln(z: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    zf = z.float()
    mean = zf.mean(dim=-1, keepdim=True)
    var = (zf - mean).square().mean(dim=-1, keepdim=True)
    y = (zf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y


def _fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 a @ b of two 2-D storage-dtype matrices: the exact products
    summed in fp32 (a bf16 GEMM with an fp32 output on CUDA)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return _fp32_matmul(a, b)


def _halves(g: torch.Tensor, dtype: torch.dtype):
    """An fp32 cotangent as two storage-dtype parts whose sum it is to about
    2^-17 (for bf16): the head and what the head leaves."""
    hi = g.to(dtype)
    return hi, (g - hi.float()).to(dtype)


class _Fp32SumMatmul(torch.autograd.Function):
    """a @ b in fp32 for storage-dtype a, b (JAX's ``dot_general`` with
    ``preferred_element_type=float32``). The gradients follow JAX's transpose
    rule: the fp32 cotangent times the other operand, summed in fp32 and
    rounded once to the operand's dtype; on bf16 operands the cotangent goes
    in as its two bf16 halves."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        if a.dtype == torch.float32:
            parts = (g,)
        else:
            parts = _halves(g, a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = sum(_mm32(p, b.t()) for p in parts).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = sum(_mm32(a.t(), p) for p in parts).to(b.dtype)
        return ga, gb


def fp32_sum_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two 2-D storage-dtype matrices summed in fp32, with JAX's
    transpose rule as its backward (``_Fp32SumMatmul``)."""
    return _Fp32SumMatmul.apply(a, b)


def _hash_drop(v: torch.Tensor, seed, rate: float, rows: torch.Tensor,
               col0: int = 0) -> torch.Tensor:
    """fp32 (N, K) ``v`` under the hash keep mask of (seed, rows, columns
    from ``col0``), kept values scaled by 1 / (1 - rate)."""
    cols = col0 + torch.arange(v.shape[1], device=v.device)[None, :]
    return v * (hash_keep(seed, rows, cols, rate) / (1.0 - rate))


def _row_scale(branch_scale: torch.Tensor, n: int) -> torch.Tensor:
    """The (N, 1) fp32 factor of each row of a flattened (B, T, C) from the
    (B,) per-sample ``branch_scale``."""
    b = branch_scale.shape[0]
    if b == 0 or n % b:
        raise ValueError(f"branch_scale must have one value per sample: {b} for {n} rows")
    return branch_scale.float().repeat_interleave(n // b)[:, None]


def _rows(n: int, row0: int, device) -> torch.Tensor:
    return row0 + torch.arange(n, device=device)[:, None]


def _fc1_math(x2, ln1_scale, ln1_bias, w1, b1, eps, seed, rate, matmul, row0=0, col0=0,
              to_model=None):
    """(r, h) of the block's first half on the flattened (N, C) ``x2``: r =
    dtype(LN1(x2)), h = dtype(drop_a(GELU(r w1 + b1))) for ``w1`` (C, Ms),
    drop_a's columns from ``col0``; ``to_model`` (a tensor-parallel rank's
    identity with an all-reduced gradient) takes r on its way into fc1."""
    dtype = x2.dtype
    r = _ln(x2, ln1_scale, ln1_bias, eps).to(dtype)
    h = matmul(r if to_model is None else to_model(r), w1.to(dtype))
    if b1 is not None:
        h = h + b1.float()
    h = F.gelu(h)
    if rate > 0.0:
        h = _hash_drop(h, seed, rate, _rows(x2.shape[0], row0, x2.device), col0)
    return r, h.to(dtype)


def _ln2_math(s, b2, r, ln2_scale, ln2_bias, eps, seeds, act_rate, post_rate, row0=0,
              branch_scale=None):
    """(x_out, t) of the block's second half from fc2's fp32 (N, C) sum
    ``s`` and ``_fc1_math``'s r: t = dtype(drop_b(s + b2)), x_out =
    dtype(LN2(r + dp(drop_c(t)))); ``seeds`` = (drop_b's, drop_c's)."""
    dtype = r.dtype
    rows = _rows(r.shape[0], row0, r.device)
    t = s.float()
    if b2 is not None:
        t = t + b2.float()
    if act_rate > 0.0:
        t = _hash_drop(t, seeds[0], act_rate, rows)
    t = t.to(dtype)
    td = t
    if post_rate > 0.0:
        td = _hash_drop(t.float(), seeds[1], post_rate, rows).to(dtype)
    if branch_scale is not None:
        td = (td.float() * _row_scale(branch_scale, td.shape[0])).to(dtype)
    return _ln(r + td, ln2_scale, ln2_bias, eps).to(dtype), t


def _block_math(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps,
                seeds, act_rate, post_rate, matmul, row0=0, branch_scale=None):
    c = x.shape[-1]
    r, h = _fc1_math(x.reshape(-1, c), ln1_scale, ln1_bias, w1, b1, eps,
                     seeds[0] if act_rate > 0.0 else None, act_rate, matmul, row0)
    x_out, t = _ln2_math(matmul(h, w2.to(x.dtype)), b2, r, ln2_scale, ln2_bias, eps,
                         None if seeds is None else seeds[1:], act_rate, post_rate, row0,
                         branch_scale)
    return x_out.reshape(x.shape), t.reshape(x.shape)


def fused_block_plain(
    x: torch.Tensor,
    ln1_scale: Optional[torch.Tensor],
    ln1_bias: Optional[torch.Tensor],
    w1: torch.Tensor,
    w2: torch.Tensor,
    b1: Optional[torch.Tensor],
    b2: Optional[torch.Tensor],
    ln2_scale: Optional[torch.Tensor],
    ln2_bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    seeds: Optional[Sequence[int]] = None,
    act_rate: float = 0.0,
    post_rate: float = 0.0,
    row0: int = 0,
    branch_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference of the kernel (any device, differentiable); products in
    fp32 on the storage-dtype operands; the masks' rows start at ``row0``;
    ``branch_scale`` the per-sample drop-path factor of the MLP branch."""
    _check_rates(seeds, act_rate, post_rate)
    return _block_math(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps,
                       seeds, act_rate, post_rate, _fp32_matmul, row0, branch_scale)


def _vec(v: Optional[torch.Tensor], size: int, fill: float, dev) -> torch.Tensor:
    """A kernel's contiguous fp32 (size,) vector argument; ``fill`` for None."""
    if v is None:
        return torch.full((size,), fill, dtype=torch.float32, device=dev)
    if v.shape != (size,) or v.device != dev:
        raise ValueError(f"expected a ({size},) vector on {dev}, got {tuple(v.shape)} on {v.device}")
    return v.detach().to(torch.float32).contiguous()


def _check_rates(seeds, act_rate, post_rate):
    if (act_rate > 0.0 or post_rate > 0.0) and (seeds is None or len(seeds) != 3):
        raise ValueError("a nonzero dropout rate needs three int32 seeds")


def _launch(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps,
            seeds, act_rate, post_rate, row0=0, branch_scale=None):
    """One launch of the kernel: (x_out, t)."""
    c = x.shape[-1]
    m = w1.shape[1]
    if w1.shape != (c, m) or w2.shape != (m, c):
        raise ValueError(
            f"w1 must be (C, M) and w2 (M, C) for C={c}: got {tuple(w1.shape)}, "
            f"{tuple(w2.shape)}"
        )
    if x.dtype not in (torch.bfloat16, torch.float32) or w1.dtype != x.dtype \
            or w2.dtype != x.dtype:
        raise ValueError(f"the kernel takes bf16 or fp32 x and weights of x's dtype, got "
                         f"{x.dtype}, {w1.dtype}, {w2.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous x")
    if c % 128 or m % 128:
        raise ValueError(f"the kernel needs C % 128 == 0 and M % 128 == 0, got C={c}, M={m}")
    dev = x.device
    l1s, l1b = _vec(ln1_scale, c, 1.0, dev), _vec(ln1_bias, c, 0.0, dev)
    l2s, l2b = _vec(ln2_scale, c, 1.0, dev), _vec(ln2_bias, c, 0.0, dev)
    b1v, b2v = _vec(b1, m, 0.0, dev), _vec(b2, c, 0.0, dev)
    w1t = w1.detach().t().contiguous()  # (M, C): a no-op for Linear.weight.t() views
    w2t = w2.detach().t().contiguous()  # (C, M)
    if w1t.device != dev or w2t.device != dev:
        raise ValueError("weights must be on x's device")
    s0, s1, s2 = (int(v) for v in seeds) if seeds is not None else (0, 0, 0)
    act_t = keep_threshold(act_rate) if act_rate > 0.0 else 0
    post_t = keep_threshold(post_rate) if post_rate > 0.0 else 0
    n = x.numel() // c
    scale_ptr, rows_per_scale = None, 1
    if branch_scale is not None:
        b = branch_scale.shape[0]
        if branch_scale.dim() != 1 or b == 0 or n % b or branch_scale.device != dev:
            raise ValueError(f"branch_scale must be a (B,) vector on {dev}, one value per "
                             f"sample of the {n} rows, got {tuple(branch_scale.shape)}")
        branch_scale = branch_scale.detach().to(torch.float32).contiguous()
        scale_ptr, rows_per_scale = branch_scale.data_ptr(), n // b
    r = torch.empty((n, c), dtype=x.dtype, device=dev)
    t = torch.empty(x.shape, dtype=x.dtype, device=dev)
    x_out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if x.dtype == torch.float32:
        # bf16 scratch of the fp32 instance: r's and h's [hi | lo | hi] and
        # the weights' [hi | hi | lo] rows (csrc/fused_block.cu)
        scratch = [torch.empty(shape, dtype=torch.bfloat16, device=dev)
                   for shape in ((n, 3 * c), (m, 3 * c), (c, 3 * m), (n, 3 * m))]
        fn = library().a2v_fused_block_f32
    else:
        scratch = [torch.empty((n, m), dtype=x.dtype, device=dev)]  # h
        fn = library().a2v_fused_block
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), l1s.data_ptr(), l1b.data_ptr(), w1t.data_ptr(), b1v.data_ptr(),
            w2t.data_ptr(), b2v.data_ptr(), l2s.data_ptr(), l2b.data_ptr(),
            r.data_ptr(), *(v.data_ptr() for v in scratch), t.data_ptr(), x_out.data_ptr(),
            n, c, m, float(eps), s0, s1, s2,
            act_t, keep_scale(act_rate) if act_t else 1.0,
            post_t, keep_scale(post_rate) if post_t else 1.0, int(row0) & 0xFFFFFFFF,
            scale_ptr, rows_per_scale, stream,
        )
    check(err, "fused block kernel")
    fused_block_mlp.launches += 1
    return x_out, t


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps,
                seeds, act_rate, post_rate, row0, branch_scale):
        ctx.save_for_backward(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias,
                              branch_scale)
        ctx.conf = (eps, seeds, act_rate, post_rate)
        ctx.row0 = row0
        return _launch(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps,
                       seeds, act_rate, post_rate, row0, branch_scale)

    @staticmethod
    def backward(ctx, g_out, g_tap):
        *inputs, branch_scale = ctx.saved_tensors
        grads = fused_block_recompute(inputs, ctx.conf, (g_out, g_tap),
                                      ctx.needs_input_grad[:9], ctx.row0, branch_scale)
        return (*grads, None, None, None, None, None, None)


def _recompute(math, inputs, needs, cotangents):
    """The gradients of ``math(*inputs)``'s outputs under ``cotangents``, the
    inputs detached and recomputed under autograd: one per input, None where
    ``needs`` is false or the input is None."""
    with torch.enable_grad():
        leaves = [None if v is None else v.detach().requires_grad_(n)
                  for v, n in zip(inputs, needs)]
        outs = math(*leaves)
        wrt = [v for v, n in zip(leaves, needs) if n and v is not None]
        grads = iter(torch.autograd.grad(outs, wrt, cotangents, allow_unused=True))
    return [next(grads) if n and v is not None else None for v, n in zip(leaves, needs)]


def fused_block_recompute(inputs, conf, cotangents, needs=(True,) * 9, row0=0,
                          branch_scale=None):
    """The backward of the kernel's autograd Function (any device): the block
    recomputed from its nine tensor ``inputs`` (x, ln1_scale, ln1_bias, w1,
    w2, b1, b2, ln2_scale, ln2_bias; None where absent) under autograd with
    the fp32-sum products, for ``conf`` = (eps, seeds, act_rate, post_rate),
    the masks' first row ``row0``, the drop-path ``branch_scale`` and the
    cotangents of (x_out, t). Returns one gradient per input, None where
    ``needs`` is false or the input is None."""
    eps, seeds, act_rate, post_rate = conf
    return _recompute(lambda *leaves: _block_math(
        *leaves, eps, seeds, act_rate, post_rate, _Fp32SumMatmul.apply, row0, branch_scale),
        inputs, needs, cotangents)


_Opt = Optional[torch.Tensor]


@torch.library.custom_op("a2v::fused_block", mutates_args=(), device_types="cuda")
def _block_op(x: torch.Tensor, ln1_scale: _Opt, ln1_bias: _Opt, w1: torch.Tensor,
              w2: torch.Tensor, b1: _Opt, b2: _Opt, ln2_scale: _Opt, ln2_bias: _Opt,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """#6 without dropout on the card: one launch of the kernel."""
    return _launch(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps,
                   None, 0.0, 0.0)


@_block_op.register_kernel("cpu")
def _block_plain(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps):
    return fused_block_plain(x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps)


@_block_op.register_fake
def _block_fake(x, *_):
    return x.new_empty(x.shape), x.new_empty(x.shape)


def fused_block_mlp(
    x: torch.Tensor,
    ln1_scale: Optional[torch.Tensor],
    ln1_bias: Optional[torch.Tensor],
    w1: torch.Tensor,
    w2: torch.Tensor,
    b1: Optional[torch.Tensor],
    b2: Optional[torch.Tensor],
    ln2_scale: Optional[torch.Tensor],
    ln2_bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    seeds: Optional[Sequence[int]] = None,
    act_rate: float = 0.0,
    post_rate: float = 0.0,
    row0: int = 0,
    branch_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_out, t) for x (..., C). Serving (no gradient wanted, no dropout,
    no drop-path): the custom op ``a2v::fused_block``, the kernel on CUDA
    and the plain version on CPU. Training: on CUDA the autograd Function
    (or, without a gradient wanted, one launch with dropout), on CPU the
    plain version under autograd; the dropout masks' rows start at
    ``row0``; ``branch_scale`` (B,) scales each sample's MLP branch."""
    args = (x, ln1_scale, ln1_bias, w1, w2, b1, b2, ln2_scale, ln2_bias, eps)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused block runs on cuda or cpu tensors, got {x.device}")
    _check_rates(seeds, act_rate, post_rate)
    wants_grad = torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)
    dropout = act_rate > 0.0 or post_rate > 0.0 or branch_scale is not None
    if not wants_grad and not dropout:
        return _block_op(*args[:-1], float(eps))
    if x.device.type == "cpu":
        return fused_block_plain(*args, seeds, act_rate, post_rate, row0, branch_scale)
    seeds = None if seeds is None else tuple(int(s) for s in seeds)
    if wants_grad:
        return _FusedBlock.apply(*args, seeds, float(act_rate), float(post_rate), int(row0),
                                 branch_scale)
    return _launch(*args, seeds, float(act_rate), float(post_rate), int(row0), branch_scale)


fused_block_mlp.launches = 0


# The tensor-parallel split of #6 (``csrc/fused_block.cu``, three entries):
# a rank of a "model" group holds Ms = M / mp hidden columns of fc1 (from
# ``col0``) and the same rows of fc2, JAX's column- and row-parallel
# layout (``parallel/mesh.py:85-86``); fc2's partial sums are reduced over
# the group before the bias, the residual and LN2:
#
#   block_fc1          (r, h) = (LN1(x), drop_a(GELU(r W1s + b1s)))
#   block_fc2_partial  P = h W2s in fp32
#   (all-reduce of P over the group: S)
#   block_ln2          (x_out, t) = (LN2(r + dp(drop_c(t))), drop_b(S + b2))
#
# drop_a hashes hidden column col0 + j, so the ranks' masks are the column
# slices of the unsharded block's; drop_b and drop_c see whole rows. With
# one rank the three compute ``fused_block_plain``'s function. Training:
# each is an autograd Function whose backward recomputes through the plain
# math (``_fc1_math``, the fp32-sum product, ``_ln2_math``), with
# ``to_model`` (the Megatron f: identity forward, all-reduced gradient)
# where r enters fc1. The kernels take bf16 only; CPU tensors run the plain
# versions.


def _launch_fc1(x2, ln1_scale, ln1_bias, w1, b1, eps, seed, rate, row0, col0):
    n, c = x2.shape
    ms = w1.shape[1]
    require_bf16("block_fc1 (the tensor-parallel split of #6)", x2.dtype, w1.dtype)
    if w1.shape[0] != c:
        raise ValueError(f"block_fc1 takes x (N, C) and w1 (C, Ms), got {tuple(x2.shape)}, "
                         f"{tuple(w1.shape)}")
    if not x2.is_contiguous():
        raise ValueError("block_fc1 takes a contiguous x")
    if c % 128 or ms % 128:
        raise ValueError(f"block_fc1 needs C % 128 == 0 and Ms % 128 == 0, got C={c}, Ms={ms}")
    dev = x2.device
    w1t = w1.detach().t().contiguous()  # (Ms, C): a no-op for Linear.weight.t() views
    l1s, l1b, b1v = _vec(ln1_scale, c, 1.0, dev), _vec(ln1_bias, c, 0.0, dev), _vec(b1, ms, 0.0,
                                                                                     dev)
    thresh = keep_threshold(rate) if rate > 0.0 else 0
    r = torch.empty((n, c), dtype=x2.dtype, device=dev)
    h = torch.empty((n, ms), dtype=x2.dtype, device=dev)
    with torch.cuda.device(dev):
        err = library().a2v_block_fc1(
            x2.data_ptr(), l1s.data_ptr(), l1b.data_ptr(), w1t.data_ptr(), b1v.data_ptr(),
            r.data_ptr(), h.data_ptr(), n, c, ms, float(eps), int(seed or 0), thresh,
            keep_scale(rate) if thresh else 1.0, int(row0) & 0xFFFFFFFF,
            int(col0) & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    check(err, "block fc1 kernel")
    block_fc1.launches += 1
    return r, h


class _BlockFc1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ln1_scale, ln1_bias, w1, b1, eps, seed, rate, row0, col0, to_model):
        ctx.save_for_backward(x2, ln1_scale, ln1_bias, w1, b1)
        ctx.conf = (eps, seed, rate, row0, col0, to_model)
        return _launch_fc1(x2, ln1_scale, ln1_bias, w1, b1, eps, seed, rate, row0, col0)

    @staticmethod
    def backward(ctx, g_r, g_h):
        eps, seed, rate, row0, col0, to_model = ctx.conf
        grads = _recompute(lambda *leaves: _fc1_math(
            *leaves, eps, seed, rate, _Fp32SumMatmul.apply, row0, col0, to_model),
            ctx.saved_tensors, ctx.needs_input_grad[:5], (g_r, g_h))
        return (*grads, None, None, None, None, None, None)


def block_fc1(x2, ln1_scale, ln1_bias, w1, b1, eps=1e-5, seed=None, rate=0.0, row0=0, col0=0,
              to_model=None):
    """(r (N, C), h (N, Ms)) of the split block's first half on the
    flattened (N, C) ``x2``, ``w1`` the rank's (C, Ms) columns of fc1 (JAX
    layout: ``fc1.weight.t()``), drop_a at ``rate`` from one int32 ``seed``
    over rows from ``row0`` and hidden columns from ``col0``; ``to_model``
    takes r into fc1 under autograd. Kernel on CUDA (``a2v_block_fc1``),
    the plain version on CPU."""
    if rate > 0.0 and seed is None:
        raise ValueError("a nonzero dropout rate needs an int32 seed")
    if x2.device.type == "cpu":
        return _fc1_math(x2, ln1_scale, ln1_bias, w1, b1, eps, seed, rate, _fp32_matmul, row0,
                         col0, to_model)
    if x2.device.type != "cuda":
        raise ValueError(f"block_fc1 runs on cuda or cpu tensors, got {x2.device}")
    args = (x2, ln1_scale, ln1_bias, w1, b1)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return _BlockFc1.apply(*args, float(eps), seed, float(rate), int(row0), int(col0),
                               to_model)
    return _launch_fc1(*args, eps, seed, rate, row0, col0)


block_fc1.launches = 0


def _launch_fc2_partial(h, w2):
    n, ms = h.shape
    c = w2.shape[1]
    require_bf16("block_fc2_partial (the tensor-parallel split of #6)", h.dtype, w2.dtype)
    if w2.shape[0] != ms:
        raise ValueError(f"block_fc2_partial takes h (N, Ms) and w2 (Ms, C), got "
                         f"{tuple(h.shape)}, {tuple(w2.shape)}")
    if ms % 64 or c % 8:
        raise ValueError(f"block_fc2_partial needs Ms % 64 == 0 and C % 8 == 0, got Ms={ms}, "
                         f"C={c}")
    if not h.is_contiguous():
        raise ValueError("block_fc2_partial takes a contiguous h")
    w2t = w2.detach().t().contiguous()  # (C, Ms): a no-op for Linear.weight.t() views
    out = torch.empty((n, c), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = library().a2v_block_fc2_partial(h.data_ptr(), w2t.data_ptr(), out.data_ptr(), n, ms,
                                              c, torch.cuda.current_stream().cuda_stream)
    check(err, "block fc2 partial kernel")
    block_fc2_partial.launches += 1
    return out


class _Fc2Partial(_Fp32SumMatmul):
    """The fp32 sum h @ w2 through the fp32-output GEMM kernel; the backward
    is ``_Fp32SumMatmul``'s (JAX's transpose rule)."""

    @staticmethod
    def forward(ctx, h, w2):
        ctx.save_for_backward(h, w2)
        return _launch_fc2_partial(h, w2)


def block_fc2_partial(h: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The rank's fp32 (N, C) partial of fc2, ``h`` (N, Ms) times ``w2`` the
    rank's (Ms, C) rows of fc2 (JAX layout: ``fc2.weight.t()``), without the
    bias. Kernel on CUDA (``a2v_block_fc2_partial``), the plain fp32-sum
    product on CPU."""
    if h.device.type == "cpu":
        return _fp32_matmul(h, w2.to(h.dtype))
    if h.device.type != "cuda":
        raise ValueError(f"block_fc2_partial runs on cuda or cpu tensors, got {h.device}")
    if torch.is_grad_enabled() and (h.requires_grad or w2.requires_grad):
        return _Fc2Partial.apply(h, w2)
    return _launch_fc2_partial(h, w2)


block_fc2_partial.launches = 0


def _launch_ln2(s, b2, r, ln2_scale, ln2_bias, eps, seeds, act_rate, post_rate, row0,
                branch_scale):
    n, c = r.shape
    require_bf16("block_ln2 (the tensor-parallel split of #6)", r.dtype)
    if s.shape != (n, c) or s.dtype != torch.float32:
        raise ValueError(f"block_ln2 takes an fp32 (N, C) sum, got {s.dtype} {tuple(s.shape)}")
    if c % 128:
        raise ValueError(f"block_ln2 needs C % 128 == 0, got C={c}")
    dev = r.device
    s, r = s.contiguous(), r.contiguous()
    b2v, l2s, l2b = _vec(b2, c, 0.0, dev), _vec(ln2_scale, c, 1.0, dev), _vec(ln2_bias, c, 0.0,
                                                                               dev)
    s_fc2, s_post = (int(v) for v in seeds) if seeds is not None else (0, 0)
    act_t = keep_threshold(act_rate) if act_rate > 0.0 else 0
    post_t = keep_threshold(post_rate) if post_rate > 0.0 else 0
    scale_ptr, rows_per_scale = None, 1
    if branch_scale is not None:
        b = branch_scale.shape[0]
        if branch_scale.dim() != 1 or b == 0 or n % b or branch_scale.device != dev:
            raise ValueError(f"branch_scale must be a (B,) vector on {dev}, one value per "
                             f"sample of the {n} rows, got {tuple(branch_scale.shape)}")
        branch_scale = branch_scale.detach().to(torch.float32).contiguous()
        scale_ptr, rows_per_scale = branch_scale.data_ptr(), n // b
    t = torch.empty((n, c), dtype=r.dtype, device=dev)
    x_out = torch.empty((n, c), dtype=r.dtype, device=dev)
    with torch.cuda.device(dev):
        err = library().a2v_block_ln2(
            s.data_ptr(), b2v.data_ptr(), r.data_ptr(), l2s.data_ptr(), l2b.data_ptr(),
            t.data_ptr(), x_out.data_ptr(), n, c, float(eps), s_fc2, act_t,
            keep_scale(act_rate) if act_t else 1.0, s_post, post_t,
            keep_scale(post_rate) if post_t else 1.0, int(row0) & 0xFFFFFFFF, scale_ptr,
            rows_per_scale, torch.cuda.current_stream().cuda_stream)
    check(err, "block ln2 kernel")
    block_ln2.launches += 1
    return x_out, t


class _BlockLn2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, b2, r, ln2_scale, ln2_bias, eps, seeds, act_rate, post_rate, row0,
                branch_scale):
        ctx.save_for_backward(s, b2, r, ln2_scale, ln2_bias, branch_scale)
        ctx.conf = (eps, seeds, act_rate, post_rate, row0)
        return _launch_ln2(s, b2, r, ln2_scale, ln2_bias, eps, seeds, act_rate, post_rate, row0,
                           branch_scale)

    @staticmethod
    def backward(ctx, g_out, g_t):
        *inputs, branch_scale = ctx.saved_tensors
        eps, seeds, act_rate, post_rate, row0 = ctx.conf
        grads = _recompute(lambda *leaves: _ln2_math(
            *leaves, eps, seeds, act_rate, post_rate, row0, branch_scale),
            inputs, ctx.needs_input_grad[:5], (g_out, g_t))
        return (*grads, None, None, None, None, None, None)


def block_ln2(s, b2, r, ln2_scale, ln2_bias, eps=1e-5, seeds=None, act_rate=0.0,
              post_rate=0.0, row0=0, branch_scale=None):
    """(x_out, t), each (N, C), of the split block's second half from the
    reduced fp32 fc2 sum ``s`` and ``block_fc1``'s r: drop_b at
    ``act_rate`` and drop_c at ``post_rate`` from ``seeds`` (two int32)
    over rows from ``row0``, ``branch_scale`` the per-sample drop-path
    factor. Kernel on CUDA (``a2v_block_ln2``), the plain version on CPU."""
    if (act_rate > 0.0 or post_rate > 0.0) and (seeds is None or len(seeds) != 2):
        raise ValueError("a nonzero dropout rate needs two int32 seeds")
    if r.device.type == "cpu":
        return _ln2_math(s, b2, r, ln2_scale, ln2_bias, eps, seeds, act_rate, post_rate, row0,
                         branch_scale)
    if r.device.type != "cuda":
        raise ValueError(f"block_ln2 runs on cuda or cpu tensors, got {r.device}")
    seeds = None if seeds is None else tuple(int(v) for v in seeds)
    args = (s, b2, r, ln2_scale, ln2_bias)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return _BlockLn2.apply(*args, float(eps), seeds, float(act_rate), float(post_rate),
                               int(row0), branch_scale)
    return _launch_ln2(*args, eps, seeds, act_rate, post_rate, row0, branch_scale)


block_ln2.launches = 0


# int8 serving block: the port of the int8 arm of the JAX ``fused_block_mlp``
# (``_kernel_int8_block``, ``fused_mlp.py:273-329``)
#
#   r = dtype(LN1(x));  r_q, rs = quantize_rows(r)
#   h = GELU(fp32(r_q W1_q^T) * rs * w1s + b1)                  (fp32)
#   for each hidden chunk j:  h_q, hs = quantize_rows(h[:, j])
#       acc += fp32(h_q W2_q[:, j]^T) * hs * w2s                (fp32)
#   t = dtype(acc + b2);  x_out = dtype(LN2(r + t))             (r + t in dtype)
#
# Weights in nn.Linear layout as ``ops.int8_mm.quantize_weight`` leaves them:
# w1_q (M, C) with w1_s (M,), w2_q (C, M) with w2_s (C,). h is re-quantized
# per (row, hidden chunk): the chunk is the JAX block_m, 1024 halved until it
# divides M (``hidden_chunk``), and no int32 sum spans two chunks. The JAX
# kernel's GELU takes the A&S erf (1.5e-7 from erf), the port's erf: an h
# value on a rounding boundary of its chunk's scale may quantize one step
# apart. Serving only: there is no backward (the JAX kernel has no vjp).


H_MAX_COLS = 128  # columns of one partial max of |h| (the kernel's fc1 tile width)


def hidden_chunk(m: int, block_m: int = 1024) -> int:
    """The int8 block's re-quantization chunk for hidden width M."""
    chunk = min(block_m, m)
    while m % chunk:
        chunk //= 2
    return chunk


def fused_block_int8_plain(
    x: torch.Tensor,
    ln1_scale: Optional[torch.Tensor],
    ln1_bias: Optional[torch.Tensor],
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: Optional[torch.Tensor],
    ln2_scale: Optional[torch.Tensor],
    ln2_bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference of the int8 kernel (any device): (x_out, t), the int8
    products exact in float64."""
    dtype = x.dtype
    c = x.shape[-1]
    r = _ln(x.reshape(-1, c), ln1_scale, ln1_bias, eps).to(dtype)
    t = _int8_mlp(r, w1_q, w1_s, b1, w2_q, w2_s, b2, chunk).to(dtype)
    x_out = _ln(r + t, ln2_scale, ln2_bias, eps).to(dtype)
    return x_out.reshape(x.shape), t.reshape(x.shape)


def _int8_mlp(x2, w1_q, w1_s, b1, w2_q, w2_s, b2, chunk=None) -> torch.Tensor:
    """fp32 sum + b2 of the int8 MLP on (N, C) rows ``x2`` (quantized per
    row here), h re-quantized per (row, chunk); the int8 products exact."""
    m = w1_q.shape[0]
    chunk = hidden_chunk(m) if chunk is None else chunk
    x_q, x_s = quantize_rows(x2)
    h = int_matmul(x_q, w1_q) * x_s[:, None] * w1_s.float()
    if b1 is not None:
        h = h + b1.float()
    h = F.gelu(h)
    acc = torch.zeros((x2.shape[0], w2_q.shape[0]), dtype=torch.float32, device=x2.device)
    for j in range(0, m, chunk):
        h_q, h_s = quantize_rows(h[:, j:j + chunk])
        acc = acc + int_matmul(h_q, w2_q[:, j:j + chunk]) * h_s[:, None] * w2_s.float()
    if b2 is not None:
        acc = acc + b2.float()
    return acc


def quantize_chunks_plain(h: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's h quantizer: the max of |h| over every
    128 columns, (N, M / 128), as fc1's epilogue writes it, each chunk's
    scale from the max of its partial maxima, max(amax * fp32(1/127),
    1e-12), and rint(h / s): (h_q int8 (N, M), hs fp32 (N, M / chunk)), what
    ``quantize_rows`` gives each chunk."""
    n, m = h.shape
    part = h.abs().reshape(n, m // H_MAX_COLS, H_MAX_COLS).amax(-1)
    s = torch.clamp_min(part.reshape(n, m // chunk, -1).amax(-1) * INV_127, 1e-12)
    h_q = torch.round(h.reshape(n, m // chunk, chunk) / s[..., None]).to(torch.int8)
    return h_q.reshape(n, m), s


@torch.library.custom_op("a2v::fused_block_int8", mutates_args=(), device_types="cuda")
def _block_int8_op(x: torch.Tensor, ln1_scale: _Opt, ln1_bias: _Opt, w1_q: torch.Tensor,
                   w1_s: torch.Tensor, b1: _Opt, w2_q: torch.Tensor, w2_s: torch.Tensor,
                   b2: _Opt, ln2_scale: _Opt, ln2_bias: _Opt, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """#7 on the card: one C entry of five launches."""
    c = x.shape[-1]
    m = w1_q.shape[0]
    require_bf16("the int8 fused block (#7)", x.dtype)
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous x")
    for name, w, shape in (("w1_q", w1_q, (m, c)), ("w2_q", w2_q, (c, m))):
        if w.dtype != torch.int8 or w.shape != shape or not w.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int8 {shape}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    if c % 128 or m % 128:
        raise ValueError(f"the kernel needs C % 128 == 0 and M % 128 == 0, got C={c}, M={m}")
    dev = x.device
    l1s, l1b = _vec(ln1_scale, c, 1.0, dev), _vec(ln1_bias, c, 0.0, dev)
    l2s, l2b = _vec(ln2_scale, c, 1.0, dev), _vec(ln2_bias, c, 0.0, dev)
    b1v, b2v = _vec(b1, m, 0.0, dev), _vec(b2, c, 0.0, dev)
    w1s, w2s = _vec(w1_s, m, 1.0, dev), _vec(w2_s, c, 1.0, dev)
    if w1_q.device != dev or w2_q.device != dev:
        raise ValueError("weights must be on x's device")
    chunk = hidden_chunk(m)
    n = x.numel() // c
    r = torch.empty((n, c), dtype=x.dtype, device=dev)
    r_q = torch.empty((n, c), dtype=torch.int8, device=dev)
    r_s = torch.empty((n,), dtype=torch.float32, device=dev)
    h = torch.empty((n, m), dtype=torch.float32, device=dev)
    h_max = torch.empty((n, m // H_MAX_COLS), dtype=torch.float32, device=dev)
    h_q = torch.empty((n, m), dtype=torch.int8, device=dev)
    h_s = torch.empty((n, m // chunk), dtype=torch.float32, device=dev)
    t = torch.empty(x.shape, dtype=x.dtype, device=dev)
    x_out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().a2v_fused_block_int8(
            x.data_ptr(), l1s.data_ptr(), l1b.data_ptr(), w1_q.data_ptr(), w1s.data_ptr(),
            b1v.data_ptr(), w2_q.data_ptr(), w2s.data_ptr(), b2v.data_ptr(), l2s.data_ptr(),
            l2b.data_ptr(), r.data_ptr(), r_q.data_ptr(), r_s.data_ptr(), h.data_ptr(),
            h_max.data_ptr(), h_q.data_ptr(), h_s.data_ptr(), t.data_ptr(), x_out.data_ptr(), n,
            c, m, chunk, float(eps), stream,
        )
    check(err, "int8 fused block kernel")
    fused_block_int8.launches += 1
    return x_out, t


@_block_int8_op.register_kernel("cpu")
def _block_int8_plain(*args):
    return fused_block_int8_plain(*args)


@_block_int8_op.register_fake
def _block_int8_fake(x, *_):
    return x.new_empty(x.shape), x.new_empty(x.shape)


def fused_block_int8(
    x: torch.Tensor,
    ln1_scale: Optional[torch.Tensor],
    ln1_bias: Optional[torch.Tensor],
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: Optional[torch.Tensor],
    ln2_scale: Optional[torch.Tensor],
    ln2_bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_out, t) of the int8 block for x (..., C): the custom op
    ``a2v::fused_block_int8``, the kernel on CUDA
    (``csrc/fused_block_int8.cu``) and the plain version on CPU."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 fused block runs on cuda or cpu tensors, got {x.device}")
    return _block_int8_op(x, ln1_scale, ln1_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, ln2_scale,
                          ln2_bias, float(eps))


fused_block_int8.launches = 0


# Plain two-layer MLP of pre-LN blocks: the port of the JAX ``fused_mlp``
# (``fused_mlp.py:601``), bf16 (``_kernel_bf16``, :112) and int8
# (``_kernel_int8``, :66), which ``models/modules.Mlp`` runs:
#
#   bf16:  out = dtype(drop_b(dtype(drop_a(GELU(x W1^T + b1))) W2^T + b2))
#   int8:  out = dtype(int8 MLP of x, quantized per row)         (_int8_mlp)
#
# Weights in nn.Linear layout: w1 (M, C), w2 (C2, M) (int8: w1_q, w2_q from
# ``ops.int8_mm.quantize_weight`` with their scales). The output has x's
# dtype and x's leading dims. int8 is serving only (the JAX int8 kernel has
# no vjp); the bf16 one is reached in training by pre-LN blocks, whose
# backward recomputes through the plain math (``_fused_bf16_bwd``). In
# training the bf16 MLP takes the activation dropout at two hash sites,
# drop_a after GELU and drop_b after fc2 + b2 (both on the fp32 values,
# before the rounding), from ``seeds`` = two int32 at ``rate``: keep masks
# ``ops.dropout.hash_keep`` over (seed, row0 + row, column), the rows of the
# flattened (N, C) input, as the post-LN block's first two sites. JAX's
# pre-LN block leaves its fused MLP for the composed one there and draws
# the mask with ``jax.random``; the port keeps its kernel.


def _mlp_math(x, w1, w2, b1, b2, seeds, rate, row0, matmul) -> torch.Tensor:
    dtype = x.dtype
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    rows = row0 + torch.arange(x2.shape[0], device=x.device)[:, None]
    h = matmul(x2, w1.to(dtype).t())
    if b1 is not None:
        h = h + b1.float()
    h = F.gelu(h)
    if rate > 0.0:
        h = _hash_drop(h, seeds[0], rate, rows)
    y = matmul(h.to(dtype), w2.to(dtype).t())
    if b2 is not None:
        y = y + b2.float()
    if rate > 0.0:
        y = _hash_drop(y, seeds[1], rate, rows)
    return y.to(dtype).reshape(*x.shape[:-1], y.shape[-1])


def _check_mlp_rate(seeds, rate):
    if rate > 0.0 and (seeds is None or len(seeds) != 2):
        raise ValueError("a nonzero activation dropout rate needs two int32 seeds")


def fused_mlp_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    b1: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    seeds: Optional[Sequence[int]] = None,
    rate: float = 0.0,
    row0: int = 0,
) -> torch.Tensor:
    """Reference of the bf16 kernel (any device, differentiable): products
    in fp32 on the storage-dtype operands, h rounded to x's dtype before
    fc2; with ``rate`` the two hash-dropout sites from ``seeds``, rows from
    ``row0``."""
    _check_mlp_rate(seeds, rate)
    return _mlp_math(x, w1, w2, b1, b2, seeds, rate, row0, _fp32_matmul)


def _launch_mlp(x, w1, w2, b1, b2, seeds=None, rate=0.0, row0=0) -> torch.Tensor:
    """One launch of the kernel (checked inputs): bf16, or fp32 with each
    product taken as three bf16 products of the operands' split parts."""
    c = x.shape[-1]
    m, c2 = w1.shape[0], w2.shape[0]
    if w1.shape != (m, c) or w2.shape != (c2, m):
        raise ValueError(f"w1 must be (M, C) and w2 (C2, M) for C={c}: got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w1.dtype != x.dtype \
            or w2.dtype != x.dtype:
        raise ValueError(f"the kernel takes bf16 or fp32 x and weights of x's dtype, got "
                         f"{x.dtype}, {w1.dtype}, {w2.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous x")
    if c % 64 or m % 64 or c2 % 8:
        raise ValueError(f"the kernel needs C and M in multiples of 64 and C2 in multiples of 8, "
                         f"got C={c}, M={m}, C2={c2}")
    dev = x.device
    if w1.device != dev or w2.device != dev:
        raise ValueError("weights must be on x's device")
    w1c, w2c = w1.detach().contiguous(), w2.detach().contiguous()
    if any(v.data_ptr() % 16 for v in (x, w1c, w2c)):
        raise ValueError("the kernel needs x and the weights 16-byte aligned")
    b1v, b2v = _vec(b1, m, 0.0, dev), _vec(b2, c2, 0.0, dev)
    s0, s1 = (int(v) for v in seeds) if rate > 0.0 else (0, 0)
    thresh = keep_threshold(rate) if rate > 0.0 else 0
    n = x.numel() // c
    if x.dtype == torch.float32:
        # bf16 scratch of the fp32 instance: x's and h's [hi | lo | hi] and
        # the weights' [hi | hi | lo] rows (csrc/fused_mlp.cu)
        scratch = [torch.empty(shape, dtype=torch.bfloat16, device=dev)
                   for shape in ((n, 3 * c), (m, 3 * c), (c2, 3 * m), (n, 3 * m))]
        fn = library().a2v_fused_mlp_f32
    else:
        scratch = [torch.empty((n, m), dtype=x.dtype, device=dev)]  # h
        fn = library().a2v_fused_mlp
    out = torch.empty((*x.shape[:-1], c2), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), w1c.data_ptr(), b1v.data_ptr(), w2c.data_ptr(), b2v.data_ptr(),
            *(v.data_ptr() for v in scratch), out.data_ptr(), n, c, m, c2, s0, s1, thresh,
            keep_scale(rate) if thresh else 1.0, int(row0) & 0xFFFFFFFF, stream,
        )
    check(err, "fused MLP kernel")
    fused_mlp.launches += 1
    return out


class _FusedMlp(torch.autograd.Function):
    """The kernel's forward; the backward recomputes ``_mlp_math`` with the
    two products as ``_Fp32SumMatmul`` (bf16 GEMMs with fp32 sums and JAX's
    transpose rule), as JAX's ``_fused_bf16_bwd`` differentiates
    ``_ref_mlp_bf16``, regenerating the dropout masks from their seeds."""

    @staticmethod
    def forward(ctx, x, w1, w2, b1, b2, seeds, rate, row0):
        ctx.save_for_backward(x, w1, w2, b1, b2)
        ctx.conf = (seeds, rate, row0)
        return _launch_mlp(x, w1, w2, b1, b2, seeds, rate, row0)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, needs)]
        with torch.enable_grad():
            out = _mlp_math(*leaves, *ctx.conf, _Fp32SumMatmul.apply)
        wanted = [t for t, need in zip(leaves, needs) if need and t is not None]
        got = iter(torch.autograd.grad(out, wanted, g.reshape(out.shape)))
        return tuple(next(got) if need and t is not None else None
                     for t, need in zip(leaves, needs)) + (None, None, None)


def fused_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    b1: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    seeds: Optional[Sequence[int]] = None,
    rate: float = 0.0,
    row0: int = 0,
) -> torch.Tensor:
    """drop_b(fc2(drop_a(GELU(fc1 x)))) for x (..., C), differentiable in
    every input; the dropout at ``rate`` from two int32 ``seeds``, rows from
    ``row0``. On CUDA one launch of the kernel (``csrc/fused_mlp.cu``, bf16,
    or fp32 with each product as three bf16 products of the split parts)
    when no gradient is wanted, else the autograd Function: the kernel
    forward, and a backward that recomputes in torch GEMMs (fp32 operands:
    fp32 products of the fp32 cotangent, ``_Fp32SumMatmul``). On CPU the
    plain version, with autograd through it."""
    _check_mlp_rate(seeds, rate)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, w2, b1, b2, seeds, rate, row0)
    if x.device.type != "cuda":
        raise ValueError(f"fused MLP runs on cuda or cpu tensors, got {x.device}")
    seeds = None if rate == 0.0 else tuple(int(v) for v in seeds)
    inputs = [t for t in (x, w1, w2, b1, b2) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FusedMlp.apply(x, w1, w2, b1, b2, seeds, float(rate), int(row0))
    return _launch_mlp(x, w1, w2, b1, b2, seeds, float(rate), int(row0))


fused_mlp.launches = 0


def fused_mlp_int8_plain(
    x: torch.Tensor,
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: Optional[torch.Tensor],
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Reference of the int8 kernel (any device), the int8 products exact in
    float64."""
    c = x.shape[-1]
    out = _int8_mlp(x.reshape(-1, c), w1_q, w1_s, b1, w2_q, w2_s, b2, chunk)
    return out.to(x.dtype).reshape(*x.shape[:-1], w2_q.shape[0])


def fused_mlp_int8(
    x: torch.Tensor,
    w1_q: torch.Tensor,
    w1_s: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2_q: torch.Tensor,
    w2_s: torch.Tensor,
    b2: Optional[torch.Tensor],
) -> torch.Tensor:
    """The int8 MLP of x (..., C); kernel on CUDA (``csrc/fused_mlp_int8.cu``,
    bf16 x: four launches, the GEMMs on the int8 wgmma core, which needs C %
    16, M and the hidden chunk in multiples of 128 and C2 % 2, and raises
    otherwise), plain version on CPU."""
    if x.device.type == "cpu":
        return fused_mlp_int8_plain(x, w1_q, w1_s, b1, w2_q, w2_s, b2)
    if x.device.type != "cuda":
        raise ValueError(f"int8 fused MLP runs on cuda or cpu tensors, got {x.device}")
    c = x.shape[-1]
    m, c2 = w1_q.shape[0], w2_q.shape[0]
    require_bf16("the int8 fused MLP (#9)", x.dtype)
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous x")
    for name, w, shape in (("w1_q", w1_q, (m, c)), ("w2_q", w2_q, (c2, m))):
        if w.dtype != torch.int8 or w.shape != shape or not w.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int8 {shape}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    chunk = hidden_chunk(m)
    if c % 16 or m % H_MAX_COLS or chunk % H_MAX_COLS or c2 % 2:
        raise ValueError(f"the kernel needs C % 16, M and the hidden chunk in multiples of "
                         f"{H_MAX_COLS} and C2 % 2 == 0, got C={c}, M={m}, chunk={chunk}, "
                         f"C2={c2}")
    dev = x.device
    if w1_q.device != dev or w2_q.device != dev:
        raise ValueError("weights must be on x's device")
    b1v, b2v = _vec(b1, m, 0.0, dev), _vec(b2, c2, 0.0, dev)
    w1s, w2s = _vec(w1_s, m, 1.0, dev), _vec(w2_s, c2, 1.0, dev)
    n = x.numel() // c
    x_q = torch.empty((n, c), dtype=torch.int8, device=dev)
    x_s = torch.empty((n,), dtype=torch.float32, device=dev)
    h = torch.empty((n, m), dtype=torch.float32, device=dev)
    h_max = torch.empty((n, m // H_MAX_COLS), dtype=torch.float32, device=dev)
    h_q = torch.empty((n, m), dtype=torch.int8, device=dev)
    h_s = torch.empty((n, m // chunk), dtype=torch.float32, device=dev)
    out = torch.empty((*x.shape[:-1], c2), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().a2v_fused_mlp_int8(
            x.data_ptr(), w1_q.data_ptr(), w1s.data_ptr(), b1v.data_ptr(), w2_q.data_ptr(),
            w2s.data_ptr(), b2v.data_ptr(), x_q.data_ptr(), x_s.data_ptr(), h.data_ptr(),
            h_max.data_ptr(), h_q.data_ptr(), h_s.data_ptr(), out.data_ptr(), n, c, m, c2, chunk,
            stream,
        )
    check(err, "int8 fused MLP kernel")
    fused_mlp_int8.launches += 1
    return out


fused_mlp_int8.launches = 0
