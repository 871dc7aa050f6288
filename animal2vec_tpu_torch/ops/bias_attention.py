"""Attention with a dense additive bias: the port of
``animal2vec_tpu/models/attention.xla_attention`` and of the kernel behind
``flash_attention_tpu`` (jax's stock TPU flash attention), which the JAX
package takes for every bias that is not an ``AlibiSpec``: the image
modality's 2-D ALiBi bias, or no bias at all.

    logits = (q . k) * D^-0.5 + bias        fp32
    logits = -1e10 at padded keys           (a replacement, not an addition)
    out = dtype(softmax(logits)) . v

``q``, ``k``, ``v`` are (B, T, H, D); ``bias`` is None or fp32 (1 or B, H,
T, T); ``padding_mask`` is None or (B, T) bool, True = padded key; the
output is (B, T, H, D) in q's dtype. A query row whose keys are all padded
returns the mean of V over the T keys, as ``xla_attention``'s softmax does.

``bias_flash_attention`` is the model's entry, differentiable in q, k, v
and the bias. On a CUDA tensor with no gradient wanted (grad mode off, or
no input requires grad: serving, the EMA teacher) it makes one launch of
the hand-written flash kernel (``csrc/bias_attention.cu``, bf16, or fp32
with each product taken as three bf16 products of the operands' split
parts; head dims 1 to 128, one off a multiple of 8 on zero-padded copies,
as the ALiBi kernels take it: ``ops/attention.kernel_head_dim``). Every
launch takes the C entry of the operands' dtype (``ops.attention._entry``:
the ``_f32`` entries for fp32).
Otherwise it is a ``torch.autograd.Function``: its forward launches the
kernel with the (B*H, T) fp32 logsumexp; its backward computes ``delta =
rowsum(dO * O)`` in fp32 with one torch op and launches, for T <= 64 (the
ViT-B/16 pretraining student's 59 kept patches), the single kernel that
computes dq, dbias, dk and dv (``bias_attention_bwd_single``), else the dq +
dbias kernel (``bias_attention_dq``) and the dk/dv kernel
(``bias_attention_dkv``), all of ``csrc/bias_attention_bwd.cu``, which write
dq, dk and dv into one (B, T, 3, H, D) gradient. The gradient is
``xla_attention``'s: dbias is dS = P * (dP - delta) in fp32, 0 at padded
keys; a batch-uniform (1, H, T, T) bias gets the sum over the batch (the
transpose of the broadcast). Attention dropout (``dropout_rate`` and an
int32 ``seed``) is a hash site in the forward and in every backward
kernel: the keep mask of (seed + (b*H + h) * 0xC2B2AE3D, query, key) that
the ALiBi kernels use (``attention_keep``), regenerated in-register, never
materialized; the plain twin takes it as a (B, H, T, T) tensor (on a CPU
tensor the wrapper builds it from the seed), so that the tests can hand it
JAX's own bernoulli mask. On a CPU tensor the plain version runs and
autograd through it is the backward; any other device raises. The kernels read q, k and v in place with their batch
and time strides (each row's heads packed, the three with the same
strides), so the model passes the q, k, v views of its (B, T, 3, H, D)
projection and makes no packed copy (the ALiBi kernels' ``btc_to_packed``
copy is the largest copy of the a2v-large forward, ``PERF.md`` section 5). A
batch-uniform bias, (1, H, T, T) or expanded with batch stride 0, is read
with batch stride 0 and never expanded in memory. ``bias_attention_bwd_plain``
is the backward kernels' plain version on their inputs (the forward's lse
and delta), with their bf16 roundings.

jax's stock TPU kernel computes ``softmax((q.k + bias) * D^-0.5)``: it
weakens the bias by D^-0.5, where ``xla_attention`` (below 1024 tokens and
on every other backend) and the fairseq reference add it after the scale.
The port follows ``xla_attention`` at every length
(``tests/test_torch_image_ops.py`` and
``tests/test_torch_bias_attention_train.py`` record the difference, forward
and backward).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from animal2vec_tpu_torch.kernels.build import check
from animal2vec_tpu_torch.ops.attention import (
    _check_device, _entry, _on_cpu, kernel_head_dim, pad_head,
)
from animal2vec_tpu_torch.ops.dropout import dropout_keep, keep_scale, keep_threshold

NEG_INF = -1e10  # models/attention.py NEG_INF
DEAD_LSE = -5e9  # an lse below this marks a query row whose keys are all padded
SINGLE_T = 64  # the longest T the single backward launch takes (one 64-row tile)


def attention_keep(b: int, h: int, t: int, rate: float, seed: int, device=None) -> torch.Tensor:
    """The kernels' (B, H, T, T) fp32 0/1 keep mask of ``rate`` and ``seed``:
    the hash of (seed + (b*H + h) * 0xC2B2AE3D, query, key) that the ALiBi
    kernels use too (``ops.dropout.dropout_keep``)."""
    bh = torch.arange(b * h, dtype=torch.int64).reshape(b, h, 1, 1)
    idx = torch.arange(t, dtype=torch.int64)
    return dropout_keep(seed, bh, idx[:, None], idx[None, :], rate).to(device)


def bias_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    return_lse: bool = False,
    keep: Optional[torch.Tensor] = None,
    rate: float = 0.0,
):
    """Materialized-score reference (any device, differentiable):
    ``xla_attention``. With ``return_lse`` returns (out, lse (B*H, T) fp32).
    ``keep`` (B, H, T, T) 0/1 drops the normalized weights at ``rate`` and
    scales the kept ones by 1 / (1 - rate), before their cast, as
    ``xla_attention`` drops them under its bernoulli mask."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * d**-0.5).float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    if padding_mask is not None:
        logits = logits.masked_fill(padding_mask.bool()[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if keep is not None:
        probs = probs * keep.float() * keep_scale(rate)
    probs = probs.to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(-1, logits.shape[2])


def bias_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    keep: Optional[torch.Tensor] = None,
    rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference of the two backward kernels on their inputs (the forward's
    lse and delta = rowsum(dO * O), both (B*H, T) fp32), written out on
    materialized fp32 scores with the kernels' roundings (dS and P cast to
    q's dtype before their products). With the forward's ``keep`` mask and
    ``rate`` (f = keep / (1 - rate)): dP is f times dO V^T, and dv takes P
    f. Returns dq, dk, dv (B, T, H, D) in q's dtype and dbias = dS, fp32
    (B, H, T, T)."""
    b, t, h, d = q.shape
    scale = d**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    lse = lse.reshape(b, h, t, 1)
    dead = lse < DEAD_LSE
    padded = torch.zeros((b, 1, 1, t), dtype=torch.bool, device=q.device)
    if padding_mask is not None:
        padded = padding_mask.bool()[:, None, None, :]
    p = torch.exp(logits - lse).masked_fill(dead | padded, 0.0)
    # a row whose keys are all padded weighs each of them 1/T in the forward
    p_v = torch.where(dead & padded, 1.0 / t, p)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    if keep is not None:
        f = keep.float() * keep_scale(rate)
        p_v, dp = p_v * f, dp * f
    ds = p * (dp - delta.reshape(b, h, t, 1))
    ds_r = ds.to(q.dtype).float()
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds_r, k.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds_r, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_v.to(q.dtype).float(), dout.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), ds


def _kernel_views(q, k, v, *more):
    """(q, k, v and ``more`` (B, T, H, D) tensors as the kernels take them,
    the true D): zero-padded copies along D to ``kernel_head_dim(D)`` when
    D is off a multiple of 8, else the tensors themselves."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, T, H, D) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    d = q.shape[-1]
    dk = kernel_head_dim(d)
    return tuple(pad_head(x, dk) for x in (q, k, v) + more), d


def _check_qkv(q, k, v):
    """Check the kernels' q, k, v; return (b, t, h, d, strides)."""
    b, t, h, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the kernels take bf16 or fp32 q, k, v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides or strides[2:] != (d, 1):
        raise ValueError(f"q, k, v must share strides (stride_b, stride_t, {d}, 1), got "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    if strides[0] % 8 or strides[1] % 8 or any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the kernel reads 16-byte chunks: q, k, v must be 16-byte aligned "
                         "with strides in multiples of 8")
    if k.device != q.device or v.device != q.device:
        raise ValueError("k and v must be on q's device")
    return b, t, h, d, strides


def _bias_arg(bias: Optional[torch.Tensor], b: int, h: int, t: int, dev):
    """(contiguous fp32 bias or None, uniform): a batch-uniform bias as its
    one (1, H, T, T) plane."""
    if bias is None:
        return None, False
    if bias.dim() != 4 or bias.shape[1:] != (h, t, t) or bias.shape[0] not in (1, b):
        raise ValueError(f"bias must be (1 or {b}, {h}, {t}, {t}), got {tuple(bias.shape)}")
    if bias.dtype != torch.float32 or bias.device != dev:
        raise ValueError(f"bias must be fp32 on {dev}, got {bias.dtype} on {bias.device}")
    uniform = bias.shape[0] == 1 or bias.stride(0) == 0
    if uniform:
        bias = bias[:1]
    return bias.detach().contiguous(), uniform


def _mask_arg(padding_mask: Optional[torch.Tensor], b: int, t: int, dev):
    if padding_mask is None:
        return None
    if padding_mask.shape != (b, t) or padding_mask.device != dev:
        raise ValueError(f"padding_mask must be ({b}, {t}) on {dev}, got "
                         f"{tuple(padding_mask.shape)} on {padding_mask.device}")
    return padding_mask.to(torch.bool).contiguous()


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _drop_args(rate: float, seed: Optional[int]):
    """(seed, thresh, keep_scale) of the kernels' dropout; thresh 0 is none."""
    if rate <= 0.0:
        return 0, 0, 1.0
    if seed is None:
        raise ValueError("attention dropout needs an int32 seed")
    return int(seed), keep_threshold(rate), keep_scale(rate)


def _plain_keep(q, rate: float, seed: Optional[int]):
    """The plain version's keep mask of the kernels' hash (None at rate 0)."""
    if rate <= 0.0:
        return None
    b, t, h, _ = q.shape
    return attention_keep(b, h, t, rate, _drop_args(rate, seed)[0], q.device)


def bias_attention_forward(q, k, v, bias=None, padding_mask=None, with_lse=False,
                           rate=0.0, seed=None):
    """The forward kernel's function: out (B, T, H, D) and, with
    ``with_lse``, the (B*H, T) fp32 logsumexp; with ``rate`` > 0 the hash
    dropout of ``seed`` on the weights. On CUDA one launch of the kernel, on
    CPU the plain version under ``attention_keep``'s mask; not
    differentiable (the model's entry is ``bias_flash_attention``)."""
    if _on_cpu(q):
        return bias_attention_plain(q, k, v, bias, padding_mask, with_lse,
                                    _plain_keep(q, rate, seed), rate)
    _check_device(q, "bias attention")
    (q, k, v), d_true = _kernel_views(q, k, v)
    b, t, h, d, strides = _check_qkv(q, k, v)
    dev = q.device
    bias, uniform = _bias_arg(bias, b, h, t, dev)
    padding_mask = _mask_arg(padding_mask, b, t, dev)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=dev) if with_lse else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("a2v_bias_attention", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides[0], strides[1], _ptr(bias),
            int(uniform), _ptr(padding_mask), out.data_ptr(), _ptr(lse), b, h, t, d,
            d_true**-0.5, *_drop_args(rate, seed), stream,
        )
    check(err, "bias attention kernel")
    bias_flash_attention.launches += 1
    if d != d_true:
        out = out[..., :d_true].contiguous()
    return (out, lse) if with_lse else out


def _bwd_args(q, k, v, dout, lse, delta, bias, padding_mask, out):
    """Checked arguments of the backward kernels: (b, t, h, d, strides,
    bias, uniform, mask, the (B, T, 3, H, D) gradient's strides)."""
    b, t, h, d, strides = _check_qkv(q, k, v)
    dev = q.device
    for name, x, shape, dtype in (("dout", dout, (b, t, h, d), q.dtype),
                                  ("lse", lse, (b * h, t), torch.float32),
                                  ("delta", delta, (b * h, t), torch.float32)):
        if x.shape != shape or x.dtype != dtype or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} on q's device, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if out.shape != (b, t, h, d) or out.stride() != (3 * t * h * d, 3 * h * d, d, 1) \
            or out.dtype != q.dtype or out.device != dev:
        raise ValueError("gradient outputs must be planes of one (B, T, 3, H, D) tensor")
    bias, uniform = _bias_arg(bias, b, h, t, dev)
    return b, t, h, d, strides, bias, uniform, _mask_arg(padding_mask, b, t, dev), out.stride()


def _grad_planes(q):
    b, t, h, d = q.shape
    return torch.empty((b, t, 3, h, d), dtype=q.dtype, device=q.device).unbind(2)


def _kernel_grads(grads, d_true, d):
    """The kernel's dq, dk, dv planes for the caller's ``grads`` (planes of a
    (B, T, 3, H, D) gradient): the caller's own at D = ``d``, else planes
    of a padded gradient, whose first ``d_true`` columns ``_copy_back``
    copies into the caller's."""
    if d == d_true:
        return grads
    b, t, h, _ = grads[0].shape
    return torch.empty((b, t, 3, h, d), dtype=grads[0].dtype,
                       device=grads[0].device).unbind(2)[:len(grads)]


def _copy_back(grads, kernel_grads, d_true):
    for g, gk in zip(grads, kernel_grads):
        if g is not gk:
            g.copy_(gk[..., :d_true])


def bias_attention_dq(q, k, v, dout, lse, delta, bias=None, padding_mask=None, dq=None,
                      want_dbias=True, rate=0.0, seed=None):
    """dq (B, T, H, D) and, with ``want_dbias`` and a bias, dbias = dS (B,
    H, T, T) fp32 (else None) of the backward (of the forward's dropout at
    ``rate`` and ``seed``). ``dq`` may be a preallocated plane of a (B, T,
    3, H, D) gradient. Kernel on CUDA, ``bias_attention_bwd_plain`` on
    CPU."""
    if _on_cpu(q):
        dq_p, _, _, ds = bias_attention_bwd_plain(q, k, v, dout, lse, delta, bias, padding_mask,
                                                  _plain_keep(q, rate, seed), rate)
        return dq_p, (ds if want_dbias and bias is not None else None)
    _check_device(q, "bias attention dq")
    dq = _grad_planes(q)[0] if dq is None else dq
    (q, k, v, dout), d_true = _kernel_views(q, k, v, dout)
    (dq_k,) = _kernel_grads((dq,), d_true, q.shape[-1])
    b, t, h, d, strides, bias_c, uniform, mask, out_strides = _bwd_args(
        q, k, v, dout, lse, delta, bias, padding_mask, dq_k)
    dbias = None
    if want_dbias and bias is not None:
        dbias = torch.empty((b, h, t, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("a2v_bias_attention_bwd_dq", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides[0], strides[1], dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(bias_c), int(uniform), _ptr(mask),
            dq_k.data_ptr(), out_strides[0], out_strides[1], _ptr(dbias), b, h, t, d,
            d_true**-0.5, *_drop_args(rate, seed), stream,
        )
    check(err, "bias attention dq kernel")
    _copy_back((dq,), (dq_k,), d_true)
    bias_attention_dq.launches += 1
    return dq, dbias


bias_attention_dq.launches = 0


def bias_attention_dkv(q, k, v, dout, lse, delta, bias=None, padding_mask=None, dk=None,
                       dv=None, rate=0.0, seed=None):
    """dk and dv (B, T, H, D) of the backward (of the forward's dropout at
    ``rate`` and ``seed``); ``dk`` and ``dv`` may be preallocated planes of
    a (B, T, 3, H, D) gradient. Kernel on CUDA, ``bias_attention_bwd_plain``
    on CPU."""
    if _on_cpu(q):
        _, dk_p, dv_p, _ = bias_attention_bwd_plain(q, k, v, dout, lse, delta, bias, padding_mask,
                                                    _plain_keep(q, rate, seed), rate)
        return dk_p, dv_p
    _check_device(q, "bias attention dk/dv")
    if dk is None or dv is None:
        _, dk, dv = _grad_planes(q)
    if dv.stride() != dk.stride() or dv.shape != dk.shape:
        raise ValueError("dk and dv must be planes of one (B, T, 3, H, D) tensor")
    (q, k, v, dout), d_true = _kernel_views(q, k, v, dout)
    dk_k, dv_k = _kernel_grads((dk, dv), d_true, q.shape[-1])
    b, t, h, d, strides, bias_c, uniform, mask, out_strides = _bwd_args(
        q, k, v, dout, lse, delta, bias, padding_mask, dk_k)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("a2v_bias_attention_bwd_dkv", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides[0], strides[1], dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(bias_c), int(uniform), _ptr(mask),
            dk_k.data_ptr(), dv_k.data_ptr(), out_strides[0], out_strides[1], b, h, t, d,
            d_true**-0.5, *_drop_args(rate, seed), stream,
        )
    check(err, "bias attention dk/dv kernel")
    _copy_back((dk, dv), (dk_k, dv_k), d_true)
    bias_attention_dkv.launches += 1
    return dk, dv


bias_attention_dkv.launches = 0


def bias_attention_bwd_single(q, k, v, dout, lse, delta, bias=None, padding_mask=None, dq=None,
                              dk=None, dv=None, want_dbias=True, rate=0.0, seed=None):
    """dq, dk, dv (B, T, H, D) and, with ``want_dbias`` and a bias, dbias =
    dS (B, H, T, T) fp32 (else None) of the backward in one launch, for T <=
    ``SINGLE_T``; ``dq``, ``dk``, ``dv`` may be preallocated planes of a (B,
    T, 3, H, D) gradient; ``rate`` and ``seed`` the forward's dropout.
    Kernel on CUDA, ``bias_attention_bwd_plain`` on CPU."""
    if _on_cpu(q):
        dq_p, dk_p, dv_p, ds = bias_attention_bwd_plain(q, k, v, dout, lse, delta, bias,
                                                        padding_mask, _plain_keep(q, rate, seed),
                                                        rate)
        return dq_p, dk_p, dv_p, (ds if want_dbias and bias is not None else None)
    _check_device(q, "bias attention backward")
    if dq is None or dk is None or dv is None:
        dq, dk, dv = _grad_planes(q)
    if any(x.stride() != dq.stride() or x.shape != dq.shape for x in (dk, dv)):
        raise ValueError("dq, dk and dv must be planes of one (B, T, 3, H, D) tensor")
    (q, k, v, dout), d_true = _kernel_views(q, k, v, dout)
    grads = (dq, dk, dv)
    dq_k, dk_k, dv_k = _kernel_grads(grads, d_true, q.shape[-1])
    b, t, h, d, strides, bias_c, uniform, mask, out_strides = _bwd_args(
        q, k, v, dout, lse, delta, bias, padding_mask, dq_k)
    if t > SINGLE_T:
        raise ValueError(f"the single backward launch takes T <= {SINGLE_T}, got {t}")
    dbias = None
    if want_dbias and bias is not None:
        dbias = torch.empty((b, h, t, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("a2v_bias_attention_bwd_single", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides[0], strides[1], dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(bias_c), int(uniform), _ptr(mask),
            dq_k.data_ptr(), dk_k.data_ptr(), dv_k.data_ptr(), out_strides[0], out_strides[1],
            _ptr(dbias), b, h, t, d, d_true**-0.5, *_drop_args(rate, seed), stream,
        )
    check(err, "bias attention single backward kernel")
    _copy_back(grads, (dq_k, dk_k, dv_k), d_true)
    bias_attention_bwd_single.launches += 1
    return dq, dk, dv, dbias


bias_attention_bwd_single.launches = 0


class _BiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, padding_mask, rate, seed):
        out, lse = bias_attention_forward(q, k, v, bias, padding_mask, True, rate, seed)
        ctx.save_for_backward(q, k, v, bias, padding_mask, out, lse)
        ctx.drop = dict(rate=rate, seed=seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, padding_mask, out, lse = ctx.saved_tensors
        b, t, h, _ = q.shape
        dout = g.to(q.dtype).contiguous()
        # contiguous at every batch size (at B 1 the reshape is a strided view)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
        delta = delta.contiguous()
        dq, dk, dv = _grad_planes(q)
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        args = (q, k, v, dout, lse, delta, bias, padding_mask)
        if t <= SINGLE_T:
            dbias = bias_attention_bwd_single(*args, dq=dq, dk=dk, dv=dv,
                                              want_dbias=want_dbias, **ctx.drop)[3]
        else:
            _, dbias = bias_attention_dq(*args, dq=dq, want_dbias=want_dbias, **ctx.drop)
            bias_attention_dkv(*args, dk=dk, dv=dv, **ctx.drop)
        if dbias is not None and bias.shape[0] == 1 and b > 1:
            dbias = dbias.sum(0, keepdim=True)  # the transpose of the broadcast
        return dq, dk, dv, dbias, None, None, None


def bias_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """Dense-bias attention of (B, T, H, D) q, k, v -> (B, T, H, D),
    differentiable in q, k, v and the bias, with the hash dropout of the
    int32 ``seed`` at ``dropout_rate`` on the weights: on CUDA one forward
    launch when no gradient is wanted, else the autograd Function (forward
    with lse, the backward kernels); autograd through the plain version
    under ``attention_keep``'s mask on CPU."""
    if _on_cpu(q):
        return bias_attention_plain(q, k, v, bias, padding_mask, False,
                                    _plain_keep(q, dropout_rate, seed), dropout_rate)
    _check_device(q, "bias attention")
    inputs = (q, k, v) + (() if bias is None else (bias,))
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _BiasAttention.apply(q, k, v, bias, padding_mask, dropout_rate, seed)
    return bias_attention_forward(q, k, v, bias, padding_mask, False, dropout_rate, seed)


bias_flash_attention.launches = 0
