"""ALiBi flash attention over packed qkv: the port of
``animal2vec_tpu/ops/pallas_attention.alibi_flash_attention_packed`` (the
forward) and ``alibi_flash_attention_btc`` (the training entry, with the
backward kernels).

``alibi_flash_attention_packed`` keeps the JAX layout: ``qkv`` (3, B, H, T,
D), ``positions`` (1, T) when batch-uniform or (B, T), ``padding_mask``
(B, T) bool (True = padded key) or None, output (B, H, T, D), and with
``return_lse`` the (B*H, T) fp32 logsumexp the backward reads. On a CUDA
tensor it launches the forward kernel (``csrc/alibi_attention_fwd.cu``)
on the packed planes as (B, T, H, D) views: a launch with an lse or a
dropout rate runs its training instances (counted by
``alibi_flash_attention_packed.launches``), a serving launch (neither) goes
through ``alibi_flash_attention_serve``; on a CPU tensor it runs
``alibi_attention_plain``, a transcription of the JAX
``_reference_attention``; any other device raises.

``alibi_flash_attention_serve`` is the serving entry of the same kernel
(no lse, no dropout): (B, T, H, D) views of q, k and v with one set of
strides, read in place, into a new contiguous (B, T, H, D) tensor. The
projection's (B, T, 3, H, D) thirds and the packed layout's planes
(transposed to (B, T, H, D)) are both such views. It is the torch custom op
``a2v::alibi_attention_serve`` (the kernel for CUDA tensors, the plain
version for CPU tensors, a fake for tracing), so ``torch.export`` keeps it
as one node; the int8 serving attention is two such ops,
``a2v::quantize_qkv_int8`` and ``a2v::alibi_attention_int8``
(``kernels/ops.py`` lists every serving op).

``alibi_flash_attention_btc`` is the model's entry, for serving and
training: (B, T, 3C) in, (B, T, C) out, differentiable in ``qkv_btc`` and
``slopes``. With no gradient wanted (grad mode off, or neither input
requires grad) and no dropout it hands the q, k, v thirds of ``qkv_btc``
to ``alibi_flash_attention_serve`` and returns its (B, T, H, D) output
viewed as (B, T, C): no copy either way (on CPU tensors the plain version
runs on the same views). With dropout and no gradient it makes one
training-kernel launch on a packed copy. With a gradient wanted on CUDA it
is a ``torch.autograd.Function`` whose forward copies qkv into the packed
layout, launches the training kernel with the lse output and saves the
packed qkv, the output and the lse (the packed copy takes the place of the
JAX entry's (B, T, 3C) residual: the same bytes, and the backward needs no
second layout copy); its backward computes ``delta = rowsum(dO * O)`` in
fp32 with one torch op and launches the dq kernel (``attention_dq``, with
one slope partial per (b, h, 64-query tile), summed here) and the dk/dv
kernel (``attention_dkv``) of ``csrc/alibi_attention_bwd.cu``. On CPU
tensors autograd through ``alibi_attention_plain`` is the backward.

Dtypes: the kernels take bf16, or fp32 (JAX's default compute dtype) through
their ``_f32`` C entries, whose every fp32 product is three bf16 products
of the operands' hi and lo parts (``csrc/sm90.cuh``); out, dq, dk and dv
come in the inputs' dtype. #5 and its quantization pass take bf16 only and
raise on fp32, naming ROADMAP A.13.

Head dims: the kernels take any head dim D from 1 to ``MAX_HEAD_DIM`` (128):
D 64 as one 64-column tile, every other D as two, zero past D. They read a
head's row in 16-byte chunks, so a D that is not a multiple of 8 is
zero-padded to one (``kernel_head_dim``) in a copy made here, with the
scale D^-0.5 of the true D and only the true D columns of each output kept;
zero columns add nothing to q.k and give zero output columns. D > 128
raises on a CUDA tensor (ROADMAP A.11 queues it); the plain versions take
any D.

Semantics (all versions): scores ``q.k / sqrt(D) - slope_h * |pos_i -
pos_j|`` in fp32, zero bias where either position is < 0 when
``has_sentinel``, padded keys replaced by a finite -1e9 (a row whose keys are
all padded returns the mean of V over the T keys; the TPU kernel also
averages its zero pad keys there), fp32 softmax. Attention dropout scales
the normalized weights by ``keep / (1 - rate)`` with the hash mask of
``ops.dropout.dropout_keep`` over (seed, b*H + h, query, key), after the
undropped denominator. Gradients follow the math: the -1e9 fill of a padded
key is a constant, so no gradient reaches q, k or the slopes through it.
The TPU backward kernels agree on every row that has a live key; in a row
whose keys are all padded they take exp(-1e9 - lse) = 1 (lse rounds to
-1e9) and pass gradient through the fill (see the kernel's note).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from animal2vec_tpu_torch.kernels.build import check, library, require_bf16
from animal2vec_tpu_torch.ops.dropout import dropout_keep, keep_scale, keep_threshold
from animal2vec_tpu_torch.ops.int8_mm import INV_127, quantize_rows

NEG_INF = -1e9
# the storage dtypes of #1-#4's instances (each product of an fp32 launch is
# three bf16 products of the operands' split parts, csrc/sm90.cuh)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
DEAD_LSE = -5e8  # an lse below this marks a query row whose keys are all padded
Q_TILE = 64  # query rows per block of the dq kernel: one slope partial each
MAX_HEAD_DIM = 128  # the attention kernels' widest head


def kernel_head_dim(d: int) -> int:
    """The head dim an attention kernel launch takes for heads of ``d``:
    ``d`` rounded up to a multiple of 8 (the wrappers zero-pad to it).
    Raises past ``MAX_HEAD_DIM``."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take head dims 1 to {MAX_HEAD_DIM}, got {d} "
                         "(wider heads are ROADMAP A.11's)")
    return -(-d // 8) * 8


def pad_head(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` (..., D) zero-padded to (..., d): a new contiguous tensor, or
    ``x`` itself when D is ``d``."""
    return x if x.shape[-1] == d else F.pad(x, (0, d - x.shape[-1]))


def int8_row_len(d: int) -> int:
    """Bytes of a q8 / k8 row (and v8^T rows) of the int8 attention's
    layouts for heads of ``d``, zero past ``d``: the kernel's one tile of
    64 where ``kernel_head_dim(d)`` is 64, else its two tiles of 64 (128;
    past 128, on the CPU only, the next multiple of 64)."""
    return 64 if -(-d // 8) * 8 == 64 else max(128, -(-d // 64) * 64)


def _scores(qkv, slopes, positions, padding_mask, has_sentinel, positions_k=None):
    """fp32 scores (B, H, T, T) and the ALiBi distances (1 or B, T, T); the
    keys' positions are ``positions_k`` where given."""
    q, k, _ = qkv.unbind(0)  # (B, H, T, D) each
    d = q.shape[-1]
    logits = torch.matmul(q.float() * d**-0.5, k.float().transpose(-1, -2))
    pos = positions.float()  # (1 or B, T)
    posk = pos if positions_k is None else positions_k.float()
    dist = (pos[:, :, None] - posk[:, None, :]).abs()
    if has_sentinel:
        dist = dist.masked_fill((pos[:, :, None] < 0) | (posk[:, None, :] < 0), 0.0)
    logits = logits + (-dist)[:, None] * slopes.float()[None, :, None, None]
    if padding_mask is not None:
        logits = logits.masked_fill(padding_mask.bool()[:, None, None, :], NEG_INF)
    return logits, dist


def hash_heads_of(h: int, h0: int = 0, hash_heads: Optional[int] = None) -> Tuple[int, int]:
    """(h0, hash_heads) of a launch over ``h`` heads: a tensor-parallel
    rank's first head and the unsharded head count (0 and ``h`` unsharded);
    the dropout hash indexes head ``h`` of batch row ``b`` as
    ``b * hash_heads + h0 + h``."""
    hash_heads = h if hash_heads is None else int(hash_heads)
    if h0 < 0 or hash_heads < h0 + h:
        raise ValueError(f"heads {h0}..{h0 + h} do not lie in the {hash_heads} heads hashed")
    return int(h0), hash_heads


def _keep_factor(b, h, t, rate, seed, device, h0=0, hash_heads=None):
    """(B, H, T, T) fp32 dropout factor keep / (1 - rate); the heads are
    ``h0`` .. ``h0 + h`` of ``hash_heads`` (``hash_heads_of``)."""
    h0, hh = hash_heads_of(h, h0, hash_heads)
    bh = (torch.arange(b, device=device)[:, None] * hh + h0
          + torch.arange(h, device=device)[None, :])[:, :, None, None]
    rows = torch.arange(t, device=device)[None, None, :, None]
    cols = torch.arange(t, device=device)[None, None, None, :]
    return dropout_keep(int(seed), bh, rows, cols, rate) / (1.0 - rate)


def alibi_attention_plain(
    qkv: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = False,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    return_lse: bool = False,
    positions_k: Optional[torch.Tensor] = None,
    h0: int = 0,
    hash_heads: Optional[int] = None,
):
    """Materialized-score reference of the forward kernel (any device);
    differentiable. With ``return_lse`` returns (out, lse (B*H, T) fp32);
    ``positions_k`` (1 or B, T) are the keys' positions (default
    ``positions``); the dropout hashes the heads as heads ``h0`` .. of
    ``hash_heads`` (``hash_heads_of``)."""
    logits, _ = _scores(qkv, slopes, positions, padding_mask, has_sentinel, positions_k)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        b, h, t, _ = probs.shape
        probs = probs * _keep_factor(b, h, t, dropout_rate, seed, probs.device, h0, hash_heads)
    out = torch.matmul(probs.to(qkv.dtype), qkv[2])
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(-1, logits.shape[2])


def attention_bwd_plain(
    qkv: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = False,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    h0: int = 0,
    hash_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference of the two backward kernels on their inputs (the forward's
    lse, delta = rowsum(dO * O), both (B*H, T) fp32), written out on
    materialized fp32 scores with the kernels' roundings (P * f and dS cast
    to qkv's dtype before their products). Returns dqkv (3, B, H, T, D) in
    qkv's dtype and the slope partials (B, H, ceil(T / 64)) fp32, one per
    query tile of the dq kernel; the partials use the row's delta summed
    from P and dP, not ``delta`` (see ``csrc/alibi_attention_bwd.cu``)."""
    b, h, t, d = qkv.shape[1:]
    logits, dist = _scores(qkv, slopes, positions, padding_mask, has_sentinel)
    lse = lse.reshape(b, h, t, 1)
    # a row whose keys are all padded (lse rounds to -1e9) weighs them 1/T
    p = torch.where(lse < DEAD_LSE, 1.0 / t, torch.exp(logits - lse))
    f = (_keep_factor(b, h, t, dropout_rate, seed, p.device, h0, hash_heads)
         if dropout_rate > 0.0 else torch.ones((), device=p.device))
    q, k, v = (x.float() for x in qkv.unbind(0))
    do = dout.float()
    dpf = torch.matmul(do, v.transpose(-1, -2)) * f
    ds = p * (dpf - delta.reshape(b, h, t, 1))
    p_live = p
    if padding_mask is not None:
        padded = padding_mask.bool()[:, None, None, :]
        ds = ds.masked_fill(padded, 0.0)
        p_live = p.masked_fill(padded, 0.0)
    ds_r = ds.to(qkv.dtype).float()
    scale = d**-0.5
    dq = scale * torch.matmul(ds_r, k)
    dk = scale * torch.matmul(ds_r.transpose(-1, -2), q)
    dv = torch.matmul((p * f).to(qkv.dtype).float().transpose(-1, -2), do)
    n_qt = -(-t // Q_TILE)
    # the slope gradient -sum_j dS dist with the row's delta recomputed as
    # sum_j P f dP, as the dq kernel sums it
    pdp = p_live * dpf
    dist = dist[:, None]
    per_row = -((pdp * dist).sum(-1) - pdp.sum(-1) * (p_live * dist).sum(-1))  # (B, H, T)
    per_row = torch.nn.functional.pad(per_row, (0, n_qt * Q_TILE - t))
    parts = per_row.reshape(b, h, n_qt, Q_TILE).sum(-1)
    return torch.stack([dq, dk, dv]).to(qkv.dtype), parts


def _kernel_args(qkv, slopes, positions, padding_mask):
    """Check the kernels' inputs; return (b, h, t, d, slopes fp32, positions
    int32, pos_per_row, mask uint8 or None, mask_per_row)."""
    if qkv.dim() != 5 or qkv.shape[0] != 3:
        raise ValueError(f"qkv must be (3, B, H, T, D), got {tuple(qkv.shape)}")
    _, b, h, t, d = qkv.shape
    if qkv.dtype not in KERNEL_DTYPES or not qkv.is_contiguous():
        raise ValueError(f"the kernels take contiguous bf16 or fp32 qkv, got {qkv.dtype}")
    kernel_head_dim(d)
    return (b, h, t, d) + _side_args(b, h, t, qkv.device, slopes, positions, padding_mask)


def _side_args(b, h, t, device, slopes, positions, padding_mask):
    """Check slopes, positions and the padding mask of a launch; return
    (slopes fp32, positions int32, pos_per_row, mask uint8 or None,
    mask_per_row)."""
    if positions.dim() != 2 or positions.shape[1] != t or positions.shape[0] not in (1, b):
        raise ValueError(f"positions must be (1, T) or (B, T), got {tuple(positions.shape)}")
    if slopes.shape != (h,):
        raise ValueError(f"slopes must be ({h},), got {tuple(slopes.shape)}")
    tensors = [slopes, positions] + ([] if padding_mask is None else [padding_mask])
    if any(x.device != device for x in tensors):
        raise ValueError("slopes, positions and padding_mask must be on qkv's device")
    slopes = slopes.detach().to(torch.float32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    mask_per_row = 0
    if padding_mask is not None:
        if padding_mask.shape not in ((b, t), (1, t)):
            raise ValueError(
                f"padding_mask must be (B, T) or (1, T), got {tuple(padding_mask.shape)}"
            )
        padding_mask = padding_mask.to(torch.bool).contiguous()
        mask_per_row = int(padding_mask.shape[0] == b and b > 1)
    pos_per_row = int(positions.shape[0] == b and b > 1)
    return slopes, positions, pos_per_row, padding_mask, mask_per_row


def _dropout_args(dropout_rate: float, seed):
    """(seed, uint32 threshold, keep scale) of a launch."""
    if dropout_rate == 0.0:
        return 0, 0, 1.0
    if seed is None:
        raise ValueError("a nonzero dropout_rate needs an int32 seed")
    return int(seed), keep_threshold(dropout_rate), keep_scale(dropout_rate)


def _entry(name: str, dtype: torch.dtype):
    """The C entry ``name`` for operands of ``dtype``: the bf16 instances,
    or for fp32 the fp32 ones (``name`` + "_f32")."""
    return getattr(library(), name + ("_f32" if dtype == torch.float32 else ""))


def _check_device(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {x.device}")


def _on_cpu(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain version: it lies on the CPU. Any other
    device launches the kernel (``_check_device`` raises off CUDA)."""
    return x.device.type == "cpu"


def _aligned(x: torch.Tensor) -> bool:
    """A (..., D) view the forward kernel reads or writes: 16-byte aligned
    rows of contiguous elements, every stride a multiple of 8."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in x.stride()[:-1]))


def _positions_k(positions_k, b, t, device):
    """The kernel's key positions: None (the positions) or (int32 (1 or B,
    T) contiguous, per_row)."""
    if positions_k is None:
        return None
    if positions_k.dim() != 2 or positions_k.shape[1] != t or positions_k.shape[0] not in (1, b):
        raise ValueError(f"positions_k must be (1, T) or (B, T), got {tuple(positions_k.shape)}")
    if positions_k.device != device:
        raise ValueError("positions_k must be on qkv's device")
    return positions_k.to(torch.int32).contiguous(), int(positions_k.shape[0] == b and b > 1)


def _launch_forward(q, k, v, out, lse, side, has_sentinel, drop, posk=None,
                    heads: Tuple[int, int] = (0, 0)) -> None:
    """One launch of the forward kernel on checked (B, T, H, D) views q, k,
    v (one stride set) and out; ``side`` are ``_side_args``' slopes,
    positions and mask, ``drop`` ``_dropout_args``', ``lse`` None or a
    contiguous (B*H, T) fp32 output, ``posk`` ``_positions_k``'s,
    ``heads`` (h0, hash_heads) of the dropout hash (hash_heads 0: H). A
    head dim off a multiple of 8 runs on zero-padded copies."""
    b, t, h, d = q.shape
    dk = kernel_head_dim(d)
    target = out
    if dk != d:
        q, k, v = (pad_head(x, dk) for x in (q, k, v))
        out = out.new_empty(q.shape)
    if not all(_aligned(x) for x in (q, k, v, out)):
        raise ValueError("the kernel needs 16-byte aligned q, k, v and out with a contiguous "
                         "last dim and strides in multiples of 8")
    sl, pos, pos_per_row, mask, mask_per_row = side
    seed_i, thresh, scale = drop
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("a2v_alibi_attention_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            sl.data_ptr(), pos.data_ptr(), pos_per_row, None if posk is None else
            posk[0].data_ptr(), 0 if posk is None else posk[1],
            None if mask is None else mask.data_ptr(), mask_per_row, out.data_ptr(),
            out.stride(0), out.stride(1), out.stride(2), None if lse is None else lse.data_ptr(),
            b, h, t, dk, int(has_sentinel), d**-0.5, seed_i, thresh, scale, heads[0],
            heads[1] or h, stream,
        )
    check(err, "alibi attention forward kernel")
    if out is not target:
        target.copy_(out[..., :d])


def _check_qkv_views(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, T, H, D) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _check_card_views(q, k, v) -> None:
    """The CUDA entries' checks of (B, T, H, D) views q, k, v read in place
    (bf16 or fp32)."""
    _check_device(q, "alibi attention")
    kernel_head_dim(q.shape[-1])
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes bf16 or fp32 q, k, v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("k and v must be on q's device")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError(f"q, k, v must share their strides, got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")


@torch.library.custom_op("a2v::alibi_attention_serve", mutates_args=(), device_types="cuda")
def _serve_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, slopes: torch.Tensor,
              positions: torch.Tensor, padding_mask: Optional[torch.Tensor],
              has_sentinel: bool) -> torch.Tensor:
    """#1 on the card: one launch of the forward kernel without lse or
    dropout, q, k, v read in place, into a new (B, T, H, D) tensor."""
    _check_card_views(q, k, v)
    b, t, h, _ = q.shape
    side = _side_args(b, h, t, q.device, slopes, positions, padding_mask)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_forward(q, k, v, out, None, side, has_sentinel, _dropout_args(0.0, None))
    alibi_flash_attention_serve.launches += 1
    return out


@_serve_op.register_kernel("cpu")
def _serve_plain(q, k, v, slopes, positions, padding_mask, has_sentinel):
    packed = torch.stack([q, k, v]).transpose(2, 3)  # (3, B, H, T, D)
    out = alibi_attention_plain(packed, slopes, positions, padding_mask, has_sentinel)
    return out.transpose(1, 2).contiguous()


@_serve_op.register_fake
def _serve_fake(q, k, v, slopes, positions, padding_mask, has_sentinel):
    return q.new_empty(q.shape)


def alibi_flash_attention_serve(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = False,
) -> torch.Tensor:
    """ALiBi attention forward without lse or dropout of (B, T, H, D) views
    ``q``, ``k``, ``v`` that share one set of strides: a new contiguous (B,
    T, H, D) tensor. The custom op ``a2v::alibi_attention_serve``: the
    kernel on CUDA (``csrc/alibi_attention_fwd.cu``, q, k, v read in place),
    ``alibi_attention_plain`` on CPU."""
    _check_qkv_views(q, k, v)
    if q.device.type != "cpu":
        _check_device(q, "alibi attention")
    return _serve_op(q, k, v, slopes, positions, padding_mask, bool(has_sentinel))


alibi_flash_attention_serve.launches = 0


def alibi_flash_attention_packed(
    qkv: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = False,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    return_lse: bool = False,
    positions_k: Optional[torch.Tensor] = None,
    h0: int = 0,
    hash_heads: Optional[int] = None,
):
    """ALiBi attention forward; kernel on CUDA, plain version on CPU. With
    ``return_lse`` returns (out, lse); ``positions_k`` are the keys' own
    positions (default ``positions``); ``h0`` and ``hash_heads`` place the
    heads in the dropout hash (``hash_heads_of``). Serving calls (no lse, no
    dropout, no key positions) go to ``alibi_flash_attention_serve`` on the
    packed planes and return its output as a (B, H, T, D) view."""
    if _on_cpu(qkv):
        return alibi_attention_plain(qkv, slopes, positions, padding_mask, has_sentinel,
                                     dropout_rate, seed, return_lse, positions_k, h0,
                                     hash_heads)
    _check_device(qkv, "alibi attention")
    b, h, t, d, *side = _kernel_args(qkv, slopes, positions, padding_mask)
    heads = hash_heads_of(h, h0, hash_heads)
    drop = _dropout_args(dropout_rate, seed)
    posk = _positions_k(positions_k, b, t, qkv.device)
    planes = [x.transpose(1, 2) for x in qkv.unbind(0)]  # (B, T, H, D) views
    if not return_lse and drop[1] == 0 and posk is None:
        return alibi_flash_attention_serve(*planes, slopes, positions, padding_mask,
                                           has_sentinel).transpose(1, 2)
    out = torch.empty((b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=qkv.device) if return_lse else None
    _launch_forward(*planes, out.transpose(1, 2), lse, side, has_sentinel, drop, posk, heads)
    alibi_flash_attention_packed.launches += 1
    return (out, lse) if return_lse else out


alibi_flash_attention_packed.launches = 0


def alibi_flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = False,
    positions_k: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """#2's forward with its lse on (B, T, H, D) views ``q``, ``k``, ``v``
    of one stride set, each from its own tensor (ring attention's shards,
    ``ops/ring_attention.py``): (out (B, T, H, D), lse (B*H, T) fp32).
    ``positions`` are the queries', ``positions_k`` the keys' (default
    ``positions``) and ``padding_mask`` (True = padded) the keys'. One
    launch of the training kernel on CUDA, counted by ``.launches``; the
    plain version on CPU."""
    _check_qkv_views(q, k, v)
    if _on_cpu(q):
        out, lse = alibi_attention_plain(torch.stack([q, k, v]).transpose(2, 3), slopes,
                                         positions, padding_mask, has_sentinel,
                                         return_lse=True, positions_k=positions_k)
        return out.transpose(1, 2), lse
    _check_card_views(q, k, v)
    b, t, h, _ = q.shape
    side = _side_args(b, h, t, q.device, slopes, positions, padding_mask)
    posk = _positions_k(positions_k, b, t, q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _launch_forward(q, k, v, out, lse, side, has_sentinel, _dropout_args(0.0, None), posk)
    alibi_flash_attention_lse.launches += 1
    return out, lse


alibi_flash_attention_lse.launches = 0


def _bwd_common(qkv, dout, lse, delta, slopes, positions, padding_mask, dropout_rate, seed,
                h0, hash_heads):
    """Checked arguments of the backward kernels: (b, h, t, d, slopes,
    positions, pos_per_row, mask, mask_per_row), (seed, thresh, keep
    scale, h0, hash_heads)."""
    args = _kernel_args(qkv, slopes, positions, padding_mask)
    b, h, t, d = args[:4]
    heads = hash_heads_of(h, h0, hash_heads)
    for name, x, shape, dtype in (("dout", dout, (b, h, t, d), qkv.dtype),
                                  ("lse", lse, (b * h, t), torch.float32),
                                  ("delta", delta, (b * h, t), torch.float32)):
        if x.shape != shape or x.dtype != dtype or not x.is_contiguous() \
                or x.device != qkv.device:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} on qkv's device, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return args, _dropout_args(dropout_rate, seed) + heads


def attention_dq(qkv, dout, lse, delta, slopes, positions, padding_mask=None,
                 has_sentinel=False, dropout_rate=0.0, seed=None, dq=None, h0=0,
                 hash_heads=None):
    """dq (B, H, T, D) and the slope partials (B, H, ceil(T / 64)) of the
    flash backward. ``dq`` may be a preallocated contiguous output (a plane
    of the (3, B, H, T, D) gradient); ``h0`` and ``hash_heads`` as the
    forward's. Kernel on CUDA, ``attention_bwd_plain`` on CPU."""
    if _on_cpu(qkv):
        dqkv, parts = attention_bwd_plain(qkv, dout, lse, delta, slopes, positions,
                                          padding_mask, has_sentinel, dropout_rate, seed, h0,
                                          hash_heads)
        return dqkv[0], parts
    _check_device(qkv, "alibi attention dq")
    (b, h, t, d, sl, pos, pos_per_row, mask, mask_per_row), (seed_i, thresh, scale, h0, hh) = \
        _bwd_common(qkv, dout, lse, delta, slopes, positions, padding_mask, dropout_rate, seed,
                    h0, hash_heads)
    if dq is None:
        dq = torch.empty((b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    dk = kernel_head_dim(d)  # a head dim off a multiple of 8 on zero-padded copies
    qkv_k, dout_k = pad_head(qkv, dk), pad_head(dout, dk)
    dq_k = dq if dk == d else dq.new_empty((b, h, t, dk))
    parts = torch.empty((b, h, -(-t // Q_TILE)), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("a2v_alibi_attention_bwd_dq", qkv.dtype)(
            qkv_k.data_ptr(), dout_k.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            sl.data_ptr(), pos.data_ptr(), pos_per_row, None if mask is None else mask.data_ptr(),
            mask_per_row, dq_k.data_ptr(), parts.data_ptr(), b, h, t, dk, int(has_sentinel),
            d**-0.5, seed_i, thresh, scale, h0, hh, stream,
        )
    check(err, "alibi attention dq kernel")
    if dq_k is not dq:
        dq.copy_(dq_k[..., :d])
    attention_dq.launches += 1
    return dq, parts


attention_dq.launches = 0


def attention_dkv(qkv, dout, lse, delta, slopes, positions, padding_mask=None,
                  has_sentinel=False, dropout_rate=0.0, seed=None, dk=None, dv=None, h0=0,
                  hash_heads=None):
    """dk and dv (B, H, T, D) of the flash backward; optional preallocated
    contiguous outputs; ``h0`` and ``hash_heads`` as the forward's. Kernel
    on CUDA, ``attention_bwd_plain`` on CPU."""
    if _on_cpu(qkv):
        dqkv, _ = attention_bwd_plain(qkv, dout, lse, delta, slopes, positions, padding_mask,
                                      has_sentinel, dropout_rate, seed, h0, hash_heads)
        return dqkv[1], dqkv[2]
    _check_device(qkv, "alibi attention dk/dv")
    (b, h, t, d, sl, pos, pos_per_row, mask, mask_per_row), (seed_i, thresh, scale, h0, hh) = \
        _bwd_common(qkv, dout, lse, delta, slopes, positions, padding_mask, dropout_rate, seed,
                    h0, hash_heads)
    if dk is None:
        dk = torch.empty((b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    if dv is None:
        dv = torch.empty((b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    d_k = kernel_head_dim(d)  # a head dim off a multiple of 8 on zero-padded copies
    qkv_k, dout_k = pad_head(qkv, d_k), pad_head(dout, d_k)
    dk_k, dv_k = (dk, dv) if d_k == d else (dk.new_empty((b, h, t, d_k)),
                                           dv.new_empty((b, h, t, d_k)))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("a2v_alibi_attention_bwd_dkv", qkv.dtype)(
            qkv_k.data_ptr(), dout_k.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            sl.data_ptr(), pos.data_ptr(), pos_per_row, None if mask is None else mask.data_ptr(),
            mask_per_row, dk_k.data_ptr(), dv_k.data_ptr(), b, h, t, d_k, int(has_sentinel),
            d**-0.5, seed_i, thresh, scale, h0, hh, stream,
        )
    check(err, "alibi attention dk/dv kernel")
    if dk_k is not dk:
        dk.copy_(dk_k[..., :d])
        dv.copy_(dv_k[..., :d])
    attention_dkv.launches += 1
    return dk, dv


attention_dkv.launches = 0


def btc_to_packed(qkv_btc: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, 3C) -> contiguous (3, B, H, T, C/H)."""
    b, t, c3 = qkv_btc.shape
    return qkv_btc.reshape(b, t, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4).contiguous()


def _bhtd_to_btc(x: torch.Tensor) -> torch.Tensor:
    b, h, t, e = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * e)


class _AttentionBTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv_btc, slopes, heads, positions, padding_mask, has_sentinel,
                dropout_rate, seed, h0, hash_heads):
        packed = btc_to_packed(qkv_btc, heads)
        out, lse = alibi_flash_attention_packed(
            packed, slopes, positions, padding_mask, has_sentinel, dropout_rate, seed,
            return_lse=True, h0=h0, hash_heads=hash_heads,
        )
        ctx.save_for_backward(packed, slopes, positions, padding_mask, out, lse)
        ctx.conf = (has_sentinel, dropout_rate, seed, h0, hash_heads)
        return _bhtd_to_btc(out)

    @staticmethod
    def backward(ctx, g):
        packed, slopes, positions, padding_mask, out, lse = ctx.saved_tensors
        has_sentinel, rate, seed, h0, hash_heads = ctx.conf
        _, b, h, t, e = packed.shape
        dout = g.reshape(b, t, h, e).permute(0, 2, 1, 3).to(packed.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(-1).reshape(b * h, t)
        dqkv = torch.empty_like(packed)
        args = (packed, dout, lse, delta, slopes, positions, padding_mask, has_sentinel, rate,
                seed)
        _, parts = attention_dq(*args, dq=dqkv[0], h0=h0, hash_heads=hash_heads)
        attention_dkv(*args, dk=dqkv[1], dv=dqkv[2], h0=h0, hash_heads=hash_heads)
        dqkv_btc = dqkv.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h * e)
        dslopes = parts.sum(dim=(0, 2)).to(slopes.dtype)
        return dqkv_btc, dslopes, None, None, None, None, None, None, None, None


def alibi_attention_btc_plain(qkv_btc, heads, slopes, positions, padding_mask=None,
                              has_sentinel=False, dropout_rate=0.0, seed=None, h0=0,
                              hash_heads=None):
    """The training entry's plain version (any device; autograd is its
    backward)."""
    out = alibi_attention_plain(btc_to_packed(qkv_btc, heads), slopes, positions,
                                padding_mask, has_sentinel, dropout_rate, seed, h0=h0,
                                hash_heads=hash_heads)
    return _bhtd_to_btc(out)


def alibi_flash_attention_btc(
    qkv_btc: torch.Tensor,
    heads: int,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = False,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    h0: int = 0,
    hash_heads: Optional[int] = None,
) -> torch.Tensor:
    """The model's attention entry: (B, T, 3C) qkv -> (B, T, C),
    differentiable in ``qkv_btc`` and ``slopes``. Without a gradient wanted
    and without dropout (serving) ``alibi_flash_attention_serve`` on the q,
    k, v thirds of ``qkv_btc``, its (B, T, H, D) output viewed as (B, T,
    C); on CUDA the autograd Function (forward with lse, then the backward
    kernels) when a gradient is wanted, else one training-kernel launch
    without lse (dropout); autograd through the plain version on CPU. A
    tensor-parallel rank's ``heads`` are heads ``h0`` .. of ``hash_heads``
    in the dropout hash (``hash_heads_of``)."""
    rate = float(dropout_rate)
    wants_grad = torch.is_grad_enabled() and (qkv_btc.requires_grad or slopes.requires_grad)
    if not wants_grad and rate == 0.0:
        b, t, c3 = qkv_btc.shape
        q, k, v = qkv_btc.reshape(b, t, 3, heads, c3 // (3 * heads)).unbind(2)
        out = alibi_flash_attention_serve(q, k, v, slopes, positions, padding_mask, has_sentinel)
        return out.view(b, t, c3 // 3)
    if _on_cpu(qkv_btc):
        return alibi_attention_btc_plain(qkv_btc, heads, slopes, positions, padding_mask,
                                         has_sentinel, dropout_rate, seed, h0, hash_heads)
    _check_device(qkv_btc, "alibi attention")
    if wants_grad:
        return _AttentionBTC.apply(qkv_btc, slopes, heads, positions, padding_mask,
                                   has_sentinel, rate, seed, h0, hash_heads)
    out = alibi_flash_attention_packed(btc_to_packed(qkv_btc, heads), slopes, positions,
                                       padding_mask, has_sentinel, rate, seed, h0=h0,
                                       hash_heads=hash_heads)
    return _bhtd_to_btc(out)


# int8 serving attention: the port of ``alibi_flash_attention_int8`` and its
# kernel ``_kernel_q8`` (``pallas_attention.py:715-888``). q and k are
# quantized per row over D (``D**-0.5`` folded into q before its max), v per
# channel over T. Over each span of ``span`` keys:
#
#   s = fp32(q8 . k8) * qs * ks - slope * |pos_q - pos_k|   (0 at sentinels)
#   s = -1e9 at padded keys;  m' = max(m, max_span s);  p = exp(s - m')
#   l = exp(m - m') * l + sum p               (unquantized fp32 p)
#   acc = exp(m - m') * acc + fp32(round(127 p) . v8) * (vs * fp32(1/127))
#
# and out = acc / max(l, 1e-30), over the head's D columns (the layouts pad
# q8, k8 and v8^T with zeros to ``int8_row_len(D)``). P is quantized against the running max
# after each whole span, so the result depends on the span: the JAX key
# block (``int8_spans``, 2048 keys at most). Like the JAX wrapper, keys past
# T up to the padded length count as padded keys with zero v (their weight
# is 0 unless a row's every key is padded). m starts at -1e9, so such a row
# stays finite. Serving only: no dropout, no backward.


def int8_spans(t: int, block_q: int = 1024, block_k: int = 2048) -> Tuple[int, int]:
    """(span, padded length) of the int8 attention over T keys: the JAX
    kernel's key block and padded length (``_fwd_blocks``)."""
    ceil = lambda x, m: -(-x // m) * m
    bq, bk = min(block_q, ceil(t, 128)), min(block_k, ceil(t, 128))
    if bk > bq:
        bk = bk // bq * bq
    elif bq > bk:
        bq = bq // bk * bk
    return bk, ceil(t, max(bq, bk))


def quantize_qkv_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, T, H, D) q, k, v -> q8, qs, k8, ks, v8, vs: int8 values of the
    inputs' shape, (B, T, H) fp32 row scales of q (with ``D**-0.5`` folded
    in) and k, (B, H, D) fp32 channel scales of v."""
    q8, qs = quantize_rows(q.float() * q.shape[-1] ** -0.5)
    k8, ks = quantize_rows(k)
    v32 = v.float()
    vs = torch.clamp_min(v32.abs().amax(dim=1) * INV_127, 1e-12)
    return q8, qs, k8, ks, torch.round(v32 / vs[:, None]).to(torch.int8), vs


def alibi_attention_int8_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = True,
    block_q: int = 1024,
    block_k: int = 2048,
) -> torch.Tensor:
    """Reference of the int8 kernel with its quantization (any device): (B,
    T, H, D) in q's dtype, the int8 products exact in float64, one batch row
    at a time."""
    span, t_pad = int8_spans(q.shape[1], block_q, block_k)
    quantized = quantize_qkv_int8_pass_plain(q, k, v, t_pad)
    return attention_int8_quantized_plain(*quantized, slopes, positions, padding_mask,
                                          has_sentinel, span, q.dtype)


def attention_int8_quantized_plain(
    q8: torch.Tensor,
    qs: torch.Tensor,
    k8: torch.Tensor,
    ks: torch.Tensor,
    v8t: torch.Tensor,
    vsc: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    has_sentinel: bool,
    span: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Reference of the int8 kernel on the quantization pass's outputs (the
    layouts of ``quantize_qkv_int8_pass_plain``, any device): (B, T, H, D)
    in ``out_dtype``, D the channels of ``vsc``, the int8 products exact in
    float64."""
    b, h, t, _ = q8.shape
    d = vsc.shape[-1]
    q8, k8, v8t = q8[..., :d], k8[..., :d], v8t[:, :, :d]  # the padding is zero
    t_pad = v8t.shape[-1]
    pad = t_pad - t
    k8, ks = F.pad(k8, (0, 0, 0, pad)), F.pad(ks, (0, pad))
    v8 = v8t[..., torch.argsort(v8t_key_order(t_pad, v8t.device))].transpose(-1, -2)
    pos = F.pad(positions.to(torch.int32).expand(b, t), (0, pad)).float()
    padded = torch.zeros((b, t_pad), dtype=torch.bool, device=q8.device)
    padded[:, t:] = True
    if padding_mask is not None:
        padded[:, :t] = padding_mask.bool()
    neg_slopes = -slopes.float()[:, None, None]
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q8.device)
    for bi in range(b):
        qb = q8[bi].double()  # (H, T, D)
        qsb = qs[bi][:, :, None]
        m = torch.full((h, t), NEG_INF, device=q8.device)
        l = torch.zeros((h, t), device=q8.device)
        acc = torch.zeros((h, t, d), device=q8.device)
        for k0 in range(0, t_pad, span):
            keys = slice(k0, k0 + span)
            s = torch.matmul(qb, k8[bi][:, keys].transpose(-1, -2).double()).float()
            s = s * qsb * ks[bi][:, None, keys]
            pq, pk = pos[bi, :t, None], pos[bi, None, keys]
            dist = (pq - pk).abs()
            if has_sentinel:
                dist = dist.masked_fill((pq < 0) | (pk < 0), 0.0)
            s = (s + neg_slopes * dist).masked_fill(padded[bi, None, None, keys], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(dim=-1)
            p8 = torch.round(p * 127.0).double()
            pv = torch.matmul(p8, v8[bi][:, keys].double()).float()
            acc = acc * alpha[..., None] + pv * vsc[bi][:, None, :]
            m = m_new
        out[bi] = (acc / torch.clamp_min(l, 1e-30)[..., None]).transpose(0, 1)
    return out.to(out_dtype)


def v8t_key_order(t_pad: int, device=None) -> torch.Tensor:
    """The key at each position of a v8^T row: in every 32 keys, position a
    holds key 16 (a >> 4) + 8 ((a >> 1) & 1) + 2 ((a >> 2) & 3) + (a & 1),
    the order in which the kernel's P V product reads them (the keys that a
    thread's S accumulator holds, ``csrc/alibi_attention_int8.cu``)."""
    a = torch.arange(t_pad, device=device)
    w = a % 32
    return a - w + 16 * (w >> 4) + 8 * ((w >> 1) & 1) + 2 * ((w >> 2) & 3) + (w & 1)


def quantize_qkv_int8_pass_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_pad: int):
    """Plain version of the kernel's quantization pass: (B, T, H, D) q, k, v
    -> q8, k8 (B, H, T, R) int8, qs, ks (B, H, T) fp32, v8t (B, H, R, t_pad)
    int8 (zero past T, keys in ``v8t_key_order``) and vsc (B, H, D) fp32 =
    vs * fp32(1/127): ``quantize_qkv_int8``'s values in the kernel's
    layouts, whose rows of R = ``int8_row_len(D)`` are zero past D."""
    q8, qs, k8, ks, v8, vs = quantize_qkv_int8(q, k, v)
    t, d = q.shape[1], q.shape[-1]
    rows = int8_row_len(d)
    v8t = F.pad(v8.permute(0, 2, 3, 1), (0, t_pad - t, 0, rows - d))
    v8t = v8t[..., v8t_key_order(t_pad, q.device)]
    bhtd = lambda x: x.transpose(1, 2).contiguous()
    return (bhtd(pad_head(q8, rows)), bhtd(qs), bhtd(pad_head(k8, rows)), bhtd(ks),
            v8t.contiguous(), vs * INV_127)


@torch.library.custom_op("a2v::quantize_qkv_int8", mutates_args=(), device_types="cuda")
def _quantize_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_pad: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """#5's quantization pass on the card: one C entry of two launches, q,
    k, v read in place (a head dim off a multiple of 8 from zero-padded
    copies)."""
    require_bf16("the int8 q, k, v quantization pass (#5)", q.dtype)
    _check_card_views(q, k, v)
    b, t, h, d = q.shape
    dk = kernel_head_dim(d)
    q_k, k_k, v_k = (pad_head(x, dk) for x in (q, k, v))
    if not all(_aligned(x) for x in (q_k, k_k, v_k)):
        raise ValueError("the kernel needs 16-byte aligned q, k, v with a contiguous last dim "
                         "and strides in multiples of 8")
    if t_pad < t or t_pad % 64:
        raise ValueError(f"t_pad must be a multiple of 64 and at least T={t}, got {t_pad}")
    q8, qs, k8, ks, v8t, vsc = _quantized_layouts(q, t_pad)
    vsc_k = vsc if dk == d else vsc.new_empty((b, h, dk))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().a2v_quantize_qkv_int8(
            q_k.data_ptr(), k_k.data_ptr(), v_k.data_ptr(), q_k.stride(0), q_k.stride(1),
            q_k.stride(2), q8.data_ptr(), qs.data_ptr(), k8.data_ptr(), ks.data_ptr(),
            v8t.data_ptr(), vsc_k.data_ptr(), b, h, t, dk, t_pad, d**-0.5, stream,
        )
    check(err, "int8 q, k, v quantization kernel")
    if vsc_k is not vsc:
        vsc.copy_(vsc_k[..., :d])
    quantize_qkv_int8_pass.launches += 1
    return q8, qs, k8, ks, v8t, vsc


def _quantized_layouts(q: torch.Tensor, t_pad: int):
    """Empty q8, qs, k8, ks, v8t, vsc of the pass for (B, T, H, D) ``q``."""
    b, t, h, d = q.shape
    rows = int8_row_len(d)
    q8 = q.new_empty((b, h, t, rows), dtype=torch.int8)
    qs = q.new_empty((b, h, t), dtype=torch.float32)
    v8t = q.new_empty((b, h, rows, t_pad), dtype=torch.int8)
    return (q8, qs, torch.empty_like(q8), torch.empty_like(qs), v8t,
            q.new_empty((b, h, d), dtype=torch.float32))


@_quantize_op.register_kernel("cpu")
def _quantize_plain(q, k, v, t_pad):
    return quantize_qkv_int8_pass_plain(q, k, v, t_pad)


_quantize_op.register_fake(lambda q, k, v, t_pad: _quantized_layouts(q, t_pad))


def quantize_qkv_int8_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_pad: int):
    """The int8 attention's quantization of (B, T, H, D) views q, k, v that
    share one set of strides (the qkv projection's thirds), into the
    kernel's layouts (``quantize_qkv_int8_pass_plain``): the custom op
    ``a2v::quantize_qkv_int8``, one C entry of two launches on CUDA
    (``csrc/alibi_attention_int8.cu``, q, k, v read in place), the plain
    version on CPU."""
    _check_qkv_views(q, k, v)
    if q.device.type != "cpu":
        _check_device(q, "int8 q, k, v quantization")
    return _quantize_op(q, k, v, int(t_pad))


quantize_qkv_int8_pass.launches = 0


@torch.library.custom_op("a2v::alibi_attention_int8", mutates_args=(), device_types="cuda")
def _attention_int8_op(q8: torch.Tensor, qs: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                       v8t: torch.Tensor, vsc: torch.Tensor, slopes: torch.Tensor,
                       positions: torch.Tensor, padding_mask: Optional[torch.Tensor],
                       has_sentinel: bool, span: int, out_dtype: torch.dtype) -> torch.Tensor:
    """#5 on the card: one launch on the quantization pass's outputs, heads
    of the D channels of ``vsc`` (off a multiple of 8: the zero-padded head,
    its first D columns kept)."""
    _check_device(q8, "int8 alibi attention")
    require_bf16("the int8 alibi attention (#5)", out_dtype)
    b, h, t, rows = q8.shape
    d = vsc.shape[-1]
    dk = kernel_head_dim(d)
    if rows != int8_row_len(d) or v8t.shape[2] != rows:
        raise ValueError(f"q8 and v8t must hold rows of {int8_row_len(d)} for D={d}, got "
                         f"{tuple(q8.shape)}, {tuple(v8t.shape)}")
    t_pad = v8t.shape[-1]
    sl, pos, pos_per_row, mask, mask_per_row = _side_args(b, h, t, q8.device, slopes, positions,
                                                          padding_mask)
    vsc_k = pad_head(vsc, dk)  # zero scales of the zero channels
    out = torch.empty((b, t, h, dk), dtype=out_dtype, device=q8.device)
    # the fp32 sums between key spans (none with one span)
    o_acc = torch.empty_like(q8, dtype=torch.float32) if t_pad > span else None
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().a2v_alibi_attention_int8(
            q8.data_ptr(), qs.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8t.data_ptr(),
            vsc_k.data_ptr(), sl.data_ptr(), pos.data_ptr(), pos_per_row,
            None if mask is None else mask.data_ptr(), mask_per_row, out.data_ptr(),
            None if o_acc is None else o_acc.data_ptr(), b, h, t, dk, t_pad, span,
            int(has_sentinel), stream,
        )
    check(err, "int8 alibi attention kernel")
    alibi_flash_attention_int8.launches += 1
    return out if dk == d else out[..., :d].contiguous()


@_attention_int8_op.register_kernel("cpu")
def _attention_int8_plain(*args):
    return attention_int8_quantized_plain(*args)


@_attention_int8_op.register_fake
def _attention_int8_fake(q8, qs, k8, ks, v8t, vsc, slopes, positions, padding_mask,
                         has_sentinel, span, out_dtype):
    b, h, t, _ = q8.shape
    return q8.new_empty((b, t, h, vsc.shape[-1]), dtype=out_dtype)


def alibi_flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slopes: torch.Tensor,
    positions: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    has_sentinel: bool = True,
    block_q: int = 1024,
    block_k: int = 2048,
) -> torch.Tensor:
    """int8 ALiBi attention of (B, T, H, D) q, k, v -> (B, T, H, D) in q's
    dtype: ``quantize_qkv_int8_pass``, then the custom op
    ``a2v::alibi_attention_int8`` on its outputs. On CUDA, q, k and v are
    views with one set of strides (the qkv projection's thirds), quantized
    in place, and the kernel (``csrc/alibi_attention_int8.cu``) runs; on
    CPU the plain versions run (``alibi_attention_int8_plain``'s two
    halves)."""
    _check_qkv_views(q, k, v)
    if q.device.type != "cpu":
        _check_device(q, "int8 alibi attention")
    span, t_pad = int8_spans(q.shape[1], block_q, block_k)
    quantized = quantize_qkv_int8_pass(q, k, v, t_pad)
    return _attention_int8_op(*quantized, slopes, positions, padding_mask, bool(has_sentinel),
                              span, q.dtype)


alibi_flash_attention_int8.launches = 0
