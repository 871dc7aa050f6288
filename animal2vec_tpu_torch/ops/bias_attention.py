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

On a CUDA tensor ``bias_flash_attention`` launches the hand-written flash
kernel (``csrc/bias_attention.cu``, bf16, D = 64); on a CPU tensor it runs
``bias_attention_plain``, a transcription of ``xla_attention``; any other
device raises. The kernel reads q, k and v in place with their batch and
time strides (each row's heads packed, the three with the same strides), so
the model passes the q, k, v views of its (B, T, 3, H, D) projection and
makes no packed copy (the ALiBi kernels' ``btc_to_packed`` copy is the
largest copy of the a2v-large forward, ``PERF.md`` section 5). A
batch-uniform bias, (1, H, T, T) or expanded with batch stride 0, is read
with batch stride 0 and never expanded in memory.

jax's stock TPU kernel computes ``softmax((q.k + bias) * D^-0.5)``: it
weakens the bias by D^-0.5, where ``xla_attention`` (below 1024 tokens and
on every other backend) and the fairseq reference add it after the scale.
The port follows ``xla_attention`` at every length
(``tests/test_torch_bias_attention.py`` records the difference).
"""

from __future__ import annotations

from typing import Optional

import torch

from animal2vec_tpu_torch.kernels.build import check, library

NEG_INF = -1e10  # models/attention.py NEG_INF


def bias_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Materialized-score reference (any device): ``xla_attention``."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * d**-0.5).float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    if padding_mask is not None:
        logits = logits.masked_fill(padding_mask.bool()[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def _bias_arg(bias: torch.Tensor, b: int, h: int, t: int, dev):
    """(contiguous fp32 bias, uniform): a batch-uniform bias as its one
    (1, H, T, T) plane."""
    if bias.dim() != 4 or bias.shape[1:] != (h, t, t) or bias.shape[0] not in (1, b):
        raise ValueError(f"bias must be (1 or {b}, {h}, {t}, {t}), got {tuple(bias.shape)}")
    if bias.dtype != torch.float32 or bias.device != dev:
        raise ValueError(f"bias must be fp32 on {dev}, got {bias.dtype} on {bias.device}")
    uniform = bias.shape[0] == 1 or bias.stride(0) == 0
    if uniform:
        bias = bias[:1]
    return bias.detach().contiguous(), uniform


def bias_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense-bias attention of (B, T, H, D) q, k, v -> (B, T, H, D); kernel
    on CUDA, plain version on CPU."""
    if q.device.type == "cpu":
        return bias_attention_plain(q, k, v, bias, padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"bias attention runs on cuda or cpu tensors, got {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, T, H, D) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if d != 64 or any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError(f"the kernel takes bf16 q, k, v with head dim 64, got {q.dtype}, D={d}")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides or strides[2:] != (d, 1):
        raise ValueError(f"q, k, v must share strides (stride_b, stride_t, {d}, 1), got "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    if strides[0] % 8 or strides[1] % 8 or any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the kernel reads 16-byte chunks: q, k, v must be 16-byte aligned "
                         "with strides in multiples of 8")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("k and v must be on q's device")
    uniform = False
    if bias is not None:
        bias, uniform = _bias_arg(bias, b, h, t, dev)
    if padding_mask is not None:
        if padding_mask.shape != (b, t) or padding_mask.device != dev:
            raise ValueError(f"padding_mask must be ({b}, {t}) on {dev}, got "
                             f"{tuple(padding_mask.shape)} on {padding_mask.device}")
        padding_mask = padding_mask.to(torch.bool).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().a2v_bias_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides[0], strides[1],
            None if bias is None else bias.data_ptr(), int(uniform),
            None if padding_mask is None else padding_mask.data_ptr(), out.data_ptr(),
            b, h, t, d, d**-0.5, stream,
        )
    check(err, "bias attention kernel")
    bias_flash_attention.launches += 1
    return out


bias_flash_attention.launches = 0
