"""int8 dense projection for serving: the port of
``animal2vec_tpu/ops/int8_mm.py`` (``quantize_weight``, ``int8_dense``) and of
the lane-aligned route of ``models/modules.quantized_matmul``.

    y = dtype(fp32(x_q W_q^T) * xs * ws + bias)

x (..., K) is quantized per row over the whole K with a dynamic scale
(``quantize_rows``); the weight, in nn.Linear layout (M, K), once per output
channel over K (``quantize_weight``). Both take ``s = max(max|v| * R,
1e-12)`` with R = fp32(1/127) and ``q = round(v / s)`` with an IEEE
division, rounding half to even. The JAX code writes ``max|v| / 127.0``, but
XLA rewrites a division by a constant into a product with its reciprocal
under ``jit``, so the product is what the JAX package computes: with it the
int8 values and fp32 scales are bit-exact with JAX's on the same inputs.
The int32 product is cast to fp32, times xs, times ws, plus the fp32 bias
(zeros when None), and cast to x's dtype once. The model adds its own bias
after that cast, in the storage dtype (two roundings, as
``modules.py:300-301, 319-320, 355``).

``int8_dense`` is the custom op ``a2v::int8_dense``: on a CUDA tensor it
launches the hand-written kernel (``csrc/int8_dense.cu``, bf16 x); on a CPU
tensor it runs ``int8_dense_plain``, which accumulates the int8 products
exactly in float64; any other device raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from animal2vec_tpu_torch.kernels.build import check, library, require_bf16

INV_127 = 1.0 / 127.0  # rounds to fp32(1/127) in an fp32 product, as XLA's constant


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantization over the last dim: (int8 values of
    x's shape, fp32 scales of shape ``x.shape[:-1]``)."""
    x32 = x.float()
    s = torch.clamp_min(x32.abs().amax(dim=-1) * INV_127, 1e-12)
    return torch.round(x32 / s[..., None]).to(torch.int8), s


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of an nn.Linear weight
    (M, K): (contiguous int8 (M, K), fp32 (M,)), whatever the strides of
    ``weight``; the JAX ``quantize_weight`` of the (K, M) kernel, transposed."""
    return quantize_rows(weight.detach().contiguous())


def int_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int8 product a (..., K) . b_t (M, K)^T in float64 (|sums| stay
    far below 2^53), rounded once to fp32 as an int32 -> fp32 cast rounds."""
    return torch.matmul(a.double(), b_t.double().t()).float()


def int8_dense_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_s: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference of the kernel (any device): (..., M) in x's dtype."""
    x_q, x_s = quantize_rows(x)
    y = int_matmul(x_q, w_q) * x_s[..., None] * w_s.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


@torch.library.custom_op("a2v::int8_dense", mutates_args=(), device_types="cuda")
def _dense_op(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """#10 on the card: one C entry (x's quantization, the GEMM)."""
    k = x.shape[-1]
    m = w_q.shape[0]
    require_bf16("the int8 dense projection (#10)", x.dtype)
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous x")
    if w_q.dtype != torch.int8 or w_q.shape != (m, k) or not w_q.is_contiguous():
        raise ValueError(f"w_q must be a contiguous int8 ({m}, {k}), got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    if w_s.shape != (m,) or w_s.dtype != torch.float32 or not w_s.is_contiguous():
        raise ValueError(f"w_s must be a contiguous fp32 ({m},), got {w_s.dtype} "
                         f"{tuple(w_s.shape)}")
    if bias is not None and bias.shape != (m,):
        raise ValueError(f"bias must be ({m},), got {tuple(bias.shape)}")
    if k % 64 or m % 8:
        raise ValueError(f"the kernel needs K % 64 == 0 and M % 8 == 0, got K={k}, M={m}")
    dev = x.device
    if any(v.device != dev for v in (w_q, w_s) + (() if bias is None else (bias,))):
        raise ValueError("w_q, w_s and bias must be on x's device")
    n = x.numel() // k
    b = None if bias is None else bias.detach().to(torch.float32).contiguous()
    x_q = torch.empty((n, k), dtype=torch.int8, device=dev)
    x_s = torch.empty((n,), dtype=torch.float32, device=dev)
    out = torch.empty((*x.shape[:-1], m), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().a2v_int8_dense(
            x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), None if b is None else b.data_ptr(),
            x_q.data_ptr(), x_s.data_ptr(), out.data_ptr(), n, k, m, stream,
        )
    check(err, "int8 dense kernel")
    int8_dense.launches += 1
    return out


@_dense_op.register_kernel("cpu")
def _dense_plain(x, w_q, w_s, bias):
    return int8_dense_plain(x, w_q, w_s, bias)


@_dense_op.register_fake
def _dense_fake(x, w_q, w_s, bias):
    return x.new_empty((*x.shape[:-1], w_q.shape[0]))


def int8_dense(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_s: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (..., K) times the int8 weight w_q (M, K) with scales w_s (M,):
    (..., M) in x's dtype. The custom op ``a2v::int8_dense``: the kernel on
    CUDA, the plain version on CPU."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 dense runs on cuda or cpu tensors, got {x.device}")
    return _dense_op(x, w_q, w_s, bias)


int8_dense.launches = 0
