"""Attention kernels and a matmul chain side by side, the counterpart of
``bench/kernels2.py`` (which set jax's stock TPU flash kernel, imported at
:52, beside ``attn_v2`` at :73-82 and a matmul chain). No kernel of its
own.

    python -m animal2vec_tpu_torch.probes.kernels2

prints host ms (CUDA events), device ms and TFLOP/s, at b32 H16 T2048 D64
with no padding, of #11 without bias (``ops/bias_attention.
bias_attention_forward``), #1 with uniform positions
(``ops/attention.alibi_flash_attention_serve``), #12a ``full``
(``probes/kernels.attn_v2``, at both key tiles) and
scaled_dot_product_attention without a mask; and of the matmul chain
(65536, 1024) @ (1024, 4096) @ (4096, 1024) through torch.matmul and
through #12b (``probes/pallas_mm.row_gemm``, 128-row tiles).
"""

from __future__ import annotations

import sys
from typing import Callable, Dict

import torch

from animal2vec_tpu_torch.probes.timing import (
    card_line, cuda_ms, device_ms, ms_text, num_text, per_ms, require_cuda,
)

SHAPE = (32, 16, 2048, 64)  # b, h, t, d
CHAIN = (65536, 1024, 4096)  # rows, C, M of the matmul chain


def sweep(dev, out: Callable = print) -> Dict[str, dict]:
    """The side-by-side rows by label: host ms, device ms, TFLOP/s."""
    import torch.nn.functional as F

    from animal2vec_tpu_torch.ops.alibi import alibi_slopes
    from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_serve
    from animal2vec_tpu_torch.ops.bias_attention import bias_attention_forward
    from animal2vec_tpu_torch.probes.kernels import (
        KEY_TILES, attention_flops, attn_v2, scaled_positions,
    )
    from animal2vec_tpu_torch.probes.pallas_mm import row_gemm

    rows: Dict[str, dict] = {}

    def row(label, fn, kernel, flops):
        ms, dev_ms = cuda_ms(fn), device_ms(fn, kernel)
        rows[label] = {"ms": ms, "device_ms": dev_ms, "tflops": per_ms(flops, dev_ms)}
        out(f"{label}: {ms:.4f} ms, device {ms_text(dev_ms)}, "
            f"{num_text(rows[label]['tflops'])} TFLOP/s")

    b, h, t, d = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    flops = attention_flops(b, h, t, d)
    out(f"kernels2: attention at b{b} H{h} T{t} D{d}, no padding; the matmul chain {CHAIN}")
    with torch.inference_mode():
        qkv = (torch.randn((3, b, h, t, d), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        # (B, T, 3, H, D): the q, k, v views #11 reads (each row's heads packed)
        q, k, v = qkv.permute(1, 3, 0, 2, 4).contiguous().unbind(2)
        row("#11 bias_attention_forward, no bias", lambda: bias_attention_forward(q, k, v),
            "bias_attention_kernel", flops)
        slopes = torch.from_numpy(alibi_slopes(h).copy()).to(dev)
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
        row("#1 alibi_flash_attention_serve, uniform positions",
            lambda: alibi_flash_attention_serve(q, k, v, slopes, pos), "alibi_fwd_kernel", flops)
        sp = scaled_positions(slopes, b, t, t)
        for bk in KEY_TILES:
            row(f"#12a attn_v2 full, key tile {bk}", lambda bk=bk: attn_v2(qkv, sp, "full", bk),
                "probe_attention_kernel", flops)
        qs, ks, vs = qkv.unbind(0)
        row("SDPA, no mask", lambda: F.scaled_dot_product_attention(qs, ks, vs), "", flops)
        del q, k, v, qkv, qs, ks, vs

        n, c, m = CHAIN
        x = (torch.randn((n, c), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        w1t = (torch.randn((m, c), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        w2t = (torch.randn((c, m), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        w1, w2 = w1t.t(), w2t.t()
        chain = 4 * n * c * m
        row("matmul chain, torch.matmul", lambda: torch.matmul(torch.matmul(x, w1), w2), "",
            chain)
        row("matmul chain, #12b row_gemm (block_m 128)",
            lambda: row_gemm(row_gemm(x, w1), w2), "gemm_bf16_sm90_kernel", chain)
    return rows


def main() -> int:
    if not require_cuda("probes.kernels2"):
        return 1
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    sweep(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
