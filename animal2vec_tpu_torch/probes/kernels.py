"""#12a: the ALiBi flash-attention forward probe with slope-folded
positions, the counterpart of ``bench/kernels.py`` (``_kernel_v2`` at :27,
``attn_v2`` at :96, its ``pallas_call`` at :103).

``attn_v2(qkv, scaled_pos, variant, block_k)`` takes bench/'s layout: qkv
(3, B, H, T, D) bf16, contiguous, and ``scaled_pos`` (B, H, T) fp32, each
head's slope times the position with +1e9 at padded positions (one array
for queries and keys, so padded query rows attend to padded keys only);
it returns (B, H, T, D) bf16. The four variants take #1's scalar pass
apart: ``mm_only`` (the two products and the bf16 of the scores),
``no_softmax`` (plus the bias), ``exp_bf16`` (an online softmax with a
bf16 exp) and ``full`` (with an fp32 exp); ``csrc/probe_attention.cu``
states the function. On a CUDA tensor one launch of that kernel (D 64, a
key tile ``block_k`` of 64 or 128), on a CPU tensor ``attn_v2_plain``,
which follows the online order over tiles of ``block_k`` keys (the online
variants depend on it through the running max); any other device raises.

    python -m animal2vec_tpu_torch.probes.kernels

checks every variant against its plain twin at b2 T 512 (12 padded
positions, as bench/kernels.py checked its slice) and prints each
variant's ms, device ms, TFLOP/s and share of the bound at b32 H16 T2048
D64 with 48 padded positions, beside #1 (its padding-mask route) and
scaled_dot_product_attention with the bias as a float mask.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict

import torch

from animal2vec_tpu_torch.kernels.build import check as check_launch, library
from animal2vec_tpu_torch.probes.timing import (
    bound, card_line, check_close, cuda_ms, device_ms, ms_text, num_text, per_ms, require_cuda,
)

VARIANTS = ("mm_only", "no_softmax", "exp_bf16", "full")
KEY_TILES = (64, 128)  # the kernel's key tiles
NEG_INF = -1e9  # the running max's start, the TPU kernel's NEG_INF
PAD_POS = 1e9  # the scaled position of a padded token
# against the plain twin on the card: one bf16 rounding of the output and
# fp32 sums in another order (ATTN_TOL of chip_smoke.py). no_softmax's
# outputs reach ~1e10 (scores of -1e9 at padded pairs): relative, plus 1e-3
# of the row's largest |value| for the elements where sums of such terms
# cancel (fp32 sums of ~1e9 terms in another order differ by ~1e3).
TOL = (1e-2, 1e-2)
NO_SOFTMAX_ROW_ATOL = 1e-3
SWEEP = (32, 16, 2048, 64, 2000)  # b, h, t, d, valid positions (bench/kernels.py)


def scaled_positions(slopes: torch.Tensor, b: int, t: int, n_valid: int) -> torch.Tensor:
    """(B, H, T) fp32: slope_h * position, +1e9 from position n_valid on."""
    pos = torch.arange(t, dtype=torch.float32, device=slopes.device)
    sp = slopes.float()[:, None] * pos[None, :]
    sp = torch.where(pos[None, :] >= n_valid, torch.full_like(sp, PAD_POS), sp)
    return sp[None].expand(b, -1, -1).contiguous()


def attn_v2_plain(qkv: torch.Tensor, scaled_pos: torch.Tensor, block_k: int,
                  variant: str = "full") -> torch.Tensor:
    """The probe's function in plain PyTorch (any device), key tile by key
    tile of ``block_k`` keys (the last one ragged), with the kernel's fp32
    and bf16 roundings."""
    q, k, v = qkv.unbind(0)
    d = q.shape[-1]
    scale = torch.tensor(d**-0.5, dtype=torch.bfloat16).item()
    qs = (q * scale).float()  # bf16(q * bf16(D^-0.5))
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1] + (1,), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    pq = scaled_pos.float()[..., :, None]
    for k0 in range(0, q.shape[-2], block_k):
        kb, vb = k[..., k0:k0 + block_k, :].float(), v[..., k0:k0 + block_k, :].float()
        s = qs @ kb.transpose(-1, -2)
        if variant != "mm_only":
            s = s - (pq - scaled_pos.float()[..., None, k0:k0 + block_k]).abs()
        if variant in ("mm_only", "no_softmax"):
            acc = acc + s.to(torch.bfloat16).float() @ vb
            continue
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        if variant == "exp_bf16":
            p = torch.exp((s - m_new).to(torch.bfloat16)).float()
        else:
            p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vb
        m = m_new
    if variant in ("mm_only", "no_softmax"):
        return acc.to(torch.bfloat16)
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def _check_args(qkv: torch.Tensor, scaled_pos: torch.Tensor, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if qkv.dim() != 5 or qkv.shape[0] != 3 or qkv.dtype != torch.bfloat16 \
            or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous bf16 (3, B, H, T, D), got {qkv.dtype} "
                         f"{tuple(qkv.shape)} with strides {qkv.stride()}")
    if scaled_pos.shape != qkv.shape[1:4] or scaled_pos.dtype != torch.float32 \
            or not scaled_pos.is_contiguous() or scaled_pos.device != qkv.device:
        raise ValueError(f"scaled_pos must be a contiguous fp32 {tuple(qkv.shape[1:4])} on "
                         f"qkv's device, got {scaled_pos.dtype} {tuple(scaled_pos.shape)} on "
                         f"{scaled_pos.device}")


def attn_v2(qkv: torch.Tensor, scaled_pos: torch.Tensor, variant: str = "full",
            block_k: int = 64) -> torch.Tensor:
    """The probe (module docstring): one launch of csrc/probe_attention.cu
    on CUDA, ``attn_v2_plain`` on CPU."""
    _check_args(qkv, scaled_pos, variant)
    if qkv.device.type == "cpu":
        return attn_v2_plain(qkv, scaled_pos, block_k, variant)
    if qkv.device.type != "cuda":
        raise ValueError(f"the attention probe runs on cuda or cpu tensors, got {qkv.device}")
    _, b, h, t, d = qkv.shape
    if d != 64 or block_k not in KEY_TILES:
        raise ValueError(f"the kernel takes D 64 and a key tile in {KEY_TILES}, got D {d}, "
                         f"block_k {block_k}")
    out = torch.empty((b, h, t, d), dtype=torch.bfloat16, device=qkv.device)
    scale = torch.tensor(d**-0.5, dtype=torch.bfloat16).item()
    with torch.cuda.device(qkv.device):
        err = library().a2v_probe_attention(
            qkv.data_ptr(), scaled_pos.data_ptr(), out.data_ptr(), b, h, t, d,
            VARIANTS.index(variant), block_k, scale, torch.cuda.current_stream().cuda_stream)
    check_launch(err, "attention probe kernel")
    attn_v2.launches += 1
    return out


attn_v2.launches = 0


def attention_flops(b: int, h: int, t: int, d: int = 64) -> int:
    """Q K^T and P V: 2 T^2 D each per (b, h)."""
    return 4 * b * h * t * t * d


def attention_bound(b: int, h: int, t: int, d: int = 64):
    """(ms, what bounds it): bf16 qkv and fp32 positions read, bf16 out
    written, once each."""
    return bound(attention_flops(b, h, t, d), 2 * 4 * b * h * t * d + 4 * b * h * t)


def probe_inputs(b: int, h: int, t: int, d: int, n_valid: int, dev, seed: int = 0):
    """qkv (3, B, H, T, D) bf16 of N(0, 0.3^2) (bench/kernels.py's scale),
    the ALiBi slopes (H,) and the scaled positions."""
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes

    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn((3, b, h, t, d), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    slopes = torch.from_numpy(alibi_slopes(h).copy()).to(dev)
    return qkv, slopes, scaled_positions(slopes, b, t, n_valid)


def check_variant(label: str, qkv, sp, variant: str, block_k: int,
                  out: Callable = print) -> Dict[str, float]:
    """The kernel against attn_v2_plain on the same inputs (every row, the
    padded ones too); the plain twin's ms (one call, CUDA events)."""
    got = attn_v2(qkv, sp, variant, block_k)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = attn_v2_plain(qkv, sp, block_k, variant)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    name = f"{label} {variant} (key tile {block_k}; plain twin {plain_ms:.3f} ms)"
    atol, rtol = TOL
    if variant == "no_softmax":
        atol = NO_SOFTMAX_ROW_ATOL * want.float().abs().amax(-1, keepdim=True)
    err = check_close(name, got, want, atol, rtol, out,
                      f"{NO_SOFTMAX_ROW_ATOL} x the row's largest |plain|"
                      if variant == "no_softmax" else None)
    return {"max_abs_err": err, "plain_ms": plain_ms}


def check(dev, shapes=((2, 16, 512, 64, 500),), out: Callable = print) -> Dict[str, dict]:
    """Every variant at every key tile against its plain twin at each (b, h,
    t, d, valid positions); returns {variant: {block_k: {"max_abs_err": the
    worst over the shapes, "plain_ms": the first shape's}}}."""
    res: Dict[str, dict] = {v: {} for v in VARIANTS}
    for b, h, t, d, n_valid in shapes:
        qkv, _, sp = probe_inputs(b, h, t, d, n_valid, dev, seed=t)
        for variant in VARIANTS:
            for bk in KEY_TILES:
                r = check_variant(f"attn_v2 b{b} H{h} T{t} ({t - n_valid} padded)", qkv, sp,
                                  variant, bk, out)
                first = res[variant].setdefault(bk, r)
                first["max_abs_err"] = max(first["max_abs_err"], r["max_abs_err"])
        del qkv, sp
    return res


def sweep(dev, out: Callable = print) -> Dict[str, dict]:
    """Each variant at each key tile at b32 H16 T2048 D64 with 48 padded
    positions (host ms, device ms, TFLOP/s, share of the bound), beside #1's
    padding-mask route and SDPA with the bias as a (1, H, T, T) bf16 float
    mask. Returns the rows by label."""
    import torch.nn.functional as F

    from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_serve

    b, h, t, d, n_valid = SWEEP
    qkv, slopes, sp = probe_inputs(b, h, t, d, n_valid, dev)
    flops = attention_flops(b, h, t, d)
    bnd = attention_bound(b, h, t, d)
    rows: Dict[str, dict] = {}

    def row(label, fn, kernel):
        ms = cuda_ms(fn)
        dev_ms = device_ms(fn, kernel)
        rate = per_ms(flops, dev_ms)
        rows[label] = {"ms": ms, "device_ms": dev_ms, "tflops": rate, "bound_ms": bnd[0],
                       "bound_by": bnd[1],
                       "bound_share": None if dev_ms is None else bnd[0] / dev_ms}
        out(f"{label}: {ms:.4f} ms, device {ms_text(dev_ms)}, {num_text(rate)} TFLOP/s, "
            f"{num_text(rows[label]['bound_share'], '.3f')} of the bound {bnd[0]:.3f} ms "
            f"({bnd[1]})")

    out(f"#12a attention probe, b{b} H{h} T{t} D{d}, {t - n_valid} padded positions:")
    with torch.inference_mode():
        for bk in KEY_TILES:
            for variant in VARIANTS:
                row(f"attn_v2 {variant}, key tile {bk}",
                    lambda variant=variant, bk=bk: attn_v2(qkv, sp, variant, bk),
                    "probe_attention_kernel")
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(0))  # (B, T, H, D) views
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
        mask = (torch.arange(t, device=dev) >= n_valid)[None].expand(b, -1).contiguous()
        row("#1 alibi_flash_attention_serve, padding mask",
            lambda: alibi_flash_attention_serve(q, k, v, slopes, pos, mask), "alibi_fwd_kernel")
        bias = -(sp[0][:, :, None] - sp[0][:, None, :]).abs().to(torch.bfloat16)[None]
        qs, ks, vs = qkv.unbind(0)
        row("SDPA, the bias as a float mask",
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias), "")
    return rows


def main() -> int:
    if not require_cuda("probes.kernels"):
        return 1
    print(card_line())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    check(dev)
    sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
