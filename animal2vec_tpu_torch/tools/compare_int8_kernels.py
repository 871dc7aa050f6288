"""Time int8 serving's block (#7, ``fused_block_int8``), plain MLP (#9,
``fused_mlp_int8``) and attention (#5, ``alibi_flash_attention_int8``, its
q/k/v quantization included) of this checkout against another checkout's
(for example an archive of the parent commit), each tree in its own
process, in turns (other, this, this, other).

For each tree: #7 at a2v-large's b32 block (N 64 000, C 1024, M 4096) and
at the ViT-B/16 widths (N 12 544, C 768, M 3072), #9 at the ViT-B/16
widths with a digest of its output's bits (equal in two trees whose
outputs agree bit for bit), #5 at b32, H 16, T 2000 on the (B, T, 3, H, D)
projection's thirds; CUDA events over 10 calls after 2, and the device
time of every kernel of one call (torch.profiler).
With ``--tail``, each tree also holds #7 against its plain version at N
64 000 on three seeded inputs and prints the worst ratio of the error to
the tolerance 3e-2 + 2e-2 |plain| and the count of differing elements, for
the tap t and x_out. The inputs come from seeded generators, so both trees
see the same ones. Prints the card's name and power limit.

    python3 -m animal2vec_tpu_torch.tools.compare_int8_kernels --other-root DIR [--tail]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

THIS_ROOT = Path(__file__).resolve().parents[2]
ORDER = ("other", "this", "this", "other")
BLOCK_SHAPES = ((64_000, 1024, 4096), (12_544, 768, 3072))


def cuda_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time():
    """This checkout's tools/device_time.py, loaded by its path: the package
    on sys.path is the tree being measured, which may predate it."""
    spec = importlib.util.spec_from_file_location(
        "device_time", Path(__file__).resolve().with_name("device_time.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


DEVICE_TIME = device_time()


def device_text(fn) -> str:
    """Device time per call of every kernel fn launches, for a log line."""
    ms = DEVICE_TIME.device_ms(fn)
    return "not measured" if ms is None else f"{ms:.4f} ms"


def block_args(seed: int, n: int, c: int, m: int, dev):
    """fused_block_int8's arguments: bf16 x, nn.Linear-layout int8 weights
    quantized from seeded fp32 ones, fp32 vectors."""
    from animal2vec_tpu_torch.ops.int8_mm import quantize_weight

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, c), generator=g, device=dev).to(torch.bfloat16)
    scale = (2 / (c + m)) ** 0.5
    w1_q, w1_s = quantize_weight(torch.randn((m, c), generator=g, device=dev) * scale)
    w2_q, w2_s = quantize_weight(torch.randn((c, m), generator=g, device=dev) * scale)
    vec = lambda k, shift=0.0: torch.randn((k,), generator=g, device=dev) * 0.1 + shift
    return (x, vec(c, 1.0), vec(c), w1_q, w1_s, vec(m), w2_q, w2_s, vec(c), vec(c, 1.0), vec(c),
            1e-5)


def measure(label: str, tail: bool) -> None:
    """The measurements of the package importable from sys.path."""
    from animal2vec_tpu_torch.kernels.build import library
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes
    from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_int8
    from animal2vec_tpu_torch.ops.fused_mlp import (
        fused_block_int8, fused_block_int8_plain, fused_mlp_int8,
    )

    library()
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        for n, c, m in BLOCK_SHAPES:
            args = block_args(0, n, c, m, dev)
            call = lambda: fused_block_int8(*args)
            print(f"{label} int8 block (N {n}, C {c}, M {m}): {cuda_ms(call):.4f} ms events, "
                  f"{device_text(call)} device", flush=True)
            del args
        n, c, m = BLOCK_SHAPES[1]
        x, _, _, w1_q, w1_s, b1, w2_q, w2_s, b2 = block_args(3, n, c, m, dev)[:9]
        call = lambda: fused_mlp_int8(x, w1_q, w1_s, b1, w2_q, w2_s, b2)
        digest = hashlib.sha256(call().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        print(f"{label} int8 MLP (N {n}, C {c}, M {m}): {cuda_ms(call):.4f} ms events, "
              f"{device_text(call)} device; output digest {digest[:16]}", flush=True)
        g = torch.Generator(device=dev).manual_seed(1)
        qkv = torch.randn((32, 2000, 3, 16, 64), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        slopes = torch.from_numpy(alibi_slopes(16).copy()).to(dev)
        pos = torch.arange(2000, dtype=torch.int32, device=dev)[None]
        call = lambda: alibi_flash_attention_int8(q, k, v, slopes, pos)
        print(f"{label} int8 attention (b32, H 16, T 2000, with its quantization): "
              f"{cuda_ms(call):.4f} ms events, {device_text(call)} device", flush=True)
        del qkv, q, k, v
        if not tail:
            return
        for seed in (0, 1, 2):
            args = block_args(seed, 64_000, 1024, 4096, dev)
            (xo, t), (xo_p, t_p) = fused_block_int8(*args), fused_block_int8_plain(*args)
            torch.cuda.synchronize()
            parts = []
            for name, got, want in (("t", t, t_p), ("x_out", xo, xo_p)):
                err = (got.float() - want.float()).abs()
                ratio = (err / (3e-2 + 2e-2 * want.float().abs())).max().item()
                parts.append(f"{name} worst ratio {ratio:.3f}, max err {err.max().item():.3e}, "
                             f"{(got != want).sum().item()} elements differ")
            print(f"{label} int8 block vs plain, N 64000, seed {seed}: " + "; ".join(parts),
                  flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other-root", help="the other checkout's root")
    parser.add_argument("--tail", action="store_true",
                        help="also hold #7 against its plain version at N 64 000")
    parser.add_argument("--root", help=argparse.SUPPRESS)  # one tree, in this process
    parser.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_int8_kernels: needs a CUDA card")
    if args.root:
        sys.path.insert(0, args.root)
        measure(args.label, args.tail)
        return
    if not args.other_root:
        parser.error("--other-root is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    roots = {"this": str(THIS_ROOT), "other": str(Path(args.other_root).resolve())}
    for label in ORDER:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--root", roots[label], "--label",
               label] + (["--tail"] if args.tail else [])
        subprocess.run(cmd, check=True, cwd=roots[label])


if __name__ == "__main__":
    main()
