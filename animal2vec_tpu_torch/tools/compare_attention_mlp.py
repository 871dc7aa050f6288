"""Time the ALiBi attention forward (#2 with lse and dropout, and the serving
launch #1), its backward (#3 dq with the slope partials, #4 dk/dv) and the
plain fused MLP (#8) of this checkout against another checkout's (for
example an archive of the parent commit), each tree in its own process, in
turns (other, this, this, other).

For each tree: #2 at the finetune step's b4, H 16, T 2000 (dropout 0.2, row
1 padding its last 300 keys) and at the a2v-large pretraining student's b60
T 125 (per-row keep-set positions, dropout 0.1), #3 and #4 at the same b4
shape on #2's lse, #1 at b32 T 2000 on the (B, T, 3, H, D) projection's
thirds, and #8 at the ViT-B/16 widths (N 12 544, C 768, M 3072); CUDA
events over 10 calls after 2, and the device time of every kernel of one
call (torch.profiler, tools/device_time.py); and a digest of each call's
outputs (#2's out and lse), equal in two trees whose outputs agree bit for
bit. The inputs come from seeded generators, so both trees see the same
ones. With ``--steps``, then each tree's own ``tools/profile_train_step``
(the b4 finetune step), ``tools/profile_forward --modality image
--layer-norm-first --matmul-impl int8`` (the b64 ViT-B/16 pre-LN int8
forward), ``tools/profile_train_step --pretrain image`` (the ViT-B/16
pretraining step) and ``--pretrain audio`` (the a2v-large pretraining
step), in the same turns. Prints the card's name and power limit.

    python3 -m animal2vec_tpu_torch.tools.compare_attention_mlp --other-root DIR [--steps]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

THIS_ROOT = Path(__file__).resolve().parents[2]
ORDER = ("other", "this", "this", "other")
STEPS = (
    ("b4 finetune step", ["animal2vec_tpu_torch.tools.profile_train_step"]),
    ("b64 ViT-B/16 pre-LN int8 forward",
     ["animal2vec_tpu_torch.tools.profile_forward", "--modality", "image",
      "--layer-norm-first", "--matmul-impl", "int8"]),
    ("ViT-B/16 pretrain step",
     ["animal2vec_tpu_torch.tools.profile_train_step", "--pretrain", "image"]),
    ("a2v-large pretrain step",
     ["animal2vec_tpu_torch.tools.profile_train_step", "--pretrain", "audio"]),
)


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
    on sys.path is the tree being measured."""
    spec = importlib.util.spec_from_file_location(
        "device_time", Path(__file__).resolve().with_name("device_time.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


DEVICE_TIME = device_time()


def report(label: str, what: str, fn) -> None:
    """Times of fn, and a digest of the bits of what it returns."""
    ms = DEVICE_TIME.device_ms(fn)
    dev = "not measured" if ms is None else f"{ms:.4f} ms"
    outs = fn()
    digest = hashlib.sha256()
    for x in outs if isinstance(outs, tuple) else (outs,):
        digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    print(f"{label} {what}: {cuda_ms(fn):.4f} ms events, {dev} device; output digest "
          f"{digest.hexdigest()[:16]}", flush=True)


def attention_inputs(seed: int, b: int, t: int, dev, h: int = 16):
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes

    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((3, b, h, t, 64), generator=g, device=dev).to(torch.bfloat16)
    return qkv, torch.from_numpy(alibi_slopes(h).copy()).to(dev)


def measure(label: str) -> None:
    """The measurements of the package importable from sys.path."""
    from animal2vec_tpu_torch.kernels.build import library
    from animal2vec_tpu_torch.ops.attention import (
        alibi_flash_attention_btc, alibi_flash_attention_packed, attention_dkv, attention_dq,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import fused_mlp

    library()
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        qkv, slopes = attention_inputs(0, 4, 2000, dev)
        pos = torch.arange(2000, dtype=torch.int32, device=dev)[None]
        mask = torch.zeros((4, 2000), dtype=torch.bool, device=dev)
        mask[1, -300:] = True
        report(label, "#2 b4 T 2000, lse, dropout 0.2, row 1 padded",
               lambda: alibi_flash_attention_packed(qkv, slopes, pos, mask, False, 0.2, -123457,
                                                    return_lse=True))
        out, lse = alibi_flash_attention_packed(qkv, slopes, pos, mask, False, 0.2, -123457,
                                                return_lse=True)
        dout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(4),
                           device=dev).to(torch.bfloat16)
        delta = (dout.float() * out.float()).sum(-1).reshape(-1, 2000)
        bwd = (qkv, dout, lse, delta, slopes, pos, mask, False, 0.2, -123457)
        report(label, "#3 dq + slope partials, b4 T 2000, dropout 0.2", lambda: attention_dq(*bwd))
        report(label, "#4 dk/dv, b4 T 2000, dropout 0.2", lambda: attention_dkv(*bwd))
        qkv, slopes = attention_inputs(1, 60, 125, dev)
        rng = np.random.default_rng(1)
        pos_s = torch.from_numpy(np.stack([np.sort(rng.choice(2000, 125, replace=False))
                                           for _ in range(60)]).astype(np.int32)).to(dev)
        report(label, "#2 b60 T 125, keep-set positions, lse, dropout 0.1",
               lambda: alibi_flash_attention_packed(qkv, slopes, pos_s, None, False, 0.1,
                                                    -123456, return_lse=True))
        qkv, slopes = attention_inputs(2, 32, 2000, dev)
        qkv_btc = qkv.permute(1, 3, 0, 2, 4).reshape(32, 2000, 3 * 16 * 64)
        report(label, "#1 b32 T 2000, (B, T, 3C) in place",
               lambda: alibi_flash_attention_btc(qkv_btc, 16, slopes, pos))
        del qkv, qkv_btc
        g = torch.Generator(device=dev).manual_seed(3)
        n, c, m = 12_544, 768, 3072
        x = torch.randn((n, c), generator=g, device=dev).to(torch.bfloat16)
        scale = (2 / (c + m)) ** 0.5
        w1 = (torch.randn((m, c), generator=g, device=dev) * scale).to(torch.bfloat16)
        w2 = (torch.randn((c, m), generator=g, device=dev) * scale).to(torch.bfloat16)
        b1 = torch.randn((m,), generator=g, device=dev) * 0.1
        b2 = torch.randn((c,), generator=g, device=dev) * 0.1
        report(label, f"#8 N {n}, C {c}, M {m}", lambda: fused_mlp(x, w1, w2, b1, b2))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other-root", help="the other checkout's root")
    parser.add_argument("--steps", action="store_true",
                        help="also the finetune step, the pre-LN int8 image forward and the "
                             "two pretraining steps of each tree, in turns")
    parser.add_argument("--root", help=argparse.SUPPRESS)  # one tree, in this process
    parser.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_attention_mlp: needs a CUDA card")
    if args.root:
        sys.path.insert(0, args.root)
        measure(args.label)
        return
    if not args.other_root:
        parser.error("--other-root is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    roots = {"this": str(THIS_ROOT), "other": str(Path(args.other_root).resolve())}
    for label in ORDER:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root", roots[label],
                        "--label", label], check=True, cwd=roots[label])
    if not args.steps:
        return
    for what, module in STEPS:
        for label in ORDER:
            print(f"== {label}: {what}", flush=True)
            subprocess.run([sys.executable, "-m", *module], check=True, cwd=roots[label])


if __name__ == "__main__":
    main()
