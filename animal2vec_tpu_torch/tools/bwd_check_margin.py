"""How close the ALiBi backward's checks in ``chip_smoke.py`` phases 3b and
3e sit to their tolerance, and how they move when the forward's lse moves
by one ulp.

For the checkout's forward (#2 with lse and dropout) at phase 3b's inputs
(b4, H 16, T 2000, dropout 0.2, row 1 padding its last 300 keys) and at
phase 3e's (b60, T 125 at per-row keep-set positions, dropout 0.1), the
dk/dv kernel (#4) and its plain version ``attention_bwd_plain`` run on that
lse and on ``--moves`` copies of it with every value moved one ulp up or
down at random (seeded); printed: the worst ratio of |kernel - plain| to
phase 3b's tolerance 5e-3 + 1e-2 |plain| for dk and for dv, and how many of
the moved copies exceed 1. With ``--other-root``, the same for another
checkout (for example an archive of the parent commit) in its own process
first, then the share of the forward's out and lse values that are bit for
bit the other tree's. Prints the card's name and power limit.
``chip_smoke.py`` phases 3b and 3e print the same margin over 8 moves
(``lse_move_ratios``).

    python3 -m animal2vec_tpu_torch.tools.bwd_check_margin [--other-root DIR] [--moves 23]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

THIS_ROOT = Path(__file__).resolve().parents[2]
BWD_TOL = (5e-3, 1e-2)  # chip_smoke.py's atol, rtol of dq, dk and dv


def inputs(dev):
    """(label, qkv, slopes, positions, mask, dout, (rate, seed)) of phases 3b
    and 3e, made as chip_smoke.py makes them."""
    from animal2vec_tpu_torch.ops.alibi import alibi_slopes

    slopes = torch.from_numpy(alibi_slopes(16).copy()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    qkv = torch.randn((3, 4, 16, 2000, 64), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(2000, dtype=torch.int32, device=dev)[None]
    mask = torch.zeros((4, 2000), dtype=torch.bool, device=dev)
    mask[1, -300:] = True
    dout = torch.randn((4, 16, 2000, 64), generator=gen, device=dev).to(torch.bfloat16)
    yield "b4 T 2000, dropout 0.2", qkv, slopes, pos, mask, dout, (0.2, -123457)
    del qkv, dout
    gen = torch.Generator(device=dev).manual_seed(13)
    qkv = torch.randn((3, 60, 16, 125, 64), generator=gen, device=dev).to(torch.bfloat16)
    rng = np.random.default_rng(13)
    pos = torch.from_numpy(np.stack([np.sort(rng.choice(2000, 125, replace=False))
                                     for _ in range(60)]).astype(np.int32)).to(dev)
    dout = torch.randn((60, 16, 125, 64), generator=gen, device=dev).to(torch.bfloat16)
    yield "b60 T 125 keep-set, dropout 0.1", qkv, slopes, pos, None, dout, (0.1, -123456)


def ratio(got, want) -> float:
    atol, rtol = BWD_TOL
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def lse_move_ratios(args, moves: int, seed: int = 7):
    """The worst ratios to BWD_TOL of the dk/dv kernel's dk and dv against
    ``attention_bwd_plain`` on ``args`` (``attention_dkv``'s, the forward's
    lse third), first on that lse, then on ``moves`` copies of it with every
    value moved one ulp up or down at random (seeded): [(dk, dv), ...]."""
    from animal2vec_tpu_torch.ops.attention import attention_bwd_plain, attention_dkv

    lse = args[2]
    gen = torch.Generator(device=lse.device).manual_seed(seed)
    ratios = []
    for k in range(moves + 1):
        moved = lse
        if k:
            up = torch.rand(lse.shape, generator=gen, device=lse.device) < 0.5
            moved = torch.nextafter(lse, torch.where(up, float("inf"), float("-inf")))
        moved_args = args[:2] + (moved,) + args[3:]
        dk, dv = attention_dkv(*moved_args)
        want, _ = attention_bwd_plain(*moved_args)
        ratios.append((ratio(dk, want[1]), ratio(dv, want[2])))
        del want
    return ratios


def measure(label: str, moves: int, save: str) -> None:
    """The margins of the package importable from sys.path; its forward's
    out and lse saved to ``save``."""
    from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_packed

    dev = torch.device("cuda", 0)
    saved = {}
    for what, qkv, slopes, pos, mask, dout, drop in inputs(dev):
        b, h, t = qkv.shape[1:4]
        out, lse = alibi_flash_attention_packed(qkv, slopes, pos, mask, False, *drop,
                                                return_lse=True)
        saved[what] = (out.cpu(), lse.cpu())
        delta = (dout.float() * out.float()).sum(-1).reshape(b * h, t)
        ratios = lse_move_ratios((qkv, dout, lse, delta, slopes, pos, mask, False, *drop), moves)
        for name, col in (("dk", 0), ("dv", 1)):
            r = [x[col] for x in ratios]
            print(f"{label} {what} {name}: worst ratio {r[0]:.3f} on the forward's lse; over "
                  f"{moves} one-ulp moves max {max(r[1:]):.3f}, median "
                  f"{float(np.median(r[1:])):.3f}, {sum(x > 1 for x in r[1:])} over 1",
                  flush=True)
        del qkv, dout
        torch.cuda.empty_cache()
    torch.save(saved, save)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other-root", help="another checkout's root, measured first")
    parser.add_argument("--moves", type=int, default=23, help="moved copies of the lse")
    parser.add_argument("--root", help=argparse.SUPPRESS)  # one tree, in this process
    parser.add_argument("--label", default="this", help=argparse.SUPPRESS)
    parser.add_argument("--save", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bwd_check_margin: needs a CUDA card")
    if args.root:
        sys.path.insert(0, args.root)
        measure(args.label, args.moves, args.save)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    roots = {"this": str(THIS_ROOT)}
    if args.other_root:
        roots = {"other": str(Path(args.other_root).resolve()), **roots}
    with tempfile.TemporaryDirectory() as tmp:
        for label, root in roots.items():
            subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root", root,
                            "--label", label, "--moves", str(args.moves), "--save",
                            f"{tmp}/{label}.pt"], check=True, cwd=root)
        if not args.other_root:
            return
        this, other = (torch.load(f"{tmp}/{label}.pt") for label in ("this", "other"))
        for what, (out, lse) in this.items():
            out_o, lse_o = other[what]
            print(f"{what}: out {(out == out_o).float().mean().item():.4f}, lse "
                  f"{(lse == lse_o).float().mean().item():.4f} of the values bit for bit the "
                  f"other tree's", flush=True)


if __name__ == "__main__":
    main()
