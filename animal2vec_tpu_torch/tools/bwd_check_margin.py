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

With ``--elements N``, each moved copy whose dv fails is taken apart per
element (``explain_dv``): for up to N failing dv elements (b, h, key, d),
the kernel's and the plain version's dv, and for the query rows that
dominate the difference, bf16(P·f) as the kernel rounds it (read through
the kernel itself: dv of a one-hot dO is bf16(P·f) of one query row, exactly)
and as the plain version rounds it, beside the logit q·k/8 - slope·dist
recomputed from the same bf16 q and k in fp64, in fp32 by torch's matmul
(the plain version's), in fp32 summed one product at a time, and in fp32
per 16-, 8- or 4-wide slice of D (each slice's products summed exactly
with the running sum, then rounded to fp32: to nearest, or toward zero as
a tensor core's truncating accumulator would); and over every (query, key)
pair of the (b, h) that hold a failing element, how many of the kernel's
bf16(P·f) differ from the plain version's and which of the logits
reproduces each of them.

    python3 -m animal2vec_tpu_torch.tools.bwd_check_margin [--other-root DIR] [--moves 23]
        [--elements 12]
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


def lse_move_ratios(args, moves: int, seed: int = 7, on_dv_fail=None):
    """The worst ratios to BWD_TOL of the dk/dv kernel's dk and dv against
    ``attention_bwd_plain`` on ``args`` (``attention_dkv``'s, the forward's
    lse third), first on that lse, then on ``moves`` copies of it with every
    value moved one ulp up or down at random (seeded): [(dk, dv), ...].
    ``on_dv_fail(k, moved_args, dv, plain_dv)`` is called for each copy k
    whose dv exceeds the tolerance."""
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
        if on_dv_fail is not None and ratios[-1][1] > 1:
            on_dv_fail(k, moved_args, dv, want[2])
        del want
    return ratios


def kernel_pf(args, pairs):
    """The dk/dv kernel's bf16(P·f) (len(pairs), T queries, T keys) as fp32
    for the (b, h) in ``pairs``, read through its dv: with dO one-hot at
    query row r0 + c in column c, dv[b, h, key, c] is that row's bf16(P·f)
    times 1, summed with zeros."""
    from animal2vec_tpu_torch.ops.attention import attention_dkv

    qkv, dout = args[:2]
    b, h, t, d = dout.shape
    out = torch.empty((len(pairs), t, t), device=dout.device)
    bi, hi = (torch.tensor(x, device=dout.device) for x in zip(*pairs))
    for r0 in range(0, t, d):
        rows = min(d, t - r0)
        probe = torch.zeros_like(dout)
        c = torch.arange(rows, device=dout.device)
        probe[:, :, r0 + c, c] = 1.0
        _, dv = attention_dkv(qkv, probe, *args[2:])
        out[:, r0:r0 + rows] = dv[bi, hi, :, :rows].float().transpose(1, 2)
    return out


def _toward_zero(exact: torch.Tensor) -> torch.Tensor:
    """fp64 values rounded to fp32 toward zero."""
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def logit_variants(qkv, slopes, pos, plain_logits, pairs):
    """{name: (len(pairs), T, T) logits} of the (b, h) in ``pairs`` from
    the same bf16 q and k: fp64 (float64), and fp32 in these orders: torch's
    matmul (the plain version's, cut from its batched call), one product at
    a time, and per slice of D (16, 8 or 4 wide): the running sum plus the
    slice's products, exact, rounded to nearest or toward zero."""
    bi, hi = (torch.tensor(x, device=qkv.device) for x in zip(*pairs))
    q, k = qkv[0, bi, hi].double(), qkv[1, bi, hi].double()  # (n, T, D), exact
    p = pos[bi if pos.shape[0] > 1 else torch.zeros_like(bi)].float()
    bias = -(p[:, :, None] - p[:, None, :]).abs() * slopes.float()[hi][:, None, None]
    s64 = torch.matmul(q, k.transpose(1, 2))
    q32, k32 = q.float(), k.float()
    seq = torch.zeros_like(s64, dtype=torch.float32)
    for c in range(q.shape[-1]):  # each bf16 x bf16 product is exact in fp32
        seq = seq + q32[:, :, c, None] * k32[:, None, :, c]
    scale = q.shape[-1] ** -0.5  # a power of 2: the scaling is exact
    out = {
        "fp64": s64 * scale + bias.double(),
        "fp32 torch": plain_logits[bi, hi],
        "fp32 one by one": seq * scale + bias,
    }
    for width in (16, 8, 4):
        for name, rnd in (("nearest", lambda x: x.float()), ("toward 0", _toward_zero)):
            acc = torch.zeros_like(seq)
            for c in range(0, q.shape[-1], width):
                part = torch.matmul(q[..., c:c + width], k[..., c:c + width].transpose(1, 2))
                acc = rnd(acc.double() + part)
            out[f"fp32 per k{width} {name}"] = acc * scale + bias
    return out


def pf_agreement(args, pairs, label: str):
    """For the (b, h) in ``pairs``: the kernel's bf16(P·f), the plain
    version's, the one from each logit of ``logit_variants``, and the
    fp64/fp32 logits; prints how many of the kernel's values differ from the
    plain version's and which logit reproduces them. Returns (kernel,
    {logit: bf16(P·f)}, {logit: logits}, lse, f), each (len(pairs), T, T)."""
    from animal2vec_tpu_torch.ops.attention import _keep_factor, _scores

    qkv, dout, lse, _, slopes, pos, mask, sentinel, rate, seed = args
    b, h, t, d = dout.shape
    bi, hi = (torch.tensor(x, device=qkv.device) for x in zip(*pairs))
    pf_k = kernel_pf(args, pairs)
    logits, _ = _scores(qkv, slopes, pos, mask, sentinel)
    lse_p = lse.reshape(b, h, t)[bi, hi][..., None]
    f = (_keep_factor(b, h, t, rate, seed, qkv.device) if rate > 0.0
         else torch.ones((b, h, t, t), device=qkv.device))[bi, hi]
    variants = logit_variants(qkv, slopes, pos, logits, pairs)
    del logits
    pf = {name: (torch.exp((lg.float() - lse_p)) * f).to(torch.bfloat16).float()
          for name, lg in variants.items()}
    diff = pf_k != pf["fp32 torch"]  # the plain version's bf16(P·f)
    counts = {name: int((diff & (pf_k == v)).sum()) for name, v in pf.items()}
    none = int((diff & torch.stack([pf_k != v for v in pf.values()]).all(0)).sum())
    print(f"    {label}: over {pf_k.numel()} (query, key) pairs, {int(diff.sum())} kernel "
          f"bf16(P·f) differ from the plain version's; of those, equal to the one from the "
          f"logit in " + ", ".join(f"{n} {c}" for n, c in counts.items())
          + f"; equal to none {none}. The kernel's equal to the one from each logit over all "
          f"pairs: " + ", ".join(f"{n} {int((pf_k == v).sum())}" for n, v in pf.items()),
          flush=True)
    return pf_k, pf, variants, lse_p, f


def explain_dv(k, args, dv, want, max_elements):
    """Per-element report of copy k's failing dv elements (``--elements``)."""
    dout = args[1]
    atol, rtol = BWD_TOL
    r = (dv.float() - want.float()).abs() / (atol + rtol * want.float().abs())
    fails = (r > 1).nonzero().tolist()
    pairs = sorted({(e[0], e[1]) for e in fails})
    slot = {pr: n for n, pr in enumerate(pairs)}
    print(f"  copy {k}: {len(fails)} dv elements over the tolerance in {len(pairs)} (b, h)",
          flush=True)
    pf_k, pf, variants, lse_p, f = pf_agreement(args, pairs, "the (b, h) of these elements")
    pf_p = pf["fp32 torch"]
    do = dout.float()
    for e in fails[:max_elements]:
        bb, hh, j, c = e
        n = slot[(bb, hh)]
        contrib = (pf_k[n, :, j] - pf_p[n, :, j]) * do[bb, hh, :, c]
        rows = contrib.abs().argsort(descending=True)[:3].tolist()
        print(f"    (b {bb}, h {hh}, key {j}, d {c}): kernel dv {dv[bb, hh, j, c].item():.6g}, "
              f"plain dv {want[bb, hh, j, c].item():.6g}, ratio {r[bb, hh, j, c].item():.3f}; "
              f"sum over rows of the bf16(P·f) differences x dO {contrib.sum().item():.6g}",
              flush=True)
        for i in rows:
            if contrib[i] == 0:
                break
            lg = ", ".join(f"{name} {variants[name][n, i, j].item():.17g}" for name in variants)
            pfs = ", ".join(f"{name} {pf[name][n, i, j].item():.9g}" for name in pf)
            pf32 = torch.exp(variants["fp32 torch"][n, i, j].float() - lse_p[n, i, 0]) * f[n, i, j]
            print(f"      query {i}: dO {do[bb, hh, i, c].item():.6g}; bf16(P·f) kernel "
                  f"{pf_k[n, i, j].item():.9g}, from the logit in {pfs}; P·f in fp32 from the "
                  f"plain logit {pf32.item():.9g}; logit {lg}; lse {lse_p[n, i, 0].item():.9g}",
                  flush=True)


def measure(label: str, moves: int, save: str, elements: int = 0) -> None:
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
        report = None
        if elements and t <= 256:  # every (b, h) on the forward's own lse
            pf_agreement((qkv, dout, lse, delta, slopes, pos, mask, False, *drop),
                         [(x, y) for x in range(b) for y in range(h)], f"{what}, every (b, h)")
        if elements:
            def report(k, args, dv, want):
                explain_dv(k, args, dv, want, elements)
        ratios = lse_move_ratios((qkv, dout, lse, delta, slopes, pos, mask, False, *drop), moves,
                                 on_dv_fail=report)
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
    parser.add_argument("--elements", type=int, default=0,
                        help="failing dv elements of each failing moved copy to take apart")
    parser.add_argument("--root", help=argparse.SUPPRESS)  # one tree, in this process
    parser.add_argument("--label", default="this", help=argparse.SUPPRESS)
    parser.add_argument("--save", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bwd_check_margin: needs a CUDA card")
    if args.root:
        sys.path.insert(0, args.root)
        measure(args.label, args.moves, args.save, args.elements)
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
                            "--label", label, "--moves", str(args.moves), "--elements",
                            str(args.elements), "--save",
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
