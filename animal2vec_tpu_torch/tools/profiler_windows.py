"""Count the kernel records torch.profiler keeps as a process ages.

Every 15 s for ``--seconds``, profiles 8 windows of 10 ``F.linear`` calls
at the ViT-B/16 fc1 shape (12 544 x 768 -> 3072, bf16), each between the
runs of spin-kernel markers of ``tools/device_time.py``, and prints the
process's age, each window's device records kept (markers excluded) with
the markers kept before and after them, and how many windows
``device_time`` counts as complete. Prints the card's name and power
limit.

    python3 -m animal2vec_tpu_torch.tools.profiler_windows [--seconds 100]
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
import torch.nn.functional as F

from animal2vec_tpu_torch.tools.device_time import (
    MARKER, complete_records, markers,
)


def window(fn):
    """One profiled window of 10 calls of fn: "kept (markers before |
    after)", and whether device_time counts it as complete."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        markers()
        for _ in range(10):
            fn()
        markers()
        torch.cuda.synchronize()
    recs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    work = [i for i, e in enumerate(recs) if MARKER not in e.name]
    before = work[0] if work else len(recs)
    after = len(recs) - 1 - work[-1] if work else 0
    return f"{len(work)} ({before}|{after})", complete_records(prof) is not None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seconds", type=float, default=100.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    x = torch.randn((12_544, 768), device=dev).to(torch.bfloat16)
    w = torch.randn((3072, 768), device=dev).to(torch.bfloat16)
    fn = lambda: F.linear(x, w)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        res = [window(fn) for _ in range(8)]
        print(f"age {time.perf_counter() - t0:6.1f} s: records kept "
              f"{', '.join(n for n, _ in res)}; complete windows "
              f"{sum(ok for _, ok in res)} of 8", flush=True)
        if time.perf_counter() - t0 + 15 > args.seconds:
            break
        time.sleep(15)


if __name__ == "__main__":
    main()
