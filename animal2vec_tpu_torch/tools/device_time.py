"""Device time of the kernels a call launches, by torch.profiler, from
windows that kept every kernel record.

The card's tracing drops the first kernel records of a profiled window,
more the longer the process has run, and now and then a whole window
(``tools/profiler_windows.py`` shows it). So every window here is
bracketed by runs of spin kernels, and it counts only if its first and
last device records are among them: then none of the kernels between
was lost.
"""

from __future__ import annotations

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKERS = 32  # at each end of a window: it may lose up to 31 and count


def markers():
    """A run of MARKERS spin kernels of about half a microsecond each."""
    for _ in range(MARKERS):
        torch.cuda._sleep(1000)


def complete_records(prof):
    """The device records of a finished ``torch.profiler.profile`` window in
    the order they started, without the markers; None unless its first and
    last records are markers."""
    recs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    if not recs or MARKER not in recs[0].name or MARKER not in recs[-1].name:
        return None
    return [e for e in recs if MARKER not in e.name]


def profile_complete(fn, activities=None, attempts=8):
    """``torch.profiler.profile`` of fn() between the markers, profiled again
    until a window kept every record of fn's kernels; None after
    ``attempts`` windows that lost some."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
            markers()
            fn()
            markers()
            torch.cuda.synchronize()
        if complete_records(prof) is not None:
            return prof
    return None


def device_ms(fn, kernel="", iters=10, attempts=8):
    """Device time per call of the kernels of fn whose name holds ``kernel``
    ("" for every kernel of the call), over ``iters`` calls after one: the
    CUDA-event time of a kernel shorter than its wrapper's host work
    measures the host. None (not measured) when no window was complete. A
    complete window can still lose records between its markers, so one
    without the named kernel is profiled again; a fourth complete window
    without it raises (a name no kernel of fn has; two such windows in a
    row were seen on the card for a kernel that ran). With ``kernel`` ""
    any record counts, so a window with none between its markers lost
    them all: it counts as incomplete."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    missed = 0
    for _ in range(attempts):
        prof = profile_complete(calls, attempts=1)
        if prof is None:
            continue
        us = sum(e.time_range.elapsed_us() for e in complete_records(prof) if kernel in e.name)
        if us > 0:
            return us / iters / 1e3
        if not kernel:
            continue
        missed += 1
        if missed == 4:
            raise AssertionError(f"torch.profiler recorded no kernel named {kernel!r} in four "
                                 f"complete windows")
    print(f"  (device time of {kernel or 'every kernel of the call'!r} not measured: no "
          f"complete window with it in {attempts})", flush=True)
    return None
