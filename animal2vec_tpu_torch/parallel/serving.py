"""Data-parallel serving: one batch shard per device. The port of
``animal2vec_tpu/parallel/serving.py``.

JAX lays each batch out over a 1-D ("data",) mesh and lets GSPMD run the
jitted forward on every chip. The port keeps one replica of the model on
each device, splits each batch into equal row shards, runs each shard on its
own device and gathers the results on the host in row order. Rows are
independent, so no collective runs and the result does not depend on the
device count. The shards are launched one device after the other from one
thread: the launches are asynchronous, so the devices compute at the same
time, and the gather waits for each in turn.

Used by ``tools/infer_cli.py`` and ``tools/export_cli.py`` (their
``--data-parallel``).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def cuda_devices(first: Optional[torch.device] = None) -> List[torch.device]:
    """The visible CUDA devices, ``first`` (a CUDA device) leading."""
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if first is not None and first.type == "cuda":
        first = torch.device("cuda", first.index if first.index is not None else 0)
        devices = [first] + [d for d in devices if d != first]
    return devices


def gather(outputs: Sequence[Any]) -> Any:
    """Per-shard outputs (tensors, or tuples/lists of them, the same
    structure from every shard) -> one host (CPU) result of the same
    structure, rows in shard order."""
    first = outputs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.cpu() for o in outputs])
    return type(first)(gather(parts) for parts in zip(*outputs))


class DataParallelServing:
    """Replicate ``model`` on ``n_devices`` devices; shard batches over them.

    ``n_devices``: how many of ``devices`` to use (None/-1 = all).
    ``devices``: default the visible CUDA devices (the model's own first);
    raises without a card. A caller may pass other devices (CPU devices
    serve several shards in turn). With one device this is plain serving
    on it, with the same numerics, so callers can use it unconditionally.
    """

    def __init__(self, model: torch.nn.Module, n_devices: Optional[int] = None,
                 devices: Optional[Sequence[Any]] = None):
        if devices is None:
            devices = cuda_devices(next(model.parameters()).device)
            if not devices:
                raise RuntimeError("data-parallel serving runs on the CUDA devices and none is "
                                   "visible; pass devices=[...] to serve elsewhere")
        devices = [torch.device(d) for d in devices]
        n = len(devices) if n_devices is None or n_devices < 0 else int(n_devices)
        if n == 0:
            raise ValueError("n_devices=0: pass a positive device count, or -1/None for all "
                             "visible devices")
        if n > len(devices):
            raise ValueError(f"--data-parallel {n} but only {len(devices)} devices are "
                             f"visible ({[str(d) for d in devices[:4]]}...)")
        self.n_devices = n
        self.devices = devices[:n]
        here = next(model.parameters()).device
        self.replicas = [model if d == here else copy.deepcopy(model).to(d)
                         for d in self.devices]

    def round_batch(self, batch_size: int) -> int:
        """Smallest multiple of n_devices >= batch_size (every device must
        hold the same number of rows)."""
        n = self.n_devices
        return max(n, -(-int(batch_size) // n) * n)

    def floor_batch(self, batch_size: int) -> int:
        """Largest device multiple <= batch_size: for user batch sizes that
        are memory caps and must not be exceeded (still at least one row per
        device; below n_devices it has to grow to n)."""
        n = self.n_devices
        return max(n, int(batch_size) // n * n)

    def shard(self, x) -> List[torch.Tensor]:
        """``x`` (numpy or torch, batch first) split into n_devices equal row
        shards, each on its device."""
        x = torch.as_tensor(x)
        if x.shape[0] % self.n_devices:
            raise ValueError(f"batch dim {x.shape[0]} is not divisible by the "
                             f"{self.n_devices}-device data axis; round the batch size with "
                             "round_batch() or pad with pad_and_shard()")
        rows = x.shape[0] // self.n_devices
        return [x[i * rows:(i + 1) * rows].to(d, non_blocking=True)
                for i, d in enumerate(self.devices)]

    def pad_and_shard(self, x) -> Tuple[List[torch.Tensor], int]:
        """Zero-pad the leading dim up to a device multiple, then shard.
        Returns (shards, n_valid): callers drop rows >= n_valid of the
        gathered outputs (the final partial batch of a long file)."""
        x = np.asarray(x)
        n_valid = x.shape[0]
        target = self.round_batch(n_valid)
        if target != n_valid:
            pad = np.zeros((target - n_valid,) + x.shape[1:], dtype=x.dtype)
            x = np.concatenate([x, pad], axis=0)
        return self.shard(x), n_valid

    def map(self, fn: Callable[[torch.nn.Module, torch.Tensor], Any],
            shards: Sequence[torch.Tensor]) -> List[Any]:
        """``fn(replica, shard)`` on every device: the per-shard outputs, on
        their devices."""
        if len(shards) != self.n_devices:
            raise ValueError(f"{len(shards)} shards for {self.n_devices} devices")
        return [fn(m, s) for m, s in zip(self.replicas, shards)]

    def run(self, fn: Callable[[torch.nn.Module, torch.Tensor], Any],
            shards: Sequence[torch.Tensor]) -> Any:
        """``map``, gathered on the host in row order (``gather``)."""
        return gather(self.map(fn, shards))
