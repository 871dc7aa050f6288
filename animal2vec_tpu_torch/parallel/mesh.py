"""Data parallelism over ``torch.distributed``: the port of the "data" axis
of ``animal2vec_tpu/parallel/mesh.py``.

JAX lays one jitted step over a ("data", "model") mesh and lets XLA insert
the gradient reduction. The port runs one process per card (rank r on
``cuda:<local rank>``, or on the CPU when the caller asks for the CPU) in
one process group, and a ``DataParallel`` holds what a rank needs: its
rank and the world size, its device, the group for device tensors, a gloo
group for host tensors, and a 1-D ("data",) ``DeviceMesh`` over the group.

* ``data_parallel`` -1 means every visible card (one rank on the CPU). A
  larger count than the visible cards raises under NCCL, as JAX's
  ``build_mesh`` raises, since NCCL refuses two ranks on one card; gloo
  may put several ranks on one card (rank r on ``cuda:r mod cards``), the
  one way a single card runs a real rank split.
* The backend is explicit: NCCL on cards and gloo on the CPU by default,
  gloo on cards when asked for by name. Nothing picks another backend or
  the CPU on its own.
* Gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` only, so
  every collective on a device tensor here is one of those two, and the
  uneven gathers (validation predictions, loader states) run on host
  tensors in the gloo host group, which NCCL runs need as well.

``launch`` starts ``world`` ranks of a Python module on this host with the
environment ``torchrun`` gives (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT: a local TCP store), and ``init_data_parallel`` joins the group
such an environment describes, or makes a group of one without it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from animal2vec_tpu_torch.config import DistributedConfig

BACKENDS = ("nccl", "gloo")
# the mean (not the sum) over ranks of these step metrics: per-rank
# statistics, not shares of a global sum
MEAN_METRICS = ("target_var", "pred_var", "masked_pct", "ema_decay")
_BUCKET = 1 << 26  # elements of one gradient all-reduce (256 MB of fp32)
_TIMEOUT = datetime.timedelta(minutes=30)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def resolve_world(cfg: DistributedConfig, device, backend: str) -> int:
    """The rank count of ``cfg.data_parallel`` on ``device``'s type."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device.type == "cpu":
        if backend != "gloo":
            raise ValueError("ranks on the CPU run the gloo backend")
        return 1 if cfg.data_parallel == -1 else cfg.data_parallel
    if device.type != "cuda":
        raise ValueError(f"data parallelism runs on cuda or cpu, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if cfg.data_parallel == -1:
        return cards
    if backend == "nccl" and cfg.data_parallel > cards:
        raise ValueError(
            f"distributed.data_parallel={cfg.data_parallel} needs {cfg.data_parallel} cards but "
            f"{cards} are visible (NCCL takes one rank a card; gloo may share a card)")
    return cfg.data_parallel


def _rank_device(device, local_rank: int, backend: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= cards:
        raise ValueError(f"local rank {local_rank} has no card of its own ({cards} visible)")
    return torch.device("cuda", local_rank % cards)


@dataclasses.dataclass
class DataParallel:
    """One rank's view of the data-parallel group. The default, a rank 0
    of one with no group, makes every collective a no-op."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[dist.ProcessGroup] = None       # device tensors (NCCL or gloo)
    host_group: Optional[dist.ProcessGroup] = None  # host tensors (gloo)
    mesh: object = None                             # the 1-D ("data",) DeviceMesh
    owns_group: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def close(self) -> None:
        """Destroy the process group if ``init_data_parallel`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.host_group = self.mesh = None

    # -- collectives ---------------------------------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks of a tensor on this rank's device."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def host_sum(self, values: Sequence[float]) -> List[float]:
        """The sums over the ranks of a few host numbers (fp64)."""
        t = torch.tensor(list(values), dtype=torch.float64)
        if self.world > 1:
            dist.all_reduce(t, group=self.host_group)
        return t.tolist()

    def host_min(self, value: int) -> int:
        """The least of the ranks' ``value``."""
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.host_group)
        return int(t)

    def any(self, flag: bool) -> bool:
        """Whether any rank's ``flag`` is set."""
        return self.host_sum([float(flag)])[0] > 0 if self.world > 1 else bool(flag)

    def row_offset(self, rows: int) -> int:
        """This rank's first row of the global batch that stacks every
        rank's ``rows`` in rank order."""
        if self.world == 1:
            return 0
        one_hot = [0.0] * self.world
        one_hot[self.rank] = float(rows)
        return int(sum(self.host_sum(one_hot)[: self.rank]))

    def all_gather_object(self, obj) -> list:
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.host_group)

    def reduce_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Sum every parameter's gradient over the ranks (a missing one is a
        zero tensor, as the optimizer takes it), in flat buckets of at most
        ``_BUCKET`` elements per dtype and device."""
        if self.world == 1:
            return
        buckets: Dict[tuple, List[List[torch.nn.Parameter]]] = {}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            key = (p.grad.dtype, p.grad.device)
            groups = buckets.setdefault(key, [[]])
            if groups[-1] and sum(q.numel() for q in groups[-1]) + p.numel() > _BUCKET:
                groups.append([])
            groups[-1].append(p)
        for groups in buckets.values():
            for ps in groups:
                flat = torch.cat([p.grad.reshape(-1) for p in ps])
                dist.all_reduce(flat, group=self.group)
                for p, g in zip(ps, flat.split([p.numel() for p in ps])):
                    p.grad.copy_(g.view_as(p.grad))

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A step's scalar metrics over the ranks, in one all-reduce: the
        sum of shares and counts, the mean of ``MEAN_METRICS``."""
        if self.world == 1:
            return metrics
        keys = sorted(metrics)
        vec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).to(self.device)
                           .reshape(()) for k in keys])
        dist.all_reduce(vec, group=self.group)
        return {k: v / self.world if k.startswith(MEAN_METRICS) else v
                for k, v in zip(keys, vec.unbind(0))}

    def allgather_uneven(self, x: Optional[np.ndarray], dtype) -> Optional[np.ndarray]:
        """Every rank's (B_r, T_r, C) host array stacked in rank order, B_r
        possibly 0 (None), the trailing shapes right-padded with zeros to the
        largest (JAX ``loop._allgather_uneven``); a rank of one returns
        ``x``."""
        if self.world == 1:
            return x
        local = np.zeros((0, 0, 0), dtype) if x is None else np.asarray(x, dtype)
        meta = torch.tensor(list(local.shape), dtype=torch.int64)
        metas = [torch.zeros_like(meta) for _ in range(self.world)]
        dist.all_gather(metas, meta, group=self.host_group)
        metas = torch.stack(metas).numpy()
        n, t, c = (int(v) for v in metas.max(0))
        if n == 0:
            return None
        padded = np.zeros((n, t, c), dtype)
        padded[: local.shape[0], : local.shape[1], : local.shape[2]] = local
        parts = [torch.zeros((n, t, c), dtype=torch.from_numpy(padded).dtype)
                 for _ in range(self.world)]
        dist.all_gather(parts, torch.from_numpy(padded), group=self.host_group)
        return np.concatenate([p.numpy()[: int(m[0])] for p, m in zip(parts, metas)], 0)


def from_env() -> bool:
    """Whether the environment describes a process group (``torchrun``'s or
    ``launch``'s)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_data_parallel(device="cuda", backend: Optional[str] = None) -> DataParallel:
    """Join the process group the environment describes (``torchrun``'s,
    or ``launch``'s: RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), or make a group of one over an in-memory store; put this
    rank on ``cuda:<local rank>`` (``device`` "cuda") or the CPU."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device.type == "cpu" and backend != "gloo":
        raise ValueError("ranks on the CPU run the gloo backend")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    if from_env():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        rank, world, local_rank = 0, 1, 0
    dev = _rank_device(device, local_rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world, timeout=_TIMEOUT)
    if backend == "nccl":
        kw["device_id"] = dev
    if from_env():
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), **kw)
    group = dist.group.WORLD
    host_group = group if backend == "gloo" else dist.new_group(backend="gloo")
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group(group, dev.type, mesh_dim_names=("data",))
    return DataParallel(rank, world, dev, group, host_group, mesh, owns_group=True)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], world: int, env: Optional[Dict[str, str]] = None,
           timeout: Optional[float] = None) -> None:
    """Run ``python <argv>`` as ``world`` ranks on this host with the
    environment ``torchrun`` gives; wait for all of them. If one fails (or
    the ``timeout`` in seconds passes) the others are stopped and this
    raises."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(p for p in (root, base.get("PYTHONPATH", "")) if p)
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, *argv],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {procs.index(bad[0])} exited with {bad[0].returncode}"
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = f"the ranks ran past {timeout} s"
                break
            time.sleep(0.05)
        else:
            codes = [p.returncode for p in procs]
            if any(codes):
                failed = f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"{' '.join(argv)}: {failed}")
