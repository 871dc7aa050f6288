"""The device mesh over ``torch.distributed``: the port of
``animal2vec_tpu/parallel/mesh.py``'s ("data", "stage", "model") mesh.

JAX lays one jitted step over the mesh and lets XLA insert the gradient
reduction and the shardings' collectives. The port runs one process per
card (rank r on ``cuda:<local rank>``, or on the CPU when the caller asks
for the CPU) in one process group, and a ``DataParallel`` holds what a rank
needs: its coordinate and size on the "data" axis (``rank``, ``world``),
its device, the data axis' group for device tensors and a gloo group for
host tensors, a 1-D ("data",) ``DeviceMesh`` over it (FSDP2's), and, when
``DistributedConfig`` asks for more than data parallelism, the "stage" and
"model" axes (``Axis``: coordinate, size and groups), the FSDP flag and the
whole group (``global_rank``, ``global_world``). ``mesh_sizes`` is JAX's
``build_mesh`` arithmetic: "model" innermost, "data" outermost, data -1
takes the ranks left after stage x model, and a mesh larger than the ranks
raises. What runs on the axes lives in ``parallel/layout.py`` (the
partition plan, FSDP2, checkpoints), ``parallel/tensor.py`` (Megatron
tensor parallelism) and ``parallel/pipeline.py`` (the GPipe trunk).

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
* Data-axis collectives (the losses' counts, the gradients of replicated
  parameters, the metrics, the loader states, validation's gathers) run
  over "data"; the agreed stops and the barriers over every rank.

``launch`` starts ``world`` ranks of a Python module on this host with the
environment ``torchrun`` gives (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT: a local TCP store), and ``init_data_parallel`` joins the group
such an environment describes, or makes a group of one without it, and
lays a ``DistributedConfig``'s mesh over it (``layout``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


def mesh_sizes(cfg: DistributedConfig, ranks: int) -> Tuple[int, int, int]:
    """(data, stage, model) of ``cfg`` over ``ranks`` ranks (JAX
    ``build_mesh``): data -1 takes ``ranks // (stage * model)``; a mesh
    larger than the ranks raises, and so does one that leaves ranks out."""
    mp, pp = cfg.model_parallel, cfg.pipeline_parallel
    dp = ranks // (mp * pp) if cfg.data_parallel == -1 else cfg.data_parallel
    if dp < 1 or dp * pp * mp != ranks:
        raise ValueError(f"mesh data={dp} x stage={pp} x model={mp} needs {max(dp, 1) * pp * mp} "
                         f"ranks, the group has {ranks}")
    return dp, pp, mp


def resolve_world(cfg: DistributedConfig, device, backend: str) -> int:
    """The rank count of ``cfg``'s mesh (data x stage x model) on
    ``device``'s type: data -1 is every visible card left after stage x
    model (one data rank on the CPU)."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    inner = cfg.model_parallel * cfg.pipeline_parallel
    if device.type == "cpu":
        if backend != "gloo":
            raise ValueError("ranks on the CPU run the gloo backend")
        return (1 if cfg.data_parallel == -1 else cfg.data_parallel) * inner
    if device.type != "cuda":
        raise ValueError(f"data parallelism runs on cuda or cpu, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if cfg.data_parallel == -1:
        if cards < inner:
            raise ValueError(f"stage x model = {inner} needs {inner} cards but {cards} are "
                             "visible (give distributed.data_parallel and --dist-backend gloo "
                             "to share a card)")
        return cards // inner * inner
    world = cfg.data_parallel * inner
    if backend == "nccl" and world > cards:
        raise ValueError(
            f"distributed data_parallel x pipeline_parallel x model_parallel = {world} needs "
            f"{world} cards but {cards} are visible (NCCL takes one rank a card; gloo may share "
            "a card)")
    return world


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
class Axis:
    """A rank's coordinate on one mesh axis, the axis' size and the groups
    of the ranks that differ from it only there (device and host tensors);
    a size of 1 has no group."""

    rank: int = 0
    size: int = 1
    group: Optional[dist.ProcessGroup] = None
    host_group: Optional[dist.ProcessGroup] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the axis of a tensor on this rank's device."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass
class DataParallel:
    """One rank's view of the mesh: its data-parallel group (``rank``,
    ``world``, ``group``, ``host_group``, ``mesh``) and, for a sharded
    layout, its "stage" and "model" axes, FSDP, and the whole group. The
    default, a rank 0 of one with no group, makes every collective a
    no-op."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[dist.ProcessGroup] = None       # device tensors (NCCL or gloo)
    host_group: Optional[dist.ProcessGroup] = None  # host tensors (gloo)
    mesh: object = None                             # the 1-D ("data",) DeviceMesh
    owns_group: bool = False
    stage: Axis = dataclasses.field(default_factory=Axis)
    model: Axis = dataclasses.field(default_factory=Axis)
    fsdp: bool = False
    global_rank: int = 0
    global_world: int = 1
    world_group: Optional[dist.ProcessGroup] = None       # every rank, device tensors
    world_host_group: Optional[dist.ProcessGroup] = None  # every rank, host tensors
    backend: str = "gloo"

    @property
    def is_main(self) -> bool:
        return self.global_rank == 0

    @property
    def sharded(self) -> bool:
        """Whether parameters are split over ranks (stage, model or FSDP)."""
        return self.stage.size > 1 or self.model.size > 1 or self.fsdp

    def close(self) -> None:
        """Destroy the process group if ``init_data_parallel`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.host_group = self.mesh = None
        self.world_group = self.world_host_group = None
        self.stage, self.model = Axis(), Axis()

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
        """The least of every rank's ``value``."""
        if self.global_world == 1:
            return value
        t = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.world_host_group)
        return int(t)

    def any(self, flag: bool) -> bool:
        """Whether any rank's ``flag`` is set."""
        if self.global_world == 1:
            return bool(flag)
        t = torch.tensor([float(flag)], dtype=torch.float64)
        dist.all_reduce(t, group=self.world_host_group)
        return float(t) > 0

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
        if self.global_world > 1:
            dist.barrier(group=self.world_host_group)

    def reduce_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Sum every parameter's gradient over the data ranks (a missing one
        is a zero tensor, as the optimizer takes it), in flat buckets of at
        most ``_BUCKET`` elements per dtype and device. FSDP's parameters
        (DTensors) are skipped: their gradients are reduce-scattered
        already."""
        from torch.distributed.tensor import DTensor

        if self.world == 1:
            return
        buckets: Dict[tuple, List[List[torch.nn.Parameter]]] = {}
        for p in params:
            if isinstance(p, DTensor):
                continue
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


def init_data_parallel(device="cuda", backend: Optional[str] = None,
                       cfg: Optional[DistributedConfig] = None) -> DataParallel:
    """Join the process group the environment describes (``torchrun``'s,
    or ``launch``'s: RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), or make a group of one over an in-memory store; put this
    rank on ``cuda:<local rank>`` (``device`` "cuda") or the CPU; with a
    ``cfg`` that shards, lay its mesh over the group (``layout``)."""
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
    dp = DataParallel(rank, world, dev, group, host_group, mesh, owns_group=True,
                      global_rank=rank, global_world=world, world_group=group,
                      world_host_group=host_group, backend=backend)
    if cfg is None or not (cfg.model_parallel > 1 or cfg.pipeline_parallel > 1 or cfg.fsdp):
        if cfg is not None:
            mesh_sizes(cfg, world)
        return dp
    return layout(dp, cfg, owns_group=True)


def layout(base: DataParallel, cfg: DistributedConfig, owns_group: bool = False
           ) -> DataParallel:
    """This rank's view of ``cfg``'s (data, stage, model) mesh over the whole
    group of ``base`` (``init_data_parallel``'s): global rank r sits at
    data r // (stage x model), stage (r // model) % stage, model r % model.
    Every rank makes every axis' groups (``dist.new_group`` is collective);
    without stage and model axes the data axis is the whole group."""
    dp, pp, mp = mesh_sizes(cfg, base.global_world)
    r = base.global_rank
    coords = (r // (pp * mp), (r // mp) % pp, r % mp)
    axes = {}
    if pp * mp == 1:
        axes["data"] = Axis(r, dp, base.world_group, base.world_host_group)
    else:
        grid = np.arange(dp * pp * mp).reshape(dp, pp, mp)
        for i, name in enumerate(("data", "stage", "model")):
            for line in np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]):
                ranks = [int(v) for v in line]
                group = dist.new_group(ranks)
                host = group if base.backend == "gloo" else dist.new_group(ranks, backend="gloo")
                if r in ranks:
                    axes[name] = Axis(coords[i], len(ranks), group, host)
    from torch.distributed.device_mesh import DeviceMesh

    data = axes["data"]
    return DataParallel(
        data.rank, data.size, base.device, data.group, data.host_group,
        DeviceMesh.from_group(data.group, base.device.type, mesh_dim_names=("data",)),
        owns_group=owns_group, stage=axes.get("stage", Axis()),
        model=axes.get("model", Axis()), fsdp=cfg.fsdp, global_rank=r,
        global_world=base.global_world, world_group=base.world_group,
        world_host_group=base.world_host_group, backend=base.backend)


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
