"""The training loop: the port of ``animal2vec_tpu/train/loop.py``.

Builds the run from a ``RunConfig``, runs the epoch/update loop through the
train step (one ``torch.profiler.record_function("train_step")`` range per
step), logs every ``log_interval`` steps, validates, saves and rotates
checkpoints, resumes from the latest one (model, Adam, EMA, step and the
loader's position), and stops on max_update, the run's time limit, the
schedule's lr floor, patience or representation collapse (pretraining's
variance kill switch, checked on the host at each log).

A run is one process on one device (``device``: the card unless the
caller asks for the CPU), or, given a ``parallel.mesh.DataParallel``
``dp``, one rank of a group laid out as JAX's mesh ("data", and with
``distributed.model_parallel``, ``pipeline_parallel`` or ``fsdp`` the
"stage" and "model" axes and FSDP, ``parallel/layout.py``; the model and
its state are built whole and then put into the layout): each data rank
loads its shard of every split (host sharding; the ranks of one data
coordinate load the same rows), the steps
reduce the losses' counts, the gradients and the metrics, rank 0 writes
each checkpoint with every rank's loader state while the others wait at a
barrier, a resume restores each rank's own loader state (and raises under
another data-parallel world size; a checkpoint holds whole tensors, so the
other axes may change between runs), validation gathers the uneven per-rank predictions
to every rank before the segmentation metrics, and only rank 0 logs. Every
stop (patience, collapse, the run's limits) is decided on reduced numbers
or agreed, so all ranks stop at the same step and none waits in a
collective. An epoch ends for all ranks when the rank with the fewest
batch groups left has run its last (with length buckets the ranks' counts
differ).

Each start draws its step generators anew from ``common.seed`` + 23
(finetune) or + 17 (pretrain), as the JAX loop restarts its key. Two
things differ from the JAX loop, both about resuming: the final checkpoint
of a finetune run keeps the loader's position, and an epoch cut short by a
stop keeps its number, so a resumed run continues the same epoch where it
stopped. The validation loss is the mean of the per-batch losses over
every rank's batches, so it depends on how the split falls into batches:
under another world size it differs, while the counts and the reports are
the same.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from animal2vec_tpu_torch.config import OptimizationConfig, RunConfig
from animal2vec_tpu_torch.data.dataset import AudioLabelDataset, BatchLoader
from animal2vec_tpu_torch.evalx.reports import log_eval_report
from animal2vec_tpu_torch.evalx.segmentation import (
    intervals_from_binary, segmented_probs_and_targets,
)
from animal2vec_tpu_torch.models.finetune import _on
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.parallel.mesh import DataParallel
from animal2vec_tpu_torch.train.build import init_finetune, init_pretrain
from animal2vec_tpu_torch.train.checkpoint import CheckpointManager
from animal2vec_tpu_torch.train.finetune_step import (
    make_finetune_eval_step, make_finetune_train_step,
)
from animal2vec_tpu_torch.train.metrics import MetricsAccumulator, TensorboardSink, to_numpy
from animal2vec_tpu_torch.train.optim import build_lr_schedule
from animal2vec_tpu_torch.train.pretrain import make_pretrain_eval_step, make_pretrain_train_step

logger = logging.getLogger("animal2vec_tpu_torch")

# the variance kill switch (the floors are PretrainConfig.min_target_var and
# min_pred_var) is checked from the step after COLLAPSE_AFTER
COLLAPSE_AFTER = 5000


class CollapseError(RuntimeError):
    """Representation collapse at ``step``: the teacher's targets or the
    student's predictions lost their variance."""

    def __init__(self, step: int, what: str):
        super().__init__(f"step {step}: {what}")
        self.step = step


def _target_len(run: RunConfig) -> int:
    if run.task.max_sample_size:
        return min(run.task.max_sample_size, 80_000 * 4)
    rate = run.encoder.sample_rate
    return 80_000 if rate == 8000 else 10 * rate


def _build_loader(run: RunConfig, split: str, train: bool, accum: int, dp: DataParallel,
                  pin_memory: bool = False) -> BatchLoader:
    enc, task, data = run.encoder, run.task, run.dataset
    ds = AudioLabelDataset(
        os.path.join(task.data, f"{split}.tsv"),
        sample_rate=enc.sample_rate,
        min_sample_size=task.min_sample_size,
        normalize=enc.normalize,
        return_labels=task.with_labels,
        unique_labels=enc.labels,
        use_focal_loss=run.finetune.use_focal_loss if run.finetune else True,
        do_focal_prediction=task.do_focal_prediction,
        min_label_size=task.min_label_size if train else 0,
        conv_layers=enc.conv_layers,
        label_ext=task.label_ext,
    )
    return BatchLoader(
        ds,
        target_len=_target_len(run),
        max_tokens=data.max_tokens,
        batch_size=data.batch_size,
        accum=accum if train else 1,
        shuffle=train,
        seed=run.common.seed,
        num_workers=data.num_workers,
        host_index=dp.rank,
        host_count=dp.world,
        train=train,
        drop_last=train,
        bucket_lengths=data.bucket_lengths,
        batch_multiple=data.required_batch_size_multiple,
        pin_memory=pin_memory,
    )


def _to_device(batch: Mapping[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()
            if k not in ("id", "valid_len")}


def _check_collapse(step: int, metrics: Dict[str, float], min_target_var: float = 0.1,
                    min_pred_var: float = 0.01):
    if step <= COLLAPSE_AFTER:
        return
    tv = metrics.get("target_var")
    if tv is not None and tv < min_target_var:
        raise CollapseError(step, f"target var {tv:.4f} < {min_target_var}")
    for k, v in metrics.items():
        if k.startswith("pred_var") and v < min_pred_var:
            raise CollapseError(step, f"{k} {v:.4f} < {min_pred_var}")


class RunStopper:
    """max_update / stop_time_hours / stop_min_lr stop conditions."""

    def __init__(self, opt: OptimizationConfig, limit: int):
        self.limit = limit
        self.stop_s = opt.stop_time_hours * 3600.0
        self.stop_min_lr = opt.stop_min_lr
        self.schedule = build_lr_schedule(opt)
        self.t0 = time.monotonic()
        # stop_min_lr only binds after warmup (the warmup ramp starts below it)
        self.warmup = opt.warmup_updates

    def should_stop(self, step: int, dp: Optional[DataParallel] = None) -> Optional[str]:
        if step >= self.limit:
            return f"max_update {self.limit}"
        if self.stop_s > 0:
            late = time.monotonic() - self.t0 >= self.stop_s
            if dp is not None:  # the ranks' clocks differ: stop when one is late
                late = dp.any(late)
            if late:
                return f"stop_time_hours {self.stop_s / 3600.0:g}"
        if self.stop_min_lr >= 0 and step > self.warmup:
            lr = float(self.schedule(step))
            if lr < self.stop_min_lr:
                return f"lr {lr:.3g} < stop_min_lr {self.stop_min_lr:g}"
        return None


class EarlyStopper:
    """Patience-based early stop on the best checkpoint metric."""

    def __init__(self, patience: int, maximize: bool):
        self.patience = patience
        self.maximize = maximize
        self.best: Optional[float] = None
        self.bad = 0

    def should_stop(self, value: Optional[float]) -> bool:
        if value is None or self.patience <= 0:
            return False
        better = self.best is None or (value > self.best if self.maximize else value < self.best)
        if better:
            self.best = value
            self.bad = 0
        else:
            self.bad += 1
        return self.bad > self.patience


def _fmt(metrics: Dict[str, float]) -> str:
    return " ".join(f"{k}={metrics[k]:.4g}" for k in sorted(metrics)[:12])


def _train_loader(run: RunConfig, device: torch.device, loader_state: Dict,
                  dp: DataParallel) -> BatchLoader:
    loader = _build_loader(run, run.dataset.train_subset, True,
                           max(1, run.optimization.update_freq), dp, device.type == "cuda")
    if len(loader) == 0:
        raise ValueError(
            f"train split {run.dataset.train_subset!r} yields 0 batches: "
            f"{len(loader.dataset)} usable items < one batch group of "
            f"{loader.batch_size * loader.accum} (batch_size x update_freq); "
            "lower dataset.batch_size/max_tokens or use a larger subset")
    loader.load_state_dict(loader_state)
    return loader


def _do_validate(run: RunConfig, step: int) -> bool:
    d = run.dataset
    return bool(not d.disable_validation and step >= d.validate_after_updates
                and d.validate_interval_updates and step % d.validate_interval_updates == 0)


class _NullSink:
    """The metrics sink of a rank other than 0."""

    writer = None

    def log(self, metrics, step):
        pass

    def close(self):
        pass


def _sink(run: RunConfig, dp: DataParallel):
    return TensorboardSink(run.common.tensorboard_logdir) if dp.is_main else _NullSink()


def _info(dp: DataParallel, *args) -> None:
    if dp.is_main:
        logger.info(*args)


def _restore(ckpt: CheckpointManager, state, dp: DataParallel) -> Dict:
    """The rank's loader state from the latest checkpoint, loaded into
    ``state``; {} without one."""
    if ckpt.latest_step() is None:
        return {}
    extra = ckpt.restore(state, dp=dp)
    saved = int(extra.get("world_size", 1))
    if saved != dp.world:
        raise ValueError(
            f"{ckpt.directory}: the checkpoint at step {state.step} was written by {saved} "
            f"rank(s); resuming it under {dp.world} would change the data order and the "
            "global batch (set distributed.data_parallel to match, or start a new save_dir)")
    _info(dp, "restored checkpoint at step %d", state.step)
    return extra["loaders"][dp.rank] if "loaders" in extra else extra.get("loader", {})


def _save(ckpt: CheckpointManager, dp: DataParallel, step: int, state, loader: BatchLoader,
          metrics: Optional[Dict[str, float]] = None) -> None:
    """Rank 0 checkpoints ``state`` with every data rank's loader state (and
    the validation's ``metrics`` but its rate, which pick ``best``), the
    whole tensors of a sharded layout gathered from every rank; every rank
    waits at a barrier."""
    loaders = dp.all_gather_object(loader.state_dict())
    extra = {"loader": loaders[0], "loaders": loaders, "world_size": dp.world}
    if metrics is not None:
        extra["valid"] = {k: v for k, v in metrics.items() if k != "ups"}
    if dp.sharded:
        ckpt.save(step, state, extra=extra, metrics=metrics, dp=dp)
    elif dp.is_main:
        ckpt.save(step, state, extra=extra, metrics=metrics)
    dp.barrier()


def _finish(ckpt: CheckpointManager, dp: DataParallel) -> None:
    """Rank 0's last write reaches the disk before any rank returns."""
    if dp.is_main:
        ckpt.wait()
    dp.barrier()


def _train(run: RunConfig, state, step_fn, rngs, validate, sink, ckpt, device, max_steps,
           dp: DataParallel, stopper: Optional[EarlyStopper] = None,
           collapse: bool = False) -> Dict[str, float]:
    """The update loop shared by both runs, as one rank of ``dp``, from the
    latest checkpoint if there is one; ``validate(step)`` returns the
    validation metrics."""
    loader = _train_loader(run, device, _restore(ckpt, state, dp), dp)
    acc = MetricsAccumulator()
    opt = run.optimization
    limit = min(opt.max_update, max_steps or opt.max_update)
    run_stop = RunStopper(opt, limit)
    stop_reason = None
    last: Dict[str, float] = {}
    val, val_step = None, None
    while state.step < limit and stop_reason is None:
        loader.set_epoch(loader.epoch)
        # every rank runs as many steps as the rank with the fewest left
        left = dp.host_min(loader.remaining())
        for _, batch in zip(range(left), loader):
            with torch.profiler.record_function("train_step"):
                metrics = step_fn(state, _to_device(batch, device), rngs)
            acc.update(metrics)
            step = state.step
            if step % run.common.log_interval == 0 or step >= limit:
                last = acc.summary("train/")
                sink.log(last, step)
                _info(dp, "step %d %s", step, _fmt(last))
                if collapse:
                    _check_collapse(step, {k.split("/", 1)[1]: v for k, v in last.items()},
                                    run.pretrain.min_target_var, run.pretrain.min_pred_var)
                acc.reset()
            if _do_validate(run, step):
                val, val_step = validate(step), step
                _save(ckpt, dp, step, state, loader, val)
                if stopper is not None and stopper.should_stop(val.get("metrics/finetune/f1")):
                    _info(dp, "early stop at %d", step)
                    _finish(ckpt, dp)
                    return val
            elif (run.checkpoint.save_interval_updates
                  and step % run.checkpoint.save_interval_updates == 0):
                _save(ckpt, dp, step, state, loader)
            stop_reason = run_stop.should_stop(step, dp)
            if stop_reason:
                break
        else:  # the epoch ran to its end
            loader.epoch, loader.position = loader.epoch + 1, 0
    if stop_reason:
        _info(dp, "stopping: %s", stop_reason)
    # the last save of a validated step keeps its validation
    _save(ckpt, dp, state.step, state, loader, val if val_step == state.step else None)
    _finish(ckpt, dp)
    return last


def _group(device, dp: Optional[DataParallel], what: str) -> Tuple[torch.device, DataParallel]:
    if dp is None:
        device = _on(device, what)
        return device, DataParallel(device=device)
    return dp.device, dp


def run_finetune(run: RunConfig, pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                 max_steps: Optional[int] = None, patience: Optional[int] = None,
                 device="cuda", dp: Optional[DataParallel] = None) -> Dict[str, float]:
    """A finetuning run with validation and best-F1 checkpointing, from the
    pretrained student's state dict ``pretrained`` where given, as one rank
    of ``dp`` (on its device) where given. Returns the last logged (or, on
    an early stop, validation) metrics."""
    device, dp = _group(device, dp, "run_finetune")
    _, state = init_finetune(run, device, pretrained, dp)
    ckpt = CheckpointManager(run.checkpoint.save_dir, keep_last=run.checkpoint.keep_last,
                             best_metric=run.checkpoint.best_checkpoint_metric
                             or "metrics/finetune/f1", maximize=True)
    eval_fn = make_finetune_eval_step(run.finetune)
    sink = _sink(run, dp)
    stopper = EarlyStopper(run.checkpoint.patience if patience is None else patience,
                           run.checkpoint.maximize_best_checkpoint_metric)
    try:
        return _train(run, state, make_finetune_train_step(run.finetune, dp),
                      Rngs.from_seed(run.common.seed + 23, device, dp.rank),
                      lambda step: validate_finetune(run, state, eval_fn, sink, step, device, dp),
                      sink, ckpt, device, max_steps, dp, stopper=stopper)
    finally:
        sink.close()


def _reduced(acc: MetricsAccumulator, dp: DataParallel) -> MetricsAccumulator:
    """``acc`` holding the sums and counts of every rank's (a rank may have
    seen no batch)."""
    if dp.world > 1:
        acc.set_totals(dp.all_gather_object(acc.totals()))
    return acc


def validate_finetune(run: RunConfig, state, eval_fn, sink, step: int, device,
                      dp: Optional[DataParallel] = None) -> Dict[str, float]:
    """Validation pass: metric aggregation, then the verbose frame and
    segmented reports on the predictions gathered from every rank."""
    dp = dp or DataParallel(device=device)
    loader = _build_loader(run, run.dataset.valid_subset, False, 1, dp)
    acc = MetricsAccumulator()
    all_probs, all_targets, all_fvalid = [], [], []
    for batch in loader:
        metrics = eval_fn(state, _to_device(batch, device))
        preds = metrics.pop("_predictions", None)
        fvalid = metrics.pop("_frame_valid", None)
        acc.update(metrics)
        if preds is not None and run.task.verbose_tensorboard_logging:
            # trim the final short batch's repeated rows
            nv = int(batch["n_valid"]) if "n_valid" in batch else len(batch["source"])
            p = to_numpy(preds)[:nv]
            all_probs.append(p)
            all_targets.append(to_numpy(batch["target"])[:nv])
            all_fvalid.append(to_numpy(fvalid)[:nv] if fvalid is not None
                              else np.ones(p.shape[:2], bool))
    out = _reduced(acc, dp).summary()
    probs = targets = fvalid = None
    if all_probs:
        # length buckets give per-bucket frame counts: right-pad every batch
        # to the longest (padding marked frame-invalid)
        t_max = max(p.shape[1] for p in all_probs)

        def _pad_t(a):
            return np.pad(a, ((0, 0), (0, t_max - a.shape[1])) + ((0, 0),) * (a.ndim - 2))

        probs = np.concatenate([_pad_t(p) for p in all_probs], 0).astype(np.float32)
        targets = np.concatenate([_pad_t(t) for t in all_targets], 0).astype(np.int32)
        fvalid = np.concatenate([_pad_t(f) for f in all_fvalid], 0)
    if dp.world > 1 and run.task.verbose_tensorboard_logging:
        # every rank joins the gathers, also one that holds no item
        probs = dp.allgather_uneven(probs, np.float32)
        targets = dp.allgather_uneven(targets, np.int32)
        fvalid = dp.allgather_uneven(None if fvalid is None else
                                     fvalid[..., None].astype(np.float32), np.float32)
        fvalid = None if fvalid is None else fvalid[..., 0] > 0.5
    if probs is not None:
        # padding frames must not fire events or enter frame metrics
        probs = probs * fvalid[..., None]
        segmented = None
        if run.criterion.segmentation_metrics:
            seg_idx = [[intervals_from_binary(targets[b, :, c]) for c in range(targets.shape[-1])]
                       for b in range(targets.shape[0])]
            pr, ta, iou, sp, me = segmented_probs_and_targets(
                targets, seg_idx, probs, run.model.criterion(), run.model.sample_rate,
                _target_len(run), method=run.criterion.method)
            segmented = {"probs": pr, "targets": ta, "iou": iou, "splits": sp, "mergers": me}
        flat = fvalid.reshape(-1)
        report = log_eval_report(
            targets.reshape(-1, targets.shape[-1])[flat], probs.reshape(-1, probs.shape[-1])[flat],
            list(run.model.labels), run.model.metric_threshold, step, writer=sink.writer,
            prefix="valid", segmented=segmented)
        out.update(report)
    sink.log(out, step)
    _info(dp, "valid %d %s", step, _fmt(out))
    return out


def run_pretrain(run: RunConfig, max_steps: Optional[int] = None,
                 device="cuda", dp: Optional[DataParallel] = None) -> Dict[str, float]:
    """A data2vec-2 pretraining run of the audio encoder with the EMA
    teacher, as one rank of ``dp`` (on its device) where given. Returns the
    last logged metrics."""
    device, dp = _group(device, dp, "run_pretrain")
    _, state = init_pretrain(run, device, dp)
    ckpt = CheckpointManager(run.checkpoint.save_dir, keep_last=run.checkpoint.keep_last,
                             best_metric=run.checkpoint.best_checkpoint_metric,
                             maximize=run.checkpoint.maximize_best_checkpoint_metric)
    eval_fn = make_pretrain_eval_step(run.pretrain)
    sink = _sink(run, dp)
    try:
        return _train(run, state, make_pretrain_train_step(run.pretrain, dp=dp),
                      Rngs.from_seed(run.common.seed + 17, device, dp.rank),
                      lambda step: validate_pretrain(run, state, eval_fn, sink, step, device, dp),
                      sink, ckpt, device, max_steps, dp, collapse=True)
    finally:
        sink.close()


def validate_pretrain(run: RunConfig, state, eval_fn, sink, step: int, device,
                      dp: Optional[DataParallel] = None) -> Dict[str, float]:
    """Pretrain validation: the masked-prediction loss and the variance
    statistics on the valid split (each batch's masks drawn from seed 0 and
    the rank), and with the linear probe its confusion counts (and the
    precision, recall and F1 derived from them), over every rank's
    batches."""
    dp = dp or DataParallel(device=device)
    loader = _build_loader(run, run.dataset.valid_subset, False, 1, dp)
    acc = MetricsAccumulator()
    for batch in loader:
        acc.update(eval_fn(state, _to_device(batch, device), Rngs.from_seed(0, device, dp.rank)))
    out = _reduced(acc, dp).summary("valid/")
    sink.log(out, step)
    _info(dp, "valid %d %s", step, _fmt(out))
    return out
