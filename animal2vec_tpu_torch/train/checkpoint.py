"""Checkpoint save/restore/resume: the port of
``animal2vec_tpu/train/checkpoint.py`` with torch files in place of orbax.

``step_<10 digits>/state.pt`` holds one dict: the step, the model's fp32
state dict, ``OptaxAdam``'s moments by parameter name and its global count,
the EMA teacher's parameters (pretraining) and ``extra`` (the loader's
(epoch, position)). ``save`` takes host copies of the tensors on the
calling thread, then one background thread writes them into a temporary
directory that is renamed to the step's when complete, points ``best`` at
it when the metric improved (``meta.json`` keeps ``best_value``), and
deletes all but the last ``keep_last`` steps, never ``best``'s. ``wait``
joins that thread. ``restore`` loads a state in place, onto its model's
device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def snapshot(state, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Host copies of a ``FinetuneState`` or ``PretrainState``: step, model,
    optimizer moments and count, EMA (or None) and ``extra``."""
    opt = state.optimizer
    mu, nu = {}, {}
    for group in opt.param_groups:
        st = opt.state.get(group["params"][0])
        if st:
            mu[group["name"]], nu[group["name"]] = _host(st["mu"]), _host(st["nu"])
    ema = getattr(state, "ema", None)
    return {
        "step": int(state.step),
        "model": {k: _host(v) for k, v in state.model.state_dict().items()},
        "optimizer": {"count": int(opt.count), "mu": mu, "nu": nu},
        "ema": None if ema is None else {k: _host(v) for k, v in ema.items()},
        "extra": extra or {},
    }


def load_into(state, saved: Dict[str, Any]) -> Dict[str, Any]:
    """Put a ``snapshot`` back into ``state`` (on its model's device); returns
    ``extra``."""
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(saved["model"], strict=True)
    opt = state.optimizer
    moments = saved["optimizer"]
    names = {g["name"]: g["params"][0] for g in opt.param_groups}
    if set(moments["mu"]) - set(names):
        raise KeyError(f"checkpoint moments of unknown parameters: "
                       f"{sorted(set(moments['mu']) - set(names))[:4]}")
    opt.state.clear()
    for name, p in names.items():
        if name in moments["mu"]:
            opt.state[p] = {"mu": moments["mu"][name].to(dev), "nu": moments["nu"][name].to(dev)}
    opt.count = int(moments["count"])
    if saved["ema"] is not None:
        if set(saved["ema"]) != set(state.ema):
            raise KeyError("checkpoint EMA parameters differ from the state's")
        for k, v in saved["ema"].items():
            state.ema[k].copy_(v)
    state.step = int(saved["step"])
    return saved["extra"]


class CheckpointManager:
    """keep-last-k + best-metric checkpointing with one background writer."""

    def __init__(self, directory: str, keep_last: int = 10, best_metric: str = "",
                 maximize: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.best_metric = best_metric
        self.maximize = maximize
        self._best_value: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        if os.path.isfile(self._meta_path()):
            with open(self._meta_path()) as f:
                self._best_value = json.load(f).get("best_value")

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _meta_path(self) -> str:
        return os.path.join(self.directory, "meta.json")

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            suffix = name[len("step_"):]
            if (name.startswith("step_") and suffix.isdigit()
                    and os.path.isdir(os.path.join(self.directory, name))):
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore -------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None,
             metrics: Optional[Dict[str, float]] = None):
        """Checkpoint ``state`` as step ``step``; with ``metrics`` holding
        ``best_metric``, a better value than the best so far makes it
        ``best``."""
        self.wait()
        self.save_snapshot(step, snapshot(state, extra), metrics)

    def save_snapshot(self, step: int, saved: Dict[str, Any],
                      metrics: Optional[Dict[str, float]] = None):
        """``save`` of a ready ``snapshot``-layout dict (host tensors), as
        the converter writes one."""
        self.wait()
        best = False
        if metrics and self.best_metric and self.best_metric in metrics:
            value = float(metrics[self.best_metric])
            best = self._best_value is None or (
                value > self._best_value if self.maximize else value < self._best_value)
            if best:
                self._best_value = value
        self._thread = threading.Thread(target=self._write, args=(step, saved, best),
                                        daemon=True)
        self._thread.start()

    def _write(self, step: int, saved: Dict[str, Any], best: bool):
        try:
            path = self._step_dir(step)
            tmp = os.path.join(self.directory, f".tmp_step_{step:010d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(saved, os.path.join(tmp, STATE_FILE))
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            if best:
                link = os.path.join(self.directory, "best")
                tmp_link = link + ".tmp"
                if os.path.lexists(tmp_link):
                    os.unlink(tmp_link)
                os.symlink(path, tmp_link)
                os.replace(tmp_link, link)
                with open(self._meta_path(), "w") as f:
                    json.dump({"best_value": self._best_value}, f)
            self._rotate()
        except Exception as e:  # re-raised by wait()
            self._error = e

    def _rotate(self):
        steps = self.all_steps()
        if not self.keep_last or len(steps) <= self.keep_last:
            return
        link = os.path.join(self.directory, "best")
        best = os.path.realpath(link) if os.path.islink(link) else None
        for s in steps[: -self.keep_last]:
            p = self._step_dir(s)
            if os.path.realpath(p) != best:
                shutil.rmtree(p, ignore_errors=True)

    def wait(self):
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def load(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved dict of ``step`` (default: the latest) on the CPU."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, state, step: Optional[int] = None) -> Dict[str, Any]:
        """Load ``step`` (default: the latest) into ``state``; returns its
        ``extra``."""
        return load_into(state, self.load(step))


def load_checkpoint_dir(path: str) -> Dict[str, Any]:
    """The saved dict of a checkpoint: a ``step_*`` directory (or ``best``),
    or a manager's directory (its latest step)."""
    path = os.path.realpath(path)
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    return CheckpointManager(path).load()
