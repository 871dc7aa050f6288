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

A state in a sharded layout (``parallel/layout.py``) is saved whole: every
rank gives its shards and the main rank gets the whole tensors under the
unsharded names (``snapshot`` with a ``dp``, collective); loading slices
each rank's part out of the whole tensors (``load_into`` with a ``dp``). A
checkpoint so does not depend on the layout it was written under, as JAX's
restore reshards into the run's own (``train/loop.py:186-199``).
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


def snapshot(state, extra: Optional[Dict[str, Any]] = None, dp=None) -> Optional[Dict[str, Any]]:
    """Host copies of a ``FinetuneState`` or ``PretrainState``: step, model,
    optimizer moments and count, EMA (or None) and ``extra``. Under a
    sharded ``dp`` every rank takes part and the main rank gets the whole
    tensors (None elsewhere)."""
    opt = state.optimizer
    mu, nu = {}, {}
    for group in opt.param_groups:
        st = opt.state.get(group["params"][0])
        if st:
            mu[group["name"]], nu[group["name"]] = st["mu"], st["nu"]
    ema = getattr(state, "ema", None)
    model = state.model.state_dict(keep_vars=True)
    if dp is not None and dp.sharded:
        from animal2vec_tpu_torch.parallel.layout import full_state

        host = lambda t: full_state(dp, t)  # noqa: E731
    else:
        host = lambda t: {k: _host(v) for k, v in t.items()}  # noqa: E731
    model, mu, nu = host(model), host(mu), host(nu)
    ema = None if ema is None else host(ema)
    if model is None:  # not the main rank
        return None
    return {
        "step": int(state.step),
        "model": model,
        "optimizer": {"count": int(opt.count), "mu": mu, "nu": nu},
        "ema": ema,
        "extra": extra or {},
    }


def load_into(state, saved: Dict[str, Any], dp=None) -> Dict[str, Any]:
    """Put a ``snapshot`` back into ``state`` (on its model's device), under a
    sharded ``dp`` each rank's part of it; returns ``extra``."""
    dev = next(state.model.parameters()).device
    opt = state.optimizer
    moments = saved["optimizer"]
    names = {g["name"]: g["params"][0] for g in opt.param_groups}
    if dp is not None and dp.sharded:
        from animal2vec_tpu_torch.parallel.layout import in_trunk, load_full_state

        def held(tensors, local):  # other stages hold the rest of the trunk
            return {k: v for k, v in tensors.items()
                    if k in local or not (dp.stage.size > 1 and in_trunk(k))}

        load_full_state(dp, state.model.state_dict(keep_vars=True), saved["model"])
        moments = dict(moments, mu=held(moments["mu"], names), nu=held(moments["nu"], names))
        ema_saved = None if saved["ema"] is None else held(saved["ema"], state.ema)
    else:
        state.model.load_state_dict(saved["model"], strict=True)
        ema_saved = saved["ema"]
    if set(moments["mu"]) - set(names):
        raise KeyError(f"checkpoint moments of unknown parameters: "
                       f"{sorted(set(moments['mu']) - set(names))[:4]}")
    opt.state.clear()
    for name, p in names.items():
        if name in moments["mu"]:
            if dp is not None and dp.sharded:
                st = {k: torch.zeros_like(p, dtype=torch.float32) for k in ("mu", "nu")}
                load_full_state(dp, {name: st["mu"]}, {name: moments["mu"][name]})
                load_full_state(dp, {name: st["nu"]}, {name: moments["nu"][name]})
                opt.state[p] = st
            else:
                opt.state[p] = {"mu": moments["mu"][name].to(dev),
                                "nu": moments["nu"][name].to(dev)}
    opt.count = int(moments["count"])
    if ema_saved is not None:
        if set(ema_saved) != set(state.ema):
            raise KeyError("checkpoint EMA parameters differ from the state's")
        if dp is not None and dp.sharded:
            load_full_state(dp, state.ema, ema_saved)
        else:
            for k, v in ema_saved.items():
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
             metrics: Optional[Dict[str, float]] = None, dp=None):
        """Checkpoint ``state`` as step ``step``; with ``metrics`` holding
        ``best_metric``, a better value than the best so far makes it
        ``best``. Under a sharded ``dp`` every rank calls it (the snapshot
        is collective) and the main rank writes."""
        self.wait()
        saved = snapshot(state, extra, dp)
        if saved is not None:
            self.save_snapshot(step, saved, metrics)

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

    def restore(self, state, step: Optional[int] = None, dp=None) -> Dict[str, Any]:
        """Load ``step`` (default: the latest) into ``state`` (under a sharded
        ``dp`` the rank's part); returns its ``extra``."""
        return load_into(state, self.load(step), dp)


def load_checkpoint_dir(path: str) -> Dict[str, Any]:
    """The saved dict of a checkpoint: a ``step_*`` directory (or ``best``),
    or a manager's directory (its latest step)."""
    path = os.path.realpath(path)
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    return CheckpointManager(path).load()
