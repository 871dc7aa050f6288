"""Serving bundles: the finetuned frame-logit forward exported once with
``torch.export``, served by any later process without the model code. The
port of ``animal2vec_tpu/serve.py``.

A bundle directory holds:

* ``forward.pt2`` (and ``forward_<B>x<T>.pt2`` for every further shape):
  ``torch.export.save`` of ``(params, source) -> frame logits`` at a fixed
  (batch, wav_len), traced under ``torch.no_grad()``: the serving kernels
  appear as the custom ops of ``kernels/ops.py``, one node per launch, and
  no decomposition is run, so the bundle's aten ops are the eager ones;
* ``params.npz``: every tensor the forward reads, the model's parameters
  and buffers (the int8 modes' quantized weights included) by their state
  dict names. The weights stay out of the graph, as in JAX: one bundle can
  take retrained weights of the same structure. bf16 tensors are stored as
  uint16 bit patterns with a ``__dtypes__`` entry naming their dtype;
* ``meta.json``: the shapes, sample rate, labels, ``matmul_impl``, the
  device type and card the bundle was exported on, the torch version and
  the output shape.

``ServingBundle`` needs only torch, numpy and ``kernels/ops.py``: a serving
process imports nothing of ``animal2vec_tpu_torch.models``. A bundle runs on
the device type it was exported for (a CUDA bundle calls the kernels, a CPU
bundle their plain versions) and raises elsewhere; the kernels build or load
at the first call. Batch size and length are static: pad the final partial
batch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from animal2vec_tpu_torch.kernels import ops as _ops  # registers the a2v:: ops

DTYPES = {"bfloat16": torch.bfloat16}  # stored as uint16 bit patterns


def save_params_npz(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """``tensors`` as an npz; bf16 ones as their uint16 bit patterns with
    their dtype recorded in the ``__dtypes__`` entry (JSON bytes)."""
    out, dtypes = {}, {}
    for name, t in tensors.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            dtypes[name] = "bfloat16"
            t = t.view(torch.int16)
            out[name] = t.numpy().view(np.uint16)
        else:
            out[name] = t.numpy()
    out["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8).copy()
    np.savez(path, **out)


def load_params_npz(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The tensors of ``save_params_npz`` on ``device``, dtypes restored."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    dtypes = json.loads(bytes(flat.pop("__dtypes__", np.zeros(0, np.uint8))) or "{}")
    out = {}
    for name, arr in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if name in dtypes:
            t = t.view(torch.int16).view(DTYPES[dtypes[name]])
        out[name] = t.to(device)
    return out


def serving_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors the model's forward reads: every parameter and buffer,
    persistent or not, by name."""
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    return {k: v.detach() for k, v in tensors.items()}


class _Forward(torch.nn.Module):
    """(params, source) -> frame logits over ``functional_call``. The model
    is kept out of the module tree, so the export lifts no weight into the
    program: every tensor comes in through ``params``."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.__dict__["model"] = model

    def forward(self, params: Dict[str, torch.Tensor], source: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.model, params, (source,))["encoder_out"]


def program_name(index: int, shape: Tuple[int, int]) -> str:
    return "forward.pt2" if index == 0 else f"forward_{shape[0]}x{shape[1]}.pt2"


def _card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def export_serving(
    model: torch.nn.Module,
    out_dir: str,
    batch_size: int = 16,
    wav_len: Optional[int] = None,
    shapes: Optional[Sequence[Tuple[int, int]]] = None,
) -> str:
    """Export the eval-mode ``FinetuneModel`` ``model`` (its weights as
    loaded, e.g. bf16 after ``serving_cast``, on the device the bundle is
    for) into the bundle ``out_dir``. ``shapes``: (batch, wav_len) pairs,
    one program each, duplicates dropped; default the single (batch_size,
    wav_len), wav_len defaulting to the config's ``max_sample_size`` (10 s
    when unset). Returns ``out_dir``."""
    cfg = model.cfg
    if model.training:
        raise ValueError("export an eval() model: the bundle serves")
    if wav_len is None:
        wav_len = int(cfg.max_sample_size or 10 * cfg.sample_rate)
    if shapes is None:
        shapes = [(batch_size, wav_len)]
    # order-preserving dedupe: a repeated shape would name a program twice
    shapes = list(dict.fromkeys((int(b), int(t)) for b, t in shapes))
    params = serving_tensors(model)
    device = next(iter(params.values())).device
    os.makedirs(out_dir, exist_ok=True)
    forward = _Forward(model)
    with torch.no_grad():
        for i, shape in enumerate(shapes):
            source = torch.zeros(shape, dtype=torch.float32, device=device)
            program = torch.export.export(forward, (params, source))
            torch.export.save(program, os.path.join(out_dir, program_name(i, shape)))
    save_params_npz(os.path.join(out_dir, "params.npz"), params)
    meta = {
        "batch_size": shapes[0][0],
        "wav_len": shapes[0][1],
        "shapes": [list(s) for s in shapes],
        "sample_rate": cfg.sample_rate,
        "labels": list(cfg.labels),
        "matmul_impl": cfg.matmul_impl,
        "device_type": device.type,
        "device_name": _card_name(device),
        "torch": torch.__version__,
        "out_shape": [shapes[0][0], -1, len(cfg.labels)],
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class ServingBundle:
    """A loaded bundle: ``bundle(source)`` -> frame logits.

    Needs torch, numpy and the custom ops of ``kernels/ops.py``, no model
    code. Runs on the bundle's device type (the first card of that type
    unless ``device`` names one) and raises when that device is absent."""

    def __init__(self, bundle_dir: str, device=None):
        with open(os.path.join(bundle_dir, "meta.json")) as f:
            self.meta = json.load(f)
        kind = self.meta["device_type"]
        device = torch.device(device if device is not None else kind)
        if device.type != kind:
            raise RuntimeError(f"serving bundle was exported for {kind!r} "
                               f"({self.meta['device_name']}), not {device.type!r}")
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"serving bundle was exported for CUDA "
                               f"({self.meta['device_name']}) and this process has no card")
        self.device = device
        self.shapes = [tuple(s) for s in self.meta["shapes"]]
        t0 = time.perf_counter()
        self._calls = {
            shape: torch.export.load(os.path.join(bundle_dir, program_name(i, shape))).module()
            for i, shape in enumerate(self.shapes)
        }
        t1 = time.perf_counter()
        self._params = load_params_npz(os.path.join(bundle_dir, "params.npz"), device)
        # seconds of the load: the exported programs, the weights onto the device
        self.load_seconds = {"programs": t1 - t0, "params": time.perf_counter() - t1}

    @property
    def batch_size(self) -> int:
        return int(self.meta["batch_size"])

    @property
    def wav_len(self) -> int:
        return int(self.meta["wav_len"])

    def forward(self, source: torch.Tensor) -> torch.Tensor:
        """(batch, wav_len) fp32 waveforms of one of the bundle's shapes, on
        the bundle's device -> (B, T, n_classes) logits there, in the
        model's compute dtype. The fp32 sinc conv runs without TF32, as the
        model runs it."""
        key = tuple(source.shape)
        if key not in self._calls:
            raise ValueError(f"serving bundle expects source shape in {self.shapes}, got "
                             f"{key}; pad the final partial batch")
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                          deterministic=cudnn.deterministic, allow_tf32=False):
            return self._calls[key](self._params, source.to(self.device, torch.float32))

    def __call__(self, source) -> np.ndarray:
        """``forward`` of a numpy or torch batch -> fp32 numpy logits (the
        compute dtype's values, exactly)."""
        return self.forward(torch.as_tensor(source)).float().cpu().numpy()

    def predict_probs(self, source) -> np.ndarray:
        logits = self(source).astype(np.float32)
        return 1.0 / (1.0 + np.exp(-logits))
