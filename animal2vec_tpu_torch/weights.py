"""JAX parameter trees -> the port's state dict, and the serving cast.

``params_from_jax`` takes the JAX ``FinetuneModel`` params, or those of a
``Data2VecMulti`` (image serving, or pretraining with its decoders; or its
EMA teacher's subset), as nested dicts of numpy
arrays (or ``load_params_npz`` of an ``.npz`` whose keys are the "/"-joined
JAX param paths) and returns a state dict for
``animal2vec_tpu_torch.models.finetune.FinetuneModel`` or the port's
``Data2VecMulti`` (``build_image_model``, ``build_pretrain_model``; an EMA
subset gives the teacher dict of ``train.state.PretrainState``):

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* conv ``kernel`` (K, C_in/g, C_out) -> ``weight`` (C_out, C_in/g, K), the
  frontend's ``conv_{i}_kernel`` -> ``conv_{i}.weight``;
* 2-D conv HWIO ``kernel`` (kh, kw, C_in/g, C_out), the patch embedding's
  and the image decoder's, -> OIHW ``weight`` (C_out, C_in/g, kh, kw);
* LayerNorm ``scale`` -> ``weight``;
* the scan-stacked ``blocks/block`` params (leading depth axis) -> one module
  per layer, ``blocks.layers.{i}``;
* ``pos_blocks_{i}`` -> ``pos_blocks.{i}``, a decoder's ``blocks_{i}`` ->
  ``blocks.{i}``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LIST_MODULES = re.compile(r"^(pos_blocks|blocks)_(\d+)$")
_EXTRACTOR_KERNEL = re.compile(r"^(conv_\d+)_kernel$")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _torch_entry(path: tuple, arr: np.ndarray):
    *mods, leaf = path
    names = []
    for m in mods:
        hit = _LIST_MODULES.match(m)
        names.extend(hit.groups() if hit else (m,))
    hit = _EXTRACTOR_KERNEL.match(leaf)
    if hit:
        names.append(hit.group(1))
        leaf = "kernel"
    if leaf == "kernel":
        arr = np.transpose(arr, {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[arr.ndim])
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(names + [leaf]), torch.tensor(np.ascontiguousarray(arr))


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params (nested dicts of arrays) -> port state dict."""
    sd = {}
    for path, arr in _flatten(tree).items():
        if "block" in path and path[path.index("block") - 1] == "blocks":
            i = path.index("block")
            for layer in range(arr.shape[0]):
                name, t = _torch_entry(path[:i] + ("layers", str(layer)) + path[i + 1:], arr[layer])
                sd[name] = t
        else:
            name, t = _torch_entry(path, arr)
            sd[name] = t
    return sd


def load_params_npz(path: str) -> Dict:
    """An ``.npz`` keyed by "/"-joined JAX param paths -> nested dicts."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *mods, leaf = key.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    return tree


def serving_cast(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Store matmul and conv weights in bf16 (``bench.py:62-75``): fp32 params
    of 2 or more dims go to bf16, except the sinc filterbank (``conv_0``) and
    the ALiBi scales, which are consumed in fp32. Load the result with
    ``load_state_dict(..., assign=True)`` to keep the dtypes."""
    out = {}
    for name, t in state_dict.items():
        keep = "conv_0" in name.split(".") or name.endswith("alibi_scale")
        if t.dtype == torch.float32 and t.dim() >= 2 and not keep:
            t = t.to(torch.bfloat16)
        out[name] = t
    return out
