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
* LayerNorm (and GroupNorm) ``scale`` -> ``weight``; the learnable-kernel
  sinc's (C, K) ``conv_0/kernel`` keeps its name and layout (``kernel``),
  and PCEN's ``alpha``, ``delta``, ``root`` and ``ema/weights`` theirs;
* the scan-stacked ``blocks/block`` params (leading depth axis) -> one module
  per layer, ``blocks.layers.{i}``;
* ``pos_blocks_{i}`` -> ``pos_blocks.{i}``, a decoder's ``blocks_{i}`` ->
  ``blocks.{i}``.

``params_to_jax`` is its inverse: a port state dict -> the JAX param tree
(fp32 numpy arrays), which ``train/convert.export_pretrain`` names in the
fairseq layout.
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
    # the learnable sinc taps (C, K) are a parameter named kernel
    sinc_taps = not hit and names[-2:] == ["local_encoder", "conv_0"]
    if leaf == "kernel" and not sinc_taps:
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


_KERNEL_FROM_WEIGHT = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}  # inverses of _torch_entry's


def _jax_entry(name: str, t: torch.Tensor):
    """(JAX path, layer index of a stacked block or None, array) of one port
    state dict entry."""
    arr = t.detach().cpu()
    arr = (arr.float() if arr.is_floating_point() else arr).numpy()
    *mods, leaf = name.split(".")
    if leaf == "weight":
        if arr.ndim == 1:
            leaf = "scale"
        else:
            arr = np.transpose(arr, _KERNEL_FROM_WEIGHT[arr.ndim])
            leaf = "kernel"
            if mods[-2:-1] == ["local_encoder"] and re.fullmatch(r"conv_\d+", mods[-1]):
                leaf = mods.pop() + "_kernel"
    path, layer, i = [], None, 0
    while i < len(mods):
        m, nxt = mods[i], mods[i + 1] if i + 1 < len(mods) else ""
        if m == "blocks" and nxt == "layers":
            path.extend(("blocks", "block"))
            layer = int(mods[i + 2])
            i += 3
        elif m in ("blocks", "pos_blocks") and nxt.isdigit():
            path.append(f"{m}_{nxt}")
            i += 2
        else:
            path.append(m)
            i += 1
    return tuple(path) + (leaf,), layer, np.ascontiguousarray(arr)


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Port state dict -> JAX params (nested dicts of numpy arrays, fp32 for
    floating tensors): the inverse of ``params_from_jax``."""
    tree: Dict = {}
    stacks: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name, t in state_dict.items():
        path, layer, arr = _jax_entry(name, t)
        if layer is None:
            leaves = tree
            for m in path[:-1]:
                leaves = leaves.setdefault(m, {})
            leaves[path[-1]] = arr
        else:
            stacks.setdefault(path, {})[layer] = arr
    for path, layers in stacks.items():
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.stack([layers[i] for i in range(len(layers))])
    return tree


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
