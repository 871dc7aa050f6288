"""The serving kernels as torch custom ops.

Importing this module registers every ``a2v::`` op that the finetuned
model's eager serving forward calls (no gradient wanted, no dropout), each
defined beside its launch code:

* ``a2v::alibi_attention_serve`` (#1, ``ops/attention.py``): (B, T, H, D)
  views q, k, v read in place -> a new (B, T, H, D) output;
* ``a2v::fused_block`` (#6 without dropout, ``ops/fused_mlp.py``) ->
  (x_out, tap);
* ``a2v::int8_dense`` (#10, ``ops/int8_mm.py``);
* ``a2v::quantize_qkv_int8`` and ``a2v::alibi_attention_int8`` (#5's
  quantization pass and #5, ``ops/attention.py``);
* ``a2v::fused_block_int8`` (#7, ``ops/fused_mlp.py``).

Each op has one implementation per device type: for CUDA tensors the
kernel's launch (which adds one to its wrapper's ``launches`` count), for
CPU tensors the kernel's plain PyTorch version, and a fake for tracing, so
``torch.export`` keeps each launch as one graph node. The ops are
functional: every output is a new tensor. A process that loads an exported
serving bundle (``serve.ServingBundle``) imports this module and nothing of
``animal2vec_tpu_torch.models``; the kernels themselves build or load at
the first launch (``kernels/build.library``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from animal2vec_tpu_torch.ops import attention, fused_mlp, int8_mm

# op name -> the wrapper whose ``launches`` its CUDA implementation counts
SERVING_OPS: Dict[str, Callable] = {
    "a2v::alibi_attention_serve": attention.alibi_flash_attention_serve,
    "a2v::fused_block": fused_mlp.fused_block_mlp,
    "a2v::int8_dense": int8_mm.int8_dense,
    "a2v::quantize_qkv_int8": attention.quantize_qkv_int8_pass,
    "a2v::alibi_attention_int8": attention.alibi_flash_attention_int8,
    "a2v::fused_block_int8": fused_mlp.fused_block_int8,
}


def op(name: str) -> torch._ops.OpOverloadPacket:
    """The registered op of ``name`` ("a2v::...")."""
    namespace, short = name.split("::")
    return getattr(getattr(torch.ops, namespace), short)


def launches() -> Dict[str, int]:
    """Kernel launches counted by each serving op since its count was last
    set to 0."""
    return {name: wrapper.launches for name, wrapper in SERVING_OPS.items()}


def reset_launches() -> None:
    for wrapper in SERVING_OPS.values():
        wrapper.launches = 0
