"""Convolution padding and length arithmetic: a copy of the framework-neutral
half of ``animal2vec_tpu/ops/conv_arith.py`` (the conv stack's frame count,
and the label frame count that ``data.dataset`` and ``ops.frames`` read).

Stride-1 convs pad torch-"same" (left (k-1)//2, right the rest, so k=2 pads
(0, 1)); strided convs pad ceil(stride/2) zeros on both sides.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def same_pad_1d(kernel: int) -> Tuple[int, int]:
    """torch Conv1d(padding='same') split for stride 1: left=(k-1)//2."""
    total = kernel - 1
    left = total // 2
    return left, total - left


def strided_pad_1d(stride: int) -> Tuple[int, int]:
    """Strided-conv padding: ceil(stride/2) on both sides."""
    p = math.ceil(stride / 2)
    return p, p


def conv_out_length(length: int, kernel: int, stride: int, pad: Tuple[int, int]) -> int:
    return (length + pad[0] + pad[1] - kernel) // stride + 1


def feature_extractor_out_length(
    length: int, conv_layers: Sequence[Tuple[int, int, int]]
) -> int:
    """Frames out of the conv stack for ``length`` samples (stride-1 layers
    keep the length)."""
    for _, k, s in conv_layers:
        if s == 1:
            continue
        length = conv_out_length(length, k, s, strided_pad_1d(s))
    return length


def label_frame_length(length: int, conv_layers: Sequence[Tuple[int, int, int]]) -> int:
    """Label-target frame count: the arithmetic of
    ``feature_extractor_out_length`` with kernels clamped at min(10, k), as
    the reference's label downsampling computes it. For the shipped stacks
    both agree (only the stride-1 sinc layer has k > 10)."""
    for _, k, s in conv_layers:
        if s == 1:
            continue
        length = conv_out_length(length, min(10, k), s, strided_pad_1d(s))
    return length
