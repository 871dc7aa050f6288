"""ALiBi head slopes and the image modality's 2-D bias: copies of
``animal2vec_tpu/ops/alibi.alibi_slopes`` (geometric power-of-two recipe with
the non-power-of-two interleave) and ``alibi_bias_2d``, in numpy."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def alibi_slopes(num_heads: int) -> np.ndarray:
    def pow2_slopes(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start**i for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = (
            pow2_slopes(closest)
            + alibi_slopes(2 * closest).tolist()[0::2][: num_heads - closest]
        )
    return np.asarray(slopes, dtype=np.float32)


def alibi_bias_2d(num_patches: int, num_heads: int, distance: str = "manhattan") -> np.ndarray:
    """(heads, P, P) fp32 bias ``-slope_h * dist(i, j)`` between the cells of
    a sqrt(P) x sqrt(P) grid, manhattan or euclidean."""
    n = math.isqrt(num_patches)
    if n * n != num_patches:
        raise ValueError(f"{num_patches} patches do not make a square grid")
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    coords = np.stack([ii.reshape(-1), jj.reshape(-1)], axis=1).astype(np.float32)
    dx = np.abs(coords[:, None, 0] - coords[None, :, 0])
    dy = np.abs(coords[:, None, 1] - coords[None, :, 1])
    if distance == "manhattan":
        dist = dx + dy
    elif distance == "euclidean":
        dist = np.sqrt(dx**2 + dy**2)
    else:
        raise ValueError(distance)
    return alibi_slopes(num_heads)[:, None, None] * (-dist)[None]
