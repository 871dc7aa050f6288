"""Dropout for training: the counter-based hash masks of the kernels and the
generator-driven masks of plain tensor code.

``dropout_keep`` is the port of ``animal2vec_tpu/ops/pallas_attention.
_dropout_keep`` (the attention kernels mix the batch*head index into the
seed) and ``hash_keep`` of ``animal2vec_tpu/ops/fused_mlp._hash_keep`` (the
fused block, no head index). Both are a murmur-style finalizer over
(seed, global row, global column) in uint32 arithmetic, so a kernel can
regenerate the same mask in its backward without storing it. Here the
uint32 arithmetic runs in int64 masked to 32 bits; the CUDA kernels compute
the same bits (``csrc/common.cuh``). The keep threshold is computed once on
the host, ``keep_threshold``, and passed to the kernels as an unsigned
integer: a float32 computation of ``rate * 2**32`` on the device rounds
differently.

``Rngs`` carries the generators a training step draws from: two CPU
generators, so that no host decision waits on the device, and one on the
compute device for elementwise masks and noise. Under data parallelism
(``parallel/mesh.py``) what JAX draws once for the whole global batch is
the same on every rank, and what it draws per row is never shared:

* ``host`` (seeded alike on every rank): layerdrop and the int32 kernel
  seeds, so every rank runs the same layers and the kernels' hash masks
  come from the same seeds;
* ``rows`` (a generator of the rank's own, seeded from (seed, rank)): the
  per-row host draws, the mixup coefficients, partners and gains and the
  span and channel masks. A rank seeds its own generator rather than
  drawing for the global batch and slicing its rows, because with length
  buckets the ranks' batches at one step differ in rows and length;
* ``device`` (seeded from (seed, rank)): elementwise dropout and noise.

``row0`` is the rank's first row of the global batch. The hash masks of
the kernels read global rows: ``attention_seed`` folds row0 * H into the
attention seed (the hash adds (b*H + h) * 0xC2B2AE3D to it), and the fused
block takes row0 * T as its row offset, so a 2-rank step draws the masks
that a 1-rank step draws on the concatenated batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_U32 = 0xFFFFFFFF
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def keep_threshold(rate: float) -> int:
    """uint32 threshold: an element is kept when its hash is >= it."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """The factor a kept element is multiplied by, ``1 / (1 - rate)``."""
    return 1.0 / (1.0 - rate)


def _as_u32(v) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(v, dtype=torch.int64)
    return v.to(torch.int64) & _U32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for uint32 values held in int64, in two halves so
    that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _finalize(z: torch.Tensor) -> torch.Tensor:
    z = z ^ (z >> 15)
    z = _mul32(z, 0x2C1B3C6D)
    z = z ^ (z >> 12)
    z = _mul32(z, 0x297A2D39)
    return z ^ (z >> 15)


def _mix(rows, cols) -> torch.Tensor:
    return (_mul32(_as_u32(rows), 0x9E3779B1) + _mul32(_as_u32(cols), 0x85EBCA77)) & _U32


def dropout_keep(seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """Attention keep mask (fp32 0/1) over broadcastable int ``bh`` (batch *
    heads + head), ``rows`` (global query index) and ``cols`` (global key
    index); ``seed`` is an int32."""
    z = _mix(rows, cols) ^ ((_as_u32(seed) + _mul32(_as_u32(bh), 0xC2B2AE3D)) & _U32)
    return (_finalize(z) >= keep_threshold(rate)).to(torch.float32)


def hash_keep(seed, rows, cols, rate: float) -> torch.Tensor:
    """Fused-block keep mask (fp32 0/1) over broadcastable global ``rows``
    and ``cols``; ``seed`` is an int32."""
    z = _mix(rows, cols) ^ _as_u32(seed)
    return (_finalize(z) >= keep_threshold(rate)).to(torch.float32)


def _rank_seed(seed: int, rank: int, stream: int) -> int:
    """A generator seed of its own for (seed, rank, stream); rank 0's
    device stream keeps ``seed + 1``."""
    if rank == 0 and stream == 1:
        return seed + 1
    return int(np.random.SeedSequence([seed, rank, stream]).generate_state(1)[0])


def fold_bh_offset(seed: int, bh0: int) -> int:
    """The int32 attention seed whose hash at (b*H + h) equals ``seed``'s at
    (bh0 + b*H + h): the hash mixes in seed + bh * 0xC2B2AE3D (mod 2**32)."""
    s = (int(seed) + int(bh0) * 0xC2B2AE3D) & _U32
    return s - (1 << 32) if s > INT32_MAX else s


@dataclasses.dataclass
class Rngs:
    host: torch.Generator    # CPU, alike on every rank: layerdrop, kernel seeds
    device: torch.Generator  # the rank's compute device: dropout masks, mask noise
    rows: torch.Generator    # CPU, the rank's own: mixup, span and channel masks
    row0: int = 0            # the rank's first row of the global batch

    @classmethod
    def from_seed(cls, seed: int, device, rank: int = 0) -> "Rngs":
        device = torch.device(device)
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(_rank_seed(seed, rank, 1)),
                   torch.Generator().manual_seed(_rank_seed(seed, rank, 2)))

    def int32_seeds(self, n: int) -> list:
        """``n`` int32 hash seeds drawn on the host."""
        draw = torch.randint(INT32_MIN, INT32_MAX + 1, (n,), generator=self.host,
                             dtype=torch.int64)
        return [int(s) for s in draw]

    def attention_seed(self, heads: int) -> int:
        """One attention hash seed, with the rank's first global (batch *
        head) index ``row0 * heads`` folded in."""
        return fold_bh_offset(self.int32_seeds(1)[0], self.row0 * heads)


def dropout_mask(shape, rate: float, generator: torch.Generator, device) -> torch.Tensor:
    """The bool keep mask that ``dropout`` draws from ``generator``: drawn
    ahead of a rematerialized region, it is the same draw in the forward
    and in the recompute."""
    return torch.rand(shape, generator=generator, device=device) >= rate


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` under a ``dropout_mask``."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator`` (``F.dropout``
    takes no generator). ``rate`` 0 returns ``x``."""
    if rate == 0.0:
        return x
    return apply_dropout(x, dropout_mask(x.shape, rate, generator, x.device), rate)
