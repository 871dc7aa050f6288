"""Ring (sequence-parallel) ALiBi attention: the port of
``animal2vec_tpu/ops/ring_attention.py``.

Each of n ranks holds a T/n slice of q, k and v (B, T/n, H, D), with its
queries' global positions and its keys' padding mask. The key, value,
key-position and key-mask slices rotate around the ring, rank i sending to
rank i + 1, and every step launches #2's training forward with its lse
(``ops.attention.alibi_flash_attention_lse``) on the local queries against
the slice at hand, with that slice's own key positions. The partials merge
in log space, as the JAX ``_merge_partials`` merges them:

    out = sum_i w_i * out_i,   w_i = exp(lse_i - lse),  lse = logsumexp_i lse_i

so no rank holds a (T, T) score matrix or the whole key sequence. ALiBi
needs only the rotating key positions: the bias depends on |pos_q - pos_k|.

Forward only, as in JAX: training runs pre-chunked 10-s clips, so the
backward ring is not needed.

The rotation is an argument. ``ring_attention`` computes the shards of one
process, a list: under ``torch.distributed`` each rank holds one shard and
``dist_rotate`` moves it by ``dist.batch_isend_irecv`` (NCCL on cards,
gloo on host tensors: gloo has no send or receive of CUDA tensors); an
in-process ring (``ring_attention_local``) holds all n shards on one device
and rotates the list, which is how one card runs the ring.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_lse

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # k, v, pos_k, mask
Rotate = Callable[[List[Block]], List[Block]]


def merge_partials(out_a: torch.Tensor, lse_a: torch.Tensor, out_b: torch.Tensor,
                   lse_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-space merge of two flash partials: outs (B, T, H, D) normalized,
    lses (B, H, T) fp32 (the JAX ``_merge_partials``)."""
    m = torch.maximum(lse_a, lse_b)
    wa, wb = torch.exp(lse_a - m), torch.exp(lse_b - m)
    den = wa + wb

    def to_w(w):  # (B, H, T) -> (B, T, H, 1) in the outputs' dtype
        return (w / den).transpose(1, 2)[..., None].to(out_a.dtype)

    return out_a * to_w(wa) + out_b * to_w(wb), m + torch.log(den)


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], slopes: torch.Tensor,
                   positions: Sequence[torch.Tensor],
                   padding_masks: Sequence[Optional[torch.Tensor]], rotate: Rotate,
                   n: int, has_sentinel: bool = True) -> List[torch.Tensor]:
    """The outputs (B, T/n, H, D) of this process's query shards ``qs``
    after ``n`` ring steps; ``positions`` are each shard's global positions
    (B, T/n) int32, ``padding_masks`` each shard's key mask (True = padded)
    or None, and ``rotate`` hands every held (k, v, pos_k, mask) block on
    to the next shard of the ring."""
    blocks = [(k, v, p.to(torch.int32), torch.zeros(p.shape, dtype=torch.int32, device=p.device)
               if m is None else m.to(torch.int32))
              for k, v, p, m in zip(ks, vs, positions, padding_masks)]
    acc: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * len(qs)
    for step in range(n):
        if step:
            blocks = rotate(blocks)
        for i, (q, pos, (kb, vb, pk, mk)) in enumerate(zip(qs, positions, blocks)):
            out, lse = alibi_flash_attention_lse(q, kb, vb, slopes, pos, mk.bool(),
                                                 has_sentinel, pk)
            b, t, h, _ = q.shape
            lse = lse.reshape(b, h, t)
            acc[i] = (out, lse) if acc[i] is None else merge_partials(*acc[i], out, lse)
    return [out for out, _ in acc]


def dist_rotate(group: Optional[dist.ProcessGroup] = None) -> Rotate:
    """The rotation of a ``torch.distributed`` ring: each rank sends its one
    block to rank + 1 and receives rank - 1's, all four tensors in one
    ``batch_isend_irecv``."""

    def rotate(blocks: List[Block]) -> List[Block]:
        (block,) = blocks
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        nxt = dist.get_global_rank(group, (rank + 1) % world) if group else (rank + 1) % world
        prv = dist.get_global_rank(group, (rank - 1) % world) if group else (rank - 1) % world
        received = tuple(torch.empty_like(x) for x in block)
        ops = [dist.P2POp(dist.isend, x, nxt, group) for x in block]
        ops += [dist.P2POp(dist.irecv, x, prv, group) for x in received]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [received]

    return rotate


def local_rotate(blocks: List[Block]) -> List[Block]:
    """The rotation of an in-process ring: shard i's next block is shard
    i - 1's."""
    return blocks[-1:] + blocks[:-1]


def ring_attention_dist(q, k, v, slopes, positions, padding_mask=None,
                        group: Optional[dist.ProcessGroup] = None,
                        has_sentinel: bool = True) -> torch.Tensor:
    """This rank's (B, T/n, H, D) output of the ring over ``group``'s ranks
    (the JAX ``ring_flash_attention`` inside ``shard_map``)."""
    n = dist.get_world_size(group)
    return ring_attention([q], [k], [v], slopes, [positions], [padding_mask], dist_rotate(group),
                          n, has_sentinel)[0]


def ring_attention_local(q, k, v, slopes, positions, padding_mask=None, n: int = 2,
                         has_sentinel: bool = True) -> torch.Tensor:
    """The ring over ``n`` shards of (B, T, H, D) q, k, v along T on their
    own device, in one process (the JAX ``ring_attention_sharded``): the
    (B, T, H, D) output; ``positions`` (B, T) int32, ``padding_mask`` (B, T)
    of the keys or None. T must divide by n."""
    t = q.shape[1]
    if t % n:
        raise ValueError(f"T={t} does not split into {n} ring shards")
    split = lambda x: [s.contiguous() for s in x.chunk(n, dim=1)]  # noqa: E731
    masks = [None] * n if padding_mask is None else split(padding_mask)
    outs = ring_attention(split(q), split(k), split(v), slopes, split(positions), masks,
                          local_rotate, n, has_sentinel)
    return torch.cat(outs, dim=1)
