"""GPipe pipeline parallelism of the trunk over the mesh's "stage" axis: the
port of ``animal2vec_tpu/parallel/pipeline.py`` and of ``BlockStack``'s
pipelined arm (``models/modules.py:797-905``).

JAX shards the scanned trunk's stacked parameters over "stage" and runs an
SPMD tick loop under ``shard_map``: ``n_micro + S - 1`` ticks, each stage
applying its depth slice to one microbatch a tick and ``ppermute``-ing the
activation on; reverse-mode AD mirrors the schedule. The port runs one
process per stage (``split_trunk`` keeps a stage's ``depth / S`` layers in
its ``BlockStack``) and the same schedule with explicit point-to-point
transfers: stage s takes microbatch m from stage s - 1 (stage 0 from the
trunk's input), runs its layers and hands it on, so that microbatch m is on
stage s at tick m + s, ``n_micro + S - 1`` ticks in all; the backward runs
the microbatches in reverse through the stages (``_Trunk``, an autograd
Function whose forward keeps each microbatch's local graph). What crosses
a stage boundary is (x, acc): acc is the fp32 running sum of the weighted
layer taps, ``reduce(tap)`` summed over the last k kept layers, which
carries the finetune model's top-k tap average (its layerdrop keeps
decide the weights) and the EMA teacher's streamed targets (JAX's
``tap_reduce``). The last stage's (x, acc) reach every stage (JAX's
``psum`` of the output buffers), so the frontend and prenet before the
trunk and the heads, decoders and losses after it run on every stage, as
in JAX; the trunk input's gradient comes back from stage 0, the ALiBi
slopes' and the per-layer scales' are summed over the stages.

Randomness follows the layer, not the stage: every stage draws layerdrop
and every kept layer's draws (``AltBlock.draws``) for the whole batch in
layer order, as the plain stack draws them, and a microbatch runs its rows'
slice of them (``AltBlock.slice_draws``); drop-path rates and remat are the
layer's. A pipelined step so draws the masks of the plain stack.

Where JAX's ``_pipelined`` warns and falls back to the plain scan (no mesh
with a matching "stage" axis, a depth the stages do not divide, a dense
attention bias), the port raises with the reason.

The transport follows the backend: NCCL moves device tensors; gloo takes
host tensors in point-to-point transfers, so ranks of a card over gloo
copy the boundary to the host before sending and to the card after
receiving (``parallel/mesh.py``: gloo takes CUDA tensors in all-reduce and
broadcast only).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from animal2vec_tpu_torch.models.attention import AlibiSpec
from animal2vec_tpu_torch.models.modules import BlockStack, scale_bias, top_k_tap_average
from animal2vec_tpu_torch.parallel.mesh import DataParallel


def pick_microbatches(batch: int, stages: int, requested: int = 0) -> int:
    """Largest divisor of ``batch`` that is <= max(requested, 2*stages).

    2*stages halves the GPipe bubble vs. n_micro == stages while keeping
    per-tick work large; explicit ``requested`` raises/lowers the cap."""
    cap = requested if requested > 0 else 2 * stages
    cap = min(cap, batch)
    for m in range(cap, 0, -1):
        if batch % m == 0:
            return m
    return 1


@dataclasses.dataclass(frozen=True)
class Stream:
    """A reduction of the trunk's taps that ``BlockStack`` returns beside
    them, pipelined or not: the fp32 sum of ``reduce(tap)`` (``tap``
    itself without one) over the last ``k`` kept layers, or with ``mean``
    that sum over the number of such layers (0 where every layer
    dropped)."""

    k: int
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    mean: bool = False

    def weights(self, keeps: Sequence[float]) -> List[float]:
        """1.0 for each layer the stream takes (kept, with at most k - 1
        kept layers after it), else 0.0."""
        out, later = [0.0] * len(keeps), 0.0
        for i in reversed(range(len(keeps))):
            later += keeps[i]
            if keeps[i] and later <= self.k:
                out[i] = 1.0
        return out

    def reduced(self, tap: torch.Tensor) -> torch.Tensor:
        """What the stream sums of one tap (before the fp32 cast)."""
        return tap if self.reduce is None else self.reduce(tap)

    def of(self, taps: Sequence[torch.Tensor], keeps: Optional[Sequence[float]] = None
           ) -> torch.Tensor:
        """The value from a plain stack's taps (``keeps`` None: every layer
        kept); a mean is ``top_k_tap_average``'s."""
        if self.mean:
            return top_k_tap_average([self.reduced(t) for t in taps], self.k, keeps)
        w = self.weights([1.0] * len(taps) if keeps is None else keeps)
        chosen = [self.reduced(t).float() for t, wi in zip(taps, w) if wi]
        if not chosen:
            return torch.zeros_like(self.reduced(taps[-1]), dtype=torch.float32)
        return sum(chosen[1:], chosen[0])


class _Transport:
    """Point-to-point transfers and broadcasts between the stages of one
    (data, model) coordinate, on device tensors (NCCL, or gloo on the CPU)
    or through host tensors (gloo with ranks on a card)."""

    def __init__(self, dp: DataParallel):
        axis = dp.stage
        self.group = axis.group
        self.ranks = dist.get_process_group_ranks(axis.group)
        self.host = dp.backend == "gloo" and dp.device.type == "cuda"

    def send(self, tensors, stage: int) -> None:
        for t in tensors:
            t = t.detach().contiguous()
            dist.send(t.cpu() if self.host else t, dst=self.ranks[stage], group=self.group)

    def recv(self, like, stage: int) -> List[torch.Tensor]:
        out = []
        for shape, dtype, device in like:
            buf = torch.empty(shape, dtype=dtype, device="cpu" if self.host else device)
            dist.recv(buf, src=self.ranks[stage], group=self.group)
            out.append(buf.to(device))
        return out

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        buf = t.detach().contiguous()
        buf = buf.cpu() if self.host else buf
        dist.broadcast(buf, src=self.ranks[stage], group=self.group)
        return buf.to(t.device)


def split_trunk(stack: BlockStack, dp: DataParallel, microbatches: int = 0) -> None:
    """Keep the stage's ``depth / S`` layers of the trunk ``stack`` (stage s
    holds layers s * depth / S ..) and run it as a GPipe over the stages of
    ``dp``; ``microbatches`` 0 picks 2 S at most (``pick_microbatches``)."""
    stages = dp.stage.size
    if stack.depth % stages:
        raise ValueError(f"depth {stack.depth} is not divisible by {stages} pipeline stages")
    per = stack.depth // stages
    first = dp.stage.rank * per
    stack.layers = torch.nn.ModuleDict(
        {str(i): stack.layers[i] for i in range(first, first + per)})
    stack.pipeline = GPipe(dp, stack.depth, first, per, microbatches)


class GPipe:
    """The schedule of one stage of a pipelined trunk (``split_trunk``)."""

    def __init__(self, dp: DataParallel, depth: int, first: int, per: int, microbatches: int):
        self.dp, self.depth, self.first, self.per = dp, depth, first, per
        self.stages, self.stage = dp.stage.size, dp.stage.rank
        self.microbatches = microbatches
        self.transport = _Transport(dp)

    def run(self, stack: BlockStack, x, padding_mask, bias, rngs, scales, stream):
        """``BlockStack.forward`` of the pipelined trunk: (x, None (the taps
        stay on their stages), keeps, the ``stream``'s sum or mean (None
        without a stream))."""
        if bias is not None and not isinstance(bias, AlibiSpec):
            raise NotImplementedError(
                "a pipelined trunk takes a structured ALiBi bias or none; JAX runs a dense "
                "attention bias through the plain scan instead (models/modules.py:813)")
        b = x.shape[0]
        n_micro = pick_microbatches(b, self.stages, self.microbatches)
        keeps = [1.0] * self.depth
        dropping = stack.training and stack.layerdrop > 0.0
        if dropping:
            draws = torch.rand((self.depth,), generator=rngs.host)
            keeps = [0.0 if float(d) < stack.layerdrop else 1.0 for d in draws]
        template = next(iter(stack.layers.values()))
        shape = torch.empty((), device=x.device).expand(x.shape)
        layer_draws = [template.draws(shape, rngs, stack.rates[i]) if keeps[i] else None
                       for i in range(self.depth)]
        weights = [0.0] * self.depth if stream is None else stream.weights(keeps)
        plan = _Plan(self, stack, x, padding_mask, bias, scales, n_micro, keeps, layer_draws,
                     weights, stream)
        slopes = None if bias is None else bias.slopes
        if torch.is_grad_enabled() and any(p.requires_grad for p in stack.parameters()):
            # the anchor makes the backward run even where no input needs a gradient
            anchor = torch.zeros((), device=x.device, requires_grad=True)
            out, acc = _Trunk.apply(plan, x, slopes, scales, anchor)
        else:
            out, acc = plan.forward(x, slopes, scales, keep_graph=False)
        if stream is None:
            acc = None
        elif stream.mean:
            n = sum(weights)
            acc = acc / n if n else torch.zeros_like(acc)
        return out, None, keeps if dropping else None, acc


class _Plan:
    """One call of the pipelined trunk: its microbatches, layers and draws,
    and in training each microbatch's local graph for the backward."""

    def __init__(self, pipe: GPipe, stack, x, padding_mask, bias, scales, n_micro, keeps,
                 layer_draws, weights, stream):
        self.pipe, self.stack = pipe, stack
        self.b, self.t, self.c = x.shape
        self.dtype, self.device = x.dtype, x.device
        self.padding_mask, self.bias = padding_mask, bias
        self.n_micro, self.mb = n_micro, self.b // n_micro
        self.keeps, self.layer_draws = keeps, layer_draws
        self.weights, self.stream = weights, stream
        self.saved: List[Tuple] = []

    def _rows(self, m: int) -> Tuple[int, int]:
        return m * self.mb, (m + 1) * self.mb

    def _layers(self, xin, acc, m, slopes, scales):
        """The stage's layers on microbatch ``m``: (y, acc)."""
        lo, hi = self._rows(m)
        pm = None if self.padding_mask is None else (
            self.padding_mask[lo:hi] if self.padding_mask.shape[0] == self.b else
            self.padding_mask)
        bias = self.bias
        if bias is not None:
            pos = bias.positions
            if pos.shape[0] == self.b and self.b > 1:
                pos = pos[lo:hi]
            bias = dataclasses.replace(bias, slopes=slopes, positions=pos)
        stream = self.stream
        for i in range(self.pipe.first, self.pipe.first + self.pipe.per):
            if not self.keeps[i]:
                continue
            block = self.stack.layers[str(i)]
            draws = block.slice_draws(self.layer_draws[i], lo, hi, self.t)
            xin, tap = block(xin, pm, bias if scales is None else scale_bias(bias, scales[i]),
                             None, draws)
            if self.weights[i]:
                red = stream.reduced(tap).float()
                acc = red if acc is None else acc + red
        return xin, acc

    def forward(self, x, slopes, scales, keep_graph: bool):
        """The forward schedule; the last stage's outputs on every stage."""
        pipe, tr = self.pipe, self.pipe.transport
        s, last = pipe.stage, pipe.stages - 1
        streaming = self.stream is not None
        shape = (self.mb, self.t, self.c)
        outs, accs = [], []
        for m in range(self.n_micro):
            lo, hi = self._rows(m)
            if s == 0:
                xin, acc = x[lo:hi].detach(), None
            else:
                got = tr.recv([(shape, self.dtype, self.device)]
                              + ([(shape, torch.float32, self.device)] if streaming else []),
                              s - 1)
                xin, acc = got[0], (got[1] if streaming else None)
            if keep_graph:
                xin.requires_grad_(True)
                if acc is not None:
                    acc.requires_grad_(True)
            acc_in = acc
            with torch.set_grad_enabled(keep_graph):
                y, acc = self._layers(xin, acc, m, slopes, scales)
            if streaming and acc is None:
                acc = torch.zeros(shape, dtype=torch.float32, device=self.device)
            if keep_graph:
                self.saved.append((xin, acc_in, y, acc))
            if s < last:
                tr.send([y] + ([acc] if streaming else []), s + 1)
            else:
                outs.append(y.detach())
                accs.append(acc.detach() if streaming else None)
        if s == last:
            out = torch.cat(outs)
            acc = torch.cat(accs) if streaming else torch.empty(0, device=self.device)
        else:
            out = torch.empty((self.b, self.t, self.c), dtype=self.dtype, device=self.device)
            acc = torch.empty((self.b, self.t, self.c) if streaming else 0, dtype=torch.float32,
                              device=self.device)
        out = tr.broadcast(out, last)
        if streaming:
            acc = tr.broadcast(acc, last)
        return out, acc

    def backward(self, g_out, g_acc, x, slopes, scales):
        """The backward schedule: the microbatches in reverse, each through
        the stage's local graph; returns the gradients of (x, slopes,
        scales), equal on every stage."""
        pipe, tr = self.pipe, self.pipe.transport
        s, last = pipe.stage, pipe.stages - 1
        streaming = self.stream is not None
        shape = (self.mb, self.t, self.c)
        g_x = torch.zeros_like(x) if s == 0 else None
        for m in reversed(range(self.n_micro)):
            lo, hi = self._rows(m)
            xin, acc_in, y, acc = self.saved[m]
            if s == last:
                gy = g_out[lo:hi]
                ga = g_acc[lo:hi] if streaming else None
            else:
                got = tr.recv([(shape, self.dtype, self.device)]
                              + ([(shape, torch.float32, self.device)] if streaming else []),
                              s + 1)
                gy, ga = got[0], (got[1] if streaming else None)
            pairs = [(y, gy)] + ([(acc, ga)] if streaming else [])
            pairs = [(t, g) for t, g in pairs if t.requires_grad]
            if pairs:
                torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
            gx_in = xin.grad if xin.grad is not None else torch.zeros_like(xin)
            if s > 0:
                ga_in = None
                if streaming:
                    ga_in = acc_in.grad if acc_in.grad is not None else torch.zeros_like(acc_in)
                tr.send([gx_in] + ([ga_in] if streaming else []), s - 1)
            else:
                g_x[lo:hi] = gx_in
        self.saved.clear()
        if s != 0:
            g_x = torch.empty_like(x)
        g_x = tr.broadcast(g_x, 0)
        grads = []
        for leaf in (slopes, scales):
            if leaf is None:
                grads.append(None)
                continue
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            grads.append(self.pipe.dp.stage.all_reduce(g.contiguous()))
        return g_x, grads[0], grads[1]


class _Trunk(torch.autograd.Function):
    """The pipelined trunk under autograd: its forward runs the schedule and
    keeps each microbatch's graph (over leaf copies of the slopes and the
    per-layer scales), its backward the reverse schedule."""

    @staticmethod
    def forward(ctx, plan: _Plan, x, slopes, scales, anchor):
        ctx.plan, ctx.leaves = plan, tuple(
            None if t is None else t.detach().requires_grad_(t.requires_grad)
            for t in (slopes, scales))
        ctx.save_for_backward(x)
        return plan.forward(x, *ctx.leaves, keep_graph=True)

    @staticmethod
    def backward(ctx, g_out, g_acc):
        (x,) = ctx.saved_tensors
        g_x, g_slopes, g_scales = ctx.plan.backward(g_out, g_acc, x, *ctx.leaves)
        return None, g_x, g_slopes, g_scales, None
