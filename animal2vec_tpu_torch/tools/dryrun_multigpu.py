"""Multi-rank dry run: the port of ``__graft_entry__.dryrun_multichip`` over
the mesh's "data", "stage" and "model" axes.

Usage:
  python -m animal2vec_tpu_torch.tools.dryrun_multigpu [--ranks 2] \\
      [--device cuda|cpu] [--dist-backend nccl|gloo] [--width small|a2v-large] \\
      [--depth N] [--layout SPEC ...] [--batch B] \\
      [--parts finetune,pretrain,infer,masks,tp_masks] [--out result.json]

Starts ``--ranks`` processes in one group (``parallel.mesh.launch``) and, for
each ``--layout`` in turn (data parallelism without one), lays out
``distributed`` data = ranks / (S x M) x stage S x model M, with FSDP where
the spec says (a "+"-joined ``model=M``, ``stage=S``, ``fsdp``; or ``dp``;
``parallel/layout.py``), each data rank holding B rows of a seeded global
batch of data x B rows, and runs:

* ``finetune``: one finetune step (``finetune_100.yaml`` with every rate 0,
  mixup and masks off, update_freq 2) through the data-parallel step;
* ``pretrain``: one data2vec-2 step (clone 2, update_freq 2, one seeded
  global mask, every rate 0);
* ``infer``: the eval forward of each rank's rows, gathered to rank 0;
* ``masks``: one post-LN block in training with attention, activation and
  post-MLP hash dropout on the same rows on every rank (the ranks' masks
  must differ) against rank 0's one-rank call on every rank's rows stacked
  (each rank's output must be the slice of its global rows);
* ``tp_masks`` (a "model" axis): each rank's attention with dropout on its
  heads (``h0``) and the split block's fc1 with drop_a on its hidden
  columns (``col0``) against the whole call on the same inputs: the rank's
  outputs must be the whole call's heads and columns bit for bit (so its
  masks are their slices).

The finetune part takes a second step on the same batch, timed (host
clock around the step, synchronized), with the gradient all-reduce timed
on its own. Rank 0 then runs each part as one rank on the whole global
batch (the finetune step also twice, the second timed) and prints the
gaps of the first step: the gradients the optimizer took (each leaf's
relative norm gap, the worst leaf's and the whole gradient's, a sharded
layout's gathered whole by ``layout.full_state``; and the global norm by
``layout.grad_sq_norm`` that clipping reads; under FSDP against the same
layout without it, whose data split they share), parameters after it (max
abs over every tensor; a one-step Adam update moves a parameter by at
most lr whatever the gradient's size, so a flipped gradient sign moves it
by 2 lr: the bound is 2.1 lr, and the gradients carry the check of the
sharded backward), the loss (relative), the EMA teacher and the
probabilities; every rank's checksum of the parameters it holds whole must
agree. Each step part also times a second step (host clock, synchronized)
and reports each rank's peak device memory. ``--width small`` is C 128, 2
heads, 2 + 2 blocks on 800-sample clips (the kernels' widths);
``a2v-large`` the recipe's full model on 10-s clips; ``--depth`` cuts the
trunk to N blocks and the prenet to 2 (the widths stay). With ``--device
cpu`` the ranks are gloo processes on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

import torch.distributed as dist

from animal2vec_tpu_torch.config import (
    DecoderConfig, DistributedConfig, FinetuneConfig, FinetuneTrainConfig, OptimizationConfig,
    PretrainConfig,
)
from animal2vec_tpu_torch.parallel import mesh
from animal2vec_tpu_torch.parallel.layout import (
    apply_layout, full_state, grad_sq_norm, in_trunk,
)
from animal2vec_tpu_torch.parallel.tensor import tp_rule

SMALL = dict(embed_dim=128, num_heads=2, depth=2, prenet_depth=2, conv_pos_depth=2,
             conv_pos_width=10, conv_pos_groups=2, average_top_k_layers=2,
             conv_layers=((32, 9, 1), (64, 4, 2), (64, 3, 2)), labels=("a", "b", "c", "d"))
LR = 1e-4
OPT = OptimizationConfig(lr=LR, warmup_updates=0, update_freq=2)
PARAM_BOUND = 2.1 * LR  # two opposite one-step Adam updates, with weight decay
# a leaf's relative gradient gap against one rank: bf16 rounding in another
# order stays near 1e-2, a missing or doubled collective moves a leaf by 0.5
# or more (half of a sum lost, or twice counted)
GRAD_BOUND = 0.1
PARTS = ("finetune", "pretrain", "infer", "masks", "tp_masks")
DEPTH: Dict[str, int] = {}  # the --depth cut, set by main


def _model_cfg(width: str) -> FinetuneConfig:
    cfg = FinetuneConfig() if width == "a2v-large" else dataclasses.replace(
        FinetuneConfig(), **SMALL)
    if DEPTH:
        depth = DEPTH["depth"]
        cfg = dataclasses.replace(cfg, depth=depth, prenet_depth=min(cfg.prenet_depth, 2),
                                  average_top_k_layers=min(cfg.average_top_k_layers, depth))
    return cfg


def _wav_len(width: str) -> int:
    return 80_000 if width == "a2v-large" else 800


def _train_cfg() -> FinetuneTrainConfig:
    return dataclasses.replace(
        FinetuneTrainConfig(), freeze_finetune_updates=0, apply_mask=False,
        mask_channel_prob=0.0, dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        layerdrop=0.0, source_mixup=-1.0, optimization=OPT)


def _pretrain_cfg(width: str) -> PretrainConfig:
    model = _model_cfg(width)
    dec = DecoderConfig(decoder_dim=64, decoder_groups=4, decoder_kernel=3, decoder_layers=2,
                        input_dropout=0.0) if width == "small" else DecoderConfig()
    return dataclasses.replace(
        PretrainConfig(), model=model, average_top_k_layers=model.average_top_k_layers,
        decoder=dec, clone_batch=2, mask_noise_std=0.0, encoder_dropout=0.0,
        attention_dropout=0.0, post_mlp_drop=0.0, prenet_dropout=0.0, source_mixup=-1.0,
        optimization=OPT)


def _dtype(dp: mesh.DataParallel) -> torch.dtype:
    """bf16 compute on the card (the kernels' dtype), fp32 on the CPU."""
    return torch.bfloat16 if dp.device.type == "cuda" else torch.float32


def _rows(x: torch.Tensor, dp: mesh.DataParallel, axis: int = 0) -> torch.Tensor:
    """This rank's equal share of ``x``'s rows along ``axis``."""
    b = x.shape[axis] // dp.world
    return x.narrow(axis, dp.rank * b, b).contiguous()


def _checksum(dp: mesh.DataParallel, named) -> float:
    """The sum of the parameters this rank holds whole (not a shard of
    "model", FSDP or another stage)."""
    from torch.distributed.tensor import DTensor

    return float(sum(p.detach().double().sum() for n, p in named
                     if not (isinstance(p, DTensor) or (dp.model.size > 1 and tp_rule(n))
                             or (dp.stage.size > 1 and in_trunk(n)))))


def _world_gather(dp: mesh.DataParallel, obj) -> list:
    if dp.global_world == 1:
        return [obj]
    out = [None] * dp.global_world
    dist.all_gather_object(out, obj, group=dp.world_host_group)
    return out


def _whole(dp: mesh.DataParallel, tensors: Dict[str, torch.Tensor]):
    """``tensors`` as whole host tensors on the main rank (None elsewhere)."""
    return full_state(dp, tensors) if dp.sharded else (
        {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()} if dp.is_main
        else None)


def _gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _grads(group: mesh.DataParallel, state):
    """The gradients the optimizer took in the step just run, whole on the
    main rank (None elsewhere), and their global norm by the layout's
    ``grad_sq_norm`` (every rank takes part in both)."""
    from torch.distributed.tensor import DTensor

    named = [(g["name"], g["params"][0]) for g in state.optimizer.param_groups]
    local = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad for _, p in named]
    norm = float(grad_sq_norm(group, named, local).sqrt())
    return _whole(group, {n: p.grad for n, p in named}), norm


def _grad_gaps(grads, norm, ref_grads, ref_norm) -> dict:
    """Each leaf's relative norm gap against the reference's gradients: the
    worst leaf's with its name, the whole gradient's, the global norm's."""
    worst, leaf, num, den = 0.0, "", 0.0, 0.0
    for name, want in ref_grads.items():
        d = float((grads[name].double() - want.double()).norm())
        w = float(want.double().norm())
        num, den = num + d * d, den + w * w
        rel = d / w if w else (0.0 if d == 0.0 else float("inf"))
        if rel > worst:
            worst, leaf = rel, name
    return {"grad_gap": worst, "grad_gap_leaf": leaf, "grad_gap_whole": (num / den) ** 0.5,
            "grad_norm": norm, "ref_grad_norm": ref_norm,
            "grad_norm_gap": abs(norm - ref_norm) / ref_norm, "grad_bound": GRAD_BOUND}


def _grad_reference(dp: mesh.DataParallel, run, rows):
    """The gradients (and norm) the layout's are held against, from ``run``
    on ``rows``: under FSDP the same layout without it, the same rows a data
    rank (data parallelism, which phase 14b holds against one rank), so the
    gap isolates FSDP2's gathers and reduce-scatters from the batch split's
    bf16 rounding; else None (the one-rank run on the global batch)."""
    return run(rows, dataclasses.replace(dp, fsdp=False))[0][-1] if dp.fsdp else None


def _peak_mb(dp: mesh.DataParallel) -> float:
    if dp.device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(dp.device) / 2**20


def _launches() -> Dict[str, int]:
    from animal2vec_tpu_torch.ops.attention import (
        alibi_flash_attention_packed, alibi_flash_attention_serve, attention_dkv, attention_dq,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import (
        block_fc1, block_fc2_partial, block_ln2, fused_block_mlp,
    )

    return {"alibi_train": alibi_flash_attention_packed.launches,
            "alibi_serve": alibi_flash_attention_serve.launches,
            "alibi_dq": attention_dq.launches, "alibi_dkv": attention_dkv.launches,
            "fused_block": fused_block_mlp.launches, "block_fc1": block_fc1.launches,
            "block_fc2_partial": block_fc2_partial.launches, "block_ln2": block_ln2.launches}


def _counted(fn):
    before = _launches()
    out = fn()
    return out, {k: v - before[k] for k, v in _launches().items()}


def _sync(dp: mesh.DataParallel) -> None:
    if dp.device.type == "cuda":
        torch.cuda.synchronize(dp.device)


def _timed_reduce(dp: mesh.DataParallel, seconds: List[float]) -> None:
    """Time every gradient all-reduce of ``dp`` (synchronized) into
    ``seconds``."""
    reduce = dp.reduce_gradients

    def timed(params):
        _sync(dp)
        t0 = time.perf_counter()
        reduce(params)
        _sync(dp)
        seconds.append(time.perf_counter() - t0)

    dp.reduce_gradients = timed


def _timed(dp: mesh.DataParallel, fn) -> float:
    _sync(dp)
    t0 = time.perf_counter()
    fn()
    _sync(dp)
    return time.perf_counter() - t0


def finetune_part(dp: mesh.DataParallel, width: str, batch: int) -> dict:
    from animal2vec_tpu_torch.models.finetune import build_finetune_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.finetune_step import make_finetune_train_step
    from animal2vec_tpu_torch.train.state import FinetuneState

    cfg, tcfg = _model_cfg(width), _train_cfg()
    rng = np.random.default_rng(7)
    n, wav = batch * dp.world, _wav_len(width)
    from animal2vec_tpu_torch.ops.conv_arith import feature_extractor_out_length

    frames = feature_extractor_out_length(wav, cfg.conv_layers)
    full = {"source": torch.from_numpy(rng.normal(size=(2, n, wav)).astype(np.float32)),
            "target": torch.from_numpy((rng.random((2, n, frames, len(cfg.labels))) < 0.1)
                                       .astype(np.float32))}

    def run(rows, group):
        """The first step's whole state dict (main rank), metrics, launches
        and peak memory; the second step's seconds."""
        model = apply_layout(build_finetune_model(cfg, _dtype(dp), seed=0, device=dp.device,
                                                  train=tcfg), group)
        state = FinetuneState.create(model, tcfg, group)
        step = make_finetune_train_step(tcfg, group)
        b = {k: v.to(dp.device) for k, v in rows.items()}
        rngs = Rngs.from_seed(5, dp.device, group.rank)
        if dp.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dp.device)
        metrics, launches = _counted(lambda: step(state, b, rngs))
        first = (_whole(group, state.model.state_dict(keep_vars=True)), float(metrics["loss"]),
                 _checksum(group, state.model.named_parameters()), _peak_mb(dp),
                 _grads(group, state))
        return first, launches, _timed(dp, lambda: step(state, b, rngs))

    reduce_s: List[float] = []
    _timed_reduce(dp, reduce_s)
    mine = {k: _rows(v, dp, 1) for k, v in full.items()}
    (params, loss, checksum, peak, grads), launches, step_s = run(mine, dp)
    twin = _grad_reference(dp, run, mine)
    sums = _world_gather(dp, checksum)
    out = {"launches": launches, "checksums_equal": len(set(sums)) == 1,
           "step_ms": 1e3 * step_s, "all_reduce_ms": 1e3 * reduce_s[-1] if reduce_s else 0.0,
           "peak_mb": _world_gather(dp, peak)}
    if dp.is_main:
        if dp.device.type == "cuda":
            torch.cuda.empty_cache()
        (ref_params, ref_loss, _, ref_peak, ref_grads), _, ref_s = run(
            full, mesh.DataParallel(device=dp.device))
        out.update(_grad_gaps(*grads, *(twin or ref_grads)))
        out.update(param_gap=_gap(params, ref_params), bound=PARAM_BOUND, loss=loss,
                   ref_loss=ref_loss, loss_rel_gap=abs(loss - ref_loss) / abs(ref_loss),
                   one_rank_step_ms=1e3 * ref_s, one_rank_peak_mb=ref_peak)
    dp.barrier()
    return out


def pretrain_part(dp: mesh.DataParallel, width: str, batch: int) -> dict:
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.ops.dropout import Rngs
    from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step, mask_tokens
    from animal2vec_tpu_torch.train.state import PretrainState

    cfg = _pretrain_cfg(width)
    rng = np.random.default_rng(8)
    n, wav = batch * dp.world, _wav_len(width)
    full = {"source": torch.from_numpy(rng.normal(size=(2, n, wav)).astype(np.float32))}
    from animal2vec_tpu_torch.ops.conv_arith import feature_extractor_out_length

    t = feature_extractor_out_length(wav, cfg.model.conv_layers)
    rows = n * cfg.clone_batch
    mask = np.zeros((rows, t), np.int32)
    for r in range(rows):
        mask[r, rng.permutation(t)[:mask_tokens(cfg, t)]] = 1
    mask = torch.from_numpy(mask)

    def draw(r, steps, rngs):  # the global mask's rows of this rank
        return mask[rngs.row0: rngs.row0 + r]

    def run(b_rows, group):
        model = apply_layout(build_pretrain_model(cfg, _dtype(dp), seed=0, device=dp.device),
                             group)
        state = PretrainState.create(model, cfg, group)
        step = make_pretrain_train_step(cfg, draw, group)
        b = {k: v.to(dp.device) for k, v in b_rows.items()}
        rngs = Rngs.from_seed(5, dp.device, group.rank)
        if dp.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dp.device)
        metrics, launches = _counted(lambda: step(state, b, rngs))
        first = (_whole(group, state.model.state_dict(keep_vars=True)), _whole(group, state.ema),
                 float(metrics["loss"]), launches, _peak_mb(dp),
                 _checksum(group, state.model.named_parameters()), _grads(group, state))
        return first, _timed(dp, lambda: step(state, b, rngs))

    mine = {k: _rows(v, dp, 1) for k, v in full.items()}
    (params, ema, loss, launches, peak, checksum, grads), step_s = run(mine, dp)
    twin = _grad_reference(dp, run, mine)
    sums = _world_gather(dp, checksum)
    out = {"launches": launches, "checksums_equal": len(set(sums)) == 1,
           "step_ms": 1e3 * step_s, "peak_mb": _world_gather(dp, peak)}
    if dp.is_main:
        if dp.device.type == "cuda":
            torch.cuda.empty_cache()
        (ref_params, ref_ema, ref_loss, _, ref_peak, _, ref_grads), ref_s = run(
            full, mesh.DataParallel(device=dp.device))
        out.update(_grad_gaps(*grads, *(twin or ref_grads)))
        out.update(param_gap=_gap(params, ref_params), ema_gap=_gap(ema, ref_ema),
                   bound=PARAM_BOUND, loss=loss, ref_loss=ref_loss,
                   loss_rel_gap=abs(loss - ref_loss) / abs(ref_loss),
                   one_rank_step_ms=1e3 * ref_s, one_rank_peak_mb=ref_peak)
    dp.barrier()
    return out


def infer_part(dp: mesh.DataParallel, width: str, batch: int) -> dict:
    from animal2vec_tpu_torch.models.finetune import build_finetune_model

    cfg = _model_cfg(width)
    model = apply_layout(build_finetune_model(cfg, _dtype(dp), seed=3, device=dp.device), dp)
    src = torch.from_numpy(np.random.default_rng(9).normal(
        size=(batch * dp.world, _wav_len(width))).astype(np.float32))
    with torch.no_grad():
        probs, launches = _counted(lambda: torch.sigmoid(
            model(_rows(src, dp).to(dp.device))["encoder_out"].float()).cpu())
        gathered = dp.allgather_uneven(probs.numpy(), np.float32)
        out = {"launches": launches}
        if dp.is_main:
            whole = build_finetune_model(cfg, _dtype(dp), seed=3, device=dp.device)
            ref = torch.sigmoid(whole(src.to(dp.device))["encoder_out"].float()).cpu().numpy()
            out.update(prob_gap=float(np.abs(gathered - ref).max()), shape=list(gathered.shape))
    return out


def masks_part(dp: mesh.DataParallel, width: str, batch: int) -> dict:
    """One post-LN block in training with hash dropout: every rank gives it
    the same rows; rank r's masks are those of global rows r*B .. (r+1)*B."""
    from animal2vec_tpu_torch.models.modules import AltBlock
    from animal2vec_tpu_torch.ops.dropout import Rngs

    cfg = _model_cfg(width)
    c, h = cfg.embed_dim, cfg.num_heads
    t = 2000 if width == "a2v-large" else 200
    torch.manual_seed(11)
    block = AltBlock(c, h, cfg.mlp_ratio, attention_dropout=0.2, activation_dropout=0.1,
                     post_mlp_drop=0.1).to(dp.device).train()
    x = torch.randn(batch, t, c, generator=torch.Generator().manual_seed(12)).to(dp.device,
                                                                                 _dtype(dp))
    pos = torch.arange(t, dtype=torch.int32, device=dp.device)[None]
    enc_spec = _spec(h, pos, dp.device)

    def run(xs, group):
        rngs = Rngs.from_seed(13, dp.device, group.rank)
        rngs.row0 = group.row_offset(xs.shape[0])
        with torch.no_grad():
            y, _ = block(xs, None, enc_spec, rngs)
        return y.float().cpu()

    y = run(x, dp)
    ys = dp.all_gather_object(y)
    out = {"ranks_differ": all(not torch.equal(ys[0], other) for other in ys[1:])}
    if dp.is_main:
        ref = run(torch.cat([x] * dp.world), mesh.DataParallel(device=dp.device))
        out["slice_gap"] = max(float((ys[r] - ref[r * batch:(r + 1) * batch]).abs().max())
                               for r in range(dp.world))
    return out


def tp_masks_part(dp: mesh.DataParallel, width: str, batch: int) -> dict:
    """A "model" rank's attention with dropout on its heads and the split
    block's fc1 with drop_a on its hidden columns, against the whole calls
    on the same inputs: bit for bit the whole calls' heads and columns."""
    from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_btc
    from animal2vec_tpu_torch.ops.fused_mlp import block_fc1

    cfg = _model_cfg(width)
    c, h, m = cfg.embed_dim, cfg.num_heads, int(cfg.embed_dim * cfg.mlp_ratio)
    t = 2000 if width == "a2v-large" else 200
    mp, r = dp.model.size, dp.model.rank
    hl, ms = h // mp, m // mp
    g = torch.Generator().manual_seed(14)
    dt = _dtype(dp)
    qkv = torch.randn(batch, t, 3, h, c // h, generator=g).to(dp.device, dt)
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)], device=dp.device)
    pos = torch.arange(t, dtype=torch.int32, device=dp.device)[None]
    x = torch.randn(batch * t, c, generator=g).to(dp.device, dt)
    w1 = (0.02 * torch.randn(c, m, generator=g)).to(dp.device, dt)
    b1 = 0.02 * torch.randn(m, generator=g).to(dp.device)
    with torch.no_grad():
        whole = alibi_flash_attention_btc(qkv.reshape(batch, t, -1), h, slopes, pos, None,
                                          False, 0.2, 1234).reshape(batch, t, h, -1)
        mine = alibi_flash_attention_btc(
            qkv[:, :, :, r * hl:(r + 1) * hl].reshape(batch, t, -1), hl,
            slopes[r * hl:(r + 1) * hl], pos, None, False, 0.2, 1234, r * hl,
            h).reshape(batch, t, hl, -1)
        _, h_whole = block_fc1(x, None, None, w1, b1, 1e-5, 77, 0.1, 0)
        _, h_mine = block_fc1(x, None, None, w1[:, r * ms:(r + 1) * ms].contiguous(),
                              b1[r * ms:(r + 1) * ms], 1e-5, 77, 0.1, 0, r * ms)
    want_a, want_h = whole[:, :, r * hl:(r + 1) * hl], h_whole[:, r * ms:(r + 1) * ms]
    return {"attention_equal": bool(torch.equal(mine, want_a)),
            "fc1_equal": bool(torch.equal(h_mine, want_h)),
            "fc1_masks_equal": bool(torch.equal(h_mine == 0, want_h == 0)),
            "ranks_equal": _world_gather(dp, (bool(torch.equal(mine, want_a)),
                                              bool(torch.equal(h_mine, want_h))))}


def _spec(heads: int, pos: torch.Tensor, device):
    from animal2vec_tpu_torch.models.attention import AlibiSpec

    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / heads) for i in range(heads)],
                          device=device)
    return AlibiSpec(slopes, pos)


def run_parts(dp: mesh.DataParallel, width: str, batch: int, parts: List[str]) -> dict:
    table = {"finetune": finetune_part, "pretrain": pretrain_part, "infer": infer_part,
             "masks": masks_part, "tp_masks": tp_masks_part}
    return {p: table[p](dp, width, batch) for p in parts}


def _layout(spec: str, ranks: int) -> DistributedConfig:
    """A ``--layout`` spec: "+"-joined ``model=M``, ``stage=S``, ``fsdp``
    (data takes the ranks left), or "dp" (data parallelism alone)."""
    kw = {"model_parallel": 1, "pipeline_parallel": 1, "fsdp": False}
    for item in spec.split("+"):
        key, _, value = item.partition("=")
        if key == "model":
            kw["model_parallel"] = int(value)
        elif key == "stage":
            kw["pipeline_parallel"] = int(value)
        elif key == "fsdp":
            kw["fsdp"] = True
        elif key != "dp":
            raise ValueError(f"--layout {spec!r}: '+'-joined model=M, stage=S, fsdp or dp")
    inner = kw["model_parallel"] * kw["pipeline_parallel"]
    return DistributedConfig(data_parallel=max(1, ranks // inner), **kw)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist-backend", default=None, choices=mesh.BACKENDS)
    parser.add_argument("--width", default="small", choices=("small", "a2v-large"))
    parser.add_argument("--depth", type=int, default=0,
                        help="cut the trunk to this many blocks (and the prenet to 2)")
    parser.add_argument("--layout", action="append", default=[], metavar="SPEC",
                        help="run the parts under each such layout in turn, in one launch "
                             "('+'-joined model=M, stage=S, fsdp; or dp; default dp)")
    parser.add_argument("--batch", type=int, default=2, help="rows per data rank")
    parser.add_argument("--parts", default=",".join(PARTS))
    parser.add_argument("--out", default="", help="write rank 0's result JSON here")
    argv = sys.argv[1:] if argv is None else [str(a) for a in argv]
    args = parser.parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    if any(p not in PARTS for p in parts):
        raise ValueError(f"--parts: each of {PARTS}")
    backend = args.dist_backend or mesh.default_backend(args.device)
    if not mesh.from_env():
        mesh.launch(["-m", "animal2vec_tpu_torch.tools.dryrun_multigpu", *argv], args.ranks)
        return None
    layouts = {spec: _layout(spec, args.ranks) for spec in args.layout} or {
        "": _layout("dp", args.ranks)}
    if args.depth:
        DEPTH["depth"] = args.depth
    base = mesh.init_data_parallel(args.device, backend)
    try:
        results = {}
        for spec, layout in layouts.items():
            dp = mesh.layout(base, layout)
            # tp_masks needs a "model" axis
            results[spec] = dict(run_parts(dp, args.width, args.batch,
                                           [p for p in parts if p != "tp_masks"
                                            or layout.model_parallel > 1]),
                                 layout=dataclasses.asdict(layout))
        result = results[""] if "" in results else results
        if base.is_main:
            line = json.dumps({"ranks": base.global_world, "backend": backend,
                               "width": args.width, "depth": _model_cfg(args.width).depth,
                               "batch_per_rank": args.batch, **result})
            print(f"dryrun_multigpu {line}", flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(line)
        return result
    finally:
        base.close()


if __name__ == "__main__":
    main()
