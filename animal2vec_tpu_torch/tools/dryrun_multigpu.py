"""Data-parallel dry run: the port of ``__graft_entry__.dryrun_multichip``
for the "data" axis (no tensor, pipeline or FSDP sharding: ROADMAP A.10).

Usage:
  python -m animal2vec_tpu_torch.tools.dryrun_multigpu [--ranks 2] \\
      [--device cuda|cpu] [--dist-backend nccl|gloo] [--width small|a2v-large] \\
      [--batch B] [--parts finetune,pretrain,infer,masks] [--out result.json]

Starts ``--ranks`` processes in one group (``parallel.mesh.launch``), each
holding B rows of a seeded global batch of ranks x B rows, and runs:

* ``finetune``: one finetune step (``finetune_100.yaml`` with every rate 0,
  mixup and masks off, update_freq 2) through the data-parallel step;
* ``pretrain``: one data2vec-2 step (clone 2, update_freq 2, one seeded
  global mask, every rate 0);
* ``infer``: the eval forward of each rank's rows, gathered to rank 0;
* ``masks``: one post-LN block in training with attention, activation and
  post-MLP hash dropout on the same rows on every rank (the ranks' masks
  must differ) against rank 0's one-rank call on every rank's rows stacked
  (each rank's output must be the slice of its global rows).

The finetune part takes a second step on the same batch, timed (host
clock around the step, synchronized), with the gradient all-reduce timed
on its own. Rank 0 then runs each part as one rank on the whole global
batch (the finetune step also twice, the second timed) and prints the
gaps after the first step: parameters (max abs over every tensor; a one-step Adam
update moves a parameter by at most lr, so a flipped gradient sign moves it
by 2 lr: the bound is 2.1 lr), the loss (relative), the EMA teacher and the
probabilities; every rank's parameter checksum must agree. ``--width
small`` is C 128, 2 heads, 2 + 2 blocks on 800-sample clips (the kernels'
widths); ``a2v-large`` the recipe's full model on 10-s clips. With
``--device cpu`` the ranks are gloo processes on the CPU.
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

from animal2vec_tpu_torch.config import (
    DecoderConfig, FinetuneConfig, FinetuneTrainConfig, OptimizationConfig, PretrainConfig,
)
from animal2vec_tpu_torch.parallel import mesh

SMALL = dict(embed_dim=128, num_heads=2, depth=2, prenet_depth=2, conv_pos_depth=2,
             conv_pos_width=10, conv_pos_groups=2, average_top_k_layers=2,
             conv_layers=((32, 9, 1), (64, 4, 2), (64, 3, 2)), labels=("a", "b", "c", "d"))
LR = 1e-4
OPT = OptimizationConfig(lr=LR, warmup_updates=0, update_freq=2)
PARAM_BOUND = 2.1 * LR  # two opposite one-step Adam updates, with weight decay
PARTS = ("finetune", "pretrain", "infer", "masks")


def _model_cfg(width: str) -> FinetuneConfig:
    return FinetuneConfig() if width == "a2v-large" else dataclasses.replace(
        FinetuneConfig(), **SMALL)


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


def _checksum(params) -> float:
    return float(sum(p.detach().double().sum() for p in params))


def _gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _launches() -> Dict[str, int]:
    from animal2vec_tpu_torch.ops.attention import (
        alibi_flash_attention_packed, alibi_flash_attention_serve,
    )
    from animal2vec_tpu_torch.ops.fused_mlp import fused_block_mlp

    return {"alibi_train": alibi_flash_attention_packed.launches,
            "alibi_serve": alibi_flash_attention_serve.launches,
            "fused_block": fused_block_mlp.launches}


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
        """The first step's state dict, metrics and launches; the second
        step's seconds."""
        model = build_finetune_model(cfg, _dtype(dp), seed=0, device=dp.device, train=tcfg)
        state = FinetuneState.create(model, tcfg)
        step = make_finetune_train_step(tcfg, group)
        b = {k: v.to(dp.device) for k, v in rows.items()}
        rngs = Rngs.from_seed(5, dp.device, group.rank)
        metrics, launches = _counted(lambda: step(state, b, rngs))
        first = ({k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                 float(metrics["loss"]), _checksum(state.model.parameters()))
        _sync(dp)
        t0 = time.perf_counter()
        step(state, b, rngs)
        _sync(dp)
        return first, launches, time.perf_counter() - t0

    reduce_s: List[float] = []
    _timed_reduce(dp, reduce_s)
    (params, loss, checksum), launches, step_s = run(
        {k: _rows(v, dp, 1) for k, v in full.items()}, dp)
    sums = dp.all_gather_object(checksum)
    out = {"launches": launches, "checksums_equal": len(set(sums)) == 1,
           "step_ms": 1e3 * step_s, "all_reduce_ms": 1e3 * reduce_s[-1] if reduce_s else 0.0}
    if dp.is_main:
        if dp.device.type == "cuda":
            torch.cuda.empty_cache()
        (ref_params, ref_loss, _), _, ref_s = run(full, mesh.DataParallel(device=dp.device))
        out.update(param_gap=_gap(params, ref_params), bound=PARAM_BOUND, loss=loss,
                   ref_loss=ref_loss, loss_rel_gap=abs(loss - ref_loss) / abs(ref_loss),
                   one_rank_step_ms=1e3 * ref_s)
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
        model = build_pretrain_model(cfg, _dtype(dp), seed=0, device=dp.device)
        state = PretrainState.create(model, cfg)
        step = make_pretrain_train_step(cfg, draw, group)
        b = {k: v.to(dp.device) for k, v in b_rows.items()}
        metrics, launches = _counted(lambda: step(state, b, Rngs.from_seed(5, dp.device,
                                                                           group.rank)))
        return state, metrics, launches

    state, metrics, launches = run({k: _rows(v, dp, 1) for k, v in full.items()}, dp)
    sums = dp.all_gather_object((_checksum(state.model.parameters()),
                                 _checksum(state.ema.values())))
    params = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    ema = {k: v.cpu() for k, v in state.ema.items()}
    loss = float(metrics["loss"])
    del state
    out = {"launches": launches, "checksums_equal": len(set(sums)) == 1}
    if dp.is_main:
        if dp.device.type == "cuda":
            torch.cuda.empty_cache()
        ref, ref_metrics, _ = run(full, mesh.DataParallel(device=dp.device))
        out.update(param_gap=_gap(params, {k: v.detach().cpu()
                                           for k, v in ref.model.state_dict().items()}),
                   ema_gap=_gap(ema, {k: v.cpu() for k, v in ref.ema.items()}),
                   bound=PARAM_BOUND, loss=loss, ref_loss=float(ref_metrics["loss"]),
                   loss_rel_gap=abs(loss - float(ref_metrics["loss"])) / abs(float(
                       ref_metrics["loss"])))
        del ref
    dp.barrier()
    return out


def infer_part(dp: mesh.DataParallel, width: str, batch: int) -> dict:
    from animal2vec_tpu_torch.models.finetune import build_finetune_model

    cfg = _model_cfg(width)
    model = build_finetune_model(cfg, _dtype(dp), seed=3, device=dp.device)
    src = torch.from_numpy(np.random.default_rng(9).normal(
        size=(batch * dp.world, _wav_len(width))).astype(np.float32))
    with torch.no_grad():
        probs, launches = _counted(lambda: torch.sigmoid(
            model(_rows(src, dp).to(dp.device))["encoder_out"].float()).cpu())
        gathered = dp.allgather_uneven(probs.numpy(), np.float32)
        out = {"launches": launches}
        if dp.is_main:
            ref = torch.sigmoid(model(src.to(dp.device))["encoder_out"].float()).cpu().numpy()
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


def _spec(heads: int, pos: torch.Tensor, device):
    from animal2vec_tpu_torch.models.attention import AlibiSpec

    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / heads) for i in range(heads)],
                          device=device)
    return AlibiSpec(slopes, pos)


def run_parts(dp: mesh.DataParallel, width: str, batch: int, parts: List[str]) -> dict:
    table = {"finetune": finetune_part, "pretrain": pretrain_part, "infer": infer_part,
             "masks": masks_part}
    return {p: table[p](dp, width, batch) for p in parts}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist-backend", default=None, choices=mesh.BACKENDS)
    parser.add_argument("--width", default="small", choices=("small", "a2v-large"))
    parser.add_argument("--batch", type=int, default=2, help="rows per rank")
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
    dp = mesh.init_data_parallel(args.device, backend)
    try:
        result = run_parts(dp, args.width, args.batch, parts)
        if dp.is_main:
            line = json.dumps({"ranks": dp.world, "backend": backend, "width": args.width,
                               "batch_per_rank": args.batch, **result})
            print(f"dryrun_multigpu {line}", flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(line)
        return result
    finally:
        dp.close()


if __name__ == "__main__":
    main()
