"""Finetuning steps: the port of ``animal2vec_tpu/train/finetune_step.py``.

``finetune_loss``: BC mixup of sources and targets, the span mask (applied
in place) and the channel mask, the freeze gate from the step, the focal
(or label-smoothed) loss over all frames, and confusion-count metrics.
``make_finetune_train_step`` accumulates gradients over ``update_freq``
micro-batches (the batch carries a leading micro-batch axis, as in JAX):
gradients and metrics are averaged, then the optimizer applies one update.

Data parallelism (``parallel.mesh.DataParallel``): JAX normalizes each
micro-batch's loss by its frame count over the whole sharded batch, so
each rank divides its summed loss by the count summed over the ranks (one
all-reduce of each micro-batch's count before its backward), the
gradients are summed over the ranks once per optimizer step, after the
``update_freq`` micro-batches, and the metrics are reduced. The kernels'
hash masks read global rows (``Rngs.row0``, the rank's first row of the
global batch). Under a sharded layout (``parallel/layout.py``) the counts,
the replicated parameters' gradients and the metrics reduce over "data"
only; the ALiBi scale's gradient, which each "model" rank sees through its
heads only, is summed over "model" first.

Random draws come from an explicit ``ops.dropout.Rngs``: the mixup draws
and the masks on its rank's own rows generator, the kernels' int32 hash
seeds and the layerdrop decisions on its host generator, the noise fill
and elementwise dropout on its device generator. ``jax.random`` and torch
draw differently from one seed, so the tests hold a step to JAX with the
random parts off and the random parts to their invariants.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from animal2vec_tpu_torch.config import FinetuneTrainConfig
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.ops.conv_arith import feature_extractor_out_length
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.ops.losses import label_smoothed_nll_loss, sigmoid_focal_loss
from animal2vec_tpu_torch.ops.masking import channel_mask, span_mask
from animal2vec_tpu_torch.ops.mixup import bc_mixup
from animal2vec_tpu_torch.ops.stats import confusion_counts
from animal2vec_tpu_torch.parallel.layout import reduce_model_partials
from animal2vec_tpu_torch.parallel.mesh import DataParallel
from animal2vec_tpu_torch.train.state import FinetuneState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def finetune_loss(model: FinetuneModel, batch: Batch, rngs: Optional[Rngs], step: int,
                  cfg: FinetuneTrainConfig, train: bool = True,
                  normalize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                  ) -> Tuple[torch.Tensor, Metrics]:
    """Mean loss over the frames and the metrics of one (micro-)batch:
    ``source`` (B, T_wav), ``target`` (B, T, n_classes), optional
    ``padding_mask`` (B, T_wav) and ``n_valid`` (eval batches padded by
    repeated rows). Puts the model in train or eval mode. ``normalize``
    maps the frame count to the loss's divisor (data parallelism: the count
    summed over the ranks)."""
    mcfg = model.cfg
    source = batch["source"]
    target = batch["target"].float()
    padding_mask = batch.get("padding_mask")
    if train and cfg.source_mixup >= 0 and cfg.mixup_prob > 0:
        source, target = bc_mixup(
            source, target, cfg.source_mixup, cfg.mixup_prob, cfg.same_mixup, cfg.gain_mode,
            mcfg.sample_rate, cfg.mixing_window_length, cfg.target_mixup, rngs.rows,
        )
    b = source.shape[0]
    t_feat = feature_extractor_out_length(source.shape[1], mcfg.conv_layers)
    mask = cmask = None
    if train and cfg.apply_mask and cfg.mask_prob > 0:
        mask = span_mask(b, t_feat, cfg.mask_prob, cfg.mask_length, rngs.rows)
    if train and cfg.mask_channel_prob > 0:
        cmask = channel_mask(b, mcfg.embed_dim, cfg.mask_channel_prob, cfg.mask_channel_length,
                             rngs.rows)

    model.train(train)
    gate = step >= cfg.freeze_finetune_updates
    out = model(source, padding_mask, mask, cmask, gate, rngs if train else None)
    logits = out["encoder_out"]  # (B, T, n_classes)
    t_frames = logits.shape[1]
    dev = logits.device

    # eval batches: repeated padding rows and padded frames leave every
    # summed metric; training sums over all frames (finetune_step.py:96-114)
    n_valid = batch.get("n_valid")
    if n_valid is not None:
        row_w = (torch.arange(b, device=dev) < n_valid).float()
    else:
        row_w = torch.ones((b,), device=dev)
    frame_pad = out["padding_mask"]
    if not train and frame_pad is not None:
        fw = row_w[:, None] * (1.0 - frame_pad.float())
    else:
        fw = row_w[:, None].expand(b, t_frames)

    if cfg.use_focal_loss:
        loss = (sigmoid_focal_loss(logits, target) * fw[:, :, None]).sum()
    else:
        loss = label_smoothed_nll_loss(logits, target.long().reshape(-1), cfg.label_smoothing,
                                       reduction="none")
        loss = (loss.reshape(b, t_frames) * fw).sum()
    ntokens = fw.sum()
    loss_n = loss / (ntokens if normalize is None else normalize(ntokens))

    metrics: Metrics = {"loss": loss_n.detach(), "sample_size": ntokens}
    p32 = None
    if not train:
        p32 = torch.sigmoid(logits.float())
        metrics["_predictions"] = p32
        metrics["_frame_valid"] = fw > 0
    if cfg.report_accuracy:
        if p32 is None:
            p32 = torch.sigmoid(logits.detach().float())
        preds = (p32 >= mcfg.metric_threshold).int()
        tgt_bin = (target >= 0.5).int()
        w3 = fw[:, :, None]
        tp, fp, tn, fn = confusion_counts(preds, tgt_bin, weights=w3)
        metrics.update({
            "finetune/n_correct": ((preds == tgt_bin) * w3).sum(),
            "finetune/total": ntokens * logits.shape[-1],
            "finetune/tp": tp, "finetune/fp": fp, "finetune/tn": tn, "finetune/fn": fn,
        })
    return loss_n, metrics


def make_finetune_train_step(
    cfg: FinetuneTrainConfig, dp: Optional[DataParallel] = None,
) -> Callable[[FinetuneState, Batch, Rngs], Metrics]:
    """``train_step(state, batch, rngs) -> metrics``: every tensor of
    ``batch`` has a leading axis of ``update_freq`` micro-batches; the
    gradients of the micro-batches' mean losses are averaged and applied
    once, and ``state.step`` advances by one. Under ``dp`` the batch is the
    rank's shard, and the losses, gradients and metrics are the global
    batch's."""
    accum = max(1, cfg.optimization.update_freq)
    dp = dp or DataParallel()
    normalize = None if dp.world == 1 else (lambda n: dp.all_reduce(n.clone()))

    def train_step(state: FinetuneState, batch: Batch, rngs: Rngs) -> Metrics:
        state.zero_grad()
        total: Metrics = {}
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            rngs.row0 = dp.row_offset(len(mb["source"]))
            loss, metrics = finetune_loss(state.model, mb, rngs, state.step, cfg, True, normalize)
            (loss / accum).backward()
            for k, v in metrics.items():
                total[k] = total[k] + v if k in total else v
        reduce_model_partials(dp, state.model.named_parameters())
        dp.reduce_gradients(p for g in state.optimizer.param_groups for p in g["params"])
        state.apply_gradients()
        return dp.reduce_metrics({k: v / accum for k, v in total.items()})

    return train_step


def make_finetune_eval_step(
    cfg: FinetuneTrainConfig,
) -> Callable[[FinetuneState, Batch], Metrics]:
    """``eval_step(state, batch) -> metrics`` of one batch in eval mode
    (no mixup, masks or dropout; the loss over the valid frames)."""

    def eval_step(state: FinetuneState, batch: Batch) -> Metrics:
        with torch.no_grad():
            return finetune_loss(state.model, batch, None, state.step, cfg, train=False)[1]

    return eval_step
