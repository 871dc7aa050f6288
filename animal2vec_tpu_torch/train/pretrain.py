"""data2vec-2 pretraining steps: the port of ``animal2vec_tpu/train/pretrain.py``.

``pretrain_loss``: BC mixup (audio, training; with ``target_mixup`` and
labels the labels mix too), the local features, the clone batch (each row
repeated ``clone_batch`` times, each clone with its own mask), the
static-count mask (2-D blocks for images, spans for audio) and its
``MaskInfo`` (``keep_masked_pct`` of the masked tokens kept), the keep-set
student (noise-filled masked steps under its positional convs with
``encoder_zero_mask`` False), the decoders (shared, then the modality's),
the EMA teacher on the unmasked, un-cloned local features, and the masked
regression of each decoder's predictions on the teacher's targets at the
masked positions, times ``d2v_loss``. Beside it: the image reconstruction
term (``recon_loss``: the first decoder's output through ``recon_proj``
against the normalized pixel patches at the masked positions), and with
``with_labels`` the linear probe's focal loss at the masked positions with
its confusion counts (``pretrain/*``) at ``metric_threshold``. Each term is
scaled by its ``loss_weights`` entry before the division by the sample
size.
``make_pretrain_train_step`` accumulates gradients over ``update_freq``
micro-batches (the batch carries a leading micro-batch axis, as in JAX),
applies one update, then one EMA step of the teacher.

Data parallelism (``parallel.mesh.DataParallel``) as in the finetune step:
the loss divides by ``sample_size`` summed over the ranks (one all-reduce
of each micro-batch's count before its backward), the gradients are summed
over the ranks once per step, and the metrics are reduced (the variance
statistics as the mean over the ranks). Every rank's student, so every
rank's EMA teacher, stays identical without a collective of its own. Under
a sharded layout (``parallel/layout.py``) the losses and metrics reduce
over "data" only, the ALiBi scale's gradient also over "model", and the
teacher runs the student's layout: its tensor-parallel shards, its
pipeline stages (streaming the target sum through them) and FSDP2's
gathers of the sharded EMA copies.

The teacher (``teacher_targets``) is the student module in eval mode,
without gradient, over the student's parameters overlaid with the EMA ones
(``torch.func.functional_call``): it sums the normalized taps of its last k
trunk layers, and the targets are that sum divided by k, finished. It reads
the student's own local features, detached. With ``teacher_matmul_impl``
int8 or int8_attn (JAX's ``train/pretrain.py:150-170``) it is a module of the same
architecture in that serving mode (``int8_teacher``, built on the meta
device: it holds no weights of its own), run over the same merged
parameters and the int8 weights quantized from them at every call, as
JAX quantizes inside the teacher's forward: so the targets follow the EMA
weights after every step and equal those of a model loaded from the merged
weights. Nothing is differentiated through the int8 kernels. With extra
tokens the teacher's taps keep them, as JAX's do (its targets are
normalized over T + E rows and gathered at the masked ids); with
``cls_loss`` the output at the last extra token regresses the time-mean
target, times ``cls_loss`` and the sample size (JAX's ``pretrain.py:233-241``).

Random draws come from an explicit ``ops.dropout.Rngs``: the mixup draws
and the masks on its rank's own rows generator, the kernels' int32 seeds
and layerdrop on its host generator, elementwise dropout and the mask
tokens' noise on its device generator.
``jax.random`` and torch draw differently from one seed, so the mask draw is
a parameter (``draw_mask``) that tests set to one given mask on both sides.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from animal2vec_tpu_torch.config import PretrainConfig
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.models.data2vec2 import finish_targets
from animal2vec_tpu_torch.ops.losses import d2v_regression_loss, sigmoid_focal_loss
from animal2vec_tpu_torch.ops.masking import (
    block_mask_2d, expected_span_mask_tokens, make_mask_info_static, span_mask, take_rows,
)
from animal2vec_tpu_torch.ops.mixup import bc_mixup
from animal2vec_tpu_torch.ops.stats import compute_var, confusion_counts
from animal2vec_tpu_torch.parallel.layout import reduce_model_partials
from animal2vec_tpu_torch.parallel.mesh import DataParallel
from animal2vec_tpu_torch.train.state import PretrainState, ema_decay_at, merge_params

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
# (rows, time steps, rngs) -> (rows, T) 0/1 mask with mask_tokens(cfg, T) ones per row
MaskDraw = Callable[[int, int, Rngs], torch.Tensor]


def _block_masked(cfg: PretrainConfig) -> bool:
    return cfg.modality == "IMAGE" and cfg.mask_length > 1


def mask_tokens(cfg: PretrainConfig, t: int) -> int:
    """The static number of masked tokens per row of a T-step sequence
    (before ``keep_masked_pct`` keeps some of them)."""
    if _block_masked(cfg):
        m = int(t * cfg.mask_prob)
        return max(1, min(t - m if cfg.inverse_mask else m, t - 1))
    return expected_span_mask_tokens(t, cfg.mask_prob, cfg.mask_length, cfg.mask_dropout)


def draw_pretrain_mask(cfg: PretrainConfig, rows: int, t: int, rngs: Rngs) -> torch.Tensor:
    """The recipe's mask on the rows generator: 2-D blocks (images with
    ``mask_length`` > 1) or spans."""
    if _block_masked(cfg):
        return block_mask_2d(rows, t, cfg.mask_prob, cfg.mask_length, rngs.rows,
                             cfg.mask_prob_adjust, cfg.inverse_mask)
    return span_mask(rows, t, cfg.mask_prob, cfg.mask_length, rngs.rows, cfg.mask_dropout)


_INT8_TEACHERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def int8_teacher(model: Data2VecMulti, impl: str) -> Data2VecMulti:
    """The student's architecture in the serving mode ``impl`` ("int8" or
    "int8_attn"), on the meta device and in eval mode: a module without
    weights of its own that ``teacher_targets`` runs over the student's
    tensors (one per student and mode)."""
    per_model = _INT8_TEACHERS.setdefault(model, {})
    if impl not in per_model:
        with torch.device("meta"):
            per_model[impl] = Data2VecMulti(dataclasses.replace(model.cfg, matmul_impl=impl),
                                            model.dtype, pretrain=model.pretrain).eval()
    return per_model[impl]


@contextlib.contextmanager
def _ema_in_shards(model: Data2VecMulti, ema: Dict[str, torch.Tensor]):
    """FSDP2's sharded parameters holding their EMA copies (the copies live
    in the same shards), so that the blocks' own gathers give the teacher
    whole EMA parameters; the student's values come back after, and every
    block is resharded on the way in and out (its gathered tensors are the
    student's in the student's graph)."""
    from torch.distributed.tensor import DTensor

    from animal2vec_tpu_torch.parallel.layout import reshard

    params = dict(model.named_parameters())
    sharded = [n for n in ema if isinstance(params[n], DTensor)]
    student = {n: params[n].to_local().detach().clone() for n in sharded}
    reshard(model)
    for n in sharded:
        params[n].to_local().copy_(ema[n].to_local())
    try:
        yield {n: v for n, v in ema.items() if n not in student}
    finally:
        reshard(model)
        for n in sharded:
            params[n].to_local().copy_(student[n])


@torch.no_grad()
def teacher_encode(model: Data2VecMulti, ema: Dict[str, torch.Tensor], local: torch.Tensor,
                   impl: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """The EMA teacher's trunk output x and the fp32 sum of its last k
    normalized taps on the unmasked local features; ``impl`` an int8
    serving mode other than the model's own runs the teacher through the
    int8 kernels on weights quantized from the merged ones. Under FSDP the
    sharded EMA copies run through the blocks' gathers (``_ema_in_shards``)
    and the rest of the overlay through ``functional_call``."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(p, DTensor) for p in model.parameters()):
        was_training = model.training
        model.eval()
        try:
            with _ema_in_shards(model, ema) as rest:
                x, _, _, _, t_sum = torch.func.functional_call(
                    model, rest, (local.detach(),), {"method": "encode", "reduce_targets": True},
                    strict=False)
        finally:
            model.train(was_training)
        return x, t_sum
    params = merge_params(model, ema)
    if impl and impl != model.cfg.matmul_impl:
        net = int8_teacher(model, impl)
        tensors = {**dict(model.named_buffers()), **params, **net.quantized_buffers(params)}
        x, _, _, _, t_sum = torch.func.functional_call(
            net, tensors, (local.detach(),), {"method": "encode", "reduce_targets": True})
        return x, t_sum
    was_training = model.training
    model.eval()
    try:
        x, _, _, _, t_sum = torch.func.functional_call(
            model, params, (local.detach(),), {"method": "encode", "reduce_targets": True})
    finally:
        model.train(was_training)
    return x, t_sum


def teacher_targets(model: Data2VecMulti, ema: Dict[str, torch.Tensor],
                    local: torch.Tensor, impl: str = "") -> torch.Tensor:
    """The EMA teacher's (B, T, C) fp32 targets of the unmasked local
    features (``teacher_encode``'s tap sum divided by k, finished)."""
    cfg = model.pretrain
    return finish_targets(teacher_encode(model, ema, local, impl)[1] / cfg.average_top_k_layers,
                          cfg)


def pretrain_loss(model: Data2VecMulti, ema: Dict[str, torch.Tensor], batch: Batch,
                  rngs: Rngs, cfg: PretrainConfig, train: bool = True,
                  draw_mask: Optional[MaskDraw] = None,
                  normalize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                  ) -> Tuple[torch.Tensor, Metrics]:
    """The loss (the weighted terms summed over the masked tokens / their
    count) and the metrics of one (micro-)batch: ``source`` (B, T_wav) or
    (B, H, W, C), ``target`` (B, T, n) frame labels with ``with_labels``,
    optional ``n_valid`` (eval batches padded by repeated rows). Puts the
    model in train or eval mode. ``normalize`` maps the count to the loss's
    divisor (data parallelism: the count summed over the ranks)."""
    mode = cfg.modality
    source, target = batch["source"], batch.get("target")
    if train and mode == "AUDIO" and cfg.source_mixup >= 0 and cfg.mixup_prob > 0:
        source, target = bc_mixup(source, target, cfg.source_mixup, cfg.mixup_prob,
                                  cfg.same_mixup, cfg.gain_mode, model.cfg.sample_rate,
                                  cfg.mixing_window_length, cfg.target_mixup and cfg.with_labels,
                                  rngs.rows)
    model.train(train)
    local = model.local_features(source)
    b, t, c = local.shape
    clone = cfg.clone_batch
    local_c = local.repeat_interleave(clone, dim=0) if clone > 1 else local
    draw = draw_mask or (lambda rows, steps, r: draw_pretrain_mask(cfg, rows, steps, r))
    m_tokens = mask_tokens(cfg, t)
    info = make_mask_info_static(draw(b * clone, t, rngs).to(local.device), m_tokens,
                                 cfg.keep_masked_pct)

    x, _, _, _, mean = model.encode(local_c, zero_mask=cfg.encoder_zero_mask, rngs=rngs,
                                     mask_info=info, remove_masked=True,
                                     top_k=cfg.average_top_k_layers if cfg.with_labels else None)
    xs = model.decode_d2v(x, info, rngs)
    y = teacher_targets(model, ema, local, cfg.teacher_matmul_impl)  # (B, T [+ E], C) fp32

    # the clone rows [i*clone, (i+1)*clone) read sample i's targets: fold the
    # clone axis into the gather index instead of repeating y
    ids_masked = info.ids_shuffle[:, info.ids_keep.shape[1]:]  # (B*clone, M)
    m_cnt = ids_masked.shape[1]
    ids_folded = ids_masked.reshape(b, clone * m_cnt)
    y_m = take_rows(y, ids_folded).reshape(b * clone, m_cnt, c)

    n_valid = batch.get("n_valid")
    dev = local.device
    if n_valid is not None:
        row_w = (torch.arange(b, device=dev) < n_valid).float()
        n_rows = torch.as_tensor(n_valid, dtype=torch.float32, device=dev)
    else:
        row_w = torch.ones((b,), device=dev)
        n_rows = torch.tensor(float(b), device=dev)
    clone_w = row_w.repeat_interleave(clone) if clone > 1 else row_w
    sample_size = n_rows * clone * m_cnt
    denom = sample_size if normalize is None else normalize(sample_size)

    losses: Dict[str, torch.Tensor] = {}
    metrics: Metrics = {}
    beta, scale = cfg.loss_beta, cfg.loss_scale
    for i, xd in enumerate(xs if cfg.d2v_loss > 0 else ()):
        x_m = take_rows(xd, ids_masked)
        name = f"{mode}_regression_{i}" if len(xs) > 1 else f"{mode}_regression"
        reg = d2v_regression_loss(x_m, y_m, beta, scale).reshape(b * clone, -1)
        losses[name] = (reg * clone_w[:, None]).sum() * cfg.d2v_loss
        metrics[f"pred_var_{i}" if len(xs) > 1 else "pred_var"] = compute_var(x_m.detach())
    n_extra = model.cfg.num_extra_tokens
    if cfg.cls_loss > 0 and n_extra > 0:
        # each sample's time-mean target, broadcast to its clone rows
        cls_target = y.mean(dim=1)
        if clone > 1:
            cls_target = cls_target.repeat_interleave(clone, dim=0)
        cls_reg = d2v_regression_loss(x[:, n_extra - 1], cls_target, beta, scale)
        losses["cls"] = (cls_reg.reshape(b * clone, -1) * clone_w[:, None]).sum() \
            * cfg.cls_loss * denom  # the sample size over the ranks: the term sums
    if cfg.recon_loss > 0 and mode == "IMAGE":
        recon_t = take_rows(model.patchify_targets(batch["source"]), ids_folded)
        recon = model.recon_head(take_rows(xs[0], ids_masked))
        losses["recon"] = d2v_regression_loss(
            recon, recon_t.reshape(b * clone, m_cnt, -1), beta, scale).sum() * cfg.recon_loss
    if cfg.with_labels and target is not None:
        metrics.update(_probe(model, cfg, mean, info, rngs, target, ids_masked, clone_w,
                              losses))

    loss = sum(v * cfg.loss_weight(k) for k, v in losses.items()) / denom
    metrics["target_var"] = compute_var(y_m)
    metrics["masked_pct"] = torch.tensor(m_tokens / t, dtype=torch.float32, device=dev)
    metrics["sample_size"] = sample_size
    for k, v in losses.items():
        metrics[f"loss_{k}"] = v.detach() / denom
    return loss, metrics


def _probe(model: Data2VecMulti, cfg: PretrainConfig, mean, info, rngs: Rngs,
           target: torch.Tensor, ids_masked: torch.Tensor, clone_w: torch.Tensor,
           losses: Dict[str, torch.Tensor]) -> Metrics:
    """The linear probe (``train/pretrain.py:260-306``): its full-length
    logits and the (clone-repeated) labels at the masked positions, the
    focal loss weighted by row into ``losses``; returns its confusion
    counts at ``metric_threshold``."""
    logits = take_rows(model.linear_eval(mean, info, rngs), ids_masked)
    clone = cfg.clone_batch
    tgt = take_rows(target.repeat_interleave(clone, dim=0) if clone > 1 else target,
                    ids_masked)
    rows = logits.shape[0]
    loss = sigmoid_focal_loss(logits, tgt, reduction="none")
    losses["linear_eval_loss"] = (loss.reshape(rows, -1) * clone_w[:, None]).sum()
    preds = (torch.sigmoid(logits.detach().float()) >= cfg.metric_threshold).to(torch.int32)
    w3 = clone_w.reshape(rows, 1, 1)
    tp, fp, tn, fn = confusion_counts(preds, tgt, weights=w3)
    return {"pretrain/n_correct": ((preds == tgt.to(torch.int32)) * w3).sum(),
            "pretrain/total": clone_w.sum() * (preds.numel() // rows),
            "pretrain/tp": tp, "pretrain/fp": fp, "pretrain/tn": tn, "pretrain/fn": fn}


def make_pretrain_train_step(
    cfg: PretrainConfig, draw_mask: Optional[MaskDraw] = None,
    dp: Optional[DataParallel] = None,
) -> Callable[[PretrainState, Batch, Rngs], Metrics]:
    """``train_step(state, batch, rngs) -> metrics``: every tensor of
    ``batch`` has a leading axis of ``update_freq`` micro-batches; the
    gradients of the micro-batches' losses are averaged and applied once,
    then the teacher takes its EMA step and ``state.step`` advances by
    one. Under ``dp`` the batch is the rank's shard, and the losses,
    gradients and metrics are the global batch's (``rngs.row0``, the rank's
    first row of the global clone batch, is set before each micro-batch, so
    ``draw_mask`` may read it)."""
    accum = max(1, cfg.optimization.update_freq)
    dp = dp or DataParallel()
    normalize = None if dp.world == 1 else (lambda n: dp.all_reduce(n.clone()))

    def train_step(state: PretrainState, batch: Batch, rngs: Rngs) -> Metrics:
        state.zero_grad()
        total: Metrics = {}
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            rngs.row0 = dp.row_offset(len(mb["source"])) * cfg.clone_batch
            loss, metrics = pretrain_loss(state.model, state.ema, mb, rngs, cfg, True, draw_mask,
                                          normalize)
            (loss / accum).backward()
            metrics["loss"] = loss.detach()
            for k, v in metrics.items():
                total[k] = total[k] + v if k in total else v
        reduce_model_partials(dp, state.model.named_parameters())
        dp.reduce_gradients(p for g in state.optimizer.param_groups for p in g["params"])
        state.apply_gradients()
        out = {k: v / accum for k, v in total.items()}
        out["ema_decay"] = torch.tensor(ema_decay_at(cfg, state.step) * 1000.0)
        return dp.reduce_metrics(out)

    return train_step


def make_pretrain_eval_step(
    cfg: PretrainConfig, draw_mask: Optional[MaskDraw] = None,
) -> Callable[[PretrainState, Batch, Rngs], Metrics]:
    """``eval_step(state, batch, rngs) -> metrics`` of one batch in eval mode
    (masks and clones as in training; no mixup, no dropout)."""

    def eval_step(state: PretrainState, batch: Batch, rngs: Rngs) -> Metrics:
        with torch.no_grad():
            loss, metrics = pretrain_loss(state.model, state.ema, batch, rngs, cfg, False,
                                          draw_mask)
        metrics["loss"] = loss
        return metrics

    return eval_step
