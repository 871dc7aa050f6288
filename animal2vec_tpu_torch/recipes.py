"""YAML recipes: the port of ``animal2vec_tpu/config.py``'s reader
(``_merge_into`` :505, ``apply_overrides`` :576, ``resolve`` :589,
``load_config`` :635), onto the port's ``config.RunConfig``.

``load_config(path, overrides)`` reads a recipe in the JAX package's YAML
schema (``common``, ``task``, ``dataset``, ``distributed``, ``criterion``,
``optimization``, ``checkpoint``, ``model`` with ``modalities.audio|image``
and ``mixup``, and ``finetune``) into a tree that starts from the JAX
dataclasses' defaults (``DEFAULTS``, a copy: the port reads nothing of the
JAX package), strict on keys; applies dotted ``key=value`` overrides in the
JAX key names; resolves the derived fields as ``resolve`` does; then checks
every leaf against its class and builds the ``RunConfig``. A ``finetune``
section makes a finetune run, else the run pretrains.

Every leaf key of the schema is in exactly one class
(``tests/test_torch_recipes.py`` enumerates the JAX package's keys):

1. ``MAPPED``: read into a field of the run (or derived by ``resolve``);
2. ``IGNORED``: no meaning on the card, each with its reason (TPU kernel or
   layout selection, or a fairseq field that the JAX package does not read
   either); a value other than the default logs once and is ignored;
3. ``REFUSED``: not ported; a value other than the ones the port
   implements (the default, or those listed) raises
   ``NotImplementedError`` naming the ROADMAP item that will port it. Some refusals hold only for one kind of run (a finetune run takes
   its dropouts and masks from ``finetune``, as
   ``train/build.build_finetune_encoder_cfg`` does).

The port adds keys of its own to the schema (``PORT_KEYS``, mapped):
``task.label_ext``, the frame labels' file format ("h5" or "npz").

The six shipped recipes are kept in ``configs/`` (copies of the JAX
package's, byte for byte); ``RECIPES`` names them.
"""

from __future__ import annotations

import ast
import copy
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

from animal2vec_tpu_torch.config import (
    CheckpointConfig, CommonConfig, DatasetConfig, DecoderConfig, DistributedConfig,
    FinetuneConfig, FinetuneTrainConfig, OptimizationConfig, PretrainConfig, RunConfig,
    SegmentationConfig, TaskConfig,
)

log = logging.getLogger(__name__)

CONFIGS = Path(__file__).resolve().parent / "configs"
RECIPES = {name: CONFIGS / f"{name}.yaml" for name in (
    "finetune_100", "finetune_025", "finetune_001", "nips4bplus_finetune",
    "a2v_large_pretrain", "a2v_large_pretrain_v5e")}

_LABELS = ("['beep', 'synch', 'sn', 'cc', 'ld', 'oth', 'mo', 'al', 'soc', 'agg', 'eating', "
           "'focal']")
_DECODER = dict(decoder_dim=384, decoder_groups=16, decoder_kernel=5, decoder_layers=5,
                input_dropout=0.1, add_positions_masked=False, add_positions_all=False,
                decoder_residual=True, projection_layers=1, projection_ratio=2.0,
                lane_pack_max=2)
_MIXUP = dict(mixup_prob=0.5, mixing_window_length=0.1, source_mixup=-1.0, same_mixup=True,
              target_mixup=False, gain_mode="A_weighting")
_MODALITY = dict(prenet_depth=4, prenet_layerdrop=0.0, prenet_dropout=0.0,
                 start_drop_path_rate=0.0, end_drop_path_rate=0.0, num_extra_tokens=0,
                 init_extra_token_zero=True, mask_noise_std=0.01, mask_prob=0.7)

# The JAX package's ``to_dict(Config())`` (``finetune`` as
# ``FinetuneModelConfig()`` once a recipe has the section; tuples where the
# dataclass holds one).
DEFAULTS: Dict[str, Any] = {
    "common": dict(seed=1, compute_dtype="float32", log_interval=100, log_format="json",
                   tensorboard_logdir="", profile=False, suppress_crashes=False),
    "task": dict(
        data="", sample_rate=8000, normalize=True, with_labels=False, do_focal_prediction=True,
        min_label_size=0, enable_padding=False, max_sample_size=None, min_sample_size=1,
        unique_labels=_LABELS,
        conv_feature_layers="[(127, 63, 1)] + [(512, 10, 5)] + [(512, 3, 2)] * 3 + "
                            "[(512, 3, 1)] + [(512, 2, 1)] * 2",
        verbose_tensorboard_logging=False),
    "dataset": dict(max_tokens=408000, batch_size=None, bucket_lengths="", num_workers=8,
                    train_subset="pretrain", valid_subset="valid_0",
                    validate_interval_updates=10000, validate_after_updates=0,
                    required_batch_size_multiple=1, disable_validation=False,
                    skip_invalid_size_inputs=True),
    "distributed": dict(data_parallel=-1, model_parallel=1, fsdp=False, pipeline_parallel=1),
    "criterion": dict(use_focal_loss=True, label_smoothing=0.0, report_accuracy=True,
                      segmentation_metrics=False, metric_threshold=0.25, iou_threshold=0.0,
                      sigma_s=0.1, maxfilt_s=0.1, max_duration_s=0.5, lowP=0.125,
                      method="avg", loss_weights=None, log_keys=[]),
    "optimization": dict(lr=0.0001, max_update=100000, update_freq=1, clip_norm=1.0,
                         adam_betas=(0.9, 0.98), adam_eps=1e-06, weight_decay=0.01,
                         warmup_updates=10000, warmup_init_lr=0.0, min_lr=0.0,
                         schedule="cosine", stop_time_hours=0.0, stop_min_lr=-1.0),
    "checkpoint": dict(save_dir="checkpoints", save_interval_updates=10000, keep_last=10,
                       best_checkpoint_metric="", maximize_best_checkpoint_metric=True,
                       restore_file="", patience=0),
    "model": dict(
        loss_beta=0.0, loss_scale=None, depth=8, start_drop_path_rate=0.0,
        end_drop_path_rate=0.0, num_heads=12, norm_eps=1e-06, norm_affine=True,
        encoder_dropout=0.1, post_mlp_drop=0.1, attention_dropout=0.1, activation_dropout=0.0,
        dropout_input=0.0, layerdrop=0.0, embed_dim=768, mlp_ratio=4.0, layer_norm_first=False,
        average_top_k_layers=16, end_of_block_targets=False, clone_batch=1,
        layer_norm_target_layer=False, batch_norm_target_layer=False,
        instance_norm_target_layer=False, instance_norm_targets=False,
        layer_norm_targets=False, ema_decay=0.999, ema_end_decay=0.9999,
        ema_anneal_end_step=-1, ema_encoder_only=True, log_norms=True,
        modalities=dict(
            audio=dict(
                _MODALITY, mask_prob_min=None, inverse_mask=False, mask_prob_adjust=0.0,
                keep_masked_pct=0.0, mask_length=5, add_masks=False, remove_masks=False,
                mask_dropout=0.0, encoder_zero_mask=True, mask_channel_prob=0.0,
                mask_channel_length=64, ema_local_encoder=False, local_grad_mult=1.0,
                use_alibi_encoder=False, alibi_scale=1.0, learned_alibi=False,
                alibi_max_pos=None, learned_alibi_scale=False,
                learned_alibi_scale_per_head=False, learned_alibi_scale_per_layer=False,
                extractor_mode="layer_norm", conv_pos_width=95, conv_pos_groups=16,
                conv_pos_depth=5, conv_pos_pre_ln=False, sinc_input=True,
                apply_window_to_root=False, sinc_norm="instance", use_pswish=False,
                decoder=dict(_DECODER), conv_feature_layers="", sample_rate=8000,
                num_alibi_heads=12, model_depth=8),
            image=dict(
                _MODALITY, mask_length=5, mask_prob_adjust=0.0, inverse_mask=False,
                mask_dropout=0.0, encoder_zero_mask=True, keep_masked_pct=0.0,
                ema_local_encoder=False, local_grad_mult=1.0, use_alibi_encoder=False,
                alibi_scale=1.0, learned_alibi_scale=False, learned_alibi_scale_per_head=False,
                learned_alibi_scale_per_layer=False, input_size=224, in_chans=3, patch_size=16,
                embed_dim=768, alibi_dims=2, alibi_distance="manhattan", fixed_positions=True,
                transformer_decoder=False, enc_dec_transformer=False, decoder=dict(_DECODER),
                num_alibi_heads=12, model_depth=8)),
        shared_decoder=None, min_target_var=0.1, min_pred_var=0.01,
        supported_modality="AUDIO", mae_init=False, skip_ema=False, cls_loss=0.0,
        recon_loss=0.0, d2v_loss=1.0, final_dropout=0.0, metric_threshold=0.25,
        mixup=dict(_MIXUP), attn_impl="auto", matmul_impl="bf16", teacher_matmul_impl="",
        remat=True, remat_scope="mlp", remat_frontend=False, remat_decoder=False,
        pipeline_stages=1, pipeline_microbatches=0, with_labels=False, use_focal_loss=True,
        sample_rate=8000, unique_labels="", conv_feature_layers=""),
    "finetune": None,
}

FINETUNE_DEFAULTS: Dict[str, Any] = dict(
    w2v_path="", no_pretrained_weights=False, load_ema=False, load_pretrain_weights=False,
    freeze_finetune_updates=0, feature_grad_mult=0.0, apply_mask=True, mask_prob=0.5,
    mask_length=10, mask_channel_prob=0.0, mask_channel_length=64, layer_decay=1.0,
    average_top_k_layers=16, dropout=0.0, dropout_input=0.0, activation_dropout=0.0,
    attention_dropout=0.0, final_dropout=0.0, layerdrop=0.0, drop_path=0.0, zero_mask=False,
    update_alibi=True, mixup=dict(_MIXUP), sample_rate=8000, unique_labels="",
    use_focal_loss=True)

# the port's own keys beside the JAX schema, with their defaults
PORT_KEYS = {"task.label_ext": "h5"}

# optional groups: None until a recipe gives them (``_OPTIONAL_DATACLASS_FIELDS``)
OPTIONAL = {"finetune": FINETUNE_DEFAULTS, "model.shared_decoder": _DECODER,
            "model.modalities.audio.decoder": _DECODER,
            "model.modalities.image.decoder": _DECODER}

_A = "model.modalities.audio."
_I = "model.modalities.image."
_DEC = ("decoder_dim", "decoder_groups", "decoder_kernel", "decoder_layers", "input_dropout",
        "decoder_residual", "projection_layers", "projection_ratio")
_MIX = tuple(_MIXUP)

# 1. the keys read into the run
MAPPED = frozenset(
    [f"common.{k}" for k in ("seed", "compute_dtype", "log_interval", "tensorboard_logdir",
                             "profile", "suppress_crashes")]
    + list(PORT_KEYS)
    + [f"task.{k}" for k in ("data", "sample_rate", "normalize", "with_labels",
                             "do_focal_prediction", "min_label_size", "max_sample_size",
                             "min_sample_size", "unique_labels", "conv_feature_layers",
                             "verbose_tensorboard_logging")]
    + [f"dataset.{k}" for k in ("max_tokens", "batch_size", "bucket_lengths", "num_workers",
                                "train_subset", "valid_subset", "validate_interval_updates",
                                "validate_after_updates", "required_batch_size_multiple",
                                "disable_validation")]
    + [f"distributed.{k}" for k in ("data_parallel", "model_parallel", "fsdp",
                                     "pipeline_parallel")]
    + [f"criterion.{k}" for k in ("use_focal_loss", "label_smoothing", "report_accuracy",
                                  "segmentation_metrics", "metric_threshold", "iou_threshold",
                                  "sigma_s", "maxfilt_s", "max_duration_s", "lowP", "method",
                                  "loss_weights")]
    + [f"optimization.{k}" for k in DEFAULTS["optimization"]]
    + [f"checkpoint.{k}" for k in ("save_dir", "save_interval_updates", "keep_last",
                                   "best_checkpoint_metric", "maximize_best_checkpoint_metric",
                                   "patience")]
    + [f"model.{k}" for k in (
        "loss_beta", "loss_scale", "depth", "num_heads", "norm_eps", "encoder_dropout",
        "post_mlp_drop", "attention_dropout", "activation_dropout", "dropout_input",
        "layerdrop", "start_drop_path_rate", "end_drop_path_rate", "norm_affine",
        "layer_norm_first", "embed_dim", "mlp_ratio", "average_top_k_layers",
        "clone_batch", "ema_decay", "ema_end_decay", "ema_anneal_end_step", "ema_encoder_only",
        "cls_loss", "matmul_impl", "teacher_matmul_impl", "remat", "remat_scope",
        "remat_frontend", "remat_decoder", "with_labels", "use_focal_loss", "sample_rate",
        "unique_labels", "conv_feature_layers", "end_of_block_targets",
        "layer_norm_target_layer", "batch_norm_target_layer", "instance_norm_target_layer",
        "instance_norm_targets", "layer_norm_targets", "shared_decoder", "min_target_var",
        "min_pred_var", "recon_loss", "d2v_loss", "final_dropout", "metric_threshold",
        "pipeline_stages", "pipeline_microbatches")]
    + [f"model.mixup.{k}" for k in _MIX]
    + [_A + k for k in (
        "prenet_depth", "prenet_dropout", "num_extra_tokens", "init_extra_token_zero",
        "mask_noise_std", "mask_prob", "mask_length", "alibi_scale",
        "learned_alibi_scale_per_layer", "conv_pos_width", "conv_pos_groups", "conv_pos_depth",
        "use_pswish", "conv_feature_layers", "sample_rate", "num_alibi_heads",
        "model_depth", "prenet_layerdrop", "start_drop_path_rate", "end_drop_path_rate",
        "use_alibi_encoder", "learned_alibi_scale_per_head", "extractor_mode",
        "conv_pos_pre_ln", "sinc_input", "apply_window_to_root", "sinc_norm",
        "keep_masked_pct", "mask_dropout", "encoder_zero_mask", "local_grad_mult", "decoder")]
    + [_A + "decoder." + k for k in _DEC]
    + [f"finetune.{k}" for k in (
        "load_ema", "freeze_finetune_updates", "feature_grad_mult", "apply_mask", "mask_prob",
        "mask_length", "mask_channel_prob", "mask_channel_length", "layer_decay",
        "average_top_k_layers", "dropout", "dropout_input", "activation_dropout",
        "attention_dropout", "final_dropout", "layerdrop", "drop_path", "zero_mask",
        "update_alibi", "sample_rate", "unique_labels", "use_focal_loss",
        "load_pretrain_weights")]
    + [f"finetune.mixup.{k}" for k in _MIX]
)

_UNREAD = "a fairseq field that the JAX package does not read either"
_NO_IMAGE = ("the AUDIO model has no image encoder (in JAX too); the image modality "
             "through the loop is refused by model.supported_modality")
# 2. no meaning on the card: key -> reason
IGNORED: Dict[str, str] = {
    "common.log_format": _UNREAD,
    "task.enable_padding": _UNREAD,
    "dataset.skip_invalid_size_inputs": _UNREAD,
    "checkpoint.restore_file": _UNREAD + " (a run resumes from its save_dir)",
    "criterion.log_keys": _UNREAD + " (every metric is logged)",
    "model.log_norms": _UNREAD,
    "model.mae_init": _UNREAD,
    "model.skip_ema": "written by the JAX finetune builder, read nowhere",
    "model.attn_impl": "Pallas or XLA attention selection on the TPU (config.py:343); the "
                       "port runs its own kernels",
    _A + "mask_prob_min": _UNREAD,
    _A + "mask_prob_adjust": "the audio span mask does not read it (in JAX too)",
    _A + "inverse_mask": "the audio span mask does not read it (in JAX too)",
    _A + "add_masks": _UNREAD,
    _A + "remove_masks": _UNREAD,
    _A + "ema_local_encoder": _UNREAD,
    _A + "learned_alibi": _UNREAD,
    _A + "alibi_max_pos": _UNREAD,
    _A + "learned_alibi_scale": "written by the JAX finetune builder from "
                                "finetune.update_alibi, read nowhere: the scale stays learned "
                                "(the port refuses update_alibi=False, ROADMAP C)",
    _A + "mask_channel_prob": "pretraining draws no channel mask (in JAX too); finetuning "
                              "reads finetune.mask_channel_prob",
    _A + "mask_channel_length": "as mask_channel_prob",
    _A + "decoder.add_positions_masked": _UNREAD,
    _A + "decoder.add_positions_all": _UNREAD,
    _A + "decoder.lane_pack_max": "lane packing of the grouped convs for the TPU's 128 lanes "
                                  "(config.py:159)",
    "finetune.w2v_path": "the pretrained weights come from --pretrained (in JAX too)",
    "finetune.no_pretrained_weights": _UNREAD,
}
IGNORED.update({_I + k: _NO_IMAGE for k in DEFAULTS["model"]["modalities"]["image"]
                if k != "decoder"})
IGNORED.update({_I + "decoder." + k: _NO_IMAGE for k in _DECODER})
IGNORED[_I + "decoder"] = _NO_IMAGE
_DERIVED = {_I + "num_alibi_heads", _I + "model_depth"}  # set by resolve

A7 = "A.7"
# 3. not ported: key -> (ROADMAP item, the values the port implements or None
# for the default only, the runs it holds for)
REFUSED: Dict[str, Tuple[str, Optional[tuple], str]] = {
    # JAX's loop, train_cli and loader read audio only and never name the
    # image mode (ROADMAP A.7, not queued)
    "model.supported_modality": (A7, None, "all"),
}


# ------------------------------------------------------------------ reading


def parse_pylist(expr):
    """The conv-layer spec strings (``"[(512, 3, 2)] * 3 + [(512, 2, 1)]"``):
    list and tuple literals combined with + and * only
    (``animal2vec_tpu/config.py`` ``parse_pylist``); a list passes through."""
    if isinstance(expr, (list, tuple)):
        return list(expr)

    def ev(n):
        if isinstance(n, (ast.List, ast.Tuple, ast.Constant)):
            return ast.literal_eval(n)
        if isinstance(n, ast.BinOp) and isinstance(n.op, (ast.Add, ast.Mult)):
            left, right = ev(n.left), ev(n.right)
            return left + right if isinstance(n.op, ast.Add) else left * right
        raise ValueError(f"unsupported expression in list spec: {expr!r}")

    return ev(ast.parse(expr, mode="eval").body)


def _coerce(current: Any, value: Any) -> Any:
    """JAX's ``_coerce``: a value to the type of the default it replaces."""
    if value is None:
        return None
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(ast.literal_eval(value) if isinstance(value, str) else value)
    return value


def _merge(node: dict, data: Any, path: str) -> None:
    """Merge a raw mapping into a group of the tree, strict on keys."""
    if not isinstance(data, dict):
        raise TypeError(f"expected mapping at {path or '<root>'}, got {type(data)}")
    for key, value in data.items():
        _set(node, key, value, path)


def _set(node: dict, key: str, value: Any, path: str) -> None:
    if key not in node:
        raise KeyError(f"unknown config key: {path}{key}")
    current = node[key]
    if current is None and f"{path}{key}" in OPTIONAL:
        if value is None:
            return
        current = node[key] = copy.deepcopy(OPTIONAL[f"{path}{key}"])
    if isinstance(current, dict) and isinstance(value, dict):
        _merge(current, value, f"{path}{key}.")
    elif isinstance(current, dict) and value is not None:
        raise KeyError(f"config key {path}{key} is a group")
    else:
        node[key] = _coerce(current, value)


def apply_jax_overrides(tree: dict, overrides: Sequence[str]) -> dict:
    """Dotted ``key=value`` overrides in the JAX key names (JAX's
    ``set_by_path``): the value a Python literal where it parses as one."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must look like key=value, got {ov!r}")
        key, text = ov.split("=", 1)
        try:
            value = ast.literal_eval(text)
        except (ValueError, SyntaxError):
            value = text
        parts = key.strip().split(".")
        node, path = tree, ""
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], (dict, type(None))):
                raise KeyError(f"unknown config key: {key}")
            if node[part] is None:
                if f"{path}{part}" not in OPTIONAL:
                    raise KeyError(f"cannot descend into None at {path}{part}")
                node[part] = copy.deepcopy(OPTIONAL[f"{path}{part}"])
            node, path = node[part], f"{path}{part}."
        _set(node, parts[-1], value, path)
    return tree


def resolve(tree: dict) -> dict:
    """The derived fields (JAX's ``resolve``): the task's sample rate, labels
    and conv stack and the criterion's focal flag copied into the model and
    the finetune head, the EMA anneal end (``max_update`` when negative),
    the ALiBi head count and depth copied into the modalities; the
    ``matmul_impl`` values checked."""
    m, task = tree["model"], tree["task"]
    m["with_labels"] = task["with_labels"]
    m["use_focal_loss"] = tree["criterion"]["use_focal_loss"]
    m["sample_rate"] = task["sample_rate"]
    m["unique_labels"] = task["unique_labels"]
    m["conv_feature_layers"] = task["conv_feature_layers"]
    if m["ema_anneal_end_step"] < 0:
        m["ema_anneal_end_step"] = tree["optimization"]["max_update"]
    for mod in m["modalities"].values():
        mod["num_alibi_heads"] = m["num_heads"]
        mod["model_depth"] = m["depth"]
    audio = m["modalities"]["audio"]
    audio["conv_feature_layers"] = task["conv_feature_layers"]
    audio["sample_rate"] = task["sample_rate"]
    ft = tree["finetune"]
    if ft is not None:
        ft["sample_rate"] = task["sample_rate"]
        ft["unique_labels"] = task["unique_labels"]
        ft["use_focal_loss"] = tree["criterion"]["use_focal_loss"]
    if m["matmul_impl"] not in ("bf16", "int8", "int8_attn"):
        raise ValueError(f"model.matmul_impl={m['matmul_impl']!r}: expected one of 'bf16', "
                         "'int8', 'int8_attn'")
    if m["teacher_matmul_impl"] not in ("", "bf16", "int8", "int8_attn"):
        raise ValueError(f"model.teacher_matmul_impl={m['teacher_matmul_impl']!r}: expected "
                         "'' (follow matmul_impl), 'bf16', 'int8', or 'int8_attn'")
    return tree


_DICT_LEAVES = {"criterion.loss_weights"}  # a mapping as a value


def leaves(tree: dict, prefix: str = ""):
    """(dotted key, value) of every leaf of a tree; a group that is None (an
    optional group not given) is one leaf."""
    for key, value in tree.items():
        if isinstance(value, dict) and f"{prefix}{key}" not in _DICT_LEAVES:
            yield from leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _default_of(key: str) -> Any:
    node: Any = DEFAULTS
    path = ""
    for part in key.split("."):
        node = node[part]
        path += part
        if node is None and path in OPTIONAL and path != key:
            node = OPTIONAL[path]
        path += "."
    return node


_warned = set()


def check_classes(tree: dict) -> None:
    """Log each ignored key whose value is not the default (once a
    process), and raise NotImplementedError at the first refused key whose
    value the port does not implement."""
    run = "pretrain" if tree["finetune"] is None else "finetune"
    for key, value in leaves(tree):
        if key == "finetune":  # a pretrain run's absent group
            continue
        if key.startswith("model.shared_decoder."):
            # a shared decoder given: each leaf has the audio decoder leaf's class
            key = _A + "decoder." + key.rsplit(".", 1)[1]
        if key in IGNORED:
            if value != _default_of(key) and key not in _warned | _DERIVED:
                _warned.add(key)
                log.warning("%s=%r is ignored: %s", key, value, IGNORED[key])
            continue
        if key in REFUSED:
            item, allowed, scope = REFUSED[key]
            if scope not in ("all", run):
                continue
            ok = (value is not None) if allowed == "present" else (
                value == _default_of(key) if allowed is None else value in allowed)
            if not ok:
                raise NotImplementedError(f"{key}={value!r} is not ported (ROADMAP {item})")
            continue
        if key not in MAPPED:
            raise KeyError(f"{key} has no class (recipes.MAPPED, IGNORED, REFUSED)")


def read_tree(path: Optional[str] = None, overrides: Sequence[str] = ()) -> dict:
    """The resolved tree of a recipe file (``None``: the defaults) with
    overrides, before the class check."""
    import yaml

    tree = copy.deepcopy(DEFAULTS)
    for key, value in PORT_KEYS.items():
        group, leaf = key.split(".")
        tree[group][leaf] = value
    if path:
        with open(path) as f:
            _merge(tree, yaml.safe_load(f) or {}, "")
    apply_jax_overrides(tree, overrides)
    return resolve(tree)


# ---------------------------------------------------------------- building


def _optimization(o: dict) -> OptimizationConfig:
    return OptimizationConfig(
        lr=o["lr"], max_update=o["max_update"], update_freq=o["update_freq"],
        clip_norm=o["clip_norm"], adam_betas=tuple(o["adam_betas"]), adam_eps=o["adam_eps"],
        weight_decay=o["weight_decay"], warmup_updates=o["warmup_updates"],
        warmup_init_lr=o["warmup_init_lr"], min_lr=o["min_lr"], schedule=o["schedule"],
        stop_time_hours=o["stop_time_hours"], stop_min_lr=o["stop_min_lr"])


def encoder_config(tree: dict) -> FinetuneConfig:
    """The audio encoder of the run: the model's architecture, remat and
    numerics, the task's conv stack, labels and clip length, the criterion's
    thresholds; the head averages ``finetune.average_top_k_layers`` taps in
    a finetune run, ``model.average_top_k_layers`` in a pretrain run. The
    trunk's drop-path rates are ``finetune.drop_path`` at both ends in a
    finetune run (``build_finetune_encoder_cfg``), the model's in a pretrain
    run; the prenet's are the audio modality's in both."""
    m, task, crit, ft = tree["model"], tree["task"], tree["criterion"], tree["finetune"]
    audio = m["modalities"]["audio"]
    trunk_dp = (ft["drop_path"],) * 2 if ft is not None else (
        m["start_drop_path_rate"], m["end_drop_path_rate"])
    return FinetuneConfig(
        conv_layers=tuple(tuple(c) for c in parse_pylist(audio["conv_feature_layers"])),
        sample_rate=audio["sample_rate"], sinc_norm=audio["sinc_norm"],
        use_pswish=audio["use_pswish"], sinc_input=audio["sinc_input"],
        apply_window_to_root=audio["apply_window_to_root"],
        extractor_mode=audio["extractor_mode"], conv_pos_pre_ln=audio["conv_pos_pre_ln"],
        conv_pos_width=audio["conv_pos_width"],
        conv_pos_groups=audio["conv_pos_groups"], conv_pos_depth=audio["conv_pos_depth"],
        prenet_depth=audio["prenet_depth"], depth=m["depth"], embed_dim=m["embed_dim"],
        num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"], norm_eps=m["norm_eps"],
        layer_norm_first=m["layer_norm_first"], norm_affine=m["norm_affine"],
        end_of_block_targets=m["end_of_block_targets"],
        start_drop_path_rate=trunk_dp[0], end_drop_path_rate=trunk_dp[1],
        prenet_start_drop_path_rate=audio["start_drop_path_rate"],
        prenet_end_drop_path_rate=audio["end_drop_path_rate"],
        matmul_impl=m["matmul_impl"], use_alibi_encoder=audio["use_alibi_encoder"],
        learned_alibi_scale_per_head=audio["learned_alibi_scale_per_head"],
        alibi_scale=audio["alibi_scale"],
        learned_alibi_scale_per_layer=audio["learned_alibi_scale_per_layer"],
        num_extra_tokens=audio["num_extra_tokens"],
        init_extra_token_zero=audio["init_extra_token_zero"],
        remat=m["remat"], remat_scope=m["remat_scope"], remat_frontend=m["remat_frontend"],
        remat_decoder=m["remat_decoder"], pipeline_stages=m["pipeline_stages"],
        pipeline_microbatches=m["pipeline_microbatches"],
        average_top_k_layers=(ft or m)["average_top_k_layers"],
        labels=tuple(ast.literal_eval(task["unique_labels"])), normalize=task["normalize"],
        max_sample_size=task["max_sample_size"], metric_threshold=crit["metric_threshold"],
        sigma_s=crit["sigma_s"], maxfilt_s=crit["maxfilt_s"],
        max_duration_s=crit["max_duration_s"], lowP=crit["lowP"],
        iou_threshold=crit["iou_threshold"])


def finetune_config(tree: dict) -> FinetuneTrainConfig:
    ft, crit = tree["finetune"], tree["criterion"]
    mix = ft["mixup"]
    return FinetuneTrainConfig(
        freeze_finetune_updates=ft["freeze_finetune_updates"],
        feature_grad_mult=ft["feature_grad_mult"], apply_mask=ft["apply_mask"],
        mask_prob=ft["mask_prob"], mask_length=ft["mask_length"],
        mask_channel_prob=ft["mask_channel_prob"],
        mask_channel_length=ft["mask_channel_length"], zero_mask=ft["zero_mask"],
        mask_noise_std=tree["model"]["modalities"]["audio"]["mask_noise_std"],
        layer_decay=ft["layer_decay"], dropout=ft["dropout"], dropout_input=ft["dropout_input"],
        activation_dropout=ft["activation_dropout"], attention_dropout=ft["attention_dropout"],
        final_dropout=ft["final_dropout"], layerdrop=ft["layerdrop"], drop_path=ft["drop_path"],
        update_alibi=ft["update_alibi"], load_ema=ft["load_ema"],
        load_pretrain_weights=ft["load_pretrain_weights"],
        source_mixup=mix["source_mixup"], mixup_prob=mix["mixup_prob"],
        same_mixup=mix["same_mixup"], mixing_window_length=mix["mixing_window_length"],
        gain_mode=mix["gain_mode"], target_mixup=mix["target_mixup"],
        use_focal_loss=crit["use_focal_loss"], label_smoothing=crit["label_smoothing"],
        report_accuracy=crit["report_accuracy"],
        optimization=_optimization(tree["optimization"]))


def _decoder(d: Optional[dict]) -> Optional[DecoderConfig]:
    return None if d is None else DecoderConfig(**{k: d[k] for k in _DEC})


def pretrain_config(tree: dict) -> PretrainConfig:
    m, crit = tree["model"], tree["criterion"]
    audio, mix = m["modalities"]["audio"], m["mixup"]
    return PretrainConfig(
        model=encoder_config(tree), decoder=_decoder(audio["decoder"]),
        shared_decoder=_decoder(m["shared_decoder"]),
        clone_batch=m["clone_batch"], mask_prob=audio["mask_prob"],
        mask_length=audio["mask_length"], mask_noise_std=audio["mask_noise_std"],
        mask_dropout=audio["mask_dropout"], keep_masked_pct=audio["keep_masked_pct"],
        encoder_zero_mask=audio["encoder_zero_mask"], local_grad_mult=audio["local_grad_mult"],
        average_top_k_layers=m["average_top_k_layers"],
        instance_norm_target_layer=m["instance_norm_target_layer"],
        layer_norm_target_layer=m["layer_norm_target_layer"],
        batch_norm_target_layer=m["batch_norm_target_layer"],
        instance_norm_targets=m["instance_norm_targets"],
        layer_norm_targets=m["layer_norm_targets"], ema_decay=m["ema_decay"],
        ema_end_decay=m["ema_end_decay"], ema_anneal_end_step=m["ema_anneal_end_step"],
        ema_encoder_only=m["ema_encoder_only"], encoder_dropout=m["encoder_dropout"],
        attention_dropout=m["attention_dropout"], post_mlp_drop=m["post_mlp_drop"],
        prenet_dropout=audio["prenet_dropout"], activation_dropout=m["activation_dropout"],
        dropout_input=m["dropout_input"], layerdrop=m["layerdrop"],
        prenet_layerdrop=audio["prenet_layerdrop"], source_mixup=mix["source_mixup"],
        mixup_prob=mix["mixup_prob"], same_mixup=mix["same_mixup"],
        mixing_window_length=mix["mixing_window_length"], gain_mode=mix["gain_mode"],
        target_mixup=mix["target_mixup"], teacher_matmul_impl=m["teacher_matmul_impl"],
        d2v_loss=m["d2v_loss"], cls_loss=m["cls_loss"], recon_loss=m["recon_loss"],
        loss_beta=m["loss_beta"], loss_scale=m["loss_scale"],
        loss_weights=tuple(sorted((crit["loss_weights"] or {}).items())),
        with_labels=m["with_labels"], use_focal_loss=m["use_focal_loss"],
        final_dropout=m["final_dropout"], metric_threshold=m["metric_threshold"],
        min_target_var=m["min_target_var"], min_pred_var=m["min_pred_var"],
        optimization=_optimization(tree["optimization"]))


def run_config(tree: dict) -> RunConfig:
    """The ``RunConfig`` of a resolved, checked tree."""
    c, task, ds, ck, crit = (tree[k] for k in ("common", "task", "dataset", "checkpoint",
                                              "criterion"))
    buckets = tuple(int(b) for b in parse_pylist(ds["bucket_lengths"])) \
        if ds["bucket_lengths"] else ()
    groups = dict(
        common=CommonConfig(seed=c["seed"], compute_dtype=c["compute_dtype"],
                            log_interval=c["log_interval"],
                            tensorboard_logdir=c["tensorboard_logdir"], profile=c["profile"],
                            suppress_crashes=c["suppress_crashes"]),
        task=TaskConfig(data=task["data"], with_labels=task["with_labels"],
                        label_ext=task["label_ext"],
                        do_focal_prediction=task["do_focal_prediction"],
                        min_label_size=task["min_label_size"],
                        max_sample_size=task["max_sample_size"],
                        min_sample_size=task["min_sample_size"],
                        verbose_tensorboard_logging=task["verbose_tensorboard_logging"]),
        dataset=DatasetConfig(
            max_tokens=ds["max_tokens"], batch_size=ds["batch_size"], bucket_lengths=buckets,
            num_workers=ds["num_workers"], train_subset=ds["train_subset"],
            valid_subset=ds["valid_subset"],
            validate_interval_updates=ds["validate_interval_updates"],
            validate_after_updates=ds["validate_after_updates"],
            required_batch_size_multiple=ds["required_batch_size_multiple"],
            disable_validation=ds["disable_validation"]),
        checkpoint=CheckpointConfig(
            save_dir=ck["save_dir"], save_interval_updates=ck["save_interval_updates"],
            keep_last=ck["keep_last"], best_checkpoint_metric=ck["best_checkpoint_metric"],
            maximize_best_checkpoint_metric=ck["maximize_best_checkpoint_metric"],
            patience=ck["patience"]),
        criterion=SegmentationConfig(segmentation_metrics=crit["segmentation_metrics"],
                                     method=crit["method"]),
        distributed=DistributedConfig(**tree["distributed"]),
    )
    if tree["finetune"] is None:
        return RunConfig(pretrain=pretrain_config(tree), **groups)
    return RunConfig(model=encoder_config(tree), finetune=finetune_config(tree), **groups)


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> RunConfig:
    """The run of a YAML recipe in the JAX package's schema (``None``: the
    defaults, a pretrain run) with dotted overrides in the JAX key names:
    read, overridden, resolved, class-checked and built."""
    tree = read_tree(path, overrides)
    check_classes(tree)
    return run_config(tree)
