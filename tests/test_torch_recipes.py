"""The port's YAML recipe reader (``animal2vec_tpu_torch/recipes.py``,
``config.load_config``) and ``train_cli --config`` against the JAX
package's ``load_config``.

- The six recipe copies in ``animal2vec_tpu_torch/configs/`` are byte for
  byte the JAX package's.
- Every leaf key of JAX's ``to_dict(Config())`` (with a ``finetune``
  section) is in exactly one of the port's classes (mapped, ignored with a
  reason, refused with a ROADMAP item), and the port's copy of the
  defaults is JAX's: a key added to the JAX schema fails here.
- Each recipe resolves, in the port's tree and in the built run, to what
  JAX's ``load_config`` resolves it to, exactly, on every mapped field.
- Each refused key raises NotImplementedError naming its ROADMAP item; an
  ignored key loads.
- ``train_cli --config`` on each copy for one step at tiny widths on the
  CPU.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from animal2vec_tpu.config import Config, FinetuneModelConfig, load_config as jax_load_config
from animal2vec_tpu.config import to_dict

from animal2vec_tpu_torch import recipes
from animal2vec_tpu_torch.config import RunConfig, load_config
from animal2vec_tpu_torch.data.synthetic import generate
from animal2vec_tpu_torch.tools import train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = tuple(recipes.RECIPES)


def _jax_leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _jax_leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _jax_tree(cfg):
    tree = to_dict(cfg)
    return {k: (tuple(v) if k == "optimization.adam_betas" else v)
            for k, v in _jax_leaves(tree)}


@pytest.mark.parametrize("name", NAMES)
def test_recipe_copies_are_byte_equal(name):
    assert filecmp.cmp(str(recipes.RECIPES[name]),
                       os.path.join(REPO, "animal2vec_tpu", "configs", f"{name}.yaml"),
                       shallow=False)


def test_every_jax_key_has_exactly_one_class():
    """The leaves of JAX's schema (``finetune`` and the optional decoders
    present) against MAPPED, IGNORED and REFUSED; the port's defaults are
    JAX's."""
    cfg = Config()
    cfg.finetune = FinetuneModelConfig()
    jax = _jax_tree(cfg)
    classes = (recipes.MAPPED, set(recipes.IGNORED), set(recipes.REFUSED))
    for key in jax:
        hits = [i for i, c in enumerate(classes) if key in c]
        assert len(hits) == 1, (key, hits)
    groups = {"model.shared_decoder", "model.modalities.audio.decoder",
              "model.modalities.image.decoder"}  # optional groups, one class each
    port_keys = set(jax) | set(recipes.PORT_KEYS) | groups
    for c in classes:
        assert set(c) <= port_keys, set(c) - port_keys
    assert not recipes.MAPPED & set(recipes.IGNORED) and not set(recipes.REFUSED) & (
        recipes.MAPPED | set(recipes.IGNORED))
    tree = dict(recipes.DEFAULTS, finetune=recipes.FINETUNE_DEFAULTS)
    assert dict(recipes.leaves(tree)) == jax
    assert all(item.startswith("A.") for item, _, _ in recipes.REFUSED.values())
    assert all(reason for reason in recipes.IGNORED.values())


@pytest.mark.parametrize("name", NAMES)
def test_load_config_matches_jax(name):
    """The port's resolved tree of a recipe equals JAX's ``load_config``
    leaf for leaf (the port's own ``task.label_ext`` aside), and the run
    built from it carries JAX's values."""
    jcfg = jax_load_config(os.path.join(REPO, "animal2vec_tpu", "configs", f"{name}.yaml"))
    tree = recipes.read_tree(str(recipes.RECIPES[name]))
    ours = dict(recipes.leaves(tree))
    assert ours.pop("task.label_ext") == "h5"
    assert ours == _jax_tree(jcfg)
    run = load_config(str(recipes.RECIPES[name]))
    m, audio, task, crit = jcfg.model, jcfg.model.modalities.audio, jcfg.task, jcfg.criterion
    ft = jcfg.finetune
    enc = run.encoder
    want_enc = dict(
        conv_layers=tuple(task.conv_layers()), sample_rate=task.sample_rate,
        sinc_norm=audio.sinc_norm, use_pswish=audio.use_pswish,
        conv_pos_width=audio.conv_pos_width, conv_pos_groups=audio.conv_pos_groups,
        conv_pos_depth=audio.conv_pos_depth, prenet_depth=audio.prenet_depth, depth=m.depth,
        embed_dim=m.embed_dim, num_heads=m.num_heads, mlp_ratio=m.mlp_ratio,
        norm_eps=m.norm_eps, matmul_impl=m.matmul_impl, alibi_scale=audio.alibi_scale,
        learned_alibi_scale_per_layer=audio.learned_alibi_scale_per_layer,
        num_extra_tokens=audio.num_extra_tokens,
        init_extra_token_zero=audio.init_extra_token_zero, remat=m.remat,
        remat_scope=m.remat_scope, remat_frontend=m.remat_frontend,
        remat_decoder=m.remat_decoder, pipeline_stages=m.pipeline_stages,
        pipeline_microbatches=m.pipeline_microbatches, sinc_input=audio.sinc_input,
        apply_window_to_root=audio.apply_window_to_root, extractor_mode=audio.extractor_mode,
        conv_pos_pre_ln=audio.conv_pos_pre_ln, layer_norm_first=m.layer_norm_first,
        norm_affine=m.norm_affine, end_of_block_targets=m.end_of_block_targets,
        use_alibi_encoder=audio.use_alibi_encoder,
        learned_alibi_scale_per_head=audio.learned_alibi_scale_per_head,
        start_drop_path_rate=ft.drop_path if ft else m.start_drop_path_rate,
        end_drop_path_rate=ft.drop_path if ft else m.end_drop_path_rate,
        prenet_start_drop_path_rate=audio.start_drop_path_rate,
        prenet_end_drop_path_rate=audio.end_drop_path_rate,
        average_top_k_layers=(ft or m).average_top_k_layers, labels=tuple(task.labels()),
        normalize=task.normalize, max_sample_size=task.max_sample_size,
        metric_threshold=crit.metric_threshold, sigma_s=crit.sigma_s,
        maxfilt_s=crit.maxfilt_s, max_duration_s=crit.max_duration_s, lowP=crit.lowP,
        iou_threshold=crit.iou_threshold)
    assert {f.name for f in dataclasses.fields(enc)} == set(want_enc)
    for key, value in want_enc.items():
        assert getattr(enc, key) == value, key
    opt = run.optimization
    for f in dataclasses.fields(opt):
        want = getattr(jcfg.optimization, f.name)
        assert getattr(opt, f.name) == (tuple(want) if f.name == "adam_betas" else want), f.name
    assert (run.finetune is None) == (ft is None)
    if ft is not None:
        mix = ft.mixup
        want_ft = dict(
            freeze_finetune_updates=ft.freeze_finetune_updates,
            feature_grad_mult=ft.feature_grad_mult, apply_mask=ft.apply_mask,
            mask_prob=ft.mask_prob, mask_length=ft.mask_length,
            mask_channel_prob=ft.mask_channel_prob, mask_channel_length=ft.mask_channel_length,
            zero_mask=ft.zero_mask, mask_noise_std=audio.mask_noise_std,
            layer_decay=ft.layer_decay, dropout=ft.dropout, dropout_input=ft.dropout_input,
            activation_dropout=ft.activation_dropout, attention_dropout=ft.attention_dropout,
            final_dropout=ft.final_dropout, layerdrop=ft.layerdrop, drop_path=ft.drop_path,
            update_alibi=ft.update_alibi, load_ema=ft.load_ema,
            load_pretrain_weights=ft.load_pretrain_weights, source_mixup=mix.source_mixup, mixup_prob=mix.mixup_prob,
            same_mixup=mix.same_mixup, mixing_window_length=mix.mixing_window_length,
            gain_mode=mix.gain_mode, target_mixup=mix.target_mixup,
            use_focal_loss=crit.use_focal_loss, label_smoothing=crit.label_smoothing,
            report_accuracy=crit.report_accuracy, optimization=opt)
        assert {f.name for f in dataclasses.fields(run.finetune)} == set(want_ft)
        for key, value in want_ft.items():
            assert getattr(run.finetune, key) == value, key
    else:
        p, mix, d = run.pretrain, m.mixup, audio.decoder
        want_pre = dict(
            model=enc, clone_batch=m.clone_batch, mask_prob=audio.mask_prob,
            mask_length=audio.mask_length, mask_noise_std=audio.mask_noise_std,
            average_top_k_layers=m.average_top_k_layers, ema_decay=m.ema_decay,
            ema_end_decay=m.ema_end_decay, ema_anneal_end_step=m.ema_anneal_end_step,
            ema_encoder_only=m.ema_encoder_only, encoder_dropout=m.encoder_dropout,
            attention_dropout=m.attention_dropout, post_mlp_drop=m.post_mlp_drop,
            prenet_dropout=audio.prenet_dropout, activation_dropout=m.activation_dropout,
            dropout_input=m.dropout_input, layerdrop=m.layerdrop,
            prenet_layerdrop=audio.prenet_layerdrop, source_mixup=mix.source_mixup,
            mixup_prob=mix.mixup_prob, same_mixup=mix.same_mixup,
            mixing_window_length=mix.mixing_window_length, gain_mode=mix.gain_mode,
            teacher_matmul_impl=m.teacher_matmul_impl, cls_loss=m.cls_loss,
            loss_beta=m.loss_beta, loss_scale=m.loss_scale,
            optimization=opt, shared_decoder=m.shared_decoder,
            mask_dropout=audio.mask_dropout, keep_masked_pct=audio.keep_masked_pct,
            encoder_zero_mask=audio.encoder_zero_mask, local_grad_mult=audio.local_grad_mult,
            mask_prob_adjust=0.0, inverse_mask=False,  # the audio span mask reads neither
            instance_norm_target_layer=m.instance_norm_target_layer,
            layer_norm_target_layer=m.layer_norm_target_layer,
            batch_norm_target_layer=m.batch_norm_target_layer,
            instance_norm_targets=m.instance_norm_targets,
            layer_norm_targets=m.layer_norm_targets, target_mixup=mix.target_mixup,
            d2v_loss=m.d2v_loss, recon_loss=m.recon_loss,
            loss_weights=tuple(sorted((crit.loss_weights or {}).items())),
            with_labels=m.with_labels, use_focal_loss=m.use_focal_loss,
            final_dropout=m.final_dropout, metric_threshold=m.metric_threshold,
            min_target_var=m.min_target_var, min_pred_var=m.min_pred_var)
        assert {f.name for f in dataclasses.fields(p)} == set(want_pre) | {"decoder"}
        for key, value in want_pre.items():
            assert getattr(p, key) == value, key
        assert (p.decoder.decoder_dim, p.decoder.decoder_groups, p.decoder.decoder_kernel,
                p.decoder.decoder_layers, p.decoder.input_dropout,
                p.decoder.decoder_residual) == (d.decoder_dim, d.decoder_groups,
                                                d.decoder_kernel, d.decoder_layers,
                                                d.input_dropout, d.decoder_residual)
    c, ds, ck = jcfg.common, jcfg.dataset, jcfg.checkpoint
    assert (run.common.seed, run.common.compute_dtype, run.common.log_interval,
            run.common.tensorboard_logdir, run.common.profile,
            run.common.suppress_crashes) == (c.seed, c.compute_dtype, c.log_interval,
                                             c.tensorboard_logdir, c.profile,
                                             c.suppress_crashes)
    for f in dataclasses.fields(run.dataset):
        want = tuple(ds.buckets()) if f.name == "bucket_lengths" else getattr(ds, f.name)
        assert getattr(run.dataset, f.name) == want, f.name
    for f in dataclasses.fields(run.checkpoint):
        assert getattr(run.checkpoint, f.name) == getattr(ck, f.name), f.name
    for f in dataclasses.fields(run.task):
        if f.name != "label_ext":
            assert getattr(run.task, f.name) == getattr(task, f.name), f.name
    assert (run.criterion.segmentation_metrics, run.criterion.method) == (
        crit.segmentation_metrics, crit.method)
    assert run.distributed.data_parallel == jcfg.distributed.data_parallel


def test_presets_are_the_copies():
    assert RunConfig.finetune_100() == load_config(str(recipes.RECIPES["finetune_100"]))
    assert RunConfig.a2v_large_pretrain() == load_config(
        str(recipes.RECIPES["a2v_large_pretrain"]))


def _bad_value(key):
    item, allowed, scope = recipes.REFUSED[key]
    default = recipes._default_of(key)
    if allowed == "present":
        return None
    if allowed is not None:
        default = allowed[0]
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 2
    if default is None:
        return 0.5 if key.endswith(("loss_scale", "mask_prob_min")) else {"decoder_dim": 16}
    return "other"


@pytest.mark.parametrize("key", sorted(recipes.REFUSED))
def test_refused_key_raises_naming_its_roadmap_item(key):
    item, _, scope = recipes.REFUSED[key]
    name = "finetune_100" if scope == "finetune" else "a2v_large_pretrain"
    tree = recipes.read_tree(str(recipes.RECIPES[name]))
    recipes.check_classes(tree)  # the recipe itself passes
    node = tree
    parts = key.split(".")
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = _bad_value(key)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        recipes.check_classes(tree)


A = "model.modalities.audio."
# the keys that the encoder-options slice moved from REFUSED to MAPPED: key ->
# (recipe, value, the run's field it reaches)
MOVED = {
    "model.start_drop_path_rate": ("a2v_large_pretrain", 0.05,
                                   lambda r: r.pretrain.model.start_drop_path_rate),
    "model.end_drop_path_rate": ("a2v_large_pretrain", 0.2,
                                 lambda r: r.pretrain.model.end_drop_path_rate),
    "model.norm_affine": ("finetune_100", False, lambda r: r.model.norm_affine),
    "model.layer_norm_first": ("finetune_100", True, lambda r: r.model.layer_norm_first),
    "model.activation_dropout": ("a2v_large_pretrain", 0.1,
                                 lambda r: r.pretrain.activation_dropout),
    "model.dropout_input": ("a2v_large_pretrain", 0.1, lambda r: r.pretrain.dropout_input),
    "model.layerdrop": ("a2v_large_pretrain", 0.05, lambda r: r.pretrain.layerdrop),
    A + "prenet_layerdrop": ("a2v_large_pretrain", 0.05, lambda r: r.pretrain.prenet_layerdrop),
    A + "start_drop_path_rate": ("finetune_100", 0.05,
                                 lambda r: r.model.prenet_start_drop_path_rate),
    A + "end_drop_path_rate": ("finetune_100", 0.1, lambda r: r.model.prenet_end_drop_path_rate),
    A + "use_alibi_encoder": ("finetune_100", False, lambda r: r.model.use_alibi_encoder),
    A + "learned_alibi_scale_per_head": ("finetune_100", False,
                                         lambda r: r.model.learned_alibi_scale_per_head),
    A + "extractor_mode": ("finetune_100", "default", lambda r: r.model.extractor_mode),
    A + "conv_pos_pre_ln": ("finetune_100", True, lambda r: r.model.conv_pos_pre_ln),
    A + "sinc_input": ("finetune_100", False, lambda r: r.model.sinc_input),
    A + "apply_window_to_root": ("finetune_100", True, lambda r: r.model.apply_window_to_root),
    A + "sinc_norm": ("finetune_100", "pcen", lambda r: r.model.sinc_norm),
}


@pytest.mark.parametrize("key", sorted(MOVED))
def test_moved_key_maps(key):
    """Each key that was refused until the encoder's options were ported
    (ROADMAP A.8 and the pretraining dropouts of A.7) is mapped now: a
    value other than the recipe's reaches its field of the run; the trunk's
    drop-path of a finetune run is ``finetune.drop_path`` at both ends."""
    assert key in recipes.MAPPED and key not in recipes.REFUSED
    name, value, field = MOVED[key]
    run = load_config(str(recipes.RECIPES[name]), [f"{key}={value}"])
    assert field(run) == value
    if key == "model.start_drop_path_rate":
        ft = load_config(str(recipes.RECIPES["finetune_100"]),
                         [f"{key}={value}", "finetune.drop_path=0.3"])
        assert (ft.model.start_drop_path_rate, ft.model.end_drop_path_rate) == (0.3, 0.3)
    if key == A + "extractor_mode":
        with pytest.raises(ValueError, match="extractor_mode"):
            load_config(str(recipes.RECIPES[name]), [f"{key}=other"])
    if key == A + "sinc_norm":
        with pytest.raises(ValueError, match="sinc_norm"):
            load_config(str(recipes.RECIPES[name]), [f"{key}=other"])


P = "a2v_large_pretrain"
# the keys of the rest of pretraining (ROADMAP A.7) moved from REFUSED to
# MAPPED: key -> (recipe, value, the run's field it reaches, what it reads)
MOVED_A7 = {
    "criterion.loss_weights": (P, {"linear_eval_loss": 0.5},
                               lambda r: r.pretrain.loss_weights,
                               (("linear_eval_loss", 0.5),)),
    "model.end_of_block_targets": (P, True, lambda r: r.pretrain.model.end_of_block_targets,
                                   True),
    "model.layer_norm_target_layer": (P, True, lambda r: r.pretrain.layer_norm_target_layer,
                                      True),
    "model.batch_norm_target_layer": (P, True, lambda r: r.pretrain.batch_norm_target_layer,
                                      True),
    "model.instance_norm_target_layer": (
        P, False, lambda r: r.pretrain.instance_norm_target_layer, False),
    "model.instance_norm_targets": (P, True, lambda r: r.pretrain.instance_norm_targets, True),
    "model.layer_norm_targets": (P, True, lambda r: r.pretrain.layer_norm_targets, True),
    "model.shared_decoder": (P, {"decoder_dim": 32, "decoder_groups": 4, "projection_layers": 2},
                             lambda r: (r.pretrain.shared_decoder.decoder_dim,
                                        r.pretrain.shared_decoder.projection_layers), (32, 2)),
    "model.min_target_var": (P, 0.2, lambda r: r.pretrain.min_target_var, 0.2),
    "model.min_pred_var": (P, 0.02, lambda r: r.pretrain.min_pred_var, 0.02),
    "model.recon_loss": (P, 1.0, lambda r: r.pretrain.recon_loss, 1.0),
    "model.d2v_loss": (P, 0.5, lambda r: r.pretrain.d2v_loss, 0.5),
    "model.final_dropout": (P, 0.1, lambda r: r.pretrain.final_dropout, 0.1),
    "model.metric_threshold": (P, 0.4, lambda r: r.pretrain.metric_threshold, 0.4),
    "model.mixup.target_mixup": (P, True, lambda r: r.pretrain.target_mixup, True),
    A + "keep_masked_pct": (P, 0.1, lambda r: r.pretrain.keep_masked_pct, 0.1),
    A + "mask_dropout": (P, 0.1, lambda r: r.pretrain.mask_dropout, 0.1),
    A + "encoder_zero_mask": (P, False, lambda r: r.pretrain.encoder_zero_mask, False),
    A + "local_grad_mult": (P, 0.5, lambda r: r.pretrain.local_grad_mult, 0.5),
    A + "decoder": (P, None, lambda r: r.pretrain.decoder, None),
    A + "decoder.projection_layers": (P, 3, lambda r: r.pretrain.decoder.projection_layers, 3),
    A + "decoder.projection_ratio": (P, 1.5, lambda r: r.pretrain.decoder.projection_ratio, 1.5),
    "finetune.load_pretrain_weights": ("finetune_100", True,
                                       lambda r: r.finetune.load_pretrain_weights, True),
    A + "inverse_mask": (P, True, lambda r: r.pretrain.inverse_mask, False),  # ignored
}


@pytest.mark.parametrize("key", sorted(MOVED_A7))
def test_pretraining_key_maps(key):
    """Each key of the rest of pretraining is mapped now (the audio
    ``inverse_mask`` ignored, as JAX's span mask reads it nowhere): a value
    other than the recipe's, on a copy of the recipe, reaches its field of
    the run; a shared decoder comes from the schema's decoder defaults with
    the keys given; the modality decoder may be absent beside a shared one
    only."""
    name, value, field, want = MOVED_A7[key]
    assert key not in recipes.REFUSED
    assert key in (recipes.IGNORED if key.endswith("inverse_mask") else recipes.MAPPED)
    extra = ["model.shared_decoder.decoder_dim=768"] if key == A + "decoder" else []
    if key in ("model.shared_decoder", "criterion.loss_weights"):
        overrides = [f"{key}.{k}={v}" for k, v in value.items()] \
            if key == "model.shared_decoder" else [f"{key}={value!r}"]
    else:
        overrides = [f"{key}={value}"]
    run = load_config(str(recipes.RECIPES[name]), overrides + extra)
    assert field(run) == want
    if key == A + "decoder":
        with pytest.raises(ValueError, match="needs a decoder"):
            load_config(str(recipes.RECIPES[name]), overrides)


def test_ignored_keys_load_and_unknown_keys_raise(caplog):
    path = str(recipes.RECIPES["finetune_100"])
    base = load_config(path)
    run = load_config(path, ["model.attn_impl=flash",
                             "model.modalities.audio.decoder.lane_pack_max=8",
                             "common.log_format=text"])
    assert run == base
    assert "model.attn_impl='flash' is ignored" in caplog.text
    for bad in ("model.nope=1", "nope.x=1", "model.depth"):
        with pytest.raises((KeyError, ValueError)):
            load_config(path, [bad])
    with pytest.raises(ValueError, match="teacher_matmul_impl"):
        load_config(path, ["model.teacher_matmul_impl=int4"])
    # JAX key names reach the run: remat, the int8 teacher, tokens, losses
    pre = load_config(str(recipes.RECIPES["a2v_large_pretrain_v5e"]), [
        "model.teacher_matmul_impl=int8", "model.cls_loss=1.0", "model.loss_beta=0.25",
        "model.loss_scale=2.0", "model.modalities.audio.num_extra_tokens=1",
        "model.modalities.audio.learned_alibi_scale_per_layer=true",
        "model.remat_frontend=true", "model.remat_decoder=true", "task.label_ext=npz"])
    p = pre.pretrain
    assert (p.teacher_matmul_impl, p.cls_loss, p.loss_beta, p.loss_scale) == ("int8", 1.0, 0.25,
                                                                             2.0)
    assert (p.model.num_extra_tokens, p.model.learned_alibi_scale_per_layer, p.model.remat,
            p.model.remat_scope, p.model.remat_frontend, p.model.remat_decoder) == (
        1, True, True, "attn", True, True)
    assert pre.task.label_ext == "npz"


TINY_CLI = [
    "model.depth=2", "model.embed_dim=32", "model.num_heads=4", "model.average_top_k_layers=2",
    A + "prenet_depth=1", A + "conv_pos_depth=2", A + "conv_pos_width=10",
    A + "conv_pos_groups=2", "task.conv_feature_layers=[(9, 7, 1), (16, 4, 2), (16, 3, 2)]",
    "model.clone_batch=2", A + "decoder.decoder_dim=16", A + "decoder.decoder_groups=4",
    A + "decoder.decoder_kernel=3", A + "decoder.decoder_layers=2",
    "common.compute_dtype=float32", "common.tensorboard_logdir=", "dataset.batch_size=2",
    "dataset.num_workers=2", "task.max_sample_size=800", "task.label_ext=npz",
    "optimization.update_freq=1", "task.min_label_size=0", "task.min_sample_size=1",
    "dataset.bucket_lengths="]
LABELS = ("beep", "synch", "sn", "cc", "ld", "oth", "mo", "al", "soc", "agg", "eating", "focal")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("recipes") / "data"), n_clips=8,
                    clip_seconds=0.1, labels=LABELS, seed=1, label_ext="npz")


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_config_tiny_cpu(name, corpus, tmp_path):
    """``train_cli --config`` on the copy for one step at tiny widths (JAX
    key names), with ``common.profile`` on for the first finetune recipe:
    a finite loss, a step-1 checkpoint and, when profiled, a trace."""
    extra = []
    if name.endswith("finetune") or name.startswith("finetune"):
        extra = ["dataset.train_subset=train_0", "finetune.average_top_k_layers=2",
                 "finetune.freeze_finetune_updates=0", "finetune.mask_channel_length=4",
                 f"task.unique_labels=\"{list(LABELS)}\""]
    if name == "finetune_100":
        extra += ["common.profile=true", f"common.tensorboard_logdir={tmp_path / 'trace'}"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = train_cli.main(["--config", str(recipes.RECIPES[name]), "--data", corpus,
                              "--save-dir", str(tmp_path / "run"), "--max-steps", "1",
                              "--device", "cpu", *TINY_CLI, *extra])
    finally:
        torch.set_num_threads(n)
    assert np.isfinite(out["train/loss"])
    from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir

    assert load_checkpoint_dir(str(tmp_path / "run"))["step"] == 1
    if name == "finetune_100":
        assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


# every moved key set in a copy of a recipe: the finetune copy takes variant
# P's options (PCEN, the windowed learnable sinc, the LayerNorm before the
# positional convs, pre-LN blocks without affine, one ALiBi scale for the
# heads, drop-path), the pretrain copy variant N's (no ALiBi, a plain first
# conv, the "default" extractor mode, drop-path) with the A.7 dropouts
OPTION_COPIES = {
    "finetune_100": {
        "model": dict(layer_norm_first=True, norm_affine=False, start_drop_path_rate=0.1,
                      end_drop_path_rate=0.1),
        "model.modalities.audio": dict(
            sinc_norm="pcen", apply_window_to_root=True, conv_pos_pre_ln=True,
            learned_alibi_scale_per_head=False, start_drop_path_rate=0.05,
            end_drop_path_rate=0.1),
        "finetune": dict(drop_path=0.1, activation_dropout=0.1)},
    "a2v_large_pretrain": {
        "model": dict(activation_dropout=0.1, dropout_input=0.1, layerdrop=0.2,
                      start_drop_path_rate=0.0, end_drop_path_rate=0.1),
        "model.modalities.audio": dict(
            use_alibi_encoder=False, sinc_input=False, extractor_mode="default",
            prenet_layerdrop=0.2, start_drop_path_rate=0.1, end_drop_path_rate=0.1)},
}


@pytest.mark.parametrize("name", sorted(OPTION_COPIES))
def test_train_cli_config_with_every_option(name, corpus, tmp_path):
    """A copy of the recipe that sets the moved keys runs one step of
    ``train_cli --config`` at tiny widths on the CPU (finetune: the
    variant P encoder; pretrain: variant N with the A.7 dropouts)."""
    import yaml

    with open(recipes.RECIPES[name]) as f:
        tree = yaml.safe_load(f)
    for group, values in OPTION_COPIES[name].items():
        node = tree
        for part in group.split("."):
            node = node.setdefault(part, {})
        node.update(values)
    path = tmp_path / f"{name}_options.yaml"
    path.write_text(yaml.safe_dump(tree))
    set_keys = {f"{g}.{k}" for g, v in OPTION_COPIES[name].items() for k in v}
    assert set_keys - {"finetune.drop_path", "finetune.activation_dropout"} <= set(MOVED)
    extra = []
    if name.startswith("finetune"):
        extra = ["dataset.train_subset=train_0", "finetune.average_top_k_layers=2",
                 "finetune.freeze_finetune_updates=0", "finetune.mask_channel_length=4",
                 f"task.unique_labels=\"{list(LABELS)}\""]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = train_cli.main(["--config", str(path), "--data", corpus,
                              "--save-dir", str(tmp_path / "run"), "--max-steps", "1",
                              "--device", "cpu", *TINY_CLI, *extra])
    finally:
        torch.set_num_threads(n)
    assert np.isfinite(out["train/loss"])
    run = load_config(str(path), TINY_CLI + extra)
    enc = run.encoder
    if name.startswith("finetune"):
        assert (enc.sinc_norm, enc.layer_norm_first, enc.norm_affine,
                enc.start_drop_path_rate) == ("pcen", True, False, 0.1)
    else:
        assert (enc.use_alibi_encoder, enc.extractor_mode, run.pretrain.layerdrop,
                run.pretrain.prenet_layerdrop) == (False, "default", 0.2, 0.2)


def test_train_cli_suppresses_crashes(tmp_path, caplog):
    """``common.suppress_crashes`` logs the run's exception and returns
    None (a manifest directory that does not exist)."""
    out = train_cli.main(["--config", str(recipes.RECIPES["a2v_large_pretrain"]), "--data",
                          str(tmp_path / "missing"), "--save-dir", str(tmp_path / "run"),
                          "--device", "cpu", "common.suppress_crashes=true", *TINY_CLI])
    assert out is None and "run crashed (suppressed)" in caplog.text


def test_train_cli_pretrains_with_the_probe_then_hands_it_over(corpus, tmp_path):
    """``train_cli --config`` on the pretraining copy with the keys of the
    rest of pretraining (labels and the focal probe, a shared decoder with a
    projection head, the layer-normed targets, masking options, loss
    weights), two steps; then a finetune run from its checkpoint with
    ``finetune.load_pretrain_weights``: at step 0 its head is the probe bit
    for bit, and it trains a step."""
    from animal2vec_tpu_torch.train.build import init_finetune
    from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir

    labels = [f"task.unique_labels=\"{list(LABELS)}\""]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = train_cli.main([
            "--config", str(recipes.RECIPES["a2v_large_pretrain"]), "--data", corpus,
            "--save-dir", str(tmp_path / "pre"), "--max-steps", "2", "--device", "cpu",
            *TINY_CLI, *labels, "task.with_labels=true", "dataset.train_subset=train_0",
            "model.shared_decoder.decoder_dim=16", "model.shared_decoder.decoder_groups=4",
            "model.shared_decoder.decoder_kernel=3", "model.shared_decoder.decoder_layers=1",
            "model.shared_decoder.projection_layers=2", "model.layer_norm_targets=true",
            A + "keep_masked_pct=0.1", A + "mask_dropout=0.1",
            "criterion.loss_weights={'linear_eval_loss': 0.5}"])
        assert np.isfinite(out["train/loss"]) and out["train/loss_linear_eval_loss"] > 0
        assert out["train/pretrain/total"] > 0
        pre = load_checkpoint_dir(str(tmp_path / "pre"))["model"]
        ft_args = [*TINY_CLI, *labels, "dataset.train_subset=train_0",
                   "finetune.average_top_k_layers=2", "finetune.freeze_finetune_updates=0",
                   "finetune.mask_channel_length=4", "finetune.load_pretrain_weights=true"]
        run = load_config(str(recipes.RECIPES["finetune_100"]),
                          ft_args + [f"task.data={corpus}"])
        model, _ = init_finetune(run, "cpu", pre)
        assert torch.equal(model.proj.weight, pre["linear_eval_projection.weight"])
        assert torch.equal(model.proj.bias, pre["linear_eval_projection.bias"])
        out = train_cli.main(["--config", str(recipes.RECIPES["finetune_100"]), "--data", corpus,
                              "--save-dir", str(tmp_path / "ft"), "--max-steps", "1",
                              "--pretrained", str(tmp_path / "pre"), "--device", "cpu",
                              *ft_args])
        assert np.isfinite(out["train/loss"])
    finally:
        torch.set_num_threads(n)
