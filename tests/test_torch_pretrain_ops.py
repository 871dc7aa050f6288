"""The pretraining slice's configs and ops in the port against the JAX
package: ``PretrainConfig`` against ``a2v_large_pretrain.yaml`` and
``vit_b16`` against the JAX defaults; the masks (``block_mask_2d`` on the
same uniform draws, ``make_mask_info_static``, ``gather_keep``,
``scatter_with_mask_tokens``, ``masked_alibi``), the regression loss,
``compute_var``, the EMA decay schedule, ``ema_param_label`` on every
parameter of tiny audio and image models, the target normalizations, the
decoders (``Decoder1d``, ``Decoder2d``) and a pre-LN block in training
(the fused MLP's autograd, the post-MLP dropout site).

Tolerances: masks, ids and gathers exact; losses, statistics and target
normalizations 1e-6; the decoders and the pre-LN block 1e-5 (convs and
GEMMs in another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import animal2vec_tpu.ops.masking as jax_masking
from animal2vec_tpu.config import ModelConfig, load_config
from animal2vec_tpu.models.data2vec2 import Data2VecMulti as JaxData2VecMulti
from animal2vec_tpu.models.data2vec2 import ema_param_label as jax_ema_param_label
from animal2vec_tpu.models.data2vec2 import finish_targets as jax_finish_targets
from animal2vec_tpu.models.data2vec2 import make_targets as jax_make_targets
from animal2vec_tpu.models.modules import AltBlock as JaxAltBlock, BlockConfig
from animal2vec_tpu.models.modules import Decoder1d as JaxDecoder1d
from animal2vec_tpu.models.modules import Decoder2d as JaxDecoder2d
from animal2vec_tpu.models.modules import fp32_instance_norm as jax_instance_norm
from animal2vec_tpu.ops.losses import d2v_regression_loss as jax_regression_loss
from animal2vec_tpu.ops.stats import compute_var as jax_compute_var
from animal2vec_tpu.ops.stats import get_annealed_rate as jax_annealed_rate
from animal2vec_tpu.train.build import build_pretrain_model as jax_build_pretrain_model
from animal2vec_tpu.train.state import ema_decay_at as jax_ema_decay_at

from animal2vec_tpu_torch.config import (
    DecoderConfig, FinetuneConfig, ImageConfig, OptimizationConfig, PretrainConfig,
)
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti, ema_param_label, make_targets
from animal2vec_tpu_torch.models.finetune import build_pretrain_model
from animal2vec_tpu_torch.models.modules import AltBlock, Decoder1d, Decoder2d, fp32_instance_norm
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.ops.losses import d2v_regression_loss
from animal2vec_tpu_torch.ops.masking import (
    block_mask_2d, gather_keep, make_mask_info_static, masked_alibi, scatter_with_mask_tokens,
)
from animal2vec_tpu_torch.ops.stats import compute_var, get_annealed_rate
from animal2vec_tpu_torch.train.pretrain import mask_tokens
from animal2vec_tpu_torch.train.state import ema_decay_at
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_torch_model import _jittered
from tests.test_torch_pretrain_step import IMAGE, _jax_cfg, _port_cfg

TOL = 1e-6
MODULE_TOL = 1e-5


def test_pretrain_config_matches_the_a2v_recipe():
    """Every field of ``PretrainConfig()`` against what ``load_config`` of
    ``a2v_large_pretrain.yaml`` resolves it to; the recipe's fields that the
    port does not carry hold the values the port implements."""
    cfg = load_config("animal2vec_tpu/configs/a2v_large_pretrain.yaml")
    m, audio, mix, opt = cfg.model, cfg.model.modalities.audio, cfg.model.mixup, cfg.optimization
    expected = dict(
        clone_batch=m.clone_batch, mask_prob=audio.mask_prob, mask_length=audio.mask_length,
        mask_noise_std=audio.mask_noise_std, average_top_k_layers=m.average_top_k_layers,
        ema_decay=m.ema_decay, ema_end_decay=m.ema_end_decay,
        ema_anneal_end_step=m.ema_anneal_end_step, ema_encoder_only=m.ema_encoder_only,
        encoder_dropout=m.encoder_dropout, attention_dropout=m.attention_dropout,
        post_mlp_drop=m.post_mlp_drop, prenet_dropout=audio.prenet_dropout,
        activation_dropout=m.activation_dropout, dropout_input=m.dropout_input,
        layerdrop=m.layerdrop, prenet_layerdrop=audio.prenet_layerdrop,
        source_mixup=mix.source_mixup, mixup_prob=mix.mixup_prob, same_mixup=mix.same_mixup,
        mixing_window_length=mix.mixing_window_length, gain_mode=mix.gain_mode,
        teacher_matmul_impl=m.teacher_matmul_impl, cls_loss=m.cls_loss, loss_beta=m.loss_beta,
        loss_scale=m.loss_scale, shared_decoder=m.shared_decoder,
        mask_dropout=audio.mask_dropout, keep_masked_pct=audio.keep_masked_pct,
        encoder_zero_mask=audio.encoder_zero_mask, local_grad_mult=audio.local_grad_mult,
        mask_prob_adjust=0.0, inverse_mask=False,  # the audio span mask reads neither
        instance_norm_target_layer=m.instance_norm_target_layer,
        layer_norm_target_layer=m.layer_norm_target_layer,
        batch_norm_target_layer=m.batch_norm_target_layer,
        instance_norm_targets=m.instance_norm_targets, layer_norm_targets=m.layer_norm_targets,
        target_mixup=mix.target_mixup, d2v_loss=m.d2v_loss, recon_loss=m.recon_loss,
        loss_weights=tuple(sorted((cfg.criterion.loss_weights or {}).items())),
        with_labels=m.with_labels, use_focal_loss=m.use_focal_loss,
        final_dropout=m.final_dropout, metric_threshold=m.metric_threshold,
        min_target_var=m.min_target_var, min_pred_var=m.min_pred_var,
    )
    ours = PretrainConfig()
    assert set(expected) | {"model", "decoder", "optimization"} == {
        f.name for f in dataclasses.fields(ours)}
    for name, value in expected.items():
        assert getattr(ours, name) == value, name
    for f in dataclasses.fields(OptimizationConfig):
        want = getattr(opt, f.name)
        assert getattr(ours.optimization, f.name) == (tuple(want) if f.name == "adam_betas"
                                                      else want), f.name
    d = audio.decoder
    assert ours.decoder == DecoderConfig(d.decoder_dim, d.decoder_groups, d.decoder_kernel,
                                         d.decoder_layers, d.input_dropout, d.decoder_residual)
    assert ours.decoder == DecoderConfig(768, 16, 7, 4, 0.1)
    model = ours.model
    assert (model.depth, model.embed_dim, model.num_heads, model.prenet_depth, model.norm_eps,
            model.mlp_ratio) == (m.depth, m.embed_dim, m.num_heads, audio.prenet_depth,
                                 m.norm_eps, m.mlp_ratio)
    assert list(model.conv_layers) == cfg.task.conv_layers()
    assert (model.sinc_norm, model.use_pswish, model.conv_pos_width, model.conv_pos_groups,
            model.conv_pos_depth) == (audio.sinc_norm, audio.use_pswish, audio.conv_pos_width,
                                      audio.conv_pos_groups, audio.conv_pos_depth)
    # what the port implements of the fields it does not carry
    assert _recipe_constants(m, audio) and not cfg.task.with_labels and not mix.target_mixup
    assert m.shared_decoder is None and m.cls_loss == 0
    assert audio.num_extra_tokens == 0 and not m.teacher_matmul_impl and m.matmul_impl == "bf16"
    assert m.start_drop_path_rate == m.end_drop_path_rate == 0.0
    assert d.projection_layers == 1 and audio.use_alibi_encoder
    assert audio.learned_alibi_scale_per_head and not audio.learned_alibi_scale_per_layer
    assert mask_tokens(ours, 2000) == 1875 and 2000 - 1875 == 125


def _recipe_constants(m, modality) -> bool:
    """The values of a JAX ``ModelConfig`` and its modality config that the
    port implements as constants: instance-normed target layers and no other
    target norm, the squared error at 1/sqrt(C), no reconstruction loss, no
    layerdrop, input or activation dropout, zeroed student masks without
    dropout, inversion or kept masked tokens, the frontend's full
    gradient."""
    assert m.instance_norm_target_layer and not m.layer_norm_target_layer
    assert not (m.batch_norm_target_layer or m.instance_norm_targets or m.layer_norm_targets)
    assert (m.loss_beta, m.loss_scale, m.d2v_loss, m.recon_loss) == (0.0, None, 1.0, 0.0)
    assert (m.layerdrop, m.dropout_input, m.activation_dropout) == (0.0, 0.0, 0.0)
    assert modality.prenet_layerdrop == 0.0 and modality.local_grad_mult == 1.0
    assert modality.encoder_zero_mask and not modality.inverse_mask
    assert modality.mask_dropout == 0.0 and modality.keep_masked_pct == 0.0
    return True


def test_vit_b16_matches_the_jax_image_defaults():
    m = ModelConfig()
    img = m.modalities.image
    ours = PretrainConfig.vit_b16()
    assert ours.model == ImageConfig(use_alibi_encoder=True) and ours.modality == "IMAGE"
    d = img.decoder
    assert ours.decoder == DecoderConfig(d.decoder_dim, d.decoder_groups, d.decoder_kernel,
                                         d.decoder_layers, d.input_dropout, d.decoder_residual)
    opt = load_config().optimization  # OptimizationConfig's defaults
    for f in dataclasses.fields(OptimizationConfig):
        want = getattr(opt, f.name)
        assert getattr(ours.optimization, f.name) == (tuple(want) if f.name == "adam_betas"
                                                      else want), f.name
    for name in ("ema_decay", "ema_end_decay", "ema_encoder_only"):
        assert getattr(ours, name) == getattr(m, name), name
    for name in ("mask_prob", "mask_length", "mask_noise_std", "prenet_dropout"):
        assert getattr(ours, name) == getattr(img, name), name
    # the overrides: JAX's own image pretrain test, and k = the trunk's depth
    m.instance_norm_target_layer = True
    assert _recipe_constants(m, img) and img.mask_prob_adjust == 0.0
    assert (ours.clone_batch, ours.encoder_dropout, ours.post_mlp_drop) == (2, 0.0, 0.0)
    assert ours.attention_dropout == m.attention_dropout == 0.1  # JAX's default
    assert ours.average_top_k_layers == m.depth == 8 and m.average_top_k_layers == 16
    assert ours.ema_anneal_end_step == opt.max_update
    assert mask_tokens(ours, 196) == 137


@pytest.mark.parametrize("make,err", [
    (lambda: PretrainConfig(average_top_k_layers=17), ValueError),
    (lambda: PretrainConfig(model=FinetuneConfig(matmul_impl="int8")), NotImplementedError),
    (lambda: PretrainConfig(clone_batch=0), ValueError),
    (lambda: PretrainConfig(optimization=OptimizationConfig(schedule="linear")), ValueError),
    (lambda: PretrainConfig(end_of_block_targets=True), TypeError),  # the encoder's field
])
def test_pretrain_config_refuses(make, err):
    """Each refusal; attention dropout with the image modality's dense bias
    no longer raises, and an int8 teacher is taken at widths off 128 (JAX's
    XLA route there)."""
    with pytest.raises(err):
        make()
    assert PretrainConfig.vit_b16(attention_dropout=0.1).attention_dropout == 0.1
    assert PretrainConfig.vit_b16(model=ImageConfig(embed_dim=96, num_heads=2),
                                  teacher_matmul_impl="int8").teacher_matmul_impl == "int8"


@pytest.mark.parametrize("prob", [0.7, 0.5])
def test_block_mask_2d_matches_jax_on_the_same_draws(prob, monkeypatch):
    """The port's sampler and JAX's on the same uniform draws (JAX's
    ``jax.random.uniform`` replaced by the port generator's draws, in the
    order both take them) give the same mask; every row has the static
    count; a single seed's L x L block is all masked."""
    b, p, length = 6, 196, 5
    gen = torch.Generator().manual_seed(3)
    ours = block_mask_2d(b, p, prob, length, gen)
    replay = torch.Generator().manual_seed(3)
    draws = [torch.rand((b, p), generator=replay).numpy() for _ in range(2)]
    monkeypatch.setattr(jax_masking.jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(draws.pop(0)))
    ref = jax_masking.block_mask_2d(jax.random.PRNGKey(0), b, p, prob, length, 0.0, False)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (ours.sum(1) == int(p * prob)).all()
    # one seed (the first draw's smallest cell) dilates to the L x L block
    # below and right of it, clipped at the grid's edge; the exactify step
    # keeps every block cell and tops the count up elsewhere
    one = block_mask_2d(1, p, 0.2, length, torch.Generator().manual_seed(4))
    grid = one.reshape(14, 14).numpy()
    r, c = divmod(int(torch.rand((1, p), generator=torch.Generator().manual_seed(4)).argmin()), 14)
    assert grid[r:r + length, c:c + length].all() and grid.sum() == int(p * 0.2)


def test_mask_info_and_gathers_match_jax():
    b, t, m, c, h = 4, 30, 21, 5, 3
    rng = np.random.default_rng(11)
    mask = np.zeros((b, t), np.int32)
    for r in range(b):
        mask[r, rng.permutation(t)[:m]] = 1
    info = make_mask_info_static(torch.from_numpy(mask), m)
    jinfo = jax_masking.make_mask_info_static(jnp.asarray(mask), m)
    for a, j in zip(info, jinfo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    keep = gather_keep(torch.from_numpy(x), info)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jax_masking.gather_keep(
        jnp.asarray(x), jinfo)))
    full = scatter_with_mask_tokens(keep, info, 0.0)
    ref = jax_masking.scatter_with_mask_tokens(jnp.asarray(keep.numpy()), jinfo,
                                               jax.random.PRNGKey(0), 0.0)
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(full.numpy(), x * (1 - mask[..., None]))
    noisy = scatter_with_mask_tokens(keep, info, 0.01, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(noisy.numpy()[mask == 0], x[mask == 0])
    assert 0 < np.abs(noisy.numpy()[mask == 1]).max() < 0.1
    bias = rng.normal(size=(1, h, t, t)).astype(np.float32)
    ours = masked_alibi(torch.from_numpy(bias), info)
    ref = jax_masking.masked_alibi(jnp.broadcast_to(jnp.asarray(bias), (b, h, t, t)), jinfo)
    assert ours.shape == (b, h, t - m, t - m)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(3, 7, 16), (2, 5, 768), (4, 3), (1, 9, 5)])
def test_regression_loss_matches_jax(shape):
    rng = np.random.default_rng(12)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32)
    ours = d2v_regression_loss(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y))
    ref = jax_regression_loss(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y), 0.0, None)
    assert ours.dtype == torch.float32 and ours.shape == (x.size // shape[-1], shape[-1])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_statistics_and_ema_schedule_match_jax():
    rng = np.random.default_rng(13)
    y = (rng.normal(size=(4, 9, 24)) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(float(compute_var(torch.from_numpy(y))),
                               float(jax_compute_var(jnp.asarray(y))), rtol=0, atol=TOL)
    for step in (0, 1, 7, 2999, 3000, 5000):
        assert get_annealed_rate(0.999, 0.9999, step, 3000) == float(
            jax_annealed_rate(0.999, 0.9999, jnp.asarray(step, jnp.int32), 3000))
    for cfg in (PretrainConfig(), PretrainConfig.vit_b16()):
        jcfg = ModelConfig(ema_decay=cfg.ema_decay, ema_end_decay=cfg.ema_end_decay,
                           ema_anneal_end_step=cfg.ema_anneal_end_step)
        for step in (1, 10_000, cfg.ema_anneal_end_step, cfg.ema_anneal_end_step + 5):
            ours = ema_decay_at(cfg, step)
            assert ours == float(jax_ema_decay_at(jcfg, jnp.asarray(step, jnp.int32))), step
    assert ema_decay_at(PretrainConfig(), 300_000) == 1.0
    same = dataclasses.replace(PretrainConfig(), ema_end_decay=0.9997)
    assert ema_decay_at(same, 5) == float(np.float32(0.9997))


@pytest.mark.parametrize("modality", ["AUDIO", "IMAGE"])
def test_ema_param_label_matches_jax(modality):
    """On every parameter path of the JAX tiny pretraining model, both
    settings of ``ema_encoder_only``, the port's label of the port's name is
    JAX's label of the path; and the names are the port model's."""
    jcfg = _jax_cfg(modality)
    jmodel = jax_build_pretrain_model(jcfg)
    example = jnp.zeros((1, 800)) if modality == "AUDIO" else jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "mask_noise": jax.random.PRNGKey(1)}, example,
        modality))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    model = Data2VecMulti(_port_cfg(modality).model, pretrain=_port_cfg(modality))
    names = set()
    for path, leaf in flat:
        keys = tuple(str(k.key) for k in path)
        tree = {}
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.zeros(leaf.shape, np.float32)
        ported = list(params_from_jax(tree))
        names.update(ported)
        for only in (True, False):
            want = jax_ema_param_label(keys, only)
            assert all(ema_param_label(n, only) == want for n in ported), (keys, only)
    assert names == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("k", [1, 2, 3])
def test_target_normalizations_match_jax(k):
    """``make_targets`` against JAX's with the recipes' flags (instance-normed
    target layers, no final norm: JAX's ``finish_targets`` is the identity),
    and ``fp32_instance_norm`` against JAX's."""
    jcfg = ModelConfig(average_top_k_layers=k, instance_norm_target_layer=True)
    rng = np.random.default_rng(14)
    taps = (rng.normal(size=(3, 2, 11, 8)) * 2 + 0.5).astype(np.float32)
    ours = make_targets(list(torch.from_numpy(taps)), k)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_make_targets(jnp.asarray(taps), jcfg)),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(np.asarray(jax_finish_targets(jnp.asarray(taps[0]), jcfg)),
                                  taps[0])
    np.testing.assert_allclose(fp32_instance_norm(torch.from_numpy(taps[1])).numpy(),
                               np.asarray(jax_instance_norm(jnp.asarray(taps[1]))),
                               rtol=0, atol=TOL)


def _module_params(module, x, seed):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return _jittered(params, seed + 1)


@pytest.mark.parametrize("kernel", [3, 4])
def test_decoder1d_matches_jax(kernel):
    x = np.random.default_rng(15).normal(size=(2, 20, 32)).astype(np.float32)
    jdec = JaxDecoder1d(decoder_dim=16, decoder_kernel=kernel, decoder_groups=4,
                        decoder_layers=3, out_dim=32)
    params = _module_params(jdec, x, 16)
    dec = Decoder1d(32, 32, 16, kernel, 4, 3)
    dec.load_state_dict(params_from_jax(params), strict=True)
    ours = dec(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(jdec.apply({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=MODULE_TOL)


@pytest.mark.parametrize("kernel", [3, 4])
def test_decoder2d_matches_jax(kernel):
    x = np.random.default_rng(17).normal(size=(2, 16, 32)).astype(np.float32)
    jdec = JaxDecoder2d(decoder_dim=16, decoder_kernel=kernel, decoder_groups=4,
                        decoder_layers=2, out_dim=32, h_size=4, w_size=4)
    params = _module_params(jdec, x, 18)
    dec = Decoder2d(32, 32, 16, kernel, 4, 2, grid=4)
    dec.load_state_dict(params_from_jax(params), strict=True)
    ours = dec(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(jdec.apply({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=MODULE_TOL)


def test_pre_ln_block_trains_as_jax():
    """A pre-LN block in training with every rate 0 (JAX's fused MLP path;
    the port's ``fused_mlp`` autograd, its plain version on the CPU) and a
    dense bias: output, tap and every gradient against ``jax.grad``; with
    ``post_mlp_drop`` the residual branch is dropped, the tap is not."""
    c, h, t = 32, 4, 10
    rng = np.random.default_rng(19)
    x = rng.normal(size=(2, t, c)).astype(np.float32)
    bias = rng.normal(size=(1, h, t, t)).astype(np.float32)
    g_out, g_tap = (rng.normal(size=(2, t, c)).astype(np.float32) for _ in range(2))
    jblk = JaxAltBlock(cfg=BlockConfig(dim=c, num_heads=h, layer_norm_first=True))
    jb = jnp.broadcast_to(jnp.asarray(bias), (2, h, t, t))
    params = _jittered(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), None, jb)["params"], 1)

    def f(p, x):
        out, tap = jblk.apply({"params": p}, x, None, jb, 0.0, False,
                              rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.sum(out * g_out) + jnp.sum(tap * g_tap), (out, tap)

    (_, (out_j, tap_j)), (gp_j, gx_j) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    blk = AltBlock(c, h, layer_norm_first=True).train()
    blk.load_state_dict(params_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out, tap = blk(xt, None, torch.from_numpy(bias), Rngs.from_seed(0, "cpu"))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=MODULE_TOL)
    np.testing.assert_allclose(tap.detach().numpy(), np.asarray(tap_j), rtol=0, atol=MODULE_TOL)
    ((out * torch.from_numpy(g_out)).sum() + (tap * torch.from_numpy(g_tap)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=0, atol=MODULE_TOL)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    for name, p in blk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=0, atol=MODULE_TOL,
                                   err_msg=name)
    drop = AltBlock(c, h, layer_norm_first=True, post_mlp_drop=0.5).train()
    drop.load_state_dict(blk.state_dict())
    out_d, tap_d = drop(torch.from_numpy(x), None, torch.from_numpy(bias),
                        Rngs.from_seed(0, "cpu"))
    kept = (out_d - tap_d).detach()
    assert torch.allclose(tap_d, tap) and ((kept == 0) | torch.isclose(kept, 2 * tap_d)).all()
    assert (kept == 0).any() and (kept != 0).any()


def test_pretrain_model_builds_on_cpu_and_refuses_cuda_without_a_card():
    cfg = _port_cfg("IMAGE")
    model = build_pretrain_model(cfg, device="cpu")
    assert model.training and model.image_encoder.decoder.grid == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_pretrain_model(cfg)


def test_top_k_beyond_depth_is_refused_and_recorded():
    """With k > depth the JAX teacher sums the taps of every layer and
    divides by k: its training targets are depth / k times the stacked
    average of ``make_targets`` (here 2 / 4 with instance-norm target
    layers and no final norm). The port refuses k > depth and its
    ``make_targets`` averages the last k taps, as the stacked path does."""
    jcfg = _jax_cfg("IMAGE")
    jcfg.model.average_top_k_layers = 4
    jmodel = jax_build_pretrain_model(jcfg)
    imgs = jnp.asarray(np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32))
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "mask_noise": key}, imgs, "IMAGE")["params"]
    local = jmodel.apply({"params": params}, imgs, "IMAGE", True,
                         method=JaxData2VecMulti.local_features)
    _, t_acc, _, _ = jmodel.apply({"params": params}, local, "IMAGE", None, False, None, None,
                                  True, True, True, method=JaxData2VecMulti.encode)
    streamed = jax_finish_targets(t_acc / 4, jcfg.model)
    _, taps, _, _ = jmodel.apply({"params": params}, local, "IMAGE",
                                 method=JaxData2VecMulti.encode)
    stacked = jax_make_targets(taps, jcfg.model)
    np.testing.assert_allclose(np.asarray(streamed), 0.5 * np.asarray(stacked), atol=1e-6)
    with pytest.raises(ValueError, match="average_top_k_layers"):
        PretrainConfig.vit_b16(model=ImageConfig(**IMAGE), average_top_k_layers=4)
    ours = make_targets(list(torch.from_numpy(np.array(taps))), 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(stacked), rtol=0, atol=1e-5)
