"""The image modality's serving path in the port against the JAX package's
``Data2VecMulti.extract_features(imgs, "IMAGE")``.

A tiny lane-aligned ViT (32 x 32 images in 8 x 8 patches: 16 patches, model
width 128 with 2 heads of 64, MLP 256, 1 prenet + 2 trunk blocks, the 2-D
ALiBi bias with one learned scale per head, one of them negative so that
the clip at 0 counts), whose widths take the JAX package's Pallas routes
for the MLP (``A2V_PALLAS_SERVE=1``, interpret mode); the dense-bias
attention is ``xla_attention`` on the JAX side. Params cross over through
``params_from_jax`` with ``strict=True``.

Tolerances: in bf16 numerics run in fp32, x and every tap within 1e-4
max-abs (the same math in another order through 3 blocks). int8 as
``tests/test_torch_int8_model.py`` holds a model: each block on its own
inputs at the op tolerances (at most 5 % of rows beyond 1e-5, the largest
error one quantization step), and the whole model within 3x the JAX
model's own response to a one-ulp change of its input (a value at an int8
rounding boundary lands one step apart and attention spreads the moved row).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.config import ImageModalityConfig, ModalitiesConfig, ModelConfig
from animal2vec_tpu.models.data2vec2 import Data2VecMulti as JaxData2VecMulti
from animal2vec_tpu.models.modules import AltBlock as JaxAltBlock, BlockConfig

from animal2vec_tpu_torch.config import ImageConfig
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.finetune import build_image_model
from animal2vec_tpu_torch.models.modules import AltBlock
from animal2vec_tpu_torch.weights import params_from_jax, serving_cast

from tests.test_torch_int8_model import STEP, _jax_block_params
from tests.test_torch_int8_ops import ROWS_OFF, _rows_off

TOL = 1e-4
DIMS = dict(input_size=32, patch_size=8, embed_dim=128, num_heads=2, mlp_ratio=2.0,
            prenet_depth=1, depth=2, use_alibi_encoder=True, learned_alibi_scale_per_head=True)


@pytest.fixture(autouse=True)
def pallas_route(monkeypatch):
    monkeypatch.setenv("A2V_PALLAS_SERVE", "1")


def _models(seed=0, **kw):
    """The JAX model with jittered params (one ALiBi scale negative) and the
    port's model loaded from them."""
    cfg = ImageConfig(**DIMS, **kw)
    image = ImageModalityConfig(
        prenet_depth=cfg.prenet_depth, input_size=cfg.input_size, patch_size=cfg.patch_size,
        in_chans=cfg.in_chans, embed_dim=cfg.patch_embed_dim,
        use_alibi_encoder=cfg.use_alibi_encoder,
        learned_alibi_scale_per_head=cfg.learned_alibi_scale_per_head,
        alibi_distance=cfg.alibi_distance, num_alibi_heads=cfg.num_heads,
        model_depth=cfg.depth, decoder=None,
    )
    jcfg = ModelConfig(
        depth=cfg.depth, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads,
        mlp_ratio=cfg.mlp_ratio, layer_norm_first=cfg.layer_norm_first,
        end_of_block_targets=cfg.end_of_block_targets, matmul_impl=cfg.matmul_impl,
        supported_modality="IMAGE", encoder_dropout=0.0, attention_dropout=0.0,
        post_mlp_drop=0.0, remat=False, modalities=ModalitiesConfig(image=image),
    )
    jmodel = JaxData2VecMulti(cfg=jcfg)
    imgs = jnp.zeros((1, cfg.input_size, cfg.input_size, 3))
    params = jmodel.init({"params": jax.random.PRNGKey(seed)}, imgs, "IMAGE",
                         method=JaxData2VecMulti.extract_features)["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.05, params)
    scale = params["image_encoder"]["alibi_scale"]
    scale[..., 0, :, :] = -0.3
    model = Data2VecMulti(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, jmodel, params, model.eval()


def _images(cfg, n=2, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.input_size, cfg.input_size, cfg.in_chans)).astype(np.float32)


def _jax_features(jmodel, params, imgs):
    apply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, "IMAGE",
                                              method=JaxData2VecMulti.extract_features))
    out = apply(params, jnp.asarray(imgs))
    return np.asarray(out["x"]), np.asarray(out["layer_results"])


@pytest.mark.parametrize("kw", [
    dict(layer_norm_first=False, patch_embed_dim=96),
    dict(layer_norm_first=True),
    dict(layer_norm_first=True, end_of_block_targets=True, alibi_distance="euclidean"),
], ids=["post-ln-patch-proj", "pre-ln", "pre-ln-block-taps-euclidean"])
def test_features_match_jax_bf16_numerics(kw):
    cfg, jmodel, params, model = _models(**kw)
    imgs = _images(cfg)
    with torch.no_grad():
        out = model.extract_features(torch.from_numpy(imgs), "IMAGE")
    x_j, taps_j = _jax_features(jmodel, params, imgs)
    assert out["x"].shape == x_j.shape == (2, 16, 128) and out["padding_mask"] is None
    assert len(out["layer_results"]) == taps_j.shape[0] == 2
    np.testing.assert_allclose(out["x"].numpy(), x_j, rtol=0, atol=TOL)
    for tap, tap_j in zip(out["layer_results"], taps_j):
        np.testing.assert_allclose(tap.numpy(), tap_j, rtol=0, atol=TOL)


def test_pre_ln_block_drops_its_residual():
    """The pre-LN block gives 2 * mlp(norm2(y)) with y = x + attn(norm1(x)),
    and taps mlp(norm2(y)): the reference's ``r = t = mlp(...); x = r + t``."""
    torch.manual_seed(0)
    blk = AltBlock(128, 2, mlp_ratio=2.0, eps=1e-6, layer_norm_first=True).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn_like(p) * 0.1)
        x = torch.randn(2, 16, 128)
        bias = torch.randn(1, 2, 16, 16)
        out, tap = blk(x, None, bias)
        y = x + blk.attn(blk.norm1(x), None, bias)
        mlp = blk.mlp(blk.norm2(y))
    torch.testing.assert_close(tap, mlp, rtol=0, atol=0)
    torch.testing.assert_close(out, 2 * mlp, rtol=0, atol=0)


@pytest.mark.parametrize("mode,pre_ln", [("int8", True), ("int8_attn", False)])
def test_int8_features_match_jax(mode, pre_ln):
    """Each block on the inputs the port gave it against the JAX AltBlock on
    the same inputs (op tolerances), then x end to end within 3x the JAX
    model's response to a one-ulp change of its images."""
    cfg, jmodel, params, model = _models(seed=2, layer_norm_first=pre_ln, matmul_impl=mode)
    imgs = _images(cfg, seed=6)
    seen = []
    hooks = [mod.register_forward_hook(lambda m, args, out, name=name: seen.append(
        (name, args[0], args[2], out))) for name, mod in model.named_modules()
        if isinstance(mod, AltBlock)]
    with torch.no_grad():
        x = model.extract_features(torch.from_numpy(imgs), "IMAGE")["x"].numpy()
    for h in hooks:
        h.remove()
    assert [s[0] for s in seen] == ["image_encoder.context_encoder.blocks.layers.0",
                                    "blocks.layers.0", "blocks.layers.1"]
    blk = JaxAltBlock(cfg=BlockConfig(dim=128, num_heads=2, mlp_ratio=2.0, norm_eps=1e-6,
                                      layer_norm_first=pre_ln, matmul_impl=mode))
    apply_blk = jax.jit(lambda p, v, b: blk.apply({"params": p}, v, None, b))
    for name, xin, bias, (xo, tap) in seen:
        b = jnp.broadcast_to(jnp.asarray(bias.numpy()), (xin.shape[0],) + tuple(bias.shape[1:]))
        xo_j, tap_j = apply_blk(_jax_block_params(params, name), jnp.asarray(xin.numpy()), b)
        for ours, ref in ((tap, tap_j), (xo, xo_j)):
            share, worst = _rows_off(ours.numpy(), ref)
            assert share <= ROWS_OFF and worst <= STEP * np.abs(ref).max(), (name, share, worst)

    ref, _ = _jax_features(jmodel, params, imgs)
    ref_ulp, _ = _jax_features(jmodel, params, np.nextafter(imgs, np.float32(np.inf)))
    rel = lambda a: np.linalg.norm(a - ref) / np.linalg.norm(ref)
    assert rel(x) <= 3 * rel(ref_ulp), (rel(x), rel(ref_ulp))
    # the int8 numerics are in force: the bf16 model lies further off
    bf16 = Data2VecMulti(dataclasses.replace(cfg, matmul_impl="bf16")).eval()
    bf16.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        assert rel(bf16.extract_features(torch.from_numpy(imgs), "IMAGE")["x"].numpy()) > rel(x)


def test_weights_round_trip_from_jax_init():
    """A JAX-initialized tiny image model (unjittered, as ``init`` leaves it)
    loads with ``strict=True`` (the 4-D patch kernel transposed HWIO ->
    OIHW) and gives JAX's features; ``serving_cast`` keeps the ALiBi scale
    in fp32."""
    cfg, jmodel, _, _ = _models(layer_norm_first=True, patch_embed_dim=64)
    params = jmodel.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 32, 32, 3)), "IMAGE",
                         method=JaxData2VecMulti.extract_features)["params"]
    sd = params_from_jax(params)
    assert sd["image_encoder.patch_embed.weight"].shape == (64, 3, 8, 8)
    np.testing.assert_array_equal(sd["image_encoder.patch_embed.weight"].numpy(),
                                  np.transpose(params["image_encoder"]["patch_embed"]["kernel"],
                                               (3, 2, 0, 1)))
    model = Data2VecMulti(cfg).eval()
    model.load_state_dict(sd, strict=True)
    imgs = _images(cfg, seed=7)
    with torch.no_grad():
        x = model.extract_features(torch.from_numpy(imgs), "IMAGE")["x"].numpy()
    np.testing.assert_allclose(x, _jax_features(jmodel, params, imgs)[0], rtol=0, atol=TOL)
    cast = serving_cast(sd)
    assert cast["image_encoder.alibi_scale"].dtype == torch.float32
    assert cast["image_encoder.patch_embed.weight"].dtype == torch.bfloat16


def test_build_image_model_and_serving_only():
    cfg = ImageConfig(**DIMS, matmul_impl="int8")
    model = build_image_model(cfg, seed=4, device="cpu")
    assert not model.training and model.mode == "IMAGE"
    assert all(m.w1_q is not None for m in model.modules() if isinstance(m, AltBlock))
    again = build_image_model(cfg, seed=4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    imgs = torch.from_numpy(_images(cfg, n=1))
    with pytest.raises(ValueError, match="IMAGE"):
        model.extract_features(imgs)  # the JAX method's default mode, AUDIO
    with pytest.raises(NotImplementedError, match="serving"):
        model.train().extract_features(imgs, "IMAGE")
    # the int8 blocks are serving-only; a bf16 block with a dense bias or
    # none trains (pretraining, tests/test_torch_pretrain_*.py)
    for pre_ln in (False, True):
        blk = AltBlock(128, 2, mlp_ratio=2.0, layer_norm_first=pre_ln, matmul_impl="int8")
        blk.quantize_weights()
        with pytest.raises(RuntimeError, match="serving-only"):
            blk.train()(torch.zeros(1, 16, 128), None, None)
        x = torch.zeros(1, 16, 128, requires_grad=True)
        out, _ = AltBlock(128, 2, mlp_ratio=2.0, layer_norm_first=pre_ln).train()(x, None, None)
        out.sum().backward()
        assert x.grad is not None
