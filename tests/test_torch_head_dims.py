"""Every head dim up to 128 that the JAX package's attention kernels run, in
the port, against the JAX package on the CPU.

JAX's Pallas kernels take any head dim D (their blocks carry D whole); the
port's kernels take D from 1 to 128 (``ops/attention.kernel_head_dim``: a
head of 64 columns or two, a D off a multiple of 8 on zero-padded copies).
On the CPU the port runs the kernels' plain versions; these tests hold them
against the JAX package at D 32, 80 (XLS-R 1B, ViT-H/14), 96, 120 (XLS-R
2B), 128 and 36 (off a multiple of 8), in fp32:

* #1's function (``alibi_flash_attention_packed`` at batch-uniform
  positions) against the JAX entry of the same name, its Pallas kernel
  ``_kernel_serve_nk1`` in interpret mode, within 1e-5 as
  ``tests/test_torch_attention.py``;
* #2 with its dropout, per-row positions and a padding mask, and #3 / #4
  (the training entry ``alibi_flash_attention_btc`` and its gradients)
  against the JAX entry's VJP (``_kernel``, ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel`` interpreted), within 1e-5 (the slope gradient within
  1e-5 of its largest component) as ``tests/test_torch_attention_train.py``;
* #5 with its quantization (``alibi_flash_attention_int8``) against JAX's
  ``alibi_flash_attention_int8`` (``_kernel_q8`` interpreted): the
  quantizers bit for bit, the output within one 1/127 step of P times the
  largest |v| and at most 5 % of rows beyond 1e-5, as
  ``tests/test_torch_int8_ops.py``;
* #11 / #11b (``bias_flash_attention`` and autograd through it) against
  ``xla_attention`` and ``jax.grad`` of it, dq, dk, dv and dbias within 1e-5;
* ring attention over two shards at D 32 against JAX's
  ``ring_attention_sharded`` within 2e-3, as
  ``tests/test_torch_ring_attention.py``;
* a tiny finetune model at D 80 (C 640, H 8, 1 prenet + 2 trunk blocks, the
  fused kernels' widths) against JAX's logits within 1e-4 and its gradients
  within 1e-5 of each tensor's largest value; a tiny pre-LN image model at D
  128 (C 256, H 2) against JAX's features within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from animal2vec_tpu.config import ImageModalityConfig, ModalitiesConfig, ModelConfig
from animal2vec_tpu.models.attention import xla_attention
from animal2vec_tpu.models.data2vec2 import Data2VecMulti as JaxData2VecMulti
from animal2vec_tpu.ops.pallas_attention import (
    alibi_flash_attention_btc as jax_btc,
    alibi_flash_attention_int8 as jax_attention_int8,
    alibi_flash_attention_packed as jax_packed,
)
from animal2vec_tpu.ops.ring_attention import ring_attention_sharded
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model

from animal2vec_tpu_torch.config import ImageConfig
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.ops.alibi import alibi_bias_2d, alibi_slopes
from animal2vec_tpu_torch.ops.attention import (
    alibi_flash_attention_btc, alibi_flash_attention_int8, alibi_flash_attention_packed,
    int8_row_len, int8_spans, quantize_qkv_int8, quantize_qkv_int8_pass, v8t_key_order,
)
from animal2vec_tpu_torch.ops.bias_attention import bias_flash_attention
from animal2vec_tpu_torch.ops.ring_attention import ring_attention_local
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import _finetune_cfg
from tests.test_torch_int8_ops import ROWS_OFF, _jax_qkv, _rows_off
from tests.test_torch_model import TINY_LAYERS, _jittered, _port_cfg
from tests.test_torch_widths import _close_grads, _image_features

TOL = 1e-5
MODEL_TOL = 1e-4  # logits and features, fp32 (PERF.md section 2)
RING_TOL = 2e-3
SEED = -123457  # a negative int32 dropout seed
HEAD_DIMS = (32, 80, 96, 120, 128, 36)


def _rnd(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_alibi_serving_forward_matches_jax_kernel(d):
    """#1 (batch-uniform positions: ``_kernel_serve_nk1``); #2's forward,
    ``_kernel``, runs in the training test below."""
    rng = np.random.default_rng(d)
    b, h, t = 1, 2, 96
    qkv = _rnd(rng, 3, b, h, t, d)
    slopes = (alibi_slopes(h) * 0.8).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)[None]
    ours = alibi_flash_attention_packed(torch.from_numpy(qkv), torch.from_numpy(slopes),
                                        torch.from_numpy(pos), None, False).numpy()
    ref = np.asarray(jax_packed(jnp.asarray(qkv), jnp.asarray(slopes), jnp.asarray(pos), None,
                                False, 0.0, None))
    assert ours.shape == (b, h, t, d)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_alibi_training_entry_and_gradients_match_jax(d):
    """#2 with dropout 0.2, per-row positions and padded keys (``_kernel``),
    then dq, dk, dv and the slope gradient (#3, #4) under one cotangent;
    the slope gradient, a sum over B H T^2 terms that cancel down to a
    fraction of their size, within 1e-5 of its largest component."""
    rng = np.random.default_rng(100 + d)
    b, h, t = 1, 2, 72
    qkv = _rnd(rng, b, t, 3 * h * d)
    g = _rnd(rng, b, t, h * d)
    slopes = (alibi_slopes(h) * 0.8).astype(np.float32)
    pos = np.sort(rng.choice(2 * t, t, replace=False)).astype(np.int32)[None]
    mask = np.zeros((b, t), bool)
    mask[0, -9:] = True
    q = torch.from_numpy(qkv).requires_grad_()
    s = torch.from_numpy(slopes).requires_grad_()
    out = alibi_flash_attention_btc(q, h, s, torch.from_numpy(pos), torch.from_numpy(mask),
                                    False, 0.2, SEED)
    dq, ds = torch.autograd.grad(out, (q, s), torch.from_numpy(g))
    out_j, vjp = jax.vjp(
        lambda x, sl: jax_btc(x, h, sl, jnp.asarray(pos), jnp.asarray(mask), False, 0.2,
                              jnp.asarray(SEED, jnp.int32)),
        jnp.asarray(qkv), jnp.asarray(slopes))
    dq_j, ds_j = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=0, atol=TOL)
    ds_j = np.asarray(ds_j)
    np.testing.assert_allclose(ds.numpy(), ds_j, rtol=0, atol=TOL * np.abs(ds_j).max())


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_int8_attention_matches_jax_kernel(d):
    """#5 and its quantization pass: q, k, v quantized bit for bit as JAX
    quantizes them (q scaled by D^-0.5 of the true D), the pass's layouts
    zero past D in rows of ``int8_row_len(D)``, the output as JAX's
    ``_kernel_q8`` within the quantization flips."""
    rng = np.random.default_rng(200 + d)
    b, t, h = 1, 200, 2
    q, k, v = (_rnd(rng, b, t, h, d) for _ in range(3))
    slopes = alibi_slopes(h).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for ours_x, ref_x in zip(quantize_qkv_int8(tq, tk, tv), _jax_qkv(q, k, v)):
        np.testing.assert_array_equal(ours_x.numpy(), np.asarray(ref_x))
    t_pad = int8_spans(t)[1]
    q8, _, k8, _, v8t, vsc = quantize_qkv_int8_pass(tq, tk, tv, t_pad)
    rows = int8_row_len(d)
    assert q8.shape == (b, h, t, rows) and v8t.shape == (b, h, rows, t_pad)
    assert vsc.shape == (b, h, d) and not q8[..., d:].any() and not v8t[:, :, d:].any()
    v8 = v8t[..., v8t_key_order(t_pad).argsort()]
    np.testing.assert_array_equal(v8[:, :, :d, :t].permute(0, 3, 1, 2).numpy(),
                                  quantize_qkv_int8(tq, tk, tv)[4].numpy())
    ours = alibi_flash_attention_int8(tq, tk, tv, torch.from_numpy(slopes),
                                      torch.from_numpy(pos), None, True, block_q=128).numpy()
    ref = np.asarray(jax_attention_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(slopes), jnp.asarray(pos), None, True,
                                        block_q=128))
    assert ours.shape == (b, t, h, d)
    share, worst = _rows_off(ours, ref)
    assert share <= ROWS_OFF and worst <= 4e-2, (share, worst)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bias_attention_and_gradients_match_xla_attention(d):
    """#11 with a batch-uniform 2-D ALiBi bias and padded keys, and #11b's
    function: dq, dk, dv and the bias gradient (the batch sum) against
    ``jax.grad`` of ``xla_attention``."""
    rng = np.random.default_rng(300 + d)
    b, t, h = 2, 49, 2
    q, k, v, dout = (_rnd(rng, b, t, h, d) for _ in range(4))
    bias = alibi_bias_2d(t, h)[None] * np.float32(0.7)
    mask = np.zeros((b, t), bool)
    mask[0, -5:] = True
    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias))
    out = bias_flash_attention(tq, tk, tv, tb, torch.from_numpy(mask))
    grads = torch.autograd.grad(out, (tq, tk, tv, tb), torch.from_numpy(dout))

    def f(q, k, v, bias):
        o = xla_attention(q, k, v, jnp.broadcast_to(bias, (b, h, t, t)), jnp.asarray(mask))
        return jnp.sum(o * jnp.asarray(dout)), o

    refs, out_j = jax.grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v, bias)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=TOL)
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL,
                                   err_msg=name)


def test_ring_attention_at_d32_matches_jax():
    """#2 with key positions under ring attention: two shards in process
    against JAX's ring on a two-device mesh, the last keys padded."""
    rng = np.random.default_rng(31)
    b, t, h, d = 1, 256, 2, 32
    q, k, v = (_rnd(rng, b, t, h, d) for _ in range(3))
    slopes = np.asarray([0.5, 0.125], np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    pad = np.broadcast_to(np.arange(t) >= 200, (b, t)).copy()
    ours = ring_attention_local(*map(torch.from_numpy, (q, k, v, slopes, pos, pad)), 2).numpy()
    ring_mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    ref = np.asarray(ring_attention_sharded(*map(jnp.asarray, (q, k, v, slopes, pos, pad)),
                                            ring_mesh, "data"))
    live = ~pad[0]
    np.testing.assert_allclose(ours[:, live], ref[:, live], rtol=0, atol=RING_TOL)


XLS_R_1B_TINY = dict(embed_dim=640, num_heads=8, depth=2, prenet_depth=1, conv_pos_depth=2,
                     conv_pos_width=10, conv_pos_groups=2)  # D 80, the fused kernels' widths


def test_finetune_model_at_d80_matches_jax():
    """The post-LN ALiBi finetune model with 80-wide heads: logits within
    1e-4 and the gradient of <logits, g> for every parameter of the
    transformer blocks (the attention's and the fused blocks') within 1e-5
    of each tensor's largest value."""
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=2,
                         **XLS_R_1B_TINY)
    jmodel = jax_build_finetune_model(jcfg)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, 800)))["params"]
    params = _jittered(params, seed=1)
    model = FinetuneModel(_port_cfg(jcfg, TINY_LAYERS, **XLS_R_1B_TINY))
    model.load_state_dict(params_from_jax(params), strict=True)
    model.eval()
    rng = np.random.default_rng(80)
    src = _rnd(rng, 2, 800)
    out = model(torch.from_numpy(src))["encoder_out"]
    g = _rnd(rng, *out.shape)

    def f(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(src))["encoder_out"]
        return jnp.sum(logits * jnp.asarray(g)), logits

    jgrads, ref = jax.jit(jax.grad(f, has_aux=True))(params)
    assert model.cfg.embed_dim // model.cfg.num_heads == 80
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=MODEL_TOL)
    (out * torch.from_numpy(g)).sum().backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    named = {n: p for n, p in model.named_parameters() if ".blocks." in n}
    assert len(named) > 20 and set(named) <= set(want)
    unused = sorted(n for n in named if named[n].grad is None)
    assert all(not want[n].any() for n in unused), unused  # no gradient on either side
    names = sorted(set(named) - set(unused))
    _close_grads([named[n].grad for n in names], [want[n].numpy() for n in names], names)
    assert all(named[n].grad.abs().sum() > 0 for n in names if "qkv" in n)


IMAGE_D128 = dict(input_size=32, patch_size=8, embed_dim=256, num_heads=2, mlp_ratio=4.0,
                  prenet_depth=1, depth=1, use_alibi_encoder=True,
                  learned_alibi_scale_per_head=True, layer_norm_first=True)


def _image_models():
    """The pre-LN image model with heads of 128, JAX's and the port's, from
    the same jittered weights."""
    cfg = ImageConfig(**IMAGE_D128)
    image = ImageModalityConfig(
        prenet_depth=cfg.prenet_depth, input_size=cfg.input_size, patch_size=cfg.patch_size,
        in_chans=cfg.in_chans, embed_dim=cfg.patch_embed_dim,
        use_alibi_encoder=cfg.use_alibi_encoder,
        learned_alibi_scale_per_head=cfg.learned_alibi_scale_per_head,
        alibi_distance=cfg.alibi_distance, num_alibi_heads=cfg.num_heads,
        model_depth=cfg.depth, decoder=None)
    jmodel = JaxData2VecMulti(cfg=ModelConfig(
        depth=cfg.depth, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads,
        mlp_ratio=cfg.mlp_ratio, layer_norm_first=cfg.layer_norm_first,
        supported_modality="IMAGE", encoder_dropout=0.0, attention_dropout=0.0,
        post_mlp_drop=0.0, remat=False, modalities=ModalitiesConfig(image=image)))
    init = jax.jit(lambda key, x: jmodel.init({"params": key}, x, "IMAGE",
                                              method=JaxData2VecMulti.extract_features))
    params = _jittered(init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"], seed=1)
    model = Data2VecMulti(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, jmodel, params, model.eval()


def test_image_model_at_d128_matches_jax():
    """The pre-LN image model with its 2-D ALiBi bias at C 256 and two
    heads of 128: features within 1e-4."""
    cfg, jmodel, params, model = _image_models()
    imgs = _rnd(np.random.default_rng(128), 2, 32, 32, 3)
    ours, jax_run = _image_features(jmodel, params, model, imgs)
    ref = jax_run(imgs)
    assert cfg.embed_dim // cfg.num_heads == 128 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=MODEL_TOL)
