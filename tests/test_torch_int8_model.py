"""The int8 serving modes of the whole model (``matmul_impl`` "int8" and
"int8_attn") against the JAX package's.

A tiny lane-aligned model (embed 128, 2 heads of 64, MLP 512, prenet 1 +
trunk 2 blocks), whose widths take the JAX package's Pallas route (run in
interpret mode, ``A2V_PALLAS_SERVE=1``, ``A2V_FLASH_INTERPRET=1``) as the
port's ops do. The sequence lengths (200 frames, and 2000 in 10-s windows)
are ones the JAX trunk pads to its attention block (256 and 2048), so that
in ``int8_attn`` the pad rows enter the per-channel v scales on both sides.
Besides the default encoder, pre-LN ones (their MLPs through the int8
fused MLP) and an ALiBi-free one (the int8 projections around the bf16
attention, whose trunk neither side pads) are served (``ENCODERS``).

Tolerances. The int8 roundings are the same on both sides, but a value
within ~1e-7 of an int8 rounding boundary (A&S erf against erf in GELU,
XLA's exp against torch's, fp32 sums in another order) lands one step
apart, which moves its row by a step of the next product
(``tests/test_torch_int8_ops.py``). In a model that difference compounds:
the moved row changes the int8 roundings of later layers, and attention
spreads it to every row. So each block is held on its own inputs at the op
tolerances, and the whole model at the size of the JAX model's own
response to a one-ulp change of its input; each bound is stated at its
test.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as tu

from animal2vec_tpu.config import resolve
from animal2vec_tpu.models.attention import AlibiSpec as JaxAlibiSpec
from animal2vec_tpu.models.modules import AltBlock as JaxAltBlock, BlockConfig
from animal2vec_tpu.ops.audio import chunk_and_normalize as jax_chunk
from animal2vec_tpu.tools.infer_cli import infer_long_file as jax_infer_long_file
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.data.wavio import read_wav
from animal2vec_tpu_torch.models.finetune import FinetuneModel, build_finetune_model
from animal2vec_tpu_torch.models.modules import AltBlock
from animal2vec_tpu_torch.tools import infer_cli
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import _finetune_cfg
from tests.test_torch_int8_ops import ROWS_OFF, _rows_off
from tests.test_torch_model import SERVING_LAYERS, TINY_LAYERS, _jittered, _port_cfg, _synthetic_wav

DIMS = dict(embed_dim=128, num_heads=2, depth=2, prenet_depth=1, conv_pos_depth=2,
            conv_pos_width=10, conv_pos_groups=2)
MODES = ("int8", "int8_attn")
PROB_TOL, PROB_MEDIAN = 2e-2, 5e-3  # measured 1.4e-2 and 2.0e-3 (int8_attn)
EVENT_FRAMES = 2e-2
STEP = 2e-2  # one flipped value moves a block's row by at most this share of its range
SEGMENT = 10.0  # 2000 frames through the stride-40 stack, padded to 2048 by JAX
# the encoders served in int8: (audio modality changes, model changes), JAX
# names = the port's fields. Pre-LN blocks (the int8 fused MLP, the residual
# the reference drops), with affine norms, or without them and with one
# ALiBi scale shared by the heads; post-LN without ALiBi (the int8
# projections around the bf16 attention, no trunk padding).
ENCODERS = {
    "default": ({}, {}),
    "pre-LN": ({}, dict(layer_norm_first=True)),
    "pre-LN-no-affine": (dict(learned_alibi_scale_per_head=False),
                         dict(layer_norm_first=True, norm_affine=False)),
    "no-ALiBi": (dict(use_alibi_encoder=False), {}),
}
# (mode, encoder) cases: the default encoder's keep the mode as their id;
# each pre-LN encoder in one mode (int8_attn without affine norms and with
# the shared ALiBi scale), the ALiBi-free one in both
CASES = [pytest.param(m, "default", id=m) for m in MODES] + [
    pytest.param(m, e, id=f"{m}-{e}") for m, e in (
        ("int8", "pre-LN"), ("int8_attn", "pre-LN-no-affine"), ("int8", "no-ALiBi"),
        ("int8_attn", "no-ALiBi"))]


@pytest.fixture(autouse=True)
def pallas_route(monkeypatch):
    monkeypatch.setenv("A2V_PALLAS_SERVE", "1")
    monkeypatch.setenv("A2V_FLASH_INTERPRET", "1")


def _jax_cfg(conv_layers, mode, encoder):
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in conv_layers), avg_k=2,
                         **DIMS)
    jcfg.model.matmul_impl = mode
    audio, blocks = ENCODERS[encoder]
    for key, value in audio.items():
        setattr(jcfg.model.modalities.audio, key, value)
    for key, value in blocks.items():
        setattr(jcfg.model, key, value)
    return resolve(jcfg)


@functools.lru_cache(maxsize=None)
def _jax_params(conv_layers, wav_len, encoder):
    """The JAX model's jittered init, which the modes share (their param
    trees and init draws are the same)."""
    jmodel = jax_build_finetune_model(_jax_cfg(conv_layers, "bf16", encoder))
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.zeros((1, wav_len)))["params"]
    return _jittered(params, seed=11)


def _models(conv_layers, wav_len, mode, encoder="default"):
    jcfg = _jax_cfg(conv_layers, mode, encoder)
    jmodel = jax_build_finetune_model(jcfg)
    params = _jax_params(tuple(conv_layers), wav_len, encoder)
    audio, blocks = ENCODERS[encoder]
    cfg = dataclasses.replace(_port_cfg(jcfg, conv_layers, **DIMS), matmul_impl=mode, **audio,
                              **blocks)
    model = FinetuneModel(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, jmodel, params, model.eval()


def _jax_block_params(params, port_name):
    """The JAX params of the port's block ``<stack>.layers.<i>``: layer i
    of the scan-stacked ``<stack>/block`` tree."""
    prefix, i = port_name.rsplit(".layers.", 1)
    node = params
    for key in prefix.split(".") + ["block"]:
        node = node[key]
    return jax.tree_util.tree_map(lambda a: a[int(i)], node)


def _own_rows_off(run, p, x, pad, spec, ref_tap, draws=6):
    """The largest share of rows beyond 1e-5 by which the JAX block's tap
    moves under one-ulp changes of its input x: all up, all down, and
    seeded mixes of the two."""
    rng = np.random.default_rng(0)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    worst = 0.0
    for k in range(draws):
        to = (up, down)[k] if k < 2 else np.where(rng.random(x.shape) < 0.5, up, down)
        moved = run(p, jnp.asarray(np.nextafter(x, to)), pad, spec)[1]
        worst = max(worst, _rows_off(moved, ref_tap)[0])
    return worst


@pytest.mark.parametrize("mode,encoder", CASES)
def test_logits_match_jax(mode, encoder):
    """Each of the three blocks on the inputs the port gave it, against the
    JAX AltBlock on the same inputs (the op tolerances: rows beyond 1e-5 at
    most 5 %, the largest error one quantization step); then the logits end
    to end, whose relative norm error may be at most 3x the JAX model's own
    response to a one-ulp change of its input: int8 amplifies every rounding
    difference, one flipped value moving its row by a step that attention
    spreads to every row, so the JAX model against itself moves its logits
    by 6e-3 (int8) and 1.8e-2 (int8_attn) relative norm; and their
    probabilities within PROB_TOL (median PROB_MEDIAN) of JAX's. Each
    encoder of ENCODERS: the trunk runs padded to 256 rows only in int8_attn
    with ALiBi, as JAX pads it."""
    jcfg, jmodel, params, model = _models(TINY_LAYERS, 800, mode, encoder)
    blocks = ENCODERS[encoder][1]
    alibi = ENCODERS[encoder][0].get("use_alibi_encoder", True)
    src = np.random.default_rng(12).normal(size=(2, 800)).astype(np.float32)
    seen = []
    hooks = [mod.register_forward_hook(lambda m, args, out, name=name: seen.append(
        (name, *args[:3], out))) for name, mod in model.named_modules()
        if isinstance(mod, AltBlock)]
    with torch.no_grad():
        logits = model(torch.from_numpy(src))["encoder_out"].numpy()
    for h in hooks:
        h.remove()
    assert [s[0] for s in seen] == ["encoder.audio_encoder.context_encoder.blocks.layers.0",
                                    "encoder.blocks.layers.0", "encoder.blocks.layers.1"]
    blk = JaxAltBlock(cfg=BlockConfig(dim=128, num_heads=2, norm_eps=1e-5, matmul_impl=mode,
                                      **blocks))
    # int8_attn with ALiBi runs the trunk padded to 256 rows as JAX does
    # (for its AlibiSpec); int8, and int8_attn without ALiBi, do not
    assert {x.shape[1] for _, x, *_ in seen} == {256 if mode == "int8_attn" and alibi else 200}
    run = jax.jit(lambda p, v, m, spec: blk.apply({"params": p}, v, m, spec))
    for name, x, pad, bias, (xo, tap) in seen:
        assert (bias is None) == (not alibi)
        spec = None if bias is None else JaxAlibiSpec(jnp.asarray(bias.slopes.numpy()),
                                                      jnp.asarray(bias.positions.numpy()))
        pad = None if pad is None else jnp.asarray(pad.numpy())
        p = _jax_block_params(params, name)
        refs, outs = run(p, jnp.asarray(x.numpy()), pad, spec), (xo, tap)
        rows_off = ROWS_OFF
        if blocks.get("layer_norm_first"):
            # a pre-LN block gives x = t + t (the residual dropped, dropout
            # off), on both sides; and int8_attn spreads one value that
            # lands an int8 step apart over the rows of its key: the JAX
            # block itself moves up to 8.6 % of its tap's rows beyond 1e-5
            # under one-ulp changes of its input (the port 8.2 % against it).
            # So only t is held, its share of rows off at most 1.5x the
            # largest of that response (six draws) where it exceeds ROWS_OFF
            assert torch.equal(xo, tap + tap) and np.array_equal(refs[0], refs[1] + refs[1])
            refs, outs = refs[1:], (tap,)
            rows_off = max(ROWS_OFF, 1.5 * _own_rows_off(run, p, x.numpy(), pad, spec, refs[0]))
        for ours, ref in zip(outs, refs):
            share, worst = _rows_off(ours.numpy(), ref)
            assert share <= rows_off and worst <= STEP * np.abs(ref).max(), (name, share, worst)

    apply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x)["encoder_out"])
    ref = np.asarray(apply(params, jnp.asarray(src)))
    ref_ulp = np.asarray(apply(params, jnp.asarray(np.nextafter(src, np.float32(np.inf)))))
    assert logits.shape == ref.shape == (2, 200, 4)
    rel = lambda a: np.linalg.norm(a - ref) / np.linalg.norm(ref)
    assert rel(logits) <= 3 * rel(ref_ulp), (rel(logits), rel(ref_ulp))
    err = np.abs(1 / (1 + np.exp(-logits)) - 1 / (1 + np.exp(-ref)))
    assert err.max() <= PROB_TOL and np.median(err) <= PROB_MEDIAN, (err.max(), np.median(err))
    # the int8 numerics are in force: the bf16 model's logits lie further off
    bf16 = FinetuneModel(dataclasses.replace(model.cfg, matmul_impl="bf16")).eval()
    bf16.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        assert rel(bf16(torch.from_numpy(src))["encoder_out"].numpy()) > rel(logits)


def _event_frames(events, labels, n=6200, step=0.005):
    """(class, 5-ms frame) occupancy of an event dict."""
    occ = np.zeros((len(labels), n), bool)
    for ci, name in enumerate(labels):
        for e in events[name]:
            occ[ci, int(round(e["onset_s"] / step)):int(round(e["offset_s"] / step)) + 1] = True
    return occ


@pytest.mark.parametrize("mode,encoder", [
    pytest.param(m, "default", id=m) for m in MODES] + [
    pytest.param("int8_attn", "pre-LN-no-affine", id="int8_attn-pre-LN-no-affine")])
def test_infer_long_file_matches_jax(tmp_path, mode, encoder):
    """Window probabilities within PROB_TOL of JAX's (median within
    PROB_MEDIAN), and the events of ``infer_long_file`` on the same frames:
    for the avg and canny methods the (class, 5-ms frame) cells that lie
    in an event on one side and not on the other at most EVENT_FRAMES of
    all. Identical events are not a fair demand of int8: the JAX CLI
    itself, given the same recording with a few PCM16 samples moved by one
    step, changes 1.0 % of the cells (canny, int8_attn) and adds or drops
    events where a probability sits at the threshold; the port against JAX
    changed 1.1 % at most."""
    jcfg, jmodel, params, model = _models(SERVING_LAYERS, 8000, mode, encoder)
    wav_path = tmp_path / "rec.wav"
    _synthetic_wav(wav_path, 25)
    wav, _ = read_wav(str(wav_path))
    (batch,) = jax_chunk(wav, SEGMENT, 8000, True, 16)
    apply = jax.jit(lambda p, x: jax.nn.sigmoid(jmodel.apply({"params": p}, x)["encoder_out"]))
    probs_j = np.asarray(apply(params, jnp.asarray(batch)))
    probs = infer_cli.window_probabilities(model, batch, torch.device("cpu"))
    assert probs.shape == probs_j.shape == (3, 2000, 4)
    err = np.abs(probs - probs_j)
    prob_tol = PROB_TOL
    if ENCODERS[encoder][1].get("layer_norm_first"):
        # the pre-LN blocks pass int8 flips on undamped: the JAX model moves
        # its own probabilities by up to 2.2e-2 under a one-ulp change of its
        # input (the port lies 2.05e-2 from it), so the bound is the larger
        # of PROB_TOL and that response
        moved = np.asarray(apply(params, jnp.asarray(np.nextafter(batch, np.float32(np.inf)))))
        prob_tol = max(PROB_TOL, float(np.abs(moved - probs_j).max()))
    assert err.max() <= prob_tol and np.median(err) <= PROB_MEDIAN, (err.max(), np.median(err))
    for method in ("avg", "canny"):
        ours = infer_cli.infer_long_file(str(wav_path), model, model.cfg, method=method,
                                         segment_length=SEGMENT)
        ref = jax_infer_long_file(str(wav_path), jmodel, {"params": params}, jcfg, method=method,
                                  segment_length=SEGMENT, data_parallel=1)
        assert ours.keys() == ref.keys()
        n_ours, n_ref = (sum(len(v) for v in e.values()) for e in (ours, ref))
        assert n_ref > 3 and abs(n_ours - n_ref) <= 0.1 * n_ref, (method, n_ours, n_ref)
        labels = model.cfg.labels
        off = (_event_frames(ours, labels) != _event_frames(ref, labels)).mean()
        assert off <= EVENT_FRAMES, (method, off)


def test_int8_attn_block_without_alibi_takes_the_padding_mask():
    """One int8_attn block of an ALiBi-free encoder on a batch whose second
    row has 56 padded frames, against the JAX block on the same weights and
    mask, at the op tolerances: the mask reaches the bf16 dense-bias
    attention behind the int8 projections (#10 -> #11)."""
    b, t, c, h = 2, 200, 128, 2
    rng = np.random.default_rng(30)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    pad = np.zeros((b, t), bool)
    pad[1, -56:] = True
    blk = JaxAltBlock(cfg=BlockConfig(dim=c, num_heads=h, norm_eps=1e-5, matmul_impl="int8_attn"))
    params = blk.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), jnp.asarray(pad), None)
    params = _jittered(params, seed=31)
    refs = blk.apply(params, jnp.asarray(x), jnp.asarray(pad), None)
    ours = AltBlock(c, h, eps=1e-5, matmul_impl="int8_attn")
    ours.load_state_dict(params_from_jax(params["params"]), strict=True)
    ours.quantize_weights()
    with torch.no_grad():
        outs = ours.eval()(torch.from_numpy(x), torch.from_numpy(pad), None)
    for got, ref in zip(outs, refs):
        share, worst = _rows_off(got.numpy(), ref)
        assert share <= ROWS_OFF and worst <= STEP * np.abs(ref).max(), (share, worst)
    # the mask is in force: without it the real rows of the padded sample move
    with torch.no_grad():
        free = ours(torch.from_numpy(x), None, None)[1].numpy()
    assert np.abs(free[1, :t - 56] - outs[1][1, :t - 56].numpy()).max() > 1e-3


def test_state_dict_is_the_bf16_one():
    """One set of weights serves the three modes: the int8 buffers are
    quantized at load and are not in the state dict."""
    cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS, average_top_k_layers=2,
                              **DIMS)
    models = {m: build_finetune_model(dataclasses.replace(cfg, matmul_impl=m), seed=3,
                                      device="cpu") for m in ("bf16",) + MODES}
    sds = {m: mod.state_dict() for m, mod in models.items()}
    for m in MODES:
        assert sds[m].keys() == sds["bf16"].keys()
        assert all(torch.equal(sds[m][k], sds["bf16"][k]) for k in sds[m])
    # loading the bf16 weights into an int8 model re-quantizes them
    fresh = FinetuneModel(dataclasses.replace(cfg, matmul_impl="int8_attn"))
    fresh.load_state_dict(sds["bf16"], strict=True)
    blocks = [mod for mod in fresh.modules() if isinstance(mod, AltBlock)]
    assert len(blocks) == 3
    ref = [mod for mod in models["int8_attn"].modules() if isinstance(mod, AltBlock)]
    for a, b in zip(blocks, ref):
        for name in ("w1_q", "w1_s", "w2_q", "w2_s"):
            assert torch.equal(getattr(a, name), getattr(b, name))
        for name in ("qkv_q", "qkv_s", "proj_q", "proj_s"):
            assert torch.equal(getattr(a.attn, name), getattr(b.attn, name))
    assert all(mod.w1_q is None for mod in models["bf16"].modules() if isinstance(mod, AltBlock))
    assert all(mod.attn.qkv_q is None for mod in models["int8"].modules()
               if isinstance(mod, AltBlock))


@pytest.mark.parametrize("mode", MODES)
def test_train_mode_raises(mode):
    cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS, average_top_k_layers=2,
                              matmul_impl=mode, **DIMS)
    model = build_finetune_model(cfg, device="cpu").train()
    with pytest.raises(RuntimeError, match="serving-only"):
        model(torch.zeros((1, 1024)))


def test_unknown_or_unaligned_matmul_impl_raises():
    """An unknown mode raises; the int8 modes are taken at every width, as
    JAX serves them there through its XLA route
    (``tests/test_torch_widths.py`` holds that route against JAX's)."""
    base = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS, average_top_k_layers=2,
                               **DIMS)
    with pytest.raises(ValueError, match="matmul_impl"):
        dataclasses.replace(base, matmul_impl="fp8")
    assert dataclasses.replace(base, matmul_impl="int8", embed_dim=96,
                               num_heads=2).embed_dim == 96
    assert dataclasses.replace(base, matmul_impl="int8_attn", mlp_ratio=2.5).mlp_ratio == 2.5
    with pytest.raises(ValueError, match="matmul_impl"):
        AltBlock(128, 2, matmul_impl="int4")
    dataclasses.replace(base, matmul_impl="bf16", embed_dim=96, num_heads=2)


def test_cli_main_serves_int8(tmp_path):
    """``main()`` with the override ``matmul_impl=int8_attn``: load_finetuned
    quantizes, and the events are those of the model loaded by hand."""
    jcfg, jmodel, params, model = _models(SERVING_LAYERS, 8000, "int8_attn")
    flat = {"/".join(k): np.asarray(v) for k, v in tu.flatten_dict(params).items()}
    np.savez(tmp_path / "params.npz", **flat)
    _synthetic_wav(tmp_path / "rec.wav", 6)
    overrides = [f"{k}={v}" for k, v in DIMS.items()] + [
        f"conv_layers={SERVING_LAYERS}", "average_top_k_layers=2", "matmul_impl=int8_attn",
        "labels=('a','b','c','focal')", "max_sample_size=80000",
    ]
    cfg = infer_cli.parse_overrides(FinetuneConfig(), overrides)
    loaded = infer_cli.load_finetuned(str(tmp_path / "params.npz"), cfg, torch.device("cpu"))
    assert all(mod.attn.qkv_q is not None and mod.w1_q is not None
               for mod in loaded.modules() if isinstance(mod, AltBlock))
    out = tmp_path / "events.json"
    infer_cli.main(["--wav", str(tmp_path / "rec.wav"), "--weights", str(tmp_path / "params.npz"),
                    "--device", "cpu", "--out", str(out), *overrides])
    events = json.loads(out.read_text())
    assert events == infer_cli.infer_long_file(str(tmp_path / "rec.wav"), loaded, cfg)
