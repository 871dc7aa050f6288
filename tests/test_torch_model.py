"""The whole inference slice of the port against the JAX package.

The JAX ``FinetuneModel`` runs in fp32 on the tiny config of
``tests/test_parity.py`` at embed 128 (4 heads, depth 3, prenet 2: the
fused kernels' widths, so the port's blocks take the kernels' plain
versions, as at a2v-large's widths on the card); its params cross over
through ``params_from_jax`` and the port must give the same logits within
1e-4 max-abs, and ``infer_long_file`` the same window
probabilities (1e-4) and the same events on a synthetic 25-s recording.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as tu

from animal2vec_tpu.ops.audio import chunk_and_normalize as jax_chunk
from animal2vec_tpu.tools.infer_cli import infer_long_file as jax_infer_long_file
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.data.wavio import write_wav
from animal2vec_tpu_torch.models.finetune import FinetuneModel, build_finetune_model
from animal2vec_tpu_torch.tools import infer_cli
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import _finetune_cfg

TOL = 1e-4
TINY = dict(embed_dim=128, num_heads=4, depth=3, prenet_depth=2,
            conv_pos_depth=2, conv_pos_width=10, conv_pos_groups=2)
TINY_LAYERS = ((9, 7, 1), (16, 4, 2), (16, 3, 2))
# long-file inference cuts 10-s windows: a stride-40 stack (as a2v-large's)
# keeps them at 2000 frames, where the dense-attention references stay small
SERVING_LAYERS = ((9, 7, 1), (16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2))


def _port_cfg(jcfg, conv_layers=TINY_LAYERS, **dims):
    crit = jcfg.criterion
    return FinetuneConfig(
        conv_layers=conv_layers, average_top_k_layers=jcfg.finetune.average_top_k_layers,
        labels=tuple(jcfg.task.labels()), max_sample_size=jcfg.task.max_sample_size,
        metric_threshold=crit.metric_threshold, sigma_s=crit.sigma_s,
        maxfilt_s=crit.maxfilt_s, max_duration_s=crit.max_duration_s, lowP=crit.lowP,
        **dims,
    )


def _jittered(params, seed):
    """Break the init's symmetries (unit norms, zero biases, equal scales)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.05, params
    )


def _both_models(conv_layers, wav_len):
    jcfg = _finetune_cfg(
        conv_layers=" + ".join(f"[{l}]" for l in conv_layers), avg_k=3, **TINY
    )
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, wav_len)))["params"]
    params = _jittered(params, seed=1)
    model = FinetuneModel(_port_cfg(jcfg, conv_layers, **TINY))
    model.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, jmodel, params, model.eval()


@pytest.fixture(scope="module")
def tiny():
    return _both_models(TINY_LAYERS, 800)


@pytest.fixture(scope="module")
def serving():
    return _both_models(SERVING_LAYERS, 8000)


def test_logits_match_jax(tiny):
    jcfg, jmodel, params, model = tiny
    src = np.random.default_rng(2).normal(size=(2, 800)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(src))["encoder_out"])
    with torch.no_grad():
        out = model(torch.from_numpy(src))
    logits = out["encoder_out"].numpy()
    assert logits.shape == ref.shape == (2, 200, 4)
    assert len(out["layer_results"]) == 3 and out["padding_mask"] is None
    np.testing.assert_allclose(logits, ref, rtol=0, atol=TOL)


def test_padding_mask_matches_jax(tiny):
    jcfg, jmodel, params, model = tiny
    src = np.random.default_rng(3).normal(size=(2, 800)).astype(np.float32)
    mask = np.zeros((2, 800), bool)
    mask[1, 600:] = True
    ref = jmodel.apply({"params": params}, jnp.asarray(src), jnp.asarray(mask))
    with torch.no_grad():
        out = model(torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_array_equal(out["padding_mask"].numpy(), np.asarray(ref["padding_mask"]))
    np.testing.assert_allclose(out["encoder_out"].numpy(), np.asarray(ref["encoder_out"]),
                               rtol=0, atol=TOL)


def test_local_features_and_relative_positions_match_jax(tiny):
    jcfg, jmodel, params, model = tiny
    src = np.random.default_rng(4).normal(size=(2, 800)).astype(np.float32)
    v = {"params": params}
    local_j = jmodel.apply(v, jnp.asarray(src),
                           method=lambda m, s: m.encoder.local_features(s))
    pos_j = jmodel.apply(v, local_j,
                         method=lambda m, x: m.encoder.audio_encoder.relative_positions(x))
    enc = model.encoder.audio_encoder
    with torch.no_grad():
        local = enc.local_features(torch.from_numpy(src), torch.float32)
        pos = enc.relative_positions(torch.tensor(np.asarray(local_j)))
    np.testing.assert_allclose(local.numpy(), np.asarray(local_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), rtol=0, atol=TOL)


def test_instance_norm_frontend_matches_jax():
    """sinc_norm=instance: |sinc conv| -> affine instance norm over time,
    GELU instead of PSwish."""
    from animal2vec_tpu.config import resolve

    jcfg = _finetune_cfg(
        conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3, **TINY
    )
    jcfg.model.modalities.audio.sinc_norm = "instance"
    jcfg.model.modalities.audio.use_pswish = False
    jcfg = resolve(jcfg)
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 800)))["params"]
    params = _jittered(params, seed=3)
    cfg = dataclasses.replace(_port_cfg(jcfg, **TINY), sinc_norm="instance", use_pswish=False)
    model = FinetuneModel(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    src = np.random.default_rng(7).normal(size=(2, 800)).astype(np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(src),
                       method=lambda m, s: m.encoder.local_features(s))
    with torch.no_grad():
        local = model.encoder.audio_encoder.local_features(torch.from_numpy(src), torch.float32)
    np.testing.assert_allclose(local.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def _synthetic_wav(path, seconds, sr=8000, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * sr) / sr
    wav = 0.05 * rng.normal(size=t.shape)
    burst = (t % 3.0) < 0.4
    wav[burst] += 0.5 * np.sin(2 * np.pi * 900 * t[burst])
    write_wav(str(path), wav.astype(np.float32), sr)
    return wav


@pytest.mark.parametrize("method", ["avg", "max", "canny"])
def test_infer_long_file_matches_jax(serving, tmp_path, method):
    jcfg, jmodel, params, model = serving
    wav_path = tmp_path / "rec.wav"
    _synthetic_wav(wav_path, 25)
    cfg = model.cfg
    assert cfg.segment_length == 10.0
    # the windows both CLIs cut, through both forwards
    from animal2vec_tpu_torch.data.wavio import read_wav

    wav, _ = read_wav(str(wav_path))
    (batch,) = jax_chunk(wav, 10.0, 8000, True, 16)
    probs_j = np.asarray(jax.nn.sigmoid(
        jmodel.apply({"params": params}, jnp.asarray(batch))["encoder_out"]
    ))
    probs = infer_cli.window_probabilities(model, batch, torch.device("cpu"))
    assert probs.shape == probs_j.shape == (3, 2000, 4)
    np.testing.assert_allclose(probs, probs_j, rtol=0, atol=TOL)

    # a threshold inside the probability range, so that events start and stop
    threshold = float(np.round(np.median(probs_j), 3))
    events = infer_cli.infer_long_file(str(wav_path), model, cfg, method=method,
                                       threshold=threshold)
    ref = jax_infer_long_file(str(wav_path), jmodel, {"params": params}, jcfg, method=method,
                              threshold=threshold, data_parallel=1)
    assert events.keys() == ref.keys()
    assert sum(len(v) for v in events.values()) > 3
    for name in ref:
        assert len(events[name]) == len(ref[name]), name
        for ours, theirs in zip(events[name], ref[name]):
            assert (ours["onset_s"], ours["offset_s"]) == (theirs["onset_s"], theirs["offset_s"])
            assert abs(ours["likelihood"] - theirs["likelihood"]) <= 1.5e-4


def test_cli_main_serves_npz_weights(serving, tmp_path):
    jcfg, jmodel, params, model = serving
    flat = {"/".join(k): np.asarray(v) for k, v in tu.flatten_dict(params).items()}
    np.savez(tmp_path / "params.npz", **flat)
    _synthetic_wav(tmp_path / "rec.wav", 12)
    overrides = [f"{k}={v}" for k, v in TINY.items()] + [
        f"conv_layers={SERVING_LAYERS}", "average_top_k_layers=3",
        "labels=('a','b','c','focal')", "max_sample_size=None",
    ]
    out = tmp_path / "events.json"
    infer_cli.main([
        "--wav", str(tmp_path / "rec.wav"), "--weights", str(tmp_path / "params.npz"),
        "--device", "cpu", "--out", str(out), *overrides,
    ])
    events = json.loads(out.read_text())
    assert set(events) == {"a", "b", "c", "focal"}
    assert all(0 <= e["onset_s"] <= e["offset_s"] <= 20.0 for v in events.values() for e in v)


def test_seeded_init_is_deterministic():
    cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS,
                              average_top_k_layers=3, **TINY)
    a = build_finetune_model(cfg, seed=7, device="cpu").state_dict()
    b = build_finetune_model(cfg, seed=7, device="cpu").state_dict()
    c = build_finetune_model(cfg, seed=8, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj.weight"], c["proj.weight"])
    # mel-spaced sinc filters, not a degenerate zero init
    low = a["encoder.audio_encoder.local_encoder.conv_0.low_hz"]
    assert torch.all(torch.diff(low[:, 0]) > 0)


def test_build_finetune_model_defaults_to_the_card(monkeypatch):
    """With no device argument the factory builds on CUDA: without a card
    it raises instead of carrying on on the CPU; device="cpu" builds there,
    with the same seeded weights as on any device."""
    cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS,
                              average_top_k_layers=3, **TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_finetune_model(cfg)
    model = build_finetune_model(cfg, device="cpu")
    assert not model.training
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.slow
def test_a2v_large_dims_match_jax():
    """a2v-large widths (127-filter sinc, 512-ch conv stack, C 1024, 16
    heads, 8 + 16 blocks, avg 16) on a 1-s window in fp32."""
    layers = FinetuneConfig().conv_layers
    dims = dict(embed_dim=1024, num_heads=16, depth=16, prenet_depth=8,
                conv_pos_depth=5, conv_pos_width=95, conv_pos_groups=16)
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in layers), avg_k=16,
                         unique_labels=str(list(FinetuneConfig().labels)), **dims)
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8000)))["params"]
    src = np.random.default_rng(6).normal(size=(1, 8000)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(src))["encoder_out"])
    model = FinetuneModel(_port_cfg(jcfg, conv_layers=layers, **dims))
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(src))["encoder_out"].numpy()
    np.testing.assert_allclose(logits, ref, rtol=0, atol=TOL)
