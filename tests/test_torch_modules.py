"""The port's helper copies, config preset and modules against the JAX
package's originals, plus the port's import hygiene and the on-card
scripts' refusal to run without CUDA.

Inputs come from numpy seeds and go to both sides; modules compare in fp32
with tolerance 1e-5 max-abs (the same math in another summation order).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.config import load_config
from animal2vec_tpu.data import wavio as jax_wavio
from animal2vec_tpu.models.attention import AlibiSpec as JaxAlibiSpec
from animal2vec_tpu.models.modules import AltBlock as JaxAltBlock, BlockConfig
from animal2vec_tpu.ops import audio as jax_audio, conv_arith as jax_conv_arith, sinc as jax_sinc

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.data import wavio
from animal2vec_tpu_torch.models.attention import AlibiSpec
from animal2vec_tpu_torch.models.modules import AltBlock
from animal2vec_tpu_torch.ops import audio, conv_arith, sinc
from animal2vec_tpu_torch.ops.alibi import alibi_slopes
from animal2vec_tpu_torch.weights import params_from_jax, serving_cast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


class TestHelperCopies:
    @pytest.mark.parametrize("c,k", [(127, 63), (9, 7), (40, 251)])
    def test_sinc(self, c, k):
        low, band = sinc.mel_init_filterbank(c, k, 8000)
        low_j, band_j = jax_sinc.mel_init_filterbank(c, k, 8000)
        np.testing.assert_array_equal(low, low_j)
        np.testing.assert_array_equal(band, band_j)
        np.testing.assert_array_equal(sinc.half_hamming_window(k), jax_sinc.half_hamming_window(k))
        np.testing.assert_array_equal(sinc.full_hamming_window(k), jax_sinc.full_hamming_window(k))
        rng = np.random.default_rng(k)
        low = low + rng.normal(size=low.shape).astype(np.float32) * 20
        ours = sinc.sinc_filters(torch.from_numpy(low), torch.from_numpy(band), k, 8000)
        ref = jax_sinc.sinc_filters(jnp.asarray(low), jnp.asarray(band), k, 8000)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=TOL)

    def test_conv_arith(self):
        layers = FinetuneConfig().conv_layers
        for k in range(1, 12):
            assert conv_arith.same_pad_1d(k) == jax_conv_arith.same_pad_1d(k)
            assert conv_arith.strided_pad_1d(k) == jax_conv_arith.strided_pad_1d(k)
        for n in (1000, 8000, 80_000, 123_457):
            assert conv_arith.feature_extractor_out_length(n, layers) == (
                jax_conv_arith.feature_extractor_out_length(n, layers)
            )

    @pytest.mark.parametrize("n,batch", [(250_000, 16), (80_000, 4), (5_000, 2)])
    def test_chunk_and_normalize(self, n, batch):
        wav = np.random.default_rng(n).normal(size=n).astype(np.float32) * 0.3
        ours = audio.chunk_and_normalize(wav, 10.0, 8000, True, batch)
        ref = jax_audio.chunk_and_normalize(wav, 10.0, 8000, True, batch)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)

    def test_wavio(self, tmp_path):
        wav = np.random.default_rng(4).uniform(-0.9, 0.9, size=(1000, 2)).astype(np.float32)
        for subtype in ("PCM_16", "FLOAT"):
            wavio.write_wav(str(tmp_path / "a.wav"), wav, 8000, subtype)
            jax_wavio.write_wav(str(tmp_path / "b.wav"), wav, 8000, subtype)
            assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
            ours, sr = wavio.read_wav(str(tmp_path / "a.wav"))
            ref, sr_j = jax_wavio.read_wav(str(tmp_path / "a.wav"))
            assert sr == sr_j == 8000
            np.testing.assert_array_equal(ours, ref)


def test_config_preset_matches_finetune_100_yaml():
    jcfg = load_config(os.path.join(REPO, "animal2vec_tpu/configs/finetune_100.yaml"))
    m, audio_cfg, crit = jcfg.model, jcfg.model.modalities.audio, jcfg.criterion
    expected = {
        "conv_layers": tuple(jcfg.task.conv_layers()),
        "sample_rate": jcfg.task.sample_rate,
        "sinc_norm": audio_cfg.sinc_norm,
        "use_pswish": audio_cfg.use_pswish,
        "conv_pos_width": audio_cfg.conv_pos_width,
        "conv_pos_groups": audio_cfg.conv_pos_groups,
        "conv_pos_depth": audio_cfg.conv_pos_depth,
        "prenet_depth": audio_cfg.prenet_depth,
        "depth": m.depth,
        "embed_dim": m.embed_dim,
        "num_heads": m.num_heads,
        "mlp_ratio": m.mlp_ratio,
        "norm_eps": m.norm_eps,
        "alibi_scale": audio_cfg.alibi_scale,
        "average_top_k_layers": jcfg.finetune.average_top_k_layers,
        "labels": tuple(jcfg.task.labels()),
        "normalize": jcfg.task.normalize,
        "max_sample_size": jcfg.task.max_sample_size,
        "metric_threshold": crit.metric_threshold,
        "sigma_s": crit.sigma_s,
        "maxfilt_s": crit.maxfilt_s,
        "max_duration_s": crit.max_duration_s,
        "lowP": crit.lowP,
        "iou_threshold": crit.iou_threshold,
        "matmul_impl": m.matmul_impl,
        "learned_alibi_scale_per_layer": audio_cfg.learned_alibi_scale_per_layer,
        "num_extra_tokens": audio_cfg.num_extra_tokens,
        "init_extra_token_zero": audio_cfg.init_extra_token_zero,
        "remat": m.remat, "remat_scope": m.remat_scope, "remat_frontend": m.remat_frontend,
        "remat_decoder": m.remat_decoder,
        "pipeline_stages": m.pipeline_stages, "pipeline_microbatches": m.pipeline_microbatches,
        "sinc_input": audio_cfg.sinc_input,
        "apply_window_to_root": audio_cfg.apply_window_to_root,
        "extractor_mode": audio_cfg.extractor_mode,
        "conv_pos_pre_ln": audio_cfg.conv_pos_pre_ln,
        "layer_norm_first": m.layer_norm_first, "norm_affine": m.norm_affine,
        "end_of_block_targets": m.end_of_block_targets,
        "use_alibi_encoder": audio_cfg.use_alibi_encoder,
        "learned_alibi_scale_per_head": audio_cfg.learned_alibi_scale_per_head,
        # a finetune run's trunk takes finetune.drop_path (build_finetune_encoder_cfg)
        "start_drop_path_rate": jcfg.finetune.drop_path,
        "end_drop_path_rate": jcfg.finetune.drop_path,
        "prenet_start_drop_path_rate": audio_cfg.start_drop_path_rate,
        "prenet_end_drop_path_rate": audio_cfg.end_drop_path_rate,
    }
    ours = FinetuneConfig()
    assert set(expected) == {f.name for f in dataclasses.fields(ours)}
    for name, value in expected.items():
        assert getattr(ours, name) == value, name
    # the structural choices the port implements
    assert not m.layer_norm_first and not m.end_of_block_targets and m.norm_affine
    assert not audio_cfg.conv_pos_pre_ln
    assert audio_cfg.extractor_mode == "layer_norm" and not audio_cfg.apply_window_to_root
    assert audio_cfg.use_alibi_encoder and audio_cfg.learned_alibi_scale_per_head
    assert not audio_cfg.learned_alibi_scale_per_layer and audio_cfg.num_extra_tokens == 0


def test_serving_cast_rules():
    sd = {
        "a.conv_0.low_hz": torch.ones(3, 1),
        "a.alibi_scale": torch.ones(1, 1, 2, 1, 1),
        "a.norm.weight": torch.ones(4),
        "a.fc.weight": torch.ones(4, 4),
        "a.conv_1.weight": torch.ones(4, 4, 3),
    }
    out = serving_cast(sd)
    assert out["a.conv_0.low_hz"].dtype == torch.float32
    assert out["a.alibi_scale"].dtype == torch.float32
    assert out["a.norm.weight"].dtype == torch.float32
    assert out["a.fc.weight"].dtype == torch.bfloat16
    assert out["a.conv_1.weight"].dtype == torch.bfloat16


def test_alt_block_matches_jax(monkeypatch):
    """One post-LN AltBlock, JAX side on its Pallas kernels in interpret mode
    (packed ALiBi attention and the fused block)."""
    monkeypatch.setenv("A2V_PALLAS_SERVE", "1")
    monkeypatch.setenv("A2V_FLASH_INTERPRET", "1")
    b, t, c, h = 2, 150, 128, 2
    rng = np.random.default_rng(20)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    blk = JaxAltBlock(cfg=BlockConfig(dim=c, num_heads=h, mlp_ratio=2.0, norm_eps=1e-5))
    slopes = (alibi_slopes(h) * 0.6).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)[None]
    spec = JaxAlibiSpec(jnp.asarray(slopes), jnp.asarray(pos))
    params = blk.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), None, spec)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.05, params
    )
    xo_j, tap_j = blk.apply(params, jnp.asarray(x), None, spec)

    ours = AltBlock(c, h, mlp_ratio=2.0, eps=1e-5)
    ours.load_state_dict(params_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        xo, tap = ours(torch.from_numpy(x), None,
                       AlibiSpec(torch.from_numpy(slopes), torch.from_numpy(pos)))
    np.testing.assert_allclose(tap.numpy(), np.asarray(tap_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(xo.numpy(), np.asarray(xo_j), rtol=0, atol=TOL)


def test_port_imports_no_jax():
    """Every port module, and chip_smoke.py imported as a module, load no
    module of jax, jaxlib, flax or the JAX package; importing chip_smoke
    runs nothing."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import animal2vec_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(json.dumps({'names': names, 'loaded': sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'animal2vec_tpu'))}))\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout  # chip_smoke printed nothing on import
    res = json.loads(lines[0])
    assert len(res["names"]) >= 71
    assert {"animal2vec_tpu_torch.recipes", "animal2vec_tpu_torch.ops.int8_mm", "animal2vec_tpu_torch.ops.fused_mlp",
            "animal2vec_tpu_torch.ops.attention", "animal2vec_tpu_torch.ops.bias_attention",
            "animal2vec_tpu_torch.train.pretrain", "animal2vec_tpu_torch.train.state",
            "animal2vec_tpu_torch.data.dataset", "animal2vec_tpu_torch.train.loop",
            "animal2vec_tpu_torch.train.checkpoint", "animal2vec_tpu_torch.tools.train_cli",
            "animal2vec_tpu_torch.kernels.ops", "animal2vec_tpu_torch.serve",
            "animal2vec_tpu_torch.parallel.serving", "animal2vec_tpu_torch.train.convert",
            "animal2vec_tpu_torch.tools.convert_cli", "animal2vec_tpu_torch.tools.export_cli",
            "animal2vec_tpu_torch.tools.aot_cli", "animal2vec_tpu_torch.tools.manifest_cli",
            "animal2vec_tpu_torch.tools.prepare_data_cli", "animal2vec_tpu_torch.data.stratify",
            "animal2vec_tpu_torch.parallel.mesh", "animal2vec_tpu_torch.ops.ring_attention",
            "animal2vec_tpu_torch.tools.dryrun_multigpu", "animal2vec_tpu_torch.runtime.native",
            } <= set(res["names"])
    assert res["loaded"] == [], res["loaded"]


@pytest.mark.parametrize("method", ["avg", "max", "canny"])
def test_fuse_predict_copy_matches_original(method):
    """The port's evalx copy gives the original's events on the same
    probabilities: bursts on a noise floor, three windows, four classes."""
    from animal2vec_tpu.evalx.segmentation import fuse_predict as jax_fuse_predict
    from animal2vec_tpu_torch.evalx.segmentation import fuse_predict

    rng = np.random.default_rng(30)
    t = np.arange(2000)
    probs = 0.1 * rng.random((3, 2000, 4))
    for b in range(3):
        for c in range(4):
            for start in rng.integers(0, 1900, size=4):
                probs[b, start:start + rng.integers(5, 80), c] += rng.uniform(0.3, 0.8)
    probs = np.clip(probs + 0.05 * np.sin(t / 37.0)[None, :, None], 0, 1)
    md = FinetuneConfig().criterion()
    for kw in ({}, {"multiplier": 2}, {"multiplier": 1, "bs": 4}):
        ours = fuse_predict(80_000, probs, md, 8000, method=method, **kw)
        ref = jax_fuse_predict(80_000, probs, md, 8000, method=method, **kw)
        assert ours == ref
    assert sum(len(v) for v in ours[1][0]) > 3


@pytest.mark.parametrize("argv", [
    ["chip_smoke.py"],
    ["-m", "animal2vec_tpu_torch.tools.profile_forward"],
    ["-m", "animal2vec_tpu_torch.tools.profile_train_step"],
    ["-m", "animal2vec_tpu_torch.tools.compare_int8_kernels", "--other-root", "."],
    ["-m", "animal2vec_tpu_torch.tools.compare_bias_attention", "--other-csrc", "."],
    ["-m", "animal2vec_tpu_torch.tools.profiler_windows", "--seconds", "1"],
    ["-m", "animal2vec_tpu_torch.tools.train_cli", "--recipe", "finetune_100"],
    ["-m", "animal2vec_tpu_torch.tools.export_cli", "--manifest-path", "m", "--checkpoint", "c",
     "--out-path", "o"],
    ["-m", "animal2vec_tpu_torch.tools.aot_cli", "--checkpoint", "c", "--out", "o"],
])
def test_card_scripts_refuse_without_cuda(argv):
    """Without a CUDA card the on-card scripts exit non-zero and print no
    result line, instead of carrying on on the CPU."""
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in (out.stderr + out.stdout).lower()


@pytest.mark.parametrize("names, kept", [
    (["spin_kernel", "gemm", "ln_rows", "spin_kernel"], ["gemm", "ln_rows"]),
    (["spin_kernel"] * 2 + ["gemm", "ln_rows"] + ["spin_kernel"] * 3, ["gemm", "ln_rows"]),
    (["gemm", "ln_rows", "spin_kernel"], None),  # every leading marker lost
    (["spin_kernel", "gemm", "ln_rows"], None),  # every trailing marker lost
    (["spin_kernel", "spin_kernel"], []),
    ([], None),  # a window that recorded nothing
])
def test_device_time_counts_only_complete_windows(names, kept):
    """A profiled window counts only when its first and last device records
    are spin-kernel markers, however many of each run were lost; host
    records and the order they are listed in do not matter."""
    from types import SimpleNamespace

    from animal2vec_tpu_torch.tools.device_time import complete_records

    def record(name, start, device):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start),
                               device_type=device)

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [record(n, 10 * i, cuda) for i, n in enumerate(names)]
    events = events[::-1] + [record("cudaLaunchKernel", -5, cpu), record("spin_kernel", 999, cpu)]
    recs = complete_records(SimpleNamespace(events=lambda: events))
    assert (recs if recs is None else [e.name for e in recs]) == kept
