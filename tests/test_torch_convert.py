"""The port's fairseq converter (``train/convert.py``, ``tools/convert_cli.py``)
against the JAX package's.

A fairseq-named finetune ``.pt`` is made by JAX's ``export_pretrain`` from
seeded JAX params (the tiny config of ``tests/test_torch_model.py``) and
saved with a ``cfg`` entry whose class cannot be imported at load time. The
port's ``convert_cli import`` turns it into a checkpoint of this package;
served in fp32 it gives JAX's logits within 1e-4 max abs (TOL), and
``infer_cli --checkpoint`` serves it. The port's ``export_pretrain`` equals
JAX's in names and arrays exactly, and the pretraining import (with the
``_ema`` teacher) equals JAX's ``convert_pretrain`` through
``params_from_jax`` exactly.
"""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.models.data2vec2 import Data2VecMulti as JaxData2VecMulti
from animal2vec_tpu.train.convert import convert_pretrain as jax_convert_pretrain
from animal2vec_tpu.train.convert import export_pretrain as jax_export_pretrain

from animal2vec_tpu_torch.config import DecoderConfig, FinetuneConfig, PretrainConfig
from animal2vec_tpu_torch.data.wavio import write_wav
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.tools import convert_cli, infer_cli
from animal2vec_tpu_torch.train.checkpoint import load_checkpoint_dir
from animal2vec_tpu_torch.train.convert import (
    export_pretrain, load_torch_checkpoint, state_dict_to_numpy,
)
from animal2vec_tpu_torch.weights import params_from_jax, params_to_jax

from tests.test_models import tiny_model_cfg
from tests.test_torch_model import TINY, TINY_LAYERS, _both_models, _jittered

TOL = 1e-4  # logits, fp32 port against fp32 JAX (as tests/test_torch_model.py)
WAV = 800
# the port's configuration of tests/test_models.tiny_model_cfg: its encoder
# (TINY_CONV, embed 32, 4 heads, depth 3, prenet 2) and its audio decoder
TINY_CONV = ((9, 7, 1), (16, 4, 2), (16, 3, 2))
TINY_PRETRAIN = PretrainConfig(
    model=FinetuneConfig(conv_layers=TINY_CONV, **dict(TINY, embed_dim=32),
                         average_top_k_layers=2),
    decoder=DecoderConfig(12, 4, 3, 2, 0.0), average_top_k_layers=2, clone_batch=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' ops are too small for intra-op threads, which only
    spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save_with_unimportable_cfg(path, sd):
    """torch.save ``{"model": sd, "cfg": <object of a class that is gone at
    load time>}``, as fairseq pickles its config dataclasses."""
    mod = types.ModuleType("fairseq_cfg_stub")

    class FairseqConfig:
        def __init__(self):
            self.task = {"sample_rate": 8000}

    FairseqConfig.__module__ = mod.__name__
    FairseqConfig.__qualname__ = "FairseqConfig"
    mod.FairseqConfig = FairseqConfig
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"model": sd, "cfg": FairseqConfig()}, path)
    finally:
        del sys.modules[mod.__name__]


@pytest.fixture(scope="module")
def finetune_pt(tmp_path_factory):
    jcfg, jmodel, params, _ = _both_models(TINY_LAYERS, WAV)
    sd = {f"w2v_encoder.w2v_model.{k}": v
          for k, v in jax_export_pretrain(params["encoder"], jcfg.model).items()}
    sd["w2v_encoder.proj.weight"] = np.asarray(params["proj"]["kernel"]).T
    sd["w2v_encoder.proj.bias"] = np.asarray(params["proj"]["bias"])
    path = str(tmp_path_factory.mktemp("pt") / "finetuned.pt")
    _save_with_unimportable_cfg(path, {k: torch.tensor(np.ascontiguousarray(v))
                                       for k, v in sd.items()})
    return path, sd, jcfg, jmodel, params


def _overrides(cfg: FinetuneConfig):
    return [f"{k}={getattr(cfg, k)!r}" for k in (
        "conv_layers", "embed_dim", "num_heads", "depth", "prenet_depth", "conv_pos_depth",
        "conv_pos_width", "conv_pos_groups", "average_top_k_layers", "labels")]


def test_imported_finetune_checkpoint_gives_jax_logits(finetune_pt, tmp_path):
    path, _, jcfg, jmodel, params = finetune_pt
    with pytest.raises(ModuleNotFoundError):  # the tolerant loader is what reads it
        torch.load(path, weights_only=False)
    _, _, _, port_model = _both_models(TINY_LAYERS, WAV)
    cfg = port_model.cfg
    out = str(tmp_path / "converted")
    assert convert_cli.main(["import", "--pt", path, "--out", out, "--strict",
                             *_overrides(cfg)]) == 0
    saved = load_checkpoint_dir(out)
    assert saved["step"] == 0 and saved["extra"]["kind"] == "finetune"
    model = FinetuneModel(cfg)
    model.load_state_dict(saved["model"], strict=True)
    src = np.random.default_rng(31).normal(size=(2, WAV)).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(src))["encoder_out"])
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(src))["encoder_out"].numpy()
    np.testing.assert_allclose(logits, ref, rtol=0, atol=TOL)

    # served by infer_cli --checkpoint (bf16 serving cast): events come out
    wav = str(tmp_path / "rec.wav")
    write_wav(wav, (0.1 * np.random.default_rng(32).normal(size=3 * WAV)).astype(np.float32),
              8000)
    events = infer_cli.main(["--wav", wav, "--checkpoint", out, "--device", "cpu",
                             "--out", str(tmp_path / "ev.json"), *_overrides(cfg),
                             f"max_sample_size={WAV}"])
    assert set(events) == set(cfg.labels)

    # export back to the fairseq names: the .pt's tensors, exactly
    npz = str(tmp_path / "back.npz")
    assert convert_cli.main(["export", "--checkpoint", out, "--out", npz,
                             *_overrides(cfg)]) == 0
    _, sd, _, _, _ = finetune_pt
    with np.load(npz) as z:
        assert set(z.files) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(z[k], np.asarray(sd[k], np.float32), err_msg=k)


def test_strict_import_refuses_an_incomplete_checkpoint(finetune_pt, tmp_path):
    """A .pt missing one block's tensors: --strict exits 1 and writes
    nothing; without it the gap is filled from a fresh init."""
    _, sd, _, _, _ = finetune_pt
    cut = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()
           if ".blocks.2." not in k}
    pt = str(tmp_path / "cut.pt")
    torch.save({"model": cut}, pt)
    cfg = _both_models(TINY_LAYERS, WAV)[3].cfg
    assert convert_cli.main(["import", "--pt", pt, "--out", str(tmp_path / "a"), "--strict",
                             *_overrides(cfg)]) == 1
    assert not os.path.exists(str(tmp_path / "a" / "step_0000000000"))
    assert convert_cli.main(["import", "--pt", pt, "--out", str(tmp_path / "b"),
                             *_overrides(cfg)]) == 0
    FinetuneModel(cfg).load_state_dict(load_checkpoint_dir(str(tmp_path / "b"))["model"],
                                       strict=True)


@pytest.fixture(scope="module")
def pretrain_params():
    jcfg = tiny_model_cfg()
    model = JaxData2VecMulti(cfg=jcfg)
    params = model.init({"params": jax.random.PRNGKey(0), "mask_noise": jax.random.PRNGKey(1)},
                        jnp.zeros((1, WAV)))["params"]
    return jcfg, _jittered(params, seed=33)


def test_export_pretrain_equals_jax(pretrain_params):
    jcfg, params = pretrain_params
    ref = jax_export_pretrain(params, jcfg)
    sd = params_from_jax(params)
    ours = export_pretrain(sd, TINY_PRETRAIN.model)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == np.float32 and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    # params_to_jax inverts params_from_jax
    back = params_from_jax(params_to_jax(sd))
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_pretrain_import_with_ema_equals_jax(pretrain_params, tmp_path):
    """A pretraining .pt with a nested ``_ema`` teacher: the checkpoint's
    student and EMA equal JAX's convert_pretrain through params_from_jax,
    and the student loads into the port's pretraining model."""
    jcfg, params = pretrain_params
    sd = jax_export_pretrain(params, jcfg)
    teacher = {k: v * 0.5 for k, v in sd.items()
               if k.startswith("blocks.") or (k.startswith("modality_encoders.AUDIO")
                                              and "local_encoder" not in k
                                              and "decoder" not in k
                                              and "project_features" not in k)}
    pt = str(tmp_path / "pretrain.pt")
    _save_with_unimportable_cfg(pt, {**{k: torch.tensor(v) for k, v in sd.items()},
                                     "_ema": {k: torch.tensor(v) for k, v in teacher.items()}})
    out = str(tmp_path / "converted")
    over = [f"model.{o}" for o in _overrides(TINY_PRETRAIN.model)] + [
        "decoder.decoder_dim=12", "decoder.decoder_groups=4", "decoder.decoder_kernel=3",
        "decoder.decoder_layers=2", "average_top_k_layers=2"]
    assert convert_cli.main(["import", "--pt", pt, "--out", out, "--strict", *over]) == 0
    saved = load_checkpoint_dir(out)
    flat = {**sd, **{f"_ema.{k}": v for k, v in teacher.items()}}
    want, want_ema = jax_convert_pretrain(flat, jcfg)
    want, want_ema = params_from_jax(want), params_from_jax(want_ema)
    assert saved["model"].keys() == want.keys() and saved["ema"].keys() == want_ema.keys()
    for got, ref in ((saved["model"], want), (saved["ema"], want_ema)):
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model

    build_pretrain_model(TINY_PRETRAIN, device="cpu").load_state_dict(saved["model"],
                                                                      strict=True)


def test_unreadable_files_raise_value_error(tmp_path):
    good = str(tmp_path / "good.pt")
    torch.save({"model": {"w": torch.ones(64, 64)}}, good)
    data = open(good, "rb").read()
    truncated = tmp_path / "truncated.pt"
    truncated.write_bytes(data[: len(data) // 2])
    garbage = tmp_path / "garbage.pt"
    garbage.write_bytes(np.random.default_rng(34).bytes(4096))
    for path in (truncated, garbage):
        with pytest.raises(ValueError, match="could not be read"):
            load_torch_checkpoint(str(path))


def test_half_precision_tensors_survive_the_load(tmp_path):
    """bf16 and fp16 tensors (and a nested _ema) come out as their exact
    fp32 values."""
    rng = np.random.default_rng(35)
    bf = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).bfloat16()
    hf = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)).half()
    path = str(tmp_path / "half.pt")
    _save_with_unimportable_cfg(path, {"a.weight": bf, "b.bias": hf,
                                       "_ema": {"a.weight": bf * 2}, "step": 3})
    sd = state_dict_to_numpy(load_torch_checkpoint(path)["model"])
    assert set(sd) == {"a.weight", "b.bias", "_ema.a.weight"}
    assert all(v.dtype == np.float32 for v in sd.values())
    np.testing.assert_array_equal(sd["a.weight"], bf.float().numpy())
    np.testing.assert_array_equal(sd["b.bias"], hf.float().numpy())
    np.testing.assert_array_equal(sd["_ema.a.weight"], (bf * 2).float().numpy())


def test_per_layer_scales_and_extra_tokens_round_trip():
    """A model with two extra tokens and one ALiBi scale per block: the
    port's ``export_pretrain`` equals JAX's on the same params (the scales
    as (n_blocks, 1, H, 1, 1), the tokens (1, 2, C)), and the import gives
    the state dict back bit for bit."""
    from animal2vec_tpu_torch.models.finetune import build_pretrain_model
    from animal2vec_tpu_torch.train.convert import pretrain_state_dicts

    cfg = dataclasses.replace(TINY_PRETRAIN, model=dataclasses.replace(
        TINY_PRETRAIN.model, num_extra_tokens=2, learned_alibi_scale_per_layer=True))
    sd = build_pretrain_model(cfg, seed=5, device="cpu").state_dict()
    sd["audio_encoder.alibi_scale"] = torch.rand(sd["audio_encoder.alibi_scale"].shape)
    assert sd["audio_encoder.alibi_scale"].shape == (cfg.model.n_blocks, 1, 4, 1, 1)
    ours = export_pretrain(sd, cfg.model)
    jcfg = tiny_model_cfg()
    jcfg.modalities.audio.num_extra_tokens = 2
    jcfg.modalities.audio.learned_alibi_scale_per_layer = True
    ref = jax_export_pretrain(params_to_jax(sd), jcfg)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["modality_encoders.AUDIO.extra_tokens"].shape == (1, 2, 32)
    back, _ = pretrain_state_dicts(ours, cfg.model, cfg.decoder.decoder_layers)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
