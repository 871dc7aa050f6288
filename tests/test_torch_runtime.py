"""The port's C++ batch loader (``animal2vec_tpu_torch/runtime``) against
the JAX package's: the source copy, ``decode_batch`` on the same files in
train and eval, the twins of ``tests/test_runtime.py``'s cases at their
tolerances, and a failed build that raises."""

import os
from pathlib import Path

import numpy as np
import pytest

from animal2vec_tpu import runtime as jax_runtime
from animal2vec_tpu.ops.audio import layer_norm_1d

from animal2vec_tpu_torch.data.dataset import AudioLabelDataset, BatchLoader
from animal2vec_tpu_torch.data.synthetic import generate
from animal2vec_tpu_torch.data.wavio import read_wav, write_wav
from animal2vec_tpu_torch.kernels.build import BUILD_ROOT
from animal2vec_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """tests/test_runtime.py's three files: 2 s, 1 s and 2.5 s at 8 kHz."""
    root = str(tmp_path_factory.mktemp("native"))
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate([16_000, 8_000, 20_000]):
        p = os.path.join(root, f"w{i}.wav")
        write_wav(p, rng.uniform(-0.5, 0.5, n).astype(np.float32), 8000)
        paths.append(p)
    return paths


def test_source_is_the_jax_copy():
    ours = REPO / "animal2vec_tpu_torch" / "runtime" / "a2v_runtime.cc"
    assert ours.read_bytes() == (REPO / "animal2vec_tpu" / "runtime" / "a2v_runtime.cc").read_bytes()
    assert native.SOURCE == ours


def test_builds_its_own_library():
    assert native.ensure_built() and native.available()
    assert native.library_path().parent.parent == BUILD_ROOT
    assert Path(native._lib._name) == native.library_path()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_decode_batch_matches_jax(wavs, train, seed):
    """Crops at 6000 samples (every file longer) and pads at 18 000 (two
    shorter), normalized or not: out, valid lengths and crop starts
    equal."""
    assert jax_runtime.native_available()
    for target_len, normalize in ((6_000, True), (18_000, False)):
        kw = dict(normalize=normalize, train=train, seed=seed, expected_sr=8000)
        ours = native.decode_batch(wavs, target_len, **kw)
        theirs = jax_runtime.decode_batch(wavs, target_len, **kw)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        if target_len == 6_000 and train:
            assert len(set(ours[2].tolist())) > 1  # seeded offsets, not the center


def test_wav_info(wavs):
    assert native.wav_info_native(wavs[0]) == (16_000, 8000)


def test_decode_matches_python(wavs):
    out, valid, starts = native.decode_batch(wavs, target_len=16_000, normalize=False,
                                             train=False, expected_sr=8000)
    assert out.shape == (3, 16_000)
    ref0, _ = read_wav(wavs[0])
    np.testing.assert_allclose(out[0], ref0, atol=1e-6)
    assert valid[1] == 8_000  # short file: right-padded
    np.testing.assert_allclose(out[1, 8_000:], 0.0)
    assert valid[2] == 16_000 and starts[2] == 2_000  # long file: center crop at eval


def test_normalization_matches(wavs):
    out, _, _ = native.decode_batch([wavs[0]], target_len=16_000, normalize=True, train=False)
    ref, _ = read_wav(wavs[0])
    np.testing.assert_allclose(out[0], layer_norm_1d(ref), atol=2e-4)


def test_train_crop_deterministic_per_seed(wavs):
    a1, _, s1 = native.decode_batch([wavs[2]], 8_000, False, True, seed=7)
    a2, _, s2 = native.decode_batch([wavs[2]], 8_000, False, True, seed=7)
    np.testing.assert_array_equal(a1, a2)
    assert s1[0] == s2[0] and 0 <= s1[0] <= 12_000


def test_bad_file_raises(tmp_path):
    bad = str(tmp_path / "bad.wav")
    (tmp_path / "bad.wav").write_bytes(b"not audio at all")
    with pytest.raises(ValueError):
        native.decode_batch([bad], 8_000, False, False)
    with pytest.raises(ValueError):
        native.wav_info_native(bad)


def test_sample_rate_mismatch_raises(tmp_path):
    p = str(tmp_path / "sr.wav")
    write_wav(p, np.zeros(100, np.float32), 16_000)
    with pytest.raises(ValueError):
        native.decode_batch([p], 8_000, False, False, expected_sr=8000)


def test_failed_build_raises(tmp_path, monkeypatch):
    """With the compiler command pointed at ``false`` and an empty build
    directory, loading the library, decoding and constructing the default
    loader raise; only ``use_native=False`` asks for the Python decoder."""
    root = generate(str(tmp_path / "data"), n_clips=2, clip_seconds=0.5, seed=1)
    ds = AudioLabelDataset(os.path.join(root, "pretrain.tsv"))
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the batch loader failed"):
        native.ensure_built()
    with pytest.raises(RuntimeError):
        native.decode_batch([os.path.join(root, ds.names[0])], 4000)
    with pytest.raises(RuntimeError):
        BatchLoader(ds, target_len=4000, batch_size=1)
    assert not native.library_path().exists()
    batches = list(BatchLoader(ds, target_len=4000, batch_size=1, use_native=False))
    assert len(batches) == 2 and native._lib is None
