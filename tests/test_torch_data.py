"""The port's host data pipeline against the JAX package's: the copied
label arithmetic, manifests, label files and synthetic generator, and the
``BatchLoader`` batch for batch, bit for bit: the Python decoders of both
(``use_native=False``) on one host, and each package's default, the C++
batch loader, with its crops, on two hosts."""

import os

import numpy as np
import pytest
import torch

from animal2vec_tpu.data import labels as jax_labels
from animal2vec_tpu.data import manifest as jax_manifest
from animal2vec_tpu.data.dataset import AudioLabelDataset as JaxDataset
from animal2vec_tpu.data.dataset import BatchLoader as JaxLoader
from animal2vec_tpu.data.synthetic import generate as jax_generate
from animal2vec_tpu.data.wavio import read_wav as jax_read_wav
from animal2vec_tpu.ops import frames as jax_frames
from animal2vec_tpu.ops.conv_arith import label_frame_length as jax_label_frame_length

from animal2vec_tpu_torch.data import labels, manifest
from animal2vec_tpu_torch.data.dataset import AudioLabelDataset, BatchLoader
from animal2vec_tpu_torch.data.synthetic import DEFAULT_LABELS, generate
from animal2vec_tpu_torch.ops import frames
from animal2vec_tpu_torch.ops.conv_arith import label_frame_length

A2V_LAYERS = [(127, 63, 1), (512, 10, 5)] + [(512, 3, 2)] * 3 + [(512, 3, 1)] + [(512, 2, 1)] * 2
TINY_LAYERS = [(9, 7, 1), (16, 4, 2), (16, 3, 2)]


@pytest.mark.parametrize("layers", [A2V_LAYERS, TINY_LAYERS], ids=["a2v", "tiny"])
def test_label_frames_match_jax(layers):
    rng = np.random.default_rng(0)
    for n in (1, 799, 800, 4000, 80_000, 80_001):
        assert label_frame_length(n, layers) == jax_label_frame_length(n, layers)
    n = 8000
    starts = rng.integers(0, n - 500, 6)
    ends = starts + rng.integers(1, 500, 6)
    cats = rng.integers(0, 11, 6)
    foc = rng.integers(0, 2, 6)
    for multilabel in (True, False):
        for focal in (True, False):
            kw = dict(focal=foc, multilabel=multilabel, do_focal_prediction=focal)
            np.testing.assert_array_equal(
                frames.frame_targets(n, 12, starts, ends, cats, layers, **kw),
                jax_frames.frame_targets(n, 12, starts, ends, cats, layers, **kw))
            raster = frames.rasterize_labels(n, 12, starts, ends, cats, **kw)
            np.testing.assert_array_equal(
                raster, jax_frames.rasterize_labels(n, 12, starts, ends, cats, **kw))
            np.testing.assert_array_equal(frames.downsample_targets(raster, n, layers),
                                          jax_frames.downsample_targets(raster, n, layers))


@pytest.mark.parametrize("ext", ["h5", "npz"])
def test_manifest_and_labels_match_jax(tmp_path, ext):
    entries = [("wav/a.wav", 8000), ("wav/sub/b.wav", 123)]
    manifest.write_manifest(str(tmp_path / "ours.tsv"), "/data", entries)
    jax_manifest.write_manifest(str(tmp_path / "theirs.tsv"), "/data", entries)
    assert (tmp_path / "ours.tsv").read_bytes() == (tmp_path / "theirs.tsv").read_bytes()
    assert manifest.read_manifest(str(tmp_path / "ours.tsv")) == \
        jax_manifest.read_manifest(str(tmp_path / "ours.tsv"))
    fields = dict(start_time=[0.1, 0.5], start_frame=[800, 4000], end_time=[0.2, 0.9],
                  end_frame=[1600, 7200], lbl=["beep", "cc"], lbl_cat=[0, 3], foc=[1, 0])
    path = str(tmp_path / f"x.{ext}")
    labels.write_label_file(path, **fields)
    ours, theirs = labels.read_label_file(path), jax_labels.read_label_file(path)
    jax_labels.write_label_file(str(tmp_path / f"y.{ext}"), **fields)
    again = labels.read_label_file(str(tmp_path / f"y.{ext}"))
    assert ours.keys() == theirs.keys() == again.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
        np.testing.assert_array_equal(ours[k], again[k])
    wav = "/r/wav/08000Hz/clip.wav"
    assert labels.audio_path_to_label_path(wav, lblext=ext) == \
        jax_labels.audio_path_to_label_path(wav, lblext=ext)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("ext,secs", [("h5", 0.5), ("npz", (0.3, 0.9))], ids=["h5", "npz-var"])
def test_generate_matches_jax(tmp_path, ext, secs):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    generate(ours, n_clips=5, clip_seconds=secs, seed=3, label_ext=ext)
    jax_generate(theirs, n_clips=5, clip_seconds=secs, seed=3, label_ext=ext)
    assert _tree(ours) == _tree(theirs)
    for rel in _tree(ours):
        a, b = os.path.join(ours, rel), os.path.join(theirs, rel)
        if rel.endswith(".tsv"):
            ra, rb = manifest.read_manifest(a), manifest.read_manifest(b)
            assert ra[1] == rb[1] and ra[0] == ours and rb[0] == theirs
        elif rel.endswith(".wav"):
            wa, sa = jax_read_wav(a)
            wb, sb = jax_read_wav(b)
            assert sa == sb == 8000
            np.testing.assert_array_equal(wa, wb)
        else:
            la, lb = labels.read_label_file(a), labels.read_label_file(b)
            assert la.keys() == lb.keys()
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Uniform 0.5-s clips and variable 0.2-1.0-s clips, npz labels."""
    root = tmp_path_factory.mktemp("corpus")
    fixed = generate(str(root / "fixed"), n_clips=11, clip_seconds=0.5, seed=5, label_ext="npz")
    var = generate(str(root / "var"), n_clips=14, clip_seconds=(0.2, 1.0), seed=6,
                   label_ext="npz")
    return fixed, var


def _datasets(root, split, train, ext="npz"):
    kw = dict(sample_rate=8000, normalize=True, return_labels=True,
              unique_labels=DEFAULT_LABELS, min_label_size=0,
              conv_layers=TINY_LAYERS, label_ext=ext)
    path = os.path.join(root, f"{split}.tsv")
    return AudioLabelDataset(path, **kw), JaxDataset(path, **kw)


def _assert_same_batch(ours, theirs):
    assert set(ours) == set(theirs), (set(ours), set(theirs))
    for k, v in theirs.items():
        got = ours[k]
        assert isinstance(got, torch.Tensor)
        want = np.asarray(v)
        assert got.dtype == torch.from_numpy(want).dtype and tuple(got.shape) == want.shape, k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


LOADERS = {
    # (corpus, split, train, loader keywords, epochs)
    "train-accum2": ("fixed", "pretrain", True,
                     dict(target_len=3200, batch_size=2, accum=2, seed=9), 2),
    "train-buckets": ("var", "pretrain", True,
                      dict(target_len=6400, max_tokens=8000, accum=2, seed=4,
                           bucket_lengths=[1600, 3200, 6400]), 2),
    "eval": ("fixed", "pretrain", False,
             dict(target_len=4000, batch_size=3, accum=1, shuffle=False, drop_last=False), 1),
    "eval-buckets": ("var", "pretrain", False,
                     dict(target_len=6400, max_tokens=9600, shuffle=False, drop_last=False,
                          bucket_lengths=[3200, 6400], batch_multiple=2), 1),
}


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loader_matches_jax(corpus, case):
    which, split, train, kw, epochs = LOADERS[case]
    root = corpus[0] if which == "fixed" else corpus[1]
    ds, jds = _datasets(root, split, train)
    loader = BatchLoader(ds, train=train, num_workers=2, use_native=False, **kw)
    jloader = JaxLoader(jds, train=train, num_workers=2, use_native=False, **kw)
    assert len(loader) == len(jloader) > 0
    n = 0
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        for ours, theirs in zip(loader, jloader, strict=True):
            _assert_same_batch(ours, theirs)
            n += 1
    assert n == epochs * len(loader)
    if not train:
        assert "n_valid" in ours


@pytest.fixture(scope="module")
def long_clips(tmp_path_factory):
    """0.3-1.5-s clips, most longer than the 0.8-s crop below."""
    root = tmp_path_factory.mktemp("long")
    return generate(str(root), n_clips=16, clip_seconds=(0.3, 1.5), seed=8, label_ext="npz")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_default_loader_matches_jax_native(long_clips, train):
    """The default loaders (the C++ decoder in both packages) batch for
    batch on two hosts with labels and buckets: the same seeded crop
    offsets (JAX's use_native=True default, dataset.py:175, 308-340), hence
    the same sources and cropped targets."""
    ds, jds = _datasets(long_clips, "pretrain", train)
    target_len = 6400
    assert (ds.sizes > target_len).sum() >= 8
    kw = dict(target_len=target_len, max_tokens=12800, accum=2 if train else 1, seed=3,
              shuffle=train, drop_last=train, bucket_lengths=[3200, target_len])
    n = 0
    for host in range(2):
        shard = dict(kw, host_index=host, host_count=2)
        loader = BatchLoader(ds, train=train, num_workers=2, **shard)
        jloader = JaxLoader(jds, train=train, num_workers=2, **shard)
        assert jloader._native and len(loader) == len(jloader) > 0
        for epoch in range(2 if train else 1):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            for ours, theirs in zip(loader, jloader, strict=True):
                _assert_same_batch(ours, theirs)
                n += 1
    assert n >= 4


def test_loader_resumes_mid_epoch(corpus):
    ds, _ = _datasets(corpus[1], "pretrain", True)
    kw = dict(target_len=6400, max_tokens=8000, accum=1, seed=2, num_workers=2,
              bucket_lengths=[1600, 3200, 6400])
    loader = BatchLoader(ds, **kw)
    loader.set_epoch(1)
    full = list(loader)
    assert len(full) >= 4
    first = BatchLoader(ds, **kw)
    first.set_epoch(1)
    it = iter(first)
    for _ in range(2):
        next(it)
    state = first.state_dict()
    assert state == {"epoch": 1, "position": 2}
    resumed = BatchLoader(ds, **kw)
    resumed.load_state_dict(state)
    resumed.set_epoch(resumed.epoch)
    rest = list(resumed)
    assert len(rest) == len(full) - 2
    for ours, want in zip(rest, full[2:]):
        assert ours.keys() == want.keys()
        for k in want:
            assert torch.equal(ours[k], want[k]), k
    assert resumed.state_dict() == {"epoch": 1, "position": 0}
