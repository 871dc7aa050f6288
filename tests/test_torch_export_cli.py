"""The port's manifest export (``tools/export_cli.py``) and data tools
(``data/stratify.py``, ``tools/manifest_cli.py``, ``tools/prepare_data_cli.py``)
against the JAX package's own functions.

export_cli runs a tiny fp32 finetune model (embed 128, depth 3, the a2v
stride-40 conv stack) over a synthetic split of 1-s clips, 8 clips at batch 3
so the last batch repeats rows (``n_valid``). Its HDF5 holds against JAX:
the likelihoods against the JAX model's sigmoid on the JAX loader's batches
within 1e-4, the segmented likelihoods and targets against JAX's
``segmented_probs_and_targets`` of the exported likelihoods exactly, the
targets exactly, the embeddings against the JAX model's tap average within
1e-4. The npz output holds the same groups, bit for bit.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as tu

from animal2vec_tpu.data import stratify as jax_stratify
from animal2vec_tpu.data.dataset import AudioLabelDataset as JaxDataset
from animal2vec_tpu.data.dataset import BatchLoader as JaxLoader
from animal2vec_tpu.evalx.segmentation import (
    intervals_from_binary as jax_intervals,
    segmented_probs_and_targets as jax_segmented,
)
from animal2vec_tpu.tools import manifest_cli as jax_manifest_cli
from animal2vec_tpu.tools import prepare_data_cli as jax_prepare_data_cli
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.data import stratify
from animal2vec_tpu_torch.data.synthetic import DEFAULT_LABELS, generate
from animal2vec_tpu_torch.data.wavio import write_wav
from animal2vec_tpu_torch.tools import export_cli, manifest_cli, prepare_data_cli

from tests.test_parity import _finetune_cfg
from tests.test_torch_model import SERVING_LAYERS, TINY, _jittered

TOL = 1e-4  # likelihoods and embeddings, fp32 port against fp32 JAX
CLIP = 8000  # 1-s clips at 8 kHz: 200 frames through the stride-40 stack
BATCH = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' ops are too small for intra-op threads, which only
    spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    data = generate(str(root / "data"), n_clips=10, clip_seconds=CLIP / 8000, seed=21)
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in SERVING_LAYERS), avg_k=3,
                         unique_labels=str(DEFAULT_LABELS), **TINY)
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, CLIP)))["params"]
    params = _jittered(params, seed=22)
    weights = str(root / "params.npz")
    np.savez(weights, **{"/".join(k): np.asarray(v)
                         for k, v in tu.flatten_dict(params).items()})
    overrides = [f"{k}={v!r}" for k, v in TINY.items()] + [
        f"conv_layers={SERVING_LAYERS!r}", "average_top_k_layers=3", f"max_sample_size={CLIP}",
        f"labels={tuple(DEFAULT_LABELS)!r}"]
    return root, data, jcfg, jmodel, params, weights, overrides


def _export(setup, out, fmt, *extra):
    root, data, _, _, _, weights, overrides = setup
    return export_cli.main([
        "--manifest-path", data, "--split", "train_0", "--weights", weights, "--out-path", out,
        "--batch-size", str(BATCH), "--export-predictions", "--export-embeddings",
        "--average-start-k-layers", "1", "--average-end-k-layers", "3", "--device", "cpu",
        "--dtype", "float32", "--output-format", fmt, *extra, *overrides])


def _read_h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        for g in f:
            for name in f[g]:
                v = f[g][name][()]
                out[f"{g}/{name}"] = v.decode() if isinstance(v, bytes) else np.asarray(v)
    return out


def _read_npz(path):
    with np.load(path) as z:
        return {k: (str(z[k]) if z[k].dtype.kind == "U" else z[k]) for k in z.files}


def test_export_matches_jax(setup, tmp_path):
    root, data, jcfg, jmodel, params, _, _ = setup
    out = str(tmp_path / "h5")
    line = _export(setup, out, "h5")
    tag = "1_3_train_0_params.npz"
    pred = _read_h5(os.path.join(out, f"predictions_FinetuneModel_{tag}.h5"))
    emb = _read_h5(os.path.join(out, f"embeddings_FinetuneModel_{tag}.h5"))

    # the JAX side: its own dataset and loader, its model, its segmentation
    ds = JaxDataset(os.path.join(data, "train_0.tsv"), sample_rate=8000, min_sample_size=1612,
                    normalize=True, return_labels=True, unique_labels=jcfg.task.labels(),
                    use_focal_loss=True, conv_layers=jcfg.task.conv_layers())
    loader = JaxLoader(ds, target_len=CLIP, batch_size=BATCH, shuffle=False, train=False,
                       drop_last=False, num_workers=1, batch_multiple=1, use_native=False)
    md = FinetuneConfig().criterion()
    seen, n_batches, n_valid_total = set(), 0, 0
    for batch in loader:
        n_batches += 1
        res = jmodel.apply({"params": params}, jnp.asarray(batch["source"]))
        probs = np.asarray(jax.nn.sigmoid(res["encoder_out"].astype(jnp.float32)))
        taps = np.asarray(res["layer_results"])[1:3].astype(np.float32).mean(axis=0)
        n_valid = int(batch.get("n_valid", probs.shape[0]))
        n_valid_total += n_valid
        targets = batch["target"]
        for i, idx in enumerate(batch["id"].ravel()[:n_valid]):
            g = f"{int(idx):06.0f}"
            seen.add(g)
            assert pred[f"{g}/fname"] == emb[f"{g}/fname"] == ds.names[int(idx)]
            np.testing.assert_allclose(pred[f"{g}/likelihood"], probs[i], rtol=0, atol=TOL)
            np.testing.assert_array_equal(pred[f"{g}/target"], targets[i].astype(np.float32))
            np.testing.assert_array_equal(emb[f"{g}/target"], targets[i].astype(np.float32))
            np.testing.assert_allclose(emb[f"{g}/embedding"], taps[i], rtol=0, atol=TOL)
        # segmentation of the exported likelihoods through JAX's function
        ours = np.stack([pred[f"{int(idx):06.0f}/likelihood"] for idx in batch["id"].ravel()])
        seg_idx = [[jax_intervals(targets[b, :, c]) for c in range(targets.shape[-1])]
                   for b in range(targets.shape[0])]
        pr, ta, *_ = jax_segmented(targets, seg_idx, ours, md, 8000, CLIP, method="avg")
        pr, ta = (x.reshape(ours.shape[0], ours.shape[1], -1) for x in (pr, ta))
        for i, idx in enumerate(batch["id"].ravel()[:n_valid]):
            g = f"{int(idx):06.0f}"
            np.testing.assert_array_equal(pred[f"{g}/segmented_likelihood"],
                                          pr[i].astype(np.float32))
            np.testing.assert_array_equal(pred[f"{g}/segmented_target"],
                                          ta[i].astype(np.float32))
    assert n_batches >= 2 and n_valid_total == len(ds) == len(seen)
    assert {k.split("/")[0] for k in pred} == seen
    # the throughput line: real clips of every batch but the first
    assert line["clips_timed"] == n_valid_total - BATCH and line["devices"] == 1


def test_npz_output_equals_h5(setup, tmp_path):
    """--output-format npz writes the HDF5 groups and datasets, bit for bit;
    --use-softmax writes likelihood and target only."""
    _export(setup, str(tmp_path / "h5"), "h5")
    _export(setup, str(tmp_path / "npz"), "npz")
    for kind in ("predictions", "embeddings"):
        name = f"{kind}_FinetuneModel_1_3_train_0_params.npz"
        h5 = _read_h5(str(tmp_path / "h5" / f"{name}.h5"))
        npz = _read_npz(str(tmp_path / "npz" / f"{name}.npz"))
        assert h5.keys() == npz.keys()
        for k in h5:
            if isinstance(h5[k], str):
                assert h5[k] == npz[k]
            else:
                assert h5[k].dtype == npz[k].dtype
                np.testing.assert_array_equal(h5[k], npz[k])
    _export(setup, str(tmp_path / "soft"), "npz", "--use-softmax")
    soft = _read_npz(str(tmp_path / "soft" / "predictions_FinetuneModel_1_3_train_0_params"
                                              ".npz.npz"))
    names = {k.split("/")[1] for k in soft}
    assert names == {"fname", "likelihood", "target"}
    like = np.stack([v for k, v in sorted(soft.items()) if k.endswith("/likelihood")])
    np.testing.assert_allclose(like.sum(-1), 1.0, rtol=0, atol=1e-5)


def test_stratify_matches_jax():
    rng = np.random.default_rng(23)
    y = rng.random((40, 5)) < 0.3
    y[:, 4] = rng.random(40) < 0.05  # a rare label
    for test_size, seed in ((0.15, 42), (0.3, 7)):
        ours = stratify.multilabel_stratified_split(y, test_size, seed=seed)
        ref = jax_stratify.multilabel_stratified_split(y, test_size, seed=seed)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(stratify.multilabel_stratified_kfold(y, 3, 0.2, seed=1),
                    jax_stratify.multilabel_stratified_kfold(y, 3, 0.2, seed=1)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _tree(path):
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            out[os.path.relpath(full, path)] = full
    return out


def test_manifest_cli_matches_jax(tmp_path):
    """The same tsv files (pretrain, folds, few-shot subsets, leave-p-out)
    from the same tree of wav and h5 label files, some unlabeled."""
    root = generate(str(tmp_path / "data"), n_clips=14, clip_seconds=0.25, seed=24,
                    splits=False)
    wavs = sorted(_tree(os.path.join(root, "wav")).values())
    for w in wavs[:3]:  # unlabeled clips
        os.remove(w.replace(f"{os.sep}wav{os.sep}", f"{os.sep}lbl{os.sep}")[:-3] + "h5")
    argv = ["--root", root, "--valid-percent", "0.3", "--n-split", "2", "--few-shot",
            "--leave-p-out", "--seed", "5"]
    manifest_cli.main(argv + ["--dest", str(tmp_path / "ours")])
    jax_manifest_cli.main(argv + ["--dest", str(tmp_path / "theirs")])
    ours, theirs = _tree(tmp_path / "ours"), _tree(tmp_path / "theirs")
    assert ours.keys() == theirs.keys() and "train_1_few_4.tsv" in ours
    for k in ours:
        assert open(ours[k]).read() == open(theirs[k]).read(), k


def test_prepare_data_cli_matches_jax(tmp_path):
    """Two recordings (one at 16 kHz, resampled; one stereo) cut into 1-s
    segments with their labels: the same wav and h5 files."""
    rng = np.random.default_rng(25)
    recs = tmp_path / "recs"
    recs.mkdir()
    write_wav(str(recs / "rec_a.wav"), (0.1 * rng.normal(size=16000 * 3)).astype(np.float32),
              16000)
    write_wav(str(recs / "rec_b.wav"), (0.1 * rng.normal(size=(8000 * 2 + 500, 2)))
              .astype(np.float32), 8000)
    table = tmp_path / "labels.csv"
    table.write_text("AudioFile,StartRelative,EndRelative,Name,Focal\n"
                     "rec_a.wav,0.2,0.6,beep,focal\nrec_a.wav,0.9,1.4,cc,\n"
                     "rec_b.wav,1.5,1.7,sn,focal\n")
    argv = ["--input-folder", str(recs), "--labels", str(table), "--unique-labels",
            str(DEFAULT_LABELS), "--segment-length", "1", "--workers", "1"]
    prepare_data_cli.main(argv + ["--output-folder", str(tmp_path / "ours")])
    jax_prepare_data_cli.main(argv + ["--output-folder", str(tmp_path / "theirs")])
    ours, theirs = _tree(tmp_path / "ours"), _tree(tmp_path / "theirs")
    assert ours.keys() == theirs.keys() and len(ours) == 10
    for k in ours:
        if k.endswith(".h5"):
            assert _read_flat_h5(ours[k]).keys() == _read_flat_h5(theirs[k]).keys()
            for name, v in _read_flat_h5(ours[k]).items():
                np.testing.assert_array_equal(v, _read_flat_h5(theirs[k])[name])
        else:
            assert open(ours[k], "rb").read() == open(theirs[k], "rb").read(), k


def _read_flat_h5(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}
