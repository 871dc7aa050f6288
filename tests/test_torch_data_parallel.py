"""Data-parallel serving (``parallel/serving.py``): the port of
``tests/test_data_parallel_serving.py`` on CPU devices.

The split and the gather are held on 1, 2 and 3 CPU "devices" (each a
replica on the CPU, served in turn): the probabilities of a padded batch
equal the one-device run's within 1e-6 (DP_TOL: the CPU's GEMMs may block
a shard of another row count differently), and ``infer_long_file`` gives
the same events. The helpers behave as the JAX ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.data.wavio import write_wav
from animal2vec_tpu_torch.models.finetune import build_finetune_model
from animal2vec_tpu_torch.parallel.serving import DataParallelServing, gather
from animal2vec_tpu_torch.tools.infer_cli import infer_long_file, sigmoid_probabilities

DP_TOL = 1e-6
CPU3 = ["cpu"] * 3
CFG = dataclasses.replace(
    FinetuneConfig(), embed_dim=32, num_heads=4, depth=2, prenet_depth=1, conv_pos_depth=2,
    conv_pos_width=10, conv_pos_groups=2, average_top_k_layers=2, max_sample_size=8000,
    conv_layers=((9, 7, 1), (16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' ops are too small for intra-op threads, which only
    spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_finetune_model(CFG, seed=3, device="cpu")


def _dp(n):
    return DataParallelServing(torch.nn.Linear(2, 2), n_devices=n, devices=["cpu"] * 4)


def test_round_batch():
    dp = _dp(4)
    assert [dp.round_batch(b) for b in (1, 4, 5, 12)] == [4, 4, 8, 12]


def test_floor_batch():
    """User batch sizes are memory caps: floored to a device multiple, never
    exceeded (except the one-row-per-device minimum)."""
    dp = _dp(4)
    assert [dp.floor_batch(b) for b in (12, 13, 7, 2)] == [12, 12, 4, 4]


def test_pad_and_shard():
    dp = _dp(4)
    x = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    shards, n_valid = dp.pad_and_shard(x)
    assert n_valid == 6 and [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    out = torch.cat(shards).numpy()
    np.testing.assert_array_equal(out[:6], x)
    assert (out[6:] == 0).all()


def test_shard_rejects_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        _dp(4).shard(np.zeros((6, 3), np.float32))


def test_device_count_errors():
    with pytest.raises(ValueError, match="visible"):
        DataParallelServing(torch.nn.Linear(2, 2), n_devices=4, devices=CPU3)
    with pytest.raises(ValueError, match="n_devices=0"):
        DataParallelServing(torch.nn.Linear(2, 2), n_devices=0, devices=CPU3)
    if not torch.cuda.is_available():  # the default is the CUDA devices
        with pytest.raises(RuntimeError, match="CUDA"):
            DataParallelServing(torch.nn.Linear(2, 2))


def test_gather_keeps_structure_and_row_order():
    parts = [(torch.full((2, 1), float(i)), [torch.full((2,), 10.0 * i)]) for i in range(3)]
    a, (b,) = gather(parts)
    np.testing.assert_array_equal(a[:, 0].numpy(), [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(b.numpy(), [0, 0, 10, 10, 20, 20])


@pytest.mark.parametrize("n", [2, 3])
def test_probs_match_one_device_with_padded_tail(model, n):
    """5 windows over n devices (the tail zero-padded to a multiple of n)
    give the one-device probabilities; the padded rows are dropped."""
    src = np.random.default_rng(40).normal(size=(5, 8000)).astype(np.float32)
    one = DataParallelServing(model, 1, devices=["cpu"])
    want = one.run(sigmoid_probabilities, one.shard(src)).numpy()
    dp = DataParallelServing(model, -1, devices=["cpu"] * n)
    assert dp.n_devices == n
    shards, n_valid = dp.pad_and_shard(src)
    assert n_valid == 5 and sum(s.shape[0] for s in shards) == dp.round_batch(5)
    got = dp.run(sigmoid_probabilities, shards).numpy()[:n_valid]
    assert got.shape == want.shape == (5, 200, len(CFG.labels))
    np.testing.assert_allclose(got, want, rtol=0, atol=DP_TOL)


@pytest.mark.parametrize("n", [2, 3])
def test_infer_long_file_events_do_not_depend_on_devices(model, tmp_path, n):
    """A 7-window recording at batch cap 6 (a multiple of every device
    count, so the windows group alike): over n devices the last window is
    padded to n rows; the events equal one device's."""
    rng = np.random.default_rng(41)
    t = np.arange(7 * 8000) / 8000
    wav = 0.05 * rng.normal(size=t.size)
    wav[(t % 2.0) < 0.3] += 0.5
    path = str(tmp_path / "rec.wav")
    write_wav(path, wav.astype(np.float32), 8000)
    kw = dict(max_batch_size=6, segment_length=1.0, device=torch.device("cpu"))
    one = infer_long_file(path, model, CFG, data_parallel=1, **kw)
    many = infer_long_file(path, model, CFG, data_parallel=-1, devices=["cpu"] * n, **kw)
    assert sum(len(v) for v in one.values()) > 0
    assert one.keys() == many.keys()
    for name in one:
        assert len(one[name]) == len(many[name])
        for a, b in zip(one[name], many[name]):
            assert a["onset_s"] == b["onset_s"] and a["offset_s"] == b["offset_s"]
            assert abs(a["likelihood"] - b["likelihood"]) <= 1e-4  # 4-decimal rounding
