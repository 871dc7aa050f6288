"""The port's data parallelism (``parallel/mesh.py``) against the JAX
package's "data" axis, on the CPU with gloo ranks.

* ``DistributedConfig`` against the JAX dataclass and the recipes; the
  layouts the port leaves out raise.
* The host-sharded ``BatchLoader`` yields JAX's batches for host counts 2
  and 3, train and eval, with length buckets and an uneven last eval group.
* One launch of 2 ranks (``tests/torch_dist_workers.py``) runs: a finetune
  step and a pretraining step on the two halves of a global batch, held
  against JAX's step on the whole batch laid over a 2-device virtual CPU
  mesh, within the train-step parity tests' PARAM_TOL (1e-6, every
  parameter and every EMA parameter) and LOSS_TOL (1e-5), with the
  parameter checksums of the ranks equal; a block with hash dropout at
  every site, whose masks on each rank are the global-row slice of the
  1-rank masks (bit for bit, so the two ranks' outputs differ on the same
  rows); validation of 3 clips split 2 + 1, equal to the 1-rank validation
  (the counts and the frame and segment reports; the loss is a mean of
  per-batch means, whose batches differ with the split); a pretraining run
  whose variance floors no run meets, in which both ranks raise
  ``CollapseError`` at the same step and neither hangs.
* ``train_cli`` with 2 gloo ranks: pretrain, finetune from it with a
  validation, resume; one checkpoint directory per save, with every rank's
  loader state; resuming under 1 rank raises.
* The recorded difference: mixup partners come from the rank's own rows.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import animal2vec_tpu.ops as jax_ops
import animal2vec_tpu.train.pretrain as jax_pretrain
from animal2vec_tpu.config import DistributedConfig as JaxDistributedConfig
from animal2vec_tpu.config import OptimizationConfig as JaxOptimizationConfig
from animal2vec_tpu.config import load_config
from animal2vec_tpu.data.dataset import BatchLoader as JaxLoader
from animal2vec_tpu.ops.mixup import bc_mixup as jax_bc_mixup
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model
from animal2vec_tpu.train.build import build_pretrain_model as jax_build_pretrain_model
from animal2vec_tpu.train.finetune_step import make_finetune_train_step as jax_finetune_step
from animal2vec_tpu.train.optim import build_optimizer as jax_build_optimizer
from animal2vec_tpu.train.state import FinetuneState as JaxFinetuneState
from animal2vec_tpu.train.state import PretrainState as JaxPretrainState

from animal2vec_tpu_torch.config import DistributedConfig, RunConfig, apply_overrides
from animal2vec_tpu_torch.data.dataset import BatchLoader
from animal2vec_tpu_torch.data.synthetic import generate
from animal2vec_tpu_torch.models.finetune import build_finetune_model
from animal2vec_tpu_torch.ops.mixup import bc_mixup
from animal2vec_tpu_torch.parallel import mesh
from animal2vec_tpu_torch.tools import train_cli
from animal2vec_tpu_torch.train import loop
from animal2vec_tpu_torch.train.checkpoint import CheckpointManager
from animal2vec_tpu_torch.train.finetune_step import make_finetune_eval_step
from animal2vec_tpu_torch.train.state import FinetuneState
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import _finetune_cfg
from tests.test_torch_data import LOADERS, _assert_same_batch, _datasets
from tests.test_torch_model import TINY, TINY_LAYERS, _jittered, _port_cfg
from tests.test_torch_pretrain_step import _jax_cfg as _jax_pretrain_cfg
from tests.test_torch_pretrain_step import _mask, _port_cfg as _port_pretrain_cfg
from tests.test_torch_pretrain_step import ACCUM
from tests.test_torch_train_step import LOSS_TOL, OPT, PARAM_TOL, _train_cfg
from tests.torch_dist_workers import NAMES, WAV, tiny_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
ROWS = 2  # per rank
ENV = {"OMP_NUM_THREADS": "1"}


# ----------------------------------------------------------- configuration


def test_distributed_config_matches_jax_and_refuses():
    ours, theirs = DistributedConfig(), JaxDistributedConfig()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    for recipe in ("finetune_100", "a2v_large_pretrain"):
        jcfg = load_config(os.path.join(REPO, f"animal2vec_tpu/configs/{recipe}.yaml"))
        assert getattr(RunConfig, recipe)().distributed == DistributedConfig(
            **{f.name: getattr(jcfg.distributed, f.name) for f in dataclasses.fields(ours)})
    run = apply_overrides(RunConfig.finetune_100(), ["distributed.data_parallel=2"])
    assert run.distributed.data_parallel == 2
    assert mesh.resolve_world(run.distributed, "cpu", "gloo") == 2
    assert mesh.resolve_world(DistributedConfig(), "cpu", "gloo") == 1
    # the sharded layouts are taken (tests/test_torch_parallel.py); the
    # layouts the port leaves out still raise naming ROADMAP A.10
    sharded = apply_overrides(run, ["distributed.model_parallel=2",
                                    "distributed.pipeline_parallel=2", "distributed.fsdp=True"])
    assert mesh.resolve_world(sharded.distributed, "cpu", "gloo") == 8
    for bad in (["distributed.model_parallel=2", "model.layer_norm_first=True"],
                ["distributed.fsdp=True", "model.matmul_impl=int8"]):
        with pytest.raises(NotImplementedError, match="A.10"):
            apply_overrides(run, bad)
    with pytest.raises(ValueError):
        apply_overrides(run, ["distributed.data_parallel=0"])
    with pytest.raises(ValueError, match="gloo"):
        mesh.resolve_world(run.distributed, "cpu", "nccl")


# ----------------------------------------------------------- host sharding


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Uniform 0.5-s clips and variable 0.2-1.0-s clips, npz labels."""
    root = tmp_path_factory.mktemp("corpus")
    fixed = generate(str(root / "fixed"), n_clips=11, clip_seconds=0.5, seed=5, label_ext="npz")
    var = generate(str(root / "var"), n_clips=14, clip_seconds=(0.2, 1.0), seed=6,
                   label_ext="npz")
    return fixed, var


@pytest.mark.parametrize("hosts", [2, 3])
@pytest.mark.parametrize("case", sorted(LOADERS))
def test_sharded_loader_matches_jax(corpus, case, hosts):
    which, split, train, kw, epochs = LOADERS[case]
    ds, jds = _datasets(corpus[0] if which == "fixed" else corpus[1], split, train)
    for host in range(hosts):
        shard = dict(kw, host_index=host, host_count=hosts)
        loader = BatchLoader(ds, train=train, num_workers=1, use_native=False, **shard)
        jloader = JaxLoader(jds, train=train, num_workers=1, use_native=False, **shard)
        assert len(loader) == len(jloader)
        n = 0
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            assert loader.remaining() == len(loader._epoch_plan())
            for ours, theirs in zip(loader, jloader, strict=True):
                _assert_same_batch(ours, theirs)
                n += 1
        if not train:  # every host holds eval items, some more than others
            assert n > 0 and "n_valid" in ours


# ----------------------------------------------------------- two ranks


def _mesh_batch(batch):
    data = Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))
    return data, {k: jax.device_put(jnp.asarray(v), NamedSharding(data, P(None, "data")))
                  for k, v in batch.items()}


def _jax_finetune_init():
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3, **TINY)
    jcfg.optimization = JaxOptimizationConfig(**OPT)
    jcfg.finetune.freeze_finetune_updates = 0
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, WAV)))["params"]
    return jcfg, jmodel, _jittered(params, seed=1)


def _jax_finetune_step(jcfg, jmodel, params, batch):
    """JAX's finetune step on the global batch over a 2-device mesh."""
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    data, sharded = _mesh_batch(batch)
    with data:
        jstate, jmetrics = jax.jit(jax_finetune_step(jmodel, jcfg))(
            JaxFinetuneState.create(params, tx), sharded, jax.random.PRNGKey(3))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)), jmetrics


def _jax_pretrain_init():
    jcfg = _jax_pretrain_cfg("AUDIO")
    jmodel = jax_build_pretrain_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "mask_noise": jax.random.fold_in(key, 1)},
                         jnp.zeros((1, WAV)), "AUDIO")["params"]
    return jcfg, jmodel, _jittered(params, seed=1)


def _jax_pretrain_step(jcfg, jmodel, params, batch, mask):
    """JAX's pretraining step on the global batch over a 2-device mesh, its
    mask samplers replaced by ``mask``."""
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    fixed = lambda *args, **kw: jnp.asarray(mask)  # noqa: E731
    data, sharded = _mesh_batch(batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pretrain, "span_mask", fixed)
        mp.setattr(jax_ops, "block_mask_2d", fixed)
        with data:
            jnew, jmetrics = jax.jit(jax_pretrain.make_pretrain_train_step(jmodel, jcfg))(
                JaxPretrainState.create(params, tx, jcfg.model), sharded,
                jax.random.PRNGKey(3))
    tree = lambda t: params_from_jax(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return tree(jnew.params), tree(jnew.ema_params), jmetrics


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One launch of 2 gloo ranks running every scenario, while this
    process computes JAX's references; returns (references, the ranks'
    results)."""
    from animal2vec_tpu_torch.train.pretrain import mask_tokens

    out = tmp_path_factory.mktemp("two_ranks")
    rng = np.random.default_rng(21)
    n = RANKS * ROWS
    ft_batch = {"source": rng.normal(size=(2, n, WAV)).astype(np.float32),
                "target": (rng.random((2, n, 200, 4)) < 0.1).astype(np.float32)}
    pcfg = _port_pretrain_cfg("AUDIO")
    pt_batch = {"source": rng.normal(size=(ACCUM, n, WAV)).astype(np.float32)}
    pt_mask = _mask(n * pcfg.clone_batch, 200, mask_tokens(pcfg, 200), seed=22)
    ft = _jax_finetune_init()
    pt = _jax_pretrain_init()
    data = generate(str(out / "data"), n_clips=12, clip_seconds=WAV / 8000, labels=NAMES,
                    seed=11)
    inputs = {
        "ft_cfg": _port_cfg(ft[0], TINY_LAYERS, **TINY), "ft_train": _train_cfg(0),
        "ft_params": params_from_jax(ft[2]),
        "ft_batch": {k: torch.from_numpy(v) for k, v in ft_batch.items()},
        "pt_cfg": pcfg, "pt_params": params_from_jax(pt[2]),
        "pt_mask": torch.from_numpy(pt_mask),
        "pt_batch": {k: torch.from_numpy(v) for k, v in pt_batch.items()},
        "val_train": _train_cfg(0), "val_data": data, "ring": _ring_inputs(),
    }
    torch.save(inputs, out / "inputs.pt")
    failed = []

    def ranks():
        try:
            mesh.launch(["-m", "tests.torch_dist_workers",
                         "finetune_step,pretrain_step,masks,validation,collapse,ring", str(out)],
                        RANKS, env=ENV, timeout=300)
        except Exception as e:  # raised below, in the test's thread
            failed.append(e)

    worker = threading.Thread(target=ranks)
    worker.start()
    try:
        refs = {"ft": _jax_finetune_step(*ft, ft_batch),
                "pt": _jax_pretrain_step(*pt, pt_batch, pt_mask),
                "data": data, "inputs": inputs}
    finally:
        worker.join()
    if failed:
        raise failed[0]
    return refs, [torch.load(out / f"result_{r}.pt", weights_only=False) for r in range(RANKS)]


def _ring_inputs():
    rng = np.random.default_rng(31)
    b, t, h, d = 1, 256, 2, 8
    qkv = [torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32)) for _ in range(3)]
    return {"q": qkv[0], "k": qkv[1], "v": qkv[2],
            "slopes": torch.tensor([0.5, 0.125]),
            "pos": torch.arange(t, dtype=torch.int32)[None].expand(b, t).contiguous(),
            "pad": (torch.arange(t) >= 200)[None].expand(b, t).contiguous()}


def _close(ours, ref, tol):
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), rtol=0, atol=tol,
                                   err_msg=name)


def test_two_rank_finetune_step_matches_jax(two_ranks):
    refs, results = two_ranks
    ft_ref, jmetrics = refs["ft"]
    r0, r1 = (r["finetune_step"] for r in results)
    assert r0["checksum"] == r1["checksum"]
    _close(r0["params"], ft_ref, PARAM_TOL)
    assert abs(r0["metrics"]["loss"] - float(jmetrics["loss"])) <= LOSS_TOL
    for key in ("sample_size", "finetune/tp", "finetune/fp", "finetune/tn", "finetune/fn"):
        assert r0["metrics"][key] == r1["metrics"][key] == float(jmetrics[key]), key


def test_two_rank_pretrain_step_matches_jax(two_ranks):
    refs, results = two_ranks
    pt_ref, ema_ref, jmetrics = refs["pt"]
    r0, r1 = (r["pretrain_step"] for r in results)
    # every rank's student, and so its EMA teacher, is the same after the step
    assert r0["checksum"] == r1["checksum"]
    _close(r0["params"], pt_ref, PARAM_TOL)
    _close(r0["ema"], ema_ref, PARAM_TOL)
    assert abs(r0["metrics"]["loss"] - float(jmetrics["loss"])) <= LOSS_TOL
    assert r0["metrics"]["sample_size"] == float(jmetrics["sample_size"])


def test_hash_masks_are_global_rows(two_ranks):
    _, results = two_ranks
    ref = results[0]["masks"]["ref"]
    ys = [r["masks"]["y"] for r in results]
    assert not torch.equal(ys[0], ys[1])  # same rows, different global rows
    for r, y in enumerate(ys):
        assert torch.equal(y, ref[r * len(y):(r + 1) * len(y)]), r


def test_two_rank_validation_equals_one_rank(two_ranks, tmp_path):
    refs, results = two_ranks
    run = tiny_run(refs["inputs"]["val_train"], refs["data"], str(tmp_path))
    model = build_finetune_model(run.model, seed=0, device="cpu", train=run.finetune)
    state = FinetuneState.create(model, run.finetune)
    one = loop.validate_finetune(run, state, make_finetune_eval_step(run.finetune),
                                 loop._NullSink(), 2, torch.device("cpu"))
    for res in results:
        two = dict(res["validation"]["valid"])
        assert two.keys() == one.keys() and "valid/segmented_mAP" in two
        for key, want in one.items():
            if key in ("ups", "loss"):  # a rate, and a mean over differing batches
                continue
            if np.isnan(want):
                assert np.isnan(two[key]), key
            else:
                assert two[key] == pytest.approx(want, rel=1e-12, abs=1e-12), key
        assert np.isfinite(two["loss"])
    same = [{k: v for k, v in r["validation"]["valid"].items() if k != "ups"} for r in results]
    assert same[0] == same[1]


def test_collapse_stops_every_rank_at_one_step(two_ranks):
    _, results = two_ranks
    steps = [r["collapse"]["collapsed_at"] for r in results]
    assert steps[0] is not None and steps == [steps[0]] * RANKS
    assert results[0]["collapse"]["error"] == results[1]["collapse"]["error"]


def test_two_rank_ring_matches_jax(two_ranks):
    from tests.test_torch_ring_attention import jax_ring

    _, results = two_ranks
    inp = results[0]["ring"]["ring"]
    want = jax_ring(two_ranks[0]["inputs"]["ring"], RANKS)
    np.testing.assert_allclose(inp.numpy()[:, :200], want[:, :200], rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------- the CLI


def test_train_cli_two_ranks_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = generate(str(tmp_path / "data"), n_clips=12, clip_seconds=WAV / 8000, labels=NAMES,
                    seed=12, label_ext="npz")
    model = [f"{k}={v}" for k, v in TINY.items()] + [
        f"conv_layers={TINY_LAYERS}", "average_top_k_layers=3"]
    common = ["common.compute_dtype=float32", "common.tensorboard_logdir=",
              "dataset.batch_size=2", "dataset.num_workers=1", f"task.max_sample_size={WAV}",
              "task.label_ext=npz"]
    train_cli.main(["--recipe", "a2v_large_pretrain", "--data", data, "--save-dir",
                    str(tmp_path / "pre"), "--max-steps", "1", "--device", "cpu",
                    "distributed.data_parallel=2", *common, *[f"pretrain.model.{m}" for m in model],
                    "pretrain.average_top_k_layers=3", "pretrain.clone_batch=2",
                    "pretrain.decoder.decoder_dim=16", "pretrain.decoder.decoder_groups=4",
                    "pretrain.decoder.decoder_kernel=3", "pretrain.decoder.decoder_layers=2",
                    "pretrain.optimization.update_freq=1"])
    pre = CheckpointManager(str(tmp_path / "pre"))
    assert pre.all_steps() == [1]
    finetune = [
        "--recipe", "finetune_100", "--data", data, "--save-dir", str(tmp_path / "ft"),
        "--pretrained", str(tmp_path / "pre"), "--device", "cpu", *common,
        *[f"model.{m}" for m in model],
        f"model.labels={NAMES}", "task.min_sample_size=1", "task.min_label_size=0",
        "finetune.optimization.update_freq=1", "finetune.freeze_finetune_updates=0",
        "finetune.mask_channel_length=4", "dataset.validate_after_updates=0",
        "dataset.validate_interval_updates=2"]
    train_cli.main(["--max-steps", "2", *finetune, "distributed.data_parallel=2"])
    ft = CheckpointManager(str(tmp_path / "ft"))
    assert ft.all_steps() == [2] and os.path.islink(tmp_path / "ft" / "best")
    saved = ft.load()["extra"]
    assert saved["world_size"] == 2 and len(saved["loaders"]) == 2
    train_cli.main(["--max-steps", "3", *finetune, "distributed.data_parallel=2"])
    assert ft.all_steps() == [2, 3]
    resumed = ft.load()
    assert resumed["step"] == 3 and resumed["optimizer"]["count"] == 3
    assert resumed["extra"]["loaders"][0]["position"] == resumed["extra"]["loaders"][1][
        "position"]
    with pytest.raises(ValueError, match="written by 2 rank"):
        train_cli.main(["--max-steps", "4", *finetune, "distributed.data_parallel=1"])


# ----------------------------------------------------------- differences


def test_mixup_partners_stay_on_the_rank():
    """Recorded difference: JAX's ``bc_mixup`` permutes the global batch
    over its mesh, so a row's partner may be any row; on a rank the
    permutation is of the rank's rows, so a partner is one of its own."""
    n = 8
    ident = np.eye(n, dtype=np.float32)[:, None, :]  # row i's target marks column i
    src = np.random.default_rng(0).normal(size=(n, 400)).astype(np.float32)
    args = (0.3, 1.0, True, "none", 8000, 0.05, True)
    _, jt = jax_bc_mixup(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(ident), *args)
    jt = np.asarray(jt)[:, 0]
    half = lambda c: c >= n // 2  # noqa: E731
    assert any(half(c) != half(i) for i in range(n) for c in np.flatnonzero(jt[i]))
    gen = torch.Generator().manual_seed(0)
    for rank in range(2):
        rows = slice(rank * n // 2, (rank + 1) * n // 2)
        _, t = bc_mixup(torch.from_numpy(src[rows]), torch.from_numpy(ident[rows]), *args, gen)
        used = np.flatnonzero(t.numpy().sum(axis=(0, 1)))
        assert set(used) <= set(range(n)[rows])
