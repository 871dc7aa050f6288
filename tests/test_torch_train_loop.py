"""The port's training entry point against the JAX package's: the run
presets, checkpoints, the pretrain -> finetune handoff, ``run_finetune``
against JAX's on one synthetic directory, resume, and the CLI chain
(pretrain -> finetune from it -> serve the best checkpoint).

The loop-level case runs the tiny config of ``tests/test_torch_train_step.py``
(embed 128, 4 heads, 2 + 3 blocks) with every rate at 0, mixup and masks off,
on 800-sample clips: 3 steps of update_freq 2 x b2 with validation at step
2, both sides from JAX's initial weights. Every final parameter agrees
within 3 x that test's PARAM_TOL, the logged losses within 1e-5, the
validation's confusion counts exactly and its other numbers within 1e-5.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import animal2vec_tpu.train.loop as jax_loop
from animal2vec_tpu.config import OptimizationConfig as JaxOptimizationConfig
from animal2vec_tpu.config import load_config
from animal2vec_tpu.train.build import build_finetune_encoder_cfg as jax_build_encoder_cfg
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model
from animal2vec_tpu.train.build import build_pretrain_model as jax_build_pretrain_model
from animal2vec_tpu.train.build import load_pretrained_into_finetune as jax_load_pretrained
from animal2vec_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager

import animal2vec_tpu_torch.train.loop as loop
from animal2vec_tpu_torch.config import (
    CheckpointConfig, CommonConfig, DatasetConfig, FinetuneConfig, FinetuneTrainConfig,
    OptimizationConfig, PretrainConfig, RunConfig, SegmentationConfig, TaskConfig,
    apply_overrides,
)
from animal2vec_tpu_torch.data.synthetic import generate
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.tools import infer_cli, train_cli
from animal2vec_tpu_torch.train.build import (
    build_finetune_encoder_cfg, init_finetune, init_pretrain, load_pretrained_into_finetune,
)
from animal2vec_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint_dir
from animal2vec_tpu_torch.train.finetune_step import make_finetune_train_step
from animal2vec_tpu_torch.train.pretrain import make_pretrain_train_step
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import LABELS, _finetune_cfg
from tests.test_torch_model import TINY, TINY_LAYERS, _port_cfg
from tests.test_torch_pretrain_step import _jax_cfg as _jax_pretrain_cfg
from tests.test_torch_pretrain_step import _port_cfg as _port_pretrain_cfg
from tests.test_torch_train_step import OPT, PARAM_TOL, _train_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_PARAM_TOL = 3 * PARAM_TOL
LOSS_TOL = 1e-5
VALID_TOL = 1e-5
COUNTS = ("finetune/tp", "finetune/fp", "finetune/tn", "finetune/fn")
NAMES = tuple(eval(LABELS))  # the tiny config's labels, 'focal' last
WAV = 800


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' ops are too small for intra-op threads, which only
    spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- the run config


@pytest.mark.parametrize("recipe", ["finetune_100", "a2v_large_pretrain"])
def test_run_presets_match_yaml(recipe):
    jcfg = load_config(os.path.join(REPO, f"animal2vec_tpu/configs/{recipe}.yaml"))
    run = getattr(RunConfig, recipe)()
    for group in ("common", "task", "dataset", "checkpoint"):
        ours, theirs = getattr(run, group), getattr(jcfg, group)
        for f in dataclasses.fields(ours):
            want = getattr(theirs, f.name, "h5" if f.name == "label_ext" else None)
            if f.name == "bucket_lengths":
                want = tuple(theirs.buckets())
            assert getattr(ours, f.name) == want, f"{group}.{f.name}"
    assert run.criterion == SegmentationConfig(jcfg.criterion.segmentation_metrics,
                                               jcfg.criterion.method)
    for name in ("stop_time_hours", "stop_min_lr"):
        assert getattr(run.optimization, name) == getattr(jcfg.optimization, name)
    assert (run.finetune is None) == (jcfg.finetune is None)
    if run.finetune is not None:
        assert run.model == FinetuneConfig() and run.finetune == FinetuneTrainConfig()
    else:
        assert run.pretrain == PretrainConfig() and run.model is None


def test_overrides_and_refusals():
    run = apply_overrides(RunConfig.finetune_100(), [
        "dataset.batch_size=4", "task.max_sample_size=80000", "task.label_ext=npz",
        "finetune.optimization.update_freq=1", "model.depth=4", "model.average_top_k_layers=4",
        "dataset.bucket_lengths=[8000, 16000]", "common.tensorboard_logdir="])
    assert (run.dataset.batch_size, run.task.max_sample_size, run.task.label_ext,
            run.optimization.update_freq, run.model.depth, run.dataset.bucket_lengths,
            run.common.tensorboard_logdir) == (4, 80000, "npz", 1, 4, (8000, 16000), "")
    for bad in ("nope=1", "dataset.nope=2", "dataset", "dataset.max_tokens.x=3"):
        with pytest.raises(ValueError):
            apply_overrides(run, [bad])
    with pytest.raises(ValueError):  # k > depth
        apply_overrides(run, ["model.depth=2"])
    with pytest.raises(ValueError):
        RunConfig(model=FinetuneConfig())
    with pytest.raises(NotImplementedError):
        RunConfig(pretrain=PretrainConfig.vit_b16())
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the refusal is not reachable here")
        loop.run_finetune(RunConfig.finetune_100())
    # --pretrained <fairseq .pt> warm-starts (formerly refused): see
    # test_pretrained_fairseq_pt_equals_the_convert_cli_route


@pytest.fixture(scope="module")
def fairseq_pt(tmp_path_factory):
    """A fairseq-named pretraining ``.pt`` built with JAX's
    ``export_pretrain`` from jittered tiny params and saved with an
    unimportable ``cfg`` class, its ``_ema.*`` trunk at half the student's;
    returns (path, state dict, EMA dict)."""
    import jax.numpy as jnp

    from animal2vec_tpu.models.data2vec2 import Data2VecMulti as JaxData2VecMulti
    from animal2vec_tpu.train.convert import export_pretrain as jax_export_pretrain

    from tests.test_models import tiny_model_cfg
    from tests.test_torch_convert import _save_with_unimportable_cfg
    from tests.test_torch_model import _jittered

    jcfg = tiny_model_cfg()
    params = JaxData2VecMulti(cfg=jcfg).init(
        {"params": jax.random.PRNGKey(0), "mask_noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, WAV)))["params"]
    sd = jax_export_pretrain(_jittered(params, seed=34), jcfg)
    teacher = {k: v * 0.5 for k, v in sd.items() if k.startswith("blocks.")}
    pt = str(tmp_path_factory.mktemp("fairseq") / "model.pt")
    _save_with_unimportable_cfg(pt, {**{k: torch.tensor(v) for k, v in sd.items()},
                                     **{f"_ema.{k}": torch.tensor(v) for k, v in teacher.items()}})
    return pt, sd, teacher


@pytest.mark.parametrize("load_ema", [False, True])
def test_pretrained_fairseq_pt_equals_the_convert_cli_route(fairseq_pt, tmp_path, load_ema):
    """``train_cli --pretrained <fairseq .pt>`` (``load_pretrained``, JAX's
    ``_load_pretrained``): the student state dict that a ``.pt`` gives
    equals the checkpoint directory that ``convert_cli import --kind
    pretrain`` writes, read by the directory route, on every tensor; both
    warm-start the same finetune model. With ``finetune.load_ema`` the
    file's ``_ema.*`` weights take the student's place where present."""
    from animal2vec_tpu_torch.tools import convert_cli

    from tests.test_torch_convert import TINY_PRETRAIN, _overrides, _save_with_unimportable_cfg

    pt, sd, teacher = fairseq_pt
    model = TINY_PRETRAIN.model
    run = dataclasses.replace(
        RunConfig.finetune_100(), model=dataclasses.replace(model, labels=NAMES),
        finetune=dataclasses.replace(FinetuneTrainConfig(), load_ema=load_ema))
    got = train_cli.load_pretrained(pt, run)
    ema_pt = pt
    if load_ema:  # the directory route of the EMA weights: a .pt holding them as the student
        ema_pt = str(tmp_path / "ema.pt")
        _save_with_unimportable_cfg(ema_pt, {k: torch.tensor(teacher.get(k, v))
                                             for k, v in sd.items()})
    out = str(tmp_path / "converted")
    over = [f"model.{o}" for o in _overrides(model)] + [
        "decoder.decoder_dim=12", "decoder.decoder_groups=4", "decoder.decoder_kernel=3",
        "decoder.decoder_layers=2", "average_top_k_layers=2"]
    assert convert_cli.main(["import", "--pt", ema_pt, "--out", out, "--kind", "pretrain",
                             *over]) == 0
    want = train_cli.load_pretrained(out, run)
    assert got and set(got) <= set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    plain = train_cli.load_pretrained(pt, dataclasses.replace(
        run, finetune=dataclasses.replace(run.finetune, load_ema=False)))
    name = "blocks.layers.0.mlp.fc1.weight"  # a teacher tensor: halved in _ema
    assert torch.equal(got[name], plain[name] * 0.5 if load_ema else plain[name])
    _, a = init_finetune(run, "cpu", pretrained=got)
    _, b = init_finetune(run, "cpu", pretrained=want)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_stoppers_match_jax():
    """EarlyStopper, RunStopper's lr floor and the collapse kill switch
    decide as the JAX loop's do."""
    values = [0.1, 0.3, 0.2, 0.3, 0.25, 0.4, 0.1, 0.1, 0.1]
    for patience, maximize in ((0, True), (1, True), (2, False)):
        ours, theirs = loop.EarlyStopper(patience, maximize), jax_loop.EarlyStopper(patience,
                                                                                  maximize)
        assert [ours.should_stop(v) for v in values] == [theirs.should_stop(v) for v in values]
    opt = dict(lr=1e-4, max_update=100, warmup_updates=10, warmup_init_lr=0.0, min_lr=0.0,
               stop_min_lr=2e-5)
    jcfg = load_config()
    jcfg.optimization = JaxOptimizationConfig(**opt)
    ours, theirs = loop.RunStopper(OptimizationConfig(**opt), 90), jax_loop.RunStopper(jcfg, 90)
    decided = [(ours.should_stop(s), theirs.should_stop(s)) for s in range(0, 101, 3)]
    assert [a is None for a, _ in decided] == [b is None for _, b in decided]
    assert any(a for a, _ in decided) and decided[0] == (None, None)
    loop._check_collapse(5000, {"target_var": 0.0})
    with pytest.raises(loop.CollapseError):
        loop._check_collapse(5001, {"target_var": 0.05})
    with pytest.raises(loop.CollapseError):
        loop._check_collapse(6000, {"target_var": 1.0, "pred_var_1": 0.001})


# ----------------------------------------------------------- checkpoints


def _tiny_finetune_run(tmp, data="", **changes):
    model = FinetuneConfig(conv_layers=TINY_LAYERS, average_top_k_layers=3, labels=NAMES,
                           max_sample_size=WAV, metric_threshold=0.25, **TINY)
    run = RunConfig(
        model=model, finetune=_train_cfg(0),
        common=CommonConfig(compute_dtype="float32", log_interval=1),
        task=TaskConfig(data=data, with_labels=True, max_sample_size=WAV,
                        verbose_tensorboard_logging=True),
        dataset=DatasetConfig(batch_size=2, num_workers=2, train_subset="train_0",
                              validate_interval_updates=2, validate_after_updates=0),
        checkpoint=CheckpointConfig(save_dir=str(tmp), save_interval_updates=1000),
        criterion=SegmentationConfig(segmentation_metrics=True),
    )
    return dataclasses.replace(run, **changes)


def _tiny_pretrain_run(tmp, data=""):
    return RunConfig(pretrain=_port_pretrain_cfg("AUDIO"),
                     common=CommonConfig(compute_dtype="float32", log_interval=1),
                     task=TaskConfig(data=data, max_sample_size=WAV),
                     dataset=DatasetConfig(batch_size=2, num_workers=2, disable_validation=True),
                     checkpoint=CheckpointConfig(save_dir=str(tmp), save_interval_updates=1000))


def _step_batch(seed, labels):
    rng = np.random.default_rng(seed)
    batch = {"source": torch.from_numpy(rng.normal(size=(2, 2, WAV)).astype(np.float32))}
    if labels:
        batch["target"] = torch.from_numpy((rng.random((2, 2, 200, len(NAMES))) < 0.1)
                                           .astype(np.int64))
    return batch


def _same_state(a, b):
    for x, y in ((a.model.state_dict(), b.model.state_dict()),
                 (getattr(a, "ema", None) or {}, getattr(b, "ema", None) or {})):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    sa = {g["name"]: a.optimizer.state.get(g["params"][0]) for g in a.optimizer.param_groups}
    sb = {g["name"]: b.optimizer.state.get(g["params"][0]) for g in b.optimizer.param_groups}
    assert sa.keys() == sb.keys()
    for k in sa:
        assert (sa[k] is None) == (sb[k] is None), k
        if sa[k] is not None:
            assert torch.equal(sa[k]["mu"], sb[k]["mu"]) and torch.equal(sa[k]["nu"], sb[k]["nu"])


@pytest.mark.parametrize("kind", ["finetune", "pretrain"])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, kind):
    if kind == "finetune":
        run = _tiny_finetune_run(tmp_path)
        init, step_fn = (lambda: init_finetune(run, "cpu")), make_finetune_train_step(run.finetune)
    else:
        run = _tiny_pretrain_run(tmp_path)
        init, step_fn = (lambda: init_pretrain(run, "cpu")), make_pretrain_train_step(run.pretrain)
    _, state = init()
    state.step = 50  # past the pretraining warmup: the teacher moves
    rngs = Rngs.from_seed(3, "cpu")
    for i in range(2):
        step_fn(state, _step_batch(i, kind == "finetune"), rngs)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=2)
    mgr.save(state.step, state, extra={"loader": {"epoch": 3, "position": 5}})
    mgr.wait()
    _, fresh = init()
    assert not torch.equal(fresh.model.state_dict()["proj.weight" if kind == "finetune"
                                                    else "blocks.layers.0.mlp.fc1.weight"],
                           state.model.state_dict()["proj.weight" if kind == "finetune"
                                                    else "blocks.layers.0.mlp.fc1.weight"])
    extra = CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    assert extra == {"loader": {"epoch": 3, "position": 5}}
    _same_state(fresh, state)
    # one more step from each gives the same state again
    step_fn(state, _step_batch(7, kind == "finetune"), Rngs.from_seed(9, "cpu"))
    step_fn(fresh, _step_batch(7, kind == "finetune"), Rngs.from_seed(9, "cpu"))
    _same_state(fresh, state)


def test_checkpoint_rotation_keeps_best(tmp_path):
    run = _tiny_finetune_run(tmp_path)
    _, state = init_finetune(run, "cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=2, best_metric="f1")
    for step, f1 in ((1, 0.5), (2, 0.9), (3, 0.1), (4, 0.2), (5, 0.3)):
        state.step = step
        mgr.save(step, state, metrics={"f1": f1})
    mgr.wait()
    assert mgr.all_steps() == [2, 4, 5] and mgr.latest_step() == 5
    assert os.path.realpath(tmp_path / "ck" / "best") == os.path.realpath(
        tmp_path / "ck" / "step_0000000002")
    assert json.loads((tmp_path / "ck" / "meta.json").read_text()) == {"best_value": 0.9}
    assert load_checkpoint_dir(str(tmp_path / "ck" / "best"))["step"] == 2
    assert load_checkpoint_dir(str(tmp_path / "ck"))["step"] == 5
    again = CheckpointManager(str(tmp_path / "ck"), keep_last=2, best_metric="f1")
    state.step = 6
    again.save(6, state, metrics={"f1": 0.8})  # not better than the kept 0.9
    again.wait()
    assert again.all_steps() == [2, 5, 6]
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path / "ck"))


# ----------------------------------------------------------- the handoff


def test_pretrained_handoff_matches_jax():
    """JAX's load_pretrained_into_finetune on tiny JAX pretraining params,
    and the port's on params_from_jax of them, give the same finetune
    state dict; the decoders stay behind."""
    jpre_cfg = _jax_pretrain_cfg("AUDIO")
    jpre = jax_build_pretrain_model(jpre_cfg)
    src = jax.numpy.zeros((1, WAV))
    pre_params = jpre.init({"params": jax.random.PRNGKey(0),
                            "mask_noise": jax.random.PRNGKey(1)}, src)["params"]
    pre_params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.5, pre_params)
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3, **TINY)
    jft = jax_build_finetune_model(jcfg)
    ft_params = jax.tree_util.tree_map(
        np.asarray, jft.init({"params": jax.random.PRNGKey(2)}, src)["params"])
    want = params_from_jax(jax_load_pretrained(ft_params, pre_params, jcfg))
    pre_sd = params_from_jax(pre_params)
    got = load_pretrained_into_finetune(params_from_jax(ft_params), pre_sd)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(".decoder." in k for k in pre_sd) and not any(".decoder." in k for k in got)
    assert torch.equal(got["proj.weight"], params_from_jax(ft_params)["proj.weight"])
    with pytest.raises(ValueError, match="no pretrained"):
        load_pretrained_into_finetune(got, {"nothing": torch.zeros(1)})
    bad = dict(pre_sd, **{"blocks.layers.0.mlp.fc1.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape"):
        load_pretrained_into_finetune(got, bad)
    # the configuration: the encoder's architecture and mask noise come
    # from pretraining, as JAX's build_finetune_encoder_cfg keeps them
    pre = _port_pretrain_cfg("AUDIO")
    pre = dataclasses.replace(pre, mask_noise_std=0.03)
    model, recipe = build_finetune_encoder_cfg(pre, FinetuneConfig(average_top_k_layers=3),
                                               FinetuneTrainConfig())
    assert model.embed_dim == 128 and model.depth == 3 and model.conv_layers == TINY_LAYERS
    assert model.labels == FinetuneConfig().labels and recipe.mask_noise_std == 0.03
    jpre_cfg.model.modalities.audio.mask_noise_std = 0.03
    jenc = jax_build_encoder_cfg(jpre_cfg.model, jcfg.finetune)
    assert jenc.modalities.audio.mask_noise_std == recipe.mask_noise_std
    assert (jenc.embed_dim, jenc.depth, jenc.modalities.audio.prenet_depth) == (
        model.embed_dim, model.depth, model.prenet_depth)


# ----------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 clips of 800 samples with h5 labels of the tiny config's classes:
    9 train, 3 valid."""
    root = str(tmp_path_factory.mktemp("loop_data"))
    return generate(root, n_clips=12, clip_seconds=WAV / 8000, labels=NAMES, seed=11)


class Recorder:
    """A metrics sink that keeps every (step, metrics) it is given."""

    runs = []

    def __init__(self, logdir=None, project=None):
        self.writer = None
        self.logs = []
        Recorder.runs.append(self)

    def log(self, metrics, step):
        self.logs.append((step, dict(metrics)))

    def close(self):
        pass


def _jax_run(corpus, save_dir, monkeypatch):
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3, **TINY)
    jcfg.common.log_interval = 1
    jcfg.distributed.data_parallel = 1  # one device, as the port runs
    jcfg.task.data = corpus
    jcfg.task.max_sample_size = WAV
    jcfg.task.verbose_tensorboard_logging = True
    jcfg.dataset.batch_size = 2
    jcfg.dataset.num_workers = 2
    jcfg.dataset.train_subset = "train_0"
    jcfg.dataset.validate_interval_updates = 2
    jcfg.dataset.validate_after_updates = 0
    jcfg.criterion.segmentation_metrics = True
    jcfg.criterion.metric_threshold = 0.5  # every confusion count non-zero
    jcfg.checkpoint.save_dir = save_dir
    jcfg.checkpoint.save_interval_updates = 1000
    jcfg.optimization = JaxOptimizationConfig(**OPT)
    init = {}
    real_init = jax_loop.init_finetune

    def capture(*args, **kwargs):
        model, state = real_init(*args, **kwargs)
        init["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        return model, state

    monkeypatch.setattr(jax_loop, "init_finetune", capture)
    monkeypatch.setattr(jax_loop, "TensorboardSink", Recorder)
    Recorder.runs = []
    jax_loop.run_finetune(jcfg, max_steps=3)
    final = JaxCheckpointManager(save_dir).restore()[0]
    return jcfg, init["params"], params_from_jax(final["params"]), Recorder.runs[0].logs


def _from_params(params):
    """An ``init_finetune`` that loads ``params`` (a port state dict)."""
    def init(run, device, pretrained=None, dp=None):
        model, state = init_finetune(run, device, pretrained, dp)
        model.load_state_dict(params, strict=True)
        return model, state
    return init


def test_run_finetune_matches_jax(corpus, tmp_path, monkeypatch):
    jcfg, jinit, jfinal, jlogs = _jax_run(corpus, str(tmp_path / "jax"), monkeypatch)
    run = _tiny_finetune_run(tmp_path / "port", data=corpus,
                             model=_port_cfg(jcfg, TINY_LAYERS, **TINY))
    monkeypatch.setattr(loop, "init_finetune", _from_params(params_from_jax(jinit)))
    monkeypatch.setattr(loop, "TensorboardSink", Recorder)
    Recorder.runs = []
    loop.run_finetune(run, max_steps=3, device="cpu")
    logs = Recorder.runs[0].logs
    final = CheckpointManager(str(tmp_path / "port")).load()
    assert final["step"] == 3
    assert final["model"].keys() == jfinal.keys()
    for name, want in jfinal.items():
        np.testing.assert_allclose(final["model"][name].numpy(), want.numpy(), rtol=0,
                                   atol=LOOP_PARAM_TOL, err_msg=name)
    train = [(s, m["train/loss"]) for s, m in logs if "train/loss" in m]
    jtrain = [(s, m["train/loss"]) for s, m in jlogs if "train/loss" in m]
    assert [s for s, _ in train] == [s for s, _ in jtrain] == [1, 2, 3]
    assert all(abs(a - b) <= LOSS_TOL for (_, a), (_, b) in zip(train, jtrain))
    (vstep, val), = [(s, m) for s, m in logs if "valid/mAP" in m]
    (jstep, jval), = [(s, m) for s, m in jlogs if "valid/mAP" in m]
    assert vstep == jstep == 2
    val.pop("ups"), jval.pop("ups")
    assert val.keys() == jval.keys() and "valid/segmented_mAP" in val
    for key in COUNTS:
        assert val[key] == jval[key] > 0, key
    for key, want in jval.items():
        if np.isnan(want):
            assert np.isnan(val[key]), key
        else:
            assert abs(val[key] - want) <= VALID_TOL, (key, val[key], want)
    # the best checkpoint is the validated step's
    assert load_checkpoint_dir(str(tmp_path / "port" / "best"))["step"] == 2


def test_resume_is_bit_exact(corpus, tmp_path):
    """4 steps straight, and 2 steps + a restart + 2 more, give the same
    parameters bit for bit (every rate 0: the restarted step generators
    draw nothing that matters)."""
    straight = _tiny_finetune_run(tmp_path / "a", data=corpus)
    loop.run_finetune(straight, max_steps=4, device="cpu")
    split = _tiny_finetune_run(tmp_path / "b", data=corpus)
    loop.run_finetune(split, max_steps=2, device="cpu")
    assert load_checkpoint_dir(str(tmp_path / "b"))["extra"]["loader"] == {"epoch": 0,
                                                                           "position": 2}
    loop.run_finetune(split, max_steps=4, device="cpu")
    a, b = (load_checkpoint_dir(str(tmp_path / d)) for d in ("a", "b"))
    assert a["step"] == b["step"] == 4 and a["extra"] == b["extra"]
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4


def test_cli_chain(tmp_path):
    """train_cli: pretrain 2 steps, finetune 2 steps from that checkpoint,
    then infer_cli --checkpoint on the best one returns events."""
    data = generate(str(tmp_path / "data"), n_clips=12, clip_seconds=WAV / 8000, labels=NAMES,
                    seed=12, label_ext="npz")
    model = [f"{k}={v}" for k, v in TINY.items()] + [
        f"conv_layers={TINY_LAYERS}", "average_top_k_layers=3"]
    common = ["common.compute_dtype=float32", "common.tensorboard_logdir=",
              "dataset.batch_size=2", "dataset.num_workers=2", f"task.max_sample_size={WAV}",
              "task.label_ext=npz"]
    train_cli.main(["--recipe", "a2v_large_pretrain", "--data", data, "--save-dir",
                    str(tmp_path / "pre"), "--max-steps", "2", "--device", "cpu",
                    *common, *[f"pretrain.model.{m}" for m in model],
                    "pretrain.average_top_k_layers=3", "pretrain.clone_batch=2",
                    "pretrain.decoder.decoder_dim=16", "pretrain.decoder.decoder_groups=4",
                    "pretrain.decoder.decoder_kernel=3", "pretrain.decoder.decoder_layers=2",
                    "pretrain.optimization.update_freq=1"])
    assert load_checkpoint_dir(str(tmp_path / "pre"))["step"] == 2
    out = train_cli.main([
        "--recipe", "finetune_100", "--data", data, "--save-dir", str(tmp_path / "ft"),
        "--pretrained", str(tmp_path / "pre"), "--max-steps", "2", "--device", "cpu", *common,
        *[f"model.{m}" for m in model], f"model.labels={NAMES}", "task.min_sample_size=1",
        "task.min_label_size=0", "finetune.optimization.update_freq=1",
        "finetune.freeze_finetune_updates=0", "finetune.mask_channel_length=4",
        "dataset.validate_after_updates=0",
        "dataset.validate_interval_updates=2"])
    assert np.isfinite(out["train/loss"])
    ck = load_checkpoint_dir(str(tmp_path / "ft" / "best"))
    assert ck["step"] == 2
    pre = load_checkpoint_dir(str(tmp_path / "pre"))["model"]
    # the finetune run started from the pretrained frontend, which it does not train
    name = "audio_encoder.local_encoder.conv_1.weight"
    assert torch.equal(ck["model"]["encoder." + name], pre[name])
    from animal2vec_tpu_torch.data.wavio import write_wav

    wav = np.random.default_rng(0).normal(size=3 * 8000).astype(np.float32)
    write_wav(str(tmp_path / "rec.wav"), wav, 8000)
    events = infer_cli.main(["--wav", str(tmp_path / "rec.wav"), "--checkpoint",
                             str(tmp_path / "ft" / "best"), "--device", "cpu", "--threshold",
                             "0.0", "--out", str(tmp_path / "ev.json"), *model,
                             f"labels={NAMES}", f"max_sample_size={WAV}"])
    assert set(events) == set(NAMES) and sum(len(v) for v in events.values()) > 0
