"""The port's layouts over four gloo ranks and through ``train_cli``, and the
recorded difference of the pipelined trunk, on the CPU.

* One launch of 4 gloo ranks (``tests/torch_parallel_workers.py``): data 2
  x model 2 with FSDP, and stage 2 x model 2, each through a finetune step
  and a pretraining step with the EMA teacher on the tiny depth-4 model,
  held against JAX's step on the whole global batch (the train-step
  tests' PARAM_TOL and LOSS_TOL) with every rank's replicated parameters
  equal.
* ``train_cli`` with ``distributed.model_parallel=2`` (2 ranks) finetunes 2 steps and
  saves; the checkpoint holds whole tensors under the unsharded names and
  equals a 1-rank run's within PARAM_TOL; a 1-rank ``train_cli`` resumes it
  and continues to step 3, its first save of step 2's restored state equal
  to the sharded save bit for bit.
* The recorded difference: where JAX's ``BlockStack`` logs a warning and
  runs the plain scan (pipeline stages without a matching "stage" axis, a
  dense attention bias), the port raises with the reason.
"""

import copy
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model

from animal2vec_tpu_torch import recipes
from animal2vec_tpu_torch.config import RunConfig, apply_overrides, load_config
from animal2vec_tpu_torch.data.synthetic import generate
from animal2vec_tpu_torch.parallel.pipeline import GPipe
from animal2vec_tpu_torch.tools import train_cli
from animal2vec_tpu_torch.train.build import init_finetune
from animal2vec_tpu_torch.train.checkpoint import CheckpointManager

from tests.test_torch_model import TINY_LAYERS
from tests.test_torch_parallel import (
    TINY4, WAV, check_step, jax_finetune, launch_with_references,
)
from tests.test_torch_train_step import PARAM_TOL
from tests.torch_dist_workers import NAMES

__all__ = ["jax_finetune"]  # the module fixture, shared with test_torch_parallel

FOUR = ("fsdp_tp:finetune", "fsdp_tp:pretrain", "pp_tp:finetune", "pp_tp:pretrain")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, jax_finetune):
    return launch_with_references(tmp_path_factory.mktemp("four_ranks"), 4, FOUR, jax_finetune)


@pytest.mark.parametrize("scenario", FOUR)
def test_four_rank_layout_step_matches_jax(four_ranks, scenario):
    check_step(*four_ranks, scenario)


def test_train_cli_sharded_then_one_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = generate(str(tmp_path / "data"), n_clips=8, clip_seconds=WAV / 8000, labels=NAMES,
                    seed=13, label_ext="npz")
    model = [f"model.{k}={v}" for k, v in TINY4.items()] + [
        f"model.conv_layers={TINY_LAYERS}", "model.average_top_k_layers=3",
        f"model.labels={NAMES}"]
    common = ["--recipe", "finetune_100", "--data", data, "--device", "cpu",
              "common.compute_dtype=float32", "common.tensorboard_logdir=",
              "dataset.batch_size=2", "dataset.num_workers=1", f"task.max_sample_size={WAV}",
              "task.label_ext=npz", "task.min_sample_size=1", "task.min_label_size=0",
              "finetune.optimization.update_freq=1", "finetune.freeze_finetune_updates=0",
              "finetune.mask_channel_prob=0.0", "finetune.apply_mask=False",
              "finetune.dropout=0.0", "finetune.attention_dropout=0.0",
              "finetune.activation_dropout=0.0", "finetune.layerdrop=0.0",
              "finetune.source_mixup=-1.0", "dataset.disable_validation=True",
              "distributed.data_parallel=1", *model]
    sharded, plain = str(tmp_path / "tp"), str(tmp_path / "one")
    train_cli.main([*common, "distributed.model_parallel=2", "--save-dir", sharded,
                    "--max-steps", "2"])
    train_cli.main([*common, "--save-dir", plain, "--max-steps", "2"])
    saved = CheckpointManager(sharded).load()
    one = CheckpointManager(plain).load()
    assert saved["step"] == one["step"] == 2 and saved["model"].keys() == one["model"].keys()
    for name, want in one["model"].items():
        np.testing.assert_allclose(saved["model"][name].numpy(), want.numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
    for moment in ("mu", "nu"):
        assert saved["optimizer"][moment].keys() == one["optimizer"][moment].keys()
    # one rank restores the sharded save whole
    run = apply_overrides(RunConfig.finetune_100(), [a for a in common if "=" in a])
    _, state = init_finetune(run, "cpu")
    CheckpointManager(sharded).restore(state)
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, saved["model"][name]), name
    train_cli.main([*common, "--save-dir", sharded, "--max-steps", "3"])
    resumed = CheckpointManager(sharded).load()
    assert resumed["step"] == 3 and resumed["optimizer"]["count"] == 3


def test_pipeline_raises_where_jax_falls_back(jax_finetune, caplog):
    """Recorded difference: JAX's ``BlockStack`` with pipeline stages but no
    mesh with a matching "stage" axis logs a warning and runs the plain
    scan; the port's run config raises (as does a dense attention bias in
    the pipelined trunk, which JAX also runs through the plain scan)."""
    jcfg, _, params = jax_finetune
    jcfg = copy.deepcopy(jcfg)
    jcfg.model.pipeline_stages = 2
    jmodel = jax_build_finetune_model(jcfg)
    with caplog.at_level(logging.WARNING):
        out = jmodel.apply({"params": params}, jnp.zeros((2, WAV)))
    assert np.isfinite(np.asarray(out["encoder_out"])).all()
    assert "falling back to the plain layer scan" in caplog.text
    path = str(recipes.RECIPES["finetune_100"])
    with pytest.raises(ValueError, match="the port raises"):
        load_config(path, ["model.pipeline_stages=2"])
    with pytest.raises(NotImplementedError, match="dense attention bias"):
        GPipe.run(object.__new__(GPipe), None, torch.zeros(2, 5, 8), None,
                  torch.zeros(1, 4, 5, 5), None, None, None)
