"""The port's finetune train step against the JAX package's, and the
training arms of its modules.

One ``make_finetune_train_step`` on the tiny config of
``tests/test_torch_model.py`` (embed 128, 4 heads, 2 prenet + 3 trunk
blocks) from the same jittered params, with every dropout rate and
layerdrop at 0, mixup and masks off (``jax.random`` and torch draw
differently from one seed; the random parts are held to JAX at op level),
``update_freq`` 2, global-norm clipping 1.0 and weight decay 0.01. The loss
must agree within 1e-5, and every updated parameter within 1e-6 (1e-3 of
the step size lr = 1e-3: the first Adam update is about lr * sign(g), so the
parameters carry the gradients' agreement scaled down). With the freeze gate
closed the head's update still matches and every encoder gradient is a zero
tensor, as JAX's are.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal2vec_tpu.config import OptimizationConfig
from animal2vec_tpu.models.modules import top_k_tap_average as jax_top_k
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model
from animal2vec_tpu.train.finetune_step import make_finetune_train_step as jax_make_step
from animal2vec_tpu.train.optim import build_optimizer as jax_build_optimizer
from animal2vec_tpu.train.state import FinetuneState as JaxFinetuneState

from animal2vec_tpu_torch.config import FinetuneConfig, FinetuneTrainConfig, OptimizationConfig
from animal2vec_tpu_torch.models.finetune import FinetuneModel, build_finetune_model
from animal2vec_tpu_torch.models.modules import top_k_tap_average
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.train.finetune_step import (
    make_finetune_eval_step, make_finetune_train_step,
)
from animal2vec_tpu_torch.train.state import FinetuneState
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import _finetune_cfg
from tests.test_torch_model import TINY, TINY_LAYERS, _jittered, _port_cfg

LOSS_TOL = 1e-5
PARAM_TOL = 1e-6
OPT = dict(lr=1e-3, max_update=100, warmup_updates=0, warmup_init_lr=0.0, min_lr=0.0,
           clip_norm=1.0, weight_decay=0.01, adam_eps=1e-6, adam_betas=(0.9, 0.98),
           update_freq=2)


def _train_cfg(freeze):
    return dataclasses.replace(
        FinetuneTrainConfig(), freeze_finetune_updates=freeze, apply_mask=False,
        mask_channel_prob=0.0, dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        layerdrop=0.0, source_mixup=-1.0, label_smoothing=0.0,
        optimization=OptimizationConfig(**OPT),
    )


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"source": rng.normal(size=(2, 2, 800)).astype(np.float32),
            "target": (rng.random((2, 2, 200, 4)) < 0.1).astype(np.float32)}


def _both_steps(freeze):
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3, **TINY)
    jcfg.optimization = OptimizationConfig(**OPT)
    jcfg.finetune.freeze_finetune_updates = freeze
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 800)))["params"]
    params = _jittered(params, seed=1)
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    batch = _batch(seed=2)
    jstate, jmetrics = jax_make_step(jmodel, jcfg)(
        JaxFinetuneState.create(params, tx), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3),
    )
    tcfg = _train_cfg(freeze)
    model = FinetuneModel(_port_cfg(jcfg, TINY_LAYERS, **TINY), train=tcfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = FinetuneState.create(model, tcfg)
    metrics = make_finetune_train_step(tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, Rngs.from_seed(0, "cpu"),
    )
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    return state, metrics, jmetrics, ref


@pytest.mark.parametrize("gate", ["open", "closed"])
def test_train_step_matches_jax(gate):
    state, metrics, jmetrics, ref = _both_steps(freeze=0 if gate == "open" else 5)
    assert state.step == 1
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= LOSS_TOL
    for key in ("sample_size", "finetune/tp", "finetune/fp", "finetune/tn", "finetune/fn"):
        assert float(metrics[key]) == float(jmetrics[key]), key
    ours = state.model.state_dict()
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    # feature_grad_mult 0 stops the gradient at the conv frontend; JAX's
    # gradient there is zero, and so is the port's (not None)
    frontend = [n for n in grads if ".local_encoder." in n]
    assert frontend and all(grads[n] is not None and not grads[n].any() for n in frontend)
    encoder = [n for n in grads if n.startswith("encoder.")]
    if gate == "closed":
        assert all(grads[n] is not None and not grads[n].any() for n in encoder)
        assert grads["proj.weight"].abs().sum() > 0
    else:
        assert grads["encoder.blocks.layers.2.mlp.fc1.weight"].abs().sum() > 0
        assert grads["encoder.audio_encoder.alibi_scale"].abs().sum() > 0


def test_recipe_step_draws_and_trains():
    """The finetune_100 recipe (mixup, span and channel masks with the noise
    fill, every dropout, layerdrop) on the tiny model: finite loss, the
    trunk trains, the frontend stays fixed, and the same Rngs seed repeats
    the step exactly."""
    cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS, average_top_k_layers=3,
                              labels=("a", "b", "c", "d"), **TINY)
    base = FinetuneTrainConfig()
    tcfg = dataclasses.replace(base, freeze_finetune_updates=0, mask_channel_length=4,
                               layerdrop=0.3, optimization=dataclasses.replace(
                                   base.optimization, warmup_updates=0, update_freq=2))
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=4).items()}
    runs = []
    for _ in range(2):
        model = build_finetune_model(cfg, seed=0, device="cpu", train=tcfg)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = FinetuneState.create(model, tcfg)
        rngs = Rngs.from_seed(5, "cpu")
        losses = [float(make_finetune_train_step(tcfg)(state, batch, rngs)["loss"])
                  for _ in range(2)]
        runs.append((losses, {n: p.detach() for n, p in model.named_parameters()}))
    (losses, after), (losses2, after2) = runs
    assert np.isfinite(losses).all() and losses == losses2
    assert all(torch.equal(after[n], after2[n]) for n in after)
    assert all(torch.equal(before[n], after[n]) for n in before if ".local_encoder." in n)
    assert not torch.equal(before["encoder.blocks.layers.0.mlp.fc2.weight"],
                           after["encoder.blocks.layers.0.mlp.fc2.weight"])
    metrics = make_finetune_eval_step(tcfg)(state, {k: v[0] for k, v in batch.items()})
    assert metrics["_predictions"].shape == (2, 200, 4) and not state.model.training


def test_top_k_tap_average_with_keeps_matches_jax():
    rng = np.random.default_rng(9)
    taps = rng.normal(size=(6, 2, 5, 3)).astype(np.float32)
    for keeps in ([1, 0, 1, 1, 0, 1], [0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1]):
        for k in (1, 3, 6):
            ref = jax_top_k(jnp.asarray(taps), jnp.asarray(keeps, jnp.float32), k)
            ours = top_k_tap_average(list(torch.from_numpy(taps)), k, [float(v) for v in keeps])
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_layerdrop_skips_blocks_and_counts():
    cfg = dataclasses.replace(FinetuneConfig(), conv_layers=TINY_LAYERS, average_top_k_layers=3,
                              labels=("a", "b"), **TINY)
    model = build_finetune_model(cfg, device="cpu",
                                 train=dataclasses.replace(FinetuneTrainConfig(), layerdrop=1.0))
    model.train()
    x = torch.randn(2, 20, TINY["embed_dim"])
    blocks = model.encoder.blocks
    spec = model.encoder.audio_encoder.alibi_spec(torch.arange(20, dtype=torch.int32)[None])
    y, taps, keeps, _ = blocks(x, None, spec, Rngs.from_seed(0, "cpu"))
    assert keeps == [0.0, 0.0, 0.0] and torch.equal(y, x) and all(t is x for t in taps)
    model.eval()
    _, _, keeps, _ = blocks(x, None, spec)
    assert keeps is None
