"""The port's sharded layouts (``parallel/mesh.py``, ``parallel/layout.py``,
``parallel/tensor.py``, ``parallel/pipeline.py``) against the JAX
package's ("data", "stage", "model") mesh, on the CPU with gloo ranks.

* Units: ``pick_microbatches`` equals JAX's over a grid; ``mesh_sizes``
  equals ``build_mesh``'s axes; the partition plan agrees with JAX's
  ``param_partition_spec`` on which block layers are column-parallel,
  row-parallel, FSDP-sharded and split over stages (the differences it
  records: the dense layers outside the blocks stay replicated); the
  recipes map the A.10 keys and reproduce JAX's depth check; the layouts
  left out raise naming A.10.
* Plain versions: the split #6 (``block_fc1``, ``block_fc2_partial``,
  ``block_ln2``) on each rank's hidden columns, summed over the ranks,
  equals the unsharded block with every dropout site and drop-path on
  (1e-5; fp32 partial sums in another order), its drop_a masks are the
  unsharded masks' column slices bit for bit and JAX's ``_hash_keep`` at
  the global columns; the head-offset attention (forward and backward) on
  each rank's heads equals the unsharded call's heads (1e-6) with the
  masks the slices bit for bit and JAX's ``_dropout_keep`` at b * H + h0 +
  h.
* One launch of 2 gloo ranks (``tests/torch_parallel_workers.py``) runs
  FSDP (data 2), tensor parallelism (model 2) and the GPipe trunk (stage
  2), each through a finetune step and a pretraining step with the EMA
  teacher on a tiny depth-4 model, held against JAX's step on the whole
  global batch with the rates at 0 (the train-step tests' PARAM_TOL 1e-6
  on every parameter and EMA parameter, LOSS_TOL 1e-5) and the ranks'
  checksums of their replicated parameters equal; a tensor-parallel block with every
  dropout site on against the whole block (1e-5: the masks must agree to
  land there); the pipelined model with every dropout site, layerdrop and
  drop-path on against the plain model from the same seeds (its logits
  bit for bit: the stages draw the plain stack's masks).
"""

import dataclasses
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import animal2vec_tpu.ops as jax_ops
import animal2vec_tpu.train.pretrain as jax_pretrain
from animal2vec_tpu.config import DistributedConfig as JaxDistributedConfig
from animal2vec_tpu.config import OptimizationConfig as JaxOptimizationConfig
from animal2vec_tpu.config import load_config as jax_load_config
from animal2vec_tpu.ops.fused_mlp import _hash_keep as jax_hash_keep
from animal2vec_tpu.ops.pallas_attention import _dropout_keep as jax_dropout_keep
from animal2vec_tpu.parallel.mesh import build_mesh, param_partition_spec
from animal2vec_tpu.parallel.pipeline import pick_microbatches as jax_pick_microbatches
from animal2vec_tpu.train.build import build_finetune_model as jax_build_finetune_model
from animal2vec_tpu.train.build import build_pretrain_model as jax_build_pretrain_model
from animal2vec_tpu.train.finetune_step import make_finetune_train_step as jax_finetune_step
from animal2vec_tpu.train.optim import build_optimizer as jax_build_optimizer
from animal2vec_tpu.train.state import FinetuneState as JaxFinetuneState
from animal2vec_tpu.train.state import PretrainState as JaxPretrainState

from animal2vec_tpu_torch import recipes
from animal2vec_tpu_torch.config import DistributedConfig, ImageConfig, load_config
from animal2vec_tpu_torch.models.data2vec2 import Data2VecMulti
from animal2vec_tpu_torch.models.finetune import FinetuneModel
from animal2vec_tpu_torch.ops.attention import alibi_attention_plain, attention_bwd_plain
from animal2vec_tpu_torch.ops.dropout import hash_keep
from animal2vec_tpu_torch.ops.fused_mlp import (
    block_fc1, block_fc2_partial, block_ln2, fused_block_plain,
)
from animal2vec_tpu_torch.parallel import mesh
from animal2vec_tpu_torch.parallel.layout import apply_layout, partition_plan
from animal2vec_tpu_torch.parallel.mesh import Axis, mesh_sizes
from animal2vec_tpu_torch.parallel.pipeline import pick_microbatches
from animal2vec_tpu_torch.weights import params_from_jax

from tests.test_parity import _finetune_cfg
from tests.test_torch_model import TINY, TINY_LAYERS, _jittered, _port_cfg
from tests.test_torch_pretrain_step import ACCUM, _mask
from tests.test_torch_pretrain_step import _jax_cfg as _jax_pretrain_cfg
from tests.test_torch_pretrain_step import _port_cfg as _port_pretrain_cfg
from tests.test_torch_train_step import LOSS_TOL, OPT, PARAM_TOL, _train_cfg
from tests.torch_parallel_workers import LAYOUTS

WAV = 800
ROWS = 4  # the global batch
DEPTH = 4  # the trunk splits over 2 stages
TINY4 = dict(TINY, depth=DEPTH)
ENV = {"OMP_NUM_THREADS": "1"}
A10 = "ROADMAP A.10"


# ----------------------------------------------------------- units


def test_pick_microbatches_matches_jax():
    for batch in range(1, 18):
        for stages in range(1, 5):
            for requested in range(0, 7):
                assert pick_microbatches(batch, stages, requested) == \
                    jax_pick_microbatches(batch, stages, requested)


@pytest.mark.parametrize("ranks,data,stage,model", [
    (8, -1, 1, 2), (8, -1, 2, 2), (8, 2, 2, 2), (4, -1, 1, 1), (4, 1, 2, 2), (2, -1, 2, 1),
    (2, 4, 1, 1), (2, 1, 1, 4)])
def test_mesh_sizes_are_build_mesh(ranks, data, stage, model):
    """``mesh_sizes`` is JAX's ``build_mesh`` arithmetic: data -1 takes what
    stage x model leave, a mesh larger than the ranks raises in both."""
    cfg = DistributedConfig(data_parallel=data, model_parallel=model, pipeline_parallel=stage)
    jcfg = JaxDistributedConfig(data_parallel=data, model_parallel=model,
                                pipeline_parallel=stage)
    if data * stage * model > ranks:
        with pytest.raises(ValueError):
            build_mesh(jcfg, jax.devices()[:ranks])
        with pytest.raises(ValueError):
            mesh_sizes(cfg, ranks)
        return
    jmesh = build_mesh(jcfg, jax.devices()[:ranks])
    want = (jmesh.shape["data"], jmesh.shape.get("stage", 1), jmesh.shape["model"])
    assert mesh_sizes(cfg, ranks) == want


@pytest.fixture(scope="module")
def jax_finetune():
    """The tiny depth-4 JAX finetune config, model and jittered params."""
    jcfg = _finetune_cfg(conv_layers=" + ".join(f"[{l}]" for l in TINY_LAYERS), avg_k=3,
                         **TINY4)
    jcfg.optimization = JaxOptimizationConfig(**OPT)
    jcfg.finetune.freeze_finetune_updates = 0
    jmodel = jax_build_finetune_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, WAV)))["params"]
    return jcfg, jmodel, _jittered(params, seed=1)


_LAYER = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


@pytest.mark.parametrize("model,fsdp,stages", [(2, False, 1), (1, True, 1), (1, False, 2),
                                                (2, True, 2)])
def test_partition_plan_matches_jax(jax_finetune, model, fsdp, stages):
    """Per block layer (prenet and trunk, qkv / proj / fc1 / fc2, kernel and
    bias) the port's plan has JAX's roles: column- or row-parallel over
    "model", FSDP over "data", split over "stage". The recorded difference:
    JAX's rule also shards dense layers outside the blocks (the head's
    ``proj``, ``project_linear``), which the port keeps replicated."""
    _, _, params = jax_finetune
    jmesh = types.SimpleNamespace(shape={"data": 2, "model": model, "stage": stages})
    names = list(FinetuneModel(_port_cfg(jax_finetune[0], TINY_LAYERS, **TINY4)).state_dict())
    plan = partition_plan(names, model, fsdp, stages)
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(k.key for k in path)
        spec = tuple(param_partition_spec(keys, leaf.shape, jmesh, fsdp))
        if "block" in keys and keys[-2] in _LAYER and keys[-1] in ("kernel", "bias"):
            prefix = ("encoder.blocks.layers." if keys[1] == "blocks" else
                      "encoder.audio_encoder.context_encoder.blocks.layers.")
            tp = None
            if "model" in spec:
                tp = "column" if keys[-2] in ("qkv", "fc1") else "row"
            # recorded: JAX's rule also lays the prenet's stacked leaves over
            # "stage" (the prenet runs whole on every stage: GSPMD gathers it)
            want = (tp, "data" in spec, "stage" in spec and keys[1] == "blocks")
            assert ("stage" in spec) == (stages > 1), keys
            leaf_name = "weight" if keys[-1] == "kernel" else "bias"
            for i in range(leaf.shape[0]):
                assert plan[f"{prefix}{i}.{_LAYER[keys[-2]]}.{leaf_name}"] == want, keys
                seen += 1
        elif keys == ("proj", "kernel"):  # the head: row-parallel and FSDP in JAX
            assert ("model" in spec, "data" in spec) == (model > 1, fsdp)
            assert plan["proj.weight"] == (None, False, False)
        elif keys == ("encoder", "audio_encoder", "project_linear", "kernel"):
            assert ("model" in spec, "data" in spec) == (False, fsdp)
            assert plan["encoder.audio_encoder.project_linear.weight"] == (None, False, False)
    assert seen == (2 + DEPTH) * 8


def test_recipes_map_the_layout_keys():
    """The five A.10 keys are mapped (no longer refused) and reach the run;
    JAX's config-time depth check is reproduced."""
    keys = ("distributed.model_parallel", "distributed.fsdp", "distributed.pipeline_parallel",
            "model.pipeline_stages", "model.pipeline_microbatches")
    for key in keys:
        assert key in recipes.MAPPED and key not in recipes.REFUSED, key
    path = str(recipes.RECIPES["a2v_large_pretrain"])
    run = load_config(path, ["distributed.model_parallel=2", "distributed.fsdp=true",
                             "distributed.pipeline_parallel=2", "model.pipeline_stages=2",
                             "model.pipeline_microbatches=3"])
    assert run.distributed == DistributedConfig(-1, 2, True, 2)
    assert (run.pretrain.model.pipeline_stages, run.pretrain.model.pipeline_microbatches) == (2, 3)
    ft = str(recipes.RECIPES["finetune_100"])
    with pytest.raises(ValueError, match="not divisible") as ours:
        load_config(ft, ["distributed.pipeline_parallel=3"])
    with pytest.raises(ValueError, match="not divisible") as theirs:
        jax_load_config(os.path.join(os.path.dirname(recipes.__file__), "..", "animal2vec_tpu",
                                     "configs", "finetune_100.yaml"),
                        ["distributed.pipeline_parallel=3"])
    assert str(ours.value) == str(theirs.value)


def test_left_out_layouts_raise_naming_a10():
    """Tensor parallelism of pre-LN blocks, without ALiBi and of the image
    modality, and the int8 modes under any sharding, raise (ROADMAP A.10),
    in the config and in ``apply_layout``."""
    ft = str(recipes.RECIPES["finetune_100"])
    pre = str(recipes.RECIPES["a2v_large_pretrain"])
    for path, overrides in ((ft, ["distributed.model_parallel=2", "model.layer_norm_first=true"]),
                            (ft, ["distributed.model_parallel=2",
                                  "model.modalities.audio.use_alibi_encoder=false"]),
                            (ft, ["distributed.fsdp=true", "model.matmul_impl=int8"]),
                            (pre, ["distributed.pipeline_parallel=2",
                                   "model.teacher_matmul_impl=int8_attn"])):
        with pytest.raises(NotImplementedError, match=A10):
            load_config(path, overrides)
    tp = mesh.DataParallel(model=Axis(0, 2))
    image = Data2VecMulti(ImageConfig(input_size=32, patch_size=8, patch_embed_dim=32,
                                      embed_dim=32, num_heads=4, prenet_depth=1, depth=2))
    pre_ln = FinetuneModel(dataclasses.replace(_port_cfg(_cfg_stub(), TINY_LAYERS, **TINY4),
                                               layer_norm_first=True))
    for model in (image, pre_ln):
        with pytest.raises(NotImplementedError, match=A10):
            apply_layout(model, tp)
    int8 = FinetuneModel(dataclasses.replace(
        _port_cfg(_cfg_stub(k=2), TINY_LAYERS, embed_dim=128, num_heads=2, depth=2,
                  prenet_depth=1, conv_pos_depth=1, conv_pos_width=10, conv_pos_groups=2),
        matmul_impl="int8"))
    with pytest.raises(NotImplementedError, match=A10):
        apply_layout(int8, mesh.DataParallel(stage=Axis(0, 2)))


def _cfg_stub(k=3):
    """A JAX-shaped config stub for ``_port_cfg`` (labels, thresholds, the
    head's ``k`` taps)."""
    crit = types.SimpleNamespace(metric_threshold=0.25, sigma_s=0.1, maxfilt_s=0.1,
                                 max_duration_s=0.5, lowP=0.125)
    task = types.SimpleNamespace(labels=lambda: ["a", "b", "c", "d"], max_sample_size=WAV)
    return types.SimpleNamespace(finetune=types.SimpleNamespace(average_top_k_layers=k),
                                 task=task, criterion=crit)


# ----------------------------------------------------------- plain versions


def test_split_block_shards_equal_the_block():
    """Two ranks' halves of #6's hidden columns through the split entries'
    plain versions, their fc2 partial sums added, equal the unsharded block
    with drop_a, drop_b, drop_c and drop-path on; the drop_a masks are the
    unsharded masks' slices bit for bit, and JAX's ``_hash_keep`` at the
    global columns."""
    g = torch.Generator().manual_seed(0)
    n, c, m, mp, row0 = 2 * 40, 64, 256, 2, 120
    x = torch.randn(2, 40, c, generator=g)
    w1, w2 = torch.randn(c, m, generator=g) * 0.1, torch.randn(m, c, generator=g) * 0.1
    b1, b2 = torch.randn(m, generator=g) * 0.1, torch.randn(c, generator=g) * 0.1
    l1s, l1b, l2s, l2b = (1 + 0.1 * torch.randn(c, generator=g) for _ in range(4))
    seeds, act, post = (11, -22, 33), 0.2, 0.3
    scale = torch.tensor([0.0, 1.25])
    want, want_t = fused_block_plain(x, l1s, l1b, w1, w2, b1, b2, l2s, l2b, 1e-5, seeds, act,
                                     post, row0, scale)
    _, h_full = block_fc1(x.reshape(n, c), l1s, l1b, w1, b1, 1e-5, seeds[0], act, row0)
    ms = m // mp
    parts, rs = [], []
    for r in range(mp):
        cols = slice(r * ms, (r + 1) * ms)
        rr, h = block_fc1(x.reshape(n, c), l1s, l1b, w1[:, cols], b1[cols], 1e-5, seeds[0], act,
                          row0, r * ms)
        assert torch.equal(h == 0, h_full[:, cols] == 0), r
        rows = np.arange(row0, row0 + n)[:, None]
        jkeep = np.asarray(jax_hash_keep(jnp.int32(seeds[0]), jnp.asarray(rows, jnp.int32),
                                         jnp.asarray(np.arange(r * ms, (r + 1) * ms)[None],
                                                     jnp.int32), act))
        ours = hash_keep(seeds[0], torch.from_numpy(rows), r * ms + torch.arange(ms)[None], act)
        assert np.array_equal(ours.numpy(), jkeep)
        parts.append(block_fc2_partial(h, w2[cols]))
        rs.append(rr)
    x_out, t = block_ln2(sum(parts), b2, rs[0], l2s, l2b, 1e-5, seeds[1:], act, post, row0,
                         scale)
    np.testing.assert_allclose(x_out.reshape(x.shape).numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.reshape(x.shape).numpy(), want_t.numpy(), rtol=0, atol=1e-5)


def test_head_offset_attention_equals_the_heads_slice():
    """Each rank's heads (h0 = 2 r of H = 4) through the forward and backward
    plain versions with ``h0`` and ``hash_heads`` equal the unsharded call's
    heads; the dropout masks are the unsharded masks' heads bit for bit and
    JAX's ``_dropout_keep`` at b * H + h0 + h."""
    from animal2vec_tpu_torch.ops.attention import _keep_factor

    g = torch.Generator().manual_seed(1)
    b, h, t, d, rate, seed = 2, 4, 48, 8, 0.25, 1234567
    qkv = torch.randn(3, b, h, t, d, generator=g)
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625])
    pos = torch.arange(t, dtype=torch.int32)[None]
    pad = torch.zeros(b, t, dtype=torch.bool)
    pad[1, 40:] = True
    out, lse = alibi_attention_plain(qkv, slopes, pos, pad, False, rate, seed, True)
    dout = torch.randn(b, h, t, d, generator=g)
    delta = (dout * out).sum(-1).reshape(b * h, t)
    dqkv, parts = attention_bwd_plain(qkv, dout, lse, delta, slopes, pos, pad, False, rate, seed)
    full_keep = _keep_factor(b, h, t, rate, seed, "cpu")
    for r in range(2):
        hs = slice(2 * r, 2 * r + 2)
        sub = qkv[:, :, hs].contiguous()
        o, l = alibi_attention_plain(sub, slopes[hs], pos, pad, False, rate, seed, True,
                                     h0=2 * r, hash_heads=h)
        np.testing.assert_allclose(o.numpy(), out[:, hs].numpy(), rtol=0, atol=1e-6)
        dl = delta.reshape(b, h, t)[:, hs].reshape(-1, t)
        dq, pr = attention_bwd_plain(sub, dout[:, hs].contiguous(), l, dl, slopes[hs], pos, pad,
                                     False, rate, seed, h0=2 * r, hash_heads=h)
        np.testing.assert_allclose(dq.numpy(), dqkv[:, :, hs].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pr.numpy(), parts[:, hs].numpy(), rtol=0, atol=1e-5)
        keep = _keep_factor(b, 2, t, rate, seed, "cpu", 2 * r, h)
        assert torch.equal(keep, full_keep[:, hs])
        bh = (np.arange(b)[:, None] * h + 2 * r + np.arange(2)[None]).reshape(-1)
        for i, bh_id in enumerate(bh):
            jkeep = np.asarray(jax_dropout_keep(jnp.int32(seed), jnp.uint32(bh_id),
                                                jnp.arange(t, dtype=jnp.int32)[:, None],
                                                jnp.arange(t, dtype=jnp.int32)[None], rate))
            ours = (keep.reshape(-1, t, t)[i] > 0).float().numpy()
            assert np.array_equal(ours, jkeep), (r, i)


# ----------------------------------------------------------- two ranks


def _jax_finetune_step(jcfg, jmodel, params, batch):
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    jstate, jmetrics = jax.jit(jax_finetune_step(jmodel, jcfg))(
        JaxFinetuneState.create(params, tx), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)), jmetrics


def _jax_pretrain():
    jcfg = _jax_pretrain_cfg("AUDIO", model_kw={"depth": DEPTH})
    jmodel = jax_build_pretrain_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "mask_noise": jax.random.fold_in(key, 1)},
                         jnp.zeros((1, WAV)), "AUDIO")["params"]
    return jcfg, jmodel, _jittered(params, seed=1)


def _jax_pretrain_step(jcfg, jmodel, params, batch, mask):
    tx, _ = jax_build_optimizer(jcfg.optimization, params)
    fixed = lambda *args, **kw: jnp.asarray(mask)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pretrain, "span_mask", fixed)
        mp.setattr(jax_ops, "block_mask_2d", fixed)
        jnew, jmetrics = jax.jit(jax_pretrain.make_pretrain_train_step(jmodel, jcfg))(
            JaxPretrainState.create(params, tx, jcfg.model),
            {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3))
    tree = lambda t: params_from_jax(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return tree(jnew.params), tree(jnew.ema_params), jmetrics


def layout_inputs(jax_finetune, jax_pretrain):
    """The workers' inputs and the global batches (numpy, seeded)."""
    from animal2vec_tpu_torch.train.pretrain import mask_tokens

    rng = np.random.default_rng(21)
    ft_batch = {"source": rng.normal(size=(2, ROWS, WAV)).astype(np.float32),
                "target": (rng.random((2, ROWS, 200, 4)) < 0.1).astype(np.float32)}
    pcfg = _port_pretrain_cfg("AUDIO", model_kw={"depth": DEPTH})
    pt_batch = {"source": rng.normal(size=(ACCUM, ROWS, WAV)).astype(np.float32)}
    pt_mask = _mask(ROWS * pcfg.clone_batch, 200, mask_tokens(pcfg, 200), seed=22)
    inputs = {
        "ft_cfg": _port_cfg(jax_finetune[0], TINY_LAYERS, **TINY4), "ft_train": _train_cfg(0),
        "ft_params": params_from_jax(jax_finetune[2]),
        "ft_batch": {k: torch.from_numpy(v) for k, v in ft_batch.items()},
        "pt_cfg": pcfg, "pt_params": params_from_jax(jax_pretrain[2]),
        "pt_mask": torch.from_numpy(pt_mask),
        "pt_batch": {k: torch.from_numpy(v) for k, v in pt_batch.items()},
    }
    return inputs, ft_batch, pt_batch, pt_mask


def launch_with_references(out, world, scenarios, jax_finetune):
    """One launch of ``world`` gloo ranks running ``scenarios`` while this
    process computes JAX's finetune and pretraining steps on the global
    batches; returns (references, the ranks' results)."""
    pt = _jax_pretrain()
    inputs, ft_batch, pt_batch, pt_mask = layout_inputs(jax_finetune, pt)
    torch.save(inputs, out / "inputs.pt")
    failed = []

    def ranks():
        try:
            mesh.launch(["-m", "tests.torch_parallel_workers", ",".join(scenarios), str(out)],
                        world, env=ENV, timeout=300)
        except Exception as e:  # raised below, in the test's thread
            failed.append(e)

    worker = threading.Thread(target=ranks)
    worker.start()
    try:
        refs = {"finetune": _jax_finetune_step(*jax_finetune, ft_batch),
                "pretrain": _jax_pretrain_step(*pt, pt_batch, pt_mask)}
    finally:
        worker.join()
    if failed:
        raise failed[0]
    return refs, [torch.load(out / f"result_{r}.pt", weights_only=False) for r in range(world)]


def close(ours, ref, tol, what=""):
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


def check_step(refs, results, scenario):
    """A layout's step on rank 0 against JAX's, and every rank's replicated
    parameters equal."""
    layout, part = scenario.split(":")
    r0 = results[0][scenario]
    sums = {r[scenario]["checksum"] for r in results}
    assert len(sums) == 1, scenario
    if part == "finetune":
        ref, jmetrics = refs["finetune"]
        close(r0["params"], ref, PARAM_TOL, scenario)
        for key in ("sample_size", "finetune/tp", "finetune/fp", "finetune/tn", "finetune/fn"):
            assert r0["metrics"][key] == float(jmetrics[key]), (scenario, key)
    else:
        ref, ema_ref, jmetrics = refs["pretrain"]
        close(r0["params"], ref, PARAM_TOL, scenario)
        close(r0["ema"], ema_ref, PARAM_TOL, scenario)
        assert r0["metrics"]["sample_size"] == float(jmetrics["sample_size"])
    assert abs(r0["metrics"]["loss"] - float(jmetrics["loss"])) <= LOSS_TOL, scenario


TWO = ("fsdp:finetune", "fsdp:pretrain", "tp:finetune", "tp:pretrain", "pp:finetune",
       "pp:pretrain", "tp:block_dropout", "pp:model_dropout")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_finetune):
    assert all(LAYOUTS[s.split(":")[0]] for s in TWO)
    return launch_with_references(tmp_path_factory.mktemp("two_ranks"), 2, TWO, jax_finetune)


@pytest.mark.parametrize("scenario", [s for s in TWO if s.endswith(("finetune", "pretrain"))])
def test_two_rank_layout_step_matches_jax(two_ranks, scenario):
    check_step(*two_ranks, scenario)


def test_tensor_parallel_block_with_dropout_equals_the_block(two_ranks):
    """Both "model" ranks' output, input gradient and summed slope gradient
    of the sharded block with every dropout site and drop-path on equal the
    whole block's on the same draws (1e-5)."""
    _, results = two_ranks
    ref = results[0]["tp:block_dropout"]["ref"]
    for res in results:
        for ours, want in zip(res["tp:block_dropout"]["y"], ref):
            np.testing.assert_allclose(ours.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_pipelined_model_draws_the_plain_stacks_masks(two_ranks):
    """The 2-stage pipelined model in training with every dropout site,
    layerdrop and drop-path on gives the plain model's logits bit for bit
    (the stages draw the plain stack's masks, a microbatch its rows' slice)
    and its ALiBi-scale gradient within 1e-5, on both stages."""
    _, results = two_ranks
    ref = results[0]["pp:model_dropout"]["ref"]
    for res in results:
        logits, grad = res["pp:model_dropout"]["y"]
        assert torch.equal(logits, ref[0])
        np.testing.assert_allclose(grad.numpy(), ref[1].numpy(), rtol=0, atol=1e-5)
