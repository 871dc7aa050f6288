"""Serving bundles (``serve.py``, ``tools/aot_cli.py``) and the serving
kernels' custom ops (``kernels/ops.py``).

A CPU bundle of a tiny model (embed 128, 2 heads of 64, prenet 1 + depth 2,
the stride-40 conv stack, 1-s windows) gives the live model's logits
exactly (BUNDLE_TOL 0: the same aten ops and the same plain kernel versions
on the same inputs) in bf16, ``int8`` and ``int8_attn``; a subprocess loads
it without importing ``animal2vec_tpu_torch.models``. Each custom op passes
``torch.library.opcheck`` on CPU tensors. On a card (``gpu`` tests) each
op's CUDA output equals a direct call of its launch code bit for bit, and a
CUDA bundle's logits equal the eager ones.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.kernels import ops as kernel_ops
from animal2vec_tpu_torch.models.finetune import build_finetune_model
from animal2vec_tpu_torch.ops import attention, fused_mlp, int8_mm
from animal2vec_tpu_torch.serve import (
    ServingBundle, export_serving, load_params_npz, save_params_npz,
)
from animal2vec_tpu_torch.weights import params_to_jax, serving_cast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE_TOL = 0.0
WAV = 8000
CFG = dataclasses.replace(
    FinetuneConfig(), embed_dim=128, num_heads=2, depth=2, prenet_depth=1, conv_pos_depth=2,
    conv_pos_width=10, conv_pos_groups=2, average_top_k_layers=2, max_sample_size=WAV,
    conv_layers=((9, 7, 1), (16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' ops are too small for intra-op threads, which only
    spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(mode="bf16", device="cpu"):
    cfg = dataclasses.replace(CFG, matmul_impl=mode)
    model = build_finetune_model(cfg, dtype=torch.bfloat16, seed=5, device=device)
    model.load_state_dict(serving_cast(model.state_dict()), strict=True, assign=True)
    return model


def _source(batch, seed=50, device="cpu"):
    x = np.random.default_rng(seed).normal(size=(batch, WAV)).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A bf16 CPU bundle of two shapes, the first given twice."""
    model = _model()
    out = str(tmp_path_factory.mktemp("bundle"))
    export_serving(model, out, shapes=[(2, WAV), (2, WAV), (1, WAV // 2)])
    return model, out


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_attn"])
def test_cpu_bundle_matches_live_model(mode, tmp_path):
    model = _model(mode)
    export_serving(model, str(tmp_path), batch_size=2)
    src = _source(2)
    with torch.no_grad():
        want = model(src)["encoder_out"]
    got = ServingBundle(str(tmp_path)).forward(src)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == (2, 200, len(CFG.labels))
    assert (got.float() - want.float()).abs().max().item() <= BUNDLE_TOL
    program = torch.export.load(os.path.join(str(tmp_path), "forward.pt2"))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    want_ops = {"bf16": {"a2v.alibi_attention_serve.default", "a2v.fused_block.default"},
                "int8": {"a2v.alibi_attention_serve.default", "a2v.fused_block_int8.default"},
                "int8_attn": {"a2v.int8_dense.default", "a2v.quantize_qkv_int8.default",
                              "a2v.alibi_attention_int8.default",
                              "a2v.fused_block_int8.default"}}[mode]
    assert {t for t in targets if t.startswith("a2v.")} == want_ops
    # the weights stay out of the program: every tensor the model holds comes
    # in as a user input; the only constants are the sinc conv's time grid and
    # window, a function of its kernel size (2 x 3 values here)
    assert not program.state_dict
    n_params = len(load_params_npz(os.path.join(str(tmp_path), "params.npz")))
    assert len(program.graph_signature.user_inputs) == n_params + 1
    assert sum(c.numel() for c in program.constants.values()) <= 2 * CFG.conv_layers[0][1]


def test_bundle_shapes_meta_and_guard(bundle):
    model, out = bundle
    assert sorted(os.listdir(out)) == ["forward.pt2", f"forward_1x{WAV // 2}.pt2", "meta.json",
                                       "params.npz"]
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["shapes"] == [[2, WAV], [1, WAV // 2]]
    assert (meta["batch_size"], meta["wav_len"], meta["sample_rate"]) == (2, WAV, 8000)
    assert meta["labels"] == list(CFG.labels) and meta["matmul_impl"] == "bf16"
    assert (meta["device_type"], meta["device_name"]) == ("cpu", "cpu")
    assert meta["out_shape"] == [2, -1, len(CFG.labels)]
    b = ServingBundle(out)
    for shape in ((2, WAV), (1, WAV // 2)):
        src = _source(shape[0])[:, : shape[1]]
        with torch.no_grad():
            want = model(src)["encoder_out"]
        assert torch.equal(b.forward(src), want)
    with pytest.raises(ValueError, match="expects source shape"):
        b(np.zeros((3, WAV), np.float32))
    probs = b.predict_probs(_source(2).numpy())
    np.testing.assert_allclose(probs, torch.sigmoid(b.forward(_source(2)).float()).numpy(),
                               rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="exported for 'cpu'"):
        ServingBundle(out, device="meta")


def test_cuda_bundle_refuses_a_process_without_a_card(bundle, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, out = bundle
    for name in os.listdir(out):
        data = open(os.path.join(out, name), "rb").read()
        (tmp_path / name).write_bytes(data)
    meta = json.load(open(tmp_path / "meta.json"))
    meta.update(device_type="cuda", device_name="NVIDIA H100 80GB HBM3")
    json.dump(meta, open(tmp_path / "meta.json", "w"))
    with pytest.raises(RuntimeError, match="no card"):
        ServingBundle(str(tmp_path))


def test_subprocess_load_imports_no_model_code(bundle, tmp_path):
    model, out = bundle
    src = _source(2, seed=51)
    np.save(tmp_path / "src.npy", src.numpy())
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from animal2vec_tpu_torch.serve import ServingBundle\n"
        f"b = ServingBundle({out!r})\n"
        f"np.save({str(tmp_path / 'got.npy')!r}, b(np.load({str(tmp_path / 'src.npy')!r})))\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.startswith(('animal2vec_tpu_torch.models', 'animal2vec_tpu_torch.train',\n"
        "                     'jax', 'flax')) or m == 'animal2vec_tpu')))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    with torch.no_grad():
        want = model(src)["encoder_out"].float().numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "got.npy"), want)


def test_params_npz_round_trip(tmp_path):
    """bf16 as uint16 bit patterns with the __dtypes__ entry, the rest as
    they are: every tensor back bit for bit, with its dtype."""
    rng = np.random.default_rng(52)
    tensors = {
        "a.weight": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)).bfloat16(),
        "a.bias": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)),
        "b.w_q": torch.from_numpy(rng.integers(-127, 128, (2, 8)).astype(np.int8)),
        "c.scale": torch.tensor([-0.0, float("inf")]).bfloat16(),
    }
    path = str(tmp_path / "params.npz")
    save_params_npz(path, tensors)
    with np.load(path) as z:
        assert z["a.weight"].dtype == np.uint16
        assert json.loads(bytes(z["__dtypes__"])) == {"a.weight": "bfloat16",
                                                      "c.scale": "bfloat16"}
    back = load_params_npz(path)
    assert back.keys() == tensors.keys()
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype
        assert torch.equal(back[k].view(torch.uint8), v.view(torch.uint8)), k


def test_aot_cli_bundle_serves_the_weights(tmp_path):
    """aot_cli from an npz of JAX-layout params, on the CPU: the bundle's
    probabilities are the (numpy) sigmoid of the logits of the model that
    infer_cli loads from the same file."""
    from animal2vec_tpu_torch.tools import aot_cli
    from animal2vec_tpu_torch.tools.infer_cli import load_finetuned

    model = build_finetune_model(CFG, seed=6, device="cpu")
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(params_to_jax(model.state_dict()), ())
    weights = str(tmp_path / "params.npz")
    np.savez(weights, **flat)
    over = [f"{k}={getattr(CFG, k)!r}" for k in (
        "embed_dim", "num_heads", "depth", "prenet_depth", "conv_pos_depth", "conv_pos_width",
        "conv_pos_groups", "average_top_k_layers", "conv_layers")]
    out = str(tmp_path / "bundle")
    assert aot_cli.main(["--weights", weights, "--out", out, "--batch", "2", "--seconds", "1",
                         "--device", "cpu", *over]) == 0
    live = load_finetuned(weights, CFG, torch.device("cpu"))
    src = _source(2, seed=53)
    with torch.no_grad():
        logits = live(src)["encoder_out"].float().numpy()
    np.testing.assert_array_equal(ServingBundle(out).predict_probs(src.numpy()),
                                  1.0 / (1.0 + np.exp(-logits)))


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------


def _op_args(name, device="cpu", b=2, t=40, h=2, d=64, seed=54):
    """Inputs of each serving op at a small shape, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    c, m = h * d, 4 * h * d
    bf = torch.bfloat16
    if name in ("a2v::alibi_attention_serve", "a2v::quantize_qkv_int8",
                "a2v::alibi_attention_int8"):
        qkv = rnd(b, t, 3, h, d).to(device, bf)
        q, k, v = qkv.unbind(2)
        slopes = (torch.rand(h, generator=gen) + 0.1).to(device)
        pos = torch.arange(t, dtype=torch.int32, device=device)[None]
        mask = torch.zeros((b, t), dtype=torch.bool)
        mask[1, -7:] = True
        mask = mask.to(device)
        if name == "a2v::alibi_attention_serve":
            return (q, k, v, slopes, pos, mask, False)
        span, t_pad = attention.int8_spans(t)
        if name == "a2v::quantize_qkv_int8":
            return (q, k, v, t_pad)
        quantized = attention.quantize_qkv_int8_pass_plain(q.cpu(), k.cpu(), v.cpu(), t_pad)
        return (*[x.to(device) for x in quantized], slopes, pos, mask, True, span, bf)
    x = rnd(b, t, c).to(device, bf)
    vec = lambda n: (0.1 * rnd(n)).to(device)
    ln = ((1 + vec(c)), vec(c))
    w1, w2 = (0.05 * rnd(m, c)).to(device, bf), (0.05 * rnd(c, m)).to(device, bf)
    if name == "a2v::fused_block":
        return (x, *ln, w1.t(), w2.t(), vec(m), vec(c), *ln, 1e-5)
    w1_q, w1_s = int8_mm.quantize_weight(w1)
    w2_q, w2_s = int8_mm.quantize_weight(w2)
    if name == "a2v::int8_dense":
        return (x, w1_q, w1_s, vec(m))
    return (x, *ln, w1_q, w1_s, vec(m), w2_q, w2_s, vec(c), *ln, 1e-5)


@pytest.mark.parametrize("name", sorted(kernel_ops.SERVING_OPS))
def test_custom_op_opcheck(name):
    """Schema, fake (meta) implementation, no aliasing and the autograd
    registration of each op on CPU tensors."""
    op = kernel_ops.op(name)
    args = _op_args(name)
    torch.library.opcheck(op.default, args)
    before = kernel_ops.launches()
    op(*args)  # the plain version: no kernel launch counted
    assert kernel_ops.launches() == before


def test_wrappers_route_serving_through_the_ops():
    """The model's wrappers call the ops (the same values), and the fused
    block with dropout or a gradient keeps its training route."""
    args = _op_args("a2v::fused_block")
    got = fused_mlp.fused_block_mlp(*args)
    want = fused_mlp.fused_block_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x = args[0].float().requires_grad_()
    out, _ = fused_mlp.fused_block_mlp(x, *[a.float() if isinstance(a, torch.Tensor) else a
                                            for a in args[1:]])
    assert out.grad_fn is not None and "a2v" not in type(out.grad_fn).__name__


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(kernel_ops.SERVING_OPS))
def test_custom_op_equals_its_launch_code_on_card(cuda, name):
    """The op through the dispatcher against a direct call of its CUDA
    implementation (the launch code): bit for bit, one counted launch
    each."""
    op = kernel_ops.op(name)
    args = _op_args(name, device=cuda, t=333)
    if name == "a2v::alibi_attention_int8":
        q, k, v = _op_args("a2v::alibi_attention_serve", device=cuda, t=333)[:3]
        args = (*attention.quantize_qkv_int8_pass(q, k, v, args[4].shape[-1]), *args[6:])
    launch_code = {
        "a2v::alibi_attention_serve": attention._serve_op,
        "a2v::quantize_qkv_int8": attention._quantize_op,
        "a2v::alibi_attention_int8": attention._attention_int8_op,
        "a2v::fused_block": fused_mlp._block_op, "a2v::fused_block_int8": fused_mlp._block_int8_op,
        "a2v::int8_dense": int8_mm._dense_op}[name]
    counter = kernel_ops.SERVING_OPS[name]
    before = counter.launches
    got = op(*args)
    direct = launch_code._init_fn(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    got = got if isinstance(got, tuple) else (got,)
    direct = direct if isinstance(direct, tuple) else (direct,)
    for a, b in zip(got, direct):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "int8_attn"])
def test_cuda_bundle_matches_eager_on_card(cuda, mode, tmp_path):
    model = _model(mode, device=cuda)
    export_serving(model, str(tmp_path), batch_size=2)
    src = _source(2, device=cuda)
    with torch.no_grad():
        want = model(src)["encoder_out"]
    bundle = ServingBundle(str(tmp_path))
    assert bundle.meta["device_type"] == "cuda"
    kernel_ops.reset_launches()
    got = bundle.forward(src)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    n = CFG.n_blocks
    launched = {k: v for k, v in kernel_ops.launches().items() if v}
    assert launched == ({"a2v::alibi_attention_serve": n, "a2v::fused_block": n}
                        if mode == "bf16" else
                        {"a2v::int8_dense": 2 * n, "a2v::quantize_qkv_int8": n,
                         "a2v::alibi_attention_int8": n, "a2v::fused_block_int8": n})
