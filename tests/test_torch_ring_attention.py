"""The port's ring attention (``ops/ring_attention.py``) and #2's key
positions against the JAX package's, on the CPU.

* #2's plain version with ``positions_k`` (keys at other positions than the
  queries, with a padding mask of the keys) against JAX's ``_pallas_forward
  (..., positions_k=...)`` in interpret mode, out and lse within 1e-5.
* The in-process ring over 2 and 4 shards, and the ring over 4 gloo ranks
  (``tests/torch_dist_workers.py``; 2 ranks run in
  ``tests/test_torch_distributed.py``), against JAX's
  ``ring_attention_sharded`` on the virtual CPU mesh within 2e-3, as
  ``tests/test_ring_attention.py`` holds JAX's ring against full attention,
  with the last 56 of 256 keys padded (the padded query rows compared as
  JAX's test leaves them out).
* ``merge_partials`` of two key halves equals the softmax over all keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from animal2vec_tpu.ops.pallas_attention import _pallas_forward
from animal2vec_tpu.ops.ring_attention import ring_attention_sharded

from animal2vec_tpu_torch.ops.attention import alibi_flash_attention_lse
from animal2vec_tpu_torch.ops.ring_attention import merge_partials, ring_attention_local
from animal2vec_tpu_torch.parallel import mesh

TOL = 2e-3
PLAIN_TOL = 1e-5
LIVE = 200  # keys 200.. are padded


def _inputs(b=1, t=256, h=2, d=8, seed=31):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
               for _ in range(3))
    return {"q": q, "k": k, "v": v, "slopes": torch.tensor([0.5, 0.125]),
            "pos": torch.arange(t, dtype=torch.int32)[None].expand(b, t).contiguous(),
            "pad": (torch.arange(t) >= LIVE)[None].expand(b, t).contiguous()}


def jax_ring(inp, n):
    """JAX's ring over an n-device mesh axis, (B, T, H, D) numpy."""
    ring_mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    j = {k: jnp.asarray(v.numpy()) for k, v in inp.items()}
    return np.asarray(ring_attention_sharded(j["q"], j["k"], j["v"], j["slopes"], j["pos"],
                                             j["pad"], ring_mesh, "data"))


def test_positions_k_plain_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    b, t, h, d = 2, 160, 2, 8
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3))
    slopes = np.asarray([0.3, 0.07], np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    pos_k = (pos + np.asarray([[160], [-160]], np.int32)).astype(np.int32)  # the neighbours
    pad = np.arange(t)[None, :] >= np.asarray([[150], [t]])
    want_out, want_lse = _pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes), jnp.asarray(pos),
        jnp.asarray(pad), positions_k=jnp.asarray(pos_k))
    out, lse = alibi_flash_attention_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(slopes),
        torch.from_numpy(pos), torch.from_numpy(pad), True, torch.from_numpy(pos_k))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=PLAIN_TOL)
    np.testing.assert_allclose(lse.numpy().reshape(b, h, t), np.asarray(want_lse)[..., :t],
                               rtol=0, atol=PLAIN_TOL)


def test_merge_partials_of_two_halves_is_the_full_softmax():
    inp = _inputs(t=64)
    q, k, v, sl, pos = (inp[n] for n in ("q", "k", "v", "slopes", "pos"))
    full, full_lse = alibi_flash_attention_lse(q, k, v, sl, pos)
    # each half's 32 keys against all 64 queries: (B, T) key tensors hold
    # the half and a padded copy of it
    halves = []
    for s in (slice(0, 32), slice(32, 64)):
        kk = torch.cat([k[:, s]] * 2, dim=1)
        vv = torch.cat([v[:, s]] * 2, dim=1)
        pk = torch.cat([pos[:, s]] * 2, dim=1)
        dup = torch.zeros(pos.shape, dtype=torch.bool)
        dup[:, 32:] = True  # the second copy is padding
        out, lse = alibi_flash_attention_lse(q, kk, vv, sl, pos, dup, True, pk)
        halves.append((out, lse.reshape(1, 2, 64)))
    merged, lse = merge_partials(*halves[0], *halves[1])
    np.testing.assert_allclose(merged.numpy(), full.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy().reshape(-1), full_lse.numpy().reshape(-1), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_in_process_ring_matches_jax(n):
    inp = _inputs()
    want = jax_ring(inp, n)
    got = ring_attention_local(inp["q"], inp["k"], inp["v"], inp["slopes"], inp["pos"],
                               inp["pad"], n)
    np.testing.assert_allclose(got.numpy()[:, :LIVE], want[:, :LIVE], rtol=TOL, atol=TOL)


def test_four_rank_ring_matches_jax(tmp_path):
    inp = _inputs()
    torch.save({"ring": inp}, tmp_path / "inputs.pt")
    mesh.launch(["-m", "tests.torch_dist_workers", "ring", str(tmp_path)], 4,
                env={"OMP_NUM_THREADS": "1"}, timeout=180)
    got = torch.load(tmp_path / "result_0.pt", weights_only=False)["ring"]["ring"]
    want = jax_ring(inp, 4)
    np.testing.assert_allclose(got.numpy()[:, :LIVE], want[:, :LIVE], rtol=TOL, atol=TOL)
