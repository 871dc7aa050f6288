"""The port's CUDA sources read as text, on the CPU: the C entries of
``animal2vec_tpu_torch/csrc/*.cu`` and ``kernels/build.py``'s ``SIGNATURES``
name the same functions with the same number of arguments, and every
header is reached by the ``#include`` lines of some ``.cu`` source, so that a
removed kernel leaves no declared entry and no orphaned header behind; the
arguments that data parallelism and ring attention added (#2's key
positions, #6's row offset) sit where ``SIGNATURES`` declares them."""

import ctypes
import re

from animal2vec_tpu_torch.kernels.build import CSRC, SIGNATURES

ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)


def test_c_entries_match_signatures():
    entries = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            assert name not in entries, f"{name} defined twice"
            entries[name] = len(params.split(","))
    assert sorted(entries) == sorted(SIGNATURES)
    for name, n_params in entries.items():
        assert len(SIGNATURES[name]) == n_params, name


def test_every_header_is_included():
    reached, todo = set(), [p.name for p in CSRC.glob("*.cu")]
    while todo:
        for name in INCLUDE.findall((CSRC / todo.pop()).read_text()):
            assert (CSRC / name).is_file(), f"missing header {name}"
            if name not in reached:
                reached.add(name)
                todo.append(name)
    assert sorted(reached) == sorted(p.name for p in CSRC.glob("*.cuh"))


def _params(entry: str) -> list:
    for src in CSRC.glob("*.cu"):
        for name, params in ENTRY.findall(src.read_text()):
            if name == entry:
                return [p.split()[-1].lstrip("*") for p in params.split(",")]
    raise KeyError(entry)


def test_key_positions_and_row_offset_arguments():
    fwd = _params("a2v_alibi_attention_fwd")
    assert fwd[7:13] == ["pos", "pos_per_row", "pos_k", "posk_per_row", "mask", "mask_per_row"]
    sig = SIGNATURES["a2v_alibi_attention_fwd"]
    assert sig[9] is ctypes.c_void_p and sig[10] is ctypes.c_int
    block = _params("a2v_fused_block")
    assert block[-4:] == ["row0", "branch_scale", "rows_per_scale", "stream"]
    assert SIGNATURES["a2v_fused_block"][-4] is ctypes.c_uint
    assert SIGNATURES["a2v_fused_block"][-3:-1] == (ctypes.c_void_p, ctypes.c_int)
    mlp = _params("a2v_fused_mlp")
    assert mlp[-6:] == ["seed_act", "seed_fc2", "thresh", "keep_scale", "row0", "stream"]
    assert SIGNATURES["a2v_fused_mlp"][-2] is ctypes.c_uint
