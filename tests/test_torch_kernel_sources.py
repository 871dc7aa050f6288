"""The port's CUDA sources read as text, on the CPU: the C entries of
``animal2vec_tpu_torch/csrc/*.cu`` and ``kernels/build.py``'s ``SIGNATURES``
name the same functions with the same number of arguments, and every
header is reached by the ``#include`` lines of some ``.cu`` source, so that a
removed kernel leaves no declared entry and no orphaned header behind."""

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
