"""ctypes bindings of the C++ batch audio loader (``a2v_runtime.cc``).

The port of ``animal2vec_tpu/runtime/native.py``: the same C source (a copy
kept equal to the original by ``tests/test_torch_runtime.py``), the same
entries and errors. ``decode_batch`` decodes, normalizes and pads or crops
a batch of wav files on a pool of C++ threads; in training each long clip
is cropped at ``xorshift(seed * 0x9E3779B97F4A7C15 + i + 1)`` modulo the
free length, which ``data.dataset.BatchLoader`` takes by default, so that
the port crops where the JAX loader does.

The library is built at first use (never at import) by ``g++ -O3
-std=c++17 -fPIC -pthread -shared`` into ``_build/runtime-<hash>/``, keyed
by a hash of the source and the flags, under the kernels' file lock
(``kernels.build.build_lock``), so that processes starting together build
it once. A failed build or load raises: no caller falls back to the Python
decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from animal2vec_tpu_torch.kernels.build import BUILD_ROOT, build_lock

SOURCE = Path(__file__).resolve().with_name("a2v_runtime.cc")
LIB_NAME = "liba2v_runtime.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None  # the loaded library, once built


def library_path() -> Path:
    """Where this source and these flags build the library."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"runtime-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library if this source hash has none yet (one process at
    a time); return its path. Raises RuntimeError if the compiler fails."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with build_lock(lib.parent):
        if lib.is_file():  # built by the process that held the lock
            return lib
        tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the batch loader failed ({' '.join(cmd)}, exit "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)  # atomic: a concurrent reader sees whole files only
    return lib


def ensure_built() -> bool:
    """Build (at first use) and load the library with its C signatures;
    True, or raises if the build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.a2v_wav_info.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ]
            lib.a2v_wav_info.restype = ctypes.c_int
            lib.a2v_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
            lib.a2v_decode_batch.restype = ctypes.c_int
            _lib = lib
    return True


def available() -> bool:
    """JAX's name for ``ensure_built``: True once the library loads; a
    failed build raises here too."""
    return ensure_built()


def wav_info_native(path: str) -> Tuple[int, int]:
    """(frames, sample rate) of a wav file; ValueError if it cannot be
    decoded."""
    ensure_built()
    frames = ctypes.c_int64()
    sr = ctypes.c_int()
    if _lib.a2v_wav_info(path.encode(), ctypes.byref(frames), ctypes.byref(sr)) != 0:
        raise ValueError(f"cannot decode {path}")
    return int(frames.value), int(sr.value)


def decode_batch(
    paths: List[str],
    target_len: int,
    normalize: bool = True,
    train: bool = True,
    seed: int = 0,
    expected_sr: int = 0,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode, normalize and pad or crop a batch: (out (N, target_len)
    float32, valid lengths (N,), crop starts (N,)). Long clips are cropped
    at random (seeded, ``train``) or in the center; ValueError names the
    files that fail to decode or do not have ``expected_sr`` (0: any)."""
    ensure_built()
    n = len(paths)
    out = np.empty((n, target_len), dtype=np.float32)
    valid = np.empty((n,), dtype=np.int64)
    starts = np.empty((n,), dtype=np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = _lib.a2v_decode_batch(
        arr, n, target_len, int(normalize), int(train), ctypes.c_uint64(seed), expected_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        num_threads,
    )
    if failures:
        bad = [paths[i] for i in range(n) if valid[i] == 0]
        raise ValueError(f"{failures} files failed to decode, e.g. {bad[:3]}")
    return out, valid, starts
