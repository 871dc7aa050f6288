"""Build and load the Hopper kernels of ``animal2vec_tpu_torch/csrc``.

The ``.cu`` sources are compiled by ``nvcc`` for ``sm_90a``, one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface, which ``ctypes`` loads. The build runs at
first use (never at import), into ``animal2vec_tpu_torch/_build/<hash>/``
keyed by a hash of the sources and flags, so a fresh checkout builds once
and a changed source rebuilds. ``nvcc``'s register/spill report
(``-Xptxas -v``) is kept beside the library as ``build.log``.

Ranks that start together (data parallelism, one process per card) share
the build directory: a file lock (``build.lock``, ``fcntl.flock``) lets one
process compile while the others wait for it, up to ``LOCK_TIMEOUT_S``,
and then load its library instead of compiling the same sources again.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
LIB_NAME = "liba2v_kernels.so"
LOCK_TIMEOUT_S = 900.0  # a rank waits this long for another rank's build
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
# dropout arguments of the attention entries: seed, threshold, keep scale
_DROP = (_I, _U, _F)
# the ALiBi entries' dropout-hash head offset: h0, hash_heads
_HEADS = (_I, _I)
# the ALiBi forward's and backward's arguments (below)
_FWD = (_P, _P, _P, _L, _L, _L, _P, _P, _I, _P, _I, _P, _I, _P, _L, _L, _L, _P) + (_I,) * 5 \
    + (_F,) + _DROP + _HEADS + (_P,)
_BWD = (_P,) * 6 + (_I, _P, _I, _P, _P) + (_I,) * 5 + (_F,) + _DROP + _HEADS + (_P,)
# the dense-bias forward's and its three backward entries' arguments (below)
_BIAS_FWD = (_P, _P, _P, _L, _L, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F) + _DROP + (_P,)
_BIAS_DQ = (_P, _P, _P, _L, _L, _P, _P, _P, _P, _I, _P, _P, _L, _L, _P) + (_I,) * 4 + (_F,) \
    + _DROP + (_P,)
_BIAS_DKV = (_P, _P, _P, _L, _L, _P, _P, _P, _P, _I, _P, _P, _P, _L, _L) + (_I,) * 4 + (_F,) \
    + _DROP + (_P,)
_BIAS_SINGLE = (_P, _P, _P, _L, _L, _P, _P, _P, _P, _I, _P, _P, _P, _P, _L, _L, _P) \
    + (_I,) * 4 + (_F,) + _DROP + (_P,)
# C signatures of the entries in csrc/*.cu; every entry returns a cudaError_t
SIGNATURES = {
    # q, k, v, stride_b, stride_t, stride_h, slopes, pos, pos_per_row, pos_k,
    # posk_per_row, mask, mask_per_row, out, out_stride_b, out_stride_t,
    # out_stride_h, lse, B, H, T, D, has_sentinel, sm_scale, seed, thresh,
    # keep_scale, h0, hash_heads, stream
    "a2v_alibi_attention_fwd": _FWD,
    # qkv, dout, lse, delta, slopes, pos, pos_per_row, mask, mask_per_row, dq,
    # dslope_part, B, H, T, D, has_sentinel, sm_scale, seed, thresh,
    # keep_scale, h0, hash_heads, stream
    "a2v_alibi_attention_bwd_dq": _BWD,
    # as bwd_dq with dk, dv in place of dq, dslope_part
    "a2v_alibi_attention_bwd_dkv": _BWD,
    # the fp32 instances of the three (fp32 q, k, v, out; qkv, dout, dq, dk,
    # dv): the same arguments
    "a2v_alibi_attention_fwd_f32": _FWD,
    "a2v_alibi_attention_bwd_dq_f32": _BWD,
    "a2v_alibi_attention_bwd_dkv_f32": _BWD,
    # x, ln1_scale, ln1_bias, w1t, b1, w2t, b2, ln2_scale, ln2_bias, r, h, t,
    # x_out, N, C, M, eps, seed_act, seed_fc2, seed_post, act_thresh,
    # act_scale, post_thresh, post_scale, row0, branch_scale, rows_per_scale,
    # stream
    "a2v_fused_block": (_P,) * 13 + (_I, _I, _I, _F, _I, _I, _I, _U, _F, _U, _F, _U, _P, _I,
                                      _P),
    # the fp32 block: x, ln1_scale, ln1_bias, w1t, b1, w2t, b2, ln2_scale,
    # ln2_bias, r, rs, w1s, w2s, hs, t, x_out, then as a2v_fused_block from N
    "a2v_fused_block_f32": (_P,) * 16 + (_I, _I, _I, _F, _I, _I, _I, _U, _F, _U, _F, _U, _P,
                                          _I, _P),
    # the tensor-parallel split of #6: x, ln1_scale, ln1_bias, w1t, b1, r, h,
    # N, C, Ms, eps, seed_act, act_thresh, act_scale, row0, col0, stream
    "a2v_block_fc1": (_P,) * 7 + (_I, _I, _I, _F, _I, _U, _F, _U, _U, _P),
    # h, w2t, partial, N, Ms, C, stream
    "a2v_block_fc2_partial": (_P,) * 3 + (_I,) * 3 + (_P,),
    # S, b2, r, ln2_scale, ln2_bias, t, x_out, N, C, eps, seed_fc2,
    # act_thresh, act_scale, seed_post, post_thresh, post_scale, row0,
    # branch_scale, rows_per_scale, stream
    "a2v_block_ln2": (_P,) * 7 + (_I, _I, _F, _I, _U, _F, _I, _U, _F, _U, _P, _I, _P),
    # x, w_q, w_s, bias, x_q, x_s, out, N, K, M, stream
    "a2v_int8_dense": (_P,) * 7 + (_I,) * 3 + (_P,),
    # x, ln1_scale, ln1_bias, w1_q, w1_s, b1, w2_q, w2_s, b2, ln2_scale,
    # ln2_bias, r, r_q, r_s, h, h_max, h_q, h_s, t, x_out, N, C, M, chunk, eps,
    # stream
    "a2v_fused_block_int8": (_P,) * 20 + (_I,) * 4 + (_F, _P),
    # q, k, v, stride_b, stride_t, stride_h, q8, qs, k8, ks, v8t, vsc, B, H, T,
    # D, t_pad, q_scale, stream
    "a2v_quantize_qkv_int8": (_P,) * 3 + (_L,) * 3 + (_P,) * 6 + (_I,) * 5 + (_F, _P),
    # q8, qs, k8, ks, v8t, vsc, slopes, pos, pos_per_row, mask, mask_per_row,
    # out, o_acc, B, H, T, D, t_pad, span, has_sentinel, stream
    "a2v_alibi_attention_int8": (_P,) * 8 + (_I, _P, _I, _P, _P) + (_I,) * 7 + (_P,),
    # q, k, v, stride_b, stride_t, bias, bias_uniform, mask, out, lse, B, H, T,
    # D, sm_scale, seed, thresh, keep_scale, stream
    "a2v_bias_attention": _BIAS_FWD,
    # q, k, v, stride_b, stride_t, dout, lse, delta, bias, bias_uniform, mask,
    # dq, out_stride_b, out_stride_t, dbias, B, H, T, D, sm_scale, seed, thresh,
    # keep_scale, stream
    "a2v_bias_attention_bwd_dq": _BIAS_DQ,
    # q, k, v, stride_b, stride_t, dout, lse, delta, bias, bias_uniform, mask,
    # dk, dv, out_stride_b, out_stride_t, B, H, T, D, sm_scale, seed, thresh,
    # keep_scale, stream
    "a2v_bias_attention_bwd_dkv": _BIAS_DKV,
    # q, k, v, stride_b, stride_t, dout, lse, delta, bias, bias_uniform, mask,
    # dq, dk, dv, out_stride_b, out_stride_t, dbias, B, H, T, D, sm_scale,
    # seed, thresh, keep_scale, stream
    "a2v_bias_attention_bwd_single": _BIAS_SINGLE,
    # the fp32 instances of the four (fp32 q, k, v, out; dout, dq, dk, dv):
    # the same arguments
    "a2v_bias_attention_f32": _BIAS_FWD,
    "a2v_bias_attention_bwd_dq_f32": _BIAS_DQ,
    "a2v_bias_attention_bwd_dkv_f32": _BIAS_DKV,
    "a2v_bias_attention_bwd_single_f32": _BIAS_SINGLE,
    # x, w1, b1, w2, b2, h, out, N, C, M, C2, seed_act, seed_fc2, thresh,
    # keep_scale, row0, stream
    "a2v_fused_mlp": (_P,) * 7 + (_I,) * 6 + (_U, _F, _U, _P),
    # the fp32 MLP: x, w1, b1, w2, b2, xs, w1s, w2s, hs, out, then as
    # a2v_fused_mlp from N
    "a2v_fused_mlp_f32": (_P,) * 10 + (_I,) * 6 + (_U, _F, _U, _P),
    # x, w1_q, w1_s, b1, w2_q, w2_s, b2, x_q, x_s, h, h_max, h_q, h_s, out, N,
    # C, M, C2, chunk, stream
    "a2v_fused_mlp_int8": (_P,) * 14 + (_I,) * 5 + (_P,),
    # the probes (animal2vec_tpu_torch/probes/)
    # qkv, scaled_pos, out, B, H, T, D, variant, block_k, sm_scale, stream
    "a2v_probe_attention": (_P,) * 3 + (_I,) * 6 + (_F, _P),
    # x, wt, c, M, K, N, block_m, stream
    "a2v_probe_gemm": (_P,) * 3 + (_I,) * 4 + (_P,),
    # a, bt, out, M, K, N, iters, route, block_n, resident, stream
    "a2v_probe_mma": (_P,) * 3 + (_I,) * 7 + (_P,),
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the Hopper kernels are "
        "built from source and need the CUDA toolkit"
    )


@contextlib.contextmanager
def build_lock(out_dir: Path, timeout: float = LOCK_TIMEOUT_S):
    """Hold ``out_dir/build.lock`` exclusively; raise after ``timeout`` s."""
    with open(out_dir / "build.lock", "a") as f:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{out_dir}: another process held the kernel build lock "
                                       f"for {timeout:.0f} s")
                time.sleep(0.2)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile the kernels if this source hash has no library yet (one
    process at a time, under the build lock); return the library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with build_lock(out_dir):
        if lib.is_file():  # built by the process that held the lock
            return lib
        return _compile(out_dir, lib)


def _compile(out_dir: Path, lib: Path) -> Path:
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs, jobs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    log = []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            (out_dir / "build.log").write_text("\n".join(log))
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out[-4000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
           *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    (out_dir / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees whole files only
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def require_bf16(what: str, *dtypes) -> None:
    """Raise unless every dtype is bf16: for a kernel whose fp32 instance is
    still to be written (ROADMAP A.13). The ALiBi kernels (#1-#4), the fused
    post-LN block (#6), the fused pre-LN MLP (#8) and the dense-bias
    attention with its backward (#11, #11b) take fp32 as well; the int8
    kernels (#5 and its pass, #7, #9, #10) and #6's tensor-parallel split
    (#6s) call this."""
    for dtype in dtypes:
        if str(dtype) != "torch.bfloat16":
            raise ValueError(f"{what} takes bf16 on the card, got {dtype}: its fp32 instance is "
                             "not ported yet (ROADMAP A.13)")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
