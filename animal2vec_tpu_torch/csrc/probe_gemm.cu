// Row-blocked bf16 GEMM probe: the bf16 GEMM core of #6 and #8
// (bf16_gemm_sm90.cuh) without bias, GELU or dropout, swept over its row
// tile.
//
//   C[M, N] = bf16(x[M, K] w[K, N])   fp32 sums
//
// Replaces the TPU kernel bench/pallas_mm.py:18 pallas_mm (pallas_call at
// :28), a tuning probe that ran one (block_m, K) x (K, N) dot per grid step
// at the frontend's (65536, 512) @ (512, 512) and swept block_m. Here
// block_m is the core's row tile BM: 64 rows (one warpgroup), 128 (two, the
// tile of #6 and #8) or 256 (four), each block owning BM x 128 outputs.
// The output tile, the 64-deep K step, the 3-stage cp.async ring, the
// wgmma m64n128k16 SS products and the staged 16-byte stores are the
// core's own, so the probe times #6's and #8's GEMM loop with their
// epilogue (bias, GELU, dropout) taken out.
//
// w is read as the core reads nn.Linear weights: K-major, (N, K) row-major.
// The wrapper takes w as a (K, N) view of such a tensor (w = wt.t()), and
// the probes make wt once, outside any timed call; nothing is transposed
// per launch.
//
// Bound on the H100: 2 M K N operations against (M K + K N + M N) x 2
// bytes. The frontend's (65536, 512) @ (512, 512) is 34.4 GFLOP (0.035 ms
// at the 989 TFLOP/s bf16 peak) against 0.135 GB (0.040 ms at 3.35 TB/s):
// bound by bytes, at 256 operations a byte. #6's fc1 and fc2 at b32
// (64 000 x 1024 -> 4096 and back) are 0.537 TFLOP each (0.543 ms), #8's
// at the ViT-B/16 widths (12 544 x 768 -> 3072 and back) 59.2 GFLOP
// (0.060 ms): bound by operations.
#include "bf16_gemm_sm90.cuh"

// C entry, bound with ctypes. x (M, K) and wt (N, K) bf16 row-major, c (M,
// N) bf16; all 16-byte aligned; K a multiple of 64 and N of 8; block_m 64,
// 128 or 256. Returns a cudaError_t.
extern "C" int a2v_probe_gemm(const void* x, const void* wt, void* c, int M, int K, int N,
                              int block_m, void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M <= 0 || K <= 0 || K % kG16BK != 0 || N <= 0 || N % 8 != 0 ||
      (M + block_m - 1) / block_m > 65535 || misaligned(x) || misaligned(wt) || misaligned(c))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(wt);
  auto* cb = static_cast<bf16*>(c);
  switch (block_m) {
    case 64:
      return launch_gemm_sm90_nobias<64>(s, xb, wb, cb, M, K, N);
    case 128:
      return launch_gemm_sm90_nobias<128>(s, xb, wb, cb, M, K, N);
    case 256:
      return launch_gemm_sm90_nobias<256>(s, xb, wb, cb, M, K, N);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
