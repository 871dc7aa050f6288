// int8 dense projection of serving, bf16 in and out:
//
//   x_q, xs = quantize_rows(x);  y = bf16(fp32(x_q W_q^T) * xs * ws + bias)
//
// Replaces the TPU kernel animal2vec_tpu/ops/int8_mm.py:_kernel (the
// lane-aligned route of models/modules.quantized_matmul). Numerics follow
// it: x quantized per row over the whole K (scale max(max|x| * fp32(1/127),
// 1e-12), IEEE division, round half to even; int8_quant.cuh), int32 products,
// fp32 dequant in the order (acc * xs) * ws, the fp32 bias, one bf16
// rounding.
//
// Bound on the H100 at the serving shapes (N = 32 x 2000 rows, K = 1024):
// the qkv projection (M = 3072) does 0.40 TOP of int8 work, 0.20 ms at the
// 1,979 TOP/s int8 peak, against 0.53 GB of x, W and y (0.16 ms at 3.35
// TB/s), so it is bound by operations; the out projection (M = 1024) is
// bound by its 0.26 GB of bytes (0.08 ms).
//
// Design: two launches on the caller's stream. The first quantizes x, one
// warp per row, into an int8 (N, K) scratch and its (N,) fp32 scales
// (int8_quant.cuh's quantize_segments_kernel, shared with the int8 MLP; the
// TPU kernel quantizes its row tile into VMEM once per row block,
// here the quantized rows go through device memory, N x K bytes, half of
// x's). The second is the wgmma GEMM of int8_gemm_sm90.cuh with W_q in
// nn.Linear layout (M, K) as its K-major B operand: the int8 tensor cores
// reach their rate only through wgmma, which reads both operands from
// swizzled shared-memory tiles that a 3-stage cp.async ring keeps filled
// (the mma.sync GEMM it replaces was paced by its 32-bit shared-memory
// fragment loads).
#include "int8_gemm_sm90.cuh"
#include "int8_quant.cuh"

// C entry, bound with ctypes. x (N, K) bf16; w_q (M, K) int8; w_s (M,)
// fp32; bias null or (M,) fp32; x_q (N, K) int8 and x_s (N,) fp32 scratch;
// out (N, M) bf16. Returns a cudaError_t.
extern "C" int a2v_int8_dense(const void* x, const void* w_q, const void* w_s,
                              const void* bias, void* x_q, void* x_s, void* out, int N, int K,
                              int M, void* stream) {
  using namespace a2v;
  if (N <= 0 || K <= 0 || K % 64 != 0 || M <= 0 || M % 8 != 0 ||
      (N + kG8Tile - 1) / kG8Tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* xq = static_cast<int8_t*>(x_q);
  auto* xs = static_cast<float*>(x_s);
  quantize_segments_kernel<__nv_bfloat16><<<quantize_blocks(N), kQuantThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), xq, xs, N, K, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm_s8_sm90<kEpiDense>(s, xq, static_cast<const int8_t*>(w_q), xs,
                                       static_cast<const float*>(w_s),
                                       static_cast<const float*>(bias), out, nullptr, N, K, M, K);
}
