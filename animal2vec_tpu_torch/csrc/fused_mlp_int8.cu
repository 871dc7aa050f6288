// Two-layer MLP of a pre-LN block with int8 weights, for serving:
//
//   x_q, xs = quantize_rows(x)
//   h = GELU(fp32(x_q W1_q^T) * xs * w1s + b1)                       fp32
//   h_q, hs = quantize per (row, hidden chunk of `chunk` columns)
//   out = bf16(sum_chunks fp32(h_q W2_q^T) * hs * w2s + b2)
//
// Replaces the TPU kernel animal2vec_tpu/ops/fused_mlp.py:_kernel_int8 (the
// int8 fused_mlp of models/modules.Mlp under matmul_impl int8 / int8_attn).
// Numerics follow it, as fused_block_int8.cu without the LayerNorms: x
// quantized per row over C, per-row dynamic scales max(max|v| *
// fp32(1/127), 1e-12) with an IEEE division and round half to even, int32
// products, fp32 dequant in the TPU kernel's order, exact-erf GELU in fp32
// (the TPU kernel takes the A&S erf, 1.5e-7 apart), h re-quantized per
// (row, chunk) where the chunk is the TPU kernel's hidden block (1024 for
// M = 3072: three scales per row), the int32 sum of fc2 folded into fp32 at
// every chunk boundary, one rounding of the sum + b2.
//
// Design: one C entry makes four launches on the caller's stream:
//   1. quantize_segments     x -> x_q (int8), xs, one warp per row;
//   2. gemm_s8<GELU, fp32>   h = GELU(dequant(x_q W1_q^T) + b1), fp32 (N, M);
//   3. quantize_segments     h -> h_q (int8), hs (N, M / chunk);
//   4. gemm_s8<bf16>         out = bf16(sum over chunks of dequant + b2).
// A chunk's scale needs the max over `chunk` columns of h, eight of the
// GEMM's 128-column tiles, so h goes through device memory in fp32 once.
// The weights come in nn.Linear layout (out, in), the B operand layout of
// the int8 MMA (int8_gemm.cuh).
//
// Bound on the H100 at the ViT-B/16 serving shape (N = 64 x 196 rows,
// C = 768, M = 3072): fc1 + fc2 are 118 GOP of int8 work (0.060 ms at the
// 1,979 TOP/s int8 peak) against 43 MB of x, out, weights and scales
// (0.013 ms): bound by operations. h's traffic (fp32 out and in, int8 out
// and in: 385 MB, 0.12 ms) and mma.sync's fraction of the int8 peak are
// what a later change (a CTA owning whole hidden chunks, wgmma) removes.
#include "int8_gemm.cuh"

// C entry, bound with ctypes. x (N, C) bf16; w1_q (M, C) and w2_q (C2, M)
// int8 (nn.Linear layout); w1_s, b1 (M) and w2_s, b2 (C2) fp32; x_q (N, C)
// int8, x_s (N) fp32, h (N, M) fp32, h_q (N, M) int8 and h_s (N, M / chunk)
// fp32 scratch; out (N, C2) bf16. Returns a cudaError_t.
extern "C" int a2v_fused_mlp_int8(const void* x, const void* w1_q, const void* w1_s,
                                  const void* b1, const void* w2_q, const void* w2_s,
                                  const void* b2, void* x_q, void* x_s, void* h, void* h_q,
                                  void* h_s, void* out, int N, int C, int M, int C2, int chunk,
                                  void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  if (N <= 0 || C <= 0 || C % kS8BK != 0 || M <= 0 || chunk <= 0 || chunk % kS8BK != 0 ||
      M % chunk != 0 || C2 <= 0 || C2 % 8 != 0 || (N + kS8Tile - 1) / kS8Tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* xq = static_cast<int8_t*>(x_q);
  auto* xs = static_cast<float*>(x_s);
  auto* hf = static_cast<float*>(h);
  auto* hq = static_cast<int8_t*>(h_q);
  auto* hs = static_cast<float*>(h_s);
  const int row_tiles = (N + kS8Tile - 1) / kS8Tile;
  cudaError_t err;

  quantize_segments_kernel<bf16><<<quantize_blocks(N), kQuantThreads, 0, s>>>(
      static_cast<const bf16*>(x), xq, xs, N, C, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gemm_s8_kernel<true, float><<<dim3((M + kS8Tile - 1) / kS8Tile, row_tiles), kS8Threads, 0, s>>>(
      xq, static_cast<const int8_t*>(w1_q), xs, static_cast<const float*>(w1_s),
      static_cast<const float*>(b1), hf, N, C, M, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  quantize_segments_kernel<float>
      <<<quantize_blocks(static_cast<long long>(N) * (M / chunk)), kQuantThreads, 0, s>>>(
          hf, hq, hs, N, M, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gemm_s8_kernel<false, bf16><<<dim3((C2 + kS8Tile - 1) / kS8Tile, row_tiles), kS8Threads, 0, s>>>(
      hq, static_cast<const int8_t*>(w2_q), hs, static_cast<const float*>(w2_s),
      static_cast<const float*>(b2), static_cast<bf16*>(out), N, M, C2, chunk);
  return static_cast<int>(cudaGetLastError());
}
