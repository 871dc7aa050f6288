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
// Design: four launches on the caller's stream, the int8 block's (#7,
// fused_block_int8.cu) without its LayerNorms:
//   1. quantize_segments     x -> x_q (int8), xs, one warp per row;
//   2. fc1, gemm_s8_sm90<kEpiGeluF32>: h = GELU(dequant(x_q W1_q^T) + b1),
//      fp32 (N, M), and each row's max |h| over every 128 columns, (N, M /
//      128) fp32;
//   3. quantize_chunks       h -> h_q (int8), hs (N, M / chunk): the chunk's
//      scale from its partial maxima, so h is read once;
//   4. fc2, gemm_s8_sm90<kEpiSegBf16>: out = bf16(sum over chunks of
//      dequant + b2), the int32 sum restarting at every chunk.
// Both GEMMs are int8_gemm_sm90.cuh's wgmma core (128 x 128 tiles, a
// 3-stage cp.async ring, two blocks an SM); the quantizers are
// int8_quant.cuh's. The int32 sums are exact and every dequant step is
// rounded on its own in the order above, so the output is that of the
// mma.sync design this replaces bit for bit (it was paced by its 32-bit
// shared-memory fragment loads, and its h quantizer read h twice). The
// weights come in nn.Linear layout (out, in), wgmma's K-major B operand.
//
// Bound on the H100 at the ViT-B/16 serving shape (N = 64 x 196 rows,
// C = 768, M = 3072): fc1 + fc2 are 118 GOP of int8 work (0.060 ms at the
// 1,979 TOP/s int8 peak) against 43 MB of x, out, weights and scales
// (0.013 ms): bound by operations. h goes through device memory (fp32
// written and read, int8 written and read: 385 MB, 0.115 ms at 3.35 TB/s),
// because a chunk's scale needs the max over 1024 columns of h, eight of
// fc1's 128-column tiles.
#include "int8_gemm_sm90.cuh"
#include "int8_quant.cuh"

// C entry, bound with ctypes. x (N, C) bf16; w1_q (M, C) and w2_q (C2, M)
// int8 (nn.Linear layout); w1_s, b1 (M) and w2_s, b2 (C2) fp32; x_q (N, C)
// int8, x_s (N) fp32, h (N, M) fp32, h_max (N, M / 128) fp32, h_q (N, M)
// int8 and h_s (N, M / chunk) fp32 scratch; out (N, C2) bf16. Needs C % 16,
// M % 128, chunk % 128 (M % chunk) and C2 % 2. Returns a cudaError_t.
extern "C" int a2v_fused_mlp_int8(const void* x, const void* w1_q, const void* w1_s,
                                  const void* b1, const void* w2_q, const void* w2_s,
                                  const void* b2, void* x_q, void* x_s, void* h, void* h_max,
                                  void* h_q, void* h_s, void* out, int N, int C, int M, int C2,
                                  int chunk, void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  if (N <= 0 || C <= 0 || C % 16 != 0 || M <= 0 || M % kG8Tile != 0 || chunk <= 0 ||
      chunk % kG8BK != 0 || chunk > 32 * kQuantPartCols || M % chunk != 0 || C2 <= 0 ||
      C2 % 2 != 0 || (N + kG8Tile - 1) / kG8Tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* xq = static_cast<int8_t*>(x_q);
  auto* xs = static_cast<float*>(x_s);
  auto* hf = static_cast<float*>(h);
  auto* hm = static_cast<float*>(h_max);
  auto* hq = static_cast<int8_t*>(h_q);
  auto* hs = static_cast<float*>(h_s);
  cudaError_t err;

  quantize_segments_kernel<bf16><<<quantize_blocks(N), kQuantThreads, 0, s>>>(
      static_cast<const bf16*>(x), xq, xs, N, C, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_s8_sm90<kEpiGeluF32>(
           s, xq, static_cast<const int8_t*>(w1_q), xs, static_cast<const float*>(w1_s),
           static_cast<const float*>(b1), hf, hm, N, C, M, C))) != cudaSuccess)
    return static_cast<int>(err);
  quantize_chunks_kernel<<<quantize_blocks(static_cast<long long>(N) * (M / chunk)),
                           kQuantThreads, 0, s>>>(hf, hm, hq, hs, N, M, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return launch_gemm_s8_sm90<kEpiSegBf16>(s, hq, static_cast<const int8_t*>(w2_q), hs,
                                         static_cast<const float*>(w2_s),
                                         static_cast<const float*>(b2), out, nullptr, N, M, C2,
                                         chunk);
}
