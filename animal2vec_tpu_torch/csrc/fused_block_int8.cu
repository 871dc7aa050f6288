// Post-LN MLP sub-block of an AltBlock with int8 weights, for serving:
//
//   r = bf16(LN1(x));  r_q, rs = quantize_rows(r)
//   h = GELU(fp32(r_q W1_q^T) * rs * w1s + b1)                       fp32
//   h_q, hs = quantize per (row, hidden chunk of `chunk` columns)
//   t = bf16(sum_chunks fp32(h_q W2_q^T) * hs * w2s + b2)
//   x_out = bf16(LN2(bf16(r + t)))                                   -> (x_out, t)
//
// Replaces the TPU kernel animal2vec_tpu/ops/fused_mlp.py:_kernel_int8_block.
// Numerics follow it: fp32 LayerNorm statistics, r quantized from its bf16
// cast-back, per-row dynamic scales max(max|v| * fp32(1/127), 1e-12) with an
// IEEE division and round half to even, int32 products, fp32 dequant in
// the TPU kernel's order, exact-erf GELU in fp32 (the TPU kernel takes the
// A&S erf, 1.5e-7 apart), h re-quantized per (row, chunk) where the chunk
// is the TPU kernel's hidden block (1024 for a2v-large's M = 4096: four
// scales per row), the int32 sum of fc2 restarting at every chunk, the tap
// t rounded to bf16 after + b2, the residual add in bf16 before LN2's fp32
// statistics.
//
// Design: one C entry makes five launches on the caller's stream:
//   1. ln_rows<QUANT>        x -> r (bf16), r_q (int8), rs, one warp per row
//      (layernorm.cuh: the row in registers for C <= 1024, re-read past it);
//   2. fc1, gemm_s8_sm90<kEpiGeluF32>: h = GELU(dequant(r_q W1_q^T) + b1),
//      fp32 (N, M), and each row's max |h| over every 128 columns, (N, M /
//      128) fp32;
//   3. quantize_chunks       h -> h_q (int8), hs (N, M / chunk): the chunk's
//      scale from its partial maxima, so h is read once (int8_quant.cuh);
//   4. fc2, gemm_s8_sm90<kEpiSegBf16>: t = bf16(sum over chunks of dequant +
//      b2), the int32 sum restarting at every chunk;
//   5. ln_rows<RESID>        x_out = LN2(bf16(r + t)).
// Both GEMMs are int8_gemm_sm90.cuh's wgmma core on 128 x 128 tiles, two
// blocks an SM (fc2's fp32 chunk sums spill to local memory and are
// touched only at the folds: measured faster than the unspilled
// alternatives, int8_gemm_sm90.cuh). A chunk's scale needs the max over
// `chunk` (1024) columns of h, eight of fc1's 128-column tiles, so h goes
// through device memory in fp32 once (N x M x 4 B written and read, then N
// x M int8 written and read by fc2). The weights come in nn.Linear layout
// (out, in), wgmma's K-major B operand.
//
// Bound on the H100 at the serving shape (N = 32 x 2000 rows, C = 1024,
// M = 4096): fc1 + fc2 are 1.07 TOP of int8 work per layer, 0.54 ms at the
// 1,979 TOP/s int8 peak, against 0.40 GB of x, x_out, t and the weights
// (0.12 ms at 3.35 TB/s): bound by operations. h's round trip adds 2.6 GB
// (fp32 out and in, int8 out and in: ~0.8 ms at 3.35 TB/s), which a block
// owning whole hidden chunks (128 rows x 1024 fp32 columns of h do not fit
// in shared memory) would avoid.
#include "int8_gemm_sm90.cuh"
#include "int8_quant.cuh"
#include "layernorm.cuh"

// C entry, bound with ctypes. x, r, t, x_out: (N, C) bf16; w1_q (M, C) and
// w2_q (C, M) int8 (nn.Linear layout); w1_s (M), w2_s (C), b1 (M), b2 (C)
// and the LayerNorm scales/biases (C) fp32; r_q (N, C) int8, r_s (N) fp32,
// h (N, M) fp32, h_max (N, M / 128) fp32, h_q (N, M) int8 and h_s (N, M /
// chunk) fp32 scratch. Returns a cudaError_t.
extern "C" int a2v_fused_block_int8(
    const void* x, const void* ln1_scale, const void* ln1_bias, const void* w1_q,
    const void* w1_s, const void* b1, const void* w2_q, const void* w2_s, const void* b2,
    const void* ln2_scale, const void* ln2_bias, void* r, void* r_q, void* r_s, void* h,
    void* h_max, void* h_q, void* h_s, void* t, void* x_out, int N, int C, int M, int chunk,
    float eps, void* stream) {
  using namespace a2v;
  if (N <= 0 || C <= 0 || C % 128 != 0 || M <= 0 || M % 128 != 0 || chunk <= 0 || chunk % kG8BK != 0 || chunk > 32 * kG8Tile ||
      M % chunk != 0 || (N + kG8Tile - 1) / kG8Tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* rb = static_cast<bf16*>(r);
  auto* rq = static_cast<int8_t*>(r_q);
  auto* rs = static_cast<float*>(r_s);
  auto* hf = static_cast<float*>(h);
  auto* hm = static_cast<float*>(h_max);
  auto* hq = static_cast<int8_t*>(h_q);
  auto* hs = static_cast<float*>(h_s);
  auto* tb = static_cast<bf16*>(t);
  const DropSite none{0u, 0u, 1.f};
  cudaError_t err;

  if ((err = static_cast<cudaError_t>(launch_ln_rows<false, false, true>(
           s, static_cast<const bf16*>(x), nullptr, static_cast<const float*>(ln1_scale),
           static_cast<const float*>(ln1_bias), rb, rq, rs, N, C, eps, none))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_s8_sm90<kEpiGeluF32>(
           s, rq, static_cast<const int8_t*>(w1_q), rs, static_cast<const float*>(w1_s),
           static_cast<const float*>(b1), hf, hm, N, C, M, C))) != cudaSuccess)
    return static_cast<int>(err);
  const long long items = static_cast<long long>(N) * (M / chunk);
  quantize_chunks_kernel<<<quantize_blocks(items), kQuantThreads, 0, s>>>(hf, hm, hq, hs, N, M,
                                                                          chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_s8_sm90<kEpiSegBf16>(
           s, hq, static_cast<const int8_t*>(w2_q), hs, static_cast<const float*>(w2_s),
           static_cast<const float*>(b2), tb, nullptr, N, M, C, chunk))) != cudaSuccess)
    return static_cast<int>(err);
  return launch_ln_rows<true, false, false>(
      s, rb, tb, static_cast<const float*>(ln2_scale), static_cast<const float*>(ln2_bias),
      static_cast<bf16*>(x_out), nullptr, nullptr, N, C, eps, none);
}
