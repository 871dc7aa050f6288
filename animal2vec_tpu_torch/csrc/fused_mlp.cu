// Plain two-layer MLP of a pre-LN block, bf16 storage (a2v_fused_mlp; the
// fp32 storage of JAX's default compute dtype: a2v_fused_mlp_f32 below),
// with the training activation dropout at two hash sites:
//
//   h = bf16(drop_a(GELU(x W1^T + b1)));  out = bf16(drop_b(h W2^T + b2))
//
// Replaces the TPU kernel animal2vec_tpu/ops/fused_mlp.py:_kernel_bf16 (the
// fused_mlp of models/modules.Mlp, which pre-LN AltBlocks run). Numerics
// follow it: both products bf16 x bf16 with fp32 accumulation, the bias and
// the exact-erf GELU in fp32 (the TPU kernel takes the A&S erf, 1.5e-7
// apart), h rounded to bf16 before fc2, one rounding of fc2's sum + b2. The
// TPU kernel sums fc2 over 1024-wide hidden chunks into an fp32 scratch;
// here one fp32 accumulator runs over the whole hidden width (the same sum
// in another order). The TPU kernel has no dropout (JAX's training pre-LN
// block composes its MLP in XLA); here drop_a (seed 0) and drop_b (seed 1)
// are the fused post-LN block's first two sites: keep = drop_hash(seed,
// row0 + row, column) >= threshold (common.cuh), applied to the fp32 value
// before its rounding and scaled by 1 / (1 - rate), bit for bit the masks of
// ops/dropout.hash_keep. A threshold of 0 launches the instances without
// dropout, as before the sites were added.
//
// Design: one C entry makes two launches of bf16_gemm_sm90.cuh's GEMM
// (wgmma m64n128k16 on 128-byte swizzled tiles behind a 3-stage cp.async
// ring, 128 x 128 output tiles) on the caller's stream, as fused_block.cu
// does without its two LayerNorms and its dropout:
//   1. gemm_bf16_sm90<GELU>  h = GELU(x W1^T + b1), bf16 (N, M) scratch;
//   2. gemm_bf16_sm90        out = h W2^T + b2.
// Both weights come in nn.Linear layout, K-major as wgmma reads them. h
// goes through device memory.
//
// Bound on the H100 at the ViT-B/16 serving shape (N = 64 x 196 rows,
// C = 768, M = 3072): fc1 + fc2 are 118 GFLOP (0.12 ms at the 989 TFLOP/s
// bf16 peak) against 48 MB of x, out and weights (0.014 ms): bound by
// operations. h's round trip adds 2 x N x M x 2 B = 154 MB (0.05 ms).
#include "bf16_gemm_sm90.cuh"

// C entry, bound with ctypes. x (N, C) bf16; w1 (M, C) and w2 (C2, M) bf16
// (nn.Linear layout); b1 (M) and b2 (C2) fp32; h (N, M) bf16 scratch; out
// (N, C2) bf16. x, the weights, h and out 16-byte aligned; C and M
// multiples of 64 (the GEMM's K step), M and C2 multiples of 8. seed_act and
// seed_fc2 are the two int32 dropout seeds [after GELU, after fc2], thresh
// their keep threshold (0: no dropout) and keep_scale 1 / (1 - rate); the
// masks' rows start at row0. Returns a cudaError_t.
extern "C" int a2v_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* h, void* out, int N, int C, int M, int C2,
                             int seed_act, int seed_fc2, unsigned int thresh, float keep_scale,
                             unsigned int row0, void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (N <= 0 || C <= 0 || C % kG16BK != 0 || M <= 0 || M % kG16BK != 0 || C2 <= 0 ||
      C2 % 8 != 0 || (N + kG16BM - 1) / kG16BM > 65535 || misaligned(x) || misaligned(w1) ||
      misaligned(w2) || misaligned(h) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0u;
  const DropSite site_act{static_cast<uint32_t>(seed_act), thresh, keep_scale, row0};
  const DropSite site_fc2{static_cast<uint32_t>(seed_fc2), thresh, keep_scale, row0};
  auto* hb = static_cast<bf16*>(h);
  const int err = launch_gemm_sm90<true>(drop, s, static_cast<const bf16*>(x),
                                         static_cast<const bf16*>(w1),
                                         static_cast<const float*>(b1), hb, N, C, M, site_act);
  if (err != 0) return err;
  return launch_gemm_sm90<false>(drop, s, hb, static_cast<const bf16*>(w2),
                                 static_cast<const float*>(b2), static_cast<bf16*>(out), N, M, C2,
                                 site_fc2);
}

// C entry of the fp32 MLP, bound with ctypes: a2v_fused_mlp's function on
// fp32 x, weights and out, every product an fp32 product taken as three
// bf16 ones (sm90.cuh split_pair), as the fp32 post-LN block
// (fused_block.cu a2v_fused_block_f32) takes its two, without the
// LayerNorms. The arguments of a2v_fused_mlp with fp32 x (N, C), w1 (M, C),
// w2 (C2, M) and out (N, C2), and bf16 scratch: xs (N, 3C), x's [hi | lo |
// hi]; w1s (M, 3C) and w2s (C2, 3M), the weights' [hi | hi | lo]; hs (N,
// 3M), h's [hi | lo | hi]; all 16-byte aligned. Three launches on the
// caller's stream:
//   1. split_planes_kernel   xs, w1s, w2s (bf16_gemm_sm90.cuh);
//   2. gemm_bf16_sm90        hs = split(drop_a(GELU(xs w1s^T + b1))), K = 3C;
//   3. gemm_bf16_sm90        out = drop_b(hs w2s^T + b2) in fp32, K = 3M.
// The numerics are the plain version's in fp32 (JAX's _kernel_bf16 on fp32
// operands: both products fp32, h kept in fp32, one fp32 sum + b2), but
// each product's sum carries the split's ~2^-16 relative error of each
// term. Bound on the H100 at a2v-large's b32 widths (N 64 000, C 1024, M
// 4096): 1.07 TFLOP over the TF32 dense peak (494.7 TFLOP/s) is 2.2 ms; the
// split design issues three times the bf16 products, 3.2 TFLOP, 3.3 ms at
// the 989 TFLOP/s bf16 peak, and moves xs (0.39 GB) and hs (1.57 GB written,
// read) besides x and out. Returns a cudaError_t.
extern "C" int a2v_fused_mlp_f32(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* xs, void* w1s, void* w2s, void* hs,
                                 void* out, int N, int C, int M, int C2, int seed_act,
                                 int seed_fc2, unsigned int thresh, float keep_scale,
                                 unsigned int row0, void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (N <= 0 || C <= 0 || C % kG16BK != 0 || M <= 0 || M % kG16BK != 0 || C2 <= 0 ||
      C2 % 8 != 0 || (N + kG16BM - 1) / kG16BM > 65535 || misaligned(x) || misaligned(w1) ||
      misaligned(w2) || misaligned(xs) || misaligned(w1s) || misaligned(w2s) ||
      misaligned(hs) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0u;
  const DropSite site_act{static_cast<uint32_t>(seed_act), thresh, keep_scale, row0};
  const DropSite site_fc2{static_cast<uint32_t>(seed_fc2), thresh, keep_scale, row0};
  auto* xsb = static_cast<bf16*>(xs);
  auto* w1b = static_cast<bf16*>(w1s);
  auto* w2b = static_cast<bf16*>(w2s);
  auto* hsb = static_cast<bf16*>(hs);
  int err = launch_split_planes(
      s, SplitPlanes{static_cast<const float*>(x), xsb, static_cast<size_t>(N) * C / 4, C, true},
      SplitPlanes{static_cast<const float*>(w1), w1b, static_cast<size_t>(M) * C / 4, C, false},
      SplitPlanes{static_cast<const float*>(w2), w2b, static_cast<size_t>(C2) * M / 4, M, false});
  if (err != 0) return err;
  err = launch_gemm_sm90<true, bf16, true>(drop, s, xsb, w1b, static_cast<const float*>(b1), hsb,
                                           N, 3 * C, M, site_act);
  if (err != 0) return err;
  return launch_gemm_sm90<false, float>(drop, s, hsb, w2b, static_cast<const float*>(b2),
                                        static_cast<float*>(out), N, 3 * M, C2, site_fc2);
}
