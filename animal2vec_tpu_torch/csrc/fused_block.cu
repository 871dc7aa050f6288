// Post-LN MLP sub-block of an AltBlock, bf16 storage, with the training
// hash dropout:
//
//   r = LN1(x);  h = drop_a(GELU(fc1 r + b1));  t = drop_b(fc2 h + b2)
//   x_out = LN2(bf16(r + dp(drop_c(t))))        -> (x_out, t)
//
// Replaces the TPU kernel animal2vec_tpu/ops/fused_mlp.py:_kernel_bf16_block.
// Numerics follow it: LayerNorm statistics in fp32 over C, r cast back to
// bf16 before fc1, both products bf16 x bf16 with fp32 accumulation, bias +
// exact-erf GELU in fp32, h cast to bf16 before fc2, the tap t = bf16(acc +
// b2) (after drop_b, before drop_c), and the residual add in bf16 before
// LN2's fp32 statistics. The three dropout sites are those of the TPU kernel:
// drop_a after GELU (seed 0, activation rate), drop_b after fc2 (seed 1,
// the same rate), drop_c on the residual branch (seed 2, post-mlp rate), each
// keep = drop_hash(seed, global row, global column) >= threshold
// (common.cuh), scaled by 1 / (1 - rate). Rows are rows of the flattened
// (N, C) input; columns are hidden (fc1) or output (fc2, residual) columns.
// dp is drop-path on the branch: with a branch_scale the dropped-out t
// (bf16) times its sample's fp32 factor (0 or 1 / (1 - rate),
// branch_scale[row / rows_per_scale]), rounded to bf16 again. JAX sends a
// drop-path block to its composed XLA block; this computes the same function
// in the LN2 pass. Without a branch_scale, the launches are those of the
// block without drop-path.
//
// Design: one C entry makes four launches on the caller's stream:
//   1. ln_rows           x -> r (bf16), one warp per row;
//   2. gemm_bf16_sm90    h = drop_a(GELU(r W1 + b1)), bf16 (N, M) scratch;
//   3. gemm_bf16_sm90    t = drop_b(h W2 + b2) (the layer tap);
//   4. ln_rows           x_out = LN2(bf16(r + drop_c(t))).
// The GEMM is bf16_gemm_sm90.cuh's: wgmma m64n128k16 on 128-byte swizzled
// shared-memory tiles behind a 3-stage cp.async ring, 128 x 128 output
// tiles, the bias, GELU and dropout in its epilogue; both weights come in
// nn.Linear layout, K-major as wgmma reads them.
//
// Bound on the H100 at the serving shape (N = 32 x 2000 rows, C = 1024,
// M = 4096): fc1 + fc2 are 1.07 TFLOP per layer (1.1 ms at the 989 TFLOP/s
// bf16 peak), so the block is compute-bound. Unlike the TPU kernel this
// design round-trips h through device memory: 2 x N x M x 2 B = 1.05 GB
// per layer (0.31 ms at 3.35 TB/s), about half of the block's 2.0 GB of
// traffic (x, r three times, t twice, x_out). Keeping h on chip needs the
// fc1 -> fc2 fusion of a later change. The dropout hash adds ~12 integer
// instructions per element of h, t and the residual branch.
#include "bf16_gemm_sm90.cuh"
#include "layernorm.cuh"

// C entry, bound with ctypes. x, r, t, x_out: (N, C) bf16; w1t: (M, C) and
// w2t: (C, M) bf16 (nn.Linear layout); h: (N, M) bf16 scratch; LayerNorm
// scales/biases and b1 (M), b2 (C) fp32. seeds are the three int32 dropout
// seeds [after GELU, after fc2, post-mlp]; a threshold of 0 turns a site
// off (act_thresh covers the first two sites); the masks' rows start at
// row0 (a data-parallel rank's first global row). branch_scale: null, or the
// fp32 drop-path factor of each block of rows_per_scale rows (a sample).
// Returns a cudaError_t.
extern "C" int a2v_fused_block(const void* x, const void* ln1_scale, const void* ln1_bias,
                               const void* w1t, const void* b1, const void* w2t, const void* b2,
                               const void* ln2_scale, const void* ln2_bias, void* r, void* h,
                               void* t, void* x_out, int N, int C, int M, float eps,
                               int seed_act, int seed_fc2, int seed_post,
                               unsigned int act_thresh, float act_scale,
                               unsigned int post_thresh, float post_scale, unsigned int row0,
                               const void* branch_scale, int rows_per_scale, void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  if (N <= 0 || C <= 0 || C % 128 != 0 || C > 128 * (kLnMaxPerLane / 4) || M <= 0 ||
      M % 128 != 0 || (N + kG16BM - 1) / kG16BM > 65535 || rows_per_scale <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  auto* rb = static_cast<bf16*>(r);
  auto* hb = static_cast<bf16*>(h);
  auto* tb = static_cast<bf16*>(t);
  const int ln_blocks = (N + kLnThreads / 32 - 1) / (kLnThreads / 32);
  const DropSite site_act{static_cast<uint32_t>(seed_act), act_thresh, act_scale, row0};
  const DropSite site_fc2{static_cast<uint32_t>(seed_fc2), act_thresh, act_scale, row0};
  const DropSite site_post{static_cast<uint32_t>(seed_post), post_thresh, post_scale, row0};
  cudaError_t err;

  ln_rows_kernel<false, false, false><<<ln_blocks, kLnThreads, 0, s>>>(
      xb, nullptr, static_cast<const float*>(ln1_scale), static_cast<const float*>(ln1_bias),
      rb, nullptr, nullptr, N, C, eps, site_post);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_sm90<true>(
           act_thresh != 0u, s, rb, static_cast<const bf16*>(w1t), static_cast<const float*>(b1),
           hb, N, C, M, site_act))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_sm90<false>(
           act_thresh != 0u, s, hb, static_cast<const bf16*>(w2t), static_cast<const float*>(b2),
           tb, N, M, C, site_fc2))) != cudaSuccess)
    return static_cast<int>(err);
  const auto* bscale = static_cast<const float*>(branch_scale);
  if (bscale != nullptr && post_thresh != 0u)
    ln_rows_kernel<true, true, false, true><<<ln_blocks, kLnThreads, 0, s>>>(
        rb, tb, static_cast<const float*>(ln2_scale), static_cast<const float*>(ln2_bias),
        static_cast<bf16*>(x_out), nullptr, nullptr, N, C, eps, site_post, bscale,
        rows_per_scale);
  else if (bscale != nullptr)
    ln_rows_kernel<true, false, false, true><<<ln_blocks, kLnThreads, 0, s>>>(
        rb, tb, static_cast<const float*>(ln2_scale), static_cast<const float*>(ln2_bias),
        static_cast<bf16*>(x_out), nullptr, nullptr, N, C, eps, site_post, bscale,
        rows_per_scale);
  else if (post_thresh != 0u)
    ln_rows_kernel<true, true, false><<<ln_blocks, kLnThreads, 0, s>>>(
        rb, tb, static_cast<const float*>(ln2_scale), static_cast<const float*>(ln2_bias),
        static_cast<bf16*>(x_out), nullptr, nullptr, N, C, eps, site_post);
  else
    ln_rows_kernel<true, false, false><<<ln_blocks, kLnThreads, 0, s>>>(
        rb, tb, static_cast<const float*>(ln2_scale), static_cast<const float*>(ln2_bias),
        static_cast<bf16*>(x_out), nullptr, nullptr, N, C, eps, site_post);
  return static_cast<int>(cudaGetLastError());
}
