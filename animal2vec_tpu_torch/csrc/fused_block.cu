// Post-LN MLP sub-block of an AltBlock, bf16 storage (a2v_fused_block; the
// fp32 storage of JAX's default compute dtype: a2v_fused_block_f32 below),
// with the training hash dropout:
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
//   1. ln_rows           x -> r (bf16), one warp per row (layernorm.cuh: the
//                        row in registers for C <= 1024, re-read past it);
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
#include <algorithm>

#include "bf16_gemm_sm90.cuh"
#include "layernorm.cuh"

namespace {

// LN2 of the block: x_out = LN2(E(r + dp(drop_c(t)))) on stream s, the
// ln_rows instance of the dropout site and the drop-path factor (null:
// none), E the storage type (bf16, or fp32 in the fp32 block). Returns a
// cudaError_t.
template <typename E>
int launch_ln2(cudaStream_t s, const E* r, const E* t, const float* scale, const float* bias,
               E* x_out, int N, int C, float eps, const a2v::DropSite& site_post,
               const float* bscale, int rows_per_scale) {
  using namespace a2v;
  if (bscale != nullptr && site_post.thresh != 0u)
    return launch_ln_rows<true, true, false, true, E>(s, r, t, scale, bias, x_out, nullptr,
                                                      nullptr, N, C, eps, site_post, bscale,
                                                      rows_per_scale);
  if (bscale != nullptr)
    return launch_ln_rows<true, false, false, true, E>(s, r, t, scale, bias, x_out, nullptr,
                                                       nullptr, N, C, eps, site_post, bscale,
                                                       rows_per_scale);
  if (site_post.thresh != 0u)
    return launch_ln_rows<true, true, false, false, E>(s, r, t, scale, bias, x_out, nullptr,
                                                       nullptr, N, C, eps, site_post);
  return launch_ln_rows<true, false, false, false, E>(s, r, t, scale, bias, x_out, nullptr,
                                                      nullptr, N, C, eps, site_post);
}

}  // namespace

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
  if (N <= 0 || C <= 0 || C % 128 != 0 || M <= 0 || M % 128 != 0 ||
      (N + kG16BM - 1) / kG16BM > 65535 || rows_per_scale <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  auto* rb = static_cast<bf16*>(r);
  auto* hb = static_cast<bf16*>(h);
  auto* tb = static_cast<bf16*>(t);
  const DropSite site_act{static_cast<uint32_t>(seed_act), act_thresh, act_scale, row0};
  const DropSite site_fc2{static_cast<uint32_t>(seed_fc2), act_thresh, act_scale, row0};
  const DropSite site_post{static_cast<uint32_t>(seed_post), post_thresh, post_scale, row0};
  cudaError_t err;

  if ((err = static_cast<cudaError_t>(launch_ln_rows<false, false, false>(
           s, xb, nullptr, static_cast<const float*>(ln1_scale),
           static_cast<const float*>(ln1_bias), rb, nullptr, nullptr, N, C, eps,
           site_post))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_sm90<true>(
           act_thresh != 0u, s, rb, static_cast<const bf16*>(w1t), static_cast<const float*>(b1),
           hb, N, C, M, site_act))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_sm90<false>(
           act_thresh != 0u, s, hb, static_cast<const bf16*>(w2t), static_cast<const float*>(b2),
           tb, N, M, C, site_fc2))) != cudaSuccess)
    return static_cast<int>(err);
  return launch_ln2<bf16>(s, rb, tb, static_cast<const float*>(ln2_scale),
                    static_cast<const float*>(ln2_bias), static_cast<bf16*>(x_out), N, C, eps,
                    site_post, static_cast<const float*>(branch_scale), rows_per_scale);
}

// C entry of the fp32 block, bound with ctypes: a2v_fused_block's function
// on fp32 x, weights, r, t and x_out, every product an fp32 product taken
// as three bf16 ones (sm90.cuh split_pair). The arguments of
// a2v_fused_block, with fp32 x, w1t (M, C), w2t (C, M), r, t and x_out
// (N, C), and bf16 scratch: rs (N, 3C), the LN1 output's [hi | lo | hi];
// w1s (M, 3C) and w2s (C, 3M), the weights' [hi | hi | lo]; hs (N, 3M),
// h's [hi | lo | hi]. Five launches on the caller's stream:
//   1. split_planes_kernel   w1s, w2s (bf16_gemm_sm90.cuh);
//   2. ln_rows<fp32>         r = LN1(x) and rs;
//   3. gemm_bf16_sm90        hs = split(drop_a(GELU(rs w1s^T + b1))), K = 3C;
//   4. gemm_bf16_sm90        t = drop_b(hs w2s^T + b2) in fp32, K = 3M;
//   5. ln_rows<fp32>         x_out = LN2(r + dp(drop_c(t))), all fp32.
// The numerics are the plain version's in fp32 (JAX's block in its fp32
// storage dtype: r and h kept in fp32, the residual added in fp32), but
// each product's sum carries the split's ~2^-16 relative error of each
// term. Bound on the H100 at the b32 serving shape (N 64 000, C 1024, M
// 4096): the block's 1.07 TFLOP over the TF32 dense peak (494.7 TFLOP/s)
// is 2.2 ms; the split design issues three times the bf16 products, 3.2
// TFLOP, 3.3 ms at the 989 TFLOP/s bf16 peak, and moves hs (1.57 GB
// written, read) besides x, r, rs, t and x_out. Returns a cudaError_t.
extern "C" int a2v_fused_block_f32(const void* x, const void* ln1_scale, const void* ln1_bias,
                                   const void* w1t, const void* b1, const void* w2t,
                                   const void* b2, const void* ln2_scale, const void* ln2_bias,
                                   void* r, void* rs, void* w1s, void* w2s, void* hs, void* t,
                                   void* x_out, int N, int C, int M, float eps, int seed_act,
                                   int seed_fc2, int seed_post, unsigned int act_thresh,
                                   float act_scale, unsigned int post_thresh, float post_scale,
                                   unsigned int row0, const void* branch_scale,
                                   int rows_per_scale, void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  if (N <= 0 || C <= 0 || C % 128 != 0 || M <= 0 || M % 128 != 0 ||
      (N + kG16BM - 1) / kG16BM > 65535 || rows_per_scale <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* rf = static_cast<float*>(r);
  auto* rsb = static_cast<bf16*>(rs);
  auto* w1b = static_cast<bf16*>(w1s);
  auto* w2b = static_cast<bf16*>(w2s);
  auto* hsb = static_cast<bf16*>(hs);
  auto* tf = static_cast<float*>(t);
  const DropSite site_act{static_cast<uint32_t>(seed_act), act_thresh, act_scale, row0};
  const DropSite site_fc2{static_cast<uint32_t>(seed_fc2), act_thresh, act_scale, row0};
  const DropSite site_post{static_cast<uint32_t>(seed_post), post_thresh, post_scale, row0};
  cudaError_t err;

  const size_t quads = static_cast<size_t>(M) * C / 4;
  if ((err = static_cast<cudaError_t>(launch_split_planes(
           s, SplitPlanes{static_cast<const float*>(w1t), w1b, quads, C, false},
           SplitPlanes{static_cast<const float*>(w2t), w2b, quads, M, false}))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_ln_rows<false, false, false, false, float>(
           s, static_cast<const float*>(x), nullptr, static_cast<const float*>(ln1_scale),
           static_cast<const float*>(ln1_bias), rf, nullptr, nullptr, N, C, eps, site_post,
           nullptr, 1, rsb))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_sm90<true, bf16, true>(
           act_thresh != 0u, s, rsb, w1b, static_cast<const float*>(b1), hsb, N, 3 * C, M,
           site_act))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = static_cast<cudaError_t>(launch_gemm_sm90<false, float>(
           act_thresh != 0u, s, hsb, w2b, static_cast<const float*>(b2), tf, N, 3 * M, C,
           site_fc2))) != cudaSuccess)
    return static_cast<int>(err);
  return launch_ln2<float>(s, rf, tf, static_cast<const float*>(ln2_scale),
                           static_cast<const float*>(ln2_bias), static_cast<float*>(x_out), N, C,
                           eps, site_post, static_cast<const float*>(branch_scale),
                           rows_per_scale);
}

// The tensor-parallel split of the block (one rank of a "model" group of
// mp ranks holds Ms = M / mp hidden columns, from col0): JAX's layout
// shards fc1 by columns and fc2 by rows, and fc2's all-reduce has to come
// before the residual and LN2, which a2v_fused_block runs after fc2 in
// its own launches. So the block is three entries around the all-reduce
// (done by the caller, over fp32 (N, C) partial sums):
//
//   a2v_block_fc1           r = LN1(x);  h = drop_a(GELU(r W1s + b1s))
//                           (drop_a's hash at hidden column col0 + j, so a
//                           rank's mask is its columns of the unsharded one)
//   a2v_block_fc2_partial   P = h W2s^T in fp32, no bias
//   a2v_block_ln2           t = bf16(drop_b(S + b2)) for the reduced S;
//                           x_out = LN2(bf16(r + dp(drop_c(t))))
//
// With mp = 1 (col0 0, Ms = M) the three compute a2v_fused_block's
// function, except that fc2's sum is rounded to fp32 before the bias where
// the fused epilogue adds the bias to the accumulator: the same value.
// Launches: fc1 is a2v_fused_block's first two (ln_rows, the GELU GEMM);
// the partial the GEMM core's fp32-output instance (float2 stores straight
// from the accumulator, bf16_gemm_sm90.cuh); ln2 a bias + dropout pass over
// (N, C) and a2v_fused_block's LN2 launch.
//
// Bound on the H100 at a2v-large's finetune step split over two ranks (N =
// 8000, C = 1024, Ms = 2048): fc1 and the partial are each 2 N C Ms =
// 33.6 GFLOP (0.034 ms at 989 TFLOP/s) against 69.7 MB (fc1: x, W1s, r, h;
// the partial: h, W2s, P; 0.021 ms at 3.35 TB/s): bound by operations;
// ln2 reads 32.8 MB of S and 16.4 MB of r and writes 32.8 MB of t and
// x_out (0.024 ms): bound by bytes.

// (N, C): t = bf16(drop_b(S + b2)), two columns a thread.
__global__ void bias_drop_round_kernel(const float* __restrict__ S, const float* __restrict__ b2,
                                       __nv_bfloat16* __restrict__ t, int N, int C,
                                       a2v::DropSite drop, bool dropout) {
  const size_t pairs = static_cast<size_t>(N) * C / 2;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < pairs;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = 2 * i;
    const int row = static_cast<int>(e / C), col = static_cast<int>(e % C);
    const float2 v = reinterpret_cast<const float2*>(S)[i];
    float x0 = v.x + b2[col], x1 = v.y + b2[col + 1];
    if (dropout) {
      x0 *= a2v::drop_factor(drop.seed, drop.row0 + row, col, drop.thresh, drop.keep_scale);
      x1 *= a2v::drop_factor(drop.seed, drop.row0 + row, col + 1, drop.thresh, drop.keep_scale);
    }
    reinterpret_cast<uint32_t*>(t)[i] = a2v::pack_bf16(x0, x1);
  }
}

// C entry. x, r: (N, C) bf16; w1t: (Ms, C) bf16 (the rank's rows of fc1's
// nn.Linear weight); b1: (Ms) and the LayerNorm's scale and bias (C) fp32;
// h: (N, Ms) bf16. drop_a's seed and threshold as a2v_fused_block's
// seed_act / act_thresh, its rows from row0 and its columns from col0.
// Returns a cudaError_t.
extern "C" int a2v_block_fc1(const void* x, const void* ln1_scale, const void* ln1_bias,
                             const void* w1t, const void* b1, void* r, void* h, int N, int C,
                             int Ms, float eps, int seed_act, unsigned int act_thresh,
                             float act_scale, unsigned int row0, unsigned int col0,
                             void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  if (N <= 0 || C <= 0 || C % 128 != 0 || Ms <= 0 || Ms % 128 != 0 ||
      (N + kG16BM - 1) / kG16BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* rb = static_cast<bf16*>(r);
  const DropSite site_act{static_cast<uint32_t>(seed_act), act_thresh, act_scale, row0, col0};
  if (int err = launch_ln_rows<false, false, false>(
          s, static_cast<const bf16*>(x), nullptr, static_cast<const float*>(ln1_scale),
          static_cast<const float*>(ln1_bias), rb, nullptr, nullptr, N, C, eps, DropSite{}))
    return err;
  return launch_gemm_sm90<true>(act_thresh != 0u, s, rb, static_cast<const bf16*>(w1t),
                                static_cast<const float*>(b1), static_cast<bf16*>(h), N, C, Ms,
                                site_act);
}

// C entry. h: (N, Ms) bf16; w2t: (C, Ms) bf16 (the rank's columns of fc2's
// nn.Linear weight); partial: (N, C) fp32 = h w2t^T. Returns a cudaError_t.
extern "C" int a2v_block_fc2_partial(const void* h, const void* w2t, void* partial, int N, int Ms,
                                     int C, void* stream) {
  using namespace a2v;
  if (N <= 0 || Ms <= 0 || Ms % 64 != 0 || C <= 0 || C % 8 != 0 ||
      (N + kG16BM - 1) / kG16BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gemm_sm90_f32(static_cast<cudaStream_t>(stream),
                              static_cast<const __nv_bfloat16*>(h),
                              static_cast<const __nv_bfloat16*>(w2t), static_cast<float*>(partial),
                              N, Ms, C);
}

// C entry. S: (N, C) fp32, the partial sums reduced over the ranks; b2 and
// the LayerNorm's scale and bias (C) fp32; r: (N, C) bf16 (a2v_block_fc1's);
// t, x_out: (N, C) bf16. Seeds, thresholds, row0 and the drop-path
// branch_scale as a2v_fused_block's. Returns a cudaError_t.
extern "C" int a2v_block_ln2(const void* S, const void* b2, const void* r, const void* ln2_scale,
                             const void* ln2_bias, void* t, void* x_out, int N, int C, float eps,
                             int seed_fc2, unsigned int act_thresh, float act_scale,
                             int seed_post, unsigned int post_thresh, float post_scale,
                             unsigned int row0, const void* branch_scale, int rows_per_scale,
                             void* stream) {
  using namespace a2v;
  using bf16 = __nv_bfloat16;
  if (N <= 0 || C <= 0 || C % 128 != 0 || rows_per_scale <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* tb = static_cast<bf16*>(t);
  const DropSite site_fc2{static_cast<uint32_t>(seed_fc2), act_thresh, act_scale, row0};
  const DropSite site_post{static_cast<uint32_t>(seed_post), post_thresh, post_scale, row0};
  const size_t pairs = static_cast<size_t>(N) * C / 2;
  const int blocks = static_cast<int>(std::min<size_t>((pairs + 255) / 256, 132 * 16));
  bias_drop_round_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(S),
                                                static_cast<const float*>(b2), tb, N, C,
                                                site_fc2, act_thresh != 0u);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return launch_ln2<bf16>(s, static_cast<const bf16*>(r), tb, static_cast<const float*>(ln2_scale),
                    static_cast<const float*>(ln2_bias), static_cast<bf16*>(x_out), N, C, eps,
                    site_post, static_cast<const float*>(branch_scale), rows_per_scale);
}
