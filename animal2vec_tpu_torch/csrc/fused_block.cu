// Post-LN MLP sub-block of an AltBlock, bf16 storage, with the training
// hash dropout:
//
//   r = LN1(x);  h = drop_a(GELU(fc1 r + b1));  t = drop_b(fc2 h + b2)
//   x_out = LN2(bf16(r + drop_c(t)))            -> (x_out, t)
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
//
// Design: one C entry makes four launches on the caller's stream:
//   1. ln_rows           x -> r (bf16), one warp per row;
//   2. gemm_bias_act     h = drop_a(GELU(r W1 + b1)), bf16 (N, M) scratch;
//   3. gemm_bias_act     t = drop_b(h W2 + b2) (the layer tap);
//   4. ln_rows           x_out = LN2(bf16(r + drop_c(t))).
// The GEMM is 128x128 output tiles, K steps of 32 double-buffered through
// shared memory by cp.async, eight warps each computing 64x32 with mma.sync
// m16n8k16 from 32-bit fragment loads (the padded 40-element shared rows make
// them conflict-free). Both weights come in nn.Linear layout, (out, in) with
// the reduction dim contiguous, which is the B-fragment layout. The dropout
// lives in the epilogues (template DROP), so the serving launches compile
// without it.
//
// Bound on the H100 at the serving shape (N = 32 x 2000 rows, C = 1024,
// M = 4096): fc1 + fc2 are 1.07 TFLOP per layer (1.1 ms at the 989 TFLOP/s
// bf16 peak), so the block is compute-bound; mma.sync reaches a fraction of
// that peak, wgmma is the lever for a later change. Unlike the TPU kernel
// this design round-trips h through device memory: 2 x N x M x 2 B = 1.05 GB
// per layer (0.31 ms at 3.35 TB/s), about half of the block's 2.0 GB of
// traffic (x, r three times, t twice, x_out). Keeping h on chip needs the
// fc1 -> fc2 fusion of a later change. The dropout hash adds ~12 integer
// instructions per element of h, t and the residual branch.
#include "layernorm.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 128;          // GEMM output tile, rows and columns
constexpr int kBK = 32;             // GEMM reduction step
constexpr int kLds = kBK + 8;       // padded shared row (80 B)
constexpr int kGemmThreads = 256;   // 8 warps as 2 (rows) x 4 (columns)

// C[N, NOUT] = drop(act(A[N, K] W[NOUT, K]^T + bias)), bf16 out, fp32
// accumulate. Needs K % 32 == 0 and NOUT % 2 == 0; rows past N are
// zero-filled on load and not stored.
template <bool GELU, bool DROP>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_act_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const float* __restrict__ bias, bf16* __restrict__ C, int N, int K,
                     int NOUT, DropSite drop) {
  __shared__ __align__(16) bf16 sA[2][kTile * kLds];
  __shared__ __align__(16) bf16 sW[2][kTile * kLds];

  const int n0 = blockIdx.x * kTile;  // output columns (fastest: blocks sharing
  const int m0 = blockIdx.y * kTile;  // an A row tile run together)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  auto load = [&](int stage, int k0) {
    for (int c = tid; c < kTile * kBK / 8; c += kGemmThreads) {
      const int r = c >> 2, col = (c & 3) * 8;
      const int arow = m0 + r, wrow = n0 + r;
      cp_async_16(&sA[stage][r * kLds + col],
                  A + static_cast<size_t>(arow < N ? arow : 0) * K + k0 + col, arow < N);
      cp_async_16(&sW[stage][r * kLds + col],
                  W + static_cast<size_t>(wrow < NOUT ? wrow : 0) * K + k0 + col, wrow < NOUT);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_steps = K / kBK;
  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load((step + 1) & 1, (step + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = sA[step & 1];
    const bf16* w_s = sW[step & 1];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int c = ks * 16 + 2 * i4;
      uint32_t af[4][4], wf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        af[mt][0] = ld_u32(&a_s[r * kLds + c]);
        af[mt][1] = ld_u32(&a_s[(r + 8) * kLds + c]);
        af[mt][2] = ld_u32(&a_s[r * kLds + c + 8]);
        af[mt][3] = ld_u32(&a_s[(r + 8) * kLds + c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        wf[nt][0] = ld_u32(&w_s[n * kLds + c]);
        wf[nt][1] = ld_u32(&w_s[n * kLds + c + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], af[mt], wf[nt]);
    }
    __syncthreads();  // the next load overwrites this stage
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * i4;
    if (col >= NOUT) continue;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= N) continue;
        float x0 = acc[mt][nt][2 * half] + b0;
        float x1 = acc[mt][nt][2 * half + 1] + b1;
        if (GELU) {
          x0 = gelu_erf(x0);
          x1 = gelu_erf(x1);
        }
        if (DROP) {
          x0 *= drop_factor(drop.seed, row, col, drop.thresh, drop.keep_scale);
          x1 *= drop_factor(drop.seed, row, col + 1, drop.thresh, drop.keep_scale);
        }
        *reinterpret_cast<uint32_t*>(&C[static_cast<size_t>(row) * NOUT + col]) =
            pack_bf16(x0, x1);
      }
    }
  }
}

template <bool GELU>
void launch_gemm(bool drop, dim3 grid, cudaStream_t s, const bf16* A, const bf16* W,
                 const float* bias, bf16* C, int N, int K, int NOUT, const DropSite& site) {
  if (drop)
    gemm_bias_act_kernel<GELU, true><<<grid, kGemmThreads, 0, s>>>(A, W, bias, C, N, K, NOUT,
                                                                   site);
  else
    gemm_bias_act_kernel<GELU, false><<<grid, kGemmThreads, 0, s>>>(A, W, bias, C, N, K, NOUT,
                                                                    site);
}

}  // namespace
}  // namespace a2v

// C entry, bound with ctypes. x, r, t, x_out: (N, C) bf16; w1t: (M, C) and
// w2t: (C, M) bf16 (nn.Linear layout); h: (N, M) bf16 scratch; LayerNorm
// scales/biases and b1 (M), b2 (C) fp32. seeds are the three int32 dropout
// seeds [after GELU, after fc2, post-mlp]; a threshold of 0 turns a site
// off (act_thresh covers the first two sites). Returns a cudaError_t.
extern "C" int a2v_fused_block(const void* x, const void* ln1_scale, const void* ln1_bias,
                               const void* w1t, const void* b1, const void* w2t, const void* b2,
                               const void* ln2_scale, const void* ln2_bias, void* r, void* h,
                               void* t, void* x_out, int N, int C, int M, float eps,
                               int seed_act, int seed_fc2, int seed_post,
                               unsigned int act_thresh, float act_scale,
                               unsigned int post_thresh, float post_scale, void* stream) {
  using namespace a2v;
  if (N <= 0 || C <= 0 || C % 128 != 0 || C > 128 * (kLnMaxPerLane / 4) || M <= 0 ||
      M % 128 != 0 || (N + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  auto* rb = static_cast<bf16*>(r);
  auto* hb = static_cast<bf16*>(h);
  auto* tb = static_cast<bf16*>(t);
  const int ln_blocks = (N + kLnThreads / 32 - 1) / (kLnThreads / 32);
  const int row_tiles = (N + kTile - 1) / kTile;
  const DropSite site_act{static_cast<uint32_t>(seed_act), act_thresh, act_scale};
  const DropSite site_fc2{static_cast<uint32_t>(seed_fc2), act_thresh, act_scale};
  const DropSite site_post{static_cast<uint32_t>(seed_post), post_thresh, post_scale};
  cudaError_t err;

  ln_rows_kernel<false, false, false><<<ln_blocks, kLnThreads, 0, s>>>(
      xb, nullptr, static_cast<const float*>(ln1_scale), static_cast<const float*>(ln1_bias),
      rb, nullptr, nullptr, N, C, eps, site_post);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  launch_gemm<true>(act_thresh != 0u, dim3(M / kTile, row_tiles), s, rb,
                    static_cast<const bf16*>(w1t), static_cast<const float*>(b1), hb, N, C, M,
                    site_act);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  launch_gemm<false>(act_thresh != 0u, dim3(C / kTile, row_tiles), s, hb,
                     static_cast<const bf16*>(w2t), static_cast<const float*>(b2), tb, N, M, C,
                     site_fc2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (post_thresh != 0u)
    ln_rows_kernel<true, true, false><<<ln_blocks, kLnThreads, 0, s>>>(
        rb, tb, static_cast<const float*>(ln2_scale), static_cast<const float*>(ln2_bias),
        static_cast<bf16*>(x_out), nullptr, nullptr, N, C, eps, site_post);
  else
    ln_rows_kernel<true, false, false><<<ln_blocks, kLnThreads, 0, s>>>(
        rb, tb, static_cast<const float*>(ln2_scale), static_cast<const float*>(ln2_bias),
        static_cast<bf16*>(x_out), nullptr, nullptr, N, C, eps, site_post);
  return static_cast<int>(cudaGetLastError());
}
