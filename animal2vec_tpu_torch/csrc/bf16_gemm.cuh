// bf16 GEMM with a fused bias / GELU / dropout epilogue, shared by
// fused_block.cu and fused_mlp.cu:
//
//   C[N, NOUT] = bf16(drop(act(A[N, K] W[NOUT, K]^T + bias)))
//
// bf16 operands, fp32 accumulation, the bias and the exact-erf GELU in fp32,
// one rounding to bf16. W comes in nn.Linear layout, (out, in) with the
// reduction dim contiguous, which is the B-fragment layout of mma.sync.
//
// Design: 128x128 output tiles, K steps of 32 double-buffered through shared
// memory by cp.async, eight warps each computing 64x32 with mma.sync
// m16n8k16 from 32-bit fragment loads (the padded 40-element shared rows make
// them conflict-free). The dropout lives in the epilogue (template DROP), so
// serving launches compile without it.
#pragma once

#include "common.cuh"

namespace a2v {
namespace {

constexpr int kTile = 128;          // GEMM output tile, rows and columns
constexpr int kBK = 32;             // GEMM reduction step
constexpr int kLds = kBK + 8;       // padded shared row (80 B)
constexpr int kGemmThreads = 256;   // 8 warps as 2 (rows) x 4 (columns)

// Needs K % 32 == 0 and NOUT % 2 == 0; rows past N are zero-filled on load
// and not stored.
template <bool GELU, bool DROP>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_act_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ C, int N, int K,
                     int NOUT, DropSite drop) {
  using bf16 = __nv_bfloat16;
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

// One GEMM launch of the given grid; the dropout template when `drop`.
template <bool GELU>
void launch_gemm(bool drop, dim3 grid, cudaStream_t s, const __nv_bfloat16* A,
                 const __nv_bfloat16* W, const float* bias, __nv_bfloat16* C, int N, int K,
                 int NOUT, const DropSite& site) {
  if (drop)
    gemm_bias_act_kernel<GELU, true><<<grid, kGemmThreads, 0, s>>>(A, W, bias, C, N, K, NOUT,
                                                                   site);
  else
    gemm_bias_act_kernel<GELU, false><<<grid, kGemmThreads, 0, s>>>(A, W, bias, C, N, K, NOUT,
                                                                    site);
}

// The grid of a GEMM with NOUT output columns over N rows.
inline dim3 gemm_grid(int N, int NOUT) {
  return dim3((NOUT + kTile - 1) / kTile, (N + kTile - 1) / kTile);
}

}  // namespace
}  // namespace a2v
