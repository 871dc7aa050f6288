// The mma.sync int8 GEMM of the int8 MLP (fused_mlp_int8.cu), and the
// segment quantizer it shares with int8_dense.cu (whose GEMM, like the int8
// block's, is int8_gemm_sm90.cuh's wgmma kernel).
//
// quantize_segments_kernel: x (rows, len), bf16 or fp32, cut into segments
// of seg_len columns; each (row, segment) gets its own int8 scale (ops/
// int8_mm.quantize_rows): q = rint(x / s), s = max(max|x| * kInv127, 1e-12).
// One warp per (row, segment) reads it twice (max, then quantize).
//
// gemm_s8_kernel: C[N, NOUT] = act(sum over segments of
//   fp32(A_seg . W_seg^T) * row_scale[row, seg] * col_scale[col] + bias[col])
// with A (N, K) and W (NOUT, K) int8 row-major: nn.Linear's (out, in) layout
// is the "col" B operand of mma.sync.m16n8k32, so W needs no transpose. The
// int32 sum restarts at every segment of seg_len columns of K (the int8
// MLP's hidden chunks; seg_len = K elsewhere) and is folded into the fp32
// sum as ((fp32(acc) * row scale) * col scale) in that order, each product
// and sum rounded on its own (no FMA contraction), as the JAX kernels write
// it. The epilogue adds the fp32 bias (or nothing), applies exact-erf GELU
// when GELU, and stores fp32 or bf16.
//
// Design, as fused_block.cu's bf16 GEMM: 128x128 output tiles, K steps of 64
// int8 double-buffered through shared memory by cp.async, eight warps each
// computing 64x32 with mma.sync m16n8k32 (int32 accumulate, exact) from
// 32-bit fragment loads; the padded 80-byte shared rows make them
// conflict-free. The int32 and fp32 accumulators of a thread are 64 + 64
// registers.
#pragma once

#include "common.cuh"

namespace a2v {
namespace {

constexpr int kS8Tile = 128;         // output tile, rows and columns
constexpr int kS8BK = 64;            // reduction step (int8 values)
constexpr int kS8Lds = kS8BK + 16;   // padded shared row (80 B)
constexpr int kS8Threads = 256;      // 8 warps as 2 (rows) x 4 (columns)
constexpr int kQuantThreads = 256;   // 8 (row, segment) items per block

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Needs seg_len % 64 == 0 and len % seg_len == 0; scale is (rows, len / seg_len).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_segments_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int rows, int len, int seg_len) {
  const int n_seg = len / seg_len;
  const long long item =
      static_cast<long long>(blockIdx.x) * (kQuantThreads / 32) + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(rows) * n_seg) return;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(item / n_seg) * len +
                      static_cast<size_t>(item % n_seg) * seg_len;
  float amax = 0.f;
  for (int j = 2 * lane; j < seg_len; j += 64) {
    const float2 v = load2(x + base + j);
    amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
  const float s = fmaxf(warp_max(amax) * kInv127, 1e-12f);
  for (int j = 2 * lane; j < seg_len; j += 64) {
    const float2 v = load2(x + base + j);
    *reinterpret_cast<char2*>(q + base + j) =
        make_char2(static_cast<signed char>(quantize_s8(v.x, s)),
                   static_cast<signed char>(quantize_s8(v.y, s)));
  }
  if (lane == 0) scale[item] = s;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Needs K % seg_len == 0, seg_len % 64 == 0 and NOUT % 8 == 0; rows past N
// and columns past NOUT are zero-filled on load and not stored. bias may be
// null.
template <bool GELU, typename OutT>
__global__ void __launch_bounds__(kS8Threads)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
               const float* __restrict__ row_scale, const float* __restrict__ col_scale,
               const float* __restrict__ bias, OutT* __restrict__ C, int N, int K, int NOUT,
               int seg_len) {
  __shared__ __align__(16) int8_t sA[2][kS8Tile * kS8Lds];
  __shared__ __align__(16) int8_t sW[2][kS8Tile * kS8Lds];

  const int n0 = blockIdx.x * kS8Tile;  // output columns (fastest: blocks sharing
  const int m0 = blockIdx.y * kS8Tile;  // an A row tile run together)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  auto load = [&](int stage, int k0) {
    for (int c = tid; c < kS8Tile * kS8BK / 16; c += kS8Threads) {
      const int r = c >> 2, col = (c & 3) * 16;
      const int arow = m0 + r, wrow = n0 + r;
      cp_async_16(&sA[stage][r * kS8Lds + col],
                  A + static_cast<size_t>(arow < N ? arow : 0) * K + k0 + col, arow < N);
      cp_async_16(&sW[stage][r * kS8Lds + col],
                  W + static_cast<size_t>(wrow < NOUT ? wrow : 0) * K + k0 + col, wrow < NOUT);
    }
  };

  float accf[4][4][4];
  int acci[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) accf[mt][nt][e] = 0.f;

  const int n_seg = K / seg_len, seg_steps = seg_len / kS8BK, n_steps = K / kS8BK;
  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step % seg_steps == 0) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acci[mt][nt][e] = 0;
    }
    if (step + 1 < n_steps) {
      load((step + 1) & 1, (step + 1) * kS8BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_s = sA[step & 1];
    const int8_t* w_s = sW[step & 1];
#pragma unroll
    for (int ks = 0; ks < kS8BK / 32; ++ks) {
      const int c = ks * 32 + 4 * i4;
      uint32_t af[4][4], wf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        af[mt][0] = ld_s8x4(&a_s[r * kS8Lds + c]);
        af[mt][1] = ld_s8x4(&a_s[(r + 8) * kS8Lds + c]);
        af[mt][2] = ld_s8x4(&a_s[r * kS8Lds + c + 16]);
        af[mt][3] = ld_s8x4(&a_s[(r + 8) * kS8Lds + c + 16]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        wf[nt][0] = ld_s8x4(&w_s[n * kS8Lds + c]);
        wf[nt][1] = ld_s8x4(&w_s[n * kS8Lds + c + 16]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acci[mt][nt], af[mt], wf[nt]);
    }
    __syncthreads();  // the next load overwrites this stage
    if ((step + 1) % seg_steps == 0) {  // fold the segment's int32 sum into fp32
      const int seg = step / seg_steps;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
          const float rs = row < N ? row_scale[static_cast<size_t>(row) * n_seg + seg] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + wn * 32 + nt * 8 + 2 * i4;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float cs = col < NOUT ? col_scale[col + e] : 0.f;
              const float part =
                  __fmul_rn(__fmul_rn(__int2float_rn(acci[mt][nt][2 * half + e]), rs), cs);
              accf[mt][nt][2 * half + e] = __fadd_rn(accf[mt][nt][2 * half + e], part);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * i4;
    if (col >= NOUT) continue;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (row >= N) continue;
        float y0 = __fadd_rn(accf[mt][nt][2 * half], b0);
        float y1 = __fadd_rn(accf[mt][nt][2 * half + 1], b1);
        if (GELU) {
          y0 = gelu_erf(y0);
          y1 = gelu_erf(y1);
        }
        store2(C + static_cast<size_t>(row) * NOUT + col, y0, y1);
      }
    }
  }
}

inline int quantize_blocks(long long items) {
  return static_cast<int>((items + kQuantThreads / 32 - 1) / (kQuantThreads / 32));
}

}  // namespace
}  // namespace a2v
