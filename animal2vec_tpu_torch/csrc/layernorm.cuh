// Row LayerNorm of the fused post-LN blocks (fused_block.cu,
// fused_block_int8.cu): one warp per row of bf16 values; fp32 statistics;
// bf16 out. The fp32 instances (E float, the fp32 block) read and write
// fp32 rows with the same arithmetic and no rounding of z, and can write
// the output's split planes beside it (``planes``: (N, 3C) bf16, a row's
// hi parts, lo parts and hi parts again, sm90.cuh split_pair).
//
//   y = LN(z) * scale + bias,  z = x, or bf16(x + dp(drop(t))) when RESID
//   (the storage-dtype residual add of LN2; drop(t) rounds to bf16 first;
//   with BSCALE, dp multiplies it by the fp32 drop-path factor of its row's
//   sample, branch_scale[row / rows_per_scale], and rounds again; in fp32
//   storage every step stays fp32).
//
// With QUANT the row is also quantized to int8 from its bf16-rounded output
// (the int8 block quantizes the cast-back r): s = max(max|y| * fp32(1/127),
// 1e-12), q = rint(y / s) with an IEEE division, round half to even, as
// ops/int8_mm.quantize_rows.
//
// Two instances of the same arithmetic, chosen by C in launch_ln_rows:
//   ln_rows_kernel       C <= 1024: the row in registers, 32 floats a lane,
//                        read once;
//   ln_rows_wide_kernel  C > 1024, any multiple of 128: nothing of the row
//                        is held; each pass (the sum, the squared
//                        deviations, the normalize) reads the row again from
//                        global memory (L2 at 8 rows of a few KB a block),
//                        recomputing z (RESID, DROP's hash factor, BSCALE)
//                        identically, and QUANT reads its own bf16 output
//                        back for the quantization. A lane visits its
//                        4-column groups in the same order in both, so the
//                        fp32 sums are formed in the same order.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace a2v {
namespace {

// E without deducing it from an argument (a null t or planes)
template <typename T>
struct ln_elem {
  using type = T;
};
template <typename T>
using ln_t = typename ln_elem<T>::type;

constexpr int kLnThreads = 256;     // 8 rows per block, one warp per row
constexpr int kLnMaxPerLane = 32;   // the register instance: C <= 1024
constexpr int kLnRegCols = 32 * kLnMaxPerLane;

// z at columns c .. c + 3 of the row at `base` (row `row`): x, or with RESID
// bf16(x + dp(drop(t))) (fp32: x + dp(drop(t)) unrounded).
template <bool RESID, bool DROP, bool BSCALE>
__device__ __forceinline__ void ln_load4(const float* __restrict__ x,
                                         const float* __restrict__ t, size_t base, int c,
                                         int row, const DropSite& drop, float bscale,
                                         float z[4]) {
  const float4 xv = *reinterpret_cast<const float4*>(x + base + c);
  z[0] = xv.x, z[1] = xv.y, z[2] = xv.z, z[3] = xv.w;
  if (RESID) {
    const float4 tv = *reinterpret_cast<const float4*>(t + base + c);
    const float tt[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b = tt[e];
      if (DROP)
        b *= drop_factor(drop.seed, drop.row0 + row, c + e, drop.thresh, drop.keep_scale);
      if (BSCALE) b *= bscale;
      z[e] += b;
    }
  }
}

template <bool RESID, bool DROP, bool BSCALE>
__device__ __forceinline__ void ln_load4(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ t, size_t base, int c,
                                         int row, const DropSite& drop, float bscale,
                                         float z[4]) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(x + base + c);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float2 v = __bfloat1622float2(xp[p]);
    if (RESID) {
      float2 tv = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(t + base + c)[p]);
      if (DROP) {
        const int col = c + 2 * p;
        const uint32_t grow = drop.row0 + row;
        tv.x = __bfloat162float(__float2bfloat16_rn(
            tv.x * drop_factor(drop.seed, grow, col, drop.thresh, drop.keep_scale)));
        tv.y = __bfloat162float(__float2bfloat16_rn(
            tv.y * drop_factor(drop.seed, grow, col + 1, drop.thresh, drop.keep_scale)));
      }
      if (BSCALE) {
        tv.x = __bfloat162float(__float2bfloat16_rn(tv.x * bscale));
        tv.y = __bfloat162float(__float2bfloat16_rn(tv.y * bscale));
      }
      v.x = __bfloat162float(__float2bfloat16_rn(v.x + tv.x));
      v.y = __bfloat162float(__float2bfloat16_rn(v.y + tv.y));
    }
    z[2 * p] = v.x;
    z[2 * p + 1] = v.y;
  }
}

// The normalized, scaled bf16 pair of (z0, z1) at columns c, c + 1.
__device__ __forceinline__ uint32_t ln_pair(float z0, float z1, float mean, float rstd,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias, int c) {
  return pack_bf16((z0 - mean) * rstd * scale[c] + bias[c],
                   (z1 - mean) * rstd * scale[c + 1] + bias[c + 1]);
}

// The fp32 instances' output of columns c .. c + 3 of a row of C at
// `base`: the normalized, scaled fp32 values into y and, where planes is
// not null, their hi, lo and hi parts into the row's three thirds of it.
__device__ __forceinline__ void ln_store4_f32(const float z[4], float mean, float rstd,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias, float* y,
                                              __nv_bfloat16* planes, size_t base, int c, int C) {
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = (z[e] - mean) * rstd * scale[c + e] + bias[c + e];
  *reinterpret_cast<float4*>(y + base + c) = make_float4(o[0], o[1], o[2], o[3]);
  if (planes != nullptr) {
    uint2 hi, lo;
    sm90::split_pair(o[0], o[1], hi.x, lo.x);
    sm90::split_pair(o[2], o[3], hi.y, lo.y);
    __nv_bfloat16* p = planes + 3 * base + c;
    *reinterpret_cast<uint2*>(p) = hi;
    *reinterpret_cast<uint2*>(p + C) = lo;
    *reinterpret_cast<uint2*>(p + 2 * C) = hi;
  }
}

// Needs C % 128 == 0, C <= 1024. q and q_scale are read only with QUANT
// (bf16 only), branch_scale only with BSCALE, planes only in fp32.
template <bool RESID, bool DROP, bool QUANT, bool BSCALE = false, typename E = __nv_bfloat16>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const E* __restrict__ x, const E* __restrict__ t,
               const float* __restrict__ scale, const float* __restrict__ bias,
               E* __restrict__ y, int8_t* __restrict__ q,
               float* __restrict__ q_scale, int N, int C, float eps, DropSite drop,
               const float* __restrict__ branch_scale = nullptr, int rows_per_scale = 1,
               __nv_bfloat16* __restrict__ planes = nullptr) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  static_assert(!(kF32 && QUANT), "the int8 block's quantization reads bf16 rows");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kLnThreads / 32) + warp;
  if (row >= N) return;
  const float bscale = BSCALE ? branch_scale[row / rows_per_scale] : 1.f;
  const int n_chunks = C / 128;  // 4 values per lane per chunk
  const size_t base = static_cast<size_t>(row) * C;
  float z[kLnMaxPerLane];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kLnMaxPerLane / 4; ++j) {
    if (j < n_chunks) {
      ln_load4<RESID, DROP, BSCALE>(x, t, base, j * 128 + lane * 4, row, drop, bscale,
                                    z + j * 4);
      sum += z[j * 4] + z[j * 4 + 1];
      sum += z[j * 4 + 2] + z[j * 4 + 3];
    }
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kLnMaxPerLane / 4; ++j) {
    if (j < n_chunks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = z[j * 4 + e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kLnMaxPerLane / 4; ++j) {
    if (kF32 && j < n_chunks)
      ln_store4_f32(z + j * 4, mean, rstd, scale, bias, reinterpret_cast<float*>(y), planes,
                    base, j * 128 + lane * 4, C);
    if (!kF32 && j < n_chunks) {
      const int c = j * 128 + lane * 4;
      uint32_t packed[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int e = 2 * p;
        packed[p] = ln_pair(z[j * 4 + e], z[j * 4 + e + 1], mean, rstd, scale, bias, c + e);
        if (QUANT) {  // keep the bf16-rounded values for the quantization
          const float2 r = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&packed[p]));
          z[j * 4 + e] = r.x;
          z[j * 4 + e + 1] = r.y;
          amax = fmaxf(amax, fmaxf(fabsf(r.x), fabsf(r.y)));
        }
      }
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(y) + base + c) =
          make_uint2(packed[0], packed[1]);
    }
  }
  if (QUANT) {
    const float s = fmaxf(warp_max(amax) * kInv127, 1e-12f);
#pragma unroll
    for (int j = 0; j < kLnMaxPerLane / 4; ++j) {
      if (j < n_chunks) {
        const int c = j * 128 + lane * 4;
        *reinterpret_cast<uint32_t*>(q + base + c) =
            pack_s8x4(quantize_s8(z[j * 4], s), quantize_s8(z[j * 4 + 1], s),
                      quantize_s8(z[j * 4 + 2], s), quantize_s8(z[j * 4 + 3], s));
      }
    }
    if (lane == 0) q_scale[row] = s;
  }
}

// Needs C % 128 == 0 (any C); the arguments of ln_rows_kernel. Three passes
// over the row from global memory, and with QUANT a fourth over y.
template <bool RESID, bool DROP, bool QUANT, bool BSCALE = false, typename E = __nv_bfloat16>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_wide_kernel(const E* __restrict__ x, const E* __restrict__ t,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    E* y, int8_t* __restrict__ q, float* __restrict__ q_scale,
                    int N, int C, float eps, DropSite drop,
                    const float* __restrict__ branch_scale = nullptr, int rows_per_scale = 1,
                    __nv_bfloat16* __restrict__ planes = nullptr) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  static_assert(!(kF32 && QUANT), "the int8 block's quantization reads bf16 rows");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kLnThreads / 32) + warp;
  if (row >= N) return;
  const float bscale = BSCALE ? branch_scale[row / rows_per_scale] : 1.f;
  const int n_chunks = C / 128;
  const size_t base = static_cast<size_t>(row) * C;
  float z[4];
  float sum = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    ln_load4<RESID, DROP, BSCALE>(x, t, base, j * 128 + lane * 4, row, drop, bscale, z);
    sum += z[0] + z[1];
    sum += z[2] + z[3];
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    ln_load4<RESID, DROP, BSCALE>(x, t, base, j * 128 + lane * 4, row, drop, bscale, z);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = z[e] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  float amax = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    const int c = j * 128 + lane * 4;
    ln_load4<RESID, DROP, BSCALE>(x, t, base, c, row, drop, bscale, z);
    if (kF32) {
      ln_store4_f32(z, mean, rstd, scale, bias, reinterpret_cast<float*>(y), planes, base, c, C);
      continue;
    }
    uint32_t packed[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      packed[p] = ln_pair(z[2 * p], z[2 * p + 1], mean, rstd, scale, bias, c + 2 * p);
      if (QUANT) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&packed[p]));
        amax = fmaxf(amax, fmaxf(fabsf(r.x), fabsf(r.y)));
      }
    }
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(y) + base + c) =
        make_uint2(packed[0], packed[1]);
  }
  if (QUANT) {
    const float s = fmaxf(warp_max(amax) * kInv127, 1e-12f);
    for (int j = 0; j < n_chunks; ++j) {
      const int c = j * 128 + lane * 4;
      // this lane's own stores of the pass above
      const uint2 packed =
          *reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(y) + base + c);
      const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed.x));
      const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed.y));
      *reinterpret_cast<uint32_t*>(q + base + c) =
          pack_s8x4(quantize_s8(r0.x, s), quantize_s8(r0.y, s), quantize_s8(r1.x, s),
                    quantize_s8(r1.y, s));
    }
    if (lane == 0) q_scale[row] = s;
  }
}

// One launch of the row LayerNorm on stream s, the register instance for
// C <= 1024 and the wide one above; E (bf16 unless given) the rows' type.
// Returns a cudaError_t.
template <bool RESID, bool DROP, bool QUANT, bool BSCALE = false, typename E = __nv_bfloat16>
int launch_ln_rows(cudaStream_t s, const ln_t<E>* x, const ln_t<E>* t, const float* scale,
                   const float* bias, ln_t<E>* y, int8_t* q, float* q_scale, int N, int C,
                   float eps, DropSite drop, const float* branch_scale = nullptr,
                   int rows_per_scale = 1, __nv_bfloat16* planes = nullptr) {
  const int blocks = (N + kLnThreads / 32 - 1) / (kLnThreads / 32);
  if (C <= kLnRegCols)
    ln_rows_kernel<RESID, DROP, QUANT, BSCALE, E><<<blocks, kLnThreads, 0, s>>>(
        x, t, scale, bias, y, q, q_scale, N, C, eps, drop, branch_scale, rows_per_scale,
        planes);
  else
    ln_rows_wide_kernel<RESID, DROP, QUANT, BSCALE, E><<<blocks, kLnThreads, 0, s>>>(
        x, t, scale, bias, y, q, q_scale, N, C, eps, drop, branch_scale, rows_per_scale,
        planes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace a2v
