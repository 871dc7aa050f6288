// Row LayerNorm of the fused post-LN blocks (fused_block.cu,
// fused_block_int8.cu): one warp per row of C <= 1024 bf16 values, held in
// registers; fp32 statistics; bf16 out.
//
//   y = LN(z) * scale + bias,  z = x, or bf16(x + dp(drop(t))) when RESID
//   (the storage-dtype residual add of LN2; drop(t) rounds to bf16 first;
//   with BSCALE, dp multiplies it by the fp32 drop-path factor of its row's
//   sample, branch_scale[row / rows_per_scale], and rounds again).
//
// With QUANT the row is also quantized to int8 from its bf16-rounded output
// (the int8 block quantizes the cast-back r): s = max(max|y| * fp32(1/127),
// 1e-12), q = rint(y / s) with an IEEE division, round half to even, as
// ops/int8_mm.quantize_rows.
#pragma once

#include "common.cuh"

namespace a2v {
namespace {

constexpr int kLnThreads = 256;     // 8 rows per block, one warp per row
constexpr int kLnMaxPerLane = 32;   // C <= 1024

// Needs C % 128 == 0, C <= 1024. q and q_scale are read only with QUANT,
// branch_scale only with BSCALE.
template <bool RESID, bool DROP, bool QUANT, bool BSCALE = false>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ t,
               const float* __restrict__ scale, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ y, int8_t* __restrict__ q,
               float* __restrict__ q_scale, int N, int C, float eps, DropSite drop,
               const float* __restrict__ branch_scale = nullptr, int rows_per_scale = 1) {
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
      const int c = j * 128 + lane * 4;
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(x + base + c);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float2 v = __bfloat1622float2(xp[p]);
        if (RESID) {
          float2 tv =
              __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(t + base + c)[p]);
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
        z[j * 4 + 2 * p] = v.x;
        z[j * 4 + 2 * p + 1] = v.y;
        sum += v.x + v.y;
      }
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
    if (j < n_chunks) {
      const int c = j * 128 + lane * 4;
      uint32_t packed[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int e = 2 * p;
        const float y0 = (z[j * 4 + e] - mean) * rstd * scale[c + e] + bias[c + e];
        const float y1 = (z[j * 4 + e + 1] - mean) * rstd * scale[c + e + 1] + bias[c + e + 1];
        packed[p] = pack_bf16(y0, y1);
        if (QUANT) {  // keep the bf16-rounded values for the quantization
          const float2 r = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&packed[p]));
          z[j * 4 + e] = r.x;
          z[j * 4 + e + 1] = r.y;
          amax = fmaxf(amax, fmaxf(fabsf(r.x), fabsf(r.y)));
        }
      }
      *reinterpret_cast<uint2*>(y + base + c) = make_uint2(packed[0], packed[1]);
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

}  // namespace
}  // namespace a2v
