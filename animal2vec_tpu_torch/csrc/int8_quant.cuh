// The int8 row quantizers of the int8 kernels (ops/int8_mm.quantize_rows):
// a scale is s = max(max|v| * kInv127, 1e-12) and a value rint(v / s), round
// half to even (common.cuh's quantize_s8).
//
// quantize_segments_kernel: x (rows, len), bf16 or fp32, cut into segments
// of seg_len columns; each (row, segment) gets its own scale. One warp per
// (row, segment) reads it twice (max, then quantize). The int8 dense
// projection (#10, int8_dense.cu) and the int8 MLP (#9, fused_mlp_int8.cu)
// quantize their bf16 x with it, one segment a row.
//
// quantize_chunks_kernel: the h quantizer of the int8 block (#7,
// fused_block_int8.cu) and the int8 MLP (#9): h (rows, len) fp32 cut into
// chunks of `chunk` columns; chunk j of a row gets the scale from amax, the
// max of the chunk's chunk / 128 partial maxima (fc1's row_amax,
// int8_gemm_sm90.cuh kEpiGeluF32), which is the chunk's max, so the
// result is quantize_rows of the chunk bit for bit. One warp per (row,
// chunk) reads the chunk once, 16 bytes a lane.
#pragma once

#include "common.cuh"

namespace a2v {
namespace {

constexpr int kQuantThreads = 256;   // 8 (row, segment) items per block
constexpr int kQuantPartCols = 128;  // columns behind each partial max of amax

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Needs seg_len % 2 == 0 and len % seg_len == 0; scale is (rows, len / seg_len).
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

// Needs chunk % 128 == 0, chunk <= 4096 and len % chunk == 0; scale is
// (rows, len / chunk), amax (rows, len / 128).
__global__ void __launch_bounds__(kQuantThreads)
quantize_chunks_kernel(const float* __restrict__ h, const float* __restrict__ amax,
                       int8_t* __restrict__ q, float* __restrict__ scale, int rows, int len,
                       int chunk) {
  const int n_chunks = len / chunk, parts = chunk / kQuantPartCols;
  const long long item =
      static_cast<long long>(blockIdx.x) * (kQuantThreads / 32) + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(rows) * n_chunks) return;
  const int lane = threadIdx.x & 31;
  const long long row = item / n_chunks;
  const int c = static_cast<int>(item % n_chunks);
  const float a = lane < parts ? amax[row * (len / kQuantPartCols) + c * parts + lane] : 0.f;
  const float s = fmaxf(warp_max(a) * kInv127, 1e-12f);
  const size_t base = static_cast<size_t>(row) * len + static_cast<size_t>(c) * chunk;
#pragma unroll 4
  for (int j = 4 * lane; j < chunk; j += 128) {
    const float4 v = *reinterpret_cast<const float4*>(h + base + j);
    *reinterpret_cast<uint32_t*>(q + base + j) = pack_s8x4(
        quantize_s8(v.x, s), quantize_s8(v.y, s), quantize_s8(v.z, s), quantize_s8(v.w, s));
  }
  if (lane == 0) scale[item] = s;
}

// Blocks of kQuantThreads for `items` (row, segment) items, one warp each.
inline int quantize_blocks(long long items) {
  return static_cast<int>((items + kQuantThreads / 32 - 1) / (kQuantThreads / 32));
}

}  // namespace
}  // namespace a2v
