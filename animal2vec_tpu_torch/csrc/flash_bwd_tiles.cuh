// Tile helpers of the flash-attention backward kernels (alibi_attention_bwd.cu
// and bias_attention_bwd.cu): 64 x 64 bf16 tiles with D = 64, four warps of
// 16 rows, mma.sync m16n8k16 with fp32 accumulation. The accumulator of one
// product is reused in registers as the bf16 A operand of the next (the
// accumulator layout is the A-operand layout); see common.cuh for the
// fragment layouts.
#pragma once

#include "common.cuh"

namespace a2v {
namespace flash_bwd {

constexpr int kD = 64;
constexpr int kTile = 64;      // rows per block and per loop step
constexpr int kLds = kD + 8;   // padded shared row: conflict-free 32-bit reads
constexpr int kThreads = 128;  // four warps x 16 rows

using bf16 = __nv_bfloat16;

// 16-byte chunks of a 64 x 64 bf16 tile whose rows lie row_stride elements
// apart into padded shared rows; rows past T are zero-filled.
__device__ __forceinline__ void stage_rows(bf16* smem, const bf16* src, long long row_stride,
                                           int row0, int T, int tid) {
  for (int c = tid; c < kTile * kD / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8, row = row0 + r;
    const long long src_row = row < T ? row : 0;
    cp_async_16(&smem[r * kLds + col], src + src_row * row_stride + col, row < T);
  }
}

// A fragments of this warp's 16 rows (r0 = warp * 16 + g) of a staged tile.
__device__ __forceinline__ void row_fragments(uint32_t (&f)[kD / 16][4], const bf16* smem,
                                              int r0, int i4) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * i4;
    f[kk][0] = ld_u32(&smem[r0 * kLds + c]);
    f[kk][1] = ld_u32(&smem[(r0 + 8) * kLds + c]);
    f[kk][2] = ld_u32(&smem[r0 * kLds + c + 8]);
    f[kk][3] = ld_u32(&smem[(r0 + 8) * kLds + c + 8]);
  }
}

// acc[j] (16 x 8, j = 0..7) = A (16 x D fragments) . rows[j*8 .. j*8+7]^T of
// a staged tile: the B operand is the tile's rows read as columns.
__device__ __forceinline__ void rows_product(float (&acc)[kTile / 8][4],
                                             const uint32_t (&a)[kD / 16][4], const bf16* smem,
                                             int g, int i4) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const bf16* row = &smem[(j * 8 + g) * kLds + 2 * i4];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t b[2] = {ld_u32(row + kk * 16), ld_u32(row + kk * 16 + 8)};
      mma_16816(acc[j], a[kk], b);
    }
  }
}

// out (16 x D) += A . tile, where A is the bf16 of acc (16 x 64, accumulator
// layout) and the tile (64 x D) is staged in shared memory; its B operands
// come transposed by ldmatrix.
__device__ __forceinline__ void acc_times_tile(float (&out)[kD / 8][4],
                                               const float (&acc)[kTile / 8][4],
                                               const bf16* smem, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(acc[2 * kk][0], acc[2 * kk][1]),
                            pack_bf16(acc[2 * kk][2], acc[2 * kk][3]),
                            pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                            pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
    const int tile = lane >> 3;
    const int row = kk * 16 + (tile & 1) * 8 + (lane & 7);
#pragma unroll
    for (int dn = 0; dn < kD / 8; dn += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, &smem[row * kLds + (dn + (tile >> 1)) * 8]);
      mma_16816(out[dn], pa, bv);
      mma_16816(out[dn + 1], pa, bv + 2);
    }
  }
}

// Rows row0 and row1 (< T) of this thread's (16 x D) accumulator, times
// scale, as bf16 into rows row_stride elements apart.
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           const float (&acc)[kD / 8][4], int row0, int row1,
                                           int T, float scale, int i4) {
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * i4;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(&dst[static_cast<long long>(row0) * row_stride + col]) =
          pack_bf16(acc[dn][0] * scale, acc[dn][1] * scale);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(&dst[static_cast<long long>(row1) * row_stride + col]) =
          pack_bf16(acc[dn][2] * scale, acc[dn][3] * scale);
  }
}

}  // namespace flash_bwd
}  // namespace a2v
