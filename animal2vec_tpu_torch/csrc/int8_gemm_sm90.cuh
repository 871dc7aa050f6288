// int8 GEMM for Hopper (sm_90a): wgmma on 128-byte swizzled shared-memory
// tiles behind a cp.async ring. int8_dense.cu's product (#10); the int8
// block (#7) and the int8 MLP (#9) still run int8_gemm.cuh's mma.sync
// GEMM.
//
//   C[N, NOUT] = bf16(fp32(A . W^T) * row_scale[row] * col_scale[col] + bias[col])
//
// A (N, K) and W (NOUT, K) are int8 row-major: both K-major, which wgmma
// needs for 8-bit operands, so nn.Linear's (out, in) weight needs no
// transpose. Each product and sum of the dequant is rounded on its own
// (no FMA contraction), in the order ((fp32(acc) * row scale) * col scale)
// + bias, as int8_gemm.cuh and the JAX kernel write it; then one bf16
// rounding. The int32 sums are exact, so the result is that of the plain
// version (ops/int8_mm.int8_dense_plain) bit for bit.
//
// Design: one block of two warpgroups per 128 x 128 output tile; each
// warpgroup owns 64 rows and issues wgmma m64n128k32 (s8 x s8 -> s32) with
// A (its 64 rows) and W (the tile's 128 columns) read from shared memory
// (SS). A K step is 128 int8 = one 128-byte swizzled row, four k32 steps.
// The (A, W) tile pairs of kG8Stages K steps live in a ring in dynamic
// shared memory, filled by cp.async 16 bytes at a time by all 256 threads:
// the copies of step t + kG8Stages - 1 are in flight while step t's
// products run. Rows past N, columns past NOUT and K past the matrix are
// zero-filled. blockIdx.x walks the output columns, so the blocks that
// share an A row tile run together and W (3 MB at 3072 x 1024) stays in L2.
//
// Bound on the H100 at a2v-large's b32 qkv projection (N = 64 000, K =
// 1024, 3072 outputs): 0.40 TOP of int8 work, 0.20 ms at the 1,979 TOP/s
// peak. A 128 x 128 tile brings 32 KB from L2 per K step for 2 M
// multiply-adds, 64 per byte, so L2's bandwidth rather than the tensor
// cores is the likelier limit of this design (not measured: ncu does not
// run on the card's machine). Measured slower on an H100 (PERF.md): 128 x
// 256 tiles, a fourth ring stage at one block an SM, and a wgmma group left
// in flight across the loop's barrier; two blocks an SM is what this design
// needs.
//
// Registers: 64 int32 accumulators a thread and no fp32 sums, under 128
// registers, so two blocks share an SM and one block's epilogue and ring
// fill overlap the other's products. The int8 block and MLP quantize their
// hidden activations in K segments, each with its own row scale; the fold
// of each segment's int32 sum into fp32 that they need is added with them
// when they move onto this core (ROADMAP B).
#pragma once

#include "sm90.cuh"

namespace a2v {
namespace {

constexpr int kG8Tile = 128;      // output tile rows and columns
constexpr int kG8BK = 128;        // K step: one 128-byte swizzled row of int8
constexpr int kG8Stages = 3;      // ring depth: two steps in flight
constexpr int kG8Threads = 256;   // two warpgroups of 64 rows
constexpr int kG8TileBytes = kG8Tile * kG8BK;    // 16 KB
constexpr int kG8StageBytes = 2 * kG8TileBytes;  // A and W
constexpr int kG8Smem = kG8Stages * kG8StageBytes + sm90::kTileAlign;

// Rows row0 .. row0 + 127 of an (n_rows, K) int8 matrix, columns k0 ..
// k0 + 127, into a swizzled tile (chunk c of row r at byte r * 128 +
// ((c ^ (r % 8)) << 4)); rows past n_rows and columns past K zero-filled.
// The caller commits the group.
__device__ __forceinline__ void stage_s8_tile(int8_t* tile, const int8_t* src, int row0,
                                              int n_rows, int K, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kG8Tile * 8 / kG8Threads; ++i) {
    const int c = tid + i * kG8Threads, r = c >> 3, ch = c & 7;
    const int row = row0 + r, col = k0 + ch * 16;
    const bool in = row < n_rows && col < K;
    cp_async_16(tile + r * kG8BK + ((ch ^ (r & 7)) << 4),
                src + (in ? static_cast<size_t>(row) * K + col : 0), in);
  }
}

// The dequant of an int32 sum: (fp32(acc) * row scale) * col scale.
__device__ __forceinline__ float dequant_s8(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

// Needs K % 16 == 0 and NOUT % 2 == 0. bias may be null.
__global__ void __launch_bounds__(kG8Threads, 2)
gemm_s8_sm90_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                    const float* __restrict__ row_scale, const float* __restrict__ col_scale,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ C, int N, int K,
                    int NOUT) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  int8_t* const ring = reinterpret_cast<int8_t*>(sm90::align_tiles(smem_raw));

  const int n0 = blockIdx.x * kG8Tile;  // output columns
  const int m0 = blockIdx.y * kG8Tile;  // rows
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int n_steps = (K + kG8BK - 1) / kG8BK;

  // step kt's A and W tiles into its ring slot; the caller commits
  auto stage = [&](int kt) {
    int8_t* dst = ring + (kt % kG8Stages) * kG8StageBytes;
    stage_s8_tile(dst, A, m0, N, K, kt * kG8BK, tid);
    stage_s8_tile(dst + kG8TileBytes, W, n0, NOUT, K, kt * kG8BK, tid);
  };
#pragma unroll
  for (int s = 0; s < kG8Stages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }

  // this thread's rows m0 + 64 wg + 16 warp + g + 8r and columns n0 + 8j +
  // 2 i4 + e: accumulator 4j + 2r + e
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rows[r] = m0 + 64 * wg + 16 * warp + g + 8 * r;

  const uint64_t desc_ring = desc_sw128(ring);
  for (int kt = 0; kt < n_steps; ++kt) {
    cp_async_wait<kG8Stages - 2>();  // this thread's copies of step kt have landed
    fence_proxy_async();
    __syncthreads();  // step kt visible to all; every warpgroup is done with step kt - 1
    if (kt + kG8Stages - 1 < n_steps) stage(kt + kG8Stages - 1);  // into step kt - 1's slot
    cp_async_commit();

    const uint64_t slot = desc_ring + (((kt % kG8Stages) * kG8StageBytes) >> 4);
    const uint64_t da = slot + ((wg * 64 * kG8BK) >> 4), db = slot + (kG8TileBytes >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kG8BK / 32; ++kk)
      wgmma_s8_n128(acc, da + kk * kDescStepK, db + kk * kDescStepK, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  float rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rs[r] = rows[r] < N ? row_scale[rows[r]] : 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * i4;
    if (col >= NOUT) continue;
    float cs[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cs[e] = col_scale[col + e];
      if (bias) b[e] = bias[col + e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= N) continue;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = dequant_s8(acc[4 * j + 2 * r + e], rs[r], cs[e]);
        if (bias) y[e] = __fadd_rn(y[e], b[e]);
      }
      *reinterpret_cast<uint32_t*>(C + static_cast<size_t>(rows[r]) * NOUT + col) =
          pack_bf16(y[0], y[1]);
    }
  }
}

}  // namespace
}  // namespace a2v
