// int8 GEMM for Hopper (sm_90a): wgmma on 128-byte swizzled shared-memory
// tiles behind a cp.async ring, with three epilogues: int8_dense.cu's
// projection (#10), and fc1 and fc2 of the int8 block (#7,
// fused_block_int8.cu) and of the int8 MLP (#9, fused_mlp_int8.cu).
//
//   kEpiDense:   C = bf16(fp32(A . W^T) * row_scale[row] * col_scale[col] + bias[col])
//   kEpiGeluF32: C = GELU(fp32(A . W^T) * row_scale[row] * col_scale[col] + bias[col]),
//                fp32, and row_amax[row, col / 128] = max |C| over the
//                128-column tile (the int8 block's h and its partial maxima)
//   kEpiSegBf16: C = bf16(sum over K segments s of fp32(A_s . W_s^T) *
//                row_scale[row, s] * col_scale[col] + bias[col])
//
// A (N, K) and W (NOUT, K) are int8 row-major: both K-major, which wgmma
// needs for 8-bit operands, so nn.Linear's (out, in) weight needs no
// transpose. Each product and sum of the dequant is rounded on its own
// (no FMA contraction), in the order ((fp32(acc) * row scale) * col scale)
// + bias, as the JAX kernels write it. kEpiSegBf16 is the
// int8 block's fc2: the int32 sum restarts at every seg_len columns of K
// (the block's hidden chunk, whose h values share one scale per row) and
// each segment's dequant is added to an fp32 sum that starts at 0, in the
// segments' order. The int32 sums are exact, so kEpiDense gives the plain
// version (ops/int8_mm.int8_dense_plain) bit for bit, and kEpiSegBf16 keeps
// the plain version's rounding of every step.
//
// Design: one block of two warpgroups per 128 x 128 output tile; each
// warpgroup owns 64 rows and issues wgmma m64n128k32 (s8 x s8 -> s32) with
// A (its 64 rows) and W (the tile's 128 columns) read from shared memory
// (SS). A K step is 128 int8 = one 128-byte swizzled row, four k32 steps.
// The (A, W) tile pairs of three K steps live in a ring in dynamic shared
// memory, filled by cp.async 16 bytes at a time by all 256 threads: the
// copies of step t + 2 are in flight while step t's products run. Rows
// past N, columns past NOUT and K past the matrix are zero-filled.
// blockIdx.x walks the output columns, so the blocks that share an A row
// tile run together and W stays in L2. A segment's first product
// overwrites the int32 sum (wgmma's scale-d 0), so the fold needs no
// reset.
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
// Registers: 64 int32 accumulators a thread, under 128 registers, so two
// blocks share an SM and one block's epilogue and ring fill overlap the
// other's products. kEpiSegBf16 also holds 64 fp32 sums, beyond the
// two-block cap: ptxas spills them to local memory, and they are touched
// only at the segment folds. Measured on an H100 at the int8 block's b32
// fc2 (N 64 000, K 4096, 1024 outputs; PERF.md): 0.745 ms so, against
// 0.914 for unspilled 128 x 64 tiles (24 KB from L2 a K step for half the
// products) and 0.857-0.865 for 128 x 128 at one block an SM (255
// registers, three or four stages).
//
// kEpiGeluF32 stages each warpgroup's 64 x 128 fp32 results through padded
// shared-memory rows (544 bytes: conflict-free 8-byte writes from the
// accumulator layout) in the ring's space and stores them as 16-byte row
// chunks; the row's max |h| over the tile comes from the same registers (a
// shuffle over the four threads of a row), so the chunk quantizer
// (int8_quant.cuh) reads h once.
#pragma once

#include "sm90.cuh"

namespace a2v {
namespace {

enum : int { kEpiDense = 0, kEpiGeluF32 = 1, kEpiSegBf16 = 2 };

constexpr int kG8Tile = 128;      // output tile rows and columns
constexpr int kG8BK = 128;        // K step: one 128-byte swizzled row of int8
constexpr int kG8Stages = 3;      // ring depth: two steps in flight
constexpr int kG8Threads = 256;   // two warpgroups of 64 rows
constexpr int kG8TileBytes = kG8Tile * kG8BK;    // 16 KB
constexpr int kG8StageBytes = 2 * kG8TileBytes;  // A and W
constexpr int kG8Smem = kG8Stages * kG8StageBytes + sm90::kTileAlign;

// Rows row0 .. row0 + 127 of an (n_rows, K) int8 matrix, columns k0 ..
// k0 + 127, into a swizzled tile (chunk c of row r at byte r * 128 + ((c ^
// (r % 8)) << 4)); rows past n_rows and columns past K zero-filled. The
// caller commits the group.
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

// Needs K % 16 == 0 and NOUT % 2 == 0; kEpiGeluF32 also NOUT % 128 == 0;
// kEpiSegBf16 K % seg_len == 0 and seg_len % 128 == 0. bias may be null
// for kEpiDense. row_scale is (N,), or (N, K / seg_len) for kEpiSegBf16;
// row_amax (N, NOUT / 128) is written by kEpiGeluF32 only.
template <int kEpi>
__global__ void __launch_bounds__(kG8Threads, 2)
gemm_s8_sm90_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                    const float* __restrict__ row_scale, const float* __restrict__ col_scale,
                    const float* __restrict__ bias, void* __restrict__ C,
                    float* __restrict__ row_amax, int N, int K, int NOUT, int seg_len) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  int8_t* const ring = reinterpret_cast<int8_t*>(sm90::align_tiles(smem_raw));

  const int n0 = blockIdx.x * kG8Tile;  // output columns
  const int m0 = blockIdx.y * kG8Tile;  // rows
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int n_steps = (K + kG8BK - 1) / kG8BK;
  const int seg_steps = kEpi == kEpiSegBf16 ? seg_len / kG8BK : n_steps;

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
  float sum[kEpi == kEpiSegBf16 ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (kEpi == kEpiSegBf16 ? 64 : 1); ++i) sum[i] = 0.f;
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
    const int first = kt % seg_steps == 0;  // a segment's first step overwrites the sums
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kG8BK / 32; ++kk)
      wgmma_s8_n128(acc, da + kk * kDescStepK, db + kk * kDescStepK, kk > 0 || !first);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    if constexpr (kEpi == kEpiSegBf16) {
      if ((kt + 1) % seg_steps == 0) {  // fold the segment's int32 sums into fp32
        const int n_seg = K / seg_len, seg = kt / seg_steps;
        float rs[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rs[r] = rows[r] < N ? row_scale[static_cast<size_t>(rows[r]) * n_seg + seg] : 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + 8 * j + 2 * i4;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float cs = col < NOUT ? col_scale[col + e] : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * j + 2 * r + e;
              sum[i] = __fadd_rn(sum[i], dequant_s8(acc[i], rs[r], cs));
            }
          }
        }
      }
    }
  }

  if constexpr (kEpi == kEpiGeluF32) {
    // through shared memory: each warpgroup writes its 64 x 128 fp32 results
    // into its own padded rows, then stores them as 16-byte row chunks
    __syncthreads();  // every warpgroup's products have read the ring
    constexpr int kLdo = kG8Tile + 8;  // floats per staged row
    float* const so = reinterpret_cast<float*>(ring) + wg * 64 * kLdo;
    float rs[2], amax[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) rs[r] = rows[r] < N ? row_scale[rows[r]] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int cl = 8 * j + 2 * i4, col = n0 + cl;
      float cs[2], b[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cs[e] = col_scale[col + e];
        b[e] = bias[col + e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = gelu_erf(__fadd_rn(dequant_s8(acc[4 * j + 2 * r + e], rs[r], cs[e]), b[e]));
          amax[r] = fmaxf(amax[r], fabsf(y[e]));
        }
        *reinterpret_cast<float2*>(so + (16 * warp + g + 8 * r) * kLdo + cl) =
            make_float2(y[0], y[1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 1));
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 2));
      if (i4 == 0 && rows[r] < N)
        row_amax[static_cast<size_t>(rows[r]) * (NOUT / kG8Tile) + blockIdx.x] = amax[r];
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's rows
    float* const out = static_cast<float*>(C);
    const int wt = tid & 127;
#pragma unroll
    for (int i = 0; i < 64 * kG8Tile / 4 / 128; ++i) {
      const int c = wt + i * 128, rl = c / (kG8Tile / 4), ch = c % (kG8Tile / 4);
      const int row = m0 + 64 * wg + rl;
      if (row < N)
        *reinterpret_cast<float4*>(&out[static_cast<size_t>(row) * NOUT + n0 + 4 * ch]) =
            *reinterpret_cast<const float4*>(so + rl * kLdo + 4 * ch);
    }
  } else {
    __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(C);
    float rs[2] = {0.f, 0.f};
    if constexpr (kEpi == kEpiDense) {
#pragma unroll
      for (int r = 0; r < 2; ++r) rs[r] = rows[r] < N ? row_scale[rows[r]] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * i4;
      if (col >= NOUT) continue;
      float cs[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kEpi == kEpiDense) cs[e] = col_scale[col + e];
        if (bias) b[e] = bias[col + e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= N) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          if constexpr (kEpi == kEpiDense)
            y[e] = dequant_s8(acc[i], rs[r], cs[e]);
          else
            y[e] = sum[i];
          if (bias) y[e] = __fadd_rn(y[e], b[e]);
        }
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(rows[r]) * NOUT + col) =
            pack_bf16(y[0], y[1]);
      }
    }
  }
}

// One launch on stream s over N rows and NOUT output columns (the raised
// shared-memory limit set once per process and instance). Returns a
// cudaError_t.
template <int kEpi>
int launch_gemm_s8_sm90(cudaStream_t s, const int8_t* A, const int8_t* W, const float* row_scale,
                        const float* col_scale, const float* bias, void* C, float* row_amax,
                        int N, int K, int NOUT, int seg_len) {
  constexpr auto kernel = gemm_s8_sm90_kernel<kEpi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kG8Smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((NOUT + kG8Tile - 1) / kG8Tile, (N + kG8Tile - 1) / kG8Tile);
  kernel<<<grid, kG8Threads, kG8Smem, s>>>(A, W, row_scale, col_scale, bias, C, row_amax, N, K, NOUT,
                                        seg_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace a2v
