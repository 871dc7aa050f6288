// bf16 GEMM for Hopper (sm_90a) with the fused bias / GELU / dropout
// epilogue: wgmma on 128-byte swizzled shared-memory tiles behind a
// cp.async ring: the bf16 GEMM core of the fused post-LN block's two
// products (#6, fused_block.cu) and of the plain fused MLP's (#8,
// fused_mlp.cu, without dropout). The GEMM probe (#12b, probe_gemm.cu)
// runs the same core without bias, GELU or dropout (BIAS false) at a row
// tile BM of 64, 128 or 256 rows (BM / 64 warpgroups); #6 and #8 run the
// 128-row instances with a bias.
//
//   C[N, NOUT] = bf16(drop(act(A[N, K] W[NOUT, K]^T + bias)))
//
// A and W are bf16 row-major, both K-major as wgmma reads them from shared
// memory, so nn.Linear's (out, in) weight needs no transpose. The sums are
// fp32; the epilogue applies the fp32 bias, the exact-erf GELU
// (GELU), the hash dropout drop_factor(seed, global row, global column)
// (DROP; common.cuh, bit for bit the mask of the plain version and of the
// backward's recompute) and one rounding to bf16.
//
// Design: one block of two warpgroups per 128 x 128 output tile (BM / 64
// warpgroups per BM x 128 tile in the probe's instances); each
// warpgroup owns 64 rows and issues wgmma m64n128k16 with A (its 64 rows)
// and W (the tile's 128 columns) read from shared memory (SS). A K step is
// 64 bf16 = one 128-byte swizzled row, four k16 steps. The (A, W) tiles of
// three K steps live in a ring in dynamic shared memory, filled by
// cp.async 16 bytes at a time by all 256 threads: the copies of step t + 2
// are in flight while step t's products run. Rows past N and columns past
// NOUT are zero-filled and not stored. blockIdx.x walks the output columns,
// so the blocks that share an A row tile run together and W (8 MB at 4096
// x 1024) stays in L2. The epilogue is computed from the wgmma accumulator
// layout (sm90.cuh), thread (warp w, lane 4g + i) holding rows 16w + g + 8r
// and columns 8j + 2i + e of its warpgroup's 64 rows; it writes the bf16
// results into padded shared-memory rows (272 bytes: conflict-free) and
// stores them as 16-byte row chunks.
//
// Bound on the H100 at a2v-large's b32 block (N = 64 000, C = 1024, M =
// 4096): each product is 0.54 TFLOP, 0.54 ms at the 989 TFLOP/s bf16 peak,
// against 0.66 GB of A, W and C (fc1; 0.20 ms at 3.35 TB/s): bound by
// operations. A 128 x 128 tile brings 32 KB from L2 per K step for 1 M
// multiply-adds, 32 per byte; wgmma reads both operands from shared memory
// at 64 + 128 rows of 128 bytes per k16 step of a warpgroup. Two blocks an
// SM (<= 128 registers, 2 x 97 KB): one block's epilogue (the bias, GELU,
// dropout and stores) overlaps the other's products. Measured on an H100
// (PERF.md): the staged 16-byte stores beat 4-byte stores straight from
// the accumulator layout (b32 fc1 1.13-1.18 against 1.24-1.27 ms, fc2 0.91
// against 1.03); slower were 128 x 256 tiles (fc2 0.93 against 1.04 ms
// with a wgmma group in flight, but fc1 1.60 against 1.24 at one block an
// SM), a fourth stage at one block an SM, a wgmma group left in flight
// across the loop's barrier, and a warp-specialized block (a producer
// warpgroup filling the ring by cp.async and mbarriers for two consumer
// warpgroups).
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace a2v {
namespace {

constexpr int kG16BM = 128;       // output tile rows of #6 and #8: two warpgroups of 64
constexpr int kG16BN = 128;       // output tile columns (wgmma's N)
constexpr int kG16BK = 64;        // K step: one 128-byte swizzled row of bf16
constexpr int kG16Stages = 3;     // ring depth: two steps in flight

// Threads and dynamic shared memory of a BM-row tile: BM / 64 warpgroups;
// the ring of kG16Stages (A, then W) steps.
__host__ __device__ constexpr int g16_threads(int bm) { return 2 * bm; }
__host__ __device__ constexpr int g16_stage_elems(int bm) { return (bm + kG16BN) * kG16BK; }
__host__ __device__ constexpr int g16_smem(int bm) {
  return kG16Stages * g16_stage_elems(bm) * 2 + sm90::kTileAlign;
}

// Needs K % 64 == 0, NOUT % 8 == 0 and a 16-byte aligned C; BIAS false
// reads no bias (null). OutT float stores the fp32 results (the
// tensor-parallel fc2 partial, without bias, GELU or dropout; the fp32
// block's fc2 with them) as 8-byte pairs straight from the accumulator
// layout. SPLIT (bf16 OutT): C is (N, 3 NOUT), each row the bf16 hi parts
// of the NOUT results, their lo parts, and the hi parts again
// (sm90.cuh split_pair): the A operand [h_hi | h_lo | h_hi] of the next
// product of the fp32 block, which takes its fp32 product as three bf16
// ones along one K three times as long.
template <bool GELU, bool DROP, int BM = kG16BM, bool BIAS = true,
          typename OutT = __nv_bfloat16, bool SPLIT = false>
__global__ void __launch_bounds__(g16_threads(BM), BM >= 256 ? 1 : 2)
gemm_bf16_sm90_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                      const float* __restrict__ bias, OutT* __restrict__ C, int N, int K,
                      int NOUT, DropSite drop) {
  using namespace sm90;
  constexpr int kThreads = g16_threads(BM);
  constexpr int kStageElems = g16_stage_elems(BM);
  extern __shared__ uint8_t smem_raw[];
  bf16* const ring = reinterpret_cast<bf16*>(align_tiles(smem_raw));

  const int n0 = blockIdx.x * kG16BN;  // output columns
  const int m0 = blockIdx.y * BM;      // rows
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int n_steps = K / kG16BK;

  // step kt's A rows (BM / 64 tiles) and W rows (kG16BN / 64 tiles) into
  // its ring slot; the caller commits
  auto stage = [&](int kt) {
    bf16* dst = ring + (kt % kG16Stages) * kStageElems;
    const int k0 = kt * kG16BK;
#pragma unroll
    for (int t = 0; t < BM / kTileRows; ++t)
      stage_tile<kThreads>(dst + t * kTileElems, A + k0, K, m0 + t * kTileRows, N, tid);
#pragma unroll
    for (int t = 0; t < kG16BN / kTileRows; ++t)
      stage_tile<kThreads>(dst + (BM / kTileRows + t) * kTileElems, W + k0, K,
                           n0 + t * kTileRows, NOUT, tid);
  };
#pragma unroll
  for (int s = 0; s < kG16Stages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }

  float acc[kG16BN / 2];
#pragma unroll
  for (int i = 0; i < kG16BN / 2; ++i) acc[i] = 0.f;

  const uint64_t desc_ring = desc_sw128(ring);
  for (int kt = 0; kt < n_steps; ++kt) {
    cp_async_wait<kG16Stages - 2>();  // this thread's copies of step kt have landed
    fence_proxy_async();
    __syncthreads();  // step kt visible to all; every warpgroup is done with step kt - 1
    if (kt + kG16Stages - 1 < n_steps) stage(kt + kG16Stages - 1);  // into step kt - 1's slot
    cp_async_commit();

    const uint64_t slot = desc_ring + (((kt % kG16Stages) * kStageElems * 2) >> 4);
    const uint64_t da = slot + wg * kDescTile;               // this warpgroup's 64 rows
    const uint64_t db = slot + (BM / kTileRows) * kDescTile;  // the kG16BN W rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kG16BK / 16; ++kk)
      wgmma_bf16_n128(acc, da + kk * kDescStepK, db + kk * kDescStepK, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // the epilogue's values in place: bias, GELU, dropout in fp32
#pragma unroll
  for (int j = 0; j < kG16BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * i4;
    const float b0 = BIAS && col < NOUT ? bias[col] : 0.f;
    const float b1 = BIAS && col < NOUT ? bias[col + 1] : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * r;
      float x0 = BIAS ? acc[4 * j + 2 * r] + b0 : acc[4 * j + 2 * r];
      float x1 = BIAS ? acc[4 * j + 2 * r + 1] + b1 : acc[4 * j + 2 * r + 1];
      if (GELU) {
        x0 = gelu_erf(x0);
        x1 = gelu_erf(x1);
      }
      if (DROP) {
        const uint32_t gcol = drop.col0 + col;
        x0 *= drop_factor(drop.seed, drop.row0 + row, gcol, drop.thresh, drop.keep_scale);
        x1 *= drop_factor(drop.seed, drop.row0 + row, gcol + 1, drop.thresh, drop.keep_scale);
      }
      acc[4 * j + 2 * r] = x0;
      acc[4 * j + 2 * r + 1] = x1;
    }
  }
  if constexpr (std::is_same<OutT, float>::value) {
    // fp32 out: each thread stores its (row, column pair) results as float2
#pragma unroll
    for (int j = 0; j < kG16BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * i4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 64 * wg + 16 * warp + g + 8 * r;
        if (row < N && col < NOUT)
          *reinterpret_cast<float2*>(&C[static_cast<size_t>(row) * NOUT + col]) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
    return;  // the bf16 epilogue below is unreachable here
  }
  // epilogue through shared memory: each warpgroup writes its 64 x 128
  // bf16 outputs into its own padded rows (272 bytes: conflict-free), then
  // stores them as 16-byte row chunks; SPLIT in two passes, the hi parts
  // (into the row's first and third thirds), then the lo parts
  __syncthreads();  // every warpgroup's products have read the ring
  constexpr int kLdo = kG16BN + 8;  // elements per staged row
  bf16* const so = ring + wg * 64 * kLdo;
  const int wt = tid & 127;
  const size_t ldc = SPLIT ? 3 * static_cast<size_t>(NOUT) : NOUT;
#pragma unroll
  for (int pass = 0; pass < (SPLIT ? 2 : 1); ++pass) {
    if (pass) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // hi stored
#pragma unroll
    for (int j = 0; j < kG16BN / 8; ++j) {
      const int cl = 8 * j + 2 * i4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = 16 * warp + g + 8 * r;
        const float x0 = acc[4 * j + 2 * r], x1 = acc[4 * j + 2 * r + 1];
        uint32_t hi, lo;
        if (SPLIT)
          split_pair(x0, x1, hi, lo);
        else
          hi = pack_bf16(x0, x1);
        *reinterpret_cast<uint32_t*>(so + rl * kLdo + cl) = pass ? lo : hi;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's rows
#pragma unroll
    for (int i = 0; i < 64 * kG16BN / 8 / 128; ++i) {
      const int c = wt + i * 128, rl = c / (kG16BN / 8), ch = c % (kG16BN / 8);
      const int row = m0 + 64 * wg + rl, col = n0 + 8 * ch;
      if (row < N && col < NOUT) {
        const uint4 chunk = *reinterpret_cast<const uint4*>(so + rl * kLdo + 8 * ch);
        // (OutT is bf16 here; the cast keeps the fp32 instances compiling)
        bf16* const crow = reinterpret_cast<bf16*>(C) + static_cast<size_t>(row) * ldc + col;
        if (!SPLIT) {
          *reinterpret_cast<uint4*>(crow) = chunk;
        } else if (pass == 0) {
          *reinterpret_cast<uint4*>(crow) = chunk;
          *reinterpret_cast<uint4*>(crow + 2 * NOUT) = chunk;
        } else {
          *reinterpret_cast<uint4*>(crow + NOUT) = chunk;
        }
      }
    }
  }
}

// One GEMM launch on stream s: C = bf16(drop(act(A W^T + bias))) over N
// rows, the dropout template when `drop`; OutT float: C in fp32; SPLIT: C
// as its (N, 3 NOUT) hi, lo, hi planes. Returns a cudaError_t.
template <bool GELU, typename OutT = __nv_bfloat16, bool SPLIT = false>
int launch_gemm_sm90(bool drop, cudaStream_t s, const __nv_bfloat16* A, const __nv_bfloat16* W,
                     const float* bias, OutT* C, int N, int K, int NOUT,
                     const DropSite& site) {
  constexpr auto with_drop = gemm_bf16_sm90_kernel<GELU, true, kG16BM, true, OutT, SPLIT>;
  constexpr auto without_drop = gemm_bf16_sm90_kernel<GELU, false, kG16BM, true, OutT, SPLIT>;
  constexpr int kSmem = g16_smem(kG16BM);
  // the shared-memory limit above 48 KB, raised once per process for both
  static const cudaError_t attr = [] {
    const cudaError_t err =
        cudaFuncSetAttribute(with_drop, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    return err != cudaSuccess ? err
                              : cudaFuncSetAttribute(without_drop,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     kSmem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((NOUT + kG16BN - 1) / kG16BN, (N + kG16BM - 1) / kG16BM);
  (drop ? with_drop : without_drop)<<<grid, g16_threads(kG16BM), kSmem, s>>>(A, W, bias, C, N,
                                                                              K, NOUT, site);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the bias-free instance with a BM-row tile on stream s: C =
// bf16(A W^T) over N rows. Returns a cudaError_t.
template <int BM>
int launch_gemm_sm90_nobias(cudaStream_t s, const __nv_bfloat16* A, const __nv_bfloat16* W,
                            __nv_bfloat16* C, int N, int K, int NOUT) {
  constexpr auto kernel = gemm_bf16_sm90_kernel<false, false, BM, false>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g16_smem(BM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((NOUT + kG16BN - 1) / kG16BN, (N + BM - 1) / BM);
  kernel<<<grid, g16_threads(BM), g16_smem(BM), s>>>(A, W, nullptr, C, N, K, NOUT, DropSite{});
  return static_cast<int>(cudaGetLastError());
}

// One launch of the fp32-output instance on stream s: C = A W^T in fp32
// over N rows (no bias). Returns a cudaError_t.
inline int launch_gemm_sm90_f32(cudaStream_t s, const __nv_bfloat16* A, const __nv_bfloat16* W,
                                float* C, int N, int K, int NOUT) {
  constexpr auto kernel = gemm_bf16_sm90_kernel<false, false, kG16BM, false, float>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g16_smem(kG16BM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((NOUT + kG16BN - 1) / kG16BN, (N + kG16BM - 1) / kG16BM);
  kernel<<<grid, g16_threads(kG16BM), g16_smem(kG16BM), s>>>(A, W, nullptr, C, N, K, NOUT,
                                                              DropSite{});
  return static_cast<int>(cudaGetLastError());
}

// One matrix of a split launch (the fp32 instances' bf16 operand planes):
// src (rows, k) fp32, k a multiple of 4 and rows 16-byte aligned, into dst
// (rows, 3k) bf16, each row [hi | hi | lo] (a W operand) or, with
// a_operand, [hi | lo | hi] (an A operand): the product of the two along
// K = 3k is a_hi w_hi + a_lo w_hi + a_hi w_lo (sm90.cuh split_pair).
// quads = rows * k / 4; 0 leaves the slot unused.
struct SplitPlanes {
  const float* src;
  __nv_bfloat16* dst;
  size_t quads;
  int k;
  bool a_operand;
};

// Up to three matrices split in one launch, four elements a thread and step.
__global__ void split_planes_kernel(SplitPlanes m0, SplitPlanes m1, SplitPlanes m2) {
  const size_t total = m0.quads + m1.quads + m2.quads;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    // the matrix of quad i, field by field (a reference to a by-value
    // parameter would put the three on the stack)
    const bool first = i < m0.quads, second = !first && i < m0.quads + m1.quads;
    const float* src = first ? m0.src : (second ? m1.src : m2.src);
    __nv_bfloat16* dst = first ? m0.dst : (second ? m1.dst : m2.dst);
    const size_t k = first ? m0.k : (second ? m1.k : m2.k);
    const bool a_operand = first ? m0.a_operand : (second ? m1.a_operand : m2.a_operand);
    const size_t e = 4 * (i - (first ? 0 : (second ? m0.quads : m0.quads + m1.quads)));
    const size_t row = e / k, col = e % k;
    const float4 w = *reinterpret_cast<const float4*>(src + e);
    uint2 hi, lo;
    sm90::split_pair(w.x, w.y, hi.x, lo.x);
    sm90::split_pair(w.z, w.w, hi.y, lo.y);
    __nv_bfloat16* out = dst + 3 * row * k + col;
    *reinterpret_cast<uint2*>(out) = hi;
    *reinterpret_cast<uint2*>(out + k) = a_operand ? lo : hi;
    *reinterpret_cast<uint2*>(out + 2 * k) = a_operand ? hi : lo;
  }
}

// One split launch of up to three matrices on stream s. Returns a
// cudaError_t.
inline int launch_split_planes(cudaStream_t s, const SplitPlanes& m0, const SplitPlanes& m1,
                               const SplitPlanes& m2 = SplitPlanes{}) {
  const size_t quads = m0.quads + m1.quads + m2.quads;
  const size_t blocks = (quads + 255) / 256 < 132 * 16 ? (quads + 255) / 256 : 132 * 16;
  split_planes_kernel<<<static_cast<int>(blocks), 256, 0, s>>>(m0, m1, m2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace a2v
