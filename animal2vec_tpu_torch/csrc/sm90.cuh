// Hopper (sm_90a) building blocks of the wgmma kernels: tiles of 128-byte
// rows (64 bf16: a head of D 64, or one of the two halves of a head of any
// other D up to 128; or 128 int8 along K) in the 128-byte swizzled
// shared-memory layout, staged by cp.async; the wgmma descriptor of such a
// tile; the wgmma m64n64k16 bf16 products (fp32 accumulate) with both
// operands in shared memory (SS, each K- or MN-major) or A in registers
// (RS); an fp32 tile layout for float2 access; the m64n8k16 SS
// product of one 8-column group, and the SS m64n128k16 product of the bf16
// GEMM (bf16_gemm_sm90.cuh); the int8 wgmma m64n128k32 and m64n64k32
// (int32 accumulate; SS, and RS for N = 64); and the fences that order
// them. The fp32 instances of the kernels stage each fp32 operand as two
// bf16 tiles, its hi and lo parts (split_pair, stage_head_split), and take
// each fp32 product as three bf16 products into one accumulator
// (gemm_head_ss_of, frag_split_from_acc).
//
// One warpgroup (four warps, 128 threads) issues each product for 64 rows;
// warp w owns rows 16w .. 16w + 15. Register layouts (PTX ISA, "wgmma
// .m64nNk16"), lane = 4*g + i:
//   D (64 x 64 fp32, 32 registers): d[4j + 2r + e] = D[16w + g + 8r][8j + 2i + e]
//     (the mma.sync m16n8 accumulator layout, once per 8 columns);
//   A (64 x 16 bf16, RS, 4 registers): the mma.sync m16n8k16 A layout of the
//     warp's 16 rows (common.cuh). So the bf16 of columns 16kk .. 16kk + 15
//     of an accumulator is the A operand of step kk of the next product:
//     frag_from_acc below.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace a2v {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kRowElems = 64;               // a tile row: 64 bf16 = 128 bytes
constexpr int kTileRows = 64;               // wgmma's M, and the N of these products
constexpr int kTileElems = kTileRows * kRowElems;  // one 8 KB tile
constexpr int kTileAlign = 1024;            // the swizzle repeats every 8 rows

// 128-byte swizzle: row r of a tile keeps its 16-byte chunk c at chunk
// c ^ (r % 8), the layout that wgmma's descriptor (layout 1) and TMA's
// SWIZZLE_128B use. The hardware XORs address bits [4, 7) with bits [7, 10),
// so a tile's base must be 1024-byte aligned. Returns the element offset.
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * kRowElems + ((chunk ^ (row & 7)) << 3);
}

// Rows row0 .. row0 + 63 of a plane of 64-element bf16 rows (row_stride
// elements apart) into a swizzled tile by cp.async, 16 bytes at a time;
// rows at or past T are zero-filled. The caller commits the group.
template <int kThreads>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* src, long long row_stride,
                                           int row0, int T, int tid) {
  constexpr int kChunks = kTileRows * 8;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = tid + i * kThreads, r = c >> 3, ch = c & 7, row = row0 + r;
    if (kChunks % kThreads != 0 && c >= kChunks) break;
    const bool in = row < T;
    cp_async_16(tile + sw128(r, ch), src + (in ? row : 0) * row_stride + ch * 8, in);
  }
}

// As stage_tile for rows of which only the first ``cols`` elements (a
// multiple of 8 below 64; none at or below 0) are read: the chunks past
// them are zero-filled.
template <int kThreads>
__device__ __forceinline__ void stage_tile_cols(bf16* tile, const bf16* src,
                                                long long row_stride, int row0, int T, int cols,
                                                int tid) {
  constexpr int kChunks = kTileRows * 8;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = tid + i * kThreads, r = c >> 3, ch = c & 7, row = row0 + r;
    if (kChunks % kThreads != 0 && c >= kChunks) break;
    const bool in = row < T && ch * 8 < cols;
    cp_async_16(tile + sw128(r, ch), in ? src + row * row_stride + ch * 8 : src, in);
  }
}

// fp32 operands as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi): x
// = hi + lo to about 2^-16 relative (2^-17 for round-to-nearest hi). An
// fp32 product a.b is taken as three bf16 products into one fp32
// accumulator, a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, each term's error about
// 2^-16 of |a||b| (the dropped a_lo.b_lo is 2^-17 squared).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// As stage_tile_cols for fp32 rows: rows row0 .. row0 + 63 of a plane of
// fp32 rows (row_stride elements apart, 16-byte aligned) split into a hi
// and a lo swizzled tile (split_pair). Columns at or past ``cols`` (a
// multiple of 8, up to 64) and rows at or past T are zero. Plain 16-byte
// loads into registers, then 8-byte shared stores: synchronous, so the
// tiles are complete once the caller's fence_proxy_async and barrier
// follow (no cp.async group).
template <int kThreads>
__device__ __forceinline__ void stage_tile_split(bf16* hi, bf16* lo, const float* src,
                                                 long long row_stride, int row0, int T,
                                                 int cols, int tid) {
  constexpr int kQuads = kTileRows * 16;  // 16-byte fp32 quads of a 64 x 64 tile
  constexpr int kIters = (kQuads + kThreads - 1) / kThreads;
  float4 x[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int c = tid + i * kThreads, r = c >> 4, f = c & 15, row = row0 + r;
    x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((kQuads % kThreads == 0 || c < kQuads) && row < T && f * 4 < cols)
      x[i] = *reinterpret_cast<const float4*>(src + row * row_stride + f * 4);
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int c = tid + i * kThreads, r = c >> 4, f = c & 15;
    if (kQuads % kThreads != 0 && c >= kQuads) break;
    uint2 h, l;
    split_pair(x[i].x, x[i].y, h.x, l.x);
    split_pair(x[i].z, x[i].w, h.y, l.y);
    const int at = sw128(r, f >> 1) + ((f & 1) << 2);
    *reinterpret_cast<uint2*>(hi + at) = h;
    *reinterpret_cast<uint2*>(lo + at) = l;
  }
}

// The attention kernels' head dims: a multiple of 8 up to 128 (their
// wrappers pad other head dims with zero columns).
__host__ __device__ constexpr bool head_dim_ok(int D) {
  return D > 0 && D <= 2 * kRowElems && D % 8 == 0;
}

// A head's rows of D elements as NC consecutive swizzled tiles, tile n
// holding columns 64n .. 64n + 63. NC = 1: D is 64 (the D 64 instances, as
// before the head dims came). NC = 2: any other D (a multiple of 8 up to
// 128), zero past D (zero columns add nothing to a product over D).
template <int kThreads, int NC>
__device__ __forceinline__ void stage_head(bf16* tiles, const bf16* src, long long row_stride,
                                           int row0, int T, int D, int tid) {
  if constexpr (NC == 1) {
    stage_tile<kThreads>(tiles, src, row_stride, row0, T, tid);
  } else {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int cols = D - n * kRowElems;
      if (cols >= kRowElems)
        stage_tile<kThreads>(tiles + n * kTileElems, src + n * kRowElems, row_stride, row0, T,
                             tid);
      else
        stage_tile_cols<kThreads>(tiles + n * kTileElems, src + n * kRowElems, row_stride,
                                  row0, T, cols, tid);
    }
  }
}

// A head's rows of fp32 elements as stage_head's NC tiles, twice: the hi
// parts at ``tiles``, the lo parts NC tiles after them (stage_tile_split).
template <int kThreads, int NC>
__device__ __forceinline__ void stage_head_split(bf16* tiles, const float* src,
                                                 long long row_stride, int row0, int T, int D,
                                                 int tid) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
    stage_tile_split<kThreads>(tiles + n * kTileElems, tiles + (NC + n) * kTileElems,
                               src + n * kRowElems, row_stride, row0, T,
                               NC == 1 ? kRowElems : D - n * kRowElems, tid);
}

// A head's rows of element type E into shared memory: bf16 by cp.async
// into NC tiles (stage_head; the caller commits the group), fp32 split
// into 2 NC tiles, hi then lo (stage_head_split).
template <int kThreads, int NC, typename E>
__device__ __forceinline__ void stage_head_of(bf16* tiles, const E* src, long long row_stride,
                                              int row0, int T, int D, int tid) {
  if constexpr (std::is_same<E, float>::value)
    stage_head_split<kThreads, NC>(tiles, src, row_stride, row0, T, D, tid);
  else
    stage_head<kThreads, NC>(tiles, src, row_stride, row0, T, D, tid);
}

// Two adjacent outputs of a kernel's element type: one packed bf16 pair or
// a float2.
__device__ __forceinline__ void store_pair(bf16* at, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(at) = pack_bf16(x0, x1);
}
__device__ __forceinline__ void store_pair(float* at, float x0, float x1) {
  *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
}

// fp32 element (row r, column c) of a 64 x 64 fp32 tile (a dense bias, or
// dS) whose 16-byte chunks are XOR-swizzled by row, (c / 4) ^ 2 (r % 4):
// float2 reads and writes in the accumulator layout (rows g, columns 2i)
// and a warp's 32 consecutive floats of one row are conflict-free.
__device__ __forceinline__ int f32_tile_at(int r, int c) {
  return r * kTileRows + ((((c >> 2) ^ ((r & 3) << 1))) << 2) + (c & 3);
}

// The first 1024-byte aligned address at or after raw: the base of the
// swizzled tiles in dynamic shared memory (which the kernels size with
// kTileAlign bytes of slack).
__device__ __forceinline__ uint8_t* align_tiles(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + kTileAlign - 1) & ~uint32_t(kTileAlign - 1)) - a);
}

// wgmma descriptor of a swizzled tile: start address >> 4 in bits [0, 14);
// leading byte offset in [16, 30), which a 128-byte-swizzled operand whose
// K (or MN) extent is one 128-byte row never uses (1 by convention); stride
// byte offset 1024 >> 4 in [32, 46), the step between groups of 8 rows;
// base offset 0 (1024-aligned tiles) in [49, 52); layout 1, the 128-byte
// swizzle, in [62, 64). The one descriptor reads the tile
//   K-major (rows along M or N, a row's 64 elements along K; transpose bit
//     0): the k16 step kk starts 32 * kk bytes in, inside the swizzle atom;
//   MN-major (rows along K, a row's 64 elements along N; transpose bit 1,
//     for B): the k16 step kk starts 16 rows = 2048 * kk bytes in.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (static_cast<uint64_t>(smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
constexpr uint64_t kDescStepK = 32 >> 4;     // K-major: 16 elements along the row
constexpr uint64_t kDescStepMN = 2048 >> 4;  // MN-major: 16 rows
constexpr uint64_t kDescTile = (kTileElems * 2) >> 4;  // the next tile

// Before a wgmma whose accumulator or A registers ordinary code wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed groups of this thread's warpgroup are pending;
// before any thread reads their accumulators.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async and st.shared write through the generic proxy; wgmma reads
// shared memory through the async proxy. After the writes have landed (the
// cp.async wait) and before the barrier that precedes the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma uses across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

#define A2V_D32(c)                                                                          \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),     \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),     \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define A2V_D32_REGS                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define A2V_RW(x) "+f"(x)
#define A2V_WO(x) "=f"(x)

// d (64 x 64) = or += A (64 x 16, descriptor; kTransA 0: K-major, 1:
// MN-major) . B (16 x 64, descriptor; kTransB as kTransA). kAccumulate
// false overwrites d (scale-d 0), and d is then write-only to the compiler.
template <bool kAccumulate, int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " A2V_D32_REGS
        ", %32, %33, p, 1, 1, %36, %35;\n}\n"
        : A2V_D32(A2V_RW)
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB), "n"(kTransA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " A2V_D32_REGS
        ", %32, %33, p, 1, 1, %36, %35;\n}\n"
        : A2V_D32(A2V_WO)
        : "l"(desc_a), "l"(desc_b), "r"(0), "n"(kTransB), "n"(kTransA));
  }
}

// d (64 x 64) += A (64 x 16 bf16 in registers, the layout above) . B (16 x
// 64, descriptor; kTransB as above).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " A2V_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : A2V_D32(A2V_RW)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(kTransB));
}

// d0..d3 (64 x 8, the accumulator layout above with j = 0) = or += A (64 x 16, K-major,
// descriptor) . B (16 x 8, K-major descriptor: 8 rows along N): one
// column group of an S tile, for the narrow last key tile of a row.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_n8(float& d0, float& d1, float& d2, float& d3,
                                            uint64_t desc_a, uint64_t desc_b) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : A2V_RW(d0), A2V_RW(d1), A2V_RW(d2), A2V_RW(d3)
        : "l"(desc_a), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : A2V_WO(d0), A2V_WO(d1), A2V_WO(d2), A2V_WO(d3)
        : "l"(desc_a), "l"(desc_b), "r"(0));
  }
}

#define A2V_D64(c)                                                                      \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),      \
      c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]),    \
      c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]),   \
      c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]),   \
      c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]),   \
      c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]),   \
      c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),   \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define A2V_D64_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define A2V_RI(x) "+r"(x)

// int8: d (64 x 128 int32, 64 registers) = (scale_d 0) or += (scale_d 1)
// A (64 x 32 s8) . B (32 x 128 s8), both K-major descriptors (8-bit
// operands of wgmma must be K-major): a 128-byte swizzled row holds 128
// int8 along K, four k32 steps of kDescStepK. The accumulator layout is
// the fp32 one above, once per 8 columns: d[4j + 2r + e] = D[16w + g +
// 8r][8j + 2i + e], j < 16. The int32 sums are exact.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " A2V_D64_REGS
      ", %64, %65, p;\n}\n"
      : A2V_D64(A2V_RI)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// int8 with N = 64: d (64 x 64 int32, 32 registers, the layout above
// once per 8 columns, j < 8) = (scale_d 0) or += (scale_d 1) A (64 x 32
// s8) . B (32 x 64 s8). SS: both K-major descriptors (the segment-fold
// GEMM's 64-column tiles, int8_gemm_sm90.cuh; the int8 attention's S =
// Q K^T). RS: A from registers in the mma.sync m16n8k32 A layout of the
// warp's 16 rows (common.cuh): a[0] = A[g][4i .. 4i + 3], a[1] = A[g +
// 8][4i ..], a[2] = A[g][16 + 4i ..], a[3] = A[g + 8][16 + 4i ..], four
// int8 a register, the lowest column in the low byte (the int8 attention's
// O += P V).
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " A2V_D32_REGS
      ", %32, %33, p;\n}\n"
      : A2V_D32(A2V_RI)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_s8_n64_rs(int (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " A2V_D32_REGS
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : A2V_D32(A2V_RI)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The bf16 GEMM's product (bf16_gemm_sm90.cuh), SS with both operands
// K-major (A: 64 rows along M, B: 128 rows along N, one 128-byte swizzled
// row of 64 elements along K each): d (64 x 128 fp32, 64 registers, the
// layout above once per 8 columns, j < 16) = (scale_d 0) or += (scale_d 1)
// A (64 x 16) . B (16 x 128).
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " A2V_D64_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : A2V_D64(A2V_RW)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef A2V_D32
#undef A2V_D32_REGS
#undef A2V_D64
#undef A2V_D64_REGS
#undef A2V_RI
#undef A2V_RW
#undef A2V_WO

// d = (or, kAcc, +=) A . B for two swizzled 64 x 64 tiles (descriptors),
// each read K-major (0: rows along M or N, a row's 64 elements along K;
// <0, 0> is A . B^T of two row tiles, e.g. S = Q K^T) or MN-major (1: rows
// along K, a row's 64 elements along M or N): four k16 steps. Issue only;
// the caller commits and waits.
template <int kTransA, int kTransB, bool kAcc = false>
__device__ __forceinline__ void gemm_tile_ss(float (&d)[32], uint64_t da, uint64_t db) {
  constexpr uint64_t step_a = kTransA ? kDescStepMN : kDescStepK;
  constexpr uint64_t step_b = kTransB ? kDescStepMN : kDescStepK;
  wgmma_ss<kAcc, kTransB, kTransA>(d, da, db);
#pragma unroll
  for (int kk = 1; kk < kRowElems / 16; ++kk)
    wgmma_ss<true, kTransB, kTransA>(d, da + kk * step_a, db + kk * step_b);
}

// d = (or, kAcc, +=) A . B^T of two heads of NC tiles each (stage_head),
// K-major: the sum over D of NC tile products (S = Q K^T, dP = dO V^T).
// Issue only.
template <int NC, bool kAcc = false>
__device__ __forceinline__ void gemm_head_ss(float (&d)[32], uint64_t da, uint64_t db) {
  gemm_tile_ss<0, 0, kAcc>(d, da, db);
#pragma unroll
  for (int n = 1; n < NC; ++n) gemm_tile_ss<0, 0, true>(d, da + n * kDescTile, db + n * kDescTile);
}

// gemm_head_ss of two heads staged by stage_head_of: bf16 (kSplit false)
// one product; fp32 (kSplit, each head hi then lo, NC tiles apart) the
// three products hi.hi + hi.lo + lo.hi into d. Issue only.
template <int NC, bool kSplit>
__device__ __forceinline__ void gemm_head_ss_of(float (&d)[32], uint64_t da, uint64_t db) {
  gemm_head_ss<NC>(d, da, db);
  if constexpr (kSplit) {
    gemm_head_ss<NC, true>(d, da, db + NC * kDescTile);
    gemm_head_ss<NC, true>(d, da + NC * kDescTile, db);
  }
}

// d += A . B with A (64 x 64) in registers as four k16 fragments and B a
// swizzled 64 x 64 tile (descriptor) whose rows run along K (MN-major).
// Issue only.
__device__ __forceinline__ void gemm_frag_tile(float (&d)[32], const uint32_t (&a)[4][4],
                                               uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk) wgmma_rs<1>(d, a[kk], db + kk * kDescStepMN);
}

// bf16 A fragments of a 64 x 64 fp32 accumulator (columns along K).
__device__ __forceinline__ void frag_from_acc(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

// The hi and lo bf16 A fragments of a 64 x 64 fp32 accumulator
// (split_pair), for the fp32 instances' three-product RS steps.
__device__ __forceinline__ void frag_split_from_acc(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                                    const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
  }
}

}  // namespace sm90
}  // namespace a2v
