// Backward of the dense-bias flash attention (bias_attention.cu), bf16 or
// fp32 in and out, head dims D <= 128 (a multiple of 8): three kernels.
//
// Replaces the backward of jax's stock TPU flash-attention kernel
// (jax.experimental.pallas.ops.tpu.flash_attention, reached through
// animal2vec_tpu/models/attention.py:flash_attention_tpu):
//   _flash_attention_bwd_dq  -> bias_attention_dq_kernel: dq and dS, the
//                               gradient of the bias (the stock kernel's ds);
//   _flash_attention_bwd_dkv -> bias_attention_dkv_kernel: dk and dv;
//   both, when one 64-row tile covers T -> bias_attention_bwd_single_kernel:
//                               dq, dS, dk and dv in one launch.
// It differentiates what bias_attention.cu computes, xla_attention's
// function (the stock kernel differentiates softmax((q.k + bias) / sqrt(D))
// instead): with s = q.k / sqrt(D) + bias, P = exp(s - lse) (lse from the
// forward), dP = dO . V^T and delta = rowsum(dO * O) (computed outside, one
// torch op):
//   dS    = P * (dP - delta)      = d bias  (fp32, (B, H, T, T))
//   dq    = dS . K / sqrt(D)
//   dk    = dS^T . Q / sqrt(D)
//   dv    = P^T . dO
// With the forward's dropout, f = keep / (1 - r) regenerated from the same
// hash of (seed + bh * 0xC2B2AE3D, query, key): dP = f (dO . V^T), dv =
// (P f)^T . dO, and delta = rowsum(dO * O) is unchanged (drop_f).
// P is expf(s - lse), s rounded as the forward rounds it (q.k / sqrt(D),
// then + bias), as the plain version computes it. A padded key's score is
// replaced by -1e10, a constant: its dS, and so its bias gradient, is 0. A
// query row whose keys are all padded (lse about -1e10) weighs every key
// 1/T in the forward: it passes 1/T to dv and no gradient to q, k or the
// bias. Keys and queries past T are dropped by bounds; the bias gradient
// is written for the T x T scores only.
//
// Bound on the H100 at the ViT-B/16 pretraining student's shape (B = 128,
// H = 12, T = 59; chip_smoke.py's bias_attention_bwd_bounds): 5 products
// of 2 T^2 D per (b, h), 0.44 GFLOP in all (under a microsecond at the bf16
// peak), against the bias in and dS out (21 MB each), q, k, v, dO (46 MB)
// and dq, dk, dv (35 MB): bound by bytes. As two launches (the dq kernel
// reads the bias and writes dS, q, k, v, dO and dq: ~101 MB, ~30 us; the
// dk/dv kernel reads the bias again and writes dk and dv: ~92 MB, ~27 us);
// as the single launch ~124 MB, ~37 us.
//
// Design (Hopper, sm_90a), from the ALiBi backward (alibi_attention_bwd.cu):
// one warpgroup (128 threads) per block owns 64 rows, wgmma's M, and every
// product is a wgmma m64n64k16 with fp32 accumulation (sm90.cuh) on 64 x 64
// bf16 tiles in the 128-byte swizzle, 1024-byte aligned, in dynamic shared
// memory:
//   dq kernel (64 queries, loops over key tiles):
//     S = Q K^T, dP = dO V^T (SS); dq += dS K (RS: dS from registers, K
//     MN-major);
//   dk/dv kernel (64 keys, loops over query tiles, transposed so that P^T
//   and dS^T come out in the A layout of the next products):
//     S^T = K Q^T, dP^T = V dO^T (SS); dv += P^T dO, dk += dS^T Q (RS, B
//     MN-major);
//   single kernel (T <= 64: one block per (b, h) holds the whole T x T
//   plane): S = Q K^T, dP = dO V^T (SS) once; the scalar pass writes the
//   bf16 of dS and of P into two more swizzled tiles, one query a row; then
//   dq = dS K (SS, dS K-major, K MN-major), dk = dS^T Q and dv = P^T dO (SS
//   with A MN-major: the staged tiles read transposed).
// q, k and v are read in place from the (B, T, H, D) views of the (B, T,
// 3, H, D) projection with their batch and time strides, as
// bias_attention.cu reads them, and dq, dk, dv are written into one (B, T,
// 3, H, D) gradient, the projection's. The streamed tiles of the two loop
// kernels (K, V and the bias tile for dq; Q, dO, the bias tile and each
// query's lse and delta for dk/dv) come through a 2-stage cp.async ring:
// the copies of tile t + 1 are in flight while tile t's products and
// scalar pass run. The bias and dS go through shared memory so that device
// memory sees row-contiguous runs (consecutive threads on consecutive
// addresses, 16 bytes a thread when T % 4 == 0, else 4): the bias tile is
// staged by cp.async, and the scalar pass writes each dS over its score's
// bias, from where the block stores dS rows to dbias. The dq and single
// kernels keep the fp32 tiles in sm90.cuh's f32_tile_at layout (float2 in
// the accumulator layout, conflict-free); the dk/dv kernel reads its bias
// tile transposed, from rows whose 8-float groups are XOR-swizzled by the
// row (SwizzledT: conflict-free for the transposed accumulator layout).
// Head dims: as in the forward a head's row is NC = 1 (D 64) or 2 (any
// other D up to 128) tiles of 64 columns, zero past D, and S and dP sum NC tile
// products. The dq kernel keeps NC dq accumulators. The dk/dv and single
// kernels, whose registers already hold two (three) accumulators, run one
// block per 64-column chunk cc of their outputs at NC = 2, each
// recomputing S and dP over the whole head; the single kernel's cc = 0
// block writes dbias. D = 64 runs the NC = 1 instances, unchanged.
// fp32 (the E = float instances, the _f32 entries), as the ALiBi backward's
// (alibi_attention_bwd.cu): every staged head is a hi and a lo bf16 tile
// (sm90.cuh stage_head_split, plain loads split in registers), and each of
// the five products is three bf16 products into one fp32 accumulator
// (hi.hi + hi.lo + lo.hi): S and dP (SS) from the staged tiles; the RS
// products of the loop kernels from dS's and P f's hi and lo fragments
// (frag_split_from_acc); the single kernel's SS products from the hi and lo
// tiles of dS and P f that its scalar pass writes (four tiles where bf16
// takes two). dS (= dbias) stays fp32, as does delta (one torch op); dq,
// dk and dv are written in fp32. Shared memory with a bias, bf16 / fp32
// bytes: dq NC 1 83 456 / 132 608, NC 2 132 608 / 230 912; dk/dv NC 1
// 84 992 / 134 144, NC 2 134 144 / 232 448; single NC 1 66 816 / 115 968,
// NC 2 99 584 / 181 504: every fp32 instance fits the 227 KB a block may
// take (dk/dv at NC 2 exactly), the single launch at NC 2 too.
#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTile = 64;      // rows per block and per loop step
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // ring depth of the streamed tiles
constexpr float kDeadLse = -5e9f;  // lse below this: every key of the row padded
constexpr int kTileBytes = kTileElems * 2;
constexpr int kF32Tile = kTile * kTile;  // floats of an fp32 tile

enum : int { kLive = 0, kPadded = 1, kPast = 2 };  // a key's or a query row's state

struct BiasBwdArgs {
  long long stride_b, stride_t;          // q, k, v (elements)
  long long out_stride_b, out_stride_t;  // dq, dk, dv
  long long bias_stride_b;               // 0 for a batch-uniform bias
  int H, T, D;
  float sm_scale;
  int bias16;   // bias rows 16-byte aligned: staged in 16-byte chunks
  int dbias16;  // dbias rows 16-byte aligned: stored in 16-byte chunks
  uint32_t seed;     // dropout seed (int32 bits)
  uint32_t thresh;   // keep when hash >= thresh; 0 = no dropout
  float keep_scale;  // 1 / (1 - rate)
};

// The forward's dropout factor of (query, key): keep_scale or 0 (1 without
// dropout), from the hash of (seed + bh * 0xC2B2AE3D, query, key).
__device__ __forceinline__ float drop_f(const BiasBwdArgs& a, uint32_t seed_mix, int query,
                                        int key) {
  if (a.thresh == 0u) return 1.f;
  const uint32_t z = static_cast<uint32_t>(query) * kHashRow + static_cast<uint32_t>(key) * kHashCol;
  return drop_mix_seeded(seed_mix, z) >= a.thresh ? a.keep_scale : 0.f;
}

// dynamic shared memory of each kernel: bf16 tiles (each twice, hi and
// lo, in the fp32 instances: planes 2), fp32 tiles (with a bias), side
// data, and slack to align the base to 1024 bytes
constexpr int dq_smem(int nc, bool has_bias, int planes) {
  return kTileBytes * nc * planes * (2 + 2 * kStages) +
         (has_bias ? kStages * kF32Tile * 4 : 0) + kStages * kTile * 4 + kTileAlign;
}
constexpr int dkv_smem(int nc, bool has_bias, int planes) {
  return kTileBytes * nc * planes * (2 + 2 * kStages) +
         (has_bias ? kStages * kF32Tile * 4 : 0) + kStages * kTile * 16 + kTileAlign;
}
constexpr int single_smem(int nc, bool has_bias, int planes) {
  return kTileBytes * (4 * nc + 2) * planes + (has_bias ? kF32Tile * 4 : 0) + kTile * 4 +
         kTileAlign;
}
static_assert(dq_smem(2, true, 2) <= 227 * 1024 && dkv_smem(2, true, 2) <= 227 * 1024 &&
                  single_smem(2, true, 2) <= 227 * 1024,
              "an fp32 instance exceeds the shared memory a block may take");

// Rows row0 .. row0 + 63, columns col0 .. col0 + 63 of a T x T fp32 plane
// into a 64 x 64 tile, element (r, c) at at(r, c); past T zero-filled. 16
// bytes a copy when the rows are 16-byte aligned (at keeps 4 columns of a
// 16-byte chunk together), else 4. The caller commits.
template <typename At>
__device__ __forceinline__ void stage_f32(float* dst, const float* plane, int row0, int col0,
                                          int T, bool vec16, int tid, At at) {
  if (vec16) {
#pragma unroll
    for (int i = 0; i < kTile * 16 / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 4, ch = c & 15;
      const int row = row0 + r, col = col0 + 4 * ch;
      const bool in = row < T && col < T;
      cp_async_16(dst + at(r, 4 * ch), plane + (in ? static_cast<size_t>(row) * T + col : 0), in);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kTile * kTile / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 6, cc = c & 63;
      const int row = row0 + r, col = col0 + cc;
      const bool in = row < T && col < T;
      cp_async_4(dst + at(r, cc), plane + (in ? static_cast<size_t>(row) * T + col : 0), in);
    }
  }
}

// The layouts of stage_f32: sm90.cuh's f32_tile_at, and rows of 64 floats
// whose 8-float groups are XORed with bits 1-2 of the row (the dk/dv
// kernel's bias tile, read transposed: a warp's reads at (query 8j + 2i +
// e, key 16w + g + 8r) fall in 32 banks; a 16-byte chunk stays whole).
struct Swizzled {
  __device__ __forceinline__ int operator()(int r, int c) const { return f32_tile_at(r, c); }
};
struct SwizzledT {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return r * kTile + (c ^ (((r >> 1) & 3) << 3));
  }
};

// The T x T part of a 64 x 64 fp32 tile (f32_tile_at layout) into rows row0
// .., columns col0 .. of a T x T plane: consecutive threads on consecutive
// addresses, 16 bytes each when vec16.
__device__ __forceinline__ void store_f32(float* plane, const float* src, int row0, int col0,
                                          int T, bool vec16, int tid) {
  if (vec16) {
#pragma unroll
    for (int i = 0; i < kTile * 16 / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 4, ch = c & 15;
      const int row = row0 + r, col = col0 + 4 * ch;
      if (row < T && col < T)
        *reinterpret_cast<float4*>(plane + static_cast<size_t>(row) * T + col) =
            *reinterpret_cast<const float4*>(src + f32_tile_at(r, 4 * ch));
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kTile * kTile / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 6, cc = c & 63;
      const int row = row0 + r, col = col0 + cc;
      if (row < T && col < T) plane[static_cast<size_t>(row) * T + col] = src[f32_tile_at(r, cc)];
    }
  }
}

// The state of key (or query) row `i` of a batch row: past T, padded, live.
__device__ __forceinline__ int key_state(const uint8_t* maskr, int key, int T) {
  return key >= T ? kPast : ((maskr && maskr[key]) ? kPadded : kLive);
}

// Rows row0, row0 + 8 (< T) of this thread's 64 x 64 accumulator, times
// scale, in E (bf16 or fp32) into columns col0 .. col0 + 63 (those below D)
// of rows row_stride elements apart.
template <typename E>
__device__ __forceinline__ void store_rows(E* dst, long long row_stride, const float (&acc)[32],
                                           int row0, int T, float scale, int i4, int col0,
                                           int D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (col0 + 8 * j < D)
        store_pair(&dst[row * row_stride + col0 + 8 * j + 2 * i4], acc[4 * j + 2 * r] * scale,
                   acc[4 * j + 2 * r + 1] * scale);
  }
}

// The A fragments of a 64 x 64 fp32 accumulator: bf16 (hi only), or fp32's
// hi and lo parts.
template <bool kF32>
__device__ __forceinline__ void frags_of(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                         const float (&d)[32]) {
  if constexpr (kF32)
    frag_split_from_acc(hi, lo, d);
  else
    frag_from_acc(hi, d);
}

// acc += A . B with A (64 x 64) in registers (frags_of) and B a swizzled
// tile whose rows run along K (descriptor db): bf16 one product; fp32 the
// three a_hi B_hi + a_hi B_lo + a_lo B_hi, B's lo tile at db + lo. Issue
// only.
template <bool kF32>
__device__ __forceinline__ void gemm_frag_of(float (&acc)[32], const uint32_t (&a_hi)[4][4],
                                             const uint32_t (&a_lo)[4][4], uint64_t db,
                                             uint64_t lo) {
  gemm_frag_tile(acc, a_hi, db);
  if constexpr (kF32) {
    gemm_frag_tile(acc, a_hi, db + lo);
    gemm_frag_tile(acc, a_lo, db);
  }
}

// One block per (64-query tile, head, batch): dq rows and the rows of dS.
// E: the element type of q, k, v, dout and the gradients, bf16 or fp32
// (each operand split in shared memory or registers, each product three
// bf16 products: sm90.cuh split_pair).
template <int NC, bool HAS_BIAS, typename E>
__global__ void __launch_bounds__(kThreads, NC == 1 ? 2 : 1)
bias_attention_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v,
                         const E* __restrict__ dout,       // (B, T, H, D) contiguous
                         const float* __restrict__ lse,    // (B*H, T)
                         const float* __restrict__ delta,  // (B*H, T)
                         const float* __restrict__ bias,   // null or (1 or B, H, T, T)
                         const uint8_t* __restrict__ mask, // null or (B, T)
                         E* __restrict__ dq,               // out_stride_b, out_stride_t
                         float* __restrict__ dbias,        // null or (B, H, T, T)
                         BiasBwdArgs a) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;     // a staged head: hi (and lo) tiles
  constexpr uint64_t kLo = NC * kDescTile;  // a staged head's lo tiles
  extern __shared__ uint8_t smem_raw[];
  constexpr int kHead = NC * kTileElems * kPlanes;  // a head's 64 rows, staged
  bf16* const sQ = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* const sDO = sQ + kHead;
  bf16* const sRing = sDO + kHead;  // stage s: K at 2s heads in, V after it
  // per stage: the bias tile, overwritten by the tile's dS
  float* const sBias = reinterpret_cast<float*>(sRing + kStages * 2 * kHead);
  int* const sKey = reinterpret_cast<int*>(sBias + (HAS_BIAS ? kStages * kF32Tile : 0));

  const int T = a.T, H = a.H, D = a.D;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long in_head = b * a.stride_b + h * D;
  const long long do_row = static_cast<long long>(H) * D;
  const E* kb = k + in_head;
  const E* vb = v + in_head;
  const uint8_t* maskr = mask ? mask + static_cast<long long>(b) * T : nullptr;
  const long long plane = static_cast<long long>(T) * T;
  const float* bias_p = HAS_BIAS ? bias + b * a.bias_stride_b + h * plane : nullptr;
  float* dbias_p = HAS_BIAS && dbias ? dbias + bh * plane : nullptr;
  const int n_tiles = (T + kTile - 1) / kTile;
  const uint32_t seed_mix = drop_seed_mix(a.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du);

  // key tile kt's K, V (and bias) into its ring slot; the caller commits
  auto stage = [&](int kt) {
    const int slot = kt % kStages, k0 = kt * kTile;
    bf16* dst = sRing + slot * 2 * kHead;
    stage_head_of<kThreads, NC>(dst, kb, a.stride_t, k0, T, D, tid);
    stage_head_of<kThreads, NC>(dst + kHead, vb, a.stride_t, k0, T, D, tid);
    if constexpr (HAS_BIAS)
      stage_f32(sBias + slot * kF32Tile, bias_p, q0, k0, T, a.bias16, tid, Swizzled{});
  };

  // prologue: Q and dO, then the first key tile, one commit group each
  stage_head_of<kThreads, NC>(sQ, q + in_head, a.stride_t, q0, T, D, tid);
  stage_head_of<kThreads, NC>(sDO, dout + b * T * do_row + h * D, do_row, q0, T, D, tid);
  cp_async_commit();
  stage(0);
  cp_async_commit();
  if (tid < kTile) sKey[tid] = key_state(maskr, tid, T);

  // this thread's rows q0 + 16 warp + g + 8r
  const int r0 = warp * 16 + g;
  float lse_r[2], delta_r[2];
  int rstate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const bool in = row < T;
    lse_r[r] = in ? lse[bh * T + row] : 0.f;
    delta_r[r] = in ? delta[bh * T + row] : 0.f;
    rstate[r] = !in ? kPast : (lse_r[r] < kDeadLse ? kPadded : kLive);
  }

  float acc_dq[NC][32], sc[32], dp[32];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dq[n][i] = 0.f;
  }
  const uint64_t desc_q = desc_sw128(sQ), desc_do = desc_sw128(sDO);
  const uint64_t desc_ring = desc_sw128(sRing);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();  // this thread's copies of tile kt (and Q, dO) have landed
    fence_proxy_async();
    __syncthreads();  // tile kt visible to all; every thread is done with tile kt - 1
    const int nt = kt + 1;
    int nkey = kLive;
    if (nt < n_tiles) {
      stage(nt);  // into the slot tile kt - 1 used
      if (tid < kTile) nkey = key_state(maskr, nt * kTile + tid, T);
    }
    cp_async_commit();

    const int slot = kt % kStages, k0 = kt * kTile;
    const uint64_t desc_k = desc_ring + slot * 2 * NC * kPlanes * kDescTile;
    wgmma_fence();
    gemm_head_ss_of<NC, kF32>(sc, desc_q, desc_k);                              // S = Q K^T
    gemm_head_ss_of<NC, kF32>(dp, desc_do, desc_k + NC * kPlanes * kDescTile);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta) at live keys of live rows, 0 elsewhere; written
    // over the score's bias when dbias is wanted
    float* const bt = sBias + slot * kF32Tile;
    const int* key = sKey + slot * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int col = 8 * j + 2 * i4;
      const int2 ks = *reinterpret_cast<const int2*>(key + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        float2 bv = make_float2(0.f, 0.f);
        if constexpr (HAS_BIAS) bv = *reinterpret_cast<const float2*>(bt + f32_tile_at(row, col));
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float x = sc[i] * a.sm_scale;
          if constexpr (HAS_BIAS) x += e ? bv.y : bv.x;
          const float p = expf(x - lse_r[r]);
          const bool live = (e ? ks.y : ks.x) == kLive && rstate[r] == kLive;
          const float f = drop_f(a, seed_mix, q0 + row, k0 + col + e);
          ds[e] = live ? p * (dp[i] * f - delta_r[r]) : 0.f;
          sc[i] = ds[e];
        }
        if (dbias_p)
          *reinterpret_cast<float2*>(bt + f32_tile_at(row, col)) = make_float2(ds[0], ds[1]);
      }
    }
    // dq += dS K; fp32: dS_hi K_hi + dS_hi K_lo + dS_lo K_hi
    uint32_t fds[4][4], fdl[4][4];
    frags_of<kF32>(fds, fdl, sc);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      fence_regs(acc_dq[n]);
      gemm_frag_of<kF32>(acc_dq[n], fds, fdl, desc_k + n * kDescTile, kLo);
    }
    wgmma_commit();
    if (nt < n_tiles && tid < kTile) sKey[(nt % kStages) * kTile + tid] = nkey;
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NC; ++n) fence_regs(acc_dq[n]);
    fence_regs(fds);
    if constexpr (kF32) fence_regs(fdl);
    if (dbias_p) {
      __syncthreads();  // every dS of the tile is in shared memory
      store_f32(dbias_p, bt, q0, k0, T, a.dbias16, tid);
    }
  }

#pragma unroll
  for (int n = 0; n < NC; ++n)
    store_rows(dq + b * a.out_stride_b + h * D, a.out_stride_t, acc_dq[n], q0 + r0, T, a.sm_scale,
               i4, 64 * n, NC == 1 ? kRowElems : D);
}

// One block per (64-key tile and 64-column chunk, head, batch): dk and dv
// rows, their columns 64 cc .. 64 cc + 63.
template <int NC, bool HAS_BIAS, typename E>
__global__ void __launch_bounds__(kThreads, NC == 1 ? 2 : 1)
bias_attention_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                          E* __restrict__ dk, E* __restrict__ dv, BiasBwdArgs a) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;     // a staged head: hi (and lo) tiles
  constexpr uint64_t kLo = NC * kDescTile;  // a staged head's lo tiles
  extern __shared__ uint8_t smem_raw[];
  constexpr int kHead = NC * kTileElems * kPlanes;  // a head's 64 rows, staged
  bf16* const sK = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* const sV = sK + kHead;
  bf16* const sRing = sV + kHead;  // stage s: Q at 2s heads in, dO after it
  // per stage: the bias tile, one query a row (SwizzledT)
  float* const sBias = reinterpret_cast<float*>(sRing + kStages * 2 * kHead);
  // per query of each stage: {lse, delta, state (as a float), unused}
  float4* const sQry = reinterpret_cast<float4*>(sBias + (HAS_BIAS ? kStages * kF32Tile : 0));

  const int T = a.T, H = a.H, D = a.D;
  const int k0 = blockIdx.x / NC * kTile, cc = blockIdx.x % NC, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long in_head = b * a.stride_b + h * D;
  const long long do_row = static_cast<long long>(H) * D;
  const E* qb = q + in_head;
  const E* dob = dout + b * T * do_row + h * D;
  const uint8_t* maskr = mask ? mask + static_cast<long long>(b) * T : nullptr;
  const long long plane = static_cast<long long>(T) * T;
  const float* bias_p = HAS_BIAS ? bias + b * a.bias_stride_b + h * plane : nullptr;
  const float inv_t = 1.f / T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const uint32_t seed_mix = drop_seed_mix(a.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du);

  // query tile qt's Q, dO (and bias) into its ring slot; the caller commits
  auto stage = [&](int qt) {
    const int slot = qt % kStages, q0 = qt * kTile;
    bf16* dst = sRing + slot * 2 * kHead;
    stage_head_of<kThreads, NC>(dst, qb, a.stride_t, q0, T, D, tid);
    stage_head_of<kThreads, NC>(dst + kHead, dob, do_row, q0, T, D, tid);
    if constexpr (HAS_BIAS)
      stage_f32(sBias + slot * kF32Tile, bias_p, q0, k0, T, a.bias16, tid, SwizzledT{});
  };
  // threads < 64 read query qt * 64 + tid's side data
  auto load_query = [&](int qt) {
    const int row = qt * kTile + tid;
    if (row >= T) return make_float4(0.f, 0.f, static_cast<float>(kPast), 0.f);
    const float l = lse[bh * T + row];
    return make_float4(l, delta[bh * T + row], static_cast<float>(l < kDeadLse ? kPadded : kLive),
                       0.f);
  };

  // prologue: K and V, then the first query tile, one commit group each
  stage_head_of<kThreads, NC>(sK, k + in_head, a.stride_t, k0, T, D, tid);
  stage_head_of<kThreads, NC>(sV, v + in_head, a.stride_t, k0, T, D, tid);
  cp_async_commit();
  stage(0);
  cp_async_commit();
  if (tid < kTile) sQry[tid] = load_query(0);

  // this thread's keys k0 + 16 warp + g + 8r (rows of S^T)
  const int r0 = warp * 16 + g;
  int kstate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kstate[r] = key_state(maskr, k0 + r0 + 8 * r, T);

  float acc_dk[32], acc_dv[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const uint64_t desc_k = desc_sw128(sK), desc_v = desc_sw128(sV);
  const uint64_t desc_ring = desc_sw128(sRing);

  for (int qt = 0; qt < n_tiles; ++qt) {
    cp_async_wait<0>();  // this thread's copies of tile qt (and K, V) have landed
    fence_proxy_async();
    __syncthreads();  // tile qt visible to all; every thread is done with tile qt - 1
    const int nt = qt + 1;
    float4 nq = make_float4(0.f, 0.f, 0.f, 0.f);
    if (nt < n_tiles) {
      stage(nt);  // into the slot tile qt - 1 used
      if (tid < kTile) nq = load_query(nt);
    }
    cp_async_commit();

    const int slot = qt % kStages;
    const uint64_t desc_q = desc_ring + slot * 2 * NC * kPlanes * kDescTile;
    const uint64_t desc_do = desc_q + NC * kPlanes * kDescTile;
    wgmma_fence();
    gemm_head_ss_of<NC, kF32>(st, desc_k, desc_q);    // S^T = K Q^T
    gemm_head_ss_of<NC, kF32>(dpt, desc_v, desc_do);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P at live (key, query) pairs, 1/T where a padded key meets a row whose
    // keys are all padded, 0 elsewhere; dS = P (dP - delta) at live keys
    const float* bt = sBias + slot * kF32Tile;
    const float4* qry = sQry + slot * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * i4 + e;
        const float4 qd = qry[col];
        const int qs = static_cast<int>(qd.z);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float x = st[i] * a.sm_scale;
          if constexpr (HAS_BIAS) x += bt[SwizzledT{}(col, r0 + 8 * r)];
          const float e_x = expf(x - qd.x);
          const bool live = kstate[r] == kLive && qs == kLive;
          const float p = live ? e_x : ((kstate[r] == kPadded && qs == kPadded) ? inv_t : 0.f);
          const float f = drop_f(a, seed_mix, qt * kTile + col, k0 + r0 + 8 * r);
          dpt[i] = live ? p * (dpt[i] * f - qd.y) : 0.f;
          st[i] = p * f;
        }
      }
    }
    // dv += P^T dO, dk += dS^T Q; fp32: each as the three products of the
    // A operand's hi and lo fragments with B's hi and lo tiles
    uint32_t fp[4][4], fds[4][4], fpl[4][4], fdl[4][4];
    frags_of<kF32>(fp, fpl, st);
    frags_of<kF32>(fds, fdl, dpt);
    wgmma_fence();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    gemm_frag_of<kF32>(acc_dv, fp, fpl, desc_do + cc * kDescTile, kLo);
    gemm_frag_of<kF32>(acc_dk, fds, fdl, desc_q + cc * kDescTile, kLo);
    wgmma_commit();
    if (nt < n_tiles && tid < kTile) sQry[(nt % kStages) * kTile + tid] = nq;
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(fp);
    fence_regs(fds);
    if constexpr (kF32) {
      fence_regs(fpl);
      fence_regs(fdl);
    }
  }

  const long long out_head = b * a.out_stride_b + h * D;
  const int cols = NC == 1 ? kRowElems : D;  // D 64: every column, known at compile time
  store_rows(dk + out_head, a.out_stride_t, acc_dk, k0 + r0, T, a.sm_scale, i4, 64 * cc, cols);
  store_rows(dv + out_head, a.out_stride_t, acc_dv, k0 + r0, T, 1.f, i4, 64 * cc, cols);
}

// T <= 64: one block per (head, batch, 64-column chunk cc) computes S and
// dP once and writes dq, dk and dv's columns 64 cc .. 64 cc + 63, and, the
// cc = 0 block, dS.
template <int NC, bool HAS_BIAS, typename E>
__global__ void __launch_bounds__(kThreads, NC == 1 && std::is_same<E, bf16>::value ? 3 : 2)
bias_attention_bwd_single_kernel(const E* __restrict__ q, const E* __restrict__ k,
                                 const E* __restrict__ v, const E* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                                 E* __restrict__ dq, E* __restrict__ dk, E* __restrict__ dv,
                                 float* __restrict__ dbias, BiasBwdArgs a) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;     // a staged head, dS, P f: hi (and lo) tiles
  constexpr uint64_t kLo = NC * kDescTile;  // a staged head's lo tiles
  extern __shared__ uint8_t smem_raw[];
  constexpr int kHead = NC * kTileElems * kPlanes;  // a head's 64 rows, staged
  bf16* const sQ = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* const sK = sQ + kHead;
  bf16* const sV = sK + kHead;
  bf16* const sDO = sV + kHead;
  bf16* const sDS = sDO + kHead;  // dS (hi, then lo), one query a row
  bf16* const sP = sDS + kPlanes * kTileElems;  // P f (1/T in rows of padded keys), likewise
  float* const sBias = reinterpret_cast<float*>(sP + kPlanes * kTileElems);  // the bias, then dS
  int* const sKey = reinterpret_cast<int*>(sBias + (HAS_BIAS ? kF32Tile : 0));

  const int T = a.T, H = a.H, D = a.D;
  const int h = blockIdx.x, b = blockIdx.y, cc = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long in_head = b * a.stride_b + h * D;
  const long long do_row = static_cast<long long>(H) * D;
  const uint8_t* maskr = mask ? mask + static_cast<long long>(b) * T : nullptr;
  const long long plane = static_cast<long long>(T) * T;
  float* dbias_p = HAS_BIAS && dbias && cc == 0 ? dbias + bh * plane : nullptr;
  const float inv_t = 1.f / T;
  const uint32_t seed_mix = drop_seed_mix(a.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du);

  stage_head_of<kThreads, NC>(sQ, q + in_head, a.stride_t, 0, T, D, tid);
  stage_head_of<kThreads, NC>(sK, k + in_head, a.stride_t, 0, T, D, tid);
  stage_head_of<kThreads, NC>(sV, v + in_head, a.stride_t, 0, T, D, tid);
  stage_head_of<kThreads, NC>(sDO, dout + b * T * do_row + h * D, do_row, 0, T, D, tid);
  if constexpr (HAS_BIAS)
    stage_f32(sBias, bias + b * a.bias_stride_b + h * plane, 0, 0, T, a.bias16, tid,
              Swizzled{});
  cp_async_commit();
  if (tid < kTile) sKey[tid] = key_state(maskr, tid, T);

  // this thread's rows 16 warp + g + 8r (their side data loads under the copies)
  const int r0 = warp * 16 + g;
  float lse_r[2], delta_r[2];
  int rstate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const bool in = row < T;
    lse_r[r] = in ? lse[bh * T + row] : 0.f;
    delta_r[r] = in ? delta[bh * T + row] : 0.f;
    rstate[r] = !in ? kPast : (lse_r[r] < kDeadLse ? kPadded : kLive);
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float sc[32], dp[32];
  const uint64_t desc_q = desc_sw128(sQ), desc_k = desc_sw128(sK), desc_v = desc_sw128(sV),
                 desc_do = desc_sw128(sDO), desc_ds = desc_sw128(sDS), desc_p = desc_sw128(sP);
  wgmma_fence();
  gemm_head_ss_of<NC, kF32>(sc, desc_q, desc_k);   // S = Q K^T
  gemm_head_ss_of<NC, kF32>(dp, desc_do, desc_v);  // dP = dO V^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);

  // dS and P as the two loop kernels form them, into the staged tiles
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int col = 8 * j + 2 * i4;
    const int2 ks = *reinterpret_cast<const int2*>(sKey + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      float2 bv = make_float2(0.f, 0.f);
      if constexpr (HAS_BIAS) bv = *reinterpret_cast<const float2*>(sBias + f32_tile_at(row, col));
      float ds[2], pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        const int kst = e ? ks.y : ks.x;
        float x = sc[i] * a.sm_scale;
        if constexpr (HAS_BIAS) x += e ? bv.y : bv.x;
        const float p = expf(x - lse_r[r]);
        const bool live = kst == kLive && rstate[r] == kLive;
        const float f = drop_f(a, seed_mix, row, col + e);
        ds[e] = live ? p * (dp[i] * f - delta_r[r]) : 0.f;
        pv[e] = f * (live ? p : ((kst == kPadded && rstate[r] == kPadded) ? inv_t : 0.f));
      }
      if (dbias_p)
        *reinterpret_cast<float2*>(sBias + f32_tile_at(row, col)) = make_float2(ds[0], ds[1]);
      const int at = sw128(row, j) + 2 * i4;
      if constexpr (kF32) {  // the hi and lo tiles
        uint32_t hi, lo;
        split_pair(ds[0], ds[1], hi, lo);
        *reinterpret_cast<uint32_t*>(sDS + at) = hi;
        *reinterpret_cast<uint32_t*>(sDS + kTileElems + at) = lo;
        split_pair(pv[0], pv[1], hi, lo);
        *reinterpret_cast<uint32_t*>(sP + at) = hi;
        *reinterpret_cast<uint32_t*>(sP + kTileElems + at) = lo;
      } else {
        *reinterpret_cast<uint32_t*>(sDS + at) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(sP + at) = pack_bf16(pv[0], pv[1]);
      }
    }
  }
  fence_proxy_async();  // the staged tiles, written by st.shared, to wgmma
  __syncthreads();

  float acc_dq[32], acc_dk[32], acc_dv[32];
  wgmma_fence();
  const uint64_t chunk = cc * kDescTile;  // the tile of columns 64 cc ..
  gemm_tile_ss<0, 1>(acc_dq, desc_ds, desc_k + chunk);   // dq = dS K
  gemm_tile_ss<1, 1>(acc_dk, desc_ds, desc_q + chunk);   // dk = dS^T Q
  gemm_tile_ss<1, 1>(acc_dv, desc_p, desc_do + chunk);   // dv = P^T dO
  if constexpr (kF32) {  // + A_hi B_lo + A_lo B_hi (A's lo tile one tile after its hi)
    gemm_tile_ss<0, 1, true>(acc_dq, desc_ds, desc_k + kLo + chunk);
    gemm_tile_ss<0, 1, true>(acc_dq, desc_ds + kDescTile, desc_k + chunk);
    gemm_tile_ss<1, 1, true>(acc_dk, desc_ds, desc_q + kLo + chunk);
    gemm_tile_ss<1, 1, true>(acc_dk, desc_ds + kDescTile, desc_q + chunk);
    gemm_tile_ss<1, 1, true>(acc_dv, desc_p, desc_do + kLo + chunk);
    gemm_tile_ss<1, 1, true>(acc_dv, desc_p + kDescTile, desc_do + chunk);
  }
  wgmma_commit();
  if (dbias_p) store_f32(dbias_p, sBias, 0, 0, T, a.dbias16, tid);
  wgmma_wait<0>();
  fence_regs(acc_dq);
  fence_regs(acc_dk);
  fence_regs(acc_dv);

  const long long out_head = b * a.out_stride_b + h * D;
  const int cols = NC == 1 ? kRowElems : D;  // D 64: every column, known at compile time
  store_rows(dq + out_head, a.out_stride_t, acc_dq, r0, T, a.sm_scale, i4, 64 * cc, cols);
  store_rows(dk + out_head, a.out_stride_t, acc_dk, r0, T, a.sm_scale, i4, 64 * cc, cols);
  store_rows(dv + out_head, a.out_stride_t, acc_dv, r0, T, 1.f, i4, 64 * cc, cols);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

int check_args(int B, int H, int T, int D, long long stride_b, long long stride_t,
               long long out_stride_b, long long out_stride_t, const void* q, const void* k,
               const void* v, const void* dout) {
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      stride_b % 8 != 0 || stride_t % 8 != 0 || out_stride_b % 8 != 0 || out_stride_t % 8 != 0 ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

BiasBwdArgs make_args(long long stride_b, long long stride_t, long long out_stride_b,
                      long long out_stride_t, const void* bias, int bias_uniform,
                      const void* dbias, int H, int T, int D, float sm_scale, int seed,
                      unsigned int thresh, float keep_scale) {
  const long long bias_stride_b = bias_uniform ? 0 : static_cast<long long>(H) * T * T;
  return BiasBwdArgs{stride_b,      stride_t, out_stride_b, out_stride_t,
                     bias_stride_b, H,        T,            D,            sm_scale,
                     T % 4 == 0 && !misaligned(bias), T % 4 == 0 && !misaligned(dbias),
                     static_cast<uint32_t>(seed), thresh, keep_scale};
}

// Launch kKernel with its dynamic shared memory, the limit above 48 KB
// raised once per process and instance.
template <auto kKernel, int kSmem, typename... Args>
int launch_one(dim3 grid, cudaStream_t s, Args... args) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kKernel<<<grid, kThreads, kSmem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The instance of each kernel for a head of NC tiles and element type E,
// with a bias or without.
template <int NC, typename E, typename... Args>
int launch_dq(bool has_bias, dim3 grid, cudaStream_t s, Args... args) {
  constexpr int P = std::is_same<E, float>::value ? 2 : 1;
  return has_bias ? launch_one<bias_attention_dq_kernel<NC, true, E>, dq_smem(NC, true, P)>(
                        grid, s, args...)
                  : launch_one<bias_attention_dq_kernel<NC, false, E>, dq_smem(NC, false, P)>(
                        grid, s, args...);
}
template <int NC, typename E, typename... Args>
int launch_dkv(bool has_bias, dim3 grid, cudaStream_t s, Args... args) {
  constexpr int P = std::is_same<E, float>::value ? 2 : 1;
  return has_bias ? launch_one<bias_attention_dkv_kernel<NC, true, E>, dkv_smem(NC, true, P)>(
                        grid, s, args...)
                  : launch_one<bias_attention_dkv_kernel<NC, false, E>, dkv_smem(NC, false, P)>(
                        grid, s, args...);
}
template <int NC, typename E, typename... Args>
int launch_single(bool has_bias, dim3 grid, cudaStream_t s, Args... args) {
  constexpr int P = std::is_same<E, float>::value ? 2 : 1;
  return has_bias ? launch_one<bias_attention_bwd_single_kernel<NC, true, E>,
                               single_smem(NC, true, P)>(grid, s, args...)
                  : launch_one<bias_attention_bwd_single_kernel<NC, false, E>,
                               single_smem(NC, false, P)>(grid, s, args...);
}

// The entries' bodies for q, k, v, dout and the gradients of element type
// E. Each returns a cudaError_t.
template <typename E>
int dq_entry(const void* q, const void* k, const void* v, long long stride_b, long long stride_t,
             const void* dout, const void* lse, const void* delta, const void* bias,
             int bias_uniform, const void* mask, void* dq, long long out_stride_b,
             long long out_stride_t, void* dbias, int B, int H, int T, int D, float sm_scale,
             int seed, unsigned int thresh, float keep_scale, void* stream) {
  if (int err = check_args(B, H, T, D, stride_b, stride_t, out_stride_b, out_stride_t, q, k, v,
                           dout))
    return err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const E*>(q);
  const auto* kp = static_cast<const E*>(k);
  const auto* vp = static_cast<const E*>(v);
  const auto* dop = static_cast<const E*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* bp = static_cast<const float*>(bias);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* dqp = static_cast<E*>(dq);
  auto* dbp = static_cast<float*>(dbias);
  const BiasBwdArgs a = make_args(stride_b, stride_t, out_stride_b, out_stride_t, bias,
                                  bias_uniform, dbias, H, T, D, sm_scale, seed, thresh,
                                  keep_scale);
  if (D == 64)
    return launch_dq<1, E>(bp != nullptr, grid, s, qp, kp, vp, dop, lp, dl, bp, mp, dqp, dbp, a);
  return launch_dq<2, E>(bp != nullptr, grid, s, qp, kp, vp, dop, lp, dl, bp, mp, dqp, dbp, a);
}

template <typename E>
int dkv_entry(const void* q, const void* k, const void* v, long long stride_b,
              long long stride_t, const void* dout, const void* lse, const void* delta,
              const void* bias, int bias_uniform, const void* mask, void* dk, void* dv,
              long long out_stride_b, long long out_stride_t, int B, int H, int T, int D,
              float sm_scale, int seed, unsigned int thresh, float keep_scale, void* stream) {
  if (int err = check_args(B, H, T, D, stride_b, stride_t, out_stride_b, out_stride_t, q, k, v,
                           dout))
    return err;
  const int nc = D == 64 ? 1 : 2;
  // one block per key tile and 64-column chunk of dk and dv
  const dim3 grid((T + kTile - 1) / kTile * nc, H, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const E*>(q);
  const auto* kp = static_cast<const E*>(k);
  const auto* vp = static_cast<const E*>(v);
  const auto* dop = static_cast<const E*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* bp = static_cast<const float*>(bias);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* dkp = static_cast<E*>(dk);
  auto* dvp = static_cast<E*>(dv);
  const BiasBwdArgs a = make_args(stride_b, stride_t, out_stride_b, out_stride_t, bias,
                                  bias_uniform, nullptr, H, T, D, sm_scale, seed, thresh,
                                  keep_scale);
  if (nc == 1)
    return launch_dkv<1, E>(bp != nullptr, grid, s, qp, kp, vp, dop, lp, dl, bp, mp, dkp, dvp, a);
  return launch_dkv<2, E>(bp != nullptr, grid, s, qp, kp, vp, dop, lp, dl, bp, mp, dkp, dvp, a);
}

template <typename E>
int single_entry(const void* q, const void* k, const void* v, long long stride_b,
                 long long stride_t, const void* dout, const void* lse, const void* delta,
                 const void* bias, int bias_uniform, const void* mask, void* dq, void* dk,
                 void* dv, long long out_stride_b, long long out_stride_t, void* dbias, int B,
                 int H, int T, int D, float sm_scale, int seed, unsigned int thresh,
                 float keep_scale, void* stream) {
  if (int err = check_args(B, H, T, D, stride_b, stride_t, out_stride_b, out_stride_t, q, k, v,
                           dout))
    return err;
  if (T > kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = D == 64 ? 1 : 2;
  const dim3 grid(H, B, nc);  // one block per head, batch row and 64-column chunk
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const E*>(q);
  const auto* kp = static_cast<const E*>(k);
  const auto* vp = static_cast<const E*>(v);
  const auto* dop = static_cast<const E*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* bp = static_cast<const float*>(bias);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* dqp = static_cast<E*>(dq);
  auto* dkp = static_cast<E*>(dk);
  auto* dvp = static_cast<E*>(dv);
  auto* dbp = static_cast<float*>(dbias);
  const BiasBwdArgs a = make_args(stride_b, stride_t, out_stride_b, out_stride_t, bias,
                                  bias_uniform, dbias, H, T, D, sm_scale, seed, thresh,
                                  keep_scale);
  if (nc == 1)
    return launch_single<1, E>(bp != nullptr, grid, s, qp, kp, vp, dop, lp, dl, bp, mp, dqp, dkp,
                               dvp, dbp, a);
  return launch_single<2, E>(bp != nullptr, grid, s, qp, kp, vp, dop, lp, dl, bp, mp, dqp, dkp,
                             dvp, dbp, a);
}

}  // namespace
}  // namespace a2v

// C entries, bound with ctypes. D: a multiple of 8 up to 128 (the wrapper
// pads other head dims with zero columns). q, k, v: (B, T, H, D) with
// element strides (stride_b, stride_t, D, 1), 16-byte aligned, strides
// multiples of 8; dout (B, T, H, D) contiguous; all bf16 (the _f32 entries:
// fp32); lse and delta (B*H, T) fp32; bias null or fp32 (bias_uniform ? 1 :
// B, H, T, T) contiguous; mask null or (B, T) uint8. dq, dk, dv are (B, T,
// H, D) in q's type with element strides (out_stride_b, out_stride_t, D, 1)
// (the three planes of one (B, T, 3, H, D) gradient); dbias null or fp32
// (B, H, T, T) contiguous (written only with a bias); thresh 0 = no
// dropout, else the forward's hash dropout (seed, thresh, keep_scale as
// a2v_bias_attention takes them). Each returns a cudaError_t.
extern "C" int a2v_bias_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         long long stride_b, long long stride_t,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* bias, int bias_uniform, const void* mask,
                                         void* dq, long long out_stride_b, long long out_stride_t,
                                         void* dbias, int B, int H, int T, int D, float sm_scale,
                                         int seed, unsigned int thresh, float keep_scale,
                                         void* stream) {
  return a2v::dq_entry<__nv_bfloat16>(q, k, v, stride_b, stride_t, dout, lse, delta, bias,
                                      bias_uniform, mask, dq, out_stride_b, out_stride_t, dbias,
                                      B, H, T, D, sm_scale, seed, thresh, keep_scale, stream);
}

extern "C" int a2v_bias_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                             long long stride_b, long long stride_t,
                                             const void* dout, const void* lse,
                                             const void* delta, const void* bias,
                                             int bias_uniform, const void* mask, void* dq,
                                             long long out_stride_b, long long out_stride_t,
                                             void* dbias, int B, int H, int T, int D,
                                             float sm_scale, int seed, unsigned int thresh,
                                             float keep_scale, void* stream) {
  return a2v::dq_entry<float>(q, k, v, stride_b, stride_t, dout, lse, delta, bias, bias_uniform,
                              mask, dq, out_stride_b, out_stride_t, dbias, B, H, T, D, sm_scale,
                              seed, thresh, keep_scale, stream);
}

extern "C" int a2v_bias_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          long long stride_b, long long stride_t,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* bias, int bias_uniform, const void* mask,
                                          void* dk, void* dv, long long out_stride_b,
                                          long long out_stride_t, int B, int H, int T, int D,
                                          float sm_scale, int seed, unsigned int thresh,
                                          float keep_scale, void* stream) {
  return a2v::dkv_entry<__nv_bfloat16>(q, k, v, stride_b, stride_t, dout, lse, delta, bias,
                                       bias_uniform, mask, dk, dv, out_stride_b, out_stride_t, B,
                                       H, T, D, sm_scale, seed, thresh, keep_scale, stream);
}

extern "C" int a2v_bias_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                              long long stride_b, long long stride_t,
                                              const void* dout, const void* lse,
                                              const void* delta, const void* bias,
                                              int bias_uniform, const void* mask, void* dk,
                                              void* dv, long long out_stride_b,
                                              long long out_stride_t, int B, int H, int T, int D,
                                              float sm_scale, int seed, unsigned int thresh,
                                              float keep_scale, void* stream) {
  return a2v::dkv_entry<float>(q, k, v, stride_b, stride_t, dout, lse, delta, bias, bias_uniform,
                               mask, dk, dv, out_stride_b, out_stride_t, B, H, T, D, sm_scale,
                               seed, thresh, keep_scale, stream);
}

// As the two entries above in one launch, for T <= 64.
extern "C" int a2v_bias_attention_bwd_single(const void* q, const void* k, const void* v,
                                             long long stride_b, long long stride_t,
                                             const void* dout, const void* lse, const void* delta,
                                             const void* bias, int bias_uniform, const void* mask,
                                             void* dq, void* dk, void* dv, long long out_stride_b,
                                             long long out_stride_t, void* dbias, int B, int H,
                                             int T, int D, float sm_scale, int seed,
                                             unsigned int thresh, float keep_scale,
                                             void* stream) {
  return a2v::single_entry<__nv_bfloat16>(q, k, v, stride_b, stride_t, dout, lse, delta, bias,
                                          bias_uniform, mask, dq, dk, dv, out_stride_b,
                                          out_stride_t, dbias, B, H, T, D, sm_scale, seed,
                                          thresh, keep_scale, stream);
}

extern "C" int a2v_bias_attention_bwd_single_f32(
    const void* q, const void* k, const void* v, long long stride_b, long long stride_t,
    const void* dout, const void* lse, const void* delta, const void* bias, int bias_uniform,
    const void* mask, void* dq, void* dk, void* dv, long long out_stride_b,
    long long out_stride_t, void* dbias, int B, int H, int T, int D, float sm_scale, int seed,
    unsigned int thresh, float keep_scale, void* stream) {
  return a2v::single_entry<float>(q, k, v, stride_b, stride_t, dout, lse, delta, bias,
                                  bias_uniform, mask, dq, dk, dv, out_stride_b, out_stride_t,
                                  dbias, B, H, T, D, sm_scale, seed, thresh, keep_scale, stream);
}
