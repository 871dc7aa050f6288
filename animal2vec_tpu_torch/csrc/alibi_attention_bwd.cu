// ALiBi flash-attention backward, bf16 or fp32 in and out, head dims D <=
// 128 (a multiple of 8): two kernels.
//
// Replaces the TPU kernels animal2vec_tpu/ops/pallas_attention.py:
//   _bwd_dq_kernel  -> alibi_attention_dq_kernel: dq and the per-(b, h,
//                      query tile) partial of the slope gradient;
//   _bwd_dkv_kernel -> alibi_attention_dkv_kernel: dk and dv.
//
// With s = q.k / sqrt(D) + bias, P = exp(s - lse) (lse from the forward),
// f = keep / (1 - r) the forward's dropout factor (regenerated from the hash
// of (seed + (b*H+h) * 0xC2B2AE3D, query, key), with b * hash_heads + h0 +
// h in place of b*H+h for a tensor-parallel rank's heads, as the forward
// hashes them), dP = dO . V^T and
// delta = rowsum(dO * O) (computed outside, one torch op):
//   dS     = P * (dP * f - delta)
//   dq     = scale * dS . K
//   dk     = scale * dS^T . Q
//   dv     = (P * f)^T . dO
//   dslope = -sum dS * dist,  dist = |pos_q - pos_k| (0 at sentinel positions)
// The slope gradient is summed per query row as -(sum_j P f dP dist -
// D * sum_j P dist) with D = sum_j P f dP, the row's delta accumulated in
// fp32 from the kernel's own P and dP. That is the same sum with an exact
// delta: the delta passed in comes from the bf16 output, and its rounding
// (~1e-3 relative) times distances of up to T moved single heads' slope
// gradients by tens of percent against fp32 autograd at B = 4, H = 16,
// T = 2000 on an H100; with D the relative norm over heads is ~4e-6
// (chip_smoke.py phase 3b).
// dq and dk use the delta passed in, as the TPU kernels do; there its
// rounding is not multiplied by a distance.
// Masked keys score a constant -1e9, so their dS is 0. A query row whose
// keys are all padded (lse rounds to -1e9) gets P = 1/T over the keys < T,
// the uniform weights its forward averaged V with; the TPU kernel instead
// evaluates exp(-1e9 - lse) = 1 there and passes dS of the masked scores to
// dq, dk and the slopes. Keys and queries past T are dropped by bounds.
//
// Bound on the H100 at the training shape (B=4, H=16, T=2000): the dq kernel
// does 3 products of 2*T^2*D per (b, h), 6*B*H*T^2*D = 98 GFLOP (0.10 ms at
// the 989 TFLOP/s bf16 peak); the dk/dv kernel 4 products, 131 GFLOP
// (0.13 ms); each reads q, k, v, dO (4 x 16 MB) and writes 16 or 32 MB, a
// few microseconds at 3.35 TB/s. Both are bound by operations. Besides the
// products each recomputes, for each of the B*H*T^2 = 256 M scores, the
// bias, the exponential and (with dropout) the hash: the dq loop compiles
// to ~1080 instructions a thread per 64-key tile (32 scores), ~34 a score
// with the hash's ~10, which at 4 warp-instructions per SM and clock is
// ~0.3 ms a kernel, more than the products' bound: the scalar pass, not the
// tensor cores, sets the pace (dropout 0 runs 12-20 % faster).
//
// Design (Hopper, sm_90a): one warpgroup (128 threads) per block owns 64
// rows (queries for dq, keys for dk/dv), wgmma's M, and loops over the
// other side's 64-row tiles. All five products are wgmma m64n64k16 with
// fp32 accumulation (sm90.cuh):
//   dq kernel:   S = Q K^T, dP = dO V^T        (SS: both tiles in shared)
//                dq += dS K                    (RS: dS from registers, K MN-major)
//   dk/dv:       S^T = K Q^T, dP^T = V dO^T    (SS)
//                dv += (P f)^T dO, dk += dS^T Q (RS, B MN-major)
// The accumulator of S (S^T) and dP (dP^T) holds P and dS after the scalar
// pass, and its bf16 is the register A operand of the next product, so
// nothing is staged through shared memory between products. Every tile
// lives in shared memory in the 128-byte swizzle, 1024-byte aligned, so
// that one descriptor reads it K-major for S and MN-major for the RS
// products. The streamed pair (K, V for dq; Q, dO for dk/dv) comes through
// a ring of kStages buffers filled by cp.async: the copies of tile t +
// kStages - 1 are in flight while tile t's products and scalar pass run
// (the wait is cp.async.wait_group kStages - 2). Two stages: one tile's
// compute (~1000 instructions a thread) outlasts the next tile's copy, and
// a build with a third stage (17 KB more shared memory a block) ran both
// kernels slower on an H100 at every shape of chip_smoke.py phase 7.
// The pair's side data (key positions, sentinel factors and mask bias for
// dq; lse, delta, positions for dk/dv) is loaded into registers when its
// tile's copy is issued and written into its ring slot after the tile in
// hand is done, so its latency hides too. The blocks of an SM (3 for dq at
// 168 registers, 2 for dk/dv at up to 222, set by registers) overlap one
// block's scalar pass with another's products. One warpgroup a block, not
// two sharing each staged tile: 256 threads at those register counts fit
// one block an SM, so the blocks could no longer overlap one another, and
// the tile traffic that sharing would halve already hides behind the
// scalar pass. S and dP read A (Q, dO; K, V) from shared memory: a build
// holding it in registers (RS) ran a few percent faster at the training
// shape but spilled dq at 3 blocks an SM.
// Head dims: as in the forward (alibi_attention_fwd.cu) a head's row is NC
// = 1 (D 64) or 2 (any other D up to 128) tiles of 64 columns, zero past D;
// S and dP sum NC tile products. The dq kernel keeps NC dq accumulators
// (two blocks an SM at NC = 2). The dk/dv kernel, already at 188-215
// registers with one dk and one dv accumulator, does not double them: at
// NC = 2 each block writes the 64 columns (cc) of dk and dv that its index
// names and recomputes S^T and dP^T over the whole head, twice the scalar
// pass for the same register budget. D = 64 runs the NC = 1 instances,
// unchanged.
// fp32 (the E = float instances, the _f32 entries): every staged head is a
// hi and a lo bf16 tile (sm90.cuh stage_head_split), and each of the five
// products is three bf16 products into one fp32 accumulator (hi.hi + hi.lo
// + lo.hi; dS and P f split in registers for the RS products), as in the
// forward; shared memory doubles (up to 200 KB at NC = 2) and dq, dk, dv
// are written in fp32. The dq kernel at NC = 2 holds its two accumulators
// and the split dS fragments at the 255-register limit (ptxas spills 12-36
// bytes there).
// Both kernels are deterministic and use no atomics: the slope gradient is
// reduced inside each block (quad shuffles for the row sums, then warp
// shuffles and shared memory) to one fp32 partial per (b, h, query tile),
// and torch sums the partials.
// The scalar pass rebuilds P as the reference (pallas_attention.py:362 and
// :421) and the plain version do: expf(logit - lse) in natural units, the
// logit rounded as the forward (#2's training instances) rounds it,
// fmaf(q.k, scale, -(slope * dist)), then the lse taken off in one fp32
// subtraction. An ex2 of a log2-scaled argument (log2(e) folded into the
// scale, the slope and -lse) rounds a few P f near 1 to bf16 the other way
// than the plain version's exp does; times a |dO| of ~2 plus the output's
// own rounding that is two output ulps, where chip_smoke.py's dk/dv check
// allows one, so one-ulp moves of the lse failed that check at both of its
// shapes (tools/bwd_check_margin.py; PERF.md). expf costs a range
// reduction beside ex2.approx, a few instructions a score. Dropout and
// sentinels are template flags, so a run without them pays neither.
#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTile = 64;      // rows per block and per loop step
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // ring depth of the streamed pair (see the note above)
constexpr float kDeadLse = -5e8f;  // lse below this: every key of the row padded
constexpr int kTileBytes = kTileElems * 2;

// dynamic shared memory: the block's two heads, the ring of pairs (each
// head twice, hi and lo, in the fp32 instances: P = 2), the ring's side
// data, and slack to align the base to 1024 bytes
template <int NC, int P>
constexpr int kDqSmem =
    NC * P * (2 + kStages * 2) * kTileBytes + kStages * kTile * 16 + kTileAlign;
template <int NC, int P>
constexpr int kDkvSmem =
    NC * P * (2 + kStages * 2) * kTileBytes + kStages * kTile * 20 + kTileAlign;

struct BwdArgs {
  int pos_per_row, mask_per_row, has_sentinel;
  int B, H, T, D;
  float sm_scale;
  uint32_t seed;     // dropout seed (int32 bits)
  uint32_t thresh;   // keep when hash >= thresh; 0 = no dropout
  float keep_scale;  // 1 / (1 - rate)
  int h0, hash_heads;  // the dropout hash's head index b * hash_heads + h0 + h
};

// One block per (64-query tile, head, batch): dq rows and the block's
// slope-gradient partial.
template <int NC, bool kDrop, bool kSentinel, typename E>
__global__ void __launch_bounds__(kThreads, NC == 1 && std::is_same<E, bf16>::value ? 3 : 2)
alibi_attention_dq_kernel(const E* __restrict__ qkv,        // (3, B, H, T, D)
                          const E* __restrict__ dout,       // (B, H, T, D)
                          const float* __restrict__ lse,    // (B*H, T)
                          const float* __restrict__ delta,  // (B*H, T)
                          const float* __restrict__ slopes, // (H,)
                          const int* __restrict__ pos,      // (1 or B, T)
                          const uint8_t* __restrict__ mask, // null or (1 or B, T)
                          E* __restrict__ dq,               // (B, H, T, D)
                          float* __restrict__ dslope_part,  // (B, H, n_qtiles)
                          BwdArgs a) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;  // a staged head: hi (and lo) tiles
  constexpr uint64_t kLo = NC * kDescTile;  // a staged head's lo tiles
  extern __shared__ uint8_t smem_raw[];
  __shared__ float sRed[kThreads / 32];
  constexpr int kHead = NC * kTileElems * kPlanes;  // a head's 64 rows, staged
  bf16* const sQ = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* const sDO = sQ + kHead;
  bf16* const sRing = sDO + kHead;  // stage s: K at 2s heads in, V after it
  // per key of each stage: {position, sentinel factor (0 or 1), bias (0 or
  // -inf: padded or past T), unused}
  float4* const sKey = reinterpret_cast<float4*>(sRing + kStages * 2 * kHead);

  const int T = a.T, H = a.H;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int D = a.D;
  const size_t head = static_cast<size_t>(T) * D;
  const size_t plane = static_cast<size_t>(a.B) * H * head;
  const E* q = qkv + bh * head;
  const E* k = q + plane;
  const E* v = k + plane;
  const int* posr = pos + (a.pos_per_row ? static_cast<size_t>(b) * T : 0);
  const uint8_t* maskr = mask ? mask + (a.mask_per_row ? static_cast<size_t>(b) * T : 0) : nullptr;
  const uint32_t seed_mix = drop_seed_mix(
      a.seed + (static_cast<uint32_t>(b) * a.hash_heads + a.h0 + h) * 0xC2B2AE3Du);
  const int n_tiles = (T + kTile - 1) / kTile;
  const uint64_t desc_q = desc_sw128(sQ), desc_do = desc_sw128(sDO);
  const uint64_t desc_ring = desc_sw128(sRing);

  auto stage_pair = [&](int kt) {
    bf16* dst = sRing + (kt % kStages) * 2 * kHead;
    stage_head_of<kThreads, NC>(dst, k, D, kt * kTile, T, D, tid);
    stage_head_of<kThreads, NC>(dst + kHead, v, D, kt * kTile, T, D, tid);
  };
  // threads < 64 read key kt*64 + tid's position and mask flag ...
  auto load_key = [&](int kt, int& p, int& m) {
    const int key = kt * kTile + tid;
    p = key < T ? posr[key] : 0;
    m = key >= T || (maskr && maskr[key]);
  };
  // ... and write its side data into the tile's ring slot
  auto store_key = [&](int kt, int p, int m) {
    sKey[(kt % kStages) * kTile + tid] =
        make_float4(static_cast<float>(p), (kSentinel && p < 0) ? 0.f : 1.f,
                    m ? -INFINITY : 0.f, 0.f);
  };

  // prologue: Q, dO and the first kStages - 1 pairs, one commit group each
  stage_head_of<kThreads, NC>(sQ, q, D, q0, T, D, tid);
  stage_head_of<kThreads, NC>(sDO, dout + bh * head, D, q0, T, D, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage_pair(s);
    cp_async_commit();
  }
  if (tid < kTile) {
    for (int s = 0; s < kStages - 1 && s < n_tiles; ++s) {
      int p, m;
      load_key(s, p, m);
      store_key(s, p, m);
    }
  }

  // this thread's rows q0 + 16 warp + g + 8r. The logit is rounded as the
  // forward kernel and the plain version round it (the bias -slope dist to
  // fp32, then its sum with q.k / sqrt(D)) and lse is taken off after, in
  // natural units: the slope partial -(sum P f dP dist - D sum P dist) is
  // quadratic in the scale of a row's P, and D sum P dist reaches ~4e3 in
  // rows whose near keys are padded, so a rounding shared by the row's few
  // weighty keys (log2(e) folded into -lse and the slope, or -slope dist -
  // lse summed first) moved partials by 3e-2 to 9e-2 on an H100.
  const float slope = slopes[h];
  float pq[2], nl[2], dl[2], sl[2], rmul[2];
  uint32_t zrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool in = row < T;
    const int p = in ? posr[row] : 0;
    pq[r] = static_cast<float>(p);
    rmul[r] = (kSentinel && p < 0) ? 0.f : 1.f;
    sl[r] = slope * rmul[r];
    // a row past T weighs every key 0
    nl[r] = in ? -lse[bh * T + row] : -INFINITY;
    dl[r] = in ? delta[bh * T + row] : 0.f;
    zrow[r] = static_cast<uint32_t>(row) * kHashRow;
  }

  float acc_dq[NC][32], sc[32], dp[32];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dq[n][i] = 0.f;
  }
  // per-row sums over this thread's keys for the slope gradient:
  // sum P f dP dist, sum P dist and sum P f dP (the in-kernel delta), with
  // dist short of the row's sentinel factor; fp32: also sum P, by which the
  // row's sums are normalized (below)
  float a_pd[2] = {0.f, 0.f}, b_pd[2] = {0.f, 0.f}, d_pd[2] = {0.f, 0.f};
  float s_pd[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
    fence_proxy_async();
    __syncthreads();  // tile kt visible to all; every thread is done with tile kt - 1
    const int nt = kt + kStages - 1;
    int np = 0, nm = 0;
    if (nt < n_tiles) {
      stage_pair(nt);  // into the slot tile kt - 1 used
      if (tid < kTile) load_key(nt, np, nm);
    }
    cp_async_commit();

    const uint64_t desc_k = desc_ring + (kt % kStages) * 2 * NC * kPlanes * kDescTile;
    wgmma_fence();
    gemm_head_ss_of<NC, kF32>(sc, desc_q, desc_k);                          // S = Q K^T
    wgmma_commit();
    gemm_head_ss_of<NC, kF32>(dp, desc_do, desc_k + NC * kPlanes * kDescTile);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const float4* key = sKey + (kt % kStages) * kTile;
    const uint32_t zt = static_cast<uint32_t>(kt * kTile + 2 * i4) * kHashCol;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 kd = key[8 * j + 2 * i4 + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float dist = fabsf(pq[r] - kd.x);
          if (kSentinel) dist *= kd.y;
          const float logit = fmaf(sc[i], a.sm_scale, -__fmul_rn(sl[r], dist));
          const float p = expf(logit + (nl[r] + kd.z));
          float dpv = dp[i];
          if (kDrop) {
            const uint32_t z = zrow[r] + zt + static_cast<uint32_t>(8 * j + e) * kHashCol;
            dpv = drop_mix_seeded(seed_mix, z) >= a.thresh ? dpv * a.keep_scale : 0.f;
          }
          const float pdp = p * dpv;  // p is 0 unless the key is live
          a_pd[r] = fmaf(pdp, dist, a_pd[r]);
          b_pd[r] = fmaf(p, dist, b_pd[r]);
          d_pd[r] += pdp;
          if constexpr (kF32) s_pd[r] += p;
          sc[i] = fmaf(-p, dl[r], pdp);  // dS
        }
      }
    }
    // dq += dS K; fp32: dS_hi K_hi + dS_hi K_lo + dS_lo K_hi
    uint32_t fds[4][4], fdl[4][4];
    if constexpr (kF32)
      frag_split_from_acc(fds, fdl, sc);
    else
      frag_from_acc(fds, sc);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      fence_regs(acc_dq[n]);
      gemm_frag_tile(acc_dq[n], fds, desc_k + n * kDescTile);
      if constexpr (kF32) {
        gemm_frag_tile(acc_dq[n], fds, desc_k + kLo + n * kDescTile);
        gemm_frag_tile(acc_dq[n], fdl, desc_k + n * kDescTile);
      }
    }
    wgmma_commit();
    if (nt < n_tiles && tid < kTile) store_key(nt, np, nm);
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NC; ++n) fence_regs(acc_dq[n]);
    fence_regs(fds);
    if constexpr (kF32) fence_regs(fdl);
  }

  // dq rows, scaled, in E
  E* dqr = dq + bh * head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < T) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * n + 8 * j;
          if (NC == 1 || col < D)
            store_pair(&dqr[static_cast<size_t>(row) * D + col + 2 * i4],
                       acc_dq[n][4 * j + 2 * r] * a.sm_scale,
                       acc_dq[n][4 * j + 2 * r + 1] * a.sm_scale);
        }
      }
    }
  }

  // row totals over the quad of lanes that share a row, then
  // -sum_j dS dist = -(sum P f dP dist - D * sum P dist) per row. fp32:
  // with P divided by its row sum S, -(a - d b / S) / S. Each fp32 P
  // carries its row's rounding of lse and of logits far from 0 (an ALiBi
  // row whose near keys are padded scores its keys near -slope * 300), a
  // relative error common to the row that the cancelling difference
  // multiplies by D sum P dist (~2400 there): against a float64 reference
  // the un-normalized partials of the plain version in fp32 lay 1.6x the
  // bf16 gate away at b4 T 2000 (the CPU emulation of this arithmetic),
  // the normalized split ones 0.43x. The bf16 instances keep the
  // un-normalized sum, bit for bit as before.
  float dsl = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      a_pd[r] += __shfl_xor_sync(0xffffffffu, a_pd[r], off);
      b_pd[r] += __shfl_xor_sync(0xffffffffu, b_pd[r], off);
      d_pd[r] += __shfl_xor_sync(0xffffffffu, d_pd[r], off);
      if constexpr (kF32) s_pd[r] += __shfl_xor_sync(0xffffffffu, s_pd[r], off);
    }
    if (i4 == 0) {
      if constexpr (kF32) {
        const float inv = s_pd[r] > 0.f ? 1.f / s_pd[r] : 0.f;  // 0: no live key
        dsl -= rmul[r] * (a_pd[r] - d_pd[r] * b_pd[r] * inv) * inv;
      } else {
        dsl -= rmul[r] * (a_pd[r] - d_pd[r] * b_pd[r]);
      }
    }
  }
  dsl = warp_sum(dsl);
  if (lane == 0) sRed[warp] = dsl;
  __syncthreads();
  if (tid == 0)
    dslope_part[bh * gridDim.x + blockIdx.x] = sRed[0] + sRed[1] + sRed[2] + sRed[3];
}

// One block per (64-key tile and 64-column chunk, head, batch): dk and dv
// rows, their columns 64 cc .. 64 cc + 63.
template <int NC, bool kDrop, bool kSentinel, typename E>
__global__ void __launch_bounds__(kThreads, 2)
alibi_attention_dkv_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ slopes, const int* __restrict__ pos,
                           const uint8_t* __restrict__ mask,
                           E* __restrict__ dk,  // (B, H, T, D)
                           E* __restrict__ dv,  // (B, H, T, D)
                           BwdArgs a) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;  // a staged head: hi (and lo) tiles
  constexpr uint64_t kLo = NC * kDescTile;  // a staged head's lo tiles
  extern __shared__ uint8_t smem_raw[];
  constexpr int kHead = NC * kTileElems * kPlanes;  // a head's 64 rows, staged
  bf16* const sK = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* const sV = sK + kHead;
  bf16* const sRing = sV + kHead;  // stage s: Q at 2s heads in, dO after it
  // per query of each stage: {position, sentinel factor, -lse (-inf past
  // T), delta}, and the weight 1/T of a padded key in a row whose keys
  // are all padded (0 elsewhere)
  float4* const sQry = reinterpret_cast<float4*>(sRing + kStages * 2 * kHead);
  float* const sDead = reinterpret_cast<float*>(sQry + kStages * kTile);

  const int T = a.T, H = a.H;
  const int k0 = blockIdx.x / NC * kTile, cc = blockIdx.x % NC, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int D = a.D;
  const size_t head = static_cast<size_t>(T) * D;
  const size_t plane = static_cast<size_t>(a.B) * H * head;
  const E* q = qkv + bh * head;
  const E* k = q + plane;
  const E* v = k + plane;
  const E* dor = dout + bh * head;
  const int* posr = pos + (a.pos_per_row ? static_cast<size_t>(b) * T : 0);
  const uint8_t* maskr = mask ? mask + (a.mask_per_row ? static_cast<size_t>(b) * T : 0) : nullptr;
  const uint32_t seed_mix = drop_seed_mix(
      a.seed + (static_cast<uint32_t>(b) * a.hash_heads + a.h0 + h) * 0xC2B2AE3Du);
  const float inv_t = 1.f / T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const uint64_t desc_k = desc_sw128(sK), desc_v = desc_sw128(sV);
  const uint64_t desc_ring = desc_sw128(sRing);

  auto stage_pair = [&](int qt) {
    bf16* dst = sRing + (qt % kStages) * 2 * kHead;
    stage_head_of<kThreads, NC>(dst, q, D, qt * kTile, T, D, tid);
    stage_head_of<kThreads, NC>(dst + kHead, dor, D, qt * kTile, T, D, tid);
  };
  // threads < 64 read query qt*64 + tid's position, lse and delta ...
  auto load_query = [&](int qt, int& p, float& l, float& dl) {
    const int row = qt * kTile + tid;
    const bool in = row < T;
    p = in ? posr[row] : 0;
    l = in ? lse[bh * T + row] : INFINITY;  // a query past T weighs every key 0
    dl = in ? delta[bh * T + row] : 0.f;
  };
  // ... and write its side data into the tile's ring slot
  auto store_query = [&](int qt, int p, float l, float dl) {
    const int slot = (qt % kStages) * kTile + tid;
    sQry[slot] = make_float4(static_cast<float>(p), (kSentinel && p < 0) ? 0.f : 1.f, -l, dl);
    sDead[slot] = l < kDeadLse ? inv_t : 0.f;
  };

  // prologue: K, V and the first kStages - 1 pairs, one commit group each
  stage_head_of<kThreads, NC>(sK, k, D, k0, T, D, tid);
  stage_head_of<kThreads, NC>(sV, v, D, k0, T, D, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage_pair(s);
    cp_async_commit();
  }
  if (tid < kTile) {
    for (int s = 0; s < kStages - 1 && s < n_tiles; ++s) {
      int p;
      float l, dl;
      load_query(s, p, l, dl);
      store_query(s, p, l, dl);
    }
  }

  // this thread's keys k0 + 16 warp + g + 8r (rows of S^T); the slope is
  // 0 at a sentinel key, as the dq kernel's is at a sentinel query
  const float slope = slopes[h];
  float pk[2], sl[2];
  bool kpad[2];  // a padded key: P = 1/T in rows of padded keys, dS = 0
  uint32_t zkey[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    const bool in = key < T;
    const int p = in ? posr[key] : 0;
    pk[r] = static_cast<float>(p);
    sl[r] = (kSentinel && p < 0) ? 0.f : slope;
    kpad[r] = in && maskr && maskr[key];
    zkey[r] = static_cast<uint32_t>(key) * kHashCol;
  }

  float acc_dk[32], acc_dv[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int qt = 0; qt < n_tiles; ++qt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile qt have landed
    fence_proxy_async();
    __syncthreads();  // tile qt visible to all; every thread is done with tile qt - 1
    const int nt = qt + kStages - 1;
    int np = 0;
    float nl = 0.f, nd = 0.f;
    if (nt < n_tiles) {
      stage_pair(nt);  // into the slot tile qt - 1 used
      if (tid < kTile) load_query(nt, np, nl, nd);
    }
    cp_async_commit();

    const uint64_t desc_q = desc_ring + (qt % kStages) * 2 * NC * kPlanes * kDescTile;
    const uint64_t desc_do = desc_q + NC * kPlanes * kDescTile;
    wgmma_fence();
    gemm_head_ss_of<NC, kF32>(st, desc_k, desc_q);    // S^T = K Q^T
    wgmma_commit();
    gemm_head_ss_of<NC, kF32>(dpt, desc_v, desc_do);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const float4* qry = sQry + (qt % kStages) * kTile;
    const float* dead = sDead + (qt % kStages) * kTile;
    const uint32_t zt = static_cast<uint32_t>(qt * kTile + 2 * i4) * kHashRow;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * i4 + e;
        const float4 qd = qry[col];
        const float pd = dead[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float dist = fabsf(qd.x - pk[r]);
          if (kSentinel) dist *= qd.y;
          // the logit rounded as the dq kernel rounds it, then - lse
          const float logit = fmaf(st[i], a.sm_scale, -__fmul_rn(sl[r], dist));
          float p = expf(logit + qd.z);
          float f = 1.f;
          if (kDrop) {
            const uint32_t z = zt + static_cast<uint32_t>(8 * j + e) * kHashRow + zkey[r];
            f = drop_mix_seeded(seed_mix, z) >= a.thresh ? a.keep_scale : 0.f;
          }
          float ds = p * fmaf(dpt[i], f, -qd.w);
          if (kpad[r]) {
            p = pd;
            ds = 0.f;
          }
          st[i] = p * f;
          dpt[i] = ds;
        }
      }
    }
    // dv += (P f)^T dO, dk += dS^T Q; fp32: each as the three products of
    // the A operand's hi and lo fragments with B's hi and lo tiles
    uint32_t fpf[4][4], fds[4][4], fpl[4][4], fdl[4][4];
    if constexpr (kF32) {
      frag_split_from_acc(fpf, fpl, st);
      frag_split_from_acc(fds, fdl, dpt);
    } else {
      frag_from_acc(fpf, st);
      frag_from_acc(fds, dpt);
    }
    wgmma_fence();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    gemm_frag_tile(acc_dv, fpf, desc_do + cc * kDescTile);
    gemm_frag_tile(acc_dk, fds, desc_q + cc * kDescTile);
    if constexpr (kF32) {
      gemm_frag_tile(acc_dv, fpf, desc_do + kLo + cc * kDescTile);
      gemm_frag_tile(acc_dv, fpl, desc_do + cc * kDescTile);
      gemm_frag_tile(acc_dk, fds, desc_q + kLo + cc * kDescTile);
      gemm_frag_tile(acc_dk, fdl, desc_q + cc * kDescTile);
    }
    wgmma_commit();
    if (nt < n_tiles && tid < kTile) store_query(nt, np, nl, nd);
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(fpf);
    fence_regs(fds);
    if constexpr (kF32) {
      fence_regs(fpl);
      fence_regs(fdl);
    }
  }

  E* dkr = dk + bh * head;
  E* dvr = dv + bh * head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key < T) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cc + 8 * j;
        if (NC == 2 && col >= D) continue;
        const size_t at = static_cast<size_t>(key) * D + col + 2 * i4;
        store_pair(&dkr[at], acc_dk[4 * j + 2 * r] * a.sm_scale,
                   acc_dk[4 * j + 2 * r + 1] * a.sm_scale);
        store_pair(&dvr[at], acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

int check_args(int B, int H, int T, int D, int h0, int hash_heads) {
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      h0 < 0 || hash_heads < h0 + H)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The dq entries' body for qkv, dout and dq of element type E. Returns a
// cudaError_t.
template <typename E>
int dq_entry(const void* qkv, const void* dout, const void* lse, const void* delta,
             const void* slopes, const void* pos, int pos_per_row, const void* mask,
             int mask_per_row, void* dq, void* dslope_part, int B, int H, int T, int D,
             int has_sentinel, float sm_scale, int seed, unsigned int thresh, float keep_scale,
             int h0, int hash_heads, void* stream) {
  if (int err = check_args(B, H, T, D, h0, hash_heads)) return err;
  constexpr int P = std::is_same<E, float>::value ? 2 : 1;
  const BwdArgs a{pos_per_row, mask_per_row, has_sentinel, B, H, T, D, sm_scale,
                  static_cast<uint32_t>(seed), thresh, keep_scale, h0, hash_heads};
  using Kernel = void (*)(const E*, const E*, const float*, const float*, const float*,
                          const int*, const uint8_t*, E*, float*, BwdArgs);
  const bool drop = thresh != 0u, sentinel = has_sentinel != 0;
  const bool wide = D != 64;
  const Kernel narrow_kernel =
      drop ? (sentinel ? alibi_attention_dq_kernel<1, true, true, E>
                       : alibi_attention_dq_kernel<1, true, false, E>)
           : (sentinel ? alibi_attention_dq_kernel<1, false, true, E>
                       : alibi_attention_dq_kernel<1, false, false, E>);
  const Kernel wide_kernel =
      drop ? (sentinel ? alibi_attention_dq_kernel<2, true, true, E>
                       : alibi_attention_dq_kernel<2, true, false, E>)
           : (sentinel ? alibi_attention_dq_kernel<2, false, true, E>
                       : alibi_attention_dq_kernel<2, false, false, E>);
  const Kernel kernel = wide ? wide_kernel : narrow_kernel;
  const int smem = wide ? kDqSmem<2, P> : kDqSmem<1, P>;
  if (cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return static_cast<int>(err);
  kernel<<<dim3((T + kTile - 1) / kTile, H, B), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(slopes), static_cast<const int*>(pos),
      static_cast<const uint8_t*>(mask), static_cast<E*>(dq),
      static_cast<float*>(dslope_part), a);
  return static_cast<int>(cudaGetLastError());
}

// The dk/dv entries' body for qkv, dout, dk and dv of element type E.
// Returns a cudaError_t.
template <typename E>
int dkv_entry(const void* qkv, const void* dout, const void* lse, const void* delta,
              const void* slopes, const void* pos, int pos_per_row, const void* mask,
              int mask_per_row, void* dk, void* dv, int B, int H, int T, int D,
              int has_sentinel, float sm_scale, int seed, unsigned int thresh, float keep_scale,
              int h0, int hash_heads, void* stream) {
  if (int err = check_args(B, H, T, D, h0, hash_heads)) return err;
  constexpr int P = std::is_same<E, float>::value ? 2 : 1;
  const BwdArgs a{pos_per_row, mask_per_row, has_sentinel, B, H, T, D, sm_scale,
                  static_cast<uint32_t>(seed), thresh, keep_scale, h0, hash_heads};
  using Kernel = void (*)(const E*, const E*, const float*, const float*, const float*,
                          const int*, const uint8_t*, E*, E*, BwdArgs);
  const bool drop = thresh != 0u, sentinel = has_sentinel != 0;
  const int nc = D == 64 ? 1 : 2;
  const Kernel narrow_kernel =
      drop ? (sentinel ? alibi_attention_dkv_kernel<1, true, true, E>
                       : alibi_attention_dkv_kernel<1, true, false, E>)
           : (sentinel ? alibi_attention_dkv_kernel<1, false, true, E>
                       : alibi_attention_dkv_kernel<1, false, false, E>);
  const Kernel wide_kernel =
      drop ? (sentinel ? alibi_attention_dkv_kernel<2, true, true, E>
                       : alibi_attention_dkv_kernel<2, true, false, E>)
           : (sentinel ? alibi_attention_dkv_kernel<2, false, true, E>
                       : alibi_attention_dkv_kernel<2, false, false, E>);
  const Kernel kernel = nc == 2 ? wide_kernel : narrow_kernel;
  const int smem = nc == 2 ? kDkvSmem<2, P> : kDkvSmem<1, P>;
  if (cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return static_cast<int>(err);
  // one block per key tile and 64-column chunk of dk and dv
  kernel<<<dim3((T + kTile - 1) / kTile * nc, H, B), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(slopes), static_cast<const int*>(pos),
      static_cast<const uint8_t*>(mask), static_cast<E*>(dk), static_cast<E*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace a2v

// C entries, bound with ctypes. D: a multiple of 8 up to 128 (the wrapper
// pads other head dims with zero columns). qkv (3, B, H, T, D) and dout
// (B, H, T, D) bf16 (the _f32 entries: fp32); lse and delta (B*H, T) fp32;
// positions (pos_per_row ? B : 1, T) int32; mask null or (mask_per_row ? B
// : 1, T) uint8. dq, dk, dv are (B, H, T, D) in qkv's type (planes of one
// (3, B, H, T, D) gradient); dslope_part is (B, H, ceil(T / 64)) fp32. Each
// returns a cudaError_t.
extern "C" int a2v_alibi_attention_bwd_dq(
    const void* qkv, const void* dout, const void* lse, const void* delta, const void* slopes,
    const void* pos, int pos_per_row, const void* mask, int mask_per_row, void* dq,
    void* dslope_part, int B, int H, int T, int D, int has_sentinel, float sm_scale, int seed,
    unsigned int thresh, float keep_scale, int h0, int hash_heads, void* stream) {
  return a2v::dq_entry<__nv_bfloat16>(qkv, dout, lse, delta, slopes, pos, pos_per_row, mask,
                          mask_per_row, dq, dslope_part, B, H, T, D, has_sentinel, sm_scale, seed,
                          thresh, keep_scale, h0, hash_heads, stream);
}

extern "C" int a2v_alibi_attention_bwd_dq_f32(
    const void* qkv, const void* dout, const void* lse, const void* delta, const void* slopes,
    const void* pos, int pos_per_row, const void* mask, int mask_per_row, void* dq,
    void* dslope_part, int B, int H, int T, int D, int has_sentinel, float sm_scale, int seed,
    unsigned int thresh, float keep_scale, int h0, int hash_heads, void* stream) {
  return a2v::dq_entry<float>(qkv, dout, lse, delta, slopes, pos, pos_per_row, mask,
                          mask_per_row, dq, dslope_part, B, H, T, D, has_sentinel, sm_scale, seed,
                          thresh, keep_scale, h0, hash_heads, stream);
}

extern "C" int a2v_alibi_attention_bwd_dkv(
    const void* qkv, const void* dout, const void* lse, const void* delta, const void* slopes,
    const void* pos, int pos_per_row, const void* mask, int mask_per_row, void* dk,
    void* dv, int B, int H, int T, int D, int has_sentinel, float sm_scale, int seed,
    unsigned int thresh, float keep_scale, int h0, int hash_heads, void* stream) {
  return a2v::dkv_entry<__nv_bfloat16>(qkv, dout, lse, delta, slopes, pos, pos_per_row, mask,
                          mask_per_row, dk, dv, B, H, T, D, has_sentinel, sm_scale, seed,
                          thresh, keep_scale, h0, hash_heads, stream);
}

extern "C" int a2v_alibi_attention_bwd_dkv_f32(
    const void* qkv, const void* dout, const void* lse, const void* delta, const void* slopes,
    const void* pos, int pos_per_row, const void* mask, int mask_per_row, void* dk,
    void* dv, int B, int H, int T, int D, int has_sentinel, float sm_scale, int seed,
    unsigned int thresh, float keep_scale, int h0, int hash_heads, void* stream) {
  return a2v::dkv_entry<float>(qkv, dout, lse, delta, slopes, pos, pos_per_row, mask,
                          mask_per_row, dk, dv, B, H, T, D, has_sentinel, sm_scale, seed,
                          thresh, keep_scale, h0, hash_heads, stream);
}
