// ALiBi flash-attention forward, bf16 or fp32 in and out, head dims D <= 128
// (a multiple of 8), on Hopper's wgmma: serving (no lse, no dropout) and
// training (the logsumexp residual of the backward and the in-kernel hash
// dropout), one kernel.
//
// Replaces the TPU kernels animal2vec_tpu/ops/pallas_attention.py:
// _kernel_serve_nk1 (batch-uniform positions, one key block) and _kernel
// (per-row positions, any number of key blocks, the lse and the dropout).
//
//   out[b,i,h] = sum_j keep_ij / (1 - r) * softmax_j(s_ij) . v_j
//   s_ij = q_i . k_j / sqrt(D) - slope_h * |pos_i - posk_j| (0 when either
//          position is < 0 and the sentinel rule is on), key j padded -> -1e9
//   posk = pos, or the keys' own positions (ring attention, whose key
//          blocks rotate past the queries: pallas_attention.py positions_k)
//   lse[b*H+h, i] = m_i + log(max(l_i, 1e-30))   (when an lse is asked for)
//
// As in the TPU kernel padded keys score a finite -1e9, so a query row
// whose keys are all padded averages V instead of producing NaN, and the
// denominator is clamped at 1e-30; keys past T have weight exactly 0.
// keep_ij is the counter hash of (seed + (b*H+h) * 0xC2B2AE3D, i, j) over
// global query and key indices (common.cuh drop_hash), so the backward
// kernels regenerate it; under tensor parallelism a rank holds H of the
// model's hash_heads heads from h0, and its (b, h) hashes as (b *
// hash_heads + h0 + h), the index of that head in the unsharded launch
// (JAX's bh_id, pallas_attention.py:82); as on the TPU the denominator l sums the undropped
// weights and the dropout scales the weights of P.V only.
//
// q, k and v are read in place: (B, T, H, D) views with one set of element
// strides (batch, head, token), a head's row 2D contiguous bytes. The
// model's serving call hands over the q, k, v thirds of its (B, T, 3, H, D)
// projection (token stride 3C) and takes out as (B, T, H, D), so neither
// the packed (3, B, H, T, D) copy of qkv nor the copy of the output back to
// (B, T, C) is made; training passes the planes of the packed copy the
// backward reads, the same views with token stride D.
//
// Bound on the H100 at the serving shape (B = 32, H = 16, T = 2000): the
// two products are 4 B H T^2 D = 0.52 TFLOP (0.53 ms at the 989 TFLOP/s
// bf16 peak) against 0.52 GB of q, k, v and out (0.16 ms at 3.35 TB/s):
// bound by operations. Beside them every score (2.05e9) takes one
// exponential on the special-function unit (16 a clock per SM: 0.53 ms
// alone) and about eight fp32 instructions (bias, scale, mask, max, sum);
// the dropout adds about ten integer instructions of hash a score. At the
// finetune shape (B = 4) the products are 0.066 TFLOP (0.066 ms), and
// training's accurate expf (a range reduction around its ex2) takes
// several instructions a score where serving's ex2 takes one.
//
// Design (sm_90a): a block of kWG warpgroups (128 threads each) owns
// kWG x 64 query rows of one (batch, head), each warpgroup 64 rows, wgmma's
// M, and walks the keys in tiles of 64 with an online softmax (running max
// and sum, fp32). The warpgroups share a ring of two key tiles in shared
// memory (128-byte swizzled K and V tiles staged by cp.async, csrc/sm90.cuh,
// and each key's position and mask entry): the copies of tile t + 1 are in
// flight while tile t's products and scalar pass run.
//   - S = Q K^T is an SS wgmma (m64n64k16, four k-steps over D) from the
//     warpgroup's swizzled Q tile and the K tile; O += P V an RS wgmma
//     whose A is the bf16 of S's accumulator after the scalar pass
//     (frag_from_acc), with V read MN-major: P never leaves registers.
//   - The bias is computed inline from the positions (|pos_i - pos_j|
//     times the slope, rounded to fp32 before its sum with the scaled
//     product), and a key's mask entry is +inf (live), -1e9 (padded) or
//     -inf (past T): a padded or absent key's score is replaced by its
//     entry. Without a padding mask only the last tile holds such keys, and
//     the others skip the test.
//   - The weights. Serving folds log2(e) into the score's scale and the
//     slope, so the scores, the running max m and the entries are in log2
//     units and each weight is one ex2(x - m). Training keeps the scores in
//     natural units and the arithmetic of the mma.sync kernel it replaces:
//     p = expf(x - m), lse = m + logf(l), out = O / l. Its outputs (out and
//     lse) are then bit for bit that kernel's, which matters to the
//     backward: #3/#4 rebuild P from this lse, and their checks against the
//     plain version flip at the level of one ulp of the lse (a weight P f
//     near 1 that rounds to bf16 the other way; PERF.md). One ex2 on a
//     folded exponent instead ran 0.342 against 0.421 ms at b4 on an H100
//     but changed a third of the lse values in their last bits. A row whose
//     keys are all padded weighs each of them expf(0) = 1: out is the mean
//     of V, lse -1e9 + log T, which rounds to -1e9 in fp32 as the plain
//     version's.
//   - The dropout (a template flag: serving instances compile without it)
//     multiplies p after l has summed it, before frag_from_acc; the seed's
//     part of the hash is mixed once per block, and the hash's input steps
//     through the tile as row kHashRow + column kHashCol.
//   - The running output is rescaled only when a row's max rose in the
//     tile (a vote per warp): along an ALiBi row the max stops rising once
//     the tile holding the row's own position has passed. In training a
//     warp whose weights in the tile are all below expf(-88) < 2^-126 (the
//     tile's row max bounds them; beside the row's max weight 1 they change
//     neither l nor O) skips the weights' pass, the exponentials and the
//     hash: along a steep head's row most keys.
//   - Every wgmma group is issued unconditionally: a product issued under
//     a branch (the last tile's k16 steps that hold no live key) made
//     ptxas fence and serialize each of them, which measured slower.
// Head dims: a head's row is NC = 1 (D 64) or 2 (any other D up to 128)
// swizzled tiles of 64 columns (sm90.cuh stage_head), columns past D
// zero-filled in shared memory, so S sums NC tile products and O is NC
// accumulators of 64 columns, each its own P V product; only columns < D
// are written, and the scale is the caller's, D^-0.5 of the true D. A D 80
// head runs the two-tile instance: 80/128 of its products are work (32/128
// at D 32). The NC = 2 instances hold 32 more accumulator registers a
// thread and run one block an SM. D = 64 runs the NC = 1 instances, whose
// code is the code before the head dims came.
// fp32 (the E = float instances, JAX's default compute dtype; entry
// a2v_alibi_attention_fwd_f32): q, k and v are staged as two bf16 tiles
// each, hi = bf16(x) and lo = bf16(x - hi), by plain 16-byte loads split in
// registers (sm90.cuh stage_head_split; synchronous, so the ring's copies no
// longer overlap the products), and each fp32 product is three bf16 ones
// into the same fp32 accumulator, S = Qhi Khi^T + Qhi Klo^T + Qlo Khi^T
// and O += Phi Vhi + Phi Vlo + Plo Vhi with P split in registers
// (frag_split_from_acc): about 2^-16 of each term's size against exact
// fp32 products, and three times the tensor-core work. Single-pass TF32
// would keep 10 bits of each operand, and P V would need K-major V tiles.
// Shared memory doubles (198 KB at NC = 2) and the fp32 instances run one
// block an SM; the scalar pass, the dropout hash and the lse are the bf16
// instances'; out is written in fp32.
// Two warpgroups a block, two blocks an SM (<= 128 registers). Measured
// slower on an H100 (PERF.md): three warpgroups, one, a third ring stage,
// tiles of 128 keys (S by m64n128k16; 186-213 registers at one block an
// SM, spills at two), and tile t - 1's P V left in flight through tile t's
// scalar pass (ptxas fences the in-flight products again).
#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTile = 64;               // keys per tile; query rows per warpgroup
constexpr int kWG = 2;                  // warpgroups per block
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 2;              // ring depth of the key tiles
constexpr float kMasked = -1e9f;        // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kDeadGap = -88.f;       // training: expf below it is under 2^-126
// Q's tiles, the ring's K and V tiles (each twice, hi and lo, in the fp32
// instances: kPlanes 2), each key's {pos, entry}, slack
template <int NC, int kPlanes>
constexpr int kSmem =
    kTileElems * 2 * NC * kPlanes * (kWG + 2 * kStages) + kStages * kTile * 8 + kTileAlign;

struct FwdArgs {
  long long stride_b, stride_h, stride_t;  // elements, shared by q, k and v
  long long out_b, out_h, out_t;           // elements of out
  int H, T, D;
  int pos_row;   // elements between batch rows of positions (0: batch-uniform)
  int posk_row;  // elements between batch rows of the key positions
  int mask_row;  // elements between batch rows of the padding mask
  float scale;   // D^-0.5, times log2(e) when serving
  float slope_unit;  // log2(e) when serving, else 1
  uint32_t seed;     // dropout seed (int32 bits)
  uint32_t thresh;   // keep when hash >= thresh
  float keep_scale;  // 1 / (1 - rate)
  int h0;            // the hash's first head: a tensor-parallel rank's
  int hash_heads;    // of the unsharded head count (0 and H unsharded)
};

// TRAIN: scores in natural units (and the lse when lse is not null); DROP
// (only with TRAIN): the hash dropout. E: the element type of q, k, v and
// out, bf16 or fp32 (each operand split in shared memory, each product
// three bf16 products: sm90.cuh split_pair).
template <int NC, bool HAS_MASK, bool HAS_SENTINEL, bool TRAIN, bool DROP, typename E>
__global__ void __launch_bounds__(kThreads, NC == 1 && std::is_same<E, bf16>::value ? 2 : 1)
alibi_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const float* __restrict__ slopes,  // (H,)
                 const int* __restrict__ pos,       // (1 or B, T) of the queries
                 const int* __restrict__ pos_k,     // (1 or B, T) of the keys
                 const uint8_t* __restrict__ mask,  // (1 or B, T), 1 = padded key
                 E* __restrict__ out,
                 float* __restrict__ lse,           // null or (B*H, T)
                 FwdArgs a) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;   // a staged head: hi (and lo) tiles
  extern __shared__ uint8_t smem_raw[];
  bf16* const sQ = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  constexpr int kHead = NC * kTileElems * kPlanes;  // a head's 64 rows, staged
  bf16* const sK = sQ + kWG * kHead;       // stage s at s heads in
  bf16* const sV = sK + kStages * kHead;
  float2* const sKey = reinterpret_cast<float2*>(sV + kStages * kHead);  // {pos, entry}

  const int T = a.T, h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile * kWG;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;

  const long long head = b * a.stride_b + h * a.stride_h;
  const E* qb = q + head;
  const E* kb = k + head;
  const E* vb = v + head;
  const int* posr = pos + static_cast<long long>(b) * a.pos_row;
  const int* poskr = pos_k + static_cast<long long>(b) * a.posk_row;
  const uint8_t* mrow = HAS_MASK ? mask + static_cast<long long>(b) * a.mask_row : nullptr;
  const int n_tiles = (T + kTile - 1) / kTile;

  // key tile kt's K and V into its ring slot; one commit group
  auto stage = [&](int kt) {
    const int slot = kt % kStages;
    stage_head_of<kThreads, NC>(sK + slot * kHead, kb, a.stride_t, kt * kTile, T, a.D, tid);
    stage_head_of<kThreads, NC>(sV + slot * kHead, vb, a.stride_t, kt * kTile, T, a.D, tid);
  };
  // threads < 64: key kt * 64 + tid's position and mask entry
  auto key_entry = [&](int kt) {
    const int key = kt * kTile + tid;
    if (key >= T) return make_float2(0.f, -INFINITY);
    return make_float2(static_cast<float>(poskr[key]),
                       HAS_MASK && mrow[key] ? kMasked : INFINITY);
  };

  // prologue: the Q tiles with key tile 0, then tiles 1 .. kStages - 2, one
  // commit group each
#pragma unroll
  for (int w = 0; w < kWG; ++w)
    stage_head_of<kThreads, NC>(sQ + w * kHead, qb, a.stride_t, q0 + w * kTile, T, a.D, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s);
    cp_async_commit();
    if (s < n_tiles && tid < kTile) sKey[s * kTile + tid] = key_entry(s);
  }

  // this thread's rows q0 + 64 wg + 16 warp + g + 8r; a sentinel query row
  // (position < 0) has no bias, as if its slope were 0
  const int row0 = q0 + 64 * wg + 16 * warp + g;
  float pq[2], slope[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    pq[r] = row < T ? static_cast<float>(posr[row]) : 0.f;
    slope[r] = HAS_SENTINEL && pq[r] < 0.f ? 0.f : slopes[h] * a.slope_unit;
  }
  // the dropout hash: the seed's share, and row0's term (row0 + 8 adds
  // 8 kHashRow)
  const uint32_t seed_mix =
      DROP ? drop_seed_mix(a.seed + (static_cast<uint32_t>(b) * a.hash_heads + a.h0 + h) *
                                        0xC2B2AE3Du)
           : 0u;
  const uint32_t zrow = static_cast<uint32_t>(row0) * kHashRow;
  float m[2] = {kMasked, kMasked};  // running max, in the scores' units
  float l[2] = {0.f, 0.f};
  float o[NC][32], sc[32];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  }
  const uint64_t desc_q = desc_sw128(sQ) + wg * NC * kPlanes * kDescTile;
  const uint64_t desc_k = desc_sw128(sK), desc_v = desc_sw128(sV);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt (and Q) have landed
    fence_proxy_async();
    __syncthreads();  // tile kt visible to all; every thread is done with tile kt - 1
    const int nt = kt + kStages - 1;
    float2 nkey = make_float2(0.f, 0.f);
    if (nt < n_tiles) {
      stage(nt);  // into the slot tile kt - 1 used
      if (tid < kTile) nkey = key_entry(nt);
    }
    cp_async_commit();

    const int slot = kt % kStages;
    wgmma_fence();
    gemm_head_ss_of<NC, kF32>(sc, desc_q, desc_k + slot * NC * kPlanes * kDescTile);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // x = s scale - slope |pos_i - pos_j| (the bias rounded first), then
    // the mask entry (kEntry: a padding mask, or the last tile), then the
    // row max
    const float4* keys = reinterpret_cast<const float4*>(sKey + slot * kTile);
    float mx[2] = {-INFINITY, -INFINITY};
    auto scores = [&](auto entry) {
      constexpr bool kEntry = decltype(entry)::value;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float4 kv = keys[4 * j + i4];  // keys 8j + 2 i4 and 8j + 2 i4 + 1
        const float pk[2] = {kv.x, kv.z}, ent[2] = {kv.y, kv.w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float dist = fabsf(pq[r] - pk[e]);
            if (HAS_SENTINEL && pk[e] < 0.f) dist = 0.f;
            float x = fmaf(sc[i], a.scale, -__fmul_rn(slope[r], dist));
            if (kEntry && ent[e] != INFINITY) x = ent[e];
            sc[i] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      }
    };
    if (HAS_MASK || kt == n_tiles - 1)
      scores(std::true_type{});
    else
      scores(std::false_type{});

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = TRAIN ? expf(m[r] - m_new) : ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // training: the weights, unless every one of the warp's is below
    // expf(-88) < 2^-126: such weights vanish beside the row's max weight
    // 1 in l and in O, and the tile's max bounds them all (along an ALiBi
    // row, keys more than about 88 / slope from the row's max)
    bool live = !TRAIN;
#pragma unroll
    for (int r = 0; r < 2; ++r) live |= mx[r] - m[r] >= kDeadGap;
    if (!TRAIN || __any_sync(0xffffffffu, live)) {
      const uint32_t zt = static_cast<uint32_t>(kt * kTile + 2 * i4) * kHashCol;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = TRAIN ? expf(sc[i] - m[r]) : ex2(sc[i] - m[r]);
        l[r] += p;  // the denominator from the fp32, undropped weights
        if (DROP) {
          // row row0 + 8r, column kt * 64 + 8j + 2 i4 + e of i = 4j + 2r + e
          const uint32_t z = zrow + zt + static_cast<uint32_t>(8 * r) * kHashRow +
                             static_cast<uint32_t>(8 * (i >> 2) + (i & 1)) * kHashCol;
          p = drop_mix_seeded(seed_mix, z) >= a.thresh ? p * a.keep_scale : 0.f;
        }
        sc[i] = p;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] *= alpha[(i >> 1) & 1];
      }
    }

    // O += P V (keys past T have P = 0 and zero-filled V rows); fp32: P's
    // hi and lo fragments, P_hi V_hi + P_hi V_lo + P_lo V_hi
    uint32_t pf[4][4], pl[4][4];
    if constexpr (kF32)
      frag_split_from_acc(pf, pl, sc);
    else
      frag_from_acc(pf, sc);
    wgmma_fence();
    const uint64_t dv = desc_v + slot * NC * kPlanes * kDescTile;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      fence_regs(o[n]);
      gemm_frag_tile(o[n], pf, dv + n * kDescTile);
      if constexpr (kF32) {
        gemm_frag_tile(o[n], pf, dv + (NC + n) * kDescTile);
        gemm_frag_tile(o[n], pl, dv + n * kDescTile);
      }
    }
    wgmma_commit();
    // ... and write the next tile's keys into their slot
    if (nt < n_tiles && tid < kTile) sKey[(nt % kStages) * kTile + tid] = nkey;
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NC; ++n) fence_regs(o[n]);
    fence_regs(pf);
    if constexpr (kF32) fence_regs(pl);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  E* ob = out + b * a.out_b + h * a.out_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    const float inv = 1.f / l[r];
    E* orow = ob + row * a.out_t;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j;  // columns past D are not written
        if (NC == 1 || col < a.D) {
          const float o0 = TRAIN ? o[n][4 * j + 2 * r] / l[r] : o[n][4 * j + 2 * r] * inv;
          const float o1 =
              TRAIN ? o[n][4 * j + 2 * r + 1] / l[r] : o[n][4 * j + 2 * r + 1] * inv;
          if constexpr (kF32)
            *reinterpret_cast<float2*>(orow + col + 2 * i4) = make_float2(o0, o1);
          else
            *reinterpret_cast<uint32_t*>(orow + col + 2 * i4) = pack_bf16(o0, o1);
        }
      }
    }
    if (TRAIN && lse != nullptr && i4 == 0)
      lse[(static_cast<long long>(b) * a.H + h) * T + row] = m[r] + logf(l[r]);
  }
}

template <int NC, bool HAS_MASK, bool HAS_SENTINEL, bool TRAIN, bool DROP, typename E>
int launch(dim3 grid, cudaStream_t s, const E* q, const E* k, const E* v,
           const float* slopes, const int* pos, const int* pos_k, const uint8_t* mask, E* out,
           float* lse, const FwdArgs& a) {
  constexpr auto kernel = alibi_fwd_kernel<NC, HAS_MASK, HAS_SENTINEL, TRAIN, DROP, E>;
  constexpr int smem = kSmem<NC, std::is_same<E, float>::value ? 2 : 1>;
  // the shared-memory limit above 48 KB, raised once per process and instance
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, slopes, pos, pos_k, mask, out, lse, a);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool TRAIN, bool DROP, typename E>
int dispatch(bool has_mask, bool has_sentinel, dim3 grid, cudaStream_t s, const E* q,
             const E* k, const E* v, const float* slopes, const int* pos,
             const int* pos_k, const uint8_t* mask, E* out, float* lse, const FwdArgs& a) {
  if (has_mask)
    return has_sentinel ? launch<NC, true, true, TRAIN, DROP>(grid, s, q, k, v, slopes, pos,
                                                              pos_k, mask, out, lse, a)
                        : launch<NC, true, false, TRAIN, DROP>(grid, s, q, k, v, slopes, pos,
                                                               pos_k, mask, out, lse, a);
  return has_sentinel ? launch<NC, false, true, TRAIN, DROP>(grid, s, q, k, v, slopes, pos,
                                                             pos_k, mask, out, lse, a)
                      : launch<NC, false, false, TRAIN, DROP>(grid, s, q, k, v, slopes, pos,
                                                              pos_k, mask, out, lse, a);
}

// The serving or training instances of the head's tile count.
template <int NC, typename E>
int dispatch_mode(bool train, bool drop, bool has_mask, bool has_sentinel, dim3 grid,
                  cudaStream_t s, const E* q, const E* k, const E* v,
                  const float* slopes, const int* pos, const int* pos_k, const uint8_t* mask,
                  E* out, float* lse, const FwdArgs& a) {
  if (drop)
    return dispatch<NC, true, true>(has_mask, has_sentinel, grid, s, q, k, v, slopes, pos, pos_k,
                                    mask, out, lse, a);
  if (train)
    return dispatch<NC, true, false>(has_mask, has_sentinel, grid, s, q, k, v, slopes, pos,
                                     pos_k, mask, out, lse, a);
  return dispatch<NC, false, false>(has_mask, has_sentinel, grid, s, q, k, v, slopes, pos, pos_k,
                                    mask, out, lse, a);
}

// The C entries' body for q, k, v and out of element type E. Returns a
// cudaError_t.
template <typename E>
int fwd_entry(const void* q, const void* k, const void* v, long long stride_b,
              long long stride_t, long long stride_h, const void* slopes, const void* pos,
              int pos_per_row, const void* pos_k, int posk_per_row, const void* mask,
              int mask_per_row, void* out, long long out_b, long long out_t, long long out_h,
              void* lse, int B, int H, int T, int D, int has_sentinel, float sm_scale, int seed,
              unsigned int thresh, float keep_scale, int h0, int hash_heads, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const long long strides[] = {stride_b, stride_t, stride_h, out_b, out_t, out_h};
  for (const long long st : strides)
    if (st % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out) || h0 < 0 ||
      hash_heads < h0 + H)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kTile * kWG - 1) / (kTile * kWG), H, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const E*>(q);
  const auto* kp = static_cast<const E*>(k);
  const auto* vp = static_cast<const E*>(v);
  const auto* sl = static_cast<const float*>(slopes);
  const auto* p = static_cast<const int*>(pos);
  const auto* pk = pos_k != nullptr ? static_cast<const int*>(pos_k) : p;
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<E*>(out);
  auto* ls = static_cast<float*>(lse);
  const bool train = ls != nullptr || thresh != 0u;
  const FwdArgs a{stride_b, stride_h, stride_t, out_b, out_h, out_t, H, T, D,
                  pos_per_row ? T : 0,
                  (pos_k != nullptr ? posk_per_row : pos_per_row) ? T : 0, mask_per_row ? T : 0,
                  train ? sm_scale : sm_scale * kLog2e, train ? 1.f : kLog2e,
                  static_cast<uint32_t>(seed), thresh, keep_scale, h0, hash_heads};
  const bool has_mask = mk != nullptr, sentinel = has_sentinel != 0, drop = thresh != 0u;
  if (D == 64)
    return dispatch_mode<1>(train, drop, has_mask, sentinel, grid, s, qp, kp, vp, sl, p, pk, mk,
                            o, ls, a);
  return dispatch_mode<2>(train, drop, has_mask, sentinel, grid, s, qp, kp, vp, sl, p, pk, mk, o,
                          ls, a);
}

}  // namespace
}  // namespace a2v

// C entries, bound with ctypes. D: a multiple of 8 up to 128 (the wrapper
// pads other head dims with zero columns). q, k, v: (B, T, H, D) with
// element strides (stride_b, stride_t, stride_h, 1), 16-byte aligned,
// strides multiples of 8; out: (B, T, H, D) with strides (out_b, out_t,
// out_h, 1), 16-byte aligned, strides multiples of 8 (bf16 in
// a2v_alibi_attention_fwd, fp32 in a2v_alibi_attention_fwd_f32); slopes
// fp32 (H,); positions int32 (pos_per_row ? B : 1, T); key positions null
// (the positions) or int32 (posk_per_row ? B : 1, T); mask null or uint8
// (mask_per_row ? B : 1, T); lse null or fp32 (B*H, T). A launch with an
// lse or a nonzero dropout threshold runs the training instances (scores
// in natural units), one with neither the serving ones. Returns a
// cudaError_t.
extern "C" int a2v_alibi_attention_fwd(
    const void* q, const void* k, const void* v, long long stride_b, long long stride_t,
    long long stride_h, const void* slopes, const void* pos, int pos_per_row, const void* pos_k,
    int posk_per_row, const void* mask, int mask_per_row, void* out, long long out_b,
    long long out_t, long long out_h, void* lse, int B, int H, int T, int D, int has_sentinel,
    float sm_scale, int seed, unsigned int thresh, float keep_scale, int h0, int hash_heads,
    void* stream) {
  return a2v::fwd_entry<__nv_bfloat16>(q, k, v, stride_b, stride_t, stride_h, slopes, pos,
                                       pos_per_row, pos_k, posk_per_row, mask, mask_per_row, out,
                                       out_b, out_t, out_h, lse, B, H, T, D, has_sentinel,
                                       sm_scale, seed, thresh, keep_scale, h0, hash_heads, stream);
}

extern "C" int a2v_alibi_attention_fwd_f32(
    const void* q, const void* k, const void* v, long long stride_b, long long stride_t,
    long long stride_h, const void* slopes, const void* pos, int pos_per_row, const void* pos_k,
    int posk_per_row, const void* mask, int mask_per_row, void* out, long long out_b,
    long long out_t, long long out_h, void* lse, int B, int H, int T, int D, int has_sentinel,
    float sm_scale, int seed, unsigned int thresh, float keep_scale, int h0, int hash_heads,
    void* stream) {
  return a2v::fwd_entry<float>(q, k, v, stride_b, stride_t, stride_h, slopes, pos, pos_per_row,
                             pos_k, posk_per_row, mask, mask_per_row, out, out_b, out_t, out_h,
                             lse, B, H, T, D, has_sentinel, sm_scale, seed, thresh, keep_scale,
                             h0, hash_heads, stream);
}
