// Flash-attention forward with a dense additive bias, bf16 or fp32 in and
// out, head dims D <= 128 (a multiple of 8).
//
// Replaces jax's stock TPU flash-attention kernel
// (jax.experimental.pallas.ops.tpu.flash_attention, reached through
// animal2vec_tpu/models/attention.py:flash_attention_tpu for every bias that
// is not an AlibiSpec: the image modality's 2-D ALiBi bias, or none). It
// computes what that module's xla_attention computes:
//
//   s_ij = (q_i . k_j) / sqrt(D) + bias[b, h, i, j]      (fp32)
//   s_ij = -1e10 where key j is padded (a replacement, not an addition)
//   out[b, i, h] = sum_j softmax_j(s_ij) v_j
//
// The TPU kernel adds the bias before its sm_scale, (q.k + bias) / sqrt(D),
// which weakens the bias by 1/sqrt(D); the port does not copy that. A query
// row whose keys are all padded scores -1e10 everywhere and returns the mean
// of V over the T keys, as xla_attention's softmax does. With lse the
// kernel also writes each row's logsumexp m + log l (the running max and
// the sum of exp(s - m)), which the backward (bias_attention_bwd.cu) reads.
// Training takes xla_attention's attention dropout as the ALiBi kernels
// (#2) take theirs: keep_ij is the counter hash of (seed + (b*H+h) *
// 0xC2B2AE3D, i, j) over global query and key indices (common.cuh), which
// the backward regenerates; the denominator l sums the undropped weights
// and the dropout scales the weights of P.V only (xla_attention drops the
// normalized weights, which is the same function). The hash runs only when
// the threshold is nonzero (a uniform branch): serving pays nothing.
//
// Bound on the H100 at the image serving shape (B = 64, H = 12, T = 196):
// the two products are 7.6 GFLOP (8 us at the bf16 peak) against 77 MB of
// q, k, v and out and the 1.8 MB bias plane (23 us at 3.35 TB/s): bound by
// bytes, and short, so latency that is not overlapped (a tile's copies, the
// bias reads) and work on empty keys weigh as much as either.
//
// Design (Hopper, sm_90a): one warpgroup (128 threads) per block owns 64
// query rows of one (batch, head), wgmma's M, and walks the keys in tiles
// of 64 with an online softmax (running max and sum, fp32). q, k and
// v are read in place from (B, T, H, D) views with any batch and time
// strides (the model hands over the q, k, v thirds of its (B, T, 3, H, D)
// projection): a head's row is 2D contiguous bytes, so every tile arrives
// as 16-byte cp.async chunks into the 128-byte swizzle of csrc/sm90.cuh, and
// no packed copy of qkv is made.
//   - S = Q K^T is an SS wgmma (m64n64k16, four k-steps over D) from the
//     swizzled Q and K tiles; O += P V an RS wgmma whose A is the bf16 of
//     S's accumulator after the scalar pass (frag_from_acc), with V read
//     MN-major: P never leaves registers.
//   - A ring of two stages holds each key tile's K, V, fp32 bias rows and
//     key-mask flags: the copies of tile t + 1 are in flight while tile t's
//     products and scalar pass run, so no tile's latency is exposed (the
//     mma.sync kernel this replaces waited for each tile before its
//     products and read each score's bias from device memory inside the
//     scalar pass). The bias rows (64 x 64 fp32, 16 KB) are staged by
//     cp.async in 16-byte chunks when the rows are 16-byte aligned (T % 4
//     == 0: the image grid's 196 and 1024), else 4 bytes at a time (the
//     student's 59), into an XOR swizzle of 16-byte chunks by row, (chunk
//     ^ 2 (row % 4)), that makes each thread's float2 reads conflict-free
//     (sm90.cuh's f32_tile_at).
//     A batch-uniform (1, H, T, T) bias is read with batch stride 0 and
//     stays in L2; a per-row (B, H, T, T) bias (pretraining's student)
//     goes the same way.
//   - The last key tile is narrowed to the live keys: at T 196 it holds 4
//     of 64. When it holds at most 32, S is computed in 8-key column groups
//     (wgmma m64n8k16, as many as the keys need) and P V takes only the
//     k16 steps that hold live keys; the scalar pass skips the rest. Keys
//     past T score -inf and their V rows are zero-filled.
//   - The scalar pass forms x - m before its exponential, expf(x - m), so
//     that a row whose keys are all padded gets exactly 1 per key, and
//     rounds the score and its exponential as the backward
//     (bias_attention_bwd.cu) does when it rebuilds P from the lse; the
//     bounds checks run on the last tile only.
// Head dims: a head's row is NC = 1 (D 64) or 2 (any other D up to 128)
// swizzled tiles of 64 columns, zero past D (sm90.cuh stage_head); S sums
// NC tile products, O is NC accumulators, only columns < D are written.
// The NC = 2 instances run one or two blocks an SM. D = 64 runs the NC = 1
// instances, unchanged.
// fp32 (the E = float instances, JAX's default compute dtype; entry
// a2v_bias_attention_f32), as the ALiBi forward's (alibi_attention_fwd.cu):
// q, k and v are staged as two bf16 tiles each, hi = bf16(x) and lo =
// bf16(x - hi), by plain 16-byte loads split in registers (sm90.cuh
// stage_head_split; synchronous, so only the bias rows' copies overlap the
// products), and each fp32 product is three bf16 ones into one fp32
// accumulator: S = Qhi Khi^T + Qhi Klo^T + Qlo Khi^T (the narrowed last
// tile's 8-key column groups the same three, group by group) and O +=
// Phi Vhi + Phi Vlo + Plo Vhi with P split in registers
// (frag_split_from_acc). The bias stays fp32 as staged; the scalar pass,
// the dropout hash and the lse are the bf16 instances'; out is fp32.
// Shared memory: 113.5 KB at NC 1 with a bias (one block an SM), 81.5 KB
// without (two), 193.5 KB at NC 2 with a bias (one).
// Shared memory: Q 8 KB, two stages of K and V (32 KB), of bias (32 KB, only
// with a bias) and flags, 1 KB of alignment slack: 73.5 KB with a bias, so
// that three blocks share an SM and one block's scalar pass overlaps
// another's products and copies. Measured slower on an H100 (PERF.md):
// blocks of two or four warpgroups sharing each K/V tile, blocks that walk
// several batch rows with the uniform bias kept in shared memory, a third
// ring stage, and copying only the live rows of the last tiles.
#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTile = 64;          // query rows per block; keys per tile
constexpr int kThreads = 128;      // one warpgroup
constexpr int kStages = 2;         // ring depth of the key tiles
constexpr float kMasked = -1e10f;  // NEG_INF of models/attention.py
constexpr int kTileBytes = kTileElems * 2;
constexpr int kBiasTileBytes = kTile * kTile * 4;

// dynamic shared memory: Q, the ring's K tiles, its V tiles (each twice,
// hi and lo, in the fp32 instances: planes 2), its bias tiles (with a
// bias), its flags, and slack to align the base to 1024 bytes
constexpr int smem_bytes(int nc, bool has_bias, int planes) {
  return kTileBytes * nc * planes * (1 + 2 * kStages) +
         (has_bias ? kStages * kBiasTileBytes : 0) + kStages * kTile * 4 + kTileAlign;
}

struct BiasArgs {
  long long stride_b;  // elements between batch rows of q, k and v
  long long stride_t;  // elements between time rows
  int H, T, D;
  float sm_scale;
  int bias16;  // the bias rows are 16-byte aligned: staged in 16-byte chunks
  uint32_t seed;      // dropout seed (int32 bits)
  uint32_t thresh;    // keep when hash >= thresh; 0 = no dropout
  float keep_scale;   // 1 / (1 - rate)
};

// E: the element type of q, k, v and out, bf16 or fp32 (each operand
// split in shared memory, each product three bf16 products: sm90.cuh
// split_pair).
template <int NC, bool HAS_BIAS, bool UNIFORM_BIAS, bool HAS_MASK, typename E>
__global__ void __launch_bounds__(kThreads, NC == 1 && std::is_same<E, bf16>::value ? 3 : 2)
bias_attention_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                      const float* __restrict__ bias,    // (1 or B, H, T, T)
                      const uint8_t* __restrict__ mask,  // (B, T), 1 = padded key
                      E* __restrict__ out,               // (B, T, H, D)
                      float* __restrict__ lse,           // null or (B*H, T)
                      BiasArgs a) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;     // a staged head: hi (and lo) tiles
  constexpr uint64_t kLo = NC * kDescTile;  // a staged head's lo tiles
  extern __shared__ uint8_t smem_raw[];
  constexpr int kHead = NC * kTileElems * kPlanes;  // a head's 64 rows, staged
  bf16* const sQ = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* const sK = sQ + kHead;          // stage s at s heads in
  bf16* const sV = sK + kStages * kHead;
  float* const sBias = reinterpret_cast<float*>(sV + kStages * kHead);
  int* const sPad = reinterpret_cast<int*>(sBias + (HAS_BIAS ? kStages * kTile * kTile : 0));

  const int H = a.H, T = a.T, D = a.D;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;

  const long long head = static_cast<long long>(b) * a.stride_b + static_cast<long long>(h) * D;
  const E* qb = q + head;
  const E* kb = k + head;
  const E* vb = v + head;
  const float* plane =
      HAS_BIAS ? bias + (static_cast<size_t>(UNIFORM_BIAS ? 0 : b) * H + h) * T * T : nullptr;
  const uint8_t* mrow = HAS_MASK ? mask + static_cast<size_t>(b) * T : nullptr;
  const int n_tiles = (T + kTile - 1) / kTile;
  // the dropout hash: the seed's share, and this thread's first row's and
  // column's terms (its second row adds 8 kHashRow)
  const uint32_t seed_mix = drop_seed_mix(a.seed + static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);
  const uint32_t zrow = static_cast<uint32_t>(q0 + warp * 16 + g) * kHashRow +
                        static_cast<uint32_t>(2 * i4) * kHashCol;

  // key tile kt's K, V and bias rows into its ring slot; one commit group
  auto stage = [&](int kt) {
    const int slot = kt % kStages, k0 = kt * kTile;
    stage_head_of<kThreads, NC>(sK + slot * kHead, kb, a.stride_t, k0, T, D, tid);
    stage_head_of<kThreads, NC>(sV + slot * kHead, vb, a.stride_t, k0, T, D, tid);
    if constexpr (HAS_BIAS) {
      float* dst = sBias + slot * kTile * kTile;
      if (a.bias16) {
#pragma unroll
        for (int i = 0; i < kTile * 16 / kThreads; ++i) {
          const int c = tid + i * kThreads, r = c >> 4, ch = c & 15;
          const int row = q0 + r, col = k0 + 4 * ch;
          const bool in = row < T && col < T;
          cp_async_16(dst + f32_tile_at(r, 4 * ch),
                      plane + (in ? static_cast<size_t>(row) * T + col : 0), in);
        }
      } else {
#pragma unroll 8
        for (int i = 0; i < kTile * kTile / kThreads; ++i) {
          const int c = tid + i * kThreads, r = c >> 6, cc = c & 63;
          const int row = q0 + r, col = k0 + cc;
          const bool in = row < T && col < T;
          cp_async_4(dst + f32_tile_at(r, cc), plane + (in ? static_cast<size_t>(row) * T + col : 0),
                     in);
        }
      }
    }
  };
  // threads < 64 read key kt * 64 + tid's mask flag ...
  auto load_pad = [&](int kt) {
    const int key = kt * kTile + tid;
    return key < T && mrow[key] ? 1 : 0;
  };

  // prologue: Q, then the first key tile, one commit group each
  stage_head_of<kThreads, NC>(sQ, qb, a.stride_t, q0, T, D, tid);
  cp_async_commit();
  stage(0);
  cp_async_commit();
  if (HAS_MASK && tid < kTile) sPad[tid] = load_pad(0);

  // this thread's rows q0 + 16 warp + g + 8r
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float o[NC][32], sc[32];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  }
  const uint64_t desc_q = desc_sw128(sQ), desc_k = desc_sw128(sK), desc_v = desc_sw128(sV);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();  // this thread's copies of tile kt (and Q) have landed
    fence_proxy_async();
    __syncthreads();  // tile kt visible to all; every thread is done with tile kt - 1
    const int nt = kt + 1;
    int npad = 0;
    if (nt < n_tiles) {
      stage(nt);  // into the slot tile kt - 1 used
      if (HAS_MASK && tid < kTile) npad = load_pad(nt);
    }
    cp_async_commit();

    const int slot = kt % kStages, k0 = kt * kTile;
    const int width = min(kTile, T - k0);  // keys of this tile below T
    const int n_groups = (width + 7) >> 3;  // 8-key column groups S holds
    const int n_steps = (width + 15) >> 4;  // k16 steps of P V
    const uint64_t dk = desc_k + slot * NC * kPlanes * kDescTile;
    wgmma_fence();
    if (n_groups > 4) {
      gemm_head_ss_of<NC, kF32>(sc, desc_q, dk);  // S = Q K^T, all 64 keys
    } else {
      // a narrow last tile: S in 8-key column groups (rows 8j.. of the K tile
      // start 1024 bytes apart), the k16 step s in tile s / 4 of the head;
      // fp32: each group's three products, Qhi Khi^T + Qhi Klo^T + Qlo Khi^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < n_groups) {
          const uint64_t dkj = dk + j * (1024 >> 4);
#pragma unroll
          for (int p = 0; p < (kF32 ? 3 : 1); ++p) {
            const uint64_t dqp = desc_q + (p == 2 ? kLo : 0), dkp = dkj + (p == 1 ? kLo : 0);
#pragma unroll
            for (int kk = 0; kk < NC * 4; ++kk) {
              const uint64_t step = (kk >> 2) * kDescTile + (kk & 3) * kDescStepK;
              if (p == 0 && kk == 0)
                wgmma_ss_n8<false>(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3], dqp,
                                   dkp);
              else
                wgmma_ss_n8<true>(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3],
                                  dqp + step, dkp + step);
            }
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale + bias, then the key mask, then the running row max; on the
    // last tile (kEdge) keys past T, and the column groups S did not
    // compute, score -inf
    const float* bt = sBias + slot * kTile * kTile;
    const int* pad = sPad + slot * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
    auto scores = [&](auto edge) {
      constexpr bool kEdge = decltype(edge)::value;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        if (kEdge && j >= 2 * n_steps) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r, col = 8 * j + 2 * i4;
          float2 bv = make_float2(0.f, 0.f);
          if constexpr (HAS_BIAS) bv = *reinterpret_cast<const float2*>(bt + f32_tile_at(row, col));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float x = sc[i] * a.sm_scale;
            if constexpr (HAS_BIAS) x += e ? bv.y : bv.x;
            if (HAS_MASK && pad[col + e]) x = kMasked;
            if (kEdge && col + e >= width) x = -INFINITY;
            sc[i] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      }
    };
    if (width < kTile)
      scores(std::true_type{});
    else
      scores(std::false_type{});
    // p = exp(x - m), rounded as the backward rounds exp(x - lse): x - m
    // is exact 0 at the max and in a row whose keys are all padded
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      if (j < 2 * n_steps) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(sc[4 * j + e] - m[e >> 1]);
          l[e >> 1] += p;  // the denominator from the fp32, undropped weights
          if (a.thresh != 0u) {
            const uint32_t z = zrow + static_cast<uint32_t>(8 * (e >> 1)) * kHashRow +
                               static_cast<uint32_t>(k0 + 8 * j + (e & 1)) * kHashCol;
            p = drop_mix_seeded(seed_mix, z) >= a.thresh ? p * a.keep_scale : 0.f;
          }
          sc[4 * j + e] = p;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= alpha[(i >> 1) & 1];
    }

    // O += P V over the k16 steps that hold live keys; fp32: P's hi and lo
    // fragments, P_hi V_hi + P_hi V_lo + P_lo V_hi
    uint32_t pf[4][4], pl[4][4];
    if constexpr (kF32)
      frag_split_from_acc(pf, pl, sc);
    else
      frag_from_acc(pf, sc);
    const uint64_t dv = desc_v + slot * NC * kPlanes * kDescTile;
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      fence_regs(o[n]);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (kk < n_steps) {
          const uint64_t dvk = dv + n * kDescTile + kk * kDescStepMN;
          wgmma_rs<1>(o[n], pf[kk], dvk);
          if constexpr (kF32) {
            wgmma_rs<1>(o[n], pf[kk], dvk + kLo);
            wgmma_rs<1>(o[n], pl[kk], dvk);
          }
        }
      }
    }
    wgmma_commit();
    // ... and write it into the next tile's slot
    if (HAS_MASK && nt < n_tiles && tid < kTile) sPad[(nt % kStages) * kTile + tid] = npad;
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NC; ++n) fence_regs(o[n]);
    fence_regs(pf);
    if constexpr (kF32) fence_regs(pl);
  }

  // the row max contributes exp(0) = 1, so l >= 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t row_stride = static_cast<size_t>(H) * D;
  E* ob = out + static_cast<size_t>(b) * T * row_stride + static_cast<size_t>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= T) continue;
    if (lse != nullptr && i4 == 0)  // the backward's logsumexp, m + log l
      lse[(static_cast<size_t>(b) * H + h) * T + row] = m[r] + logf(l[r]);
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j;  // columns past D are not written
        if (NC == 1 || col < D)
          store_pair(&ob[static_cast<size_t>(row) * row_stride + col + 2 * i4],
                     o[n][4 * j + 2 * r] * inv, o[n][4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

template <int NC, bool HAS_BIAS, bool UNIFORM_BIAS, typename E>
int launch_mask(bool has_mask, dim3 grid, cudaStream_t s, const E* q, const E* k, const E* v,
                const float* bias, const uint8_t* mask, E* out, float* lse, const BiasArgs& a) {
  constexpr auto with_mask = bias_attention_kernel<NC, HAS_BIAS, UNIFORM_BIAS, true, E>;
  constexpr auto without_mask = bias_attention_kernel<NC, HAS_BIAS, UNIFORM_BIAS, false, E>;
  constexpr int smem = smem_bytes(NC, HAS_BIAS, std::is_same<E, float>::value ? 2 : 1);
  // the shared-memory limit above 48 KB, raised once per process for both
  static const cudaError_t attr = [] {
    const cudaError_t err =
        cudaFuncSetAttribute(with_mask, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return err != cudaSuccess ? err
                              : cudaFuncSetAttribute(
                                    without_mask, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  (has_mask ? with_mask : without_mask)<<<grid, kThreads, smem, s>>>(q, k, v, bias, mask, out,
                                                                     lse, a);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, typename E>
int launch_bias(bool has_mask, bool uniform, dim3 grid, cudaStream_t s, const E* q, const E* k,
                const E* v, const float* bias, const uint8_t* mask, E* out, float* lse,
                const BiasArgs& a) {
  if (bias == nullptr)
    return launch_mask<NC, false, false>(has_mask, grid, s, q, k, v, bias, mask, out, lse, a);
  if (uniform)
    return launch_mask<NC, true, true>(has_mask, grid, s, q, k, v, bias, mask, out, lse, a);
  return launch_mask<NC, true, false>(has_mask, grid, s, q, k, v, bias, mask, out, lse, a);
}

// The C entries' body for q, k, v and out of element type E. Returns a
// cudaError_t.
template <typename E>
int bias_entry(const void* q, const void* k, const void* v, long long stride_b,
               long long stride_t, const void* bias, int bias_uniform, const void* mask,
               void* out, void* lse, int B, int H, int T, int D, float sm_scale, int seed,
               unsigned int thresh, float keep_scale, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      stride_b % 8 != 0 || stride_t % 8 != 0 || misaligned(q) || misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const E*>(q);
  const auto* kp = static_cast<const E*>(k);
  const auto* vp = static_cast<const E*>(v);
  const auto* bp = static_cast<const float*>(bias);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<E*>(out);
  auto* lp = static_cast<float*>(lse);
  const BiasArgs a{stride_b, stride_t, H, T, D, sm_scale, T % 4 == 0 && !misaligned(bias),
                   static_cast<uint32_t>(seed), thresh, keep_scale};
  const bool has_mask = mp != nullptr, uniform = bias_uniform != 0;
  if (D == 64)
    return launch_bias<1>(has_mask, uniform, grid, s, qp, kp, vp, bp, mp, op, lp, a);
  return launch_bias<2>(has_mask, uniform, grid, s, qp, kp, vp, bp, mp, op, lp, a);
}

}  // namespace
}  // namespace a2v

// C entries, bound with ctypes. D: a multiple of 8 up to 128 (the wrapper
// pads other head dims with zero columns). q, k, v: (B, T, H, D) with
// element strides (stride_b, stride_t, D, 1), 16-byte aligned, strides
// multiples of 8 (bf16 in a2v_bias_attention, fp32 in a2v_bias_attention_f32);
// bias null or fp32 (bias_uniform ? 1 : B, H, T, T) contiguous; mask null
// or (B, T) uint8; out (B, T, H, D) contiguous in q's type; lse null
// (serving) or (B*H, T) fp32, the logsumexp of each score row for the
// backward (bias_attention_bwd.cu); thresh 0 = no dropout, else the hash
// dropout of (seed, keep when hash >= thresh, kept weights times
// keep_scale). Returns a cudaError_t.
extern "C" int a2v_bias_attention(const void* q, const void* k, const void* v,
                                  long long stride_b, long long stride_t, const void* bias,
                                  int bias_uniform, const void* mask, void* out, void* lse,
                                  int B, int H, int T, int D, float sm_scale, int seed,
                                  unsigned int thresh, float keep_scale, void* stream) {
  return a2v::bias_entry<__nv_bfloat16>(q, k, v, stride_b, stride_t, bias, bias_uniform, mask,
                                        out, lse, B, H, T, D, sm_scale, seed, thresh, keep_scale,
                                        stream);
}

extern "C" int a2v_bias_attention_f32(const void* q, const void* k, const void* v,
                                      long long stride_b, long long stride_t, const void* bias,
                                      int bias_uniform, const void* mask, void* out, void* lse,
                                      int B, int H, int T, int D, float sm_scale, int seed,
                                      unsigned int thresh, float keep_scale, void* stream) {
  return a2v::bias_entry<float>(q, k, v, stride_b, stride_t, bias, bias_uniform, mask, out, lse,
                                B, H, T, D, sm_scale, seed, thresh, keep_scale, stream);
}
