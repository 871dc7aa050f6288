// ALiBi flash-attention forward probe with slope-folded positions, in four
// variants that take the scalar pass apart, bf16 in and out, D = 64, on
// Hopper's wgmma.
//
// Replaces the TPU kernel bench/kernels.py:27 _kernel_v2 (attn_v2 at :96,
// pallas_call at :103; bench/kernels2.py:73-82 runs it too), a tuning probe
// of the ALiBi forward (#1). Its function, per (b, h) and query row i, over
// key tiles of block_k keys in order:
//
//   s_ij = (bf16(q_i * bf16(D^-0.5)) . k_j) in fp32       (0.125 q, exact)
//   s_ij -= |p_i - p_j|   (not in mm_only)   p = scaled_pos[b, h], fp32
//   mm_only, no_softmax:  out_i = bf16(sum_j bf16(s_ij) v_j)
//   exp_bf16, full (an online softmax, m from -1e9, l from 0, per tile):
//     m' = max(m, max_j s_ij);  a = exp(m - m')
//     exp_bf16: p_ij = exp(bf16(s_ij - m')) in bf16;  l = a l + sum fp32(p_ij)
//     full:     p_ij = exp(s_ij - m') in fp32;        l = a l + sum p_ij
//     acc = a acc + bf16(p) v;  out_i = bf16(acc_i / max(l_i, 1e-30))
//
// One position array serves queries and keys: padded positions hold +1e9,
// so a padded query row attends to the padded keys only. The online
// variants depend on the key tile through m', so the plain twin
// (probes/kernels.attn_v2_plain) takes the tile width. Keys past T (a
// ragged last tile) do not exist: in the online variants their score is
// -inf, in the others their zero-filled V rows add 0.
//
// Layout (bench/'s): qkv (3, B, H, T, D) contiguous bf16, token stride D;
// scaled_pos (B, H, T) fp32; out (B, H, T, D) bf16.
//
// Bound on the H100 at b32 H16 T2048: the two products are 4 B H T^2 D =
// 0.550 TFLOP (0.556 ms at the 989 TFLOP/s bf16 peak) against 0.27 GB of
// qkv, positions and out (0.081 ms at 3.35 TB/s): bound by operations.
//
// Design (sm_90a), #1's (alibi_attention_fwd.cu) from the same sm90.cuh
// pieces, so that the variants differ from #1 only in the scalar pass: a
// block of two warpgroups owns 128 query rows of one (b, h), each
// warpgroup 64 rows, wgmma's M, and walks the keys in tiles of KT (64, or
// 128) with the K, V tiles and the tile's key positions in a two-stage
// cp.async ring. S = Q K^T is an SS wgmma (m64n64k16, or m64n128k16 for
// 128-key tiles); O += P V an RS wgmma whose A is the bf16 of S's
// accumulator after the scalar pass, V read MN-major. The scalar pass:
//   - mm_only: the scale and the bf16 of s: nothing else;
//   - no_softmax: adds the bias from the fp32 position row (no slope
//     multiply, no mask test);
//   - exp_bf16: the row max, the rescale a = expf(m - m'), and p by the
//     packed bf16 exp of two scores (h2exp on __nv_bfloat162), not ex2;
//   - full: the same with expf on every score, as #2's training arithmetic.
// The 128-key tile holds S in 64 accumulator registers, P in 32: one block
// an SM. The TPU's (block_q, block_k) sweep is a VMEM choice and is not
// ported.
#include <cmath>

#include "sm90.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kPD = 64;
constexpr int kPWG = 2;                  // warpgroups per block
constexpr int kPThreads = 128 * kPWG;
constexpr int kPStages = 2;              // ring depth of the key tiles
constexpr float kPNegInf = -1e9f;        // NEG_INF of the TPU kernel

enum Variant { kMmOnly = 0, kNoSoftmax = 1, kExpBf16 = 2, kFull = 3 };

template <int KT>
__host__ __device__ constexpr int probe_smem() {
  return kTileElems * 2 * kPWG + 2 * kPStages * KT * kRowElems * 2 + kPStages * KT * 4 +
         kTileAlign;
}

template <int VAR, int KT>
__global__ void __launch_bounds__(kPThreads, KT == 64 ? 2 : 1)
probe_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ spos,
                       bf16* __restrict__ out, int BH, int T, float scale) {
  constexpr int kAcc = KT / 2;    // S accumulator registers
  constexpr int kSteps = KT / 16;  // k16 steps of P V
  extern __shared__ uint8_t smem_raw[];
  bf16* const sQ = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  bf16* const sK = sQ + kPWG * kTileElems;  // stage s at s * KT rows
  bf16* const sV = sK + kPStages * KT * kRowElems;
  float* const sPos = reinterpret_cast<float*>(sV + kPStages * KT * kRowElems);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64 * kPWG;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const long long plane = static_cast<long long>(BH) * T * kPD;
  const bf16* qb = qkv + static_cast<long long>(bh) * T * kPD;
  const bf16* kb = qb + plane;
  const bf16* vb = qb + 2 * plane;
  const float* prow = spos + static_cast<long long>(bh) * T;
  const int n_tiles = (T + KT - 1) / KT;

  auto stage = [&](int kt) {
    const int slot = kt % kPStages;
#pragma unroll
    for (int t = 0; t < KT / kTileRows; ++t) {
      stage_tile<kPThreads>(sK + (slot * KT + t * kTileRows) * kRowElems, kb, kPD,
                            kt * KT + t * kTileRows, T, tid);
      stage_tile<kPThreads>(sV + (slot * KT + t * kTileRows) * kRowElems, vb, kPD,
                            kt * KT + t * kTileRows, T, tid);
    }
  };
  auto key_pos = [&](int kt) {  // threads < KT: key kt * KT + tid's position
    const int key = kt * KT + tid;
    return key < T ? prow[key] : 0.f;
  };

#pragma unroll
  for (int w = 0; w < kPWG; ++w)
    stage_tile<kPThreads>(sQ + w * kTileElems, qb, kPD, q0 + w * kTileRows, T, tid);
  stage(0);
  cp_async_commit();
  if (tid < KT) sPos[tid] = key_pos(0);

  const int row0 = q0 + 64 * wg + 16 * warp + g;  // rows row0 and row0 + 8
  float pq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) pq[r] = row0 + 8 * r < T ? prow[row0 + 8 * r] : 0.f;
  float m[2] = {kPNegInf, kPNegInf}, l[2] = {0.f, 0.f};
  float o[32], sc[kAcc];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) sc[i] = 0.f;
  const uint64_t desc_q = desc_sw128(sQ) + wg * kDescTile;
  const uint64_t desc_k = desc_sw128(sK), desc_v = desc_sw128(sV);
  constexpr uint64_t kDescStage = (KT * kRowElems * 2) >> 4;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();  // this thread's copies of tile kt (and Q) have landed
    fence_proxy_async();
    __syncthreads();  // tile kt visible to all; every thread is done with tile kt - 1
    const int nt = kt + 1;
    float npos = 0.f;
    if (nt < n_tiles) {
      stage(nt);  // into the slot tile kt - 1 used
      if (tid < KT) npos = key_pos(nt);
    }
    cp_async_commit();

    const int slot = kt % kPStages;
    const uint64_t dk = desc_k + slot * kDescStage;
    wgmma_fence();
    if constexpr (KT == 64) {
      gemm_tile_ss<0, 0>(sc, desc_q, dk);  // S = Q K^T
    } else {
#pragma unroll
      for (int kk = 0; kk < kPD / 16; ++kk)
        wgmma_bf16_n128(sc, desc_q + kk * kDescStepK, dk + kk * kDescStepK, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // s = (q k) scale, then the bias; element i = 4j + 2r + e is row row0 +
    // 8r, key kt * KT + 8j + 2 i4 + e
    const float* kpos = sPos + slot * KT;
    const bool last = kt == n_tiles - 1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const float2 pk = *reinterpret_cast<const float2*>(kpos + 8 * j + 2 * i4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float x = __fmul_rn(sc[i], scale);
          if (VAR != kMmOnly) x = __fsub_rn(x, fabsf(__fsub_rn(pq[r], e ? pk.y : pk.x)));
          if (VAR >= kExpBf16) {
            if (last && kt * KT + 8 * j + 2 * i4 + e >= T) x = -INFINITY;
            mx[r] = fmaxf(mx[r], x);
          }
          sc[i] = x;
        }
      }
    }
    if constexpr (VAR >= kExpBf16) {
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
      for (int i = 0; i < kAcc; i += 2) {
        const int r = (i >> 1) & 1;
        if constexpr (VAR == kExpBf16) {
          const __nv_bfloat162 p = h2exp(__floats2bfloat162_rn(sc[i] - m[r], sc[i + 1] - m[r]));
          sc[i] = __low2float(p);
          sc[i + 1] = __high2float(p);
        } else {
          sc[i] = expf(sc[i] - m[r]);
          sc[i + 1] = expf(sc[i + 1] - m[r]);
        }
        l[r] += sc[i] + sc[i + 1];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    }

    // O += bf16(P) V (keys past T: zero-filled V rows)
    uint32_t pf[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    }
    const uint64_t dv = desc_v + slot * kDescStage;
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<1>(o, pf[kk], dv + kk * kDescStepMN);
    wgmma_commit();
    if (nt < n_tiles && tid < KT) sPos[(nt % kPStages) * KT + tid] = npos;
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
  }

  if constexpr (VAR >= kExpBf16) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
  }
  bf16* ob = out + static_cast<long long>(bh) * T * kPD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < kPD / 8; ++j) {
      float a = o[4 * j + 2 * r], b = o[4 * j + 2 * r + 1];
      if (VAR >= kExpBf16) {
        a = a / l[r];
        b = b / l[r];
      }
      *reinterpret_cast<uint32_t*>(ob + row * kPD + 8 * j + 2 * i4) = pack_bf16(a, b);
    }
  }
}

template <int VAR, int KT>
int launch(cudaStream_t s, const bf16* qkv, const float* spos, bf16* out, int BH, int T,
           float scale) {
  constexpr auto kernel = probe_attention_kernel<VAR, KT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, probe_smem<KT>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((T + 64 * kPWG - 1) / (64 * kPWG), BH);
  kernel<<<grid, kPThreads, probe_smem<KT>(), s>>>(qkv, spos, out, BH, T, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int dispatch(int variant, cudaStream_t s, const bf16* qkv, const float* spos, bf16* out, int BH,
             int T, float scale) {
  switch (variant) {
    case kMmOnly:
      return launch<kMmOnly, KT>(s, qkv, spos, out, BH, T, scale);
    case kNoSoftmax:
      return launch<kNoSoftmax, KT>(s, qkv, spos, out, BH, T, scale);
    case kExpBf16:
      return launch<kExpBf16, KT>(s, qkv, spos, out, BH, T, scale);
    case kFull:
      return launch<kFull, KT>(s, qkv, spos, out, BH, T, scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace a2v

// C entry, bound with ctypes. qkv: contiguous bf16 (3, B, H, T, D), 16-byte
// aligned; scaled_pos: contiguous fp32 (B, H, T); out: contiguous bf16 (B,
// H, T, D). D = 64; variant 0 mm_only, 1 no_softmax, 2 exp_bf16, 3 full;
// block_k 64 or 128 (the key tile); sm_scale the bf16 of D^-0.5 (0.125).
// Returns a cudaError_t.
extern "C" int a2v_probe_attention(const void* qkv, const void* scaled_pos, void* out, int B,
                                   int H, int T, int D, int variant, int block_k, float sm_scale,
                                   void* stream) {
  using namespace a2v;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (D != kPD || B <= 0 || H <= 0 || T <= 0 || B * H > 65535 || misaligned(qkv) ||
      misaligned(out) || misaligned(scaled_pos))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* p = static_cast<const float*>(scaled_pos);
  auto* o = static_cast<bf16*>(out);
  if (block_k == 64) return dispatch<64>(variant, s, q, p, o, B * H, T, sm_scale);
  if (block_k == 128) return dispatch<128>(variant, s, q, p, o, B * H, T, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
