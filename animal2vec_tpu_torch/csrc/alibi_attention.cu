// ALiBi flash-attention forward of training, bf16 in and out, D = 64: the
// launches with the logsumexp residual of the backward or the in-kernel
// hash dropout. The serving launches (neither) run alibi_attention_serve.cu.
//
// Replaces the TPU kernel animal2vec_tpu/ops/pallas_attention.py:_kernel
// (per-row positions, any number of key blocks, the logsumexp residual and
// the in-kernel hash dropout).
//
//   out[b,h,i] = sum_j keep_ij / (1 - r) * softmax_j(s_ij) . v_j
//   s_ij = q_i . k_j / sqrt(D) - slope_h * |pos_i - pos_j| (0 when either
//          position is < 0 and the sentinel rule is on), key j padded -> -1e9
//   lse[b*H+h, i] = m_i + log(max(l_i, 1e-30))   (when an lse is asked for)
//
// keep_ij is the counter hash of (seed + (b*H+h) * 0xC2B2AE3D, i, j) over
// global query and key indices (common.cuh drop_hash), so the backward
// kernels regenerate it. As on the TPU the softmax denominator l sums the
// undropped weights and the dropout scales the weights of P.V only.
//
// Design: one thread block per (64-query tile, head, batch) with four warps,
// each owning 16 query rows. K/V tiles of 64 keys are staged in shared
// memory with cp.async; S = Q K^T and O += P V run on mma.sync m16n8k16
// (bf16 in, fp32 accumulate), P stays in registers between the two products
// (the S accumulator layout is the A-operand layout of the second product),
// and V's B operand comes transposed out of shared memory by ldmatrix.trans.
// The ALiBi bias is computed inline from the int32 positions (two
// instructions per score; no distance tile is cached, unlike the TPU
// kernel), and the online softmax runs in fp32. The masking follows the TPU
// kernel: padded keys score a finite -1e9, so a row whose keys are all padded
// averages V instead of producing NaN, and the denominator is clamped at
// 1e-30. Keys past T (2000 is not a multiple of 64) are dropped by bounds
// (weight exactly 0), not padded.
//
// Bound on the H100: at the finetune shape (B=4, H=16, T=2000) the kernel
// does 4*B*H*T^2*D = 0.066 TFLOP of tensor-core work (two products of
// 2*T^2*D per (b, h)) and the bias/softmax costs ~10 fp32 instructions per
// score (2.6e8 scores); the dropout adds ~12 integer instructions of hash
// per score. Which of the mma.sync rate and the per-score work bounds it has
// not been measured; alibi_attention_serve.cu's wgmma design, with the lse
// and the dropout added, is the lever for a later change.
#include "common.cuh"

namespace a2v {
namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;           // query rows per block (4 warps x 16)
constexpr int kBK = 64;           // keys per tile
constexpr int kLds = kD + 8;      // padded shared row: conflict-free 32-bit reads
constexpr int kThreads = 128;
constexpr float kMaskScore = -1e9f;  // NEG_INF of the TPU kernel

using bf16 = __nv_bfloat16;

// Runtime arguments of a launch beyond the tensors.
struct FwdArgs {
  int mask_per_row;
  int B, H, T;
  float sm_scale;
  uint32_t seed;        // dropout seed (int32 bits)
  uint32_t thresh;      // keep when hash >= thresh; 0 = no dropout
  float keep_scale;     // 1 / (1 - rate)
};

template <bool UNIFORM_POS, bool HAS_MASK, bool HAS_SENTINEL>
__global__ void __launch_bounds__(kThreads)
alibi_attention_kernel(const bf16* __restrict__ qkv,      // (3, B, H, T, D)
                       const float* __restrict__ slopes,  // (H,)
                       const int* __restrict__ pos,       // (1 or B, T)
                       const uint8_t* __restrict__ mask,  // (1 or B, T), 1 = padded key
                       bf16* __restrict__ out,            // (B, H, T, D)
                       float* __restrict__ lse,           // null or (B*H, T)
                       FwdArgs a) {
  const int B = a.B, H = a.H, T = a.T;
  const float sm_scale = a.sm_scale;
  __shared__ __align__(16) bf16 sQ[kBQ * kLds];
  __shared__ __align__(16) bf16 sK[kBK * kLds];
  __shared__ __align__(16) bf16 sV[kBK * kLds];
  __shared__ float sPosK[kBK];
  __shared__ int sFlagK[kBK];  // 0 = live key, 1 = padded, 2 = past T

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;

  const size_t head = static_cast<size_t>(T) * kD;
  const size_t plane = static_cast<size_t>(B) * H * head;
  const bf16* q = qkv + (static_cast<size_t>(b) * H + h) * head;
  const bf16* k = q + plane;
  const bf16* v = k + plane;
  const int* posr = pos + (UNIFORM_POS ? 0 : static_cast<size_t>(b) * T);
  const uint8_t* maskr =
      HAS_MASK ? mask + (a.mask_per_row ? static_cast<size_t>(b) * T : 0) : nullptr;
  const uint32_t seed_word = a.seed + static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du;
  const bool drop = a.thresh != 0u;

  for (int c = tid; c < kBQ * kD / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8, row = q0 + r;
    cp_async_16(&sQ[r * kLds + col], q + static_cast<size_t>(row < T ? row : 0) * kD + col,
                row < T);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * i4;
    qf[kk][0] = ld_u32(&sQ[r0 * kLds + c]);
    qf[kk][1] = ld_u32(&sQ[(r0 + 8) * kLds + c]);
    qf[kk][2] = ld_u32(&sQ[r0 * kLds + c + 8]);
    qf[kk][3] = ld_u32(&sQ[(r0 + 8) * kLds + c + 8]);
  }
  const float pq[2] = {q0 + r0 < T ? static_cast<float>(posr[q0 + r0]) : 0.f,
                       q0 + r0 + 8 < T ? static_cast<float>(posr[q0 + r0 + 8]) : 0.f};
  const float slope = slopes[h];

  float m[2] = {kMaskScore, kMaskScore};
  float l[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  const int n_tiles = (T + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBK * kD / 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 8, key = k0 + r;
      const size_t src = static_cast<size_t>(key < T ? key : 0) * kD + col;
      cp_async_16(&sK[r * kLds + col], k + src, key < T);
      cp_async_16(&sV[r * kLds + col], v + src, key < T);
    }
    cp_async_commit();
    if (tid < kBK) {
      const int key = k0 + tid;
      const bool live = key < T;
      sPosK[tid] = live ? static_cast<float>(posr[key]) : 0.f;
      sFlagK[tid] = !live ? 2 : ((HAS_MASK && maskr[key]) ? 1 : 0);
    }
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = &sK[(j * 8 + g) * kLds + 2 * i4];
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t bk[2] = {ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8)};
        mma_16816(s[j], qf[kk], bk);
      }
    }

    // scale + ALiBi bias + key mask, then the running row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * i4 + (e & 1);
        const float pk = sPosK[col];
        const int flag = sFlagK[col];
        const float pqe = pq[e >> 1];
        float dist = fabsf(pqe - pk);
        if (HAS_SENTINEL && (pqe < 0.f || pk < 0.f)) dist = 0.f;
        float x = s[j][e] * sm_scale - slope * dist;
        x = flag == 0 ? x : (flag == 1 ? kMaskScore : -INFINITY);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
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
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;  // denominator from the fp32, undropped weights
        if (drop)
          p *= drop_factor(seed_word, q0 + r0 + 8 * (e >> 1), k0 + j * 8 + 2 * i4 + (e & 1),
                           a.thresh, a.keep_scale);
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 form the A
    // operand of k-step kk; ldmatrix.trans gives V's B operands for two
    // d-tiles at a time.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int tile = lane >> 3;
      const int key = kk * 16 + (tile & 1) * 8 + (lane & 7);
#pragma unroll
      for (int dn = 0; dn < kD / 8; dn += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &sV[key * kLds + (dn + (tile >> 1)) * 8]);
        mma_16816(o[dn], pa, bv);
        mma_16816(o[dn + 1], pa, bv + 2);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* orow = out + (static_cast<size_t>(b) * H + h) * head;
  const int row0 = q0 + r0, row1 = q0 + r0 + 8;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * i4;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(&orow[static_cast<size_t>(row0) * kD + col]) =
          pack_bf16(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(&orow[static_cast<size_t>(row1) * kD + col]) =
          pack_bf16(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
  if (lse != nullptr && i4 == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * T;
    if (row0 < T) lrow[row0] = m[0] + logf(l[0]);
    if (row1 < T) lrow[row1] = m[1] + logf(l[1]);
  }
}

template <bool UNIFORM_POS, bool HAS_MASK>
void launch_sentinel(bool has_sentinel, dim3 grid, cudaStream_t stream, const bf16* qkv,
                     const float* slopes, const int* pos, const uint8_t* mask, bf16* out,
                     float* lse, const FwdArgs& a) {
  if (has_sentinel)
    alibi_attention_kernel<UNIFORM_POS, HAS_MASK, true>
        <<<grid, kThreads, 0, stream>>>(qkv, slopes, pos, mask, out, lse, a);
  else
    alibi_attention_kernel<UNIFORM_POS, HAS_MASK, false>
        <<<grid, kThreads, 0, stream>>>(qkv, slopes, pos, mask, out, lse, a);
}

template <bool UNIFORM_POS>
void launch_mask(bool has_mask, bool has_sentinel, dim3 grid, cudaStream_t stream,
                 const bf16* qkv, const float* slopes, const int* pos, const uint8_t* mask,
                 bf16* out, float* lse, const FwdArgs& a) {
  if (has_mask)
    launch_sentinel<UNIFORM_POS, true>(has_sentinel, grid, stream, qkv, slopes, pos, mask, out,
                                       lse, a);
  else
    launch_sentinel<UNIFORM_POS, false>(has_sentinel, grid, stream, qkv, slopes, pos, mask, out,
                                        lse, a);
}

}  // namespace
}  // namespace a2v

// C entry, bound with ctypes. positions are (pos_per_row ? B : 1, T) int32;
// mask is null or (mask_per_row ? B : 1, T) uint8. lse is null or (B*H, T)
// fp32; a launch needs an lse or a nonzero dropout threshold (serving
// launches, with neither, go to a2v_alibi_attention_serve). Returns a
// cudaError_t.
extern "C" int a2v_alibi_attention(const void* qkv, const void* slopes, const void* pos,
                                   int pos_per_row, const void* mask, int mask_per_row,
                                   void* out, void* lse, int B, int H, int T, int D,
                                   int has_sentinel, float sm_scale, int seed,
                                   unsigned int thresh, float keep_scale, void* stream) {
  using namespace a2v;
  if (D != kD || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      (lse == nullptr && thresh == 0u))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* sl = static_cast<const float*>(slopes);
  const auto* p = static_cast<const int*>(pos);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<bf16*>(out);
  auto* ls = static_cast<float*>(lse);
  const FwdArgs a{mask_per_row, B, H, T, sm_scale, static_cast<uint32_t>(seed), thresh,
                  keep_scale};
  if (pos_per_row)
    launch_mask<false>(mk != nullptr, has_sentinel != 0, grid, s, q, sl, p, mk, o, ls, a);
  else
    launch_mask<true>(mk != nullptr, has_sentinel != 0, grid, s, q, sl, p, mk, o, ls, a);
  return static_cast<int>(cudaGetLastError());
}
