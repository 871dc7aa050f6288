// Flash-attention forward with a dense additive bias, bf16 in and out, D = 64.
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
// of V over the T keys, as xla_attention's softmax does.
//
// Design: one thread block per (64-query tile, head, batch) with four warps,
// each owning 16 query rows, as alibi_attention.cu. q, k and v are read in
// place from (B, T, H, D) views with any batch and time strides (the model
// hands over the q, k, v thirds of its (B, T, 3, H, D) projection): a head's
// row is 128 contiguous bytes, so the tiles still arrive as 16-byte cp.async
// chunks and no packed copy of qkv is made. K/V tiles of 64 keys are staged
// in shared memory; S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate); P stays in registers between the two products; V's B
// operand comes out of shared memory by ldmatrix.trans. Each thread reads the
// fp32 bias of its own scores straight from device memory (a (1, H, T, T)
// bias of the image serving shape is 1.8 MB and stays in L2); a batch-uniform
// bias is read with batch stride 0. Keys past T (196 is not a multiple of 64)
// are dropped by bounds. The output is written as (B, T, H, D), the out
// projection's (B, T, C) input.
//
// Bound on the H100 at the image serving shape (B = 64, H = 12, T = 196):
// the two products are 7.6 GFLOP (8 us at the bf16 peak) against 77 MB of
// q, k, v and out (23 us at 3.35 TB/s): bound by bytes, and short: the
// launch and the first tiles' latency weigh as much as either. Which of the
// fp32 per-score work and the mma.sync rate bounds it at T 1024 has not been
// measured; wgmma and a double-buffered K/V pipeline are the levers.
#include "common.cuh"

namespace a2v {
namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;           // query rows per block (4 warps x 16)
constexpr int kBK = 64;           // keys per tile
constexpr int kLds = kD + 8;      // padded shared row: conflict-free 32-bit reads
constexpr int kThreads = 128;
constexpr float kMasked = -1e10f;  // NEG_INF of models/attention.py

using bf16 = __nv_bfloat16;

struct BiasArgs {
  long long stride_b;  // elements between batch rows of q, k and v
  long long stride_t;  // elements between time rows
  int H, T;
  float sm_scale;
};

template <bool HAS_BIAS, bool UNIFORM_BIAS, bool HAS_MASK>
__global__ void __launch_bounds__(kThreads)
bias_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,    // (1 or B, H, T, T)
                      const uint8_t* __restrict__ mask,  // (B, T), 1 = padded key
                      bf16* __restrict__ out,            // (B, T, H, D)
                      float* __restrict__ lse,           // null or (B*H, T)
                      BiasArgs a) {
  const int H = a.H, T = a.T;
  __shared__ __align__(16) bf16 sQ[kBQ * kLds];
  __shared__ __align__(16) bf16 sK[kBK * kLds];
  __shared__ __align__(16) bf16 sV[kBK * kLds];
  __shared__ int sFlagK[kBK];  // 0 = live key, 1 = padded, 2 = past T

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;

  const long long head = static_cast<long long>(b) * a.stride_b + static_cast<long long>(h) * kD;
  const bf16* qb = q + head;
  const bf16* kb = k + head;
  const bf16* vb = v + head;
  const uint8_t* mrow = HAS_MASK ? mask + static_cast<size_t>(b) * T : nullptr;

  for (int c = tid; c < kBQ * kD / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8, row = q0 + r;
    cp_async_16(&sQ[r * kLds + col],
                qb + static_cast<long long>(row < T ? row : 0) * a.stride_t + col, row < T);
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
  const int row0 = q0 + r0, row1 = row0 + 8;
  // this thread's two bias rows (null past T: those rows are not stored)
  const float* brow[2] = {nullptr, nullptr};
  if (HAS_BIAS) {
    const float* plane =
        bias + (static_cast<size_t>(UNIFORM_BIAS ? 0 : b) * H + h) * static_cast<size_t>(T) * T;
    if (row0 < T) brow[0] = plane + static_cast<size_t>(row0) * T;
    if (row1 < T) brow[1] = plane + static_cast<size_t>(row1) * T;
  }

  float m[2] = {kMasked, kMasked};
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
      const long long src = static_cast<long long>(key < T ? key : 0) * a.stride_t + col;
      cp_async_16(&sK[r * kLds + col], kb + src, key < T);
      cp_async_16(&sV[r * kLds + col], vb + src, key < T);
    }
    cp_async_commit();
    if (tid < kBK) {
      const int key = k0 + tid;
      sFlagK[tid] = key >= T ? 2 : ((HAS_MASK && mrow[key]) ? 1 : 0);
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

    // scale + bias, then the key mask, then the running row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * i4 + (e & 1);
        const int flag = sFlagK[col];
        float x = s[j][e] * a.sm_scale;
        if (HAS_BIAS && flag != 2 && brow[e >> 1] != nullptr) x += __ldg(brow[e >> 1] + k0 + col);
        x = flag == 0 ? x : (flag == 1 ? kMasked : -INFINITY);
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
        const float p = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
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

  // the row max contributes exp(0) = 1, so l >= 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (lse != nullptr && i4 == 0) {  // the backward's logsumexp, m + log l
    const size_t bh = static_cast<size_t>(b) * H + h;
    if (row0 < T) lse[bh * T + row0] = m[0] + logf(l[0]);
    if (row1 < T) lse[bh * T + row1] = m[1] + logf(l[1]);
  }
  const size_t row_stride = static_cast<size_t>(H) * kD;
  bf16* ob = out + static_cast<size_t>(b) * T * row_stride + static_cast<size_t>(h) * kD;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * i4;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row0) * row_stride + col]) =
          pack_bf16(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row1) * row_stride + col]) =
          pack_bf16(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
}

template <bool HAS_BIAS, bool UNIFORM_BIAS>
void launch_mask(bool has_mask, dim3 grid, cudaStream_t s, const bf16* q, const bf16* k,
                 const bf16* v, const float* bias, const uint8_t* mask, bf16* out, float* lse,
                 const BiasArgs& a) {
  if (has_mask)
    bias_attention_kernel<HAS_BIAS, UNIFORM_BIAS, true><<<grid, kThreads, 0, s>>>(
        q, k, v, bias, mask, out, lse, a);
  else
    bias_attention_kernel<HAS_BIAS, UNIFORM_BIAS, false><<<grid, kThreads, 0, s>>>(
        q, k, v, bias, mask, out, lse, a);
}

}  // namespace
}  // namespace a2v

// C entry, bound with ctypes. q, k, v: bf16 (B, T, H, D) with element
// strides (stride_b, stride_t, D, 1), 16-byte aligned, strides multiples of
// 8; bias null or fp32 (bias_uniform ? 1 : B, H, T, T) contiguous; mask null
// or (B, T) uint8; out (B, T, H, D) bf16 contiguous; lse null (serving) or
// (B*H, T) fp32, the logsumexp of each score row for the backward
// (bias_attention_bwd.cu). Returns a cudaError_t.
extern "C" int a2v_bias_attention(const void* q, const void* k, const void* v,
                                  long long stride_b, long long stride_t, const void* bias,
                                  int bias_uniform, const void* mask, void* out, void* lse,
                                  int B, int H, int T, int D, float sm_scale, void* stream) {
  using namespace a2v;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (D != kD || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 || stride_b % 8 != 0 ||
      stride_t % 8 != 0 || misaligned(q) || misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<bf16*>(out);
  auto* lp = static_cast<float*>(lse);
  const BiasArgs a{stride_b, stride_t, H, T, sm_scale};
  const bool has_mask = mp != nullptr;
  if (bp == nullptr)
    launch_mask<false, false>(has_mask, grid, s, qp, kp, vp, bp, mp, op, lp, a);
  else if (bias_uniform)
    launch_mask<true, true>(has_mask, grid, s, qp, kp, vp, bp, mp, op, lp, a);
  else
    launch_mask<true, false>(has_mask, grid, s, qp, kp, vp, bp, mp, op, lp, a);
  return static_cast<int>(cudaGetLastError());
}
