// int8 ALiBi flash-attention forward of serving, D = 64, bf16 out.
//
// Replaces the TPU kernel animal2vec_tpu/ops/pallas_attention.py:_kernel_q8
// (wrapper alibi_flash_attention_int8). The wrapper (ops/attention.py)
// quantizes q and k per row over D (D^-0.5 folded into q's scale) and v per
// channel over T with torch ops, as the JAX wrapper does with XLA ops. Over
// each span of `span` keys (the TPU kernel's key block, 2048 at most):
//
//   s  = fp32(q8 . k8) * qs * ks - slope * |pos_i - pos_j|  (0 at sentinels)
//   s  = -1e9 at padded keys and at keys in [T, t_pad)
//   m' = max(m, max over the span of s);  p = exp(s - m')
//   l  = exp(m - m') l + sum p                         (unquantized fp32 p)
//   acc = exp(m - m') acc + fp32(rint(127 p) . v8) * vs / 127
//
// and out = bf16(acc / max(l, 1e-30)), with m starting at -1e9. P is
// quantized against the running max of the whole span, as on the TPU, where
// a span is one grid step: so each span is walked twice in 64-key tiles,
// first for its row max (one extra int8 Q.K^T pass), then for P and P.V.
// Keys in [T, t_pad) are the TPU wrapper's padding: masked, with zero v, so
// a row whose every key is padded averages V over t_pad keys and stays
// finite.
//
// Design: one thread block per (64-query tile, head, batch), four warps of
// 16 query rows. Q's int8 fragments stay in registers; K tiles (64 keys x
// 64 B) and V tiles (64 channels x 64 keys, from the wrapper's transposed
// (B, H, D, T) v8) are staged in shared memory by cp.async. Both products
// are mma.sync m16n8k32 (int8 in, int32 accumulate, exact). The S
// accumulator is not the A layout of the P.V product, but the order of the
// 32 keys of a k-step is free: P's A fragment takes, for thread (g, i), the
// keys 2i, 2i+1, 8+2i, 9+2i (and +16), which it already holds, and V's B
// fragment reads the same keys as two 16-bit pairs from the transposed V
// tile. The int32 P.V sum spans a whole span (127 x 127 x 2048 < 2^31) and
// is folded into fp32 once per span, in the TPU kernel's order. q, k and
// the output keep the (B, T, H, D) layout of the projections: no permute.
//
// Bound on the H100 at the serving shape (B = 32, H = 16, T = 2000): the two
// products are 4*B*H*T^2*D = 0.52 TOP of int8 work, 0.26 ms at the 1,979
// TOP/s int8 peak, above the 0.52 GB of bf16 q, k, v and out (0.16 ms at
// 3.35 TB/s). The design does a third int8 product (the row-max pass) and
// ~15 fp32 and integer instructions per score twice (dequant, bias, mask,
// exp, rint), which the bf16 kernel's per-score cost suggests will bound it
// well above that; wgmma and one pass with a P rescale per tile (which
// changes the rounding, unlike the TPU kernel) are for a later change.
#include "common.cuh"

namespace a2v {
namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;           // query rows per block (4 warps x 16)
constexpr int kBK = 64;           // keys per tile
constexpr int kLds = kD + 16;     // padded shared row (80 B): conflict-free fragment reads
constexpr int kThreads = 128;
constexpr float kMaskScore = -1e9f;  // NEG_INF of the TPU kernel

using bf16 = __nv_bfloat16;

struct Int8Args {
  int pos_per_row, mask_per_row, has_sentinel;
  int B, H, T;
  int Tv;     // row length of v8t (T rounded up to 16)
  int t_pad;  // keys walked: a multiple of span
  int span;   // keys per P quantization (a multiple of 64)
};

__device__ __forceinline__ uint32_t ld_u16(const int8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
alibi_attention_int8_kernel(const int8_t* __restrict__ q8,   // (B, T, H, D)
                            const float* __restrict__ qs,    // (B, T, H)
                            const int8_t* __restrict__ k8,   // (B, T, H, D)
                            const float* __restrict__ ks,    // (B, T, H)
                            const int8_t* __restrict__ v8t,  // (B, H, D, Tv)
                            const float* __restrict__ vsc,   // (B, H, D): vs / 127
                            const float* __restrict__ slopes,  // (H,)
                            const int* __restrict__ pos,     // (1 or B, T)
                            const uint8_t* __restrict__ mask,  // null or (1 or B, T)
                            bf16* __restrict__ out,          // (B, T, H, D)
                            Int8Args a) {
  const int H = a.H, T = a.T;
  __shared__ __align__(16) int8_t sQ[kBQ * kLds];
  __shared__ __align__(16) int8_t sK[kBK * kLds];
  __shared__ __align__(16) int8_t sV[kD * kLds];  // row = channel, 64 keys
  __shared__ float sKs[kBK];
  __shared__ float sPosK[kBK];
  __shared__ int sMaskK[kBK];  // 1 = padded key or past T

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;

  const size_t row_stride = static_cast<size_t>(H) * kD;  // bytes between tokens
  const size_t head0 = static_cast<size_t>(b) * T * H + h;  // token 0 of (b, h)
  const int8_t* qb = q8 + head0 * kD;
  const int8_t* kb = k8 + head0 * kD;
  const float* qsb = qs + head0;
  const float* ksb = ks + head0;
  const int8_t* vb = v8t + (static_cast<size_t>(b) * H + h) * kD * a.Tv;
  const float* vscb = vsc + (static_cast<size_t>(b) * H + h) * kD;
  const int* posr = pos + (a.pos_per_row ? static_cast<size_t>(b) * T : 0);
  const uint8_t* maskr =
      mask == nullptr ? nullptr : mask + (a.mask_per_row ? static_cast<size_t>(b) * T : 0);

  for (int c = tid; c < kBQ * kD / 16; c += kThreads) {
    const int r = c >> 2, col = (c & 3) * 16, row = q0 + r;
    cp_async_16(&sQ[r * kLds + col], qb + static_cast<size_t>(row < T ? row : 0) * row_stride + col,
                row < T);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[kD / 32][4];
#pragma unroll
  for (int kk = 0; kk < kD / 32; ++kk) {
    const int c = kk * 32 + 4 * i4;
    qf[kk][0] = ld_s8x4(&sQ[r0 * kLds + c]);
    qf[kk][1] = ld_s8x4(&sQ[(r0 + 8) * kLds + c]);
    qf[kk][2] = ld_s8x4(&sQ[r0 * kLds + c + 16]);
    qf[kk][3] = ld_s8x4(&sQ[(r0 + 8) * kLds + c + 16]);
  }
  const int rows[2] = {q0 + r0, q0 + r0 + 8};
  float qsr[2], pq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qsr[r] = rows[r] < T ? qsb[static_cast<size_t>(rows[r]) * H] : 0.f;
    pq[r] = rows[r] < T ? static_cast<float>(posr[rows[r]]) : 0.f;
  }
  const float neg_slope = -slopes[h];
  float vscale[kD / 8][2];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    vscale[dn][0] = vscb[dn * 8 + 2 * i4];
    vscale[dn][1] = vscb[dn * 8 + 2 * i4 + 1];
  }

  // Stage the 64 keys from k0 (K, and V when with_v) and their scales,
  // positions and mask flags.
  auto load_keys = [&](int k0, bool with_v) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBK * kD / 16; c += kThreads) {
      const int r = c >> 2, col = (c & 3) * 16, key = k0 + r;
      cp_async_16(&sK[r * kLds + col],
                  kb + static_cast<size_t>(key < T ? key : 0) * row_stride + col, key < T);
      if (with_v) {  // r is a channel here, col the tile's key offset
        const int vkey = k0 + col;
        cp_async_16(&sV[r * kLds + col],
                    vb + static_cast<size_t>(r) * a.Tv + (vkey < a.Tv ? vkey : 0), vkey < a.Tv);
      }
    }
    cp_async_commit();
    if (tid < kBK) {
      const int key = k0 + tid;
      const bool live = key < T;
      sKs[tid] = live ? ksb[static_cast<size_t>(key) * H] : 0.f;
      sPosK[tid] = live ? static_cast<float>(posr[key]) : 0.f;
      sMaskK[tid] = !live || (maskr != nullptr && maskr[key] != 0);
    }
    cp_async_wait<0>();
    __syncthreads();
  };

  // Scores of this warp's 16 rows x the staged 64 keys (8 n-tiles of 8).
  auto scores = [&](float (&s)[kBK / 8][4]) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* krow = &sK[(j * 8 + g) * kLds + 4 * i4];
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) {
        const uint32_t bk[2] = {ld_s8x4(krow + kk * 32), ld_s8x4(krow + kk * 32 + 16)};
        mma_s8_16832(acc, qf[kk], bk);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * i4 + (e & 1);
        const float pk = sPosK[col];
        const float pqe = pq[e >> 1];
        float dist = fabsf(pqe - pk);
        if (a.has_sentinel && (pqe < 0.f || pk < 0.f)) dist = 0.f;
        const float x = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[e]), qsr[e >> 1]),
                                            sKs[col]),
                                  __fmul_rn(neg_slope, dist));
        s[j][e] = sMaskK[col] ? kMaskScore : x;
      }
    }
  };

  float m[2] = {kMaskScore, kMaskScore};
  float l[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int s0 = 0; s0 < a.t_pad; s0 += a.span) {
    // pass 1: the span's row max
    float mx[2] = {-INFINITY, -INFINITY};
    for (int k0 = s0; k0 < s0 + a.span; k0 += kBK) {
      load_keys(k0, false);
      float s[kBK / 8][4];
      scores(s);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new[r]);
    }

    // pass 2: p, its int8 quantization, and P.V
    int pv[kD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) pv[dn][0] = pv[dn][1] = pv[dn][2] = pv[dn][3] = 0;
    float lsum[2] = {0.f, 0.f};
    for (int k0 = s0; k0 < s0 + a.span; k0 += kBK) {
      load_keys(k0, true);
      float s[kBK / 8][4];
      scores(s);
      int p8[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_new[e >> 1]);
          lsum[e >> 1] += p;
          p8[j][e] = __float2int_rn(p * 127.f);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        const int j = 4 * kk;  // n-tiles j..j+3 hold the k-step's 32 keys
        const uint32_t pa[4] = {
            pack_s8x4(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]),
            pack_s8x4(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]),
            pack_s8x4(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]),
            pack_s8x4(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3])};
#pragma unroll
        for (int dn = 0; dn < kD / 8; ++dn) {
          const int8_t* vrow = &sV[(dn * 8 + g) * kLds + kk * 32 + 2 * i4];
          const uint32_t bv[2] = {ld_u16(vrow) | (ld_u16(vrow + 8) << 16),
                                  ld_u16(vrow + 16) | (ld_u16(vrow + 24) << 16)};
          mma_s8_16832(pv[dn], pa, bv);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), lsum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dn][e] = __fadd_rn(__fmul_rn(o[dn][e], alpha[e >> 1]),
                             __fmul_rn(__int2float_rn(pv[dn][e]), vscale[dn][e & 1]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    bf16* orow = out + (static_cast<size_t>(b) * T + rows[r]) * row_stride + static_cast<size_t>(h) * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<uint32_t*>(&orow[dn * 8 + 2 * i4]) =
          pack_bf16(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
  }
}

}  // namespace
}  // namespace a2v

// C entry, bound with ctypes. q8, k8 (B, T, H, D) int8 and qs, ks (B, T, H)
// fp32; v8t (B, H, D, Tv) int8, zero past T; vsc (B, H, D) fp32 (vs / 127);
// positions (pos_per_row ? B : 1, T) int32; mask null or (mask_per_row ? B :
// 1, T) uint8; out (B, T, H, D) bf16. Returns a cudaError_t.
extern "C" int a2v_alibi_attention_int8(const void* q8, const void* qs, const void* k8,
                                        const void* ks, const void* v8t, const void* vsc,
                                        const void* slopes, const void* pos, int pos_per_row,
                                        const void* mask, int mask_per_row, void* out, int B,
                                        int H, int T, int D, int Tv, int t_pad, int span,
                                        int has_sentinel, void* stream) {
  using namespace a2v;
  if (D != kD || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 || Tv < T ||
      Tv % 16 != 0 || span <= 0 || span % kBK != 0 || t_pad < T || t_pad % span != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Int8Args a{pos_per_row, mask_per_row, has_sentinel, B, H, T, Tv, t_pad, span};
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  alibi_attention_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k8), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v8t), static_cast<const float*>(vsc),
      static_cast<const float*>(slopes), static_cast<const int*>(pos),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), a);
  return static_cast<int>(cudaGetLastError());
}
