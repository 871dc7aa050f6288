// ALiBi flash-attention backward, bf16 in and out, D = 64: two kernels.
//
// Replaces the TPU kernels animal2vec_tpu/ops/pallas_attention.py:
//   _bwd_dq_kernel  -> alibi_attention_dq_kernel: dq and the per-(b, h,
//                      query tile) partial of the slope gradient;
//   _bwd_dkv_kernel -> alibi_attention_dkv_kernel: dk and dv.
//
// With s = q.k / sqrt(D) + bias, P = exp(s - lse) (lse from the forward),
// f = keep / (1 - r) the forward's dropout factor (regenerated from the hash
// of (seed + (b*H+h) * 0xC2B2AE3D, query, key)), dP = dO . V^T and
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
// Design: both kernels keep the forward kernel's layout
// (alibi_attention.cu): four warps of 16 rows,
// 64-row tiles staged in shared memory with cp.async, mma.sync m16n8k16 with
// fp32 accumulation, and the fp32 accumulator of one product reused in
// registers as the bf16 A operand of the next (the accumulator layout is the
// A-operand layout). The dq kernel owns 64 query rows and loops over key
// tiles: S = Q K^T and dP = dO V^T from row fragments of K and V, then
// dq += dS K with K's B operand from ldmatrix.trans. The dk/dv kernel owns
// 64 keys and loops over query tiles in the transposed formulation: S^T =
// K Q^T and dP^T = V dO^T with K and V as the A operands, so that (P f)^T
// and dS^T come out in the A layout of dv += (P f)^T dO and dk += dS^T Q,
// whose B operands are dO and Q through ldmatrix.trans. Nothing is staged
// through shared memory between products and no atomics are used: the slope
// gradient is reduced inside each block (quad shuffles for the row sums,
// then warp shuffles and shared memory) to one fp32 partial per (b, h,
// query tile), and torch sums the partials (deterministic).
//
// Bound on the H100 at the training shape (B=4, H=16, T=2000): the dq kernel
// does 3 products of 2*T^2*D per (b, h), 6*B*H*T^2*D = 98 GFLOP (0.10 ms at
// the 989 TFLOP/s bf16 peak); the dk/dv kernel 4 products, 131 GFLOP
// (0.13 ms); each reads q, k, v, dO (4 x 16 MB) and writes 16 or 32 MB, a
// few microseconds at 3.35 TB/s. Both are bound by operations; besides the
// products each recomputes the bias, the exponential and the dropout hash
// per score (~25 fp32/integer instructions), which mma.sync does not hide.
// wgmma and a deeper K/V (or Q/dO) pipeline are the levers for a later
// change.
#include "flash_bwd_tiles.cuh"

namespace a2v {
namespace {

using namespace flash_bwd;

constexpr float kDeadLse = -5e8f;  // lse below this: every key of the row padded

struct BwdArgs {
  int pos_per_row, mask_per_row, has_sentinel;
  int B, H, T;
  float sm_scale;
  uint32_t seed;     // dropout seed (int32 bits)
  uint32_t thresh;   // keep when hash >= thresh; 0 = no dropout
  float keep_scale;  // 1 / (1 - rate)
};

// rows of one (T, D) head plane
__device__ __forceinline__ void stage_tile(bf16* smem, const bf16* src, int row0, int T,
                                           int tid) {
  stage_rows(smem, src, kD, row0, T, tid);
}

__device__ __forceinline__ float alibi_dist(float pq, float pk, bool sentinel) {
  return (sentinel && (pq < 0.f || pk < 0.f)) ? 0.f : fabsf(pq - pk);
}

// One block per (64-query tile, head, batch): dq rows and the block's
// slope-gradient partial.
__global__ void __launch_bounds__(kThreads)
alibi_attention_dq_kernel(const bf16* __restrict__ qkv,     // (3, B, H, T, D)
                          const bf16* __restrict__ dout,    // (B, H, T, D)
                          const float* __restrict__ lse,    // (B*H, T)
                          const float* __restrict__ delta,  // (B*H, T)
                          const float* __restrict__ slopes, // (H,)
                          const int* __restrict__ pos,      // (1 or B, T)
                          const uint8_t* __restrict__ mask, // null or (1 or B, T)
                          bf16* __restrict__ dq,            // (B, H, T, D)
                          float* __restrict__ dslope_part,  // (B, H, n_qtiles)
                          BwdArgs a) {
  __shared__ __align__(16) bf16 sQ[kTile * kLds];
  __shared__ __align__(16) bf16 sDO[kTile * kLds];
  __shared__ __align__(16) bf16 sK[kTile * kLds];
  __shared__ __align__(16) bf16 sV[kTile * kLds];
  __shared__ float sPosK[kTile];
  __shared__ int sFlagK[kTile];  // 0 = live key, 1 = padded, 2 = past T
  __shared__ float sRed[kThreads / 32];

  const int T = a.T, H = a.H;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = static_cast<size_t>(T) * kD;
  const size_t plane = static_cast<size_t>(a.B) * H * head;
  const bf16* q = qkv + bh * head;
  const bf16* k = q + plane;
  const bf16* v = k + plane;
  const int* posr = pos + (a.pos_per_row ? static_cast<size_t>(b) * T : 0);
  const uint8_t* maskr = mask ? mask + (a.mask_per_row ? static_cast<size_t>(b) * T : 0) : nullptr;
  const uint32_t seed_word = a.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
  const bool drop = a.thresh != 0u;
  const bool sentinel = a.has_sentinel != 0;

  stage_tile(sQ, q, q0, T, tid);
  stage_tile(sDO, dout + bh * head, q0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qf[kD / 16][4], dof[kD / 16][4];
  row_fragments(qf, sQ, r0, i4);
  row_fragments(dof, sDO, r0, i4);
  float pq[2], lse_r[2], delta_r[2];
  int rflag[2];  // 0 = live row, 1 = every key padded, 2 = past T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const bool in = row < T;
    pq[r] = in ? static_cast<float>(posr[row]) : 0.f;
    lse_r[r] = in ? lse[bh * T + row] : 0.f;
    delta_r[r] = in ? delta[bh * T + row] : 0.f;
    rflag[r] = !in ? 2 : (lse_r[r] < kDeadLse ? 1 : 0);
  }
  const float slope = slopes[h];

  float acc_dq[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
    acc_dq[dn][0] = acc_dq[dn][1] = acc_dq[dn][2] = acc_dq[dn][3] = 0.f;
  // per-row sums over this thread's keys for the slope gradient:
  // sum P f dP dist, sum P dist and sum P f dP (the in-kernel delta)
  float a_pd[2] = {0.f, 0.f}, b_pd[2] = {0.f, 0.f}, d_pd[2] = {0.f, 0.f};

  const int n_tiles = (T + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(sK, k, k0, T, tid);
    stage_tile(sV, v, k0, T, tid);
    cp_async_commit();
    if (tid < kTile) {
      const int key = k0 + tid;
      const bool live = key < T;
      sPosK[tid] = live ? static_cast<float>(posr[key]) : 0.f;
      sFlagK[tid] = !live ? 2 : ((maskr && maskr[key]) ? 1 : 0);
    }
    cp_async_wait<0>();
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    rows_product(s, qf, sK, g, i4);    // Q K^T
    rows_product(dp, dof, sV, g, i4);  // dO V^T
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + 2 * i4 + (e & 1);
        const int kflag = sFlagK[col];
        const float dist = alibi_dist(pq[r], sPosK[col], sentinel);
        float p = 0.f;  // only live keys reach dS
        if (kflag == 0 && rflag[r] != 2)
          p = expf(s[j][e] * a.sm_scale - slope * dist - lse_r[r]);
        float dpv = dp[j][e];
        if (drop)
          dpv *= drop_factor(seed_word, q0 + r0 + 8 * r, k0 + col, a.thresh, a.keep_scale);
        const float ds = kflag == 0 ? p * (dpv - delta_r[r]) : 0.f;
        const float pdp = p * dpv;  // p is 0 unless the key is live
        a_pd[r] += pdp * dist;
        b_pd[r] += p * dist;
        d_pd[r] += pdp;
        s[j][e] = ds;
      }
    }
    acc_times_tile(acc_dq, s, sK, lane);  // dq += dS K
  }

  store_rows(dq + bh * head, kD, acc_dq, q0 + r0, q0 + r0 + 8, T, a.sm_scale, i4);

  // row totals over the quad of lanes that share a row, then
  // -sum_j dS dist = -(sum P f dP dist - D * sum P dist) per row
  float dsl = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      a_pd[r] += __shfl_xor_sync(0xffffffffu, a_pd[r], off);
      b_pd[r] += __shfl_xor_sync(0xffffffffu, b_pd[r], off);
      d_pd[r] += __shfl_xor_sync(0xffffffffu, d_pd[r], off);
    }
    if (i4 == 0) dsl -= a_pd[r] - d_pd[r] * b_pd[r];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dsl += __shfl_xor_sync(0xffffffffu, dsl, off);
  if (lane == 0) sRed[warp] = dsl;
  __syncthreads();
  if (tid == 0)
    dslope_part[bh * gridDim.x + blockIdx.x] = sRed[0] + sRed[1] + sRed[2] + sRed[3];
}

// One block per (64-key tile, head, batch): dk and dv rows.
__global__ void __launch_bounds__(kThreads)
alibi_attention_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ slopes, const int* __restrict__ pos,
                           const uint8_t* __restrict__ mask,
                           bf16* __restrict__ dk,  // (B, H, T, D)
                           bf16* __restrict__ dv,  // (B, H, T, D)
                           BwdArgs a) {
  __shared__ __align__(16) bf16 sQ[kTile * kLds];   // K first, then Q tiles
  __shared__ __align__(16) bf16 sDO[kTile * kLds];  // V first, then dO tiles
  __shared__ float sPosQ[kTile], sLse[kTile], sDelta[kTile];
  __shared__ int sFlagQ[kTile];  // 0 = live row, 1 = every key padded, 2 = past T

  const int T = a.T, H = a.H;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = static_cast<size_t>(T) * kD;
  const size_t plane = static_cast<size_t>(a.B) * H * head;
  const bf16* q = qkv + bh * head;
  const bf16* k = q + plane;
  const bf16* v = k + plane;
  const bf16* dor = dout + bh * head;
  const int* posr = pos + (a.pos_per_row ? static_cast<size_t>(b) * T : 0);
  const uint8_t* maskr = mask ? mask + (a.mask_per_row ? static_cast<size_t>(b) * T : 0) : nullptr;
  const uint32_t seed_word = a.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
  const bool drop = a.thresh != 0u;
  const bool sentinel = a.has_sentinel != 0;
  const float inv_t = 1.f / T;

  // this warp's 16 keys as A operands
  stage_tile(sQ, k, k0, T, tid);
  stage_tile(sDO, v, k0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t kf[kD / 16][4], vf[kD / 16][4];
  row_fragments(kf, sQ, r0, i4);
  row_fragments(vf, sDO, r0, i4);
  float pk[2];
  int kflag[2];  // 0 = live key, 1 = padded, 2 = past T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    const bool in = key < T;
    pk[r] = in ? static_cast<float>(posr[key]) : 0.f;
    kflag[r] = !in ? 2 : ((maskr && maskr[key]) ? 1 : 0);
  }
  const float slope = slopes[h];

  float acc_dk[kD / 8][4], acc_dv[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    acc_dk[dn][0] = acc_dk[dn][1] = acc_dk[dn][2] = acc_dk[dn][3] = 0.f;
    acc_dv[dn][0] = acc_dv[dn][1] = acc_dv[dn][2] = acc_dv[dn][3] = 0.f;
  }

  const int n_tiles = (T + kTile - 1) / kTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(sQ, q, q0, T, tid);
    stage_tile(sDO, dor, q0, T, tid);
    cp_async_commit();
    if (tid < kTile) {
      const int row = q0 + tid;
      const bool in = row < T;
      const float l = in ? lse[bh * T + row] : 0.f;
      sPosQ[tid] = in ? static_cast<float>(posr[row]) : 0.f;
      sLse[tid] = l;
      sDelta[tid] = in ? delta[bh * T + row] : 0.f;
      sFlagQ[tid] = !in ? 2 : (l < kDeadLse ? 1 : 0);
    }
    cp_async_wait<0>();
    __syncthreads();

    float st[kTile / 8][4], dpt[kTile / 8][4];
    rows_product(st, kf, sQ, g, i4);    // S^T = K Q^T
    rows_product(dpt, vf, sDO, g, i4);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + 2 * i4 + (e & 1);
        const int qflag = sFlagQ[col];
        float p = 0.f;  // a padded key weighs 0, or 1/T in a row of padded keys
        if (kflag[r] == 0 && qflag != 2)
          p = expf(st[j][e] * a.sm_scale - slope * alibi_dist(sPosQ[col], pk[r], sentinel) -
                   sLse[col]);
        else if (kflag[r] == 1 && qflag == 1)
          p = inv_t;
        const float f = drop ? drop_factor(seed_word, q0 + col, k0 + r0 + 8 * r, a.thresh,
                                           a.keep_scale)
                             : 1.f;
        const float ds = kflag[r] == 0 ? p * (dpt[j][e] * f - sDelta[col]) : 0.f;
        st[j][e] = p * f;
        dpt[j][e] = ds;
      }
    }
    acc_times_tile(acc_dv, st, sDO, lane);  // dv += (P f)^T dO
    acc_times_tile(acc_dk, dpt, sQ, lane);  // dk += dS^T Q
  }

  store_rows(dk + bh * head, kD, acc_dk, k0 + r0, k0 + r0 + 8, T, a.sm_scale, i4);
  store_rows(dv + bh * head, kD, acc_dv, k0 + r0, k0 + r0 + 8, T, 1.f, i4);
}

int check_args(int B, int H, int T, int D) {
  if (D != kD || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
}  // namespace a2v

// C entries, bound with ctypes. qkv (3, B, H, T, D) and dout (B, H, T, D)
// bf16; lse and delta (B*H, T) fp32; positions (pos_per_row ? B : 1, T)
// int32; mask null or (mask_per_row ? B : 1, T) uint8. dq, dk, dv are
// (B, H, T, D) bf16 (planes of one (3, B, H, T, D) gradient); dslope_part is
// (B, H, ceil(T / 64)) fp32. Each returns a cudaError_t.
extern "C" int a2v_alibi_attention_bwd_dq(const void* qkv, const void* dout, const void* lse,
                                          const void* delta, const void* slopes, const void* pos,
                                          int pos_per_row, const void* mask, int mask_per_row,
                                          void* dq, void* dslope_part, int B, int H, int T,
                                          int D, int has_sentinel, float sm_scale, int seed,
                                          unsigned int thresh, float keep_scale, void* stream) {
  using namespace a2v;
  if (int err = check_args(B, H, T, D)) return err;
  const BwdArgs a{pos_per_row, mask_per_row, has_sentinel, B, H, T, sm_scale,
                  static_cast<uint32_t>(seed), thresh, keep_scale};
  alibi_attention_dq_kernel<<<dim3((T + kTile - 1) / kTile, H, B), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(slopes), static_cast<const int*>(pos),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(dq),
      static_cast<float*>(dslope_part), a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int a2v_alibi_attention_bwd_dkv(const void* qkv, const void* dout, const void* lse,
                                           const void* delta, const void* slopes, const void* pos,
                                           int pos_per_row, const void* mask, int mask_per_row,
                                           void* dk, void* dv, int B, int H, int T, int D,
                                           int has_sentinel, float sm_scale, int seed,
                                           unsigned int thresh, float keep_scale, void* stream) {
  using namespace a2v;
  if (int err = check_args(B, H, T, D)) return err;
  const BwdArgs a{pos_per_row, mask_per_row, has_sentinel, B, H, T, sm_scale,
                  static_cast<uint32_t>(seed), thresh, keep_scale};
  alibi_attention_dkv_kernel<<<dim3((T + kTile - 1) / kTile, H, B), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(slopes), static_cast<const int*>(pos),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(dk), static_cast<bf16*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}
