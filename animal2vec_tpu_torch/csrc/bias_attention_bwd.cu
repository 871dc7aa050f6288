// Backward of the dense-bias flash attention (bias_attention.cu), bf16 in
// and out, D = 64: two kernels.
//
// Replaces the backward of jax's stock TPU flash-attention kernel
// (jax.experimental.pallas.ops.tpu.flash_attention, reached through
// animal2vec_tpu/models/attention.py:flash_attention_tpu):
//   _flash_attention_bwd_dq  -> bias_attention_dq_kernel: dq and dS, the
//                               gradient of the bias (the stock kernel's ds);
//   _flash_attention_bwd_dkv -> bias_attention_dkv_kernel: dk and dv.
// It differentiates what bias_attention.cu computes, xla_attention's
// function (the stock kernel differentiates softmax((q.k + bias) / sqrt(D))
// instead): with s = q.k / sqrt(D) + bias, P = exp(s - lse) (lse from the
// forward), dP = dO . V^T and delta = rowsum(dO * O) (computed outside, one
// torch op):
//   dS    = P * (dP - delta)      = d bias  (fp32, (B, H, T, T))
//   dq    = dS . K / sqrt(D)
//   dk    = dS^T . Q / sqrt(D)
//   dv    = P^T . dO
// A padded key's score is replaced by -1e10, a constant: its dS, and so its
// bias gradient, is 0. A query row whose keys are all padded (lse about
// -1e10) weighs every key 1/T in the forward: it passes 1/T to dv and no
// gradient to q, k or the bias. Keys and queries past T are dropped by
// bounds; the bias gradient is written for the T x T scores only.
//
// Design: the ALiBi backward (alibi_attention_bwd.cu, the tile helpers of
// flash_bwd_tiles.cuh) with three changes: the bias is read (fp32, per
// batch row or batch-uniform with batch stride 0) instead of computed from
// slopes and positions; the dq kernel writes dS where the ALiBi kernel
// reduces it into slope partials; q, k and v are read in place from the
// (B, T, H, D) views of the (B, T, 3, H, D) projection with their batch and
// time strides, as bias_attention.cu reads them, and dq, dk, dv are written
// into one (B, T, 3, H, D) gradient, the projection's. The dq kernel owns 64
// query rows and loops over key tiles; the dk/dv kernel owns 64 keys and
// loops over query tiles in the transposed formulation (S^T = K Q^T, dP^T =
// V dO^T), so that P^T and dS^T come out in the A layout of the next
// product. Each thread reads the bias of its own scores from device memory
// (L2-resident at the image shapes) and writes its dS values as fp32.
//
// Bound on the H100 at the ViT-B/16 student's shape (B = 128, H = 12,
// T = 59; chip_smoke.py's bias_attention_bwd_bounds): the dq kernel does 3
// products of 2 T^2 D per (b, h) (0.26 GFLOP, under a microsecond at the
// bf16 peak) and moves the bias in and dS out (2 x 21 MB) beside q, k, v,
// dO (46 MB), lse and delta (0.7 MB) and dq (12 MB): about 101 MB, bound by
// bytes at ~30 us at 3.35 TB/s. At T 59 one 64-key tile is mostly padding;
// the launch and the tile latency dominate. The dk/dv kernel reads the bias
// again and writes dk and dv: about 92 MB, ~27 us.
#include "flash_bwd_tiles.cuh"

namespace a2v {
namespace {

using namespace flash_bwd;

constexpr float kDeadLse = -5e9f;  // lse below this: every key of the row padded

struct BiasBwdArgs {
  long long stride_b, stride_t;          // q, k, v (elements)
  long long out_stride_b, out_stride_t;  // dq, dk, dv
  long long bias_stride_b;               // 0 for a batch-uniform bias
  int H, T;
  float sm_scale;
};

// One block per (64-query tile, head, batch): dq rows and the rows of dS.
__global__ void __launch_bounds__(kThreads)
bias_attention_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,    // (B, T, H, D) contiguous
                         const float* __restrict__ lse,    // (B*H, T)
                         const float* __restrict__ delta,  // (B*H, T)
                         const float* __restrict__ bias,   // null or (1 or B, H, T, T)
                         const uint8_t* __restrict__ mask, // null or (B, T)
                         bf16* __restrict__ dq,            // out_stride_b, out_stride_t
                         float* __restrict__ dbias,        // null or (B, H, T, T)
                         BiasBwdArgs a) {
  __shared__ __align__(16) bf16 sQ[kTile * kLds];
  __shared__ __align__(16) bf16 sDO[kTile * kLds];
  __shared__ __align__(16) bf16 sK[kTile * kLds];
  __shared__ __align__(16) bf16 sV[kTile * kLds];
  __shared__ int sFlagK[kTile];  // 0 = live key, 1 = padded, 2 = past T

  const int T = a.T, H = a.H;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long in_head = b * a.stride_b + h * kD;
  const long long do_row = static_cast<long long>(H) * kD;
  const bf16* kb = k + in_head;
  const bf16* vb = v + in_head;
  const uint8_t* maskr = mask ? mask + static_cast<long long>(b) * T : nullptr;
  const long long plane = static_cast<long long>(T) * T;
  const float* bias_p = bias ? bias + b * a.bias_stride_b + h * plane : nullptr;

  stage_rows(sQ, q + in_head, a.stride_t, q0, T, tid);
  stage_rows(sDO, dout + b * T * do_row + h * kD, do_row, q0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qf[kD / 16][4], dof[kD / 16][4];
  row_fragments(qf, sQ, r0, i4);
  row_fragments(dof, sDO, r0, i4);
  float lse_r[2], delta_r[2];
  int rflag[2];  // 0 = live row, 1 = every key padded, 2 = past T
  const float* brow[2];
  float* drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const bool in = row < T;
    lse_r[r] = in ? lse[bh * T + row] : 0.f;
    delta_r[r] = in ? delta[bh * T + row] : 0.f;
    rflag[r] = !in ? 2 : (lse_r[r] < kDeadLse ? 1 : 0);
    brow[r] = (bias_p && in) ? bias_p + static_cast<long long>(row) * T : nullptr;
    drow[r] = (dbias && in) ? dbias + (bh * T + row) * T : nullptr;
  }

  float acc_dq[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
    acc_dq[dn][0] = acc_dq[dn][1] = acc_dq[dn][2] = acc_dq[dn][3] = 0.f;

  const int n_tiles = (T + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows(sK, kb, a.stride_t, k0, T, tid);
    stage_rows(sV, vb, a.stride_t, k0, T, tid);
    cp_async_commit();
    if (tid < kTile) {
      const int key = k0 + tid;
      sFlagK[tid] = key >= T ? 2 : ((maskr && maskr[key]) ? 1 : 0);
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
        const int r = e >> 1, col = j * 8 + 2 * i4 + (e & 1), key = k0 + col;
        const int kflag = sFlagK[col];
        float ds = 0.f;  // only live keys of live rows reach dS
        if (kflag == 0 && rflag[r] == 0) {
          float x = s[j][e] * a.sm_scale;
          if (brow[r] != nullptr) x += __ldg(brow[r] + key);
          ds = expf(x - lse_r[r]) * (dp[j][e] - delta_r[r]);
        }
        if (drow[r] != nullptr && kflag != 2) drow[r][key] = ds;
        s[j][e] = ds;
      }
    }
    acc_times_tile(acc_dq, s, sK, lane);  // dq += dS K
  }

  store_rows(dq + b * a.out_stride_b + h * kD, a.out_stride_t, acc_dq, q0 + r0, q0 + r0 + 8, T,
             a.sm_scale, i4);
}

// One block per (64-key tile, head, batch): dk and dv rows.
__global__ void __launch_bounds__(kThreads)
bias_attention_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, BiasBwdArgs a) {
  __shared__ __align__(16) bf16 sQ[kTile * kLds];   // K first, then Q tiles
  __shared__ __align__(16) bf16 sDO[kTile * kLds];  // V first, then dO tiles
  __shared__ float sLse[kTile], sDelta[kTile];
  __shared__ int sFlagQ[kTile];  // 0 = live row, 1 = every key padded, 2 = past T

  const int T = a.T, H = a.H;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long in_head = b * a.stride_b + h * kD;
  const long long do_row = static_cast<long long>(H) * kD;
  const bf16* qb = q + in_head;
  const bf16* dob = dout + b * T * do_row + h * kD;
  const uint8_t* maskr = mask ? mask + static_cast<long long>(b) * T : nullptr;
  const long long plane = static_cast<long long>(T) * T;
  const float* bias_p = bias ? bias + b * a.bias_stride_b + h * plane : nullptr;
  const float inv_t = 1.f / T;

  // this warp's 16 keys as A operands
  stage_rows(sQ, k + in_head, a.stride_t, k0, T, tid);
  stage_rows(sDO, v + in_head, a.stride_t, k0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t kf[kD / 16][4], vf[kD / 16][4];
  row_fragments(kf, sQ, r0, i4);
  row_fragments(vf, sDO, r0, i4);
  int kflag[2], key[2];  // 0 = live key, 1 = padded, 2 = past T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + r0 + 8 * r;
    kflag[r] = key[r] >= T ? 2 : ((maskr && maskr[key[r]]) ? 1 : 0);
  }

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
    stage_rows(sQ, qb, a.stride_t, q0, T, tid);
    stage_rows(sDO, dob, do_row, q0, T, tid);
    cp_async_commit();
    if (tid < kTile) {
      const int row = q0 + tid;
      const bool in = row < T;
      const float l = in ? lse[bh * T + row] : 0.f;
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
        if (kflag[r] == 0 && qflag == 0) {
          float x = st[j][e] * a.sm_scale;
          if (bias_p) x += __ldg(bias_p + static_cast<long long>(q0 + col) * T + key[r]);
          p = expf(x - sLse[col]);
        } else if (kflag[r] == 1 && qflag == 1) {
          p = inv_t;
        }
        const float ds = kflag[r] == 0 ? p * (dpt[j][e] - sDelta[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }
    acc_times_tile(acc_dv, st, sDO, lane);  // dv += P^T dO
    acc_times_tile(acc_dk, dpt, sQ, lane);  // dk += dS^T Q
  }

  const long long out_head = b * a.out_stride_b + h * kD;
  store_rows(dk + out_head, a.out_stride_t, acc_dk, key[0], key[1], T, a.sm_scale, i4);
  store_rows(dv + out_head, a.out_stride_t, acc_dv, key[0], key[1], T, 1.f, i4);
}

int check_args(int B, int H, int T, int D, long long stride_b, long long stride_t,
               long long out_stride_b, long long out_stride_t, const void* q, const void* k,
               const void* v, const void* dout) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (D != kD || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 || stride_b % 8 != 0 ||
      stride_t % 8 != 0 || out_stride_b % 8 != 0 || out_stride_t % 8 != 0 || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

BiasBwdArgs make_args(long long stride_b, long long stride_t, long long out_stride_b,
                      long long out_stride_t, int bias_uniform, int H, int T, float sm_scale) {
  const long long bias_stride_b = bias_uniform ? 0 : static_cast<long long>(H) * T * T;
  return BiasBwdArgs{stride_b, stride_t, out_stride_b, out_stride_t, bias_stride_b, H, T,
                     sm_scale};
}

}  // namespace
}  // namespace a2v

// C entries, bound with ctypes. q, k, v: bf16 (B, T, H, D) with element
// strides (stride_b, stride_t, D, 1), 16-byte aligned, strides multiples of
// 8; dout bf16 (B, T, H, D) contiguous; lse and delta (B*H, T) fp32; bias
// null or fp32 (bias_uniform ? 1 : B, H, T, T) contiguous; mask null or
// (B, T) uint8. dq, dk, dv are bf16 (B, T, H, D) with element strides
// (out_stride_b, out_stride_t, D, 1) (the three planes of one (B, T, 3, H, D)
// gradient); dbias null or fp32 (B, H, T, T) contiguous. Each returns a
// cudaError_t.
extern "C" int a2v_bias_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         long long stride_b, long long stride_t,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* bias, int bias_uniform, const void* mask,
                                         void* dq, long long out_stride_b, long long out_stride_t,
                                         void* dbias, int B, int H, int T, int D, float sm_scale,
                                         void* stream) {
  using namespace a2v;
  if (int err = check_args(B, H, T, D, stride_b, stride_t, out_stride_b, out_stride_t, q, k, v,
                           dout))
    return err;
  const BiasBwdArgs a =
      make_args(stride_b, stride_t, out_stride_b, out_stride_t, bias_uniform, H, T, sm_scale);
  bias_attention_dq_kernel<<<dim3((T + kTile - 1) / kTile, H, B), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(dq), static_cast<float*>(dbias), a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int a2v_bias_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          long long stride_b, long long stride_t,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* bias, int bias_uniform, const void* mask,
                                          void* dk, void* dv, long long out_stride_b,
                                          long long out_stride_t, int B, int H, int T, int D,
                                          float sm_scale, void* stream) {
  using namespace a2v;
  if (int err = check_args(B, H, T, D, stride_b, stride_t, out_stride_b, out_stride_t, q, k, v,
                           dout))
    return err;
  const BiasBwdArgs a =
      make_args(stride_b, stride_t, out_stride_b, out_stride_t, bias_uniform, H, T, sm_scale);
  bias_attention_dkv_kernel<<<dim3((T + kTile - 1) / kTile, H, B), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(dk), static_cast<bf16*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}
