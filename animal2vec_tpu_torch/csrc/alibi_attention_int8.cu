// int8 ALiBi flash-attention forward of serving, head dims D <= 128 (a
// multiple of 8), bf16 out, on
// Hopper's int8 wgmma; and the one CUDA pass that quantizes its q, k, v.
//
// Replaces the TPU kernel animal2vec_tpu/ops/pallas_attention.py:_kernel_q8
// and its wrapper's quantization (alibi_flash_attention_int8, :816-831,
// XLA ops there). q and k are quantized per row over D (D^-0.5 folded into
// q before its max, the caller's fp32 of it), v per channel over T. Over each span of `span` keys
// (the TPU kernel's key block, 2048 at most):
//
//   s  = fp32(q8 . k8) * qs * ks - slope * |pos_i - pos_j|  (0 at sentinels)
//   s  = -1e9 at padded keys and at keys in [T, t_pad)
//   m' = max(m, max over the span of s);  p = exp(s - m')
//   l  = exp(m - m') l + sum p                         (unquantized fp32 p)
//   acc = exp(m - m') acc + fp32(rint(127 p) . v8) * vs / 127
//
// and out = bf16(acc / max(l, 1e-30)), with m starting at -1e9. P is
// quantized against the running max of the whole span, as on the TPU, where
// a span is one grid step: so each span is walked twice, first for its row
// max (an extra int8 Q K^T), then for P and P V (a pass with a per-tile
// rescale would round P otherwise). Keys in [T, t_pad) are the TPU
// wrapper's padding: masked, with zero v, so a row whose every key is
// padded averages V over t_pad keys and stays finite.
//
// The quantization pass (two launches, 16-byte loads) reads q, k and v
// where the model leaves them, the (B, T, H, D) views of the qkv
// projection's (B, T, 3, H, D) output (any batch, token and head strides,
// D contiguous), and writes, bit for bit ops/attention.quantize_qkv_int8's
// values (max|x| * fp32(1/127) floored at 1e-12, an IEEE division, round
// half to even):
//   1. quantize_qk: q8, k8 (B, H, T, Dp) int8 and qs, ks (B, H, T) fp32, one
//      (token, head) row per Dp / 8 threads;
//   2. quantize_v: per (b, h) block, v's per-channel max over all T, then
//      v8^T (B, H, Dp, t_pad) int8, zero past T, with the keys of every 32
//      in the order the P V product reads them (below), and vsc = vs *
//      fp32(1/127) (B, H, D).
// Dp is the head padded to the kernel's tiles, 64 NC (NC = 1 for D 64, 2
// for any other D up to 128); q8, k8 and v8^T are zero past D (a zero channel's scale
// is the 1e-12 floor), so the padded columns add nothing to Q K^T and give
// zero P V columns, which are not written.
//
// The kernel (sm_90a): a block of two warpgroups owns 128 query rows of one
// (batch, head), each warpgroup 64 rows, wgmma's M. The warpgroups share a
// 2-stage cp.async ring whose slots hold 128 keys: two K8 tiles (64 keys x
// Dp B), in pass 2 also the Dp channels' v8^T for them (2 NC tiles), and
// each key's position, scale and mask entry (+inf live, -1e9 padded or
// past T). The walk is one stream of steps, span by span, the span's keys
// in pass 1 and then again in pass 2, so the copies of the next step are
// in flight across the boundary between passes and spans; a step works
// through its two 64-key halves one after the other (one S accumulator),
// so a barrier serves 128 keys.
//   - S = Q8 K8^T: SS wgmma m64n64k32 s8 x s8 -> s32, 2 NC k32 steps over
//     Dp. A staged row is Dp int8, held in the first half (NC = 1) or the
//     whole of a 128-byte swizzled row (sm90.cuh's sw128 layout and
//     descriptor; the k32 steps start 0, 32, 64, 96 bytes in), so the int8
//     tiles take the bf16 kernels' proven descriptor at twice the bytes.
//   - The dequant ((fp32(s) * qs) * ks), the bias, the mask entry and the
//     max in fp32, each product and sum rounded on its own, in the TPU
//     kernel's order, so the scores and the span's max are the plain
//     version's. fp32(s) and rint(127 p) take the magic-number conversions
//     (two full-rate instructions each, not I2F / F2I). Pass 1 keeps only
//     each row's max; pass 2 computes p = ex2((s - m') log2(e)), the fp32
//     sum l and rint(127 p). ex2.approx is a few fp32 ulps from exp where
//     expf is one or two, so a P value near a rounding boundary of 127 p
//     lands one step apart somewhat more often (each such value moves its
//     row by one step of P V, within the tolerance the kernel is held to);
//     it measured 0.43 ms faster than expf at b32 (PERF.md). Folding
//     log2(e) into the scale and the slope, one instruction less, rounds
//     the scores themselves: an error relative to |s| (the bias reaches
//     hundreds) that flipped ten times as many P values.
//   - O_int32 += P8 V8: RS wgmma m64n64k32, one for each 64 channels of
//     V, with P8 packed from the S accumulator's registers as the A
//     operand. The accumulator gives a
//     thread the keys 8j + 2i + {0, 1} of its rows; the A fragment wants
//     the k32 step's columns 4i .. 4i + 3 and 16 + 4i .. 16 + 4i + 3. So
//     A's column a of a 32-key step carries the key
//       perm(a) = 16 (a >> 4) + 8 ((a >> 1) & 1) + 2 ((a >> 2) & 3) + (a & 1)
//     (columns 4i .. 4i + 3 hold keys 2i, 2i + 1, 8 + 2i, 9 + 2i, which the
//     thread holds), and the quantization pass writes v8^T with the same
//     order in every 32 keys: byte a of a group holds key perm(a), and key
//     k sits at a = 16 (k >> 4) + 8 ((k >> 2) & 1) + 4 ((k >> 1) & 1) + 2
//     ((k >> 3) & 1) + (k & 1). The dot product over a 32-key step does not
//     depend on the order of its keys.
//   - The int32 P V sum spans the whole span (127 x 127 x 2048 < 2^31) and
//     is folded into fp32 once per span, in the TPU kernel's order; the
//     last span writes the output, and with two spans or more the fp32
//     sums wait in a global scratch between spans (the registers hold S,
//     the int32 O and P's fragments).
// NC = 1: two blocks an SM (128 registers, 2 x 84 KB of shared memory);
// NC = 2 (32 more int32 accumulators a thread, 116 KB): one. D = 64 runs
// the NC = 1 instances, unchanged. ptxas
// spills a few values (8-60 bytes stored a thread, up to 376 loaded in the
// masked instances); the loops over a step's two halves rolled up spill
// less and measured 2-7 % slower (PERF.md), as did the previous design
// (64-key pass-2 steps, unspilled, 3-5 % slower).
//
// Bound on the H100 at the serving shape (B = 32, H = 16, T = 2000): the
// three products (Q K^T twice, P V) are 6 B H T^2 D = 0.79 TOP of int8
// work, 0.40 ms at the 1,979 TOP/s int8 peak; the two products the
// function needs, 0.26 ms, above the 0.52 GB of bf16 q, k, v and out (0.16
// ms at 3.35 TB/s). Beside them every score (2.05e9 a pass) takes about
// ten fp32 instructions in pass 1 and sixteen and an ex2 in pass 2, and
// each step a barrier and a wait for its products: the scalar passes and
// the step's synchronization, not the tensor cores, bound the kernel
// (PERF.md: timing builds without pass 1, the bias or the exponential).
#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTile = 64;             // keys per tile; query rows per warpgroup
constexpr int kWG = 2;                // warpgroups per block
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 2;            // ring depth of the key tiles
constexpr int kRowBytes = 128;        // a staged row: Dp int8 in a 128-byte swizzled row
constexpr int kS8Tile = kTile * kRowBytes;   // 8 KB
constexpr int kStepKeys = 2 * kTile;  // keys a step: two K tiles (and two V^T tiles)
constexpr float kMaskScore = -1e9f;   // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
// Q tiles, the ring's slots of 2 + 2 NC tiles (two K, 2 NC V^T), each key's
// {position, scale} and mask entry
template <int NC>
constexpr int kSlotTiles = 2 + 2 * NC;
template <int NC>
constexpr int kSmem =
    kS8Tile * (kWG + kSlotTiles<NC> * kStages) + kStages * kStepKeys * 12 + kTileAlign;

struct Int8Args {
  int H, T, D;
  int t_pad;     // keys walked: a multiple of span; the row length of v8^T
  int span;      // keys per P quantization (a multiple of 128)
  int pos_row;   // elements between batch rows of positions (0: batch-uniform)
  int mask_row;  // elements between batch rows of the padding mask
};

// The int32 <-> fp32 conversions of the scalar passes, by the magic number
// 1.5 * 2^23 (whose fp32 ulp is 1): two full-rate instructions each in
// place of I2F / F2I, which issue at 16 a clock per SM, an eighth of the
// fp32 rate (measured 2-7 % faster at b32 than I2F, F2I and pack_s8x4,
// PERF.md). fp32 of an int32 with |v| < 2^22 (a Q K^T sum over D <= 128
// is at most 128 x 127^2), exactly:
__device__ __forceinline__ float s32_to_f32(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.f);
}
// rint(x) of x in [0, 2^22), round half to even as __float2int_rn (the
// fp32 add rounds so), in the low bytes of the result's bits:
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.f));
}
// The low bytes of four words in one register, the first in the low byte.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Rows row0 .. row0 + 63 of a plane of int8 rows (row_stride bytes apart),
// their first 16 kChunks bytes, into a 128-byte swizzled tile's rows, 16
// bytes a copy; rows at or past n_rows are zero-filled. The caller commits.
template <int kChunks>
__device__ __forceinline__ void stage_s8_rows(int8_t* tile, const int8_t* src, long long row_stride,
                                              int row0, int n_rows, int tid) {
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads, r = c / kChunks, ch = c % kChunks, row = row0 + r;
    const bool in = row < n_rows;
    cp_async_16(tile + r * kRowBytes + ((ch ^ (r & 7)) << 4),
                in ? src + row * row_stride + ch * 16 : src, in);
  }
}

template <int NC, bool HAS_MASK, bool HAS_SENTINEL>
__global__ void __launch_bounds__(kThreads, NC == 1 ? 2 : 1)
alibi_int8_kernel(const int8_t* __restrict__ q8,   // (B, H, T, Dp)
                  const float* __restrict__ qs,    // (B, H, T)
                  const int8_t* __restrict__ k8,   // (B, H, T, Dp)
                  const float* __restrict__ ks,    // (B, H, T)
                  const int8_t* __restrict__ v8t,  // (B, H, Dp, t_pad), keys permuted
                  const float* __restrict__ vsc,   // (B, H, D): vs / 127
                  const float* __restrict__ slopes,  // (H,)
                  const int* __restrict__ pos,     // (1 or B, T)
                  const uint8_t* __restrict__ mask,  // (1 or B, T), 1 = padded key
                  bf16* __restrict__ out,          // (B, T, H, D)
                  float* __restrict__ o_acc,       // (B, H, T, Dp) fp32 when two spans or more
                  Int8Args a) {
  constexpr int kDp = 64 * NC, kSlot = kSlotTiles<NC>;
  extern __shared__ uint8_t smem_raw[];
  int8_t* const sQ = reinterpret_cast<int8_t*>(align_tiles(smem_raw));
  // slot s at kSlot s tiles in: K of keys 0-63 and 64-127, then V^T of each
  // 64 keys in NC tiles of 64 channels
  int8_t* const sRing = sQ + kWG * kS8Tile;
  float2* const sKD = reinterpret_cast<float2*>(sRing + kStages * kSlot * kS8Tile);  // {pos, ks}
  float* const sKE = reinterpret_cast<float*>(sKD + kStages * kStepKeys);  // mask entry

  const int T = a.T, H = a.H, h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile * kWG;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;

  const long long bh = static_cast<long long>(b) * H + h;
  const int8_t* qb = q8 + bh * T * kDp;
  const int8_t* kb = k8 + bh * T * kDp;
  const float* ksb = ks + bh * T;
  const int8_t* vb = v8t + bh * kDp * a.t_pad;
  const int* posr = pos + static_cast<long long>(b) * a.pos_row;
  const uint8_t* mrow = HAS_MASK ? mask + static_cast<long long>(b) * a.mask_row : nullptr;
  // a span's steps: span / 128 of pass 1 (two K tiles each), then as many
  // of pass 2 (two K and two V^T tiles each)
  const int n_pass = a.span / kStepKeys, per_span = 2 * n_pass;
  const int n_steps = a.t_pad / a.span * per_span;

  // step st's first key; pass 2 when (st / n_pass) is odd
  auto step_key = [&](int st) {
    return st / per_span * a.span + st % n_pass * kStepKeys;
  };
  auto stage = [&](int st) {
    const int key0 = step_key(st);
    int8_t* slot = sRing + (st % kStages) * kSlot * kS8Tile;
    const bool with_v = (st / n_pass) & 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      stage_s8_rows<kDp / 16>(slot + half * kS8Tile, kb, kDp, key0 + half * kTile, T, tid);
      if (with_v) {  // the Dp channels' v8^T rows for the half's 64 keys
#pragma unroll
        for (int n = 0; n < NC; ++n)
          stage_s8_rows<4>(slot + (2 + half * NC + n) * kS8Tile,
                           vb + static_cast<long long>(64 * n) * a.t_pad + key0 + half * kTile,
                           a.t_pad, 0, 64, tid);
      }
    }
  };
  // threads < 128: the data of step st's key tid
  struct KeyData {
    float2 kd;
    float entry;
  };
  auto key_data = [&](int st) {
    const int key = step_key(st) + tid;
    if (key >= T) return KeyData{make_float2(0.f, 0.f), kMaskScore};
    return KeyData{make_float2(static_cast<float>(posr[key]), ksb[key]),
                   HAS_MASK && mrow[key] ? kMaskScore : INFINITY};
  };
  auto put_key = [&](int st, const KeyData& k) {
    sKD[(st % kStages) * kStepKeys + tid] = k.kd;
    sKE[(st % kStages) * kStepKeys + tid] = k.entry;
  };

  // prologue: the Q tiles with step 0, then steps 1 .. kStages - 2
#pragma unroll
  for (int w = 0; w < kWG; ++w)
    stage_s8_rows<kDp / 16>(sQ + w * kS8Tile, qb, kDp, q0 + w * kTile, T, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
    if (s < n_steps && tid < kStepKeys) put_key(s, key_data(s));
  }

  // this thread's rows q0 + 64 wg + 16 warp + g + 8r; a sentinel query row
  // (position < 0) has no bias, as if its slope were 0
  float qsr[2], pq[2], nsl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * r;
    qsr[r] = row < T ? qs[bh * T + row] : 0.f;
    pq[r] = row < T ? static_cast<float>(posr[row]) : 0.f;
    nsl[r] = HAS_SENTINEL && pq[r] < 0.f ? 0.f : -slopes[h];
  }
  float m[2] = {kMaskScore, kMaskScore};
  float l[2] = {0.f, 0.f};
  const uint64_t desc_q = desc_sw128(sQ) + ((wg * kS8Tile) >> 4);
  const uint64_t desc_ring = desc_sw128(sRing);
  constexpr uint64_t kDescS8Tile = kS8Tile >> 4;

  // the start of step st: its tiles have landed and every thread is done
  // with step st - 1; the copies of step st + kStages - 1 go out; returns
  // that step's key data (threads < 128), written after this step's
  // products
  auto begin = [&](int st) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    const int nst = st + kStages - 1;
    KeyData nk{};
    if (nst < n_steps) {
      stage(nst);
      if (tid < kStepKeys) nk = key_data(nst);
    }
    cp_async_commit();
    return nk;
  };
  auto end = [&](int st, const KeyData& nk) {
    if (st + kStages - 1 < n_steps && tid < kStepKeys) put_key(st + kStages - 1, nk);
  };
  // S = Q8 K8^T of the K tile at ring tile rt (issued, committed, waited)
  int sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0;
  auto qk = [&](int rt) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2 * NC; ++kk)
      wgmma_s8_n64(sacc, desc_q + kk * kDescStepK, desc_ring + rt * kDescS8Tile + kk * kDescStepK,
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
  };
  // the scores of S against the 64 keys from key0 of step st's key data
  // (dequant, bias; the mask entry when a padding mask or T reaches the
  // tile), each handed to fn(i, r, x)
  auto scores = [&](int st, int key0, auto fn) {
    const int kofs = (st % kStages) * kStepKeys + key0;
    const float4* kd = reinterpret_cast<const float4*>(sKD + kofs);
    const float2* ke = reinterpret_cast<const float2*>(sKE + kofs);
    auto walk = [&](auto entry) {
      constexpr bool kEntry = decltype(entry)::value;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float4 kv = kd[4 * j + i4];  // keys 8j + 2 i4 and 8j + 2 i4 + 1
        const float2 en = ke[4 * j + i4];
        const float pk[2] = {kv.x, kv.z}, ksc[2] = {kv.y, kv.w}, ent[2] = {en.x, en.y};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float dist = fabsf(pq[r] - pk[e]);
            if (HAS_SENTINEL && pk[e] < 0.f) dist = 0.f;
            float x = __fadd_rn(__fmul_rn(__fmul_rn(s32_to_f32(sacc[i]), qsr[r]), ksc[e]),
                                __fmul_rn(nsl[r], dist));
            if (kEntry && ent[e] != INFINITY) x = ent[e];
            fn(i, r, x);
          }
        }
      }
    };
    if (HAS_MASK || step_key(st) + key0 + kTile > T)
      walk(std::true_type{});
    else
      walk(std::false_type{});
  };

  int st = 0;
  for (int s0 = 0; s0 < a.t_pad; s0 += a.span) {
    // pass 1: the span's row max
    float mx[2] = {-INFINITY, -INFINITY};
    for (int it = 0; it < n_pass; ++it, ++st) {
      const KeyData nk = begin(st);
      const auto max_of = [&](int, int r, float x) { mx[r] = fmaxf(mx[r], x); };
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        qk(kSlot * (st % kStages) + half);
        scores(st, half * kTile, max_of);
      }
      end(st, nk);
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new[r]);
    }

    // pass 2: p, its int8 quantization, and P V, 64 keys at a time
    int pv[NC][32];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) pv[n][i] = 0;
    }
    float lsum[2] = {0.f, 0.f};
    for (int it = 0; it < n_pass; ++it, ++st) {
      const KeyData nk = begin(st);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rt = kSlot * (st % kStages) + half;
        qk(rt);
        scores(st, half * kTile, [&](int i, int r, float x) {
          const float p = ex2(__fmul_rn(__fsub_rn(x, m_new[r]), kLog2e));
          lsum[r] += p;
          sacc[i] = static_cast<int>(rint_bits(__fmul_rn(p, 127.f)));
        });
        // A of the k32 step kk: columns 4 i4 .. +3 and 16 + 4 i4 .. +3 of
        // rows g and g + 8 hold the keys perm(a) (above) of accumulator
        // columns 32 kk + 8j' + 2 i4 + e
        uint32_t pa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = 4 * kk + 2 * hf;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              pa[kk][2 * hf + r] = pack_low_bytes(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1],
                                                  sacc[4 * j + 4 + 2 * r],
                                                  sacc[4 * j + 5 + 2 * r]);
          }
        }
        const uint64_t desc_v = desc_ring + (rt - half + 2 + half * NC) * kDescS8Tile;
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          fence_regs(pv[n]);
          wgmma_s8_n64_rs(pv[n], pa[0], desc_v + n * kDescS8Tile, 1);
          wgmma_s8_n64_rs(pv[n], pa[1], desc_v + n * kDescS8Tile + kDescStepK, 1);
        }
        wgmma_commit();
        if (half == 1) end(st, nk);
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < NC; ++n) fence_regs(pv[n]);
        fence_regs(pa);
      }
    }

    // fold the span, in the TPU kernel's order: l, and acc = alpha acc +
    // fp32(P V) vs / 127, through o_acc between spans; the last span
    // writes out = acc / max(l, 1e-30)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), lsum[r]);
      m[r] = m_new[r];
    }
    const bool first = s0 == 0, last = s0 + a.span >= a.t_pad;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[r] = fmaxf(lt, 1e-30f);
    }
    const float* vs = vsc + bh * a.D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 64 * wg + 16 * warp + g + 8 * r;
      if (row >= T) continue;
      float* orow = o_acc + (bh * T + row) * kDp;
      bf16* out_row = out + ((static_cast<long long>(b) * T + row) * H + h) * a.D;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (NC == 2 && 64 * n + 8 * j >= a.D) continue;  // columns past D are not written
          const int col = 64 * n + 8 * j + 2 * i4;
          float2 prev = make_float2(0.f, 0.f);
          if (!first) prev = *reinterpret_cast<const float2*>(orow + col);
          const float y0 = __fadd_rn(__fmul_rn(prev.x, alpha[r]),
                                     __fmul_rn(__int2float_rn(pv[n][4 * j + 2 * r]), vs[col]));
          const float y1 =
              __fadd_rn(__fmul_rn(prev.y, alpha[r]),
                        __fmul_rn(__int2float_rn(pv[n][4 * j + 2 * r + 1]), vs[col + 1]));
          if (last)
            *reinterpret_cast<uint32_t*>(out_row + col) = pack_bf16(y0 / inv[r], y1 / inv[r]);
          else
            *reinterpret_cast<float2*>(orow + col) = make_float2(y0, y1);
        }
      }
    }
  }
}

// --- the quantization pass ---------------------------------------------

constexpr int kQThreads = 256;

struct QuantArgs {
  long long stride_b, stride_t, stride_h;  // elements of q, k and v
  int B, H, T, t_pad, D;
  float q_scale;  // fp32 of D^-0.5, folded into q
};

// One (token, head) row of q or k per Dp / 8 threads, 8 values (16 bytes)
// each, zero past D: row item = ((b T + t) 2 + which) H + h, so a warp
// reads 256 / Dp rows of one token's q or k third.
template <int NC>
__global__ void __launch_bounds__(kQThreads)
quantize_qk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, QuantArgs a,
                   int8_t* __restrict__ q8, float* __restrict__ qs, int8_t* __restrict__ k8,
                   float* __restrict__ ks) {
  constexpr int kSub = 8 * NC, kDp = 64 * NC;  // threads a row; its padded length
  const long long n_items = 2ll * a.B * a.T * a.H;
  const long long gid = static_cast<long long>(blockIdx.x) * kQThreads + threadIdx.x;
  const int sub = threadIdx.x % kSub;
  const bool valid = gid / kSub < n_items;
  const long long item = valid ? gid / kSub : 0;
  const int h = static_cast<int>(item % a.H);
  const long long rest = item / a.H;
  const int which = static_cast<int>(rest & 1);
  const long long bt = rest >> 1;
  const int t = static_cast<int>(bt % a.T), b = static_cast<int>(bt / a.T);
  const bf16* src = (which ? k : q) + b * a.stride_b + t * a.stride_t + h * a.stride_h + 8 * sub;
  const uint4 raw =
      NC == 1 || 8 * sub < a.D ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float v[8], amax = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 f = __bfloat1622float2(pairs[p]);
    v[2 * p] = f.x;
    v[2 * p + 1] = f.y;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!which) v[i] = __fmul_rn(v[i], a.q_scale);  // D^-0.5 (0.125 at D 64, exact)
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 1; off < kSub; off <<= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax * kInv127, 1e-12f);
  if (!valid) return;
  const long long row = (static_cast<long long>(b) * a.H + h) * a.T + t;
  *reinterpret_cast<uint2*>((which ? k8 : q8) + row * kDp + 8 * sub) = make_uint2(
      pack_s8x4(quantize_s8(v[0], s), quantize_s8(v[1], s), quantize_s8(v[2], s),
                quantize_s8(v[3], s)),
      pack_s8x4(quantize_s8(v[4], s), quantize_s8(v[5], s), quantize_s8(v[6], s),
                quantize_s8(v[7], s)));
  if (sub == 0) (which ? ks : qs)[row] = s;
}

// The key at byte a of a 32-key group of v8^T (the P V operand's order).
__device__ __forceinline__ int perm_key(int a) {
  return 16 * (a >> 4) + 8 * ((a >> 1) & 1) + 2 * ((a >> 2) & 3) + (a & 1);
}

// One block per (head, batch): v's per-channel max over all T, then v8^T
// tile by tile (64 keys x Dp channels through shared memory), zero past D.
template <int NC>
__global__ void __launch_bounds__(kQThreads)
quantize_v_kernel(const bf16* __restrict__ v, QuantArgs a, int8_t* __restrict__ v8t,
                  float* __restrict__ vsc) {
  constexpr int kSub = 8 * NC, kRows = kQThreads / kSub, kDp = 64 * NC;
  constexpr int kRawLd = 32 * NC + 1;  // words per staged v row (Dp bf16 + 1): conflict-free
  __shared__ float sMax[kRows][kDp];
  __shared__ float sVs[kDp];
  __shared__ uint32_t sRaw[kTile * kRawLd];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int sub = tid % kSub, kr = tid / kSub;  // channels 8 sub .. 8 sub + 7
  const bf16* vb = v + b * a.stride_b + h * a.stride_h + 8 * sub;
  const long long bh = static_cast<long long>(b) * a.H + h;

  float mx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = kr; (NC == 1 || 8 * sub < a.D) && t < a.T; t += kRows) {
    const uint4 raw = *reinterpret_cast<const uint4*>(vb + t * a.stride_t);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 f = __bfloat1622float2(pairs[p]);
      mx[2 * p] = fmaxf(mx[2 * p], fabsf(f.x));
      mx[2 * p + 1] = fmaxf(mx[2 * p + 1], fabsf(f.y));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sMax[kr][8 * sub + i] = mx[i];
  __syncthreads();
  if (tid < kDp) {
    float amax = 0.f;
    for (int r = 0; r < kRows; ++r) amax = fmaxf(amax, sMax[r][tid]);
    const float s = fmaxf(amax * kInv127, 1e-12f);
    sVs[tid] = s;
    if (tid < a.D) vsc[bh * a.D + tid] = __fmul_rn(s, kInv127);
  }

  int8_t* vt = v8t + bh * kDp * a.t_pad;
  for (int k0 = 0; k0 < a.t_pad; k0 += kTile) {
    __syncthreads();  // sVs written; every thread is done with the last tile
#pragma unroll
    for (int i = 0; i < kTile * kSub / kQThreads; ++i) {  // key r's 16 bytes at chunk ch
      const int c = tid + i * kQThreads, r = c / kSub, ch = c % kSub, key = k0 + r;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (key < a.T && (NC == 1 || 8 * ch < a.D))
        raw = *reinterpret_cast<const uint4*>(v + b * a.stride_b + key * a.stride_t +
                                              h * a.stride_h + 8 * ch);
      uint32_t* dst = sRaw + r * kRawLd + 4 * ch;
      dst[0] = raw.x;
      dst[1] = raw.y;
      dst[2] = raw.z;
      dst[3] = raw.w;
    }
    __syncthreads();
    // four bytes a thread: channel d, bytes 4 quad .. 4 quad + 3 of the tile
#pragma unroll
    for (int i = 0; i < kDp / (kQThreads / 16); ++i) {
      const int d = (tid >> 4) + i * (kQThreads / 16), byte0 = 4 * (tid & 15);
      const float s = sVs[d];
      int qv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int byte = byte0 + c, key = (byte & ~31) + perm_key(byte & 31);
        const uint32_t w = sRaw[key * kRawLd + (d >> 1)];
        const float x = __uint_as_float((d & 1 ? w & 0xffff0000u : w << 16));
        qv[c] = quantize_s8(x, s);
      }
      *reinterpret_cast<uint32_t*>(vt + static_cast<long long>(d) * a.t_pad + k0 + byte0) =
          pack_s8x4(qv[0], qv[1], qv[2], qv[3]);
    }
  }
}

template <int NC, bool HAS_MASK, bool HAS_SENTINEL>
int launch(dim3 grid, cudaStream_t s, const int8_t* q8, const float* qs, const int8_t* k8,
           const float* ks, const int8_t* v8t, const float* vsc, const float* slopes,
           const int* pos, const uint8_t* mask, bf16* out, float* o_acc, const Int8Args& a) {
  constexpr auto kernel = alibi_int8_kernel<NC, HAS_MASK, HAS_SENTINEL>;
  // the shared-memory limit above 48 KB, raised once per process and instance
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<NC>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kThreads, kSmem<NC>, s>>>(q8, qs, k8, ks, v8t, vsc, slopes, pos, mask, out,
                                           o_acc, a);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_flags(bool has_mask, bool has_sentinel, dim3 grid, cudaStream_t s, const int8_t* q8,
                 const float* qs, const int8_t* k8, const float* ks, const int8_t* v8t,
                 const float* vsc, const float* slopes, const int* pos, const uint8_t* mask,
                 bf16* out, float* o_acc, const Int8Args& a) {
  if (has_mask)
    return has_sentinel ? launch<NC, true, true>(grid, s, q8, qs, k8, ks, v8t, vsc, slopes, pos,
                                                 mask, out, o_acc, a)
                        : launch<NC, true, false>(grid, s, q8, qs, k8, ks, v8t, vsc, slopes, pos,
                                                  mask, out, o_acc, a);
  return has_sentinel ? launch<NC, false, true>(grid, s, q8, qs, k8, ks, v8t, vsc, slopes, pos,
                                                mask, out, o_acc, a)
                      : launch<NC, false, false>(grid, s, q8, qs, k8, ks, v8t, vsc, slopes, pos,
                                                 mask, out, o_acc, a);
}

template <int NC>
int launch_quantize(const bf16* q, const bf16* k, const bf16* v, const QuantArgs& a, int8_t* q8,
                    float* qs, int8_t* k8, float* ks, int8_t* v8t, float* vsc, cudaStream_t s) {
  const long long threads = 2ll * a.B * a.T * a.H * 8 * NC;
  quantize_qk_kernel<NC><<<static_cast<int>((threads + kQThreads - 1) / kQThreads), kQThreads,
                           0, s>>>(q, k, a, q8, qs, k8, ks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_v_kernel<NC><<<dim3(a.H, a.B), kQThreads, 0, s>>>(v, a, v8t, vsc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace a2v

// C entry of the quantization pass, bound with ctypes. D: a multiple of 8
// up to 128 (the wrapper pads other head dims with zero columns); Dp = 64
// for D 64, else 128. q, k, v: bf16 (B, T, H, D) with element strides
// (stride_b, stride_t, stride_h, 1), 16-byte aligned, strides multiples of
// 8; q8, k8 (B, H, T, Dp) int8, qs, ks (B, H, T) fp32, v8t (B, H, Dp,
// t_pad) int8, vsc (B, H, D) fp32; q_scale the fp32 of D^-0.5 of the true
// head dim. Returns a cudaError_t.
extern "C" int a2v_quantize_qkv_int8(const void* q, const void* k, const void* v,
                                     long long stride_b, long long stride_t, long long stride_h,
                                     void* q8, void* qs, void* k8, void* ks, void* v8t,
                                     void* vsc, int B, int H, int T, int D, int t_pad,
                                     float q_scale, void* stream) {
  using namespace a2v;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      t_pad < T || t_pad % kTile != 0 || stride_b % 8 != 0 || stride_t % 8 != 0 ||
      stride_h % 8 != 0 || misaligned(q) || misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const QuantArgs a{stride_b, stride_t, stride_h, B, H, T, t_pad, D, q_scale};
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* q8p = static_cast<int8_t*>(q8);
  auto* k8p = static_cast<int8_t*>(k8);
  auto* v8p = static_cast<int8_t*>(v8t);
  auto* qsp = static_cast<float*>(qs);
  auto* ksp = static_cast<float*>(ks);
  auto* vsp = static_cast<float*>(vsc);
  if (D == 64) return launch_quantize<1>(qp, kp, vp, a, q8p, qsp, k8p, ksp, v8p, vsp, s);
  return launch_quantize<2>(qp, kp, vp, a, q8p, qsp, k8p, ksp, v8p, vsp, s);
}

// C entry of the kernel, bound with ctypes. D: a multiple of 8 up to 128;
// Dp = 64 for D 64, else 128. q8, k8 (B, H, T, Dp) int8 and qs, ks (B,
// H, T) fp32; v8t (B, H, Dp, t_pad) int8, zero past T, keys permuted as
// above; vsc (B, H, D) fp32 (vs / 127); positions (pos_per_row ? B : 1, T)
// int32; mask null or (mask_per_row ? B : 1, T) uint8; out (B, T, H, D)
// bf16; o_acc (B, H, T, Dp) fp32 scratch when t_pad > span (two key spans
// or more), else null. Returns a cudaError_t.
extern "C" int a2v_alibi_attention_int8(const void* q8, const void* qs, const void* k8,
                                        const void* ks, const void* v8t, const void* vsc,
                                        const void* slopes, const void* pos, int pos_per_row,
                                        const void* mask, int mask_per_row, void* out,
                                        void* o_acc, int B, int H, int T, int D, int t_pad,
                                        int span, int has_sentinel, void* stream) {
  using namespace a2v;
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      span <= 0 || span % kStepKeys != 0 || t_pad < T || t_pad % span != 0 ||
      (t_pad > span && o_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Int8Args a{H, T, D, t_pad, span, pos_per_row ? T : 0, mask_per_row ? T : 0};
  const dim3 grid((T + kTile * kWG - 1) / (kTile * kWG), H, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int8_t*>(q8);
  const auto* k = static_cast<const int8_t*>(k8);
  const auto* v = static_cast<const int8_t*>(v8t);
  const auto* fq = static_cast<const float*>(qs);
  const auto* fk = static_cast<const float*>(ks);
  const auto* fv = static_cast<const float*>(vsc);
  const auto* sl = static_cast<const float*>(slopes);
  const auto* p = static_cast<const int*>(pos);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<bf16*>(out);
  auto* oa = static_cast<float*>(o_acc);
  const bool has_mask = mk != nullptr, sentinel = has_sentinel != 0;
  if (D == 64)
    return launch_flags<1>(has_mask, sentinel, grid, s, q, fq, k, fk, v, fv, sl, p, mk, o, oa, a);
  return launch_flags<2>(has_mask, sentinel, grid, s, q, fq, k, fk, v, fv, sl, p, mk, o, oa, a);
}
