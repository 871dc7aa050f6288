// Tensor-core rate probe: iters repeats of one (m, k) x (k, n) product
// into one fp32 accumulator, through wgmma or through mma.sync.
//
//   out[M, N] = sum over iters of a[M, K] b[K, N]   fp32 sums, bf16 a, b
//             = iters * (a b) up to the order of the sums
//
// Replaces the TPU kernel bench/attn_probe.py:25 probe (its kernel at :29,
// pallas_call at :49), which asked whether head dim 64 runs the TPU's MXU
// at half rate: one pallas_call whose grid of iters steps each ran the
// whole (m, k) x (k, n) dot on blocks resident in VMEM into a VMEM
// accumulator, at flash-attention tile shapes: QK^T (1024, D) x (D, 2048)
// for D 64, 128, 256, PV (1024, 2048) x (2048, D) for D 64, 128, and a
// 1024^3 square, iters 512 (256 at D 256).
//
// Bound on the H100: 2 M K N iters operations at the 989 TFLOP/s bf16 peak
// (the operands are read once: a few MB): QK^T and PV at D 64 0.137 TFLOP
// (0.139 ms), at D 128 and QK^T at D 256 0.278 ms, the square 1.10 TFLOP
// (1.11 ms); by operations. A block owns a 64-row output tile, so the
// 1024-row outputs make 16 row tiles times N / BN column tiles: fewer
// blocks than the 132 SMs (128 for QK^T, 64 for the square, 16 for PV),
// and the bound of the busy SMs alone is 132 / blocks times the card's.
// The probes report the rate per busy SM beside the card's; iters is not
// split across blocks.
//
// Design (sm_90a): one block of 128 threads per 64 x BN output tile, BN the
// widest of 256, 128, 64 that divides N. The operands of a K step, a's 64
// rows and b's BN columns, are 64 elements deep and sit in shared memory as
// 128-byte swizzled tiles (sm90.cuh), b as its transpose bt (N, K), K-major
// (the wrapper takes b as a (K, N) view of a contiguous bt). Where every K
// step of the block's slices fits in shared memory (K (64 + BN) 2 bytes <=
// 227 KB: QK^T at D 64, 128, 256) they are staged once and stay resident
// through the iterations; otherwise (PV's 64 x 2048 a slice alone is 256
// KB; the square) a 3-stage cp.async ring streams them from L2 again in
// every iteration. Two routes over the same tiles:
//   - wgmma: the warpgroup issues SS wgmma m64nBNk16 (BN 64, 128 or 256)
//     from the swizzled tiles; resident, each iteration's products are one
//     commit group, with one group left in flight;
//   - mma.sync m16n8k16: warp w owns all 64 rows and columns w BN / 4 ..,
//     its A and B fragments loaded from the swizzled tiles by ldmatrix
//     (conflict-free: the eight rows of a matrix sit in eight chunks).
#include "sm90.cuh"

namespace a2v {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kMThreads = 128;
constexpr int kMRows = 64;          // output tile rows: wgmma's M
constexpr int kMStages = 3;         // ring depth of a streamed K step
constexpr int kMSmemMax = 232448;   // dynamic shared memory a block can have
enum Route { kWgmma = 0, kMmaSync = 1 };

// one K step of a's rows and b's columns: a 64-row tile, then BN rows of bt
template <int BN>
__host__ __device__ constexpr int step_elems() { return (kMRows + BN) * kRowElems; }

#define A2V_F16(c, o) \
  c(d[o + 0]), c(d[o + 1]), c(d[o + 2]), c(d[o + 3]), \
  c(d[o + 4]), c(d[o + 5]), c(d[o + 6]), c(d[o + 7]), \
  c(d[o + 8]), c(d[o + 9]), c(d[o + 10]), c(d[o + 11]), \
  c(d[o + 12]), c(d[o + 13]), c(d[o + 14]), c(d[o + 15])
#define A2V_D128(c)                                                                   \
  A2V_F16(c, 0), A2V_F16(c, 16), A2V_F16(c, 32), A2V_F16(c, 48), A2V_F16(c, 64),      \
      A2V_F16(c, 80), A2V_F16(c, 96), A2V_F16(c, 112)
#define A2V_RW(x) "+f"(x)

// d (64 x 256 fp32, 128 registers, sm90.cuh's accumulator layout once per
// 8 columns, j < 32) += A (64 x 16) . B (16 x 256), both K-major
// descriptors.
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
    "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
    "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
    "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
    "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
    "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
    "%124, %125, %126, %127"
    "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : A2V_D128(A2V_RW)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef A2V_F16
#undef A2V_D128
#undef A2V_RW

// d += A . B over one k16 step for a 64 x BN tile
template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64)
    wgmma_ss<true, 0, 0>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_bf16_n128(d, da, db, 1);
  else
    wgmma_bf16_n256(d, da, db);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16 x 8 fp32, common.cuh's C layout) += A (16 x 16) . B (16 x 8)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The mma.sync route's products of one K step held at sA (a's 64-row tile,
// then bt's BN rows): warp w's 64 x BN / 4 tile, four k16 steps.
template <int BN>
__device__ __forceinline__ void mma_sync_step(float (&acc)[4][BN / 32][4], const bf16* sA,
                                              int warp, int lane) {
  constexpr int kWN = BN / 4;  // the warp's columns
  const bf16* sB = sA + kTileElems;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4][4], bfr[kWN / 8][2];
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)  // rows 16 mb + (lane & 15), k 16 kk + 8 (lane >> 4)
      ldmatrix_x4(af[mb], sA + sw128(16 * mb + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < kWN / 16; ++np) {  // columns w kWN + 16 np .., two n8 blocks
      uint32_t r[4];
      ldmatrix_x4(r, sB + sw128(warp * kWN + 16 * np + (lane & 7) + ((lane >> 4) << 3),
                                2 * kk + ((lane >> 3) & 1)));
      bfr[2 * np][0] = r[0];
      bfr[2 * np][1] = r[1];
      bfr[2 * np + 1][0] = r[2];
      bfr[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
      for (int nb = 0; nb < kWN / 8; ++nb) mma_16816(acc[mb][nb], af[mb], bfr[nb]);
    }
  }
}

template <int ROUTE, int BN, bool RESIDENT>
__global__ void __launch_bounds__(kMThreads, 1)
probe_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bt,
                 float* __restrict__ out, int M, int K, int N, int iters) {
  constexpr int kStep = step_elems<BN>();
  extern __shared__ uint8_t smem_raw[];
  bf16* const base = reinterpret_cast<bf16*>(align_tiles(smem_raw));
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kMRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int n_k = K / kRowElems;

  // K step ks of the block's slices into buffer buf; the caller commits
  auto stage = [&](int ks, int buf) {
    bf16* dst = base + buf * kStep;
    stage_tile<kMThreads>(dst, a + ks * kRowElems, K, m0, M, tid);
#pragma unroll
    for (int t = 0; t < BN / kTileRows; ++t)
      stage_tile<kMThreads>(dst + (1 + t) * kTileElems, bt + ks * kRowElems, K,
                            n0 + t * kTileRows, N, tid);
  };

  float wacc[BN / 2];  // the wgmma route's accumulator
  float macc[4][BN / 32][4];  // the mma.sync route's
  if constexpr (ROUTE == kWgmma) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) wacc[i] = 0.f;
  } else {
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int nb = 0; nb < BN / 32; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) macc[mb][nb][e] = 0.f;
  }
  const uint64_t desc_base = desc_sw128(base);
  constexpr uint64_t kDescStep = (kStep * 2) >> 4;
  // the products of the K step in buffer buf (issue only on the wgmma route)
#define A2V_PRODUCTS(buf)                                                      \
  do {                                                                         \
    if constexpr (ROUTE == kWgmma) {                                           \
      const uint64_t da = desc_base + (buf) * kDescStep, db = da + kDescTile;  \
      _Pragma("unroll") for (int kk = 0; kk < kRowElems / 16; ++kk)            \
          wgmma_k16<BN>(wacc, da + kk * kDescStepK, db + kk * kDescStepK);     \
    } else {                                                                   \
      mma_sync_step<BN>(macc, base + (buf) * kStep, warp, lane);               \
    }                                                                          \
  } while (0)

  if constexpr (RESIDENT) {
    for (int ks = 0; ks < n_k; ++ks) stage(ks, ks);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      if constexpr (ROUTE == kWgmma) wgmma_fence();
      for (int ks = 0; ks < n_k; ++ks) A2V_PRODUCTS(ks);
      if constexpr (ROUTE == kWgmma) {
        wgmma_commit();
        wgmma_wait<1>();  // one iteration's group stays in flight
      }
    }
    if constexpr (ROUTE == kWgmma) {
      wgmma_wait<0>();
      fence_regs(wacc);
    }
  } else {
    const int n_steps = iters * n_k;
#pragma unroll
    for (int s = 0; s < kMStages - 1; ++s) {
      if (s < n_steps) stage(s % n_k, s);
      cp_async_commit();
    }
    for (int st = 0; st < n_steps; ++st) {
      cp_async_wait<kMStages - 2>();  // this thread's copies of step st have landed
      fence_proxy_async();
      __syncthreads();  // step st visible to all; every warp is done with step st - 1
      const int nx = st + kMStages - 1;
      if (nx < n_steps) stage(nx % n_k, nx % kMStages);  // into step st - 1's buffer
      cp_async_commit();
      if constexpr (ROUTE == kWgmma) wgmma_fence();
      A2V_PRODUCTS(st % kMStages);
      if constexpr (ROUTE == kWgmma) {
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(wacc);
      }
    }
  }

#undef A2V_PRODUCTS

  // fp32 out, float2 stores from the accumulator layouts
  if constexpr (ROUTE == kWgmma) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 16 * warp + g + 8 * r, col = n0 + 8 * j + 2 * i4;
        if (row < M)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * N + col) =
              make_float2(wacc[4 * j + 2 * r], wacc[4 * j + 2 * r + 1]);
      }
    }
  } else {
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
      for (int nb = 0; nb < BN / 32; ++nb) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + 16 * mb + g + 8 * r;
          const int col = n0 + warp * (BN / 4) + 8 * nb + 2 * i4;
          if (row < M)
            *reinterpret_cast<float2*>(out + static_cast<long long>(row) * N + col) =
                make_float2(macc[mb][nb][2 * r], macc[mb][nb][2 * r + 1]);
        }
      }
    }
  }
}

template <int ROUTE, int BN, bool RESIDENT>
int launch(cudaStream_t s, const bf16* a, const bf16* bt, float* out, int M, int K, int N,
           int iters) {
  constexpr auto kernel = probe_mma_kernel<ROUTE, BN, RESIDENT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int steps = RESIDENT ? K / kRowElems : kMStages;
  const int smem = steps * step_elems<BN>() * 2 + kTileAlign;
  if (smem > kMSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / BN, (M + kMRows - 1) / kMRows);
  kernel<<<grid, kMThreads, smem, s>>>(a, bt, out, M, K, N, iters);
  return static_cast<int>(cudaGetLastError());
}

template <int ROUTE, int BN>
int by_residence(bool resident, cudaStream_t s, const bf16* a, const bf16* bt, float* out, int M,
                 int K, int N, int iters) {
  return resident ? launch<ROUTE, BN, true>(s, a, bt, out, M, K, N, iters)
                  : launch<ROUTE, BN, false>(s, a, bt, out, M, K, N, iters);
}

template <int ROUTE>
int by_width(int block_n, bool resident, cudaStream_t s, const bf16* a, const bf16* bt,
             float* out, int M, int K, int N, int iters) {
  switch (block_n) {
    case 64:
      return by_residence<ROUTE, 64>(resident, s, a, bt, out, M, K, N, iters);
    case 128:
      return by_residence<ROUTE, 128>(resident, s, a, bt, out, M, K, N, iters);
    case 256:
      return by_residence<ROUTE, 256>(resident, s, a, bt, out, M, K, N, iters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace a2v

// C entry, bound with ctypes. a (M, K) and bt (N, K) bf16 row-major, out
// (M, N) fp32; all 16-byte aligned; K a multiple of 64; block_n 64, 128 or
// 256 and dividing N; resident 1 to stage every K step once (refused where
// they do not fit), 0 to stream them; route 0 wgmma, 1 mma.sync. Returns a
// cudaError_t.
extern "C" int a2v_probe_mma(const void* a, const void* bt, void* out, int M, int K, int N,
                             int iters, int route, int block_n, int resident, void* stream) {
  using namespace a2v;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M <= 0 || K <= 0 || K % kRowElems != 0 || N <= 0 || block_n <= 0 || N % block_n != 0 ||
      iters <= 0 || (M + kMRows - 1) / kMRows > 65535 || misaligned(a) || misaligned(bt) ||
      misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const bf16*>(a);
  const auto* bp = static_cast<const bf16*>(bt);
  auto* op = static_cast<float*>(out);
  if (route == kWgmma)
    return by_width<kWgmma>(block_n, resident != 0, s, ap, bp, op, M, K, N, iters);
  if (route == kMmaSync)
    return by_width<kMmaSync>(block_n, resident != 0, s, ap, bp, op, M, K, N, iters);
  return static_cast<int>(cudaErrorInvalidValue);
}
