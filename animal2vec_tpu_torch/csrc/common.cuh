// Shared device helpers for the Hopper kernels: cp.async copies, bf16
// packing, ex2, warp reductions, exact-erf GELU, the dropout hash, and the
// int8 quantizer.
//
// Register layouts of mma.sync.m16n8k16 (PTX ISA), lane = 4*g + i, which
// the wgmma kernels' accumulators and register A operands share per warp
// (sm90.cuh):
//   A (16x16, row-major): reg0 = A[g][2i..2i+1],   reg1 = A[g+8][2i..2i+1],
//                         reg2 = A[g][2i+8..+9],   reg3 = A[g+8][2i+8..+9]
//   C (16x8, fp32):       c0,c1 = C[g][2i..2i+1],  c2,c3 = C[g+8][2i..2i+1]
// A pair of bf16 values sits in one 32-bit register, the lower column in
// the low half. The int8 A layout (m16n8k32) holds four int8 a register,
// the lowest column in the low byte: a0 = A[g][4i..4i+3], a1 = A[g+8][4i..],
// a2 = A[g][16+4i..], a3 = A[g+8][16+4i..].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace a2v {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false the 16 bytes are zero-filled
// and nothing is read (gmem must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool pred) {
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4-byte global -> shared copy (rows not 16-byte aligned); with pred false
// the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (ex2.approx, flushing denormals); 2^-inf
// is 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Exact-erf GELU in fp32.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// Counter-based dropout hash of animal2vec_tpu/ops/pallas_attention.py
// _dropout_keep and ops/fused_mlp.py _hash_keep: a murmur-style finalizer
// over (row, col) mixed with the seed word (attention: seed + bh *
// 0xC2B2AE3D; fused block: the seed). An element is kept when the hash is
// >= the host-computed threshold min(int(rate * 2^32), 2^32 - 1).
// A kernel that walks a tile may add the row and column terms itself
// (kHashRow * row + kHashCol * col, wrapping) and finish with
// drop_mix_seeded(drop_seed_mix(seed_word), z), the seed's part of the
// first xorshift done once: (z ^ s) ^ ((z ^ s) >> 15) = z ^ (z >> 15) ^
// (s ^ (s >> 15)).
constexpr uint32_t kHashRow = 0x9E3779B1u, kHashCol = 0x85EBCA77u;

__device__ __forceinline__ uint32_t drop_seed_mix(uint32_t seed_word) {
  return seed_word ^ (seed_word >> 15);
}

__device__ __forceinline__ uint32_t drop_mix_seeded(uint32_t seed_mix, uint32_t z) {
  z ^= (z >> 15) ^ seed_mix;
  z *= 0x2C1B3C6Du;
  z ^= z >> 12;
  z *= 0x297A2D39u;
  z ^= z >> 15;
  return z;
}

__device__ __forceinline__ uint32_t drop_hash(uint32_t seed_word, uint32_t row, uint32_t col) {
  return drop_mix_seeded(drop_seed_mix(seed_word), row * kHashRow + col * kHashCol);
}

// Dropout of one site: keep when drop_hash(seed, row0 + row, col0 + col) >=
// thresh (row0: a data-parallel rank's first global row; col0: a
// tensor-parallel rank's first hidden column of a GEMM epilogue's output;
// 0 otherwise).
struct DropSite {
  uint32_t seed;
  uint32_t thresh;
  float keep_scale;  // 1 / (1 - rate)
  uint32_t row0 = 0;
  uint32_t col0 = 0;
};

// Dropout factor of one element: keep_scale (1 / (1 - rate)) or 0.
__device__ __forceinline__ float drop_factor(uint32_t seed_word, uint32_t row, uint32_t col,
                                             uint32_t thresh, float keep_scale) {
  return drop_hash(seed_word, row, col) >= thresh ? keep_scale : 0.f;
}

// int8 quantization (ops/int8_mm.py): a scale is max(max|v| * kInv127,
// 1e-12), the product XLA makes of the JAX code's division by 127; a value
// is rint(v / s) with an IEEE division (nvcc's default -prec-div=true; never
// build with fast-math), round half to even, within [-127, 127].
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ int quantize_s8(float v, float s) {
  return __float2int_rn(__fdiv_rn(v, s));
}

// Four int8 values in one 32-bit register, the first in the low byte.
__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

}  // namespace a2v
