// bfloat16 storage and its conversions, shared by the kernels' bf16
// instances (dwconv.cu, quad_attention.cu, relpos_scores.cu).  A bf16 is
// the upper half of a float32: widening is exact, and narrowing rounds to
// nearest even, as jnp's astype and torch's .to(bfloat16) do.
#pragma once

#include <cuda_runtime.h>

namespace {

// bfloat16 storage: the upper half of a float32.
struct bf16 {
  unsigned short u;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __uint_as_float((unsigned)v.u << 16); }
// the low and the high element of two packed bf16, widened
__device__ __forceinline__ float lo_bf16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// float32 -> bfloat16 bits, round to nearest even (NaN stays a quiet NaN).
__device__ __forceinline__ unsigned bf16_bits(float v) {
  unsigned x = __float_as_uint(v);
  if ((x & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  x += 0x7fffu + ((x >> 16) & 1u);
  return x >> 16;
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) << 16);
}

// 4 consecutive elements widened to f32: one 16-byte read (bf16: 8 bytes).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(lo_bf16(u.x), hi_bf16(u.x), lo_bf16(u.y), hi_bf16(u.y));
}

}  // namespace
