// Shared pieces of the fused dense GCN stack kernels (fused_gcn_fwd.cu,
// fused_gcn_bwd.cu): the compute-type helpers and the launch limits.
//
// The compute type T is float or __nv_bfloat16.  T is only what the
// operands are stored in: every product accumulates in float32, and a value
// "rounded to T" is float32 -> T -> float32 (round to nearest even), the
// point where the JAX kernel casts to its compute dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_gcn {

constexpr int kThreads = 512;
constexpr int kMaxLayers = 8;
constexpr int kSmemLimit = 232448;  // bytes a block may use on Hopper

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive values starting at p (16-byte aligned for float, 8-byte
// for bfloat16), widened to float32.  A bfloat16 is the top half of the
// float32 with the same bits.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__host__ __device__ __forceinline__ int round4(int f) { return (f + 3) & ~3; }

}  // namespace fused_gcn
