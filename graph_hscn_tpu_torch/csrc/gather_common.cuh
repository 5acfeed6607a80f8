// What csr_spmm.cu and edge_sddmm.cu share: vectors of up to 16 bytes,
// bfloat16 conversions, and a grid of one wave.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gather {

// V values, aligned as one load of at most 16 bytes (8 floats beside a
// bfloat16 operand's 8 are two loads).
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The blocks of `threads` threads that one SM holds at once for `kernel`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; at least 1).  A launcher
// asks once an instance and keeps the answer.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
  return n > 0 ? n : 1;
}

// A grid of one wave: the `need` blocks where the card holds them all at
// once (`per_sm` on each SM), else as many as it holds, whose warps then
// stride over the rest of the work.
inline unsigned one_wave(long long need, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = static_cast<long long>(per_sm) * (sms > 0 ? sms : 1);
  return static_cast<unsigned>(need < most ? need : most);
}

}  // namespace gather
