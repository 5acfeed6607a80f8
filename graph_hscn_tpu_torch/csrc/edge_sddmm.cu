// edge_sddmm: out[e] = <h_src[col[e], :], h_dst[row[e], :]> for e < n_real,
//             out[e] = 0 for the padding edges n_real <= e < n_edges.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/sddmm_kernel.py
// (_sddmm_kernel, called by sddmm_pallas).  In the SpMM backward it gives
// the edge-weight gradient dw[e] = <x[send e], g[recv e]>.  The output is
// in the receiver-sorted edge order of the batch, length n_edges.
//
// Bound: bytes.  Each edge reads two feature rows (2 F values) for 2 F
// flops.  The design reads each of the two rows once, coalesced:
//   - one warp per edge; lanes stride the feature dimension, so each row is
//     read as whole 128-byte lines;
//   - the lanes' partial sums are reduced in registers with
//     __shfl_xor_sync, and lane 0 writes the edge's one float32;
//   - padding edges write 0 here, so the output needs no zero-fill launch.
// Each operand is float32 or bfloat16 on its own (the backward pairs a
// bfloat16 x with a float32 gradient); the sum is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TS, typename TD>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_sddmm_kernel(const int* __restrict__ row, const int* __restrict__ col,
                  const TS* __restrict__ h_src, const TD* __restrict__ h_dst,
                  float* __restrict__ out, int n_edges, int n_real, int f) {
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n_edges) return;  // warp-uniform: the whole warp leaves
  float acc = 0.0f;
  if (e < n_real) {
    const TS* s = h_src + static_cast<size_t>(col[e]) * f;
    const TD* d = h_dst + static_cast<size_t>(row[e]) * f;
    for (int j = lane; j < f; j += 32) {
      acc = fmaf(to_f32(s[j]), to_f32(d[j]), acc);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) out[e] = acc;
}

template <typename TS, typename TD>
void launch(const int* row, const int* col, const void* h_src,
            const void* h_dst, float* out, int n_edges, int n_real, int f,
            cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_edges + kWarpsPerBlock - 1) / kWarpsPerBlock);
  edge_sddmm_kernel<TS, TD><<<grid, block, 0, s>>>(
      row, col, static_cast<const TS*>(h_src), static_cast<const TD*>(h_dst),
      out, n_edges, n_real, f);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
// src_bf16 / dst_bf16: 0 for a float32 operand, 1 for a bfloat16 one.
extern "C" int edge_sddmm(const void* row, const void* col, const void* h_src,
                          int src_bf16, const void* h_dst, int dst_bf16,
                          void* out, int n_edges, int n_real, int f,
                          void* stream) {
  if (n_edges > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* r = static_cast<const int*>(row);
    const int* c = static_cast<const int*>(col);
    float* o = static_cast<float*>(out);
    if (src_bf16 && dst_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(r, c, h_src, h_dst, o, n_edges,
                                           n_real, f, s);
    } else if (src_bf16) {
      launch<__nv_bfloat16, float>(r, c, h_src, h_dst, o, n_edges, n_real,
                                   f, s);
    } else if (dst_bf16) {
      launch<float, __nv_bfloat16>(r, c, h_src, h_dst, o, n_edges, n_real,
                                   f, s);
    } else {
      launch<float, float>(r, c, h_src, h_dst, o, n_edges, n_real, f, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
