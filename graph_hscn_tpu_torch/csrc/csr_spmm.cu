// csr_spmm: out[i, :] = sum_{e in row_ptr[i]..row_ptr[i+1]} w[e] * x[col[e], :]
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/spmm_kernel.py
// (_spmm_kernel, called by spmm_pallas) in both directions: the forward
// runs it on the receiver-sorted CSR, the backward (dx = A^T g) on the
// sender-sorted transpose with the weights permuted by t_order.
//
// Bound: bytes.  Each row moves F values of x per edge and writes F
// outputs, against 2 flops per value, far below the card's
// operations-per-byte balance.  The design keeps the traffic to one read
// of each gathered x row and one write of each output row:
//   - one warp per output row; lanes stride the feature dimension, so a
//     warp's load of x[col[e], f0 + lane] is one coalesced 128-byte line;
//   - the row's sum stays in registers (kChunks values a lane), and each
//     output element is written exactly once: no atomics, deterministic,
//     and no zero-fill launch (a row with no edges writes zeros);
//   - col[e] and w[e] are the same address across the warp, one broadcast
//     load each.
// x is float32 or bfloat16 (read with __bfloat162float); the sum and the
// output are float32.  Indices are int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = 4;  // 4 x 32 features held in registers a pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ w, const T* __restrict__ x,
                float* __restrict__ out, int n_rows, int f) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  float* out_row = out + static_cast<size_t>(row) * f;
  for (int f0 = 0; f0 < f; f0 += 32 * kChunks) {
    float acc[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) acc[k] = 0.0f;
    for (int e = beg; e < end; ++e) {
      const float we = w[e];
      const T* x_row = x + static_cast<size_t>(col[e]) * f;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int j = f0 + k * 32 + lane;
        if (j < f) acc[k] = fmaf(we, to_f32(x_row[j]), acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int j = f0 + k * 32 + lane;
      if (j < f) out_row[j] = acc[k];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
// x_bf16: 0 for float32 x, 1 for bfloat16 x.
extern "C" int csr_spmm(const void* row_ptr, const void* col, const void* w,
                        const void* x, int x_bf16, void* out, int n_rows,
                        int f, void* stream) {
  if (n_rows > 0 && f > 0) {
    const dim3 block(kWarpsPerBlock * 32);
    const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(row_ptr);
    const int* c = static_cast<const int*>(col);
    const float* wf = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    if (x_bf16) {
      csr_spmm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          rp, c, wf, static_cast<const __nv_bfloat16*>(x), o, n_rows, f);
    } else {
      csr_spmm_kernel<float><<<grid, block, 0, s>>>(
          rp, c, wf, static_cast<const float*>(x), o, n_rows, f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
