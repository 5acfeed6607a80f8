// spmm_mh: out[i, h*C + c] = sum_{e in row_ptr[i]..row_ptr[i+1]}
//                              alpha[e, h] * x[col[e], h*C + c]
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/multihead_kernel.py
// (_spmm_mh_kernel, called by spmm_mh): the per-head weighted SpMM of GAT's
// attention aggregation, all H heads in one launch.  The forward runs it on
// the receiver-sorted CSR; the backward's dx runs it on the sender-sorted
// transpose with alpha permuted by t_order, and sddmm_mh's backward runs it
// twice (once each way).
//
// Bound: bytes.  An edge moves H*C values of x and H weights for 2*H*C
// flops, far below the card's operations-per-byte balance.  The design
// keeps the traffic to one read of each gathered x row and one write of
// each output row, as csr_spmm does:
//   - one warp per output row; lanes stride the head-blocked feature axis,
//     so a warp's load of x[col[e], f0 + lane] is one coalesced line;
//   - the head of feature j is j / C, computed once a lane and chunk (C is
//     not a power of two on the main path: 16, 21 and 2), and features at
//     or past H*C are masked;
//   - alpha[e, h] is read by the lanes of head h, the H weights of an edge
//     sharing one line;
//   - the row's sum stays in registers and each output element is written
//     exactly once: no atomics, deterministic, no zero-fill launch.
// x is float32 or bfloat16; alpha, the sum and the output are float32.  For
// bfloat16 x each term is rounded as the Pallas body rounds it
// (multihead_kernel.py:86, :107-108): the product f32(x_j) * alpha, alpha
// unrounded, to bfloat16, summed in float32.  Indices are int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = 4;  // 4 x 32 features held in registers a pass

__device__ __forceinline__ float add_term(float acc, float a, float x) {
  return fmaf(a, x, acc);
}
__device__ __forceinline__ float add_term(float acc, float a,
                                          __nv_bfloat16 x) {
  return acc + __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) * a));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_mh_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
               const float* __restrict__ alpha, const T* __restrict__ x,
               float* __restrict__ out, int n_rows, int heads, int c) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int f = heads * c;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  float* out_row = out + static_cast<size_t>(row) * f;
  for (int f0 = 0; f0 < f; f0 += 32 * kChunks) {
    float acc[kChunks];
    int head[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      acc[k] = 0.0f;
      const int j = f0 + k * 32 + lane;
      head[k] = j < f ? j / c : 0;
    }
    for (int e = beg; e < end; ++e) {
      const float* a_row = alpha + static_cast<size_t>(e) * heads;
      const T* x_row = x + static_cast<size_t>(col[e]) * f;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int j = f0 + k * 32 + lane;
        if (j < f) acc[k] = add_term(acc[k], a_row[head[k]], x_row[j]);
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
// x_bf16: 0 for float32 x, 1 for bfloat16 x.  x and out are [n_rows,
// heads * c], alpha [>= row_ptr[n_rows], heads].
extern "C" int spmm_mh(const void* row_ptr, const void* col,
                       const void* alpha, const void* x, int x_bf16,
                       void* out, int n_rows, int heads, int c,
                       void* stream) {
  if (n_rows > 0 && heads > 0 && c > 0) {
    const dim3 block(kWarpsPerBlock * 32);
    const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(row_ptr);
    const int* cl = static_cast<const int*>(col);
    const float* a = static_cast<const float*>(alpha);
    float* o = static_cast<float*>(out);
    if (x_bf16) {
      spmm_mh_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          rp, cl, a, static_cast<const __nv_bfloat16*>(x), o, n_rows, heads,
          c);
    } else {
      spmm_mh_kernel<float><<<grid, block, 0, s>>>(
          rp, cl, a, static_cast<const float*>(x), o, n_rows, heads, c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
