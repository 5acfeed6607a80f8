// segment_reduce: out[i, :] = sum_{k = row_ptr[i]}^{row_ptr[i+1]-1} msgs[src(k), :]
// with src(k) = k, or order[k] when an order array is given.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/sddmm_kernel.py
// (_segment_reduce_kernel, called by segment_reduce_pallas): the forward
// segment sums of segment_sum_planned and the backward scatter of
// gather_planned (graph_hscn_tpu/ops/segment.py).  The receiver side runs
// on the CSR's row pointers over the edges in their own order; the sender
// side on the transpose's row pointers with order = t_order, so the
// permutation of the cotangent is folded into the kernel's loads instead of
// an [E, F] gather before it.
//
// Bound: bytes.  Each edge's F values are read once and added once, each
// output row is written once; one add per value read is far below the
// card's operations-per-byte balance.  The design keeps the traffic to that:
//   - one warp per output row; lane l holds V consecutive features
//     (f0 + l*V .. f0 + l*V + V-1), so a warp's load of one message row is
//     one coalesced vector load (V = 2 floats, 256 bytes, at F = 64);
//   - the row's sum stays in registers, each output element is written
//     exactly once: no atomics, deterministic, and no zero-fill launch (a
//     row with no edges writes zeros);
//   - order[k] is the same address across the warp, one broadcast load.
// Slots past row_ptr[n_rows] (padding) are never read.  msgs is float32 or
// bfloat16; bfloat16 values are exact in float32, so the sum of a bfloat16
// input is those values summed in float32, as the Pallas kernel's bf16
// one-hot matmul with float32 accumulation sums them.  The output is
// float32.  Indices: row_ptr int32, order int64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_reduce_kernel(const int* __restrict__ row_ptr,
                      const long long* __restrict__ order,
                      const T* __restrict__ msgs, float* __restrict__ out,
                      int n_rows, int f) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  float* out_row = out + static_cast<size_t>(row) * f;
  for (int f0 = 0; f0 < f; f0 += 32 * V) {
    const int j = f0 + lane * V;  // f % V == 0: j < f covers all V values
    if (j >= f) break;
    Pack<float, V> acc;
#pragma unroll
    for (int v = 0; v < V; ++v) acc.v[v] = 0.0f;
#pragma unroll 4
    for (int k = beg; k < end; ++k) {
      const size_t src = order != nullptr ? static_cast<size_t>(order[k])
                                          : static_cast<size_t>(k);
      const Pack<T, V> m =
          *reinterpret_cast<const Pack<T, V>*>(msgs + src * f + j);
#pragma unroll
      for (int v = 0; v < V; ++v) acc.v[v] += to_float(m.v[v]);
    }
    *reinterpret_cast<Pack<float, V>*>(out_row + j) = acc;
  }
}

template <typename T, int V>
void launch(const int* row_ptr, const long long* order, const void* msgs,
            float* out, int n_rows, int f, cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_reduce_kernel<T, V><<<grid, block, 0, s>>>(
      row_ptr, order, static_cast<const T*>(msgs), out, n_rows, f);
}

// The widest vector (V = 4, 2 or 1 values a lane) that F, the warp and both
// pointers allow: V divides F, 32 lanes * V do not exceed F (no lanes idled
// by a too-wide vector), and V values of T and of float are aligned at the
// base pointers (rows then stay aligned, since V divides F).
template <typename T>
int vector_width(const void* msgs, const void* out, int f) {
  for (int v = 4; v > 1; v /= 2) {
    if (f % v == 0 && f >= 32 * v &&
        reinterpret_cast<uintptr_t>(msgs) % (v * sizeof(T)) == 0 &&
        reinterpret_cast<uintptr_t>(out) % (v * sizeof(float)) == 0) {
      return v;
    }
  }
  return 1;
}

template <typename T>
void dispatch(const int* row_ptr, const long long* order, const void* msgs,
              float* out, int n_rows, int f, cudaStream_t s) {
  switch (vector_width<T>(msgs, out, f)) {
    case 4: launch<T, 4>(row_ptr, order, msgs, out, n_rows, f, s); break;
    case 2: launch<T, 2>(row_ptr, order, msgs, out, n_rows, f, s); break;
    default: launch<T, 1>(row_ptr, order, msgs, out, n_rows, f, s); break;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
// order: null (src(k) = k) or int64 [>= row_ptr[n_rows]].
// msgs_bf16: 0 for float32 msgs, 1 for bfloat16 msgs.
extern "C" int segment_reduce(const void* row_ptr, const void* order,
                              const void* msgs, int msgs_bf16, void* out,
                              int n_rows, int f, void* stream) {
  if (n_rows > 0 && f > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(row_ptr);
    const long long* ord = static_cast<const long long*>(order);
    float* o = static_cast<float*>(out);
    if (msgs_bf16) {
      dispatch<__nv_bfloat16>(rp, ord, msgs, o, n_rows, f, s);
    } else {
      dispatch<float>(rp, ord, msgs, o, n_rows, f, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
