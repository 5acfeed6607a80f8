// sddmm_mh: out[e, h] = sum_c h_src[col[e], h*C + c] * h_dst[row[e], h*C + c]
//           for e < n_real; out[e, h] = 0 for the padding edges.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/multihead_kernel.py
// (_sddmm_mh_kernel, called by sddmm_mh and gat_edge_logits): per-edge,
// per-head dots in the receiver-sorted edge order.  It gives GAT's edge
// logits (C = 2: [a_src, 1] . [1, a_dst]), the max shift a_dst-side gather,
// and d(alpha) = <x[send e], g[recv e]> a head in spmm_mh's backward.
//
// Bound: bytes.  An edge reads two rows of H*C values for 2*H*C flops and
// writes H floats.  The design:
//   - one thread per (edge, head) output, consecutive threads on
//     consecutive outputs, so the [E, H] output is written coalesced, once,
//     with no atomics and no reduction across threads (deterministic);
//   - a thread reads its head's C contiguous values of the two rows; the H
//     threads of an edge together read each row once, and the lines they
//     share are served from L1;
//   - padding edges write 0 here, so the output needs no zero-fill launch.
// Each operand is float32 or bfloat16 on its own (spmm_mh's backward pairs
// a bfloat16 x with a float32 gradient); products and sums are float32
// with no bfloat16 rounding point, as in the Pallas body.  Indices int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TS, typename TD>
__global__ void __launch_bounds__(kThreads)
sddmm_mh_kernel(const int* __restrict__ row, const int* __restrict__ col,
                const TS* __restrict__ h_src, const TD* __restrict__ h_dst,
                float* __restrict__ out, int n_edges, int n_real, int heads,
                int c) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= static_cast<long long>(n_edges) * heads) return;
  const int e = static_cast<int>(t / heads);
  const int h = static_cast<int>(t - static_cast<long long>(e) * heads);
  float acc = 0.0f;
  if (e < n_real) {
    const size_t f = static_cast<size_t>(heads) * c;
    const TS* s = h_src + static_cast<size_t>(col[e]) * f +
                  static_cast<size_t>(h) * c;
    const TD* d = h_dst + static_cast<size_t>(row[e]) * f +
                  static_cast<size_t>(h) * c;
    for (int k = 0; k < c; ++k) acc = fmaf(to_f32(s[k]), to_f32(d[k]), acc);
  }
  out[t] = acc;
}

template <typename TS, typename TD>
void launch(const int* row, const int* col, const void* h_src,
            const void* h_dst, float* out, int n_edges, int n_real,
            int heads, int c, cudaStream_t s) {
  const long long total = static_cast<long long>(n_edges) * heads;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  sddmm_mh_kernel<TS, TD><<<grid, kThreads, 0, s>>>(
      row, col, static_cast<const TS*>(h_src), static_cast<const TD*>(h_dst),
      out, n_edges, n_real, heads, c);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
// src_bf16 / dst_bf16: 0 for a float32 operand, 1 for a bfloat16 one.
// h_src and h_dst are [N, heads * c]; out is [n_edges, heads].
extern "C" int sddmm_mh(const void* row, const void* col, const void* h_src,
                        int src_bf16, const void* h_dst, int dst_bf16,
                        void* out, int n_edges, int n_real, int heads, int c,
                        void* stream) {
  if (n_edges > 0 && heads > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* r = static_cast<const int*>(row);
    const int* cl = static_cast<const int*>(col);
    float* o = static_cast<float*>(out);
    if (src_bf16 && dst_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(r, cl, h_src, h_dst, o, n_edges,
                                           n_real, heads, c, s);
    } else if (src_bf16) {
      launch<__nv_bfloat16, float>(r, cl, h_src, h_dst, o, n_edges, n_real,
                                   heads, c, s);
    } else if (dst_bf16) {
      launch<float, __nv_bfloat16>(r, cl, h_src, h_dst, o, n_edges, n_real,
                                   heads, c, s);
    } else {
      launch<float, float>(r, cl, h_src, h_dst, o, n_edges, n_real, heads, c,
                           s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
