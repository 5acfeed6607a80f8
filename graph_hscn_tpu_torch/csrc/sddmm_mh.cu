// sddmm_mh: out[e, h] = sum_c h_src[col[e], h*C + c] * h_dst[row[e], h*C + c]
//           for e < n_real; out[e, h] = 0 for the padding edges.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/multihead_kernel.py
// (_sddmm_mh_kernel, called by sddmm_mh and gat_edge_logits): per-edge,
// per-head dots in the receiver-sorted edge order.  It gives GAT's edge
// logits (C = 2: [a_src, 1] . [1, a_dst]), the max shift a_dst-side gather,
// and d(alpha) = <x[send e], g[recv e]> a head in spmm_mh's backward.
//
// Bound: bytes.  An edge reads two gathered rows of H*C values for 2*H*C
// flops and writes H floats.  At the GAT widths a launch over ~60k edges
// lasts a few microseconds, so the dependent loads (col/row -> the rows)
// and the instructions a thread issues set the time.  The design:
//   - one thread an (edge, head) output, consecutive threads on
//     consecutive outputs, so the [E, H] output is written coalesced, once,
//     with no atomics and no reduction across threads (deterministic: a
//     head's C products are summed in order by one thread); the H threads
//     of an edge read row[e] and col[e] in one broadcast load each;
//   - the thread reads its head's C values of both rows as vectors of V
//     values (16, 8, 4 or 2 bytes, the widest whose values divide C, so
//     that every vector is aligned), VP vectors of each row in flight at
//     once (at most 64 bytes), in chunks along the head; the plan
//     (ops/cuda/multihead_kernel.py:multihead_plan) picks V and VP;
//   - padding edges write 0 here, so the output needs no zero-fill launch.
// A walk by CSR row, each receiver row's vectors held in registers for its
// edges, and lane groups of several lanes a head were measured slower at
// every width of the GAT step (PERF.md): the extra dependent load of
// row_ptr and the instructions of the shuffles cost more than the receiver
// row's reuse saves, which the L1 serves anyway (consecutive edges share a
// receiver).  Each operand is float32 or bfloat16 on its own (spmm_mh's
// backward pairs a bfloat16 x with a float32 gradient); products and sums
// are float32 with no bfloat16 rounding point, as in the Pallas body.
// Indices int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// V values, aligned as one load of at most 16 bytes (8 floats beside a
// bfloat16 operand's 8 are two).
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TS, typename TD, int V, int VP>
__global__ void __launch_bounds__(kThreads)
sddmm_mh_kernel(const int* __restrict__ row, const int* __restrict__ col,
                const TS* __restrict__ h_src, const TD* __restrict__ h_dst,
                float* __restrict__ out, int n_edges, int n_real, int heads,
                int c) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= static_cast<long long>(n_edges) * heads) return;
  const int e = static_cast<int>(t / heads);
  float acc = 0.0f;
  if (e < n_real) {
    const size_t f = static_cast<size_t>(heads) * c;
    const size_t head = static_cast<size_t>(t - static_cast<long long>(e) *
                                                    heads) * c;
    const TS* s = h_src + __ldg(col + e) * f + head;
    const TD* d = h_dst + __ldg(row + e) * f + head;
    for (int k0 = 0; k0 < c; k0 += V * VP) {
      Pack<TS, V> sv[VP];
      Pack<TD, V> dv[VP];
#pragma unroll
      for (int q = 0; q < VP; ++q) {
        if (k0 + q * V < c) {
          sv[q] = *reinterpret_cast<const Pack<TS, V>*>(s + k0 + q * V);
          dv[q] = *reinterpret_cast<const Pack<TD, V>*>(d + k0 + q * V);
        }
      }
#pragma unroll
      for (int q = 0; q < VP; ++q) {
        if (k0 + q * V < c) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc = fmaf(to_f32(sv[q].v[v]), to_f32(dv[q].v[v]), acc);
        }
      }
    }
  }
  out[t] = acc;
}

struct Args {
  const int* row;
  const int* col;
  const void* h_src;
  const void* h_dst;
  float* out;
  int n_edges, n_real, heads, c;
};

// Launches the instance <TS, TD, V, VP> if it is plan (vec, passes).
template <typename TS, typename TD, int V, int VP>
bool launch_if(int vec, int passes, const Args& a, cudaStream_t s) {
  if (vec != V || passes != VP) return false;
  const long long total = static_cast<long long>(a.n_edges) * a.heads;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  sddmm_mh_kernel<TS, TD, V, VP><<<grid, kThreads, 0, s>>>(
      a.row, a.col, static_cast<const TS*>(a.h_src),
      static_cast<const TD*>(a.h_dst), a.out, a.n_edges, a.n_real, a.heads,
      a.c);
  return true;
}

// With a bfloat16 operand: one vector (vec of 8, 4, 2 or 1) in flight.
template <typename TS, typename TD>
bool dispatch_bf16(int vec, int passes, const Args& a, cudaStream_t s) {
  return launch_if<TS, TD, 8, 1>(vec, passes, a, s) ||
         launch_if<TS, TD, 4, 1>(vec, passes, a, s) ||
         launch_if<TS, TD, 2, 1>(vec, passes, a, s) ||
         launch_if<TS, TD, 1, 1>(vec, passes, a, s);
}

// The only instances built: the (V, VP) that multihead_plan
// (ops/cuda/multihead_kernel.py) returns for float32 operands and for a
// bfloat16 one (tests/test_torch_multihead_plan.py holds the two lists
// equal).  False for any other plan.
bool dispatch(bool src_bf16, bool dst_bf16, int vec, int passes,
              const Args& a, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (src_bf16 && dst_bf16) return dispatch_bf16<bf16, bf16>(vec, passes, a, s);
  if (src_bf16) return dispatch_bf16<bf16, float>(vec, passes, a, s);
  if (dst_bf16) return dispatch_bf16<float, bf16>(vec, passes, a, s);
  return launch_if<float, float, 4, 4>(vec, passes, a, s) ||
         launch_if<float, float, 4, 2>(vec, passes, a, s) ||
         launch_if<float, float, 4, 1>(vec, passes, a, s) ||
         launch_if<float, float, 2, 1>(vec, passes, a, s) ||
         launch_if<float, float, 1, 1>(vec, passes, a, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without a launch for a plan the kernel does not
// take.  src_bf16 / dst_bf16: 0 for a float32 operand, 1 for a bfloat16
// one.  h_src and h_dst are [N, heads * c], 16-byte aligned; out is
// [n_edges, heads]; row and col [n_edges].  The plan (vec, passes) is
// multihead_plan's for the narrower operand, one of dispatch's instances:
// vec divides c; passes vectors of each row in flight.
extern "C" int sddmm_mh(const void* row, const void* col, const void* h_src,
                        int src_bf16, const void* h_dst, int dst_bf16,
                        void* out, int n_edges, int n_real, int heads, int c,
                        int vec, int passes, void* stream) {
  if (vec < 1 || c % vec != 0 || n_real < 0 || n_real > n_edges ||
      reinterpret_cast<uintptr_t>(h_src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(h_dst) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_edges > 0 && heads > 0 && c > 0) {
    const Args a{static_cast<const int*>(row), static_cast<const int*>(col),
                 h_src, h_dst, static_cast<float*>(out), n_edges, n_real,
                 heads, c};
    if (!dispatch(src_bf16 != 0, dst_bf16 != 0, vec, passes, a,
                  static_cast<cudaStream_t>(stream))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
