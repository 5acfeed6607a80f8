// csr_spmm: out[i, :] = sum_{k in row_ptr[i]..row_ptr[i+1]} w[src(k)] * x[col[k], :]
// with src(k) = k, or order[k] when an order array is given.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/spmm_kernel.py
// (_spmm_kernel, called by spmm_pallas) in both directions, and its
// HBM-streamed variants (_spmm_hbm_kernel, _spmm_hbm_out_kernel), which
// Hopper needs no separate design for: the forward runs it on the
// receiver-sorted CSR, the backward (dx = A^T g) on the sender-sorted
// transpose with order = t_order, so the permutation of the weights is
// folded into the kernel's loads instead of an [E] gather before it.
//
// Bound: bytes.  An edge moves F values of x and one weight for 2 F flops,
// far below the card's operations-per-byte balance, and a row has few
// edges (about 3 on VOC), so at the VOC batch (1.57 us of bytes at F = 64)
// the time is the launch (about 2.3 us on an H100 at 700 W, under
// chip_smoke.py's timer) and
// the latency of the chain row_ptr -> col -> x (about 1.9 us cold: F = 1
// takes 4.2 us), which no layout removes; at the lattices' sizes it is the
// bytes.  The design moves each byte once and keeps a row's loads in
// flight together:
//   - a lane group of L lanes a row, 32/L rows a warp; each lane takes VP
//     vectors of V values of the row an edge (V * sizeof(x) of 16, 8, 4
//     or 2 bytes, the widest whose values divide F; VP * V at most 8
//     values), lane l of the group vector j = k0 + q * L + l in pass q, so
//     that a pass of the group reads L consecutive vectors; the launch
//     plan (ops/cuda/spmm_kernel.py:csr_spmm_plan) picks V, VP, L and B
//     from (F, dtype), so that at F = 21 no lane idles a whole row;
//   - the warp's 32/L + 1 row pointers (L >= 2) arrive in one coalesced
//     load and are handed round with __shfl_sync; the next rows' are
//     loaded while these run (the grid-stride loop below);
//   - the group loads up to L of the row's col, order and weight entries
//     at once, one a lane, and hands them round with __shfl_sync: the
//     order-indexed weight load runs beside the x loads, not before them;
//     rows longer than L loop over rounds;
//   - the x loads of B edges (all VP vectors each; B * F at most 256
//     values) are issued before the first add; adds run in CSR edge order,
//     so each sum has a fixed order: no atomics, deterministic, the row's
//     sum stays in registers, and a row with no edges writes zeros (no
//     zero-fill launch);
//   - the grid is one wave: every block where the card holds them all at
//     once, else as many as it holds, whose warps stride over the rows.
// Rows wider than a group holds loop over chunks of VP * L vectors.  x is
// float32 or bfloat16; the weights, the sum and the output are float32.
// For bfloat16 x each term is rounded as the Pallas tile body rounds it
// (spmm_kernel.py:223,230): the weight to bfloat16 once, then the product
// bf16(w) * x_j (exact in float32) to bfloat16, summed in float32; pairs
// of values take one __hmul2, which rounds the exact product once.  The
// float32 path is a plain fmaf.  Indices: row_ptr and col int32, order
// int64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gather_common.cuh"

namespace {

using gather::Pack;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// acc[v] += w * x[v] for a vector of V values: a plain fmaf for float32
// x.  For bfloat16 x, w was rounded to bfloat16 (edge_weight) and each
// product is rounded to bfloat16 before the float32 add: __hmul2 on pairs
// rounds the exact product once, as bf16_round(w * x_j) does.
template <int V>
__device__ __forceinline__ void add_terms(float (&acc)[V], float w,
                                          const Pack<float, V>& x) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = fmaf(w, x.v[v], acc[v]);
}
template <int V>
__device__ __forceinline__ void add_terms(float (&acc)[V], float w,
                                          const Pack<__nv_bfloat16, V>& x) {
  if constexpr (V % 2 == 0) {
    const __nv_bfloat162 w2 = __float2bfloat162_rn(w);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x.v);
#pragma unroll
    for (int v = 0; v < V / 2; ++v) {
      const __nv_bfloat162 p = __hmul2(w2, x2[v]);
      acc[2 * v] += __low2float(p);
      acc[2 * v + 1] += __high2float(p);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] += gather::bf16_round(w * __bfloat162float(x.v[v]));
    }
  }
}

template <typename T>
__device__ __forceinline__ float edge_weight(float w) { return w; }
template <>
__device__ __forceinline__ float edge_weight<__nv_bfloat16>(float w) {
  return gather::bf16_round(w);
}

template <typename T, int V, int VP, int B>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const long long* __restrict__ order,
                const float* __restrict__ w, const T* __restrict__ x,
                float* __restrict__ out, int n_rows, int f, int lanes) {
  // L is a power of two: shifts, not divisions.
  const int log_lanes = __ffs(lanes) - 1;
  const int rows_a_warp = 32 >> log_lanes;
  const int lane = threadIdx.x & 31;
  const int gbase = lane & ~(lanes - 1);  // the group's first lane
  const int gl = lane - gbase;
  const int grp = gbase >> log_lanes;     // the group's row in the warp
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << gbase;
  const int nv = f / V;
  const int step = VP * lanes;
  const int warp_rows = gridDim.x * kWarpsPerBlock * rows_a_warp;
  // The warp's 32/L + 1 row pointers in one load (L >= 2): lane r holds
  // row_ptr[row0 + r].  The next iteration's are in flight while this
  // one's rows run.
  int row0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
             rows_a_warp;
  int rp = __ldg(row_ptr + min(row0 + lane, n_rows));
  // row0 is the same across the warp: every lane runs every iteration.
  for (; row0 < n_rows; row0 += warp_rows) {
    const int beg = __shfl_sync(0xffffffffu, rp, grp);
    const int end = __shfl_sync(0xffffffffu, rp, grp + 1);
    rp = __ldg(row_ptr + min(row0 + warp_rows + lane, n_rows));
    const int row = row0 + grp;
    if (row >= n_rows) continue;  // the whole group skips together
    float* out_row = out + static_cast<size_t>(row) * f;
    for (int k0 = 0; k0 < nv; k0 += step) {
      bool act[VP];
      int off[VP];
#pragma unroll
      for (int q = 0; q < VP; ++q) {
        const int j = k0 + q * lanes + gl;
        act[q] = j < nv;
        off[q] = j * V;
      }
      float acc[VP][V];
#pragma unroll
      for (int q = 0; q < VP; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[q][v] = 0.0f;
      for (int base = beg; base < end; base += lanes) {
        const int cnt = min(lanes, end - base);
        int my_col = 0;
        float my_w = 0.0f;
        if (gl < cnt) {
          my_col = __ldg(col + base + gl);
          const int src = order != nullptr
                              ? static_cast<int>(__ldg(order + base + gl))
                              : base + gl;
          my_w = edge_weight<T>(__ldg(w + src));
        }
        for (int i0 = 0; i0 < cnt; i0 += B) {
          Pack<T, V> xv[B][VP];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int cb = __shfl_sync(
                gmask, my_col, gbase + ((i0 + b) & (lanes - 1)));
            if (i0 + b < cnt) {
              const T* x_row = x + static_cast<size_t>(cb) * f;
#pragma unroll
              for (int q = 0; q < VP; ++q) {
                if (act[q]) {
                  xv[b][q] =
                      *reinterpret_cast<const Pack<T, V>*>(x_row + off[q]);
                }
              }
            }
          }
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const float wb = __shfl_sync(
                gmask, my_w, gbase + ((i0 + b) & (lanes - 1)));
            if (i0 + b < cnt) {
#pragma unroll
              for (int q = 0; q < VP; ++q) {
                if (act[q]) add_terms<V>(acc[q], wb, xv[b][q]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < VP; ++q) {
        if (act[q]) {
          Pack<float, V> o;
#pragma unroll
          for (int v = 0; v < V; ++v) o.v[v] = acc[q][v];
          *reinterpret_cast<Pack<float, V>*>(out_row + off[q]) = o;
        }
      }
    }
  }
}

struct Args {
  const int* row_ptr;
  const int* col;
  const long long* order;
  const float* w;
  const void* x;
  float* out;
  int n_rows, f, lanes;
};

// Launches the instance <T, V, VP, B> if it is plan (vec, passes, batch),
// on a grid of one wave.
template <typename T, int V, int VP, int B>
bool launch_if(int vec, int passes, int batch, const Args& a,
               cudaStream_t s) {
  if (vec != V || passes != VP || batch != B) return false;
  static const int per_sm =
      gather::blocks_per_sm(csr_spmm_kernel<T, V, VP, B>, kThreads);
  const int rows_a_block = kWarpsPerBlock * (32 / a.lanes);
  const unsigned grid = gather::one_wave(
      (a.n_rows + rows_a_block - 1) / rows_a_block, per_sm);
  csr_spmm_kernel<T, V, VP, B><<<grid, kThreads, 0, s>>>(
      a.row_ptr, a.col, a.order, a.w, static_cast<const T*>(a.x), a.out,
      a.n_rows, a.f, a.lanes);
  return true;
}

// The only instances built: the (V, VP, B) that csr_spmm_plan
// (ops/cuda/spmm_kernel.py) returns for float32 x and for bfloat16 x
// (tests/test_torch_spmm_plan.py reads this list and holds it equal to the
// rule's).  False for any other plan.
bool dispatch(bool x_bf16, int vec, int passes, int batch, const Args& a,
              cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (!x_bf16) {
    return launch_if<float, 1, 1, 4>(vec, passes, batch, a, s) ||
           launch_if<float, 1, 2, 4>(vec, passes, batch, a, s) ||
           launch_if<float, 1, 4, 1>(vec, passes, batch, a, s) ||
           launch_if<float, 1, 4, 2>(vec, passes, batch, a, s) ||
           launch_if<float, 1, 4, 4>(vec, passes, batch, a, s) ||
           launch_if<float, 2, 1, 4>(vec, passes, batch, a, s) ||
           launch_if<float, 2, 2, 4>(vec, passes, batch, a, s) ||
           launch_if<float, 2, 4, 1>(vec, passes, batch, a, s) ||
           launch_if<float, 2, 4, 2>(vec, passes, batch, a, s) ||
           launch_if<float, 2, 4, 4>(vec, passes, batch, a, s) ||
           launch_if<float, 4, 1, 4>(vec, passes, batch, a, s) ||
           launch_if<float, 4, 2, 1>(vec, passes, batch, a, s) ||
           launch_if<float, 4, 2, 2>(vec, passes, batch, a, s) ||
           launch_if<float, 4, 2, 4>(vec, passes, batch, a, s);
  }
  return launch_if<bf16, 1, 1, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 1, 2, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 1, 4, 1>(vec, passes, batch, a, s) ||
         launch_if<bf16, 1, 4, 2>(vec, passes, batch, a, s) ||
         launch_if<bf16, 1, 4, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 2, 1, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 2, 2, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 2, 4, 1>(vec, passes, batch, a, s) ||
         launch_if<bf16, 2, 4, 2>(vec, passes, batch, a, s) ||
         launch_if<bf16, 2, 4, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 4, 1, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 4, 2, 1>(vec, passes, batch, a, s) ||
         launch_if<bf16, 4, 2, 2>(vec, passes, batch, a, s) ||
         launch_if<bf16, 4, 2, 4>(vec, passes, batch, a, s) ||
         launch_if<bf16, 8, 1, 1>(vec, passes, batch, a, s) ||
         launch_if<bf16, 8, 1, 2>(vec, passes, batch, a, s) ||
         launch_if<bf16, 8, 1, 4>(vec, passes, batch, a, s);
}

bool pow2_upto(int v, int most) {
  return v >= 1 && v <= most && (v & (v - 1)) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without a launch for a plan the kernel does not
// take.  order: null (src(k) = k) or int64 [>= row_ptr[n_rows]].  x_bf16:
// 0 for float32 x, 1 for bfloat16 x.  x and out are [n_rows, f] and 16-byte
// aligned; w is float32, indexed by src(k).  The plan (vec, passes, lanes,
// batch) is csr_spmm_plan's, one of dispatch's instances: vec values a load
// (vec divides f), passes vectors a lane holds at once, lanes a power of two
// from 2 to 32, batch edges in flight.
extern "C" int csr_spmm(const void* row_ptr, const void* col,
                        const void* order, const void* w, const void* x,
                        int x_bf16, void* out, int n_rows, int f, int vec,
                        int passes, int lanes, int batch, void* stream) {
  if (vec < 1 || f % vec != 0 || !pow2_upto(lanes, 32) || lanes < 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0 && f > 0) {
    const Args a{static_cast<const int*>(row_ptr),
                 static_cast<const int*>(col),
                 static_cast<const long long*>(order),
                 static_cast<const float*>(w), x, static_cast<float*>(out),
                 n_rows, f, lanes};
    if (!dispatch(x_bf16 != 0, vec, passes, batch, a,
                  static_cast<cudaStream_t>(stream))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
