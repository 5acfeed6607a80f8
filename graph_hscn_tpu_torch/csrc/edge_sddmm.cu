// edge_sddmm: out[e] = <h_src[col[e], :], h_dst[row[e], :]> for e < n_real,
//             out[e] = 0 for the padding edges n_real <= e < n_edges.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/sddmm_kernel.py
// (_sddmm_kernel, called by sddmm_pallas) and its HBM-streamed variant
// (_sddmm_hbm_kernel), which Hopper needs no separate design for.  In the
// SpMM backward it gives the edge-weight gradient dw[e] = <x[send e],
// g[recv e]>.  The output is in the receiver-sorted edge order of the
// batch, length n_edges.
//
// Bound: bytes.  Each edge reads two gathered rows (2 F values) for 2 F
// flops and writes one float.  At the VOC batch the time is the launch
// (about 2.6 us on an H100 at 700 W, under chip_smoke.py's timer) and the
// chain col/row -> the rows (F = 1 takes 3.3 us cold); at the lattices' sizes it is the bytes.
// The design reads each of the two rows once and keeps all of an edge's
// loads in flight together:
//   - a lane group of L lanes an edge (L of 1, 2, 4 or 8; 32/L edges a
//     warp, so a warp's col and row entries arrive in one coalesced load
//     each, and the next edges' while these run); each lane takes VP
//     vectors of V values of each row (V * sizeof of the narrower operand
//     of 16, 8, 4 or 2 bytes, the widest whose values divide F; VP * V at
//     most 16 values), lane l of the group vector j = k0 + q * L + l in
//     pass q, and issues all of its loads of both rows before its first
//     FMA; the launch plan (ops/cuda/sddmm_kernel.py:edge_sddmm_plan) picks
//     V, VP and L from (F, the narrower dtype); at F = 21 (84-byte rows,
//     4-byte aligned) the group's lanes share the row's scalars;
//   - the lanes' partial sums meet in log2(L) __shfl_xor_sync steps, and
//     the group's first lane writes the edge's float32: no atomics, a fixed
//     order, deterministic;
//   - padding edges write 0 without reading a row, so the output needs no
//     zero-fill launch;
//   - the grid is one wave: every block where the card holds them all at
//     once, else as many as it holds, whose warps stride over the edges.
// Rows wider than a group holds loop over chunks of VP * L vectors.  Each
// operand is float32 or bfloat16 on its own (the backward pairs a bfloat16
// x with a float32 gradient); products and sums are float32.  Indices
// int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gather_common.cuh"

namespace {

using gather::Pack;
using gather::to_f32;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <typename TS, typename TD, int V, int VP>
__global__ void __launch_bounds__(kThreads)
edge_sddmm_kernel(const int* __restrict__ row, const int* __restrict__ col,
                  const TS* __restrict__ h_src, const TD* __restrict__ h_dst,
                  float* __restrict__ out, int n_edges, int n_real, int f,
                  int lanes) {
  // L is a power of two: shifts, not divisions.
  const int log_lanes = __ffs(lanes) - 1;
  const int edges_a_warp = 32 >> log_lanes;
  const int lane = threadIdx.x & 31;
  const int gbase = lane & ~(lanes - 1);  // the group's first lane
  const int gl = lane - gbase;
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << gbase;
  const int nv = f / V;
  const int step = VP * lanes;
  const int warp_edges = gridDim.x * kWarpsPerBlock * edges_a_warp;
  int e = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * edges_a_warp +
          (gbase >> log_lanes);
  int src = 0, dst = 0;  // the edge's rows
  if (e < n_real) {
    src = __ldg(col + e);
    dst = __ldg(row + e);
  }
  for (; e < n_edges; e += warp_edges) {
    // The next edge's indices are in flight while this edge's rows run.
    int src_next = 0, dst_next = 0;
    if (e + warp_edges < n_real) {
      src_next = __ldg(col + e + warp_edges);
      dst_next = __ldg(row + e + warp_edges);
    }
    float acc = 0.0f;
    if (e < n_real) {
      const TS* s = h_src + static_cast<size_t>(src) * f;
      const TD* d = h_dst + static_cast<size_t>(dst) * f;
      for (int k0 = 0; k0 < nv; k0 += step) {
        Pack<TS, V> sv[VP];
        Pack<TD, V> dv[VP];
#pragma unroll
        for (int q = 0; q < VP; ++q) {
          const int j = k0 + q * lanes + gl;
          if (j < nv) {
            sv[q] = *reinterpret_cast<const Pack<TS, V>*>(s + j * V);
            dv[q] = *reinterpret_cast<const Pack<TD, V>*>(d + j * V);
          }
        }
#pragma unroll
        for (int q = 0; q < VP; ++q) {
          if (k0 + q * lanes + gl < nv) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc = fmaf(to_f32(sv[q].v[v]), to_f32(dv[q].v[v]), acc);
          }
        }
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(gmask, acc, o);
    }
    if (gl == 0) out[e] = acc;
    src = src_next;
    dst = dst_next;
  }
}

struct Args {
  const int* row;
  const int* col;
  const void* h_src;
  const void* h_dst;
  float* out;
  int n_edges, n_real, f, lanes;
};

// Launches the instance <TS, TD, V, VP> if it is plan (vec, passes), on a
// grid of one wave.
template <typename TS, typename TD, int V, int VP>
bool launch_if(int vec, int passes, const Args& a, cudaStream_t s) {
  if (vec != V || passes != VP) return false;
  static const int per_sm =
      gather::blocks_per_sm(edge_sddmm_kernel<TS, TD, V, VP>, kThreads);
  const int edges_a_block = kWarpsPerBlock * (32 / a.lanes);
  const unsigned grid = gather::one_wave(
      (a.n_edges + edges_a_block - 1) / edges_a_block, per_sm);
  edge_sddmm_kernel<TS, TD, V, VP><<<grid, kThreads, 0, s>>>(
      a.row, a.col, static_cast<const TS*>(a.h_src),
      static_cast<const TD*>(a.h_dst), a.out, a.n_edges, a.n_real, a.f,
      a.lanes);
  return true;
}

// With a bfloat16 operand: the (V, VP) of edge_sddmm_plan for bfloat16.
template <typename TS, typename TD>
bool dispatch_bf16(int vec, int passes, const Args& a, cudaStream_t s) {
  return launch_if<TS, TD, 1, 1>(vec, passes, a, s) ||
         launch_if<TS, TD, 1, 4>(vec, passes, a, s) ||
         launch_if<TS, TD, 1, 8>(vec, passes, a, s) ||
         launch_if<TS, TD, 2, 1>(vec, passes, a, s) ||
         launch_if<TS, TD, 2, 4>(vec, passes, a, s) ||
         launch_if<TS, TD, 2, 8>(vec, passes, a, s) ||
         launch_if<TS, TD, 4, 1>(vec, passes, a, s) ||
         launch_if<TS, TD, 4, 4>(vec, passes, a, s) ||
         launch_if<TS, TD, 8, 1>(vec, passes, a, s) ||
         launch_if<TS, TD, 8, 2>(vec, passes, a, s);
}

// The only instances built: the (V, VP) that edge_sddmm_plan
// (ops/cuda/sddmm_kernel.py) returns for float32 operands and, in
// dispatch_bf16, for a bfloat16 one (tests/test_torch_spmm_plan.py reads these lists and holds
// them equal to the rule's).  False for any other plan.
bool dispatch(bool src_bf16, bool dst_bf16, int vec, int passes,
              const Args& a, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (src_bf16 && dst_bf16) return dispatch_bf16<bf16, bf16>(vec, passes, a, s);
  if (src_bf16) return dispatch_bf16<bf16, float>(vec, passes, a, s);
  if (dst_bf16) return dispatch_bf16<float, bf16>(vec, passes, a, s);
  return launch_if<float, float, 1, 1>(vec, passes, a, s) ||
         launch_if<float, float, 1, 4>(vec, passes, a, s) ||
         launch_if<float, float, 1, 8>(vec, passes, a, s) ||
         launch_if<float, float, 2, 1>(vec, passes, a, s) ||
         launch_if<float, float, 2, 4>(vec, passes, a, s) ||
         launch_if<float, float, 2, 8>(vec, passes, a, s) ||
         launch_if<float, float, 4, 1>(vec, passes, a, s) ||
         launch_if<float, float, 4, 2>(vec, passes, a, s) ||
         launch_if<float, float, 4, 4>(vec, passes, a, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without a launch for a plan the kernel does not
// take.  src_bf16 / dst_bf16: 0 for a float32 operand, 1 for a bfloat16
// one.  h_src and h_dst are [N, f], 16-byte aligned; out is [n_edges]; row
// and col [n_edges].  The plan (vec, passes, lanes) is edge_sddmm_plan's
// for the narrower operand, one of dispatch's instances: vec divides f;
// passes vectors of each row a lane holds at once; lanes 1, 2, 4 or 8.
extern "C" int edge_sddmm(const void* row, const void* col, const void* h_src,
                          int src_bf16, const void* h_dst, int dst_bf16,
                          void* out, int n_edges, int n_real, int f, int vec,
                          int passes, int lanes, void* stream) {
  if (vec < 1 || f % vec != 0 || n_real < 0 || n_real > n_edges ||
      lanes < 1 || lanes > 8 || (lanes & (lanes - 1)) != 0 ||
      reinterpret_cast<uintptr_t>(h_src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(h_dst) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_edges > 0) {
    const Args a{static_cast<const int*>(row), static_cast<const int*>(col),
                 h_src, h_dst, static_cast<float*>(out), n_edges, n_real, f,
                 lanes};
    if (!dispatch(src_bf16 != 0, dst_bf16 != 0, vec, passes, a,
                  static_cast<cudaStream_t>(stream))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
