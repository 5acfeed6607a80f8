// spmm_mh: out[i, h*C + c] = sum_{k in row_ptr[i]..row_ptr[i+1]}
//                              alpha[src(k), h] * x[col[k], h*C + c]
// with src(k) = k, or order[k] when an order array is given.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/multihead_kernel.py
// (_spmm_mh_kernel, called by spmm_mh): the per-head weighted SpMM of GAT's
// attention aggregation, all H heads in one launch.  The forward runs it on
// the receiver-sorted CSR; the backwards run it on the sender-sorted
// transpose with order = t_order, so the permutation of alpha (or of
// sddmm_mh's cotangent) is folded into the kernel's loads instead of an
// [E, H] gather before it.
//
// Bound: bytes.  An edge moves H*C values of x and H weights for 2*H*C
// flops, far below the card's operations-per-byte balance, and a row has
// few edges (about 3 on VOC), so the time is the latency of the chain
// row_ptr -> col -> x and the loads in flight.  The design moves each byte
// once and keeps a row's loads in flight together:
//   - a lane group of L lanes a row, 32/L rows a warp, each lane VP
//     vectors of V values (V * sizeof(x) of 16, 8, 4 or 2 bytes; VP * V
//     values at most 32 bytes) of the row an edge, laid out by the launch
//     plan (ops/cuda/multihead_kernel.py:multihead_plan) in one of two
//     layouts (see spmm_mh_kernel): by head, S lanes a head, every value of
//     a lane in one head (one alpha a lane and edge; V divides C); or along
//     the row, L consecutive vectors a pass, where a head has no aligned
//     vector as wide as the row's (C = 21: 21 float4s a row), a vector
//     spanning at most two heads whose weights come from one 16-byte load
//     of the edge's four;
//   - the group loads up to L of the row's col (and order) entries at
//     once, one a lane, and hands them round with __shfl_sync; it issues
//     the x-row and alpha loads of B edges (all VP vectors each) before the
//     first add: B = 4 where a lane's share of a row is small (C = 2), else
//     1, which keeps the registers (and so the rows on the card) higher;
//   - adds run in CSR edge order, so each sum has a fixed order: no
//     atomics, deterministic, and the row's sum stays in registers; an
//     empty row writes zeros, so the output needs no zero-fill launch.
// Rows wider than a group holds loop over head passes (L/S heads a pass)
// and chunks of VP * S (row layout: VP * L) vectors.  x is float32 or
// bfloat16; alpha, the sum and the output are float32.  For bfloat16 x each
// term is rounded as the Pallas body rounds it (multihead_kernel.py:86,
// :107-108): the product f32(x_j) * alpha, alpha unrounded, to bfloat16,
// summed in float32.  Indices: row_ptr and col int32, order int64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

// V values, aligned as one load of at most 16 bytes (8 floats of the
// output beside 8 bfloat16 of x are two).
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

__device__ __forceinline__ float add_term(float acc, float a, float x) {
  return fmaf(a, x, acc);
}
__device__ __forceinline__ float add_term(float acc, float a,
                                          __nv_bfloat16 x) {
  return acc + __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) * a));
}

__device__ __forceinline__ float pick(const float4& a, int h) {
  return h == 0 ? a.x : h == 1 ? a.y : h == 2 ? a.z : a.w;
}

// ROW false (the head layout): lane gl of a group reads, in vector pass q,
// vector k = k0 + q * S + gl % S of head h0 + gl / S (V divides C); one
// alpha a lane and edge.  ROW true (the row layout, H = 4 only): lane gl
// reads, in pass q, vector j = k0 + q * L + gl of the row, so that a pass
// of the group reads L consecutive vectors; a vector spans at most two
// heads (V <= C), the edge's four weights come in one 16-byte load and
// each value picks its head's.  B edges' loads are issued before the first
// add.
template <typename T, int V, int VP, bool ROW, int B>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_mh_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
               const long long* __restrict__ order,
               const float* __restrict__ alpha, const T* __restrict__ x,
               float* __restrict__ out, int n_rows, int heads, int c,
               int lanes_per_head, int lanes) {
  // L and S are powers of two: shifts, not divisions.
  const int log_lanes = __ffs(lanes) - 1;
  const int log_s = __ffs(lanes_per_head) - 1;
  const int lane = threadIdx.x & 31;
  const int gbase = lane & ~(lanes - 1);  // the group's first lane
  const int gl = lane - gbase;
  const int row = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
                      (32 >> log_lanes) + (gbase >> log_lanes);
  if (row >= n_rows) return;  // the whole group leaves together
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << gbase;
  const int f = heads * c;
  const int S = lanes_per_head;
  const int sl = gl & (S - 1);  // the lane's place in its head
  // Head layout: head passes of L/S heads, chunks of VP*S vectors of a
  // head.  Row layout: one head pass, chunks of VP*L vectors of the row.
  const int heads_a_pass = ROW ? heads : lanes >> log_s;
  const int nv = ROW ? f / V : c / V;
  const int step = ROW ? VP * lanes : VP * S;
  const int beg = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  float* out_row = out + static_cast<size_t>(row) * f;
  for (int h0 = 0; h0 < heads; h0 += heads_a_pass) {
    const int h = ROW ? 0 : h0 + (gl >> log_s);
    for (int k0 = 0; k0 < nv; k0 += step) {
      bool act[VP];
      int off[VP];
      int head[VP];   // the head of a vector's first value
      int split[VP];  // its values from split on are of head + 1
#pragma unroll
      for (int q = 0; q < VP; ++q) {
        if constexpr (ROW) {
          const int j = k0 + q * lanes + gl;
          act[q] = j < nv;
          off[q] = j * V;
          head[q] = j * V / c;
          split[q] = (head[q] + 1) * c - j * V;
        } else {
          const int k = k0 + q * S + sl;
          act[q] = h < heads && k < nv;
          off[q] = h * c + k * V;
          head[q] = h;
          split[q] = V;
        }
      }
      float acc[VP][V];
#pragma unroll
      for (int q = 0; q < VP; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[q][v] = 0.0f;
      for (int base = beg; base < end; base += lanes) {
        const int cnt = min(lanes, end - base);
        int my_col = 0, my_src = 0;  // edge slots fit an int
        if (gl < cnt) {
          my_col = __ldg(col + base + gl);
          my_src = order != nullptr
                       ? static_cast<int>(__ldg(order + base + gl))
                       : base + gl;
        }
        for (int i0 = 0; i0 < cnt; i0 += B) {
          Pack<T, V> xv[B][VP];
          float4 a4[ROW ? B : 1];
          float a[ROW ? 1 : B];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int src_lane = gbase + ((i0 + b) & (lanes - 1));
            const int cb = __shfl_sync(gmask, my_col, src_lane);
            const int sb = __shfl_sync(gmask, my_src, src_lane);
            if (i0 + b < cnt) {
              const T* x_row = x + static_cast<size_t>(cb) * f;
#pragma unroll
              for (int q = 0; q < VP; ++q) {
                if (act[q]) {
                  xv[b][q] =
                      *reinterpret_cast<const Pack<T, V>*>(x_row + off[q]);
                }
              }
              if constexpr (ROW) {
                a4[b] = __ldg(reinterpret_cast<const float4*>(alpha) + sb);
              } else if (h < heads) {
                a[b] = __ldg(alpha + static_cast<size_t>(sb) * heads + h);
              }
            }
          }
#pragma unroll
          for (int b = 0; b < B; ++b) {
            if (i0 + b < cnt) {
#pragma unroll
              for (int q = 0; q < VP; ++q) {
                if (act[q]) {
                  float w = 0.0f, w_next = 0.0f;
                  if constexpr (ROW) {
                    w = pick(a4[ROW ? b : 0], head[q]);
                    w_next = pick(a4[ROW ? b : 0], min(head[q] + 1, 3));
                  } else {
                    w = a[ROW ? 0 : b];
                  }
#pragma unroll
                  for (int v = 0; v < V; ++v) {
                    acc[q][v] = add_term(acc[q][v], v < split[q] ? w : w_next,
                                         xv[b][q].v[v]);
                  }
                }
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
  const float* alpha;
  const void* x;
  float* out;
  int n_rows, heads, c, lanes_per_head, lanes;
};

struct Plan {
  int vec, passes;
  bool row_layout;
  int batch;
};

// Launches the instance <T, V, VP, ROW, B> if it is plan p's.
template <typename T, int V, int VP, bool ROW, int B>
bool launch_if(const Plan& p, const Args& a, cudaStream_t s) {
  if (p.vec != V || p.passes != VP || p.row_layout != ROW || p.batch != B) {
    return false;
  }
  const int rows_a_block = kWarpsPerBlock * (32 / a.lanes);
  const dim3 grid((a.n_rows + rows_a_block - 1) / rows_a_block);
  spmm_mh_kernel<T, V, VP, ROW, B><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      a.row_ptr, a.col, a.order, a.alpha, static_cast<const T*>(a.x), a.out,
      a.n_rows, a.heads, a.c, a.lanes_per_head, a.lanes);
  return true;
}

// The only instances built: the (V, VP, row layout, B) that multihead_plan
// (ops/cuda/multihead_kernel.py) returns for float32 x and for bfloat16 x
// (tests/test_torch_multihead_plan.py holds the two lists equal).  False
// for any other plan.
bool dispatch(bool x_bf16, const Plan& p, const Args& a, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (!x_bf16) {
    return launch_if<float, 1, 1, false, 4>(p, a, s) ||
           launch_if<float, 1, 4, false, 4>(p, a, s) ||
           launch_if<float, 2, 1, false, 4>(p, a, s) ||
           launch_if<float, 2, 4, false, 1>(p, a, s) ||
           launch_if<float, 2, 4, true, 1>(p, a, s) ||
           launch_if<float, 4, 1, false, 4>(p, a, s) ||
           launch_if<float, 4, 2, false, 1>(p, a, s) ||
           launch_if<float, 4, 2, true, 1>(p, a, s);
  }
  return launch_if<bf16, 1, 1, false, 4>(p, a, s) ||
         launch_if<bf16, 1, 4, false, 4>(p, a, s) ||
         launch_if<bf16, 2, 1, false, 4>(p, a, s) ||
         launch_if<bf16, 2, 4, false, 4>(p, a, s) ||
         launch_if<bf16, 2, 4, true, 4>(p, a, s) ||
         launch_if<bf16, 4, 1, false, 4>(p, a, s) ||
         launch_if<bf16, 4, 4, false, 1>(p, a, s) ||
         launch_if<bf16, 4, 4, true, 1>(p, a, s) ||
         launch_if<bf16, 8, 1, false, 4>(p, a, s) ||
         launch_if<bf16, 8, 2, false, 1>(p, a, s) ||
         launch_if<bf16, 8, 2, true, 1>(p, a, s);
}

bool pow2_upto(int v, int most) {
  return v >= 1 && v <= most && (v & (v - 1)) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without a launch for a plan the kernel does not
// take.  order: null (src(k) = k) or int64 [>= row_ptr[n_rows]].
// x_bf16: 0 for float32 x, 1 for bfloat16 x.  x and out are [n_rows,
// heads * c] and 16-byte aligned, alpha [>= row_ptr[n_rows], heads] (16-byte
// aligned in the row layout).  The plan (vec, passes, lanes_per_head, lanes,
// row_layout, batch) is multihead_plan's, one of dispatch's instances: vec
// values a lane load (vec divides c in the head layout, heads * c and at
// most c in the row layout, which takes 4 heads only), passes vectors a
// lane holds at once, lanes_per_head and lanes powers of two,
// lanes_per_head <= lanes <= 32, batch edges in flight.
extern "C" int spmm_mh(const void* row_ptr, const void* col,
                       const void* order, const void* alpha, const void* x,
                       int x_bf16, void* out, int n_rows, int heads, int c,
                       int vec, int passes, int lanes_per_head, int lanes,
                       int row_layout, int batch, void* stream) {
  const bool vec_fits =
      vec >= 1 &&
      (row_layout ? (heads == 4 && (heads * c) % vec == 0 && vec <= c &&
                     reinterpret_cast<uintptr_t>(alpha) % 16 == 0)
                  : c % vec == 0);
  if (!vec_fits || !pow2_upto(lanes_per_head, 32) || !pow2_upto(lanes, 32) ||
      lanes_per_head > lanes || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0 && heads > 0 && c > 0) {
    const Args a{static_cast<const int*>(row_ptr),
                 static_cast<const int*>(col),
                 static_cast<const long long*>(order),
                 static_cast<const float*>(alpha), x,
                 static_cast<float*>(out), n_rows, heads, c, lanes_per_head,
                 lanes};
    const Plan p{vec, passes, row_layout != 0, batch};
    if (!dispatch(x_bf16 != 0, p, a, static_cast<cudaStream_t>(stream))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
