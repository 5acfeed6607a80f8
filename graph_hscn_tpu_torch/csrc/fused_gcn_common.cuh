// Shared pieces of the fused dense GCN stack kernels (fused_gcn_fwd.cu,
// fused_gcn_bwd.cu): the compute-type helpers, the asynchronous copies, the
// launch plan and its shared-memory layout, the split reduction of the
// register-tiled products, and the staging of the exchanged operand from
// the cluster's blocks.
//
// The compute type T is float or __nv_bfloat16.  T is only what the
// operands are stored in: every product accumulates in float32, and a value
// "rounded to T" is float32 -> T -> float32 (round to nearest even), the
// point where the JAX kernel casts to its compute dtype.
//
// The launch plan (computed from the shapes by ops/fused_gcn.py:fused_plan,
// re-checked here): each graph block runs on a thread-block cluster of
// `cluster` blocks; block r owns `rows` consecutive rows (forward) or
// columns (backward) of its graph's A_hat, fewer in the last blocks.  Its
// slice of A_hat is copied into shared memory once (`resident`), or, where
// it does not fit, streamed in tiles of `jt` rows/columns of the reduction
// index.  The exchanged operand (y forward, dz backward) is staged from the
// cluster's blocks `jt` rows by `fc` feature columns at a time.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_gcn {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kMaxLayers = 8;
constexpr int kSmemLimit = 232448;  // bytes a block may use on Hopper

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive values starting at p (16-byte aligned for float, 8-byte
// for bfloat16), widened to float32.  A bfloat16 is the top half of the
// float32 with the same bits.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ float4 round4_to(const float4& v) {
  return make_float4(round_to<T>(v.x), round_to<T>(v.y), round_to<T>(v.z),
                     round_to<T>(v.w));
}

__host__ __device__ __forceinline__ int round4(int f) { return (f + 3) & ~3; }
__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// ---- asynchronous global -> shared copies (cp.async) ----------------------

// Four elements: 16 bytes of float (cache-global), 8 of bfloat16.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copy of an [nrows, ncols] tile (ncols % 4 == 0) with row
// strides src_stride / dst_stride elements; one commit group.
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, int dst_stride,
                                                const T* src,
                                                size_t src_stride, int nrows,
                                                int ncols) {
  const int per_row = ncols >> 2;
  for (int t = threadIdx.x; t < nrows * per_row; t += blockDim.x) {
    const int r = t / per_row, q = t - r * per_row;
    cp_async4(dst + static_cast<size_t>(r) * dst_stride + 4 * q,
              src + static_cast<size_t>(r) * src_stride + 4 * q);
  }
  cp_async_commit();
}

// ---- the launch plan --------------------------------------------------------

struct Plan {
  int cluster;   // blocks a graph block: 4 or 8
  int rows;      // A_hat rows (forward) / columns (backward) a block owns
  int jt;        // reduction-index rows a staged tile
  int fc;        // feature columns a pass
  int resident;  // 1: the block's A_hat slice lives in shared memory
};

// Byte offsets of a block's shared-memory regions.  `a` holds the A_hat
// slice (or tile) with row stride a_stride elements; `own` holds the
// block's rows of the exchanged operand (y forward, dz backward), row
// stride own_stride (a multiple of 4: peers read it as float4); `aux` is
// the block's second operand (h forward, dy backward) with an odd row
// stride aux_stride (column reads by consecutive rows hit distinct banks);
// `stage` (stage_floats floats) takes the staged tiles of the exchanged
// operand, W, and the partial sums of the split reduction (16 floats a
// thread).
struct Layout {
  size_t a, own, aux, stage, total;
  int a_stride, own_stride, aux_stride, stage_floats;
};

// The forward's A_hat row stride for rows of n elements: n / 4 odd, so
// that the float4 (bf16: 8-byte) loads of 8 consecutive rows at one column
// fall in 8 distinct bank groups.
__host__ __device__ __forceinline__ int padded_stride(int n) {
  return ((n >> 2) & 1) ? n : n + 4;
}

// a_rows x a_stride elements of A_hat: forward [rows][padded_stride(slot
// or jt)], backward [slot or jt][rows].  False for a plan the kernels do
// not take or whose regions exceed kSmemLimit; ops/fused_gcn.py:plan_smem
// is the same sum, which the plan is chosen by.
inline bool make_layout(const Plan& p, int slot, size_t esize, int a_rows,
                        int a_stride, int own_stride, int aux_stride,
                        Layout* out) {
  if ((p.cluster != 4 && p.cluster != 8) || p.rows < 4 || p.rows % 4 ||
      static_cast<long long>(p.rows) * p.cluster < slot || p.jt < 4 ||
      p.jt % 4 || p.jt > slot || p.fc < 4 || p.fc % 4 ||
      (p.rows / 4) * (p.fc / 4) > kThreads ||
      (p.resident != 0 && p.resident != 1))
    return false;
  Layout l{};
  l.a_stride = a_stride;
  l.own_stride = own_stride;
  l.aux_stride = aux_stride;
  const size_t a_bytes =
      align16(static_cast<size_t>(a_rows) * a_stride * esize);
  const size_t own_bytes = static_cast<size_t>(p.rows) * own_stride * 4;
  const size_t aux_bytes = align16(static_cast<size_t>(p.rows) * aux_stride * 4);
  size_t stage_bytes = static_cast<size_t>(p.jt) * p.fc * 4;
  if (stage_bytes < static_cast<size_t>(kThreads) * 16 * 4)
    stage_bytes = static_cast<size_t>(kThreads) * 16 * 4;
  l.stage_floats = static_cast<int>(stage_bytes / 4);
  l.a = 0;
  l.own = a_bytes;
  l.aux = l.own + own_bytes;
  l.stage = l.aux + aux_bytes;
  l.total = l.stage + stage_bytes;
  if (l.total > static_cast<size_t>(kSmemLimit)) return false;
  *out = l;
  return true;
}

// ---- the split reduction of a register-tiled product -----------------------
//
// A tile is 4 output rows x 4 feature columns, accumulated in 16 registers.
// With `tiles` tiles and kThreads threads, `ks` = min(kThreads / tiles,
// max_ks) threads share a tile, each taking every ks-th group of 4
// reduction rows; their partial sums are added through shared memory in the
// order 0, 1, .., ks-1.  The A_hat products take max_ks = 1: one thread sums
// a tile's whole range in order, and shared memory only hands the tiles to
// the threads that finish them.
struct Split {
  int tiles, ks, tile, part;
  bool active;
};

__device__ __forceinline__ Split split_for(int tiles, int max_ks) {
  Split s;
  s.tiles = tiles;
  s.ks = tiles > 0 ? min(kThreads / tiles, max_ks) : 1;
  if (s.ks < 1) s.ks = 1;
  s.tile = tiles > 0 ? threadIdx.x % tiles : 0;
  s.part = tiles > 0 ? threadIdx.x / tiles : 0;
  s.active = tiles > 0 && s.part < s.ks;
  return s;
}

// Write every part's partial tile to red[(part * 16 + e) * tiles + tile]
// (red: >= 16 floats a thread of shared memory); the caller synchronises
// before (red may alias the staged tiles just read) and after.
__device__ __forceinline__ void write_partials(const Split& s,
                                               const float4 acc[4],
                                               float* red) {
  if (!s.active) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      red[(s.part * 16 + 4 * r + k) * s.tiles + s.tile] = get(acc[r], k);
  }
}

// Element e (= 4 r + k) of tile `tile`, summed over the ks parts in order.
__device__ __forceinline__ float sum_parts(const float* red, int tiles,
                                           int ks, int tile, int e) {
  float z = red[e * tiles + tile];
  for (int q = 1; q < ks; ++q) z += red[(q * 16 + e) * tiles + tile];
  return z;
}

// Stage rows j0 .. j0+jn-1, columns f0 .. f0+4fq-1 of the exchanged
// operand (row j held by cluster block j / R, as its local row j % R of
// `own`, row stride own_stride) into stage[jj * fc + c], rounded to T when
// kRound.  Each thread issues four remote loads before it stores any.
template <bool kRound, typename T>
__device__ __forceinline__ void stage_from_cluster(float* stage, int fc,
                                                   float* own, int own_stride,
                                                   int R, int j0, int jn,
                                                   int f0, int fq) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = jn * fq;
  for (int t0 = threadIdx.x; t0 < n; t0 += 4 * blockDim.x) {
    float4 v[4];
    int dst[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * blockDim.x;
      dst[u] = -1;
      if (t < n) {
        const int jj = t / fq, qq = t - jj * fq;
        const int j = j0 + jj, owner = j / R;
        const float* src = cluster.map_shared_rank(own, owner) +
                           (j - owner * R) * own_stride + f0 + 4 * qq;
        v[u] = *reinterpret_cast<const float4*>(src);
        dst[u] = jj * fc + 4 * qq;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (dst[u] >= 0)
        *reinterpret_cast<float4*>(&stage[dst[u]]) =
            kRound ? round4_to<T>(v[u]) : v[u];
    }
  }
}

}  // namespace fused_gcn
