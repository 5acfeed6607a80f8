// What the graph_attn kernels share (graph_attn.cu, the forward;
// graph_attn_bwd.cu, the backward): the tile of 32 rows, loads of a head's
// rows into registers and shared memory, the dot and axpy over a padded
// head, the real keys of a tile, and the head widths the kernels are built
// for.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <initializer_list>

namespace {

constexpr int kTile = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The layout of one (graph, head): row r's element d of x [G, S, nh, hd] at
// base + r * rs + d.
struct Rows {
  size_t base;
  int rs;
};

// x's row (r < S) into registers, zeros past hd and for r >= S.
template <typename T, int HDP>
__device__ __forceinline__ void load_row(float (&dst)[HDP], const T* x,
                                         Rows at, int r, int S, int hd) {
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    dst[d] = (d < hd && r < S) ? ld(x + at.base + size_t(r) * at.rs + d)
                               : 0.0f;
  }
}

// Rows r0 .. r0+31 of x and y into shared memory tiles [32][HDP], zeros past
// hd and S; consecutive lanes read consecutive elements of a row.
template <typename T, int HDP>
__device__ __forceinline__ void stage(float (*xs)[HDP], float (*ys)[HDP],
                                      const T* x, const T* y, Rows at, int r0,
                                      int S, int hd, int lane) {
#pragma unroll 4
  for (int t = 0; t < HDP; ++t) {
    const int e = t * kTile + lane;
    const int r = e / HDP;
    const int d = e - r * HDP;
    float a = 0.0f, b = 0.0f;
    if (d < hd && r0 + r < S) {
      const size_t off = at.base + size_t(r0 + r) * at.rs + d;
      a = ld(x + off);
      b = ld(y + off);
    }
    xs[r][d] = a;
    ys[r][d] = b;
  }
}

template <int HDP>
__device__ __forceinline__ float dot(const float (&x)[HDP],
                                     const float* row) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < HDP; d += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + d);
    acc = fmaf(x[d], r.x, acc);
    acc = fmaf(x[d + 1], r.y, acc);
    acc = fmaf(x[d + 2], r.z, acc);
    acc = fmaf(x[d + 3], r.w, acc);
  }
  return acc;
}

// acc += a * row
template <int HDP>
__device__ __forceinline__ void axpy(float (&acc)[HDP], float a,
                                     const float* row) {
#pragma unroll
  for (int d = 0; d < HDP; d += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + d);
    acc[d] = fmaf(a, r.x, acc[d]);
    acc[d + 1] = fmaf(a, r.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, r.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, r.w, acc[d + 3]);
  }
}

// Lane j's key of the tile at j0 is real: before the extent and unmasked.
__device__ __forceinline__ unsigned real_keys(const unsigned char* mask,
                                              int g, int S, int n, int j0,
                                              int lane) {
  const int j = j0 + lane;
  return __ballot_sync(kFull, j < n && mask[size_t(g) * S + j]);
}

// The padded head width a kernel holds in registers, or 0 where hd is out of
// range.
int padded(int hd) {
  if (hd < 1) return 0;
  for (int w : {8, 16, 24, 32, 48, 64}) {
    if (hd <= w) return w;
  }
  return 0;
}

// Loops over the other operand's 32 rows in the backward kernels are
// unrolled `rows` rows at a time up to a head of 32, one at a time past it
// (the registers then hold each row's 48 or 64 values).
template <int HDP>
__host__ __device__ constexpr int unrolled_rows(int rows) {
  return HDP <= 32 ? rows : 1;
}

#define GRAPH_ATTN_DISPATCH(T, FN, ...)                  \
  switch (padded(hd)) {                                  \
    case 8: FN<T, 8>(__VA_ARGS__); break;                \
    case 16: FN<T, 16>(__VA_ARGS__); break;              \
    case 24: FN<T, 24>(__VA_ARGS__); break;              \
    case 32: FN<T, 32>(__VA_ARGS__); break;              \
    case 48: FN<T, 48>(__VA_ARGS__); break;              \
    default: FN<T, 64>(__VA_ARGS__); break;              \
  }

bool refused(int G, int S, int nh, int hd) {
  return padded(hd) == 0 || G < 0 || G > 65535 || S < 0 || nh < 1 ||
         nh > 65535;
}

}  // namespace
