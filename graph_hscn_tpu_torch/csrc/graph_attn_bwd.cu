// graph_attn_bwd: the backward of graph_attn (graph_attn.cu, whose note
// says what the kernels compute, what bounds them and how they are laid
// out), two kernels on the stream, in order:
//   - dQ, a query row a lane over the key tiles up to the extent; it also
//     writes D_i = dO_i . O_i;
//   - dK and dV, a key row a lane over the query tiles up to the extent.
// Each recomputes its probabilities from the forward's row log-sum-exp,
// P = exp(s - lse), reads the forward's packed keep words, and sums in one
// lane's registers in a fixed order: no atomics, deterministic.
//   dA = dO . V^T,  dP = keep * dA / (1 - rate),  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = (keep * P / (1 - rate))^T dO.
// Key or query tiles past the graph's last real node write zeros.
#include "graph_attn_common.cuh"

namespace {

// dQ, a query row a lane; also D_i = dO_i . O_i into delta for the dK/dV
// kernel.
template <typename T, int HDP>
__global__ void __launch_bounds__(kTile)
graph_attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ out,
                     const T* __restrict__ grad,
                     const unsigned char* __restrict__ mask,
                     const int* __restrict__ extent,
                     const float* __restrict__ lse,
                     const unsigned* __restrict__ keep,
                     float* __restrict__ delta, T* __restrict__ dq, int S,
                     int nh, int hd, float scale, float keep_scale) {
  constexpr int kRows = unrolled_rows<HDP>(4);
  __shared__ __align__(16) float ks[kTile][HDP];
  __shared__ __align__(16) float vs[kTile][HDP];
  const int lane = threadIdx.x;
  const int g = blockIdx.z;
  const int h = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int i = i0 + lane;
  const int W = (S + kTile - 1) / kTile;
  const size_t gh = size_t(g) * nh + h;
  const Rows at{size_t(g) * S * nh * hd + size_t(h) * hd, nh * hd};
  const int n = extent[g];
  T* dqrow = dq + at.base + size_t(i) * at.rs;
  if (i0 >= n) {
    if (i < S) {
      for (int d = 0; d < hd; ++d) st(dqrow + d, 0.0f);
    }
    return;
  }
  float qr[HDP], gr[HDP], acc[HDP];
  load_row<T, HDP>(qr, q, at, i, S, hd);
  load_row<T, HDP>(gr, grad, at, i, S, hd);
  load_row<T, HDP>(acc, out, at, i, S, hd);
  float D = 0.0f;
#pragma unroll
  for (int d = 0; d < HDP; ++d) D = fmaf(gr[d], acc[d], D);
#pragma unroll
  for (int d = 0; d < HDP; ++d) acc[d] = 0.0f;
  const float lse_i = i < S ? lse[gh * S + i] : 0.0f;
  if (i < S) delta[gh * S + i] = D;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    __syncwarp();
    stage<T, HDP>(ks, vs, k, v, at, j0, S, hd, lane);
    const unsigned valid = real_keys(mask, g, S, n, j0, lane);
    const unsigned word = keep != nullptr && i < S
                              ? keep[(gh * S + i) * W + j0 / kTile]
                              : kFull;
    __syncwarp();
#pragma unroll kRows
    for (int jj = 0; jj < kTile; ++jj) {
      if (!((valid >> jj) & 1u)) continue;  // uniform across the warp
      const float p = expf(dot<HDP>(qr, ks[jj]) * scale - lse_i);
      const float dA = dot<HDP>(gr, vs[jj]);
      const float dP = (word >> jj) & 1u ? dA * keep_scale : 0.0f;
      axpy<HDP>(acc, p * (dP - D), ks[jj]);
    }
  }
  if (i < S) {
    for (int d = 0; d < hd; ++d) st(dqrow + d, acc[d] * scale);
  }
}

// dK and dV, a key row a lane, over the query tiles up to the extent.
template <typename T, int HDP>
__global__ void __launch_bounds__(kTile)
graph_attn_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ grad,
                       const unsigned char* __restrict__ mask,
                       const int* __restrict__ extent,
                       const float* __restrict__ lse,
                       const unsigned* __restrict__ keep,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, int S, int nh, int hd,
                       float scale, float keep_scale) {
  constexpr int kRows = unrolled_rows<HDP>(2);
  __shared__ __align__(16) float qs[kTile][HDP];
  __shared__ __align__(16) float gs[kTile][HDP];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  const int lane = threadIdx.x;
  const int g = blockIdx.z;
  const int h = blockIdx.y;
  const int jt = blockIdx.x;
  const int j = jt * kTile + lane;
  const int W = (S + kTile - 1) / kTile;
  const size_t gh = size_t(g) * nh + h;
  const Rows at{size_t(g) * S * nh * hd + size_t(h) * hd, nh * hd};
  const int n = extent[g];
  T* dkrow = dk + at.base + size_t(j) * at.rs;
  T* dvrow = dv + at.base + size_t(j) * at.rs;
  if (jt * kTile >= n) {  // a key tile past the graph's last real node
    if (j < S) {
      for (int d = 0; d < hd; ++d) {
        st(dkrow + d, 0.0f);
        st(dvrow + d, 0.0f);
      }
    }
    return;
  }
  const bool real = j < n && mask[size_t(g) * S + j];
  float kr[HDP], vr[HDP], dkr[HDP], dvr[HDP];
  load_row<T, HDP>(kr, k, at, j, S, hd);
  load_row<T, HDP>(vr, v, at, j, S, hd);
#pragma unroll
  for (int d = 0; d < HDP; ++d) dkr[d] = dvr[d] = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kTile) {
    __syncwarp();
    stage<T, HDP>(qs, gs, q, grad, at, i0, S, hd, lane);
    const int i = i0 + lane;
    lse_s[lane] = i < S ? lse[gh * S + i] : 0.0f;
    delta_s[lane] = i < S ? delta[gh * S + i] : 0.0f;
    const unsigned words =
        keep != nullptr && i < S ? keep[(gh * S + i) * W + jt] : kFull;
    __syncwarp();
#pragma unroll kRows
    for (int ii = 0; ii < kTile; ++ii) {
      const bool kept = (__shfl_sync(kFull, words, ii) >> lane) & 1u;
      const float p =
          real ? expf(dot<HDP>(kr, qs[ii]) * scale - lse_s[ii]) : 0.0f;
      const float dA = dot<HDP>(vr, gs[ii]);
      axpy<HDP>(dvr, kept ? p * keep_scale : 0.0f, gs[ii]);
      const float dP = kept ? dA * keep_scale : 0.0f;
      axpy<HDP>(dkr, p * (dP - delta_s[ii]), qs[ii]);
    }
  }
  if (j < S) {
    for (int d = 0; d < hd; ++d) {
      st(dkrow + d, dkr[d] * scale);
      st(dvrow + d, dvr[d]);
    }
  }
}

template <typename T, int HDP>
void launch_bwd(const void* q, const void* k, const void* v, const void* out,
                const void* grad, const unsigned char* mask,
                const int* extent, const float* lse, const unsigned* keep,
                float* delta, void* dq, void* dk, void* dv, int G, int S,
                int nh, int hd, float scale, float keep_scale,
                cudaStream_t s) {
  const dim3 grid((S + kTile - 1) / kTile, nh, G);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(grad);
  graph_attn_dq_kernel<T, HDP><<<grid, kTile, 0, s>>>(
      qt, kt, vt, static_cast<const T*>(out), gt, mask, extent, lse, keep,
      delta, static_cast<T*>(dq), S, nh, hd, scale, keep_scale);
  graph_attn_dkdv_kernel<T, HDP><<<grid, kTile, 0, s>>>(
      qt, kt, vt, gt, mask, extent, lse, keep, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), S, nh, hd, scale, keep_scale);
}

}  // namespace

// Returns cudaGetLastError() after its launches (0 on success), or -1 for
// arguments no kernel takes (hd outside 1..64, G over 65535).  The
// arguments as graph_attn's (graph_attn.cu); out: its output, grad: the
// output's gradient, keep: null or its keep words.  delta: float32
// [G, nh, S] scratch (D_i = dO_i . O_i).  dq, dk, dv in the inputs' type,
// [G, S, nh, hd].
extern "C" int graph_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* grad, int bf16,
                              const void* mask, const void* extent,
                              const void* lse, const void* keep, void* delta,
                              void* dq, void* dk, void* dv, int G, int S,
                              int nh, int hd, float scale, float keep_scale,
                              void* stream) {
  if (refused(G, S, nh, hd)) return -1;
  if (G > 0 && S > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* mk = static_cast<const unsigned char*>(mask);
    const auto* ex = static_cast<const int*>(extent);
    const auto* ls = static_cast<const float*>(lse);
    const auto* kp = static_cast<const unsigned*>(keep);
    auto* dl = static_cast<float*>(delta);
    if (bf16) {
      GRAPH_ATTN_DISPATCH(__nv_bfloat16, launch_bwd, q, k, v, out, grad, mk,
                          ex, ls, kp, dl, dq, dk, dv, G, S, nh, hd, scale,
                          keep_scale, s)
    } else {
      GRAPH_ATTN_DISPATCH(float, launch_bwd, q, k, v, out, grad, mk, ex, ls,
                          kp, dl, dq, dk, dv, G, S, nh, hd, scale, keep_scale,
                          s)
    }
  }
  return static_cast<int>(cudaGetLastError());
}
