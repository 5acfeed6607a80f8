// fused_gcn_bwd: the reverse sweep of the fused dense GCN stack
// (fused_gcn_fwd.cu) over its stored post-dropout activations.  For each
// graph block g, with dz = dL/dh_L [S, F_L] (float32), for l = L-1 .. 0:
//   db_l += colsum(dz)
//   dy    = round_T(A_hat^T round_T(dz))          float32 accumulation
//   dW_l += h_{l-1}^T dy                          (h_{-1} = x)
//   dh    = dy W_l^T
//   dz    = dh * (h_{l-1} > 0) * keep_scale        l > 0
//   dx    = round_T(dh)                            l = 0
// keep_scale is 1/(1 - rate) under dropout, else 1: a stored hidden value
// is > 0 exactly where relu passed it and dropout kept it.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/fused_gcn_kernel.py
// (_bwd_kernel, the custom_vjp backward of fused_gcn_stack).
//
// Determinism: the TPU grid adds each graph block's dW/db into one output in
// order.  Here blocks run in parallel, so each block writes its partial
// dW/db to its own row of a [G, P] scratch array, and a second kernel sums
// the rows in the order g = 0 .. G-1: no atomics, the same bits every run.
//
// Bound: as the forward (A_hat read once, 2 G S^2 sum F_l operations).  The
// same simple design: one block a graph block, dz and dy in shared memory,
// A_hat from global memory.  For A_hat^T dz a thread owns a 4 x 4 tile
// (four columns j of A_hat, four features), so the warp's loads of A_hat
// row i are contiguous and each 4-value load feeds 16 FMAs.
// Requires S % 4 == 0 and A_hat 16-byte aligned (the wrapper checks).
#include "fused_gcn_common.cuh"

namespace fused_gcn {
namespace {

struct BwdParams {
  const void* w[kMaxLayers];     // W_l [F_{l-1}, F_l], T
  const void* act[kMaxLayers];   // h_l [G, S, F_l], T, hidden layers only
  int dims[kMaxLayers + 1];
  int off_w[kMaxLayers];         // dW_l's offset in a row of the partials
  int off_b[kMaxLayers];         // db_l's offset
  int num_layers;
  int slot;
  int fp_max;
  int fin_max;
  int num_params;                // P: the length of a row of the partials
  float keep_scale;
};

// The sum of v over the warp, the same order on every lane and every run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_gcn_bwd_kernel(const T* __restrict__ a_hat, const T* __restrict__ x,
                     const float* __restrict__ g_out, T* __restrict__ dx,
                     float* __restrict__ partial, const BwdParams p) {
  extern __shared__ float smem[];
  const int S = p.slot;
  const int g = blockIdx.x;
  // dy's row stride is odd (fp + 1), so a warp reading one column of it
  // (32 rows) hits 32 banks.
  float* dz = smem;                                // [S][fp]
  float* w_s = smem + S * p.fp_max;                // [F_in][fp]
  float* dy = w_s + p.fin_max * p.fp_max;          // [S][fp + 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_warps = blockDim.x >> 5;
  const T* a = a_hat + static_cast<size_t>(g) * S * S;
  float* part = partial + static_cast<size_t>(g) * p.num_params;

  {  // dz = the incoming cotangent, padded with zero columns
    const int f = p.dims[p.num_layers];
    const int fp = round4(f);
    const float* gr = g_out + static_cast<size_t>(g) * S * f;
    for (int t = threadIdx.x; t < S * fp; t += blockDim.x) {
      const int i = t / fp, o = t - i * fp;
      dz[t] = o < f ? gr[i * f + o] : 0.0f;
    }
  }
  for (int l = p.num_layers - 1; l >= 0; --l) {
    const int f_in = p.dims[l];
    const int f_out = p.dims[l + 1];
    const int fq = (f_out + 3) >> 2;
    const int fp = fq << 2;
    const int dys = fp + 1;
    const int fp_in = round4(f_in);
    const T* h_prev =
        (l == 0 ? x : static_cast<const T*>(p.act[l - 1])) +
        static_cast<size_t>(g) * S * f_in;
    const T* w = static_cast<const T*>(p.w[l]);
    __syncthreads();
    // db partial: the column sums of the unrounded dz, a warp a column.
    for (int o = warp; o < f_out; o += num_warps) {
      float s = 0.0f;
      for (int i = lane; i < S; i += 32) s += dz[i * fp + o];
      s = warp_sum(s);
      if (lane == 0) part[p.off_b[l] + o] = s;
    }
    for (int t = threadIdx.x; t < f_in * fp; t += blockDim.x) {
      const int k = t / fp, o = t - k * fp;
      w_s[t] = o < f_out ? to_f32(w[k * f_out + o]) : 0.0f;
    }
    __syncthreads();
    if (sizeof(T) != sizeof(float)) {  // the operand of A_hat^T is round_T
      for (int t = threadIdx.x; t < S * fp; t += blockDim.x)
        dz[t] = round_to<T>(dz[t]);
      __syncthreads();
    }
    // dy = round_T(A_hat^T dz): a thread owns rows 4c..4c+3 of dy and
    // columns 4q..4q+3.
    for (int t = threadIdx.x; t < (S >> 2) * fq; t += blockDim.x) {
      const int c = t / fq, q = t - c * fq;
      float4 acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      // Unrolled so that several loads of A_hat are in flight at once.
#pragma unroll 8
      for (int i = 0; i < S; ++i) {
        const float4 av = load4(a + static_cast<size_t>(i) * S + 4 * c);
        const float4 d = *reinterpret_cast<const float4*>(&dz[i * fp + 4 * q]);
        fma4(acc[0], av.x, d);
        fma4(acc[1], av.y, d);
        fma4(acc[2], av.z, d);
        fma4(acc[3], av.w, d);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* dr = &dy[(4 * c + r) * dys + 4 * q];
        dr[0] = round_to<T>(acc[r].x);
        dr[1] = round_to<T>(acc[r].y);
        dr[2] = round_to<T>(acc[r].z);
        dr[3] = round_to<T>(acc[r].w);
      }
    }
    __syncthreads();
    // dW partial = h_prev^T dy, a warp an entry.
    for (int t = warp; t < f_in * f_out; t += num_warps) {
      const int k = t / f_out, o = t - k * f_out;
      float s = 0.0f;
#pragma unroll 4
      for (int j = lane; j < S; j += 32)
        s = fmaf(to_f32(h_prev[j * f_in + k]), dy[j * dys + o], s);
      s = warp_sum(s);
      if (lane == 0) part[p.off_w[l] + t] = s;
    }
    // dh = dy W^T; then the next dz (relu and dropout mask) or dx.
    for (int t = threadIdx.x; t < S * fp_in; t += blockDim.x) {
      const int j = t / fp_in, k = t - j * fp_in;
      float dh = 0.0f;
      if (k < f_in) {
        for (int o = 0; o < f_out; ++o)
          dh = fmaf(dy[j * dys + o], w_s[k * fp + o], dh);
      }
      if (l > 0) {
        const bool kept = k < f_in && to_f32(h_prev[j * f_in + k]) > 0.0f;
        dz[t] = kept ? dh * p.keep_scale : 0.0f;
      } else if (k < f_in) {
        store(dx + (static_cast<size_t>(g) * S + j) * f_in + k, dh);
      }
    }
  }
}

// grads[q] = sum over g = 0 .. G-1, in order, of partial[g][q].
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ grads, int graphs,
                                    int num_params) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= num_params) return;
  float s = 0.0f;
  for (int g = 0; g < graphs; ++g)
    s += partial[static_cast<size_t>(g) * num_params + q];
  grads[q] = s;
}

template <typename T>
int launch(const void* a_hat, const void* x, const void* g_out, void* dx,
           float* partial, float* grads, const BwdParams& p, int graphs,
           int smem, cudaStream_t s) {
  auto kernel = fused_gcn_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<graphs, kThreads, smem, s>>>(
      static_cast<const T*>(a_hat), static_cast<const T*>(x),
      static_cast<const float*>(g_out), static_cast<T*>(dx), partial, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  sum_partials_kernel<<<(p.num_params + threads - 1) / threads, threads, 0,
                        s>>>(partial, grads, graphs, p.num_params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fused_gcn

// Returns a CUDA error code (0 on success), or -1 for arguments the kernel
// does not take.  w: host array of num_layers device pointers; act: host
// array of the num_layers - 1 hidden activations; dims: num_layers + 1
// widths.  partial: float32 scratch [graphs, P]; grads: float32 [P], for
// each layer dW_l [F_{l-1}, F_l] then db_l [F_l], P in all.
extern "C" int fused_gcn_bwd(const void* a_hat, const void* x, int bf16,
                             const void* const* w, const void* const* act,
                             const void* g_out, void* dx, void* partial,
                             void* grads, const int* dims, int num_layers,
                             int graphs, int slot, float keep_scale,
                             void* stream) {
  using namespace fused_gcn;
  if (num_layers < 1 || num_layers > kMaxLayers || slot % 4 != 0)
    return -1;
  BwdParams p{};
  int fp_max = 0, fin_max = 0, off = 0;
  for (int l = 0; l < num_layers; ++l) {
    p.w[l] = w[l];
    p.act[l] = l < num_layers - 1 ? act[l] : nullptr;
    p.off_w[l] = off;
    off += dims[l] * dims[l + 1];
    p.off_b[l] = off;
    off += dims[l + 1];
    fp_max = fp_max > round4(dims[l + 1]) ? fp_max : round4(dims[l + 1]);
    fin_max = fin_max > dims[l] ? fin_max : dims[l];
  }
  for (int l = 0; l <= num_layers; ++l) p.dims[l] = dims[l];
  p.num_layers = num_layers;
  p.slot = slot;
  p.fp_max = fp_max;
  p.fin_max = fin_max;
  p.num_params = off;
  p.keep_scale = keep_scale;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(fp_max) * (slot + fin_max) +
                       static_cast<size_t>(fp_max + 1) * slot);
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (graphs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  return bf16 ? launch<__nv_bfloat16>(a_hat, x, g_out, dx, part, gr, p,
                                      graphs, static_cast<int>(smem), s)
              : launch<float>(a_hat, x, g_out, dx, part, gr, p, graphs,
                              static_cast<int>(smem), s);
}
