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
// dW/db to its own row of a [G * c, P] scratch array, and a second kernel
// sums the rows in order: no atomics, the same bits every run.
//
// Bound: as the forward (A_hat read once, 2 G S^2 sum F_l operations in
// the A_hat^T products, float32 FMAs).  The design mirrors the forward's
// (fused_gcn_common.cuh holds the plan):
//   1. A graph block runs on a cluster of c = 4 (or 8) blocks; block r owns
//      the columns C_r = [r*rows, (r+1)*rows) of A_hat, so dy[C_r] =
//      A_hat[:, C_r]^T dz needs only its own columns, and dW's partial,
//      dh and the next dz are per-row over C_r.
//   2. The slice A_hat[:, C_r] is copied into shared memory once (cp.async,
//      overlapping the load of the incoming dz) and serves all L layers;
//      where it does not fit even at c = 8 the same loop streams [jt, rows]
//      tiles of it.
//   3. Block r keeps dz[C_r] in shared memory; the A_hat^T product reads
//      the other blocks' rows of dz through distributed shared memory,
//      staged jt rows at a time (rounded to T as they are staged);
//      cluster.sync() separates the phases that write and read dz.
//   4. Register tiles of 4 x 4 for all three products: dy (4 columns of
//      A_hat x 4 features: 4 float4 of A_hat and 4 of dz feed 64 FMAs;
//      each dy sums i = 0 .. S-1 in order, one FMA chain, as cuBLAS's
//      batched product in the plain version does, so that its bf16
//      rounding sees the plain version's float32 value bit for bit), dW (4
//      input x 4 output features, the block's rows split among ks threads
//      a tile, about 8 rows each: float32 out, no rounding point follows)
//      and dh (4 rows x 4 input features, W^T staged in shared memory).
//      Tiles and split sums meet in shared memory and are added in a fixed
//      order by every thread, a few outputs each.
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
  int num_params;                // P: the length of a row of the partials
  float keep_scale;
  Plan plan;
  Layout lay;
};

// The sum of v over the warp, the same order on every lane and every run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_gcn_bwd_kernel(const T* __restrict__ a_hat, const T* __restrict__ x,
                     const float* __restrict__ g_out, T* __restrict__ dx,
                     float* __restrict__ partial, const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.slot, R = p.plan.rows, jt = p.plan.jt, fc = p.plan.fc;
  const bool resident = p.plan.resident != 0;
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / p.plan.cluster;
  const int col0 = rank * R;
  const int nc = max(0, min(R, S - col0));   // this block's columns
  T* a_s = reinterpret_cast<T*>(smem + p.lay.a);           // [S or jt][R]
  float* dz_own = reinterpret_cast<float*>(smem + p.lay.own);   // [R][zs]
  float* dy_own = reinterpret_cast<float*>(smem + p.lay.aux);   // [R][ds]
  float* stage = reinterpret_cast<float*>(smem + p.lay.stage);
  const int zs = p.lay.own_stride, ds = p.lay.aux_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_warps = blockDim.x >> 5;
  const T* a_cols = a_hat + static_cast<size_t>(g) * S * S + min(col0, S);
  float* part = partial + static_cast<size_t>(blockIdx.x) * p.num_params;

  if (resident && nc > 0) copy_tile_async(a_s, R, a_cols, S, S, nc);
  {  // dz = this block's rows of the incoming cotangent, zero-padded
    const int f = p.dims[p.num_layers];
    const int fp = round4(f);
    const float* gr = g_out + (static_cast<size_t>(g) * S + min(col0, S)) * f;
    for (int t = threadIdx.x; t < nc * fp; t += blockDim.x) {
      const int i = t / fp, o = t - i * fp;
      dz_own[i * zs + o] = o < f ? gr[i * f + o] : 0.0f;
    }
  }

  for (int l = p.num_layers - 1; l >= 0; --l) {
    const int f_in = p.dims[l];
    const int f_out = p.dims[l + 1];
    const int fp = round4(f_out);
    const int fp_in = round4(f_in);
    const T* h_prev =
        (l == 0 ? x : static_cast<const T*>(p.act[l - 1])) +
        static_cast<size_t>(g) * S * f_in;
    const T* w = static_cast<const T*>(p.w[l]);
    cluster.sync();   // every block's dz rows ready
    // db partial: the column sums of the unrounded dz, a warp a column.
    for (int o = warp; o < f_out; o += num_warps) {
      float s = 0.0f;
      for (int i = lane; i < nc; i += 32) s += dz_own[i * zs + o];
      s = warp_sum(s);
      if (lane == 0) part[p.off_b[l] + o] = s;
    }
    // dy[C_r] = round_T(A_hat[:, C_r]^T round_T(dz)), fc features a pass;
    // one thread a tile, its sums in the order i = 0 .. S-1 (item 4).
    for (int f0 = 0; f0 < fp; f0 += fc) {
      const int fq = min(fc, fp - f0) >> 2;
      const Split sp = split_for((nc >> 2) * fq, 1);
      const int ct = sp.tile / max(fq, 1), q = sp.tile - ct * fq;
      float4 acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i0 = 0; i0 < S; i0 += jt) {
        const int in = min(jt, S - i0);
        // Stage round_T(dz[i0 : i0+in, f0 : f0+4fq]) from its owners.
        stage_from_cluster<true, T>(stage, fc, dz_own, zs, R, i0, in, f0,
                                    fq);
        if (!resident && nc > 0)
          copy_tile_async(a_s, R, a_cols + static_cast<size_t>(i0) * S, S,
                          in, nc);
        cp_async_wait_all();   // the tile, or the first time the slice
        __syncthreads();
        if (sp.active) {
          const T* ac = a_s + static_cast<size_t>(resident ? i0 : 0) * R +
                        4 * ct;
          const float* dq = stage + 4 * q;
#pragma unroll 4
          for (int ii = 4 * sp.part; ii < in; ii += 4 * sp.ks) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 av = load4(ac + (ii + u) * R);
              const float4 d =
                  *reinterpret_cast<const float4*>(dq + (ii + u) * fc);
              fma4(acc[0], av.x, d);
              fma4(acc[1], av.y, d);
              fma4(acc[2], av.z, d);
              fma4(acc[3], av.w, d);
            }
          }
        }
        __syncthreads();
      }
      // The tiles meet in shared memory; every thread finishes (column, 4
      // features) items of dy.
      write_partials(sp, acc, stage);
      __syncthreads();
      for (int item = threadIdx.x; item < nc * fq; item += blockDim.x) {
        const int c = item / fq, qq = item - c * fq;
        const int tile = (c >> 2) * fq + qq, e0 = 4 * (c & 3);
        float* dr = &dy_own[c * ds + f0 + 4 * qq];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dr[k] = round_to<T>(sum_parts(stage, sp.tiles, sp.ks, tile, e0 + k));
      }
      __syncthreads();
    }
    cluster.sync();   // every block is done reading this block's dz

    {  // dW partial = h_prev[C_r]^T dy[C_r]: 4 x 4 tiles over (k, o).
      const int oq = fp >> 2, tiles = (fp_in >> 2) * oq;
      auto dw_tile = [&](int t, int j_first, int j_step, float4 acc[4]) {
        const int kt = t / oq, ot = t - kt * oq;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int j = j_first; j < nc; j += j_step) {
          const T* hr = h_prev + static_cast<size_t>(col0 + j) * f_in;
          const float* dr = dy_own + j * ds + 4 * ot;
          const float4 d = make_float4(dr[0], dr[1], dr[2], dr[3]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = 4 * kt + r;
            fma4(acc[r], k < f_in ? to_f32(hr[k]) : 0.0f, d);
          }
        }
      };
      auto dw_store = [&](int t, const float4 acc[4]) {
        const int kt = t / oq, ot = t - kt * oq;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = 4 * kt + r, o = 4 * ot + c;
            if (k < f_in && o < f_out)
              part[p.off_w[l] + k * f_out + o] = get(acc[r], c);
          }
        }
      };
      float4 acc[4] = {};
      if (tiles <= kThreads) {
        // Split the rows j among ks threads a tile (about 8 rows each);
        // every thread then sums output entries over the parts in order.
        const Split sp = split_for(tiles, max(1, (nc + 7) / 8));
        if (sp.active) dw_tile(sp.tile, sp.part, sp.ks, acc);
        write_partials(sp, acc, stage);
        __syncthreads();
        for (int item = threadIdx.x; item < 16 * tiles; item += blockDim.x) {
          const int e = item / tiles, t = item - e * tiles;
          const int kt = t / oq, ot = t - kt * oq;
          const int k = 4 * kt + (e >> 2), o = 4 * ot + (e & 3);
          if (k < f_in && o < f_out)
            part[p.off_w[l] + k * f_out + o] =
                sum_parts(stage, tiles, sp.ks, t, e);
        }
      } else {
        for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
          dw_tile(t, 0, 1, acc);
          dw_store(t, acc);
        }
      }
    }
    // dh = dy W^T, fc input features a pass: a thread a 4 x 4 tile (rows
    // jt4 + rc * r, so a warp's dy reads hit distinct banks), W^T staged
    // in shared memory oc rows at a time; then the next dz (relu and
    // dropout mask) or dx.
    const int rc = nc >> 2;
    __syncthreads();   // the dW reduction is done with the stage
    for (int f0 = 0; f0 < fp_in; f0 += fc) {
      const int kq = min(fc, fp_in - f0) >> 2, wc = 4 * kq;
      const int t = threadIdx.x, jt4 = t / kq, kt = t - jt4 * kq;
      const bool active = t < rc * kq;
      const int oc = p.lay.stage_floats / wc;
      float4 acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int o0 = 0; o0 < f_out; o0 += oc) {
        const int on = min(oc, f_out - o0);
        for (int u = threadIdx.x; u < on * wc; u += blockDim.x) {
          const int oo = u / wc, c = u - oo * wc, k = f0 + c;
          stage[u] = k < f_in ? to_f32(w[k * f_out + o0 + oo]) : 0.0f;
        }
        __syncthreads();
        if (active) {
#pragma unroll 4
          for (int oo = 0; oo < on; ++oo) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(&stage[oo * wc + 4 * kt]);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              fma4(acc[r], dy_own[(jt4 + rc * r) * ds + o0 + oo], w4);
          }
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jl = jt4 + rc * r, j = col0 + jl;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = f0 + 4 * kt + c;
            const float dh = get(acc[r], c);
            if (l > 0) {
              const bool kept =
                  k < f_in &&
                  to_f32(h_prev[static_cast<size_t>(j) * f_in + k]) > 0.0f;
              dz_own[jl * zs + k] = kept ? dh * p.keep_scale : 0.0f;
            } else if (k < f_in) {
              store(dx + (static_cast<size_t>(g) * S + j) * f_in + k, dh);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// grads[q] = the sum over b = 0 .. blocks-1 of partial[b][q], a warp a q:
// lane i adds rows i, i + 32, .. in order, then the fixed shuffle tree; the
// same bits every run.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ grads, int blocks,
                                    int num_params) {
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= num_params) return;
  float s = 0.0f;
  for (int b = lane; b < blocks; b += 32)
    s += partial[static_cast<size_t>(b) * num_params + q];
  s = warp_sum(s);
  if (lane == 0) grads[q] = s;
}

template <typename T>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int cluster, int blocks, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_gcn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch(const void* a_hat, const void* x, const void* g_out, void* dx,
           float* partial, float* grads, const BwdParams& p, int graphs,
           cudaStream_t s) {
  const int blocks = graphs * p.plan.cluster;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T>(&cfg, attr, p.plan.cluster, blocks,
                                 static_cast<int>(p.lay.total), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fused_gcn_bwd_kernel<T>,
                           static_cast<const T*>(a_hat),
                           static_cast<const T*>(x),
                           static_cast<const float*>(g_out),
                           static_cast<T*>(dx), partial, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = 8;   // 256 threads, a warp a parameter
  sum_partials_kernel<<<(p.num_params + warps - 1) / warps, 32 * warps, 0,
                        s>>>(partial, grads, blocks, p.num_params);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_clusters(int cluster, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T>(&cfg, attr, cluster, cluster, smem, 0);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, fused_gcn_bwd_kernel<T>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace
}  // namespace fused_gcn

// Returns a CUDA error code (0 on success), or -1 for arguments or a plan
// the kernel does not take.  w: host array of num_layers device pointers;
// act: host array of the num_layers - 1 hidden activations; dims:
// num_layers + 1 widths.  partial: float32 scratch [graphs * cluster, P];
// grads: float32 [P], for each layer dW_l [F_{l-1}, F_l] then db_l [F_l],
// P in all.  cluster .. resident: the launch plan
// (ops/fused_gcn.py:fused_plan).
extern "C" int fused_gcn_bwd(const void* a_hat, const void* x, int bf16,
                             const void* const* w, const void* const* act,
                             const void* g_out, void* dx, void* partial,
                             void* grads, const int* dims, int num_layers,
                             int graphs, int slot, float keep_scale,
                             int cluster, int rows, int jt, int fc,
                             int resident, void* stream) {
  using namespace fused_gcn;
  if (num_layers < 1 || num_layers > kMaxLayers || slot < 4 ||
      slot % 4 != 0)
    return -1;
  BwdParams p{};
  int fp_max = 0, off = 0;
  for (int l = 0; l < num_layers; ++l) {
    if (dims[l] < 1 || dims[l + 1] < 1) return -1;
    p.w[l] = w[l];
    p.act[l] = l < num_layers - 1 ? act[l] : nullptr;
    p.off_w[l] = off;
    off += dims[l] * dims[l + 1];
    p.off_b[l] = off;
    off += dims[l + 1];
    fp_max = fp_max > round4(dims[l + 1]) ? fp_max : round4(dims[l + 1]);
  }
  for (int l = 0; l <= num_layers; ++l) p.dims[l] = dims[l];
  p.num_layers = num_layers;
  p.slot = slot;
  p.num_params = off;
  p.keep_scale = keep_scale;
  p.plan = Plan{cluster, rows, jt, fc, resident};
  // dz's rows hold the widths F_1 .. F_L: dims[0] never enters it.
  if (fc > fp_max ||
      !make_layout(p.plan, slot, bf16 ? 2 : 4, resident ? slot : jt, rows,
                   fp_max, fp_max + 1, &p.lay))
    return -1;
  if (graphs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  return bf16 ? launch<__nv_bfloat16>(a_hat, x, g_out, dx, part, gr, p,
                                      graphs, s)
              : launch<float>(a_hat, x, g_out, dx, part, gr, p, graphs, s);
}

// How many clusters of the backward kernel with this plan the card holds
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int fused_gcn_bwd_max_clusters(int bf16, int cluster, int smem) {
  using namespace fused_gcn;
  return bf16 ? max_clusters<__nv_bfloat16>(cluster, smem)
              : max_clusters<float>(cluster, smem);
}
