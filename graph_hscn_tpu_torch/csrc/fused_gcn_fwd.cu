// fused_gcn_fwd: the whole L-layer dense GCN stack of one batch in one
// launch.  For each graph block g (A_hat [S, S], h_0 = x [S, F_0]):
//   y_l = round_T(h_{l-1} W_l)             [S, F_l], float32 accumulation
//   z_l = A_hat y_l + b_l                  float32 accumulation
//   h_l = round_T(dropout(relu(z_l)))      hidden layers, stored as T
//   h_L = z_L                              logits, stored as float32
// Dropout keeps an element when its 32 random bits are >= thr and scales
// it by `scale` (both computed by the caller from the rate).  The bits are
// either given (one uint32 array [G, S, F_l] a hidden layer) or made here
// by Philox4x32-10 keyed by the 64-bit seed and countered by
// (element / 4, layer, graph block, 0), taking word element % 4, where
// element = row * F_l + column: the wrapper's plain version computes the
// same bits.
//
// Replaces the TPU kernel graph_hscn_tpu/ops/pallas/fused_gcn_kernel.py
// (_fwd_kernel, called through fused_gcn_stack).
//
// Bound: at the peptides batch (G=32, S=392, 9->16->16->10) the bytes
// (A_hat read once, 19.7 MB in float32) bound it at ~6 us, the float32
// FMAs (2 G S^2 sum F_l = 413 MFLOP, no tensor cores under matmul
// precision "highest") at about the same.  The design (fused_gcn_common.cuh
// holds the plan):
//   1. A graph block runs on a thread-block cluster of c = 4 (or 8) blocks,
//      G*c blocks in all (128 at the peptides batch, where one block a
//      graph gave 32 of the 132 SMs).  Block r owns the rows
//      R_r = [r*rows, (r+1)*rows) of z.  (An H100 holds 30 such clusters
//      of 4 at once, so 32 graph blocks take two waves.)
//   2. Its slice A_hat[R_r, :] is copied into shared memory once, with
//      cp.async issued before the first layer's x W_1 so that the two
//      overlap, and serves all L layers (where it does not fit even at
//      c = 8, the same loop streams [rows, jt] tiles of it instead).  Its
//      row stride is padded to an odd number of float4 groups.
//   3. y_l[R_r] = h[R_r] W_l is computed from the block's own rows of h,
//      which stay in shared memory from layer to layer (x too, where its
//      rows fit; the stored h_l is written once to global memory, for the
//      backward), W_l staged in shared memory.  z[R_r] = A_hat[R_r, :] y_l
//      then reads the other blocks' rows of y_l through distributed shared
//      memory (cluster.map_shared_rank), staged jt rows at a time, four
//      remote loads in flight a thread; cluster.sync() separates the
//      layers.
//   4. A thread owns a 4 x 4 register tile of z (rows it, it + rows/4, ..,
//      so that a warp's loads of A_hat fall in distinct banks; 4 features):
//      each step of 4 j loads 4 float4 of A_hat and 4 of y for 64 FMAs.
//      Each z sums j = 0 .. S-1 in order, one FMA chain, as cuBLAS's
//      batched product in the plain version does: the bf16 rounding of h
//      then sees the plain version's float32 value bit for bit (a j range
//      split among threads sums in another order, and a value next to a
//      bf16 rounding midpoint then rounds the other way, one bf16 ulp off).
//      The tiles pass through shared memory, and every thread then
//      finishes a few (row, 4 features) items: bias, relu, dropout (one
//      Philox block for 4 elements) and the stores.
// Requires S % 4 == 0 and A_hat 16-byte aligned (the wrapper checks).
#include "fused_gcn_common.cuh"

namespace fused_gcn {
namespace {

struct FwdParams {
  const void* w[kMaxLayers];       // W_l [F_{l-1}, F_l], T
  const float* b[kMaxLayers];      // b_l [F_l]
  const unsigned* bits[kMaxLayers];  // dropout bits [G, S, F_l] (mode 1)
  void* out[kMaxLayers];           // h_l [G, S, F_l]: T, the last float32
  int dims[kMaxLayers + 1];
  int num_layers;
  int slot;
  int mode;        // 0: no dropout, 1: given bits, 2: Philox from *seed
  unsigned thr;
  float scale;
  const unsigned long long* seed;
  Plan plan;
  Layout lay;
};

// Philox4x32-10 of counter (c0, layer, graph, 0) keyed by the seed: the
// four words of elements 4 c0 .. 4 c0 + 3.
__device__ __forceinline__ uint4 philox4(unsigned long long seed,
                                         unsigned graph, unsigned layer,
                                         unsigned c0) {
  unsigned c1 = layer, c2 = graph, c3 = 0u;
  unsigned k0 = static_cast<unsigned>(seed);
  unsigned k1 = static_cast<unsigned>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2);
    const unsigned lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ unsigned word(const uint4& w, unsigned i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_gcn_fwd_kernel(const T* __restrict__ a_hat, const T* __restrict__ x,
                     const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.slot, R = p.plan.rows, jt = p.plan.jt, fc = p.plan.fc;
  const bool resident = p.plan.resident != 0;
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / p.plan.cluster;
  const int row0 = rank * R;
  const int nr = max(0, min(R, S - row0));   // this block's rows, % 4 == 0
  // A tile `it` holds the rows it, it + rt, it + 2 rt, it + 3 rt: the 8
  // tiles of a warp read 8 consecutive rows, distinct banks at as.
  const int rt = nr >> 2;
  T* a_s = reinterpret_cast<T*>(smem + p.lay.a);
  float* y_own = reinterpret_cast<float*>(smem + p.lay.own);
  float* h_own = reinterpret_cast<float*>(smem + p.lay.aux);
  float* stage = reinterpret_cast<float*>(smem + p.lay.stage);
  const int as = p.lay.a_stride, ys = p.lay.own_stride;
  const int hs = p.lay.aux_stride;
  const T* a_rows = a_hat + (static_cast<size_t>(g) * S + min(row0, S)) * S;

  if (resident && nr > 0) copy_tile_async(a_s, as, a_rows, S, nr, S);
  // This block's rows of x, the first layer's h: into h_own while the copy
  // of the A_hat slice is in flight, where they fit its rows (else read
  // from global memory).
  const int f0_in = p.dims[0];
  const bool x_in_h = f0_in < hs;
  const T* x_rows = x + (static_cast<size_t>(g) * S + min(row0, S)) * f0_in;
  if (x_in_h) {
    for (int t = threadIdx.x; t < nr * f0_in; t += blockDim.x) {
      const int i = t / f0_in;
      h_own[i * hs + t - i * f0_in] = to_f32(x_rows[t]);
    }
  }
  unsigned long long seed = 0;
  if (p.mode == 2) seed = *p.seed;
  __syncthreads();

  for (int l = 0; l < p.num_layers; ++l) {
    const int f_in = p.dims[l];
    const int f_out = p.dims[l + 1];
    const int fp = round4(f_out);
    const bool hidden = l < p.num_layers - 1;
    const bool h_global = l == 0 && !x_in_h;
    const T* w = static_cast<const T*>(p.w[l]);
    // y[R_r] = round_T(h[R_r] W), fc columns a pass: a thread a 4 x 4
    // tile, W staged in shared memory kc rows at a time.
    for (int f0 = 0; f0 < fp; f0 += fc) {
      const int fq = min(fc, fp - f0) >> 2, wc = 4 * fq;
      const int t = threadIdx.x, it = t / fq, q = t - it * fq;
      const bool active = t < rt * fq;
      const int kc = p.lay.stage_floats / wc;
      float4 acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = 0; k0 < f_in; k0 += kc) {
        const int kn = min(kc, f_in - k0);
        for (int u = threadIdx.x; u < kn * wc; u += blockDim.x) {
          const int kk = u / wc, c = u - kk * wc, o = f0 + c;
          stage[u] = o < f_out ? to_f32(w[(k0 + kk) * f_out + o]) : 0.0f;
        }
        __syncthreads();
        if (active) {
#pragma unroll 4
          for (int kk = 0; kk < kn; ++kk) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(&stage[kk * wc + 4 * q]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = it + rt * r;
              fma4(acc[r],
                   h_global ? to_f32(x_rows[i * f_in + k0 + kk])
                            : h_own[i * hs + k0 + kk],
                   w4);
            }
          }
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(
              &y_own[(it + rt * r) * ys + f0 + 4 * q]) = round4_to<T>(acc[r]);
      }
    }
    if (l == 0) cp_async_wait_all();
    cluster.sync();   // every block's y rows (and the A_hat slice) ready

    // z[R_r] = A_hat[R_r, :] y + b, fc feature columns a pass; one thread a
    // tile, its sums in the order j = 0 .. S-1 (item 4 above).
    const float* bias = p.b[l];
    for (int f0 = 0; f0 < fp; f0 += fc) {
      const int fq = min(fc, fp - f0) >> 2;
      const Split sp = split_for(rt * fq, 1);
      const int it = sp.tile / max(fq, 1), q = sp.tile - it * fq;
      float4 acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j0 = 0; j0 < S; j0 += jt) {
        const int jn = min(jt, S - j0);
        stage_from_cluster<false, T>(stage, fc, y_own, ys, R, j0, jn, f0,
                                     fq);
        if (!resident && nr > 0) {
          copy_tile_async(a_s, as, a_rows + j0, S, nr, jn);
          cp_async_wait_all();
        }
        __syncthreads();
        if (sp.active) {
          const T* ar = a_s + static_cast<size_t>(it) * as +
                        (resident ? j0 : 0);
          const size_t rstep = static_cast<size_t>(rt) * as;
          const float* yq = stage + 4 * q;
#pragma unroll 4
          for (int jj = 4 * sp.part; jj < jn; jj += 4 * sp.ks) {
            const float4 y0 = *reinterpret_cast<const float4*>(yq + jj * fc);
            const float4 y1 =
                *reinterpret_cast<const float4*>(yq + (jj + 1) * fc);
            const float4 y2 =
                *reinterpret_cast<const float4*>(yq + (jj + 2) * fc);
            const float4 y3 =
                *reinterpret_cast<const float4*>(yq + (jj + 3) * fc);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float4 av = load4(ar + r * rstep + jj);
              fma4(acc[r], av.x, y0);
              fma4(acc[r], av.y, y1);
              fma4(acc[r], av.z, y2);
              fma4(acc[r], av.w, y3);
            }
          }
        }
        __syncthreads();
      }
      // The tiles meet in shared memory; then every thread finishes (row, 4
      // columns) items: bias, activation, dropout, the stores (4
      // consecutive values of a row), and the block's own h.
      write_partials(sp, acc, stage);
      __syncthreads();
      for (int item = threadIdx.x; item < nr * fq; item += blockDim.x) {
        const int i = item / fq, qq = item - i * fq;
        const int row = row0 + i;
        const int tile = (i % max(rt, 1)) * fq + qq, r = i / max(rt, 1);
        const size_t base = (static_cast<size_t>(g) * S + row) * f_out;
        uint4 words = make_uint4(0u, 0u, 0u, 0u);
        unsigned ctr = 0xffffffffu;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int o = f0 + 4 * qq + k;
          if (o >= f_out) break;
          const float z =
              sum_parts(stage, sp.tiles, sp.ks, tile, 4 * r + k) + bias[o];
          if (hidden) {
            float h = fmaxf(z, 0.0f);
            if (p.mode == 1) {
              h = p.bits[l][base + o] >= p.thr ? h * p.scale : 0.0f;
            } else if (p.mode == 2) {
              const unsigned e = static_cast<unsigned>(row * f_out + o);
              if ((e >> 2) != ctr) {
                ctr = e >> 2;
                words = philox4(seed, g, l, ctr);
              }
              h = word(words, e & 3u) >= p.thr ? h * p.scale : 0.0f;
            }
            store(static_cast<T*>(p.out[l]) + base + o, h);
            h_own[i * hs + o] = round_to<T>(h);
          } else {
            static_cast<float*>(p.out[l])[base + o] = z;
          }
        }
      }
      __syncthreads();   // the stage is free for the next pass
    }
    // Every block is done reading the others' y (and may leave, after the
    // last layer); h_own holds this layer's output for the next.
    cluster.sync();
  }
}

template <typename T>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int cluster, int blocks, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_gcn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
int launch(const void* a_hat, const void* x, const FwdParams& p, int graphs,
           cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T>(&cfg, attr, p.plan.cluster,
                                 graphs * p.plan.cluster,
                                 static_cast<int>(p.lay.total), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fused_gcn_fwd_kernel<T>,
                           static_cast<const T*>(a_hat),
                           static_cast<const T*>(x), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_clusters(int cluster, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T>(&cfg, attr, cluster, cluster, smem, 0);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, fused_gcn_fwd_kernel<T>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace
}  // namespace fused_gcn

// Returns a CUDA error code (0 on success), or -1 for arguments or a plan
// the kernel does not take.  w, b, bits, out: host arrays of num_layers
// device pointers (bits may be null unless mode == 1); dims: num_layers + 1
// widths; seed: device pointer to one uint64 (mode 2); cluster ..
// resident: the launch plan (ops/fused_gcn.py:fused_plan).
extern "C" int fused_gcn_fwd(const void* a_hat, const void* x, int bf16,
                             const void* const* w, const void* const* b,
                             const void* const* bits, void* const* out,
                             const int* dims, int num_layers, int graphs,
                             int slot, int mode, unsigned thr, float scale,
                             const void* seed, int cluster, int rows, int jt,
                             int fc, int resident, void* stream) {
  using namespace fused_gcn;
  if (num_layers < 1 || num_layers > kMaxLayers || slot < 4 ||
      slot % 4 != 0 || mode < 0 || mode > 2 ||
      (mode == 1 && bits == nullptr) || (mode == 2 && seed == nullptr))
    return -1;
  FwdParams p{};
  int fp_max = 0, hid_max = 0;
  for (int l = 0; l < num_layers; ++l) {
    if (dims[l] < 1 || dims[l + 1] < 1) return -1;
    p.w[l] = w[l];
    p.b[l] = static_cast<const float*>(b[l]);
    p.bits[l] = mode == 1 && l < num_layers - 1
                    ? static_cast<const unsigned*>(bits[l])
                    : nullptr;
    p.out[l] = out[l];
    fp_max = fp_max > round4(dims[l + 1]) ? fp_max : round4(dims[l + 1]);
    if (l > 0) hid_max = hid_max > round4(dims[l]) ? hid_max : round4(dims[l]);
  }
  for (int l = 0; l <= num_layers; ++l) p.dims[l] = dims[l];
  p.num_layers = num_layers;
  p.slot = slot;
  p.mode = mode;
  p.thr = thr;
  p.scale = scale;
  p.seed = static_cast<const unsigned long long*>(seed);
  p.plan = Plan{cluster, rows, jt, fc, resident};
  // fc may not exceed the widest layer's padded width: the stage holds fc
  // columns of y.
  if (fc > fp_max ||
      !make_layout(p.plan, slot, bf16 ? 2 : 4, rows,
                   padded_stride(resident ? slot : jt), fp_max, hid_max + 1,
                   &p.lay))
    return -1;
  if (graphs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a_hat, x, p, graphs, s)
              : launch<float>(a_hat, x, p, graphs, s);
}

// How many clusters of the forward kernel with this plan the card holds at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int fused_gcn_fwd_max_clusters(int bf16, int cluster, int smem) {
  using namespace fused_gcn;
  return bf16 ? max_clusters<__nv_bfloat16>(cluster, smem)
              : max_clusters<float>(cluster, smem);
}
