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
// (A_hat read once, 19.7 MB in float32) and the float32 operations
// (2 G S^2 sum F_l = 413 MFLOP) bound it about equally, ~6 us each.  This
// first design is simple and right rather than fast:
//   - one block a graph block, so G blocks: 32 of the card's 132 SMs;
//   - y_l lives in shared memory (S x round4(F_l) floats, 25 KB at S=392),
//     the rows of A_hat stream from global memory (L2-resident), four
//     columns at a time;
//   - a thread owns one row and four output columns, so one load of four
//     A_hat values feeds 16 FMAs;
//   - h_l is written once to its output, and read back by the next layer
//     after __syncthreads() (a block sees its own global writes then).
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
  int fp_max;      // max over layers of round4(F_l)
  int mode;        // 0: no dropout, 1: given bits, 2: Philox from *seed
  unsigned thr;
  float scale;
  const unsigned long long* seed;
};

__device__ __forceinline__ unsigned philox_word(unsigned long long seed,
                                                unsigned graph,
                                                unsigned layer,
                                                unsigned element) {
  unsigned c0 = element >> 2, c1 = layer, c2 = graph, c3 = 0u;
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
  const unsigned w = element & 3u;
  return w == 0 ? c0 : w == 1 ? c1 : w == 2 ? c2 : c3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_gcn_fwd_kernel(const T* __restrict__ a_hat, const T* __restrict__ x,
                     const FwdParams p) {
  extern __shared__ float smem[];
  const int S = p.slot;
  const int g = blockIdx.x;
  float* y = smem;                        // [S][fp]
  float* w_s = smem + S * p.fp_max;       // [F_in][fp]
  const T* a = a_hat + static_cast<size_t>(g) * S * S;
  const T* h_prev = x + static_cast<size_t>(g) * S * p.dims[0];
  unsigned long long seed = 0;
  if (p.mode == 2) seed = *p.seed;

  for (int l = 0; l < p.num_layers; ++l) {
    const int f_in = p.dims[l];
    const int f_out = p.dims[l + 1];
    const int fq = (f_out + 3) >> 2;
    const int fp = fq << 2;
    const bool hidden = l < p.num_layers - 1;
    const T* w = static_cast<const T*>(p.w[l]);
    for (int t = threadIdx.x; t < f_in * fp; t += blockDim.x) {
      const int k = t / fp, o = t - k * fp;
      w_s[t] = o < f_out ? to_f32(w[k * f_out + o]) : 0.0f;
    }
    __syncthreads();
    // y = round_T(h_prev W): a thread owns (row i, columns 4q..4q+3).
    for (int t = threadIdx.x; t < S * fq; t += blockDim.x) {
      const int i = t / fq, q = t - i * fq;
      const T* hr = h_prev + static_cast<size_t>(i) * f_in;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < f_in; ++k) {
        fma4(acc, to_f32(hr[k]),
             *reinterpret_cast<const float4*>(&w_s[k * fp + 4 * q]));
      }
      float* yr = &y[i * fp + 4 * q];
      yr[0] = round_to<T>(acc.x);
      yr[1] = round_to<T>(acc.y);
      yr[2] = round_to<T>(acc.z);
      yr[3] = round_to<T>(acc.w);
    }
    __syncthreads();
    // z = A_hat y + b, then the activation, dropout and the store.
    const float* bias = p.b[l];
    for (int t = threadIdx.x; t < S * fq; t += blockDim.x) {
      const int i = t / fq, q = t - i * fq;
      const T* ar = a + static_cast<size_t>(i) * S;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      // Unrolled so that several loads of A_hat are in flight at once: a
      // block's 16 warps are too few to hide the L2 latency one at a time.
#pragma unroll 8
      for (int j = 0; j < S; j += 4) {
        const float4 av = load4(ar + j);
        const float* yj = &y[j * fp + 4 * q];
        fma4(acc, av.x, *reinterpret_cast<const float4*>(yj));
        fma4(acc, av.y, *reinterpret_cast<const float4*>(yj + fp));
        fma4(acc, av.z, *reinterpret_cast<const float4*>(yj + 2 * fp));
        fma4(acc, av.w, *reinterpret_cast<const float4*>(yj + 3 * fp));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = 4 * q + k;
        if (o >= f_out) continue;
        const float z = get(acc, k) + bias[o];
        const size_t idx = (static_cast<size_t>(g) * S + i) * f_out + o;
        if (hidden) {
          float h = fmaxf(z, 0.0f);
          if (p.mode != 0) {
            const unsigned bits =
                p.mode == 1 ? p.bits[l][idx]
                            : philox_word(seed, g, l, i * f_out + o);
            h = bits >= p.thr ? h * p.scale : 0.0f;
          }
          store(static_cast<T*>(p.out[l]) + idx, h);
        } else {
          static_cast<float*>(p.out[l])[idx] = z;
        }
      }
    }
    __syncthreads();  // h_l is visible to the block; y and w_s are free
    h_prev = static_cast<const T*>(p.out[l]) +
             static_cast<size_t>(g) * S * f_out;
  }
}

template <typename T>
int launch(const void* a_hat, const void* x, const FwdParams& p, int graphs,
           int smem, cudaStream_t s) {
  auto kernel = fused_gcn_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<graphs, kThreads, smem, s>>>(static_cast<const T*>(a_hat),
                                        static_cast<const T*>(x), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fused_gcn

// Returns a CUDA error code (0 on success), or -1 for arguments the kernel
// does not take.  w, b, bits, out: host arrays of num_layers device
// pointers (bits may be null unless mode == 1); dims: num_layers + 1
// widths; seed: device pointer to one uint64 (mode 2).
extern "C" int fused_gcn_fwd(const void* a_hat, const void* x, int bf16,
                             const void* const* w, const void* const* b,
                             const void* const* bits, void* const* out,
                             const int* dims, int num_layers, int graphs,
                             int slot, int mode, unsigned thr, float scale,
                             const void* seed, void* stream) {
  using namespace fused_gcn;
  if (num_layers < 1 || num_layers > kMaxLayers || slot % 4 != 0 ||
      mode < 0 || mode > 2 || (mode == 1 && bits == nullptr) ||
      (mode == 2 && seed == nullptr))
    return -1;
  FwdParams p{};
  int fp_max = 0, fin_max = 0;
  for (int l = 0; l < num_layers; ++l) {
    p.w[l] = w[l];
    p.b[l] = static_cast<const float*>(b[l]);
    p.bits[l] = mode == 1 && l < num_layers - 1
                    ? static_cast<const unsigned*>(bits[l])
                    : nullptr;
    p.out[l] = out[l];
    fp_max = fp_max > round4(dims[l + 1]) ? fp_max : round4(dims[l + 1]);
    fin_max = fin_max > dims[l] ? fin_max : dims[l];
  }
  for (int l = 0; l <= num_layers; ++l) p.dims[l] = dims[l];
  p.num_layers = num_layers;
  p.slot = slot;
  p.fp_max = fp_max;
  p.mode = mode;
  p.thr = thr;
  p.scale = scale;
  p.seed = static_cast<const unsigned long long*>(seed);
  const size_t smem = sizeof(float) * static_cast<size_t>(fp_max) *
                      (static_cast<size_t>(slot) + fin_max);
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (graphs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a_hat, x, p, graphs,
                                      static_cast<int>(smem), s)
              : launch<float>(a_hat, x, p, graphs, static_cast<int>(smem),
                              s);
}
