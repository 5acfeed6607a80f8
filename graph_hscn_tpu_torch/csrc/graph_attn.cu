// graph_attn: GraphMHA's attention over each graph's slot block, forward and
// backward, with the dropout of the attention weights inside:
//   P = softmax_j(scale * q_i . k_j) over the graph's real keys j,
//   O_i = sum_j P_ij * keep_ij / (1 - rate) * v_j,
// for q, k, v [G, S, nh, hd] (the Q/K/V projections of the slotted layout)
// and a node mask [G, S].
//
// Replaces no TPU kernel: the JAX package runs this attention in XLA
// (graph_hscn_tpu/models/gps.py, GraphMHA), and the port ran it as stock
// torch ops (an einsum to the [G, nh, S, S] scores, the scale, an additive
// key bias, a float32 softmax, the dropout's compare and where, an einsum
// against V), each a pass over the whole padded score tensor.
//
// Bound: at real pairs, the forward reads the dropout draw (4 bytes a pair)
// beside 4 * hd flops a pair (the score and its share of P V), and is bound
// by those bytes at hd 24; the backward's 10 * hd flops a pair bound it.  Q,
// K, V, O and dO rows are read once a block.  The design keeps the work to
// the real pairs and the traffic to the rows:
//   - one warp a block, a block a (query or key tile of 32 rows, head,
//     graph); each lane holds one row (its q, o, or k, v, dk, dv) in
//     registers, the other operand's tile of 32 rows is staged in shared
//     memory and read as float4 broadcasts;
//   - a block loops over the other operand's tiles up to extent[g], one past
//     the graph's last real node; tiles past it are never loaded or scored,
//     and query or key tiles past it write zeros.  In the slotted layout the
//     real nodes come first, so the loop's end is the whole padding; inside
//     a visited tile, keys the mask marks as padding are excluded exactly
//     (a warp ballot of the mask);
//   - the forward's softmax is online (a running max and sum a row, float32
//     FMA, no TF32): the scores and probabilities never go to device
//     memory; the forward keeps the row log-sum-exp for the backward, which
//     recomputes each probability as exp(s - lse);
//   - dropout reads the program's own draw, uniform [G, nh, S, S] float32
//     bits, only at the visited pairs, a lane its row of the tile as
//     16-byte loads; the forward packs the keep decisions (bits >= rate) of
//     a tile row into one 32-bit word and stores them for the backward
//     ([G, nh, S, ceil(S/32)] words), so the draw is freed after the
//     forward;
//   - the backward is two kernels on the stream, in order: dQ (a query row a
//     lane; it also writes D_i = dO_i . O_i) then dK and dV (a key row a
//     lane), each sum in one lane's registers in a fixed order: no atomics,
//     deterministic.  dS = P * (dP - D) with dP = keep * dA / (1 - rate),
//     dA = dO . V^T.
// q, k, v, out and the gradients are float32 or bfloat16 (bfloat16 values
// read exactly, every sum in float32, results rounded once to bfloat16).
// hd up to 64, held in registers padded to the next of 8, 16, 24, 32, 48,
// 64 (the pad is zeros and adds nothing).
#include "graph_attn_common.cuh"

namespace {

template <typename T, int HDP>
__global__ void __launch_bounds__(kTile)
graph_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const unsigned char* __restrict__ mask,
                      const int* __restrict__ extent,
                      const float* __restrict__ bits, T* __restrict__ out,
                      float* __restrict__ lse, unsigned* __restrict__ keep,
                      int S, int nh, int hd, float scale, float rate,
                      float keep_scale) {
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
  T* orow = out + at.base + size_t(i) * at.rs;
  if (i0 >= n) {  // a query tile past the graph's last real node
    if (i < S) {
      for (int d = 0; d < hd; ++d) st(orow + d, 0.0f);
      lse[gh * S + i] = 0.0f;
    }
    return;
  }
  float qr[HDP], o[HDP];
  load_row<T, HDP>(qr, q, at, i, S, hd);
#pragma unroll
  for (int d = 0; d < HDP; ++d) o[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    __syncwarp();
    stage<T, HDP>(ks, vs, k, v, at, j0, S, hd, lane);
    const unsigned valid = real_keys(mask, g, S, n, j0, lane);
    unsigned word = kFull;
    if (bits != nullptr && i < S) {
      // The lane's row of the draw in the tile, 16-byte loads where the
      // row is aligned and whole; bit jj of the word is key j0 + jj's keep
      // decision.  Draws past the slot are not read (0): no kernel uses
      // their bits.
      const float* row = bits + (gh * S + i) * S + j0;
      word = 0;
      if (S % 4 == 0 && j0 + kTile <= S) {
#pragma unroll 4
        for (int c = 0; c < kTile; c += 4) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(row + c));
          word |= unsigned(b.x >= rate) << c
                  | unsigned(b.y >= rate) << (c + 1)
                  | unsigned(b.z >= rate) << (c + 2)
                  | unsigned(b.w >= rate) << (c + 3);
        }
      } else {
        for (int jj = 0; jj < kTile && j0 + jj < S; ++jj) {
          word |= unsigned(__ldg(row + jj) >= rate) << jj;
        }
      }
      keep[(gh * S + i) * W + j0 / kTile] = word;
    }
    __syncwarp();
    if (valid == 0) continue;
    float s[kTile];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const float x = dot<HDP>(qr, ks[jj]) * scale;
      s[jj] = (valid >> jj) & 1u ? x : -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    const float m_new = fmaxf(m, tmax);  // finite: the tile has a real key
    const float alpha = expf(m - m_new);  // 0 on the first real tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HDP; ++d) o[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const float p = expf(s[jj] - m_new);  // 0 for a padding key
      l += p;
      axpy<HDP>(o, (word >> jj) & 1u ? p : 0.0f, vs[jj]);
    }
    m = m_new;
  }
  if (i < S) {
    const float inv = keep_scale / l;
    for (int d = 0; d < hd; ++d) st(orow + d, o[d] * inv);
    lse[gh * S + i] = m + logf(l);
  }
}

template <typename T, int HDP>
void launch_fwd(const void* q, const void* k, const void* v,
                const unsigned char* mask, const int* extent,
                const float* bits, void* out, float* lse, unsigned* keep,
                int G, int S, int nh, int hd, float scale, float rate,
                float keep_scale, cudaStream_t s) {
  const dim3 grid((S + kTile - 1) / kTile, nh, G);
  graph_attn_fwd_kernel<T, HDP><<<grid, kTile, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, extent, bits, static_cast<T*>(out), lse,
      keep, S, nh, hd, scale, rate, keep_scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for
// arguments no kernel takes (hd outside 1..64, G over 65535).
// bf16: 0 for float32 q, k, v (and out, grad, the gradients), 1 for
// bfloat16.  mask: bool [G, S]; extent: int32 [G], one past each graph's
// last real node.  bits: null (no dropout) or float32 [G, nh, S, S]; keep:
// null or uint32 [G, nh, S, ceil(S/32)], written by the forward where bits
// are given, read by the backward where given.  lse: float32 [G, nh, S].
extern "C" int graph_attn(const void* q, const void* k, const void* v,
                          int bf16, const void* mask, const void* extent,
                          const void* bits, void* out, void* lse, void* keep,
                          int G, int S, int nh, int hd, float scale,
                          float rate, float keep_scale, void* stream) {
  if (refused(G, S, nh, hd)) return -1;
  if (G > 0 && S > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* mk = static_cast<const unsigned char*>(mask);
    const auto* ex = static_cast<const int*>(extent);
    const auto* bt = static_cast<const float*>(bits);
    auto* ls = static_cast<float*>(lse);
    auto* kp = static_cast<unsigned*>(keep);
    if (bf16) {
      GRAPH_ATTN_DISPATCH(__nv_bfloat16, launch_fwd, q, k, v, mk, ex, bt,
                          out, ls, kp, G, S, nh, hd, scale, rate, keep_scale,
                          s)
    } else {
      GRAPH_ATTN_DISPATCH(float, launch_fwd, q, k, v, mk, ex, bt, out, ls,
                          kp, G, S, nh, hd, scale, rate, keep_scale, s)
    }
  }
  return static_cast<int>(cudaGetLastError());
}

