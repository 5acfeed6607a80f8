"""Multi-head SpMM and head-blocked SDDMM for the H100: the counterpart of
``graph_hscn_tpu/ops/pallas/multihead_kernel.py`` (``spmm_mh``,
``sddmm_mh``, ``gat_edge_logits``), GAT's attention kernels.

Features are head-blocked on the minor axis: ``x[:, h*C:(h+1)*C]`` is head
h, and per-edge weights are ``alpha [E, H]`` in the batch's receiver-sorted
edge order.  Both kernels run on the batch's :class:`CsrPlan`:

- :func:`spmm_mh` (``csrc/spmm_mh.cu``):
  ``out[i, hC:(h+1)C] = sum_{e: recv_e = i} alpha[e, h] x[send_e, hC:(h+1)C]``;
- :func:`sddmm_mh` (``csrc/sddmm_mh.cu``):
  ``out[e, h] = <h_src[send_e, hC:(h+1)C], h_dst[recv_e, hC:(h+1)C]>``, 0 on
  the padding edges.

Both kernels take a launch plan from :func:`multihead_plan`, a pure
function of (H, C, dtype): vectors of V values of up to 16 bytes, VP of
them a thread at once; spmm_mh lays a row over a group of L lanes, by head
(S lanes a head) or along the row, with B edges' loads in flight; sddmm_mh
runs one thread an (edge, head).  ``spmm_mh`` takes an optional
``order`` (slot k reads ``alpha[order[k]]``), so the backwards on the
transpose read alpha and the SDDMM cotangent in ``t_order`` without an
[E, H] gather.

Each wrapper launches its kernel on a CUDA tensor or raises, and runs its
plain PyTorch version (``*_plain``) on a CPU tensor.  :class:`SpmmMhFunction`
and :class:`SddmmMhFunction` are the differentiable forms, with the JAX
package's custom VJPs (multihead_kernel.py:229-237, :263-277): every
gradient is one more launch of the two kernels.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from graph_hscn_tpu_torch.ops.cuda import build
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import rows_of_slots
from graph_hscn_tpu_torch.ops.cuda.vectors import aligned, pow2_ceil, widest

_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class MultiheadPlan:
    """How ``spmm_mh`` or ``sddmm_mh`` lays a row of H heads of C values
    over its threads: a group of ``lanes`` (L) lanes a row, each lane
    ``passes`` (VP) vectors of ``vec`` (V) consecutive values at once, and
    (spmm_mh) ``batch`` (B) edges' loads in flight.

    - The head layout: ``lanes_per_head`` (S) lanes a head, V dividing C.
      Vector k of head h is read by lane ``(h % (L // S)) * S + k % S`` of
      its group as its vector ``(k // S) % VP``, in head pass ``h // (L //
      S)`` and vector chunk ``k // (S * VP)``: a lane's values share a head.
      sddmm_mh always takes it with L = S = 1: one thread an (edge, head).
    - The row layout (``row_layout``, spmm_mh at H = 4): vector j of the row
      (V dividing H*C, V <= C: a vector spans at most two heads) is read by
      lane ``j % L`` as its vector ``(j // L) % VP`` in chunk ``j // (L *
      VP)``: a pass of the group reads L consecutive vectors."""

    heads: int
    c: int
    vec: int             # V
    passes: int          # VP: 1, 2 or 4
    lanes_per_head: int  # S: a power of two (1 in the row layout)
    lanes: int           # L: a power of two, S <= L <= 32
    batch: int = 1       # B: 1 or 4 (spmm_mh)
    row_layout: bool = False

    @property
    def heads_a_pass(self) -> int:
        return self.heads if self.row_layout else (self.lanes
                                                   // self.lanes_per_head)

    @property
    def head_passes(self) -> int:
        return -(-self.heads // self.heads_a_pass)

    @property
    def vec_chunks(self) -> int:
        if self.row_layout:
            return -(-(self.heads * self.c // self.vec)
                     // (self.lanes * self.passes))
        return -(-(self.c // self.vec) // (self.lanes_per_head
                                           * self.passes))

    @property
    def rows_a_warp(self) -> int:
        return 32 // self.lanes


# spmm_mh's lanes take this many bytes of a gathered row an edge (one
# vector where a vector is wider), and hold several edges' loads at once
# only when their share of the row is smaller.
LANE_BYTES = 32
KERNELS = ("spmm_mh", "sddmm_mh")


def _head_plan(heads: int, c: int, vec: int, vp: int,
               batch: int) -> MultiheadPlan:
    """spmm_mh's head layout: the fewest lanes a head that hold C / V
    vectors at VP a lane, within a warp of next_pow2(H) heads."""
    slots = pow2_ceil(heads)
    s = min(pow2_ceil(-(-(c // vec) // vp)), 32 // min(slots, 32))
    return MultiheadPlan(heads, c, vec, vp, s, min(32, s * slots), batch)


def _row_plan(heads: int, c: int, vec: int, vp: int,
              batch: int) -> MultiheadPlan:
    lanes = min(32, pow2_ceil(-(-(heads * c // vec) // vp)))
    return MultiheadPlan(heads, c, vec, vp, 1, lanes, batch, row_layout=True)


@functools.lru_cache(maxsize=512)
def multihead_plan(kernel: str, heads: int, c: int,
                   dtype: torch.dtype) -> MultiheadPlan:
    """The launch plan ``kernel`` ("spmm_mh" or "sddmm_mh") runs with for
    rows of ``heads`` heads of ``c`` values of ``dtype`` (the narrower
    operand's, for sddmm_mh's mixed operands): a pure function of the
    shapes, cached (the wrappers ask at every call).

    V is the widest vector of 16, 8, 4 or 2 bytes whose values divide C
    (the head layout) or H*C with at most C values (the row layout), so
    that every load is one aligned vector.
    - sddmm_mh: one thread an (edge, head); a float32 head of float4s all
      in flight at once (VP up to 4), else one vector.
    - spmm_mh: the row layout at H = 4 where it loads wider vectors than
      the head layout (a head of C = 21 values has no aligned vector wider
      than a value, its row of 84 has float4s); VP vectors of LANE_BYTES a
      lane; B = 4 edges in flight where a lane's share of a row is
      smaller, else 1.
    At the VOC GAT widths (H = 4), float32: C=16 -> head layout, 2 lanes a
    head of 2 float4s each, 8 lanes a row, B = 1; C=21 -> row layout, 21
    float4s over 16 lanes, B = 1; C=2 -> one float2 a lane, 4 lanes a row,
    B = 4."""
    if kernel not in KERNELS:
        raise ValueError(f"multihead_plan: kernel {kernel!r} ({KERNELS})")
    if heads < 1 or c < 1:
        raise ValueError(f"multihead_plan: {heads} heads of {c} values")
    esize = dtype.itemsize
    vec = widest(c, esize)
    if kernel == "sddmm_mh":
        vp = min(4, pow2_ceil(c // vec)) if esize == 4 and vec == 4 else 1
        return MultiheadPlan(heads, c, vec, vp, 1, 1)
    row = heads == 4 and widest(heads * c, esize, most=c) > vec
    if row:
        vec = widest(heads * c, esize, most=c)
    vp = min(4, max(1, LANE_BYTES // (vec * esize)),
             pow2_ceil(heads * c // vec if row else c // vec))
    batch = 1 if vp * vec * esize >= LANE_BYTES else 4
    return (_row_plan if row else _head_plan)(heads, c, vec, vp, batch)


def spmm_mh_plain(x: torch.Tensor, alpha: torch.Tensor,
                  row_ptr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """:func:`spmm_mh` in plain PyTorch (``index_select`` + ``index_add_``
    in float32): the CPU path, and the reference the kernel is held to.

    For bfloat16 x each message is ``bf16(f32(x_j) * alpha)`` with alpha
    unrounded, as the Pallas body rounds it (multihead_kernel.py:86); the
    sum is float32.  Padding slots are summed into a spare row that is
    dropped."""
    n = row_ptr.numel() - 1
    e, heads = alpha.shape
    c = x.shape[1] // heads
    msgs = (x.index_select(0, col.long()).float().view(e, heads, c)
            * alpha.float()[:, :, None])
    if x.dtype == torch.bfloat16:
        msgs = msgs.to(torch.bfloat16).float()
    out = torch.zeros(n + 1, heads * c, dtype=torch.float32, device=x.device)
    return out.index_add_(0, rows_of_slots(row_ptr, e),
                          msgs.view(e, heads * c))[:n]


def spmm_mh(x: torch.Tensor, alpha: torch.Tensor, row_ptr: torch.Tensor,
            col: torch.Tensor,
            order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-head weighted CSR SpMM: [N, H*C] float32.

    x [N, H*C] float32 or bfloat16; alpha [E, H] float32 (H = its width);
    row_ptr [N+1] int32; col [E] int32, E >= row_ptr[N]; order None or
    [E] int64: slot k's weights are ``alpha[order[k]]`` (the transpose's
    ``t_order``), the function of ``spmm_mh(x, alpha[order], ...)``.
    """
    if x.device.type == "cpu":
        if order is not None:
            alpha = alpha.index_select(0, order)
        return spmm_mh_plain(x, alpha, row_ptr, col)
    extra = () if order is None else (order,)
    build.check_cuda_tensors("spmm_mh", x, alpha, row_ptr, col, *extra)
    n = row_ptr.numel() - 1
    if x.dim() != 2 or x.shape[0] != n or alpha.dim() != 2:
        raise ValueError(f"spmm_mh: x {tuple(x.shape)} / alpha "
                         f"{tuple(alpha.shape)} do not fit the plan's {n} "
                         "rows")
    heads = alpha.shape[1]
    if heads == 0 or x.shape[1] % heads:
        raise ValueError(f"spmm_mh: width {x.shape[1]} is not a multiple of "
                         f"{heads} heads")
    if x.dtype not in _DTYPES:
        raise TypeError(f"spmm_mh: x dtype {x.dtype} (float32/bfloat16)")
    if (row_ptr.dtype, col.dtype, alpha.dtype) != (torch.int32, torch.int32,
                                                   torch.float32):
        raise TypeError("spmm_mh: row_ptr/col int32 and alpha float32, got "
                        f"{row_ptr.dtype}/{col.dtype}/{alpha.dtype}")
    if alpha.shape[0] != col.numel():
        raise ValueError("spmm_mh: alpha and col differ in length")
    if order is not None and (order.dtype != torch.int64
                              or order.shape != (col.numel(),)):
        raise TypeError(f"spmm_mh: order {order.dtype} "
                        f"{tuple(order.shape)} (int64 [{col.numel()}])")
    c = x.shape[1] // heads
    x, alpha = aligned(x), aligned(alpha)
    plan = multihead_plan("spmm_mh", heads, c, x.dtype)
    out = torch.empty(n, x.shape[1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.load("spmm_mh").spmm_mh(
            row_ptr.data_ptr(), col.data_ptr(),
            None if order is None else order.data_ptr(), alpha.data_ptr(),
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(), n,
            heads, c, plan.vec, plan.passes, plan.lanes_per_head, plan.lanes,
            int(plan.row_layout), plan.batch,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_mh launch failed: CUDA error {rc}")
    spmm_mh.launches += 1
    return out


spmm_mh.launches = 0


def sddmm_mh_plain(h_src: torch.Tensor, h_dst: torch.Tensor,
                   row: torch.Tensor, col: torch.Tensor, num_real: int,
                   heads: int) -> torch.Tensor:
    """:func:`sddmm_mh` in plain PyTorch (float32 products and sums): the
    CPU path, and the reference the kernel is held to."""
    c = h_src.shape[1] // heads
    out = torch.zeros(row.shape[0], heads, dtype=torch.float32,
                      device=h_src.device)
    a = h_src.index_select(0, col[:num_real].long()).float()
    b = h_dst.index_select(0, row[:num_real].long()).float()
    out[:num_real] = (a * b).view(num_real, heads, c).sum(-1)
    return out


def sddmm_mh(h_src: torch.Tensor, h_dst: torch.Tensor, row: torch.Tensor,
             col: torch.Tensor, num_real: int, heads: int) -> torch.Tensor:
    """Per-edge, per-head dots [E, H] float32; edges at or past
    ``num_real`` (the padding) are 0.

    h_src, h_dst [N, H*C] float32 or bfloat16 (each on its own); row, col
    [E] int32 (receiver and sender of each edge).
    """
    if h_src.device.type == "cpu":
        return sddmm_mh_plain(h_src, h_dst, row, col, num_real, heads)
    build.check_cuda_tensors("sddmm_mh", h_src, h_dst, row, col)
    dev = h_src.device
    if h_src.dim() != 2 or h_src.shape != h_dst.shape:
        raise ValueError(f"sddmm_mh: h_src {tuple(h_src.shape)} and h_dst "
                         f"{tuple(h_dst.shape)} must be the same [N, H*C]")
    if heads < 1 or h_src.shape[1] % heads:
        raise ValueError(f"sddmm_mh: width {h_src.shape[1]} is not a "
                         f"multiple of {heads} heads")
    if h_src.dtype not in _DTYPES or h_dst.dtype not in _DTYPES:
        raise TypeError(f"sddmm_mh: dtypes {h_src.dtype}/{h_dst.dtype} "
                        "(float32/bfloat16)")
    if row.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("sddmm_mh: row and col must be int32")
    n_edges = row.shape[0]
    if col.shape[0] != n_edges or not 0 <= num_real <= n_edges:
        raise ValueError("sddmm_mh: row/col lengths or num_real disagree")
    c = h_src.shape[1] // heads
    h_src, h_dst = aligned(h_src), aligned(h_dst)
    plan = multihead_plan(
        "sddmm_mh", heads, c, torch.bfloat16 if torch.bfloat16 in (
            h_src.dtype, h_dst.dtype) else torch.float32)
    out = torch.empty(n_edges, heads, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.load("sddmm_mh").sddmm_mh(
            row.data_ptr(), col.data_ptr(),
            h_src.data_ptr(), int(h_src.dtype == torch.bfloat16),
            h_dst.data_ptr(), int(h_dst.dtype == torch.bfloat16),
            out.data_ptr(), n_edges, num_real, heads, c, plan.vec,
            plan.passes, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sddmm_mh launch failed: CUDA error {rc}")
    sddmm_mh.launches += 1
    return out


sddmm_mh.launches = 0


class SpmmMhFunction(torch.autograd.Function):
    """Differentiable multi-head SpMM, the counterpart of ``spmm_mh``'s
    ``custom_vjp`` (multihead_kernel.py:220-240).

    forward(x [N, H*C], alpha [E, H], plan) -> [N, H*C] float32.
    backward: dx = spmm_mh on the transpose, alpha read in t_order by the
    kernel, cast to x.dtype; d alpha = sddmm_mh(x, g), cast to
    alpha.dtype.
    """

    @staticmethod
    def forward(ctx, x, alpha, plan):
        if x.shape[0] != plan.num_nodes or alpha.shape[0] != plan.col.shape[0]:
            raise ValueError(f"SpmmMhFunction: x {tuple(x.shape)} / alpha "
                             f"{tuple(alpha.shape)} do not fit the plan "
                             f"(N={plan.num_nodes}, E={plan.col.shape[0]})")
        ctx.save_for_backward(x, alpha)
        ctx.plan = plan
        return spmm_mh(x.contiguous(), alpha.float().contiguous(),
                       plan.row_ptr, plan.col)

    @staticmethod
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        plan = ctx.plan
        g = g.float().contiguous()
        dx = da = None
        if ctx.needs_input_grad[0]:
            dx = spmm_mh(g, alpha.float().contiguous(), plan.t_row_ptr,
                         plan.t_col, plan.t_order).to(x.dtype)
        if ctx.needs_input_grad[1]:
            da = sddmm_mh(x.contiguous(), g, plan.row, plan.col,
                          plan.num_edges, alpha.shape[1]).to(alpha.dtype)
        return dx, da, None


class SddmmMhFunction(torch.autograd.Function):
    """Differentiable head-blocked SDDMM, the counterpart of ``sddmm_mh``'s
    ``custom_vjp`` (multihead_kernel.py:255-280).

    forward(h_src, h_dst [N, H*C], plan, heads) -> [E, H] float32.
    backward: d h_src = spmm_mh(h_dst, g read in t_order) on the
    transpose, d h_dst = spmm_mh(h_src, g) on the forward CSR, each cast to
    its operand's dtype.
    """

    @staticmethod
    def forward(ctx, h_src, h_dst, plan, heads: int):
        ctx.save_for_backward(h_src, h_dst)
        ctx.plan = plan
        return sddmm_mh(h_src.contiguous(), h_dst.contiguous(), plan.row,
                        plan.col, plan.num_edges, heads)

    @staticmethod
    def backward(ctx, g):
        h_src, h_dst = ctx.saved_tensors
        plan = ctx.plan
        g = g.float().contiguous()
        d_src = d_dst = None
        if ctx.needs_input_grad[0]:
            d_src = spmm_mh(h_dst.contiguous(), g, plan.t_row_ptr,
                            plan.t_col, plan.t_order).to(h_src.dtype)
        if ctx.needs_input_grad[1]:
            d_dst = spmm_mh(h_src.contiguous(), g, plan.row_ptr,
                            plan.col).to(h_dst.dtype)
        return d_src, d_dst, None, None


def gat_edge_logits(a_src: torch.Tensor, a_dst: torch.Tensor,
                    plan) -> torch.Tensor:
    """Per-edge attention logits ``e[k, h] = a_src[send_k, h] +
    a_dst[recv_k, h]`` as one head-blocked SDDMM launch (C = 2), as
    multihead_kernel.py:283-296: head blocks ``[a_src, 1] . [1, a_dst]``.

    a_src, a_dst [N, H].  Returns [E, H] float32 in the plan's edge order,
    0 on the padding edges; differentiable through
    :class:`SddmmMhFunction`."""
    n, heads = a_src.shape
    hs = torch.stack([a_src, torch.ones_like(a_src)],
                     dim=-1).reshape(n, 2 * heads)
    hd = torch.stack([torch.ones_like(a_dst), a_dst],
                     dim=-1).reshape(n, 2 * heads)
    return SddmmMhFunction.apply(hs, hd, plan, heads)
