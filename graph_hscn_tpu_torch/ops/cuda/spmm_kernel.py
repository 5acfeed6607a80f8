"""CSR SpMM for the H100: the counterpart of
``graph_hscn_tpu/ops/pallas/spmm_kernel.py`` (``spmm_pallas``).

Computes ``out[i] = sum_{e: recv[e]=i} w[e] * x[send[e]]`` over the
receiver-sorted edges of a batch, with padding edges adding nothing.  The
TPU kernel reaches that through windowed one-hot matmuls on a tiling plan
built for its matrix unit; Hopper gathers rows directly, so the plan here is
plain CSR metadata (:class:`CsrPlan`), which every batch has: unlike the
windowed plan it is never infeasible.

- :func:`csr_spmm` is the kernel's wrapper (``csrc/csr_spmm.cu``): on a
  CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
  :func:`csr_spmm_plain`, the same function in plain PyTorch.  It takes an
  optional ``order`` (slot k reads ``w[order[k]]``), so the transpose reads
  the weights in ``t_order`` without an [E] gather, and its launch plan from
  :func:`csr_spmm_plan`, a pure function of (F, dtype).
- :class:`SpmmFunction` is the differentiable SpMM: forward on the CSR,
  ``dx = A^T g`` with the same kernel on the sender-sorted transpose, and
  ``dw`` through the SDDMM kernel when the weights need a gradient.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from graph_hscn_tpu_torch.data.batching import csr_row_pointers
from graph_hscn_tpu_torch.ops.cuda import build
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import edge_sddmm
from graph_hscn_tpu_torch.ops.cuda.vectors import (RowPlan, aligned,
                                                   pow2_ceil, widest)

Array = Any  # np.ndarray on the host, torch.Tensor after .to(device)


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """CSR metadata of one batch, built on the host by :func:`csr_plan`.

    Edge arrays keep the batch's receiver-sorted edge order; the real edges
    are its first ``num_edges`` slots and the padding edges the rest.

      row_ptr   [N+1] int32  row i's edges are row_ptr[i]..row_ptr[i+1],
                             over real edges only.
      col       [E]   int32  sender of each edge (the gathered row).
      row       [E]   int32  receiver of each edge (for the SDDMM).
      t_order   [E]   int64  stable sort of the edges by sender, padding
                             last: edge t_order[k] is the k-th transposed
                             edge (weights are permuted by it).
      t_row_ptr [N+1] int32  the transpose's row pointers (by sender).
      t_col     [E]   int32  receiver of each transposed edge.
    """

    row_ptr: Array
    col: Array
    row: Array
    t_order: Array
    t_row_ptr: Array
    t_col: Array
    num_nodes: int
    num_edges: int      # real edges

    def to(self, device: torch.device | str) -> "CsrPlan":
        return dataclasses.replace(self, **{
            f: torch.as_tensor(getattr(self, f)).to(device)
            for f in ("row_ptr", "col", "row", "t_order", "t_row_ptr",
                      "t_col")})


def csr_plan(senders: np.ndarray, receivers: np.ndarray,
             edge_mask: np.ndarray, num_nodes: int) -> CsrPlan:
    """The CSR plan of a packed batch: receiver-sorted edges whose real
    edges come first (what ``pack_batch`` emits).  Raises otherwise."""
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    mask = np.asarray(edge_mask, bool)
    n_real = int(mask.sum())
    if not mask[:n_real].all():
        raise ValueError("CSR plan needs the real edges before the padding")
    real_rcv = receivers[:n_real]
    if (np.diff(real_rcv) < 0).any():
        raise ValueError("CSR plan needs receiver-sorted edges")
    if n_real and (max(real_rcv.max(), senders[:n_real].max()) >= num_nodes
                   or min(real_rcv.min(), senders[:n_real].min()) < 0):
        raise ValueError("edge endpoint outside [0, num_nodes)")
    # Padding edges sort last in the transpose whatever their sender; for a
    # packed batch (padding senders = N-1, above every real sender) this is
    # the JAX plan's argsort(senders) exactly.
    order = np.argsort(np.where(mask, senders, num_nodes), kind="stable")
    return CsrPlan(
        row_ptr=csr_row_pointers(real_rcv, num_nodes),
        col=senders, row=receivers,
        t_order=order.astype(np.int64),
        t_row_ptr=csr_row_pointers(senders[order[:n_real]], num_nodes),
        t_col=receivers[order].astype(np.int32),
        num_nodes=int(num_nodes), num_edges=n_real)


def rows_of_slots(row_ptr: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The row of each edge slot of a CSR plan; the slots past row_ptr[N]
    (the padding) get the spare row N, so a plain version can sum them
    into a row it drops without reading a count back to the host."""
    slots = torch.arange(n_slots, device=row_ptr.device, dtype=row_ptr.dtype)
    return torch.searchsorted(row_ptr, slots, right=True) - 1


# csr_spmm's lanes take at most LANE_VALUES values of a row an edge (as at
# most 4 vectors), and a row of at least MIN_LANES vectors spreads over as
# many lanes; a lane group holds at most EDGE_VALUES values of a row's
# edges in flight (B edges of F values, B of 1, 2 or 4).
LANE_VALUES = 8
MIN_LANES = 8
EDGE_VALUES = 256


@functools.lru_cache(maxsize=512)
def csr_spmm_plan(f: int, dtype: torch.dtype) -> RowPlan:
    """The launch plan ``csr_spmm`` runs with for rows of ``f`` values of
    x's ``dtype``: a pure function of the two, cached (the wrapper asks at
    every call).

    V is the widest vector of 16, 8, 4 or 2 bytes whose values divide F
    (so that every load is one aligned vector); a group of L lanes takes
    a row, at least MIN_LANES (where the row has as many vectors) and
    enough that a lane takes at most LANE_VALUES values (4 vectors) of the
    row an edge; each lane VP vectors, the fewest powers of two that cover
    the row over L lanes; B edges' loads are in flight before the first
    add, B * F at most EDGE_VALUES (B of 1, 2 or 4), and a group has at
    least B lanes, so that a round of index loads holds B edges.  At the
    VOC GCN widths: F=64 float32 -> two float4s a lane, 8 lanes a row,
    B = 4; F=64 bfloat16 -> one 8-value vector a lane, 8 lanes; F=21 ->
    four scalars a lane, 8 lanes, B = 4; at the lattices' F=128, B = 2."""
    if f < 1:
        raise ValueError(f"csr_spmm_plan: a row of {f} values")
    vec = widest(f, dtype.itemsize)
    nv = f // vec
    vp_most = min(4, max(1, LANE_VALUES // vec))
    lanes = min(32, max(min(MIN_LANES, pow2_ceil(nv)),
                        pow2_ceil(-(-nv // vp_most))))
    vp = min(vp_most, pow2_ceil(-(-nv // lanes)))
    batch = next(b for b in (4, 2, 1) if b == 1 or b * f <= EDGE_VALUES)
    return RowPlan(f, vec, vp, max(lanes, batch), batch)


def csr_spmm_plain(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
                   w: torch.Tensor,
                   order: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`csr_spmm` in plain PyTorch (``index_select`` + ``index_add_``
    in float32): the CPU path, and the reference the kernel is held to.

    For bfloat16 x each message is ``bf16(bf16(w) * x_j)``, as the Pallas
    tile body rounds it (spmm_kernel.py:223,230); the sum is float32.
    Edge slots past row_ptr[N] (the padding) are summed into a spare row
    that is dropped.  With ``order``, slot k's weight is ``w[order[k]]``.
    """
    n = row_ptr.numel() - 1
    rows = rows_of_slots(row_ptr, col.numel())
    w = w.float()
    if order is not None:
        w = w.index_select(0, order)
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    msgs = x.index_select(0, col.long()).float() * w[:, None]
    if x.dtype == torch.bfloat16:
        msgs = msgs.to(torch.bfloat16).float()
    out = torch.zeros(n + 1, x.shape[1], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, msgs)[:n]


def csr_spmm(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
             w: torch.Tensor,
             order: torch.Tensor | None = None) -> torch.Tensor:
    """``out[i] = sum_{k in row i} w[src(k)] * x[col[k]]``: [N, F] float32,
    with ``src(k) = k``, or ``order[k]`` where an order is given: the
    function of ``csr_spmm(x, row_ptr, col, w[order])``.

    x [N, F] float32 or bfloat16; row_ptr [N+1] int32; col [>=nnz] int32;
    w [>=nnz] float32, where nnz = row_ptr[N]; order None or [len(col)]
    int64 (the transpose's ``t_order``).
    """
    if x.device.type == "cpu":
        return csr_spmm_plain(x, row_ptr, col, w, order)
    extra = () if order is None else (order,)
    build.check_cuda_tensors("csr_spmm", x, row_ptr, col, w, *extra)
    n = row_ptr.numel() - 1
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"csr_spmm: x {tuple(x.shape)} does not have the "
                         f"plan's {n} rows")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"csr_spmm: x dtype {x.dtype} (float32/bfloat16)")
    if (row_ptr.dtype, col.dtype, w.dtype) != (torch.int32, torch.int32,
                                               torch.float32):
        raise TypeError("csr_spmm: row_ptr/col int32 and w float32, got "
                        f"{row_ptr.dtype}/{col.dtype}/{w.dtype}")
    if w.numel() != col.numel():
        raise ValueError("csr_spmm: w and col differ in length")
    if order is not None and (order.dtype != torch.int64
                              or order.shape != (col.numel(),)):
        raise TypeError(f"csr_spmm: order {order.dtype} "
                        f"{tuple(order.shape)} (int64 [{col.numel()}])")
    f = x.shape[1]
    plan = csr_spmm_plan(f, x.dtype)
    x = aligned(x)
    out = torch.empty(n, f, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.load("csr_spmm").csr_spmm(
            row_ptr.data_ptr(), col.data_ptr(),
            None if order is None else order.data_ptr(), w.data_ptr(),
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(), n,
            f, plan.vec, plan.passes, plan.lanes, plan.batch,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmm launch failed: CUDA error {rc}")
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0


class SpmmFunction(torch.autograd.Function):
    """Differentiable CSR SpMM, the counterpart of ``spmm_pallas``'s
    ``custom_vjp`` (spmm_kernel.py:548-578).

    forward(x [N, F], w [E], plan, weight_grad) -> [N, F] float32.
    backward: dx = A^T g through the transpose plan, the weights read in
    t_order by the kernel, cast to x.dtype; dw = edge_sddmm(x, g) when
    ``weight_grad``, zeros otherwise, cast to w.dtype.
    """

    @staticmethod
    def forward(ctx, x, w, plan: CsrPlan, weight_grad: bool):
        if x.shape[0] != plan.num_nodes or w.shape[0] != plan.col.shape[0]:
            raise ValueError(f"SpmmFunction: x {tuple(x.shape)} / w "
                             f"{tuple(w.shape)} do not fit the plan "
                             f"(N={plan.num_nodes}, E={plan.col.shape[0]})")
        ctx.save_for_backward(x, w)
        ctx.plan = plan
        ctx.weight_grad = weight_grad
        return csr_spmm(x.contiguous(), plan.row_ptr, plan.col,
                        w.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        plan: CsrPlan = ctx.plan
        g = g.float().contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = csr_spmm(g, plan.t_row_ptr, plan.t_col,
                          w.float().contiguous(),
                          plan.t_order).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if ctx.weight_grad:
                dw = edge_sddmm(x.contiguous(), g, plan.row, plan.col,
                                plan.num_edges).to(w.dtype)
            else:
                dw = torch.zeros_like(w)
        return dx, dw, None, None
