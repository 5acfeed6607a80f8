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
  :func:`csr_spmm_plain`, the same function in plain PyTorch.
- :class:`SpmmFunction` is the differentiable SpMM: forward on the CSR,
  ``dx = A^T g`` with the same kernel on the sender-sorted transpose, and
  ``dw`` through the SDDMM kernel when the weights need a gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from graph_hscn_tpu_torch.data.batching import csr_row_pointers
from graph_hscn_tpu_torch.ops.cuda import build
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import edge_sddmm

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


def csr_spmm_plain(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """:func:`csr_spmm` in plain PyTorch (``index_select`` + ``index_add_``
    in float32): the CPU path, and the reference the kernel is held to.

    For bfloat16 x each message is ``bf16(bf16(w) * x_j)``, as the Pallas
    tile body rounds it (spmm_kernel.py:223,230); the sum is float32.
    Edge slots past row_ptr[N] (the padding) are summed into a spare row
    that is dropped.
    """
    n = row_ptr.numel() - 1
    rows = rows_of_slots(row_ptr, col.numel())
    w = w.float()
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    msgs = x.index_select(0, col.long()).float() * w[:, None]
    if x.dtype == torch.bfloat16:
        msgs = msgs.to(torch.bfloat16).float()
    out = torch.zeros(n + 1, x.shape[1], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, msgs)[:n]


def csr_spmm(x: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_{e in row i} w[e] * x[col[e]]``: [N, F] float32.

    x [N, F] float32 or bfloat16; row_ptr [N+1] int32; col [>=nnz] int32;
    w [>=nnz] float32, where nnz = row_ptr[N].
    """
    if x.device.type == "cpu":
        return csr_spmm_plain(x, row_ptr, col, w)
    build.check_cuda_tensors("csr_spmm", x, row_ptr, col, w)
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
    out = torch.empty(n, x.shape[1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.load("csr_spmm").csr_spmm(
            row_ptr.data_ptr(), col.data_ptr(), w.data_ptr(), x.data_ptr(),
            int(x.dtype == torch.bfloat16), out.data_ptr(), n, x.shape[1],
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
    backward: dx = A^T g through the transpose plan, cast to x.dtype;
    dw = edge_sddmm(x, g) when ``weight_grad``, zeros otherwise, cast to
    w.dtype.
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
            w_t = w.float().index_select(0, plan.t_order)
            dx = csr_spmm(g, plan.t_row_ptr, plan.t_col, w_t).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if ctx.weight_grad:
                dw = edge_sddmm(x.contiguous(), g, plan.row, plan.col,
                                plan.num_edges).to(w.dtype)
            else:
                dw = torch.zeros_like(w)
        return dx, dw, None, None
