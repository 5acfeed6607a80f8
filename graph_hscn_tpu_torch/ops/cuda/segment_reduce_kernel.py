"""CSR segment sum for the H100: the counterpart of
``graph_hscn_tpu/ops/pallas/sddmm_kernel.py`` (``segment_reduce_pallas``).

``out[i] = sum_{k = row_ptr[i]}^{row_ptr[i+1]-1} msgs[src(k)]`` with
``src(k) = k``, or ``order[k]`` when an order is given.  On a batch's
:class:`~graph_hscn_tpu_torch.ops.cuda.spmm_kernel.CsrPlan` that is the sum
of receiver-sorted edge rows by receiver (``row_ptr``), or by sender
(``t_row_ptr`` with ``order = t_order``: the permutation of the edge rows is
folded into the kernel's loads).  Slots past ``row_ptr[N]`` (the padding)
add nothing; a row with no edges is 0.

:func:`segment_reduce` is the kernel's wrapper (``csrc/segment_reduce.cu``):
on a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`segment_reduce_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from graph_hscn_tpu_torch.ops.cuda import build
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import rows_of_slots


def segment_reduce_plain(msgs: torch.Tensor, row_ptr: torch.Tensor,
                         order: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`segment_reduce` in plain PyTorch (``index_add_`` in float32):
    the CPU path, and the reference the kernel is held to.  Slots past
    row_ptr[N] (the padding) are summed into a spare row that is dropped."""
    n = row_ptr.numel() - 1
    if order is not None:
        msgs = msgs.index_select(0, order)
    out = torch.zeros(n + 1, msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, rows_of_slots(row_ptr, msgs.shape[0]),
                          msgs.float())[:n]


def segment_reduce(msgs: torch.Tensor, row_ptr: torch.Tensor,
                   order: torch.Tensor | None = None) -> torch.Tensor:
    """Row sums of a CSR over message rows: [N, F] float32.

    msgs [E, F] float32 or bfloat16 (bfloat16 values summed in float32);
    row_ptr [N+1] int32; order None or [E] int64, each entry < E.
    """
    if msgs.device.type == "cpu":
        return segment_reduce_plain(msgs, row_ptr, order)
    extra = () if order is None else (order,)
    build.check_cuda_tensors("segment_reduce", msgs, row_ptr, *extra)
    if msgs.dim() != 2:
        raise ValueError(f"segment_reduce: msgs {tuple(msgs.shape)} is not "
                         "[E, F]")
    if msgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_reduce: msgs dtype {msgs.dtype} "
                        "(float32/bfloat16)")
    if row_ptr.dtype != torch.int32:
        raise TypeError(f"segment_reduce: row_ptr {row_ptr.dtype} (int32)")
    if order is not None and (order.dtype != torch.int64
                              or order.shape != (msgs.shape[0],)):
        raise TypeError(f"segment_reduce: order {order.dtype} "
                        f"{tuple(order.shape)} (int64 [{msgs.shape[0]}])")
    n = row_ptr.numel() - 1
    out = torch.empty(n, msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    with torch.cuda.device(msgs.device):
        rc = build.load("segment_reduce").segment_reduce(
            row_ptr.data_ptr(), None if order is None else order.data_ptr(),
            msgs.data_ptr(), int(msgs.dtype == torch.bfloat16),
            out.data_ptr(), n, msgs.shape[1],
            torch.cuda.current_stream(msgs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_reduce launch failed: CUDA error {rc}")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
