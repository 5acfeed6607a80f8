"""Per-edge SDDMM for the H100: the counterpart of
``graph_hscn_tpu/ops/pallas/sddmm_kernel.py`` (``sddmm_pallas``).

``out[e] = <h_src[col[e]], h_dst[row[e]]>`` for the real edges and 0 for the
padding edges, in the batch's receiver-sorted edge order.  In the SpMM
backward it is the edge-weight gradient ``dw[e] = <x[send e], g[recv e]>``.

:func:`edge_sddmm` is the kernel's wrapper (``csrc/edge_sddmm.cu``): on a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`edge_sddmm_plain`, the same function in plain PyTorch.  Its launch
plan comes from :func:`edge_sddmm_plan`, a pure function of (F, the
narrower operand's dtype).
"""

from __future__ import annotations

import functools

import torch

from graph_hscn_tpu_torch.ops.cuda import build
from graph_hscn_tpu_torch.ops.cuda.vectors import (RowPlan, aligned,
                                                   pow2_ceil, widest)

_DTYPES = (torch.float32, torch.bfloat16)


# A lane of edge_sddmm takes at most this many values of each row a chunk,
# as at most MAX_PASSES vectors.
LANE_VALUES = 16
MAX_PASSES = 8
# The most lanes an edge.
MAX_LANES = 8


@functools.lru_cache(maxsize=512)
def edge_sddmm_plan(f: int, dtype: torch.dtype) -> RowPlan:
    """The launch plan ``edge_sddmm`` runs with for rows of ``f`` values,
    ``dtype`` the narrower operand's (bfloat16 where either is): a pure
    function of the two, cached (the wrapper asks at every call).

    V is the widest vector of 16, 8, 4 or 2 bytes whose values divide F;
    a group of L lanes an edge (1, 2, 4 or 8), the fewest that take the
    row at LANE_VALUES values a lane; each lane VP vectors of each row at
    once (LANE_VALUES values and MAX_PASSES vectors at most), the fewest
    powers of two that cover the row over L lanes, else in chunks.  At the
    VOC GCN widths, float32: F=64 -> 4 lanes an edge, 4 float4s each;
    F=21 -> 2 lanes, 8 scalars each, two chunks; F=128 -> 8 lanes, 4
    float4s each."""
    if f < 1:
        raise ValueError(f"edge_sddmm_plan: a row of {f} values")
    vec = widest(f, dtype.itemsize)
    lanes = min(MAX_LANES, pow2_ceil(-(-f // LANE_VALUES)))
    vp = min(MAX_PASSES, LANE_VALUES // vec,
             pow2_ceil(-(-(f // vec) // lanes)))
    return RowPlan(f, vec, vp, lanes)


def edge_sddmm_plain(h_src: torch.Tensor, h_dst: torch.Tensor,
                     row: torch.Tensor, col: torch.Tensor,
                     num_real: int) -> torch.Tensor:
    """:func:`edge_sddmm` in plain PyTorch (float32): the CPU path, and the
    reference the kernel is held to."""
    out = torch.zeros(row.shape[0], dtype=torch.float32, device=h_src.device)
    a = h_src.index_select(0, col[:num_real].long()).float()
    b = h_dst.index_select(0, row[:num_real].long()).float()
    out[:num_real] = (a * b).sum(-1)
    return out


def edge_sddmm(h_src: torch.Tensor, h_dst: torch.Tensor, row: torch.Tensor,
               col: torch.Tensor, num_real: int) -> torch.Tensor:
    """Per-edge dot products [E] float32; edges at or past ``num_real``
    (the padding) are 0.

    h_src, h_dst [N, F] float32 or bfloat16 (each on its own); row, col [E]
    int32 (receiver and sender of each edge).
    """
    if h_src.device.type == "cpu":
        return edge_sddmm_plain(h_src, h_dst, row, col, num_real)
    build.check_cuda_tensors("edge_sddmm", h_src, h_dst, row, col)
    dev = h_src.device
    if h_src.dim() != 2 or h_src.shape != h_dst.shape:
        raise ValueError(f"edge_sddmm: h_src {tuple(h_src.shape)} and h_dst "
                         f"{tuple(h_dst.shape)} must be the same [N, F]")
    if h_src.dtype not in _DTYPES or h_dst.dtype not in _DTYPES:
        raise TypeError(f"edge_sddmm: dtypes {h_src.dtype}/{h_dst.dtype} "
                        "(float32/bfloat16)")
    if row.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("edge_sddmm: row and col must be int32")
    n_edges = row.shape[0]
    if col.shape[0] != n_edges or not 0 <= num_real <= n_edges:
        raise ValueError("edge_sddmm: row/col lengths or num_real disagree")
    f = h_src.shape[1]
    plan = edge_sddmm_plan(f, torch.bfloat16 if torch.bfloat16 in (
        h_src.dtype, h_dst.dtype) else torch.float32)
    h_src, h_dst = aligned(h_src), aligned(h_dst)
    out = torch.empty(n_edges, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.load("edge_sddmm").edge_sddmm(
            row.data_ptr(), col.data_ptr(),
            h_src.data_ptr(), int(h_src.dtype == torch.bfloat16),
            h_dst.data_ptr(), int(h_dst.dtype == torch.bfloat16),
            out.data_ptr(), n_edges, num_real, f, plan.vec, plan.passes,
            plan.lanes, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edge_sddmm launch failed: CUDA error {rc}")
    edge_sddmm.launches += 1
    return out


edge_sddmm.launches = 0
