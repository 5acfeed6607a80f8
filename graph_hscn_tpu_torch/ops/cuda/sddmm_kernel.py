"""Per-edge SDDMM for the H100: the counterpart of
``graph_hscn_tpu/ops/pallas/sddmm_kernel.py`` (``sddmm_pallas``).

``out[e] = <h_src[col[e]], h_dst[row[e]]>`` for the real edges and 0 for the
padding edges, in the batch's receiver-sorted edge order.  In the SpMM
backward it is the edge-weight gradient ``dw[e] = <x[send e], g[recv e]>``.

:func:`edge_sddmm` is the kernel's wrapper (``csrc/edge_sddmm.cu``): on a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`edge_sddmm_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from graph_hscn_tpu_torch.ops.cuda import build

_DTYPES = (torch.float32, torch.bfloat16)


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
    out = torch.empty(n_edges, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.load("edge_sddmm").edge_sddmm(
            row.data_ptr(), col.data_ptr(),
            h_src.data_ptr(), int(h_src.dtype == torch.bfloat16),
            h_dst.data_ptr(), int(h_dst.dtype == torch.bfloat16),
            out.data_ptr(), n_edges, num_real, h_src.shape[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edge_sddmm launch failed: CUDA error {rc}")
    edge_sddmm.launches += 1
    return out


edge_sddmm.launches = 0
