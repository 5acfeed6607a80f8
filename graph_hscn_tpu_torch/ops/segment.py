"""Segment reductions over nodes/edges: the counterpart of
``graph_hscn_tpu/ops/segment.py`` (the reference's torch_scatter calls,
mpnn.py:8,60).

``num_segments`` is explicit so output shapes follow the padded batch, and
padding rows land in their own (masked) segment.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean with empty segments -> 0 (matches torch_scatter.scatter_mean)."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(data.shape[0], dtype=data.dtype,
                                    device=data.device),
                         segment_ids, num_segments).clamp_min(1)
    return totals / counts.reshape((-1,) + (1,) * (data.dim() - 1))


def graph_readout_mean(node_values: torch.Tensor, node_graph: torch.Tensor,
                       num_graphs: int) -> torch.Tensor:
    """scatter_mean over the batch vector — the MPNN readout
    (reference mpnn.py:60). Padding nodes land in the dummy final graph."""
    return segment_mean(node_values, node_graph, num_graphs)


def graph_readout_sum(node_values: torch.Tensor, node_graph: torch.Tensor,
                      num_graphs: int) -> torch.Tensor:
    return segment_sum(node_values, node_graph, num_graphs)
