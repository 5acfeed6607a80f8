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


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max within segments; an empty segment gives -inf (as
    ``jax.ops.segment_max``)."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically stable softmax within segments (GAT attention over
    incoming edges).  ``mask``: optional bool, broadcast against logits;
    masked entries get weight 0 and add nothing to the normalizer."""
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    maxes = segment_max(logits, segment_ids, num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    shifted = logits - maxes[segment_ids]
    exp = torch.where(torch.isfinite(shifted), torch.exp(shifted), 0.0)
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-16)
    return exp / denom[segment_ids]


def graph_readout_mean(node_values: torch.Tensor, node_graph: torch.Tensor,
                       num_graphs: int) -> torch.Tensor:
    """scatter_mean over the batch vector — the MPNN readout
    (reference mpnn.py:60). Padding nodes land in the dummy final graph."""
    return segment_mean(node_values, node_graph, num_graphs)


def graph_readout_sum(node_values: torch.Tensor, node_graph: torch.Tensor,
                      num_graphs: int) -> torch.Tensor:
    return segment_sum(node_values, node_graph, num_graphs)
