"""Segment reductions over nodes/edges: the counterpart of
``graph_hscn_tpu/ops/segment.py`` (the reference's torch_scatter calls,
mpnn.py:8,60).

``num_segments`` is explicit so output shapes follow the padded batch, and
padding rows land in their own (masked) segment.

``segment_sum_planned`` and ``gather_planned`` take the hand-written
``segment_reduce`` kernel when a CSR plan is attached and the backend allows
(``ops/spmm.py:kernel_enabled``), as their JAX counterparts take the Pallas
``segment_reduce_pallas``.
"""

from __future__ import annotations

import torch

from graph_hscn_tpu_torch.ops.cuda.segment_reduce_kernel import segment_reduce


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


def _check_plan(name: str, num_segments: int, edges: int, plan) -> None:
    if num_segments != plan.num_nodes or edges != plan.col.shape[0]:
        raise ValueError(f"{name}: {num_segments} segments / {edges} edge "
                         f"rows do not fit the plan (N={plan.num_nodes}, "
                         f"E={plan.col.shape[0]})")


class _SegmentSumPlanned(torch.autograd.Function):
    """forward: the receiver-side segment_reduce, cast to msgs.dtype;
    backward: the plain gather g[receivers] (segment.py:104-105)."""

    @staticmethod
    def forward(ctx, msgs, receivers, plan):
        ctx.save_for_backward(receivers)
        return segment_reduce(msgs.contiguous(), plan.row_ptr).to(msgs.dtype)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        return g.index_select(0, receivers), None, None


def segment_sum_planned(msgs: torch.Tensor, receivers: torch.Tensor,
                        num_segments: int, plan=None) -> torch.Tensor:
    """Receiver-sorted segment sum (the JAX ``segment_sum_planned``): the
    ``segment_reduce`` kernel when a plan is attached and the backend
    allows, ``segment_sum`` otherwise.

    msgs [E, F] in the batch's receiver-sorted edge order; padding edge rows
    must already be zero (the kernel drops them, ``segment_sum`` adds them
    to their receiver).  Differentiable: d msgs = g[receivers]."""
    from graph_hscn_tpu_torch.ops.spmm import kernel_enabled
    if plan is None or not kernel_enabled(msgs):
        return segment_sum(msgs, receivers, num_segments)
    _check_plan("segment_sum_planned", num_segments, msgs.shape[0], plan)
    return _SegmentSumPlanned.apply(msgs, receivers, plan)


class _GatherPlanned(torch.autograd.Function):
    """forward: x[idx]; backward: segment_reduce of the edge cotangents by
    receiver (row_ptr) or by sender (t_row_ptr, the rows taken in t_order),
    cast to g.dtype (segment.py:143-156)."""

    @staticmethod
    def forward(ctx, x, idx, plan, side: str):
        ctx.plan, ctx.side = plan, side
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = g.contiguous()
        if ctx.side == "receiver":
            out = segment_reduce(g, plan.row_ptr)
        else:
            out = segment_reduce(g, plan.t_row_ptr, plan.t_order)
        return out.to(g.dtype), None, None, None


def gather_planned(x: torch.Tensor, idx: torch.Tensor, plan=None,
                   side: str = "receiver") -> torch.Tensor:
    """Edge gather ``x[idx]`` whose backward (a scatter-add) takes the
    ``segment_reduce`` kernel when a plan is attached and the backend allows
    (the JAX ``gather_planned``).

    side: "receiver" if ``idx`` is the batch's receiver array, "sender" if
    it is the sender array.  Contract: the cotangents of padding edge rows
    are zero, since the kernel drops them (``index_select``'s own backward
    would add them to their node); layers meet it by masking their edge
    outputs."""
    from graph_hscn_tpu_torch.ops.spmm import kernel_enabled
    if side not in ("receiver", "sender"):
        raise ValueError(f"gather_planned: side {side!r} (receiver/sender)")
    if plan is None or not kernel_enabled(x):
        return x.index_select(0, idx)
    _check_plan("gather_planned", x.shape[0], idx.shape[0], plan)
    return _GatherPlanned.apply(x, idx, plan, side)
