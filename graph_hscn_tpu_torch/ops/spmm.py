"""Sparse message aggregation: gather -> (optional edge weight) -> segment
reduce.  The counterpart of ``graph_hscn_tpu/ops/spmm.py``, and the compute
core of every sparse conv layer.

With edges sorted by receiver the aggregation is a CSR SpMM:
``out[i] = sum_{e: recv[e]=i} w[e] * x[send[e]]``.  Two paths:

  - the hand-written CSR kernel (``ops/cuda/spmm_kernel.py``) when a plan is
    attached and the backend allows: on a CUDA tensor it launches the
    kernel, on a CPU tensor (backend ``"pallas"``) it runs the kernel's plain
    version through the same ``autograd.Function``.  Padding edges add
    nothing and the output is float32;
  - plain ``index_select`` + ``index_add_`` over every edge slot (the JAX
    package's XLA path) for backend ``"xla"`` or a batch without a plan.

The backend names are the JAX package's: ``"auto"`` takes the kernel on CUDA
and plain ops elsewhere, ``"pallas"`` the kernel path everywhere, ``"xla"``
plain ops everywhere.  One CSR kernel serves every size: the JAX package's
routing by VMEM budget is a fact of the TPU.
"""

from __future__ import annotations

import torch

from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import SpmmFunction
from graph_hscn_tpu_torch.ops.segment import segment_sum

_BACKEND = "auto"  # "auto" | "xla" | "pallas"


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown spmm backend {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def _use_kernel(x: torch.Tensor) -> bool:
    if _BACKEND == "xla":
        return False
    if _BACKEND == "pallas":
        return True
    return x.is_cuda


def gather_scatter(
    x: torch.Tensor,          # [N, F] node features
    senders: torch.Tensor,    # [E] int64
    receivers: torch.Tensor,  # [E] int64, sorted ascending
    *,
    num_nodes: int | None = None,
    edge_weight: torch.Tensor | None = None,   # [E] or None
    messages_out: bool = False,
    plan=None,                # CsrPlan from GraphBatch.spmm
    weight_needs_grad: bool = False,
):
    """out[i] = sum over incoming edges of (w_e * x[sender_e]).

    ``weight_needs_grad=False`` (the default) declares that the edge
    weights carry no trainable parameters (gcn_norm / mask-derived — true
    for every in-repo caller): edge_weight is detached on EVERY path, so
    d(edge_weight) is zero whichever path runs, and the kernel's backward
    skips the SDDMM.

    If ``messages_out`` is True also returns the per-edge gathered messages
    (before reduction), which some layers (GatedGCN) reuse.
    """
    num_nodes = num_nodes if num_nodes is not None else x.shape[0]
    if edge_weight is not None and not weight_needs_grad:
        edge_weight = edge_weight.detach()
    if plan is not None and not messages_out and _use_kernel(x):
        if num_nodes != plan.num_nodes:
            raise ValueError(f"num_nodes {num_nodes} != plan's "
                             f"{plan.num_nodes}")
        w = (edge_weight if edge_weight is not None
             else torch.ones(senders.shape[0], dtype=x.dtype,
                             device=x.device))
        return SpmmFunction.apply(x, w, plan, weight_needs_grad)
    msgs = x.index_select(0, senders)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    out = segment_sum(msgs, receivers, num_nodes)
    if messages_out:
        return out, msgs
    return out


def gcn_norm_weights(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
    add_self_loops: bool = True,
    edge_weight: torch.Tensor | None = None,
):
    """Symmetric GCN normalization  D^-1/2 (A+I) D^-1/2, matching PyG's
    ``gcn_norm``.

    Returns per-edge weights for the existing edge list plus, when
    ``add_self_loops``, the per-node self-loop weight ``1/(deg_i+1)`` to be
    applied as a separate diagonal term (no extra edges are materialized).

    With ``edge_weight`` the degree is the WEIGHTED in-degree and the
    returned weights are ``w_e * dinv[send] * dinv[recv]``; without it, deg
    counts incoming real edges + 1 for the self loop.
    """
    ones = torch.where(edge_mask,
                       1.0 if edge_weight is None else edge_weight, 0.0)
    deg = segment_sum(ones, receivers, num_nodes)
    if add_self_loops:
        deg = deg + 1.0
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
    w = inv_sqrt[senders] * inv_sqrt[receivers]
    if edge_weight is not None:
        w = w * edge_weight
    w = torch.where(edge_mask, w, 0.0)
    diag = inv_sqrt * inv_sqrt if add_self_loops else None
    return w, diag
