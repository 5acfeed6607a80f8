"""Graph conv layers (torch.nn) with PyG-parity math: the counterpart of
``graph_hscn_tpu/models/layers.py``.

Layers consume the flat CSR representation of a GraphBatch:
  x [N, F], senders [E], receivers [E] (sorted), edge_mask [E]
and are pure w.r.t. padding: padded rows in, zero rows out.

Parameters follow torch's layout: a flax ``kernel`` [in, out] is a
``weight`` [out, in] here (``models/convert.py`` maps one onto the other).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from graph_hscn_tpu_torch.ops.spmm import gather_scatter, gcn_norm_weights


def resolve_dtype(name: str | None) -> torch.dtype | None:
    """Config string -> compute dtype (None = native float32)."""
    if name in (None, "", "float32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"Unknown compute_dtype {name!r}")


def promote_dtype(*tensors: torch.Tensor, dtype: torch.dtype | None = None):
    """flax ``nn.dtypes.promote_dtype``: cast every tensor to ``dtype``, or
    to their common type when it is None."""
    if dtype is None:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def glorot_uniform_(weight: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``glorot_uniform`` on a torch [out, in] weight: U(-a, a) with
    a = sqrt(6 / (fan_in + fan_out))."""
    fan_out, fan_in = weight.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-a, a, generator=generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate).  The bits come from ``generator``."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class GCNConv(nn.Module):
    """PyG GCNConv:  X' = D^-1/2 (A + I) D^-1/2 X W + b.

    Self-loops are folded in as a diagonal term (weight 1/(deg_i+1)) rather
    than materialized edges, which keeps the edge array static.  Sparse
    branch of the JAX layer (layers.py:80-127); the dense-slot branch is
    slice 2 of the port.
    """

    def __init__(self, in_features: int, features: int,
                 add_self_loops: bool = True, normalize: bool = True,
                 use_bias: bool = True, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        self.dtype = dtype     # compute dtype (params stay float32)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x, senders, receivers, edge_mask, edge_weight=None,
                num_nodes=None, plan=None):
        n = num_nodes or x.shape[0]
        x, w = promote_dtype(x, self.weight, dtype=self.dtype)
        h = F.linear(x, w)
        if self.normalize:
            # Weighted degree when edge_weight is given (PyG gcn_norm
            # computes deg from the edge weights, not the edge count).
            norm_w, diag = gcn_norm_weights(
                senders, receivers, edge_mask, n,
                add_self_loops=self.add_self_loops, edge_weight=edge_weight)
        else:
            norm_w = torch.where(
                edge_mask,
                edge_weight if edge_weight is not None else 1.0, 0.0)
            diag = None
        out = gather_scatter(h, senders, receivers, num_nodes=n,
                             edge_weight=norm_w.to(h.dtype), plan=plan)
        if diag is not None:
            out = out + diag.to(h.dtype)[:, None] * h
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    # flax nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}
