"""FusedDenseGCN: the GCN stack on slotted dense batches in the fused
kernels (``ops/fused_gcn.py``), the counterpart of
``graph_hscn_tpu/models/fused_gcn.py``.

A drop-in for ``conv_type: gcn`` with relu and no norms on slotted batches,
selected by ``runtime.fused_stack``.  The readout stays in plain torch; the
kernels cover the L-layer message passing.  Dropout is made in the kernel
from one seed a step, drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj
from graph_hscn_tpu_torch.ops.fused_gcn import fused_gcn_stack
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean

_SEED_HIGH = 2 ** 62


class FusedDenseGCN(nn.Module):
    """Parameters ``kernel_i`` [in, out] (the flax layout) and ``bias_i``,
    glorot-uniform kernels and zero biases drawn from ``generator``.

    ``dtype``: bf16 compute (operands and stored hidden activations narrow;
    accumulation, bias, relu, dropout and the logits float32), or None for
    float32.
    """

    def __init__(self, num_features: int, hidden_channels: int,
                 num_classes: int, num_layers: int, dropout: float = 0.0,
                 readout: str = "mean", dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout = dropout
        self.readout = readout
        self.dtype = dtype
        self.num_layers = num_layers
        dims = ([num_features] + [hidden_channels] * (num_layers - 1)
                + [num_classes])
        for i in range(num_layers):
            a = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
            kernel = torch.empty(dims[i], dims[i + 1])
            kernel.uniform_(-a, a, generator=generator)
            self.register_parameter(f"kernel_{i}", nn.Parameter(kernel))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.zeros(dims[i + 1])))

    def params(self) -> list[dict]:
        return [{"kernel": getattr(self, f"kernel_{i}"),
                 "bias": getattr(self, f"bias_{i}")}
                for i in range(self.num_layers)]

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [G+1, C] (mean readout) or [N, C] (readout "none"),
        float32.  In training mode with dropout, one seed is drawn from
        ``generator`` (on the batch's device) for the kernel's Philox
        stream; the global RNG is never used."""
        S = batch.slot_size
        if S is None:
            raise ValueError("FusedDenseGCN needs slotted dense batches")
        G = batch.num_graphs_padded - 1
        F0 = batch.node_feat.shape[-1]
        adj = resolve_dense_adj(batch, weighted=False)
        x = batch.node_feat.reshape(G, S, F0)
        if self.dtype is not None:
            x = x.to(self.dtype)
        rate = float(self.dropout) if self.training else 0.0
        dropout = None
        if rate > 0.0:
            if generator is None:
                raise ValueError("FusedDenseGCN dropout draws its seed from "
                                 "an explicit generator")
            dropout = {"seed": torch.randint(
                0, _SEED_HIGH, (1,), dtype=torch.int64,
                device=generator.device, generator=generator)}
        h = fused_gcn_stack(x, adj, self.params(), dropout, rate)
        out = h.reshape(G * S, -1)
        out = torch.where(batch.node_mask[:, None], out, 0.0)
        if self.readout == "none":
            return out
        return graph_readout_mean(out, batch.node_graph,
                                  batch.num_graphs_padded)
