"""MPNN baselines: the counterpart of ``graph_hscn_tpu/models/mpnn.py`` (the
reference's MPNN, mpnn.py:13-76), GCN stacks so far.

Structure per the reference:
  layer 0:   conv(F -> H)
  layers 1..L-2: conv(H -> H)
  layer L-1: conv(H -> C)
  readout:   segment-mean over the batch vector (mpnn.py:60), or none for
             node-level tasks.

Reference quirk #1, behind ``compat_double_relu``: F.relu is hard-coded
before the configured activation (mpnn.py:52,57); True reproduces relu∘act,
False applies only the configured activation.
"""

from __future__ import annotations

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.layers import ACTIVATIONS, GCNConv, dropout
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean


class MPNN(nn.Module):
    def __init__(self, conv_type: str, activation: str, num_features: int,
                 hidden_channels: int, num_classes: int, num_layers: int,
                 dropout: float = 0.0, use_batch_norm: bool = False,
                 use_layer_norm: bool = False,
                 compat_double_relu: bool = True, readout: str = "mean",
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if conv_type.lower() != "gcn":
            raise NotImplementedError(
                f"conv_type {conv_type!r}: ROADMAP queue A, item 4")
        if use_batch_norm or use_layer_norm:
            raise NotImplementedError(
                "use_batch_norm / use_layer_norm: ROADMAP queue A, item 4")
        self.act = ACTIVATIONS[activation.lower()]
        self.dropout = dropout
        self.compat_double_relu = compat_double_relu
        self.readout = readout
        dims = [hidden_channels] * (num_layers - 1) + [num_classes]
        ins = [num_features] + dims[:-1]
        self.convs = nn.ModuleList(
            GCNConv(i, o, dtype=dtype, generator=generator)
            for i, o in zip(ins, dims))

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N, C] (readout "none") or [G, C], float32.  Dropout is
        on in training mode and draws its bits from ``generator``."""
        resolve_dense_adj(batch)
        x = batch.node_feat
        n = batch.num_nodes_padded
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(x, batch.senders, batch.receivers, batch.edge_mask,
                     num_nodes=n, plan=batch.spmm)
            if i < last:
                if self.compat_double_relu:
                    x = torch.relu(x)
                x = self.act(x)
                x = dropout(x, self.dropout, self.training, generator)
        # Mask padding before readout so dummy rows can't leak; logits back
        # to f32 so losses/metrics are full-precision.
        x = torch.where(batch.node_mask[:, None], x, 0.0).float()
        if self.readout == "none":
            return x
        return graph_readout_mean(x, batch.node_graph,
                                  batch.num_graphs_padded)


def build_mpnn(model_cfg, num_features: int, num_classes: int,
               compat: bool = True, readout: str = "mean", dtype=None,
               generator: torch.Generator | None = None) -> MPNN:
    """Mirror of the JAX ``build_mpnn``, its GCN branch; the other conv
    types are later slices of the port."""
    if model_cfg.conv_type.lower() != "gcn":
        raise NotImplementedError(
            f"conv_type {model_cfg.conv_type!r}: ROADMAP queue A, items 4 "
            "and 8")
    return MPNN(
        conv_type=model_cfg.conv_type,
        activation=model_cfg.activation,
        num_features=num_features,
        hidden_channels=model_cfg.hidden_channels,
        num_classes=num_classes,
        num_layers=model_cfg.num_layers,
        dropout=model_cfg.dropout,
        use_batch_norm=model_cfg.use_batch_norm,
        use_layer_norm=model_cfg.use_layer_norm,
        compat_double_relu=compat,
        readout=readout,
        dtype=dtype,
        generator=generator,
    )
