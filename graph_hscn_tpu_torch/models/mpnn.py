"""MPNN baselines: the counterpart of ``graph_hscn_tpu/models/mpnn.py`` (the
reference's MPNN, mpnn.py:13-76), GCN, GAT and GIN stacks: sparse batches
through the CSR kernels or plain gathers, slotted batches through
per-graph dense adjacencies.  ``build_mpnn`` also builds the GatedGCN
family (``models/gatedgcn.py``) and the GPS transformer
(``models/gps.py``), as the JAX one does.

Structure per the reference:
  layer 0:   conv(F -> H)
  layers 1..L-2: conv(H -> H)
  layer L-1: conv(H -> C)
  readout:   segment-mean over the batch vector (mpnn.py:60), or none for
             node-level tasks.

Multi-head GAT (``num_heads`` > 1) follows PyG: hidden layers split the
width across H concatenated heads of hidden // H channels; the output
layer averages H heads of num_classes channels.

Reference quirk #1, behind ``compat_double_relu``: F.relu is hard-coded
before the configured activation (mpnn.py:52,57); True reproduces relu∘act,
False applies only the configured activation.  ``use_layer_norm`` puts a
LayerNorm after that relu, before the activation and dropout, on every
hidden layer, as JAX's MPNN does (mpnn.py:89-99).
"""

from __future__ import annotations

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.gatedgcn import GatedGCNNet
from graph_hscn_tpu_torch.models.gps import GPSModel, GraphGPSModel
from graph_hscn_tpu_torch.models.layers import (ACTIVATIONS, GATConv,
                                               GCNConv, GINConv, LayerNorm,
                                               dropout)
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean


class MPNN(nn.Module):
    def __init__(self, conv_type: str, activation: str, num_features: int,
                 hidden_channels: int, num_classes: int, num_layers: int,
                 dropout: float = 0.0, use_batch_norm: bool = False,
                 use_layer_norm: bool = False,
                 compat_double_relu: bool = True, readout: str = "mean",
                 dtype: torch.dtype | None = None, num_heads: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv_type = conv_type.lower()
        if self.conv_type not in ("gcn", "gat", "gin"):
            raise ValueError(f"unknown MPNN conv_type {conv_type!r}")
        if use_batch_norm:
            # Not a port gap: JAX's first train step fails with flax's
            # ScopeCollectionNotFound (no batch_stats collection exists).
            raise ValueError(
                "mp.use_batch_norm: true cannot train in the JAX package "
                "either (graph_hscn_tpu/models/mpnn.py:93-95 creates a "
                "BatchNorm; graph_hscn_tpu/train/loop.py:125-135 keeps no "
                "batch_stats), so the port does not build it; use "
                "use_layer_norm")
        self.act = ACTIVATIONS[activation.lower()]
        self.dropout = dropout
        self.compat_double_relu = compat_double_relu
        self.readout = readout
        dims = [hidden_channels] * (num_layers - 1) + [num_classes]
        ins = [num_features] + dims[:-1]
        self.convs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(zip(ins, dims)):
            if self.conv_type == "gcn":
                conv = GCNConv(d_in, d_out, dtype=dtype, generator=generator)
            elif self.conv_type == "gin":
                conv = GINConv(d_in, d_out, dtype=dtype, generator=generator)
            else:
                hidden = i < num_layers - 1
                conv = GATConv(d_in, d_out // num_heads if hidden else d_out,
                               heads=num_heads, concat=hidden, dtype=dtype,
                               generator=generator)
            self.convs.append(conv)
        self.norms = (nn.ModuleList(LayerNorm(d, dtype) for d in dims[:-1])
                      if use_layer_norm else None)

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N, C] (readout "none") or [G, C], float32.  Dropout is
        on in training mode and draws its bits from ``generator``."""
        x = batch.node_feat
        n = batch.num_nodes_padded
        extra = {"plan": batch.spmm}
        dense_adj = resolve_dense_adj(batch)
        if dense_adj is not None and self.conv_type in ("gat", "gin"):
            # GIN aggregates over the raw adjacency counts.
            extra = {"dense_adj": dense_adj}
        elif dense_adj is not None:
            # Slotted dense path: normalize the adjacency ONCE for the whole
            # stack (it is layer-independent).
            adj_n, diag_n = GCNConv.normalize_dense(dense_adj)
            extra = {"dense_adj": adj_n, "dense_diag": diag_n}
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(x, batch.senders, batch.receivers, batch.edge_mask,
                     num_nodes=n, **extra)
            if i < last:
                if self.compat_double_relu:
                    x = torch.relu(x)
                if self.norms is not None:
                    x = self.norms[i](x)
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
               generator: torch.Generator | None = None,
               num_edge_features: int | None = None,
               pe=None) -> nn.Module:
    """Mirror of the JAX ``build_mpnn``: GatedGCN, GPS, or the GCN/GAT/GIN
    ``MPNN``; port-only, ``gps_layer: graphgps`` builds LRGB's
    ``GraphGPSModel`` with the LapPE encoder of ``pe`` (a ``PEConfig``,
    or None without PE).  ``num_edge_features``: the width of the batches'
    edge features (None without them), which only the GatedGCN and GPS
    branches read."""
    conv_type = model_cfg.conv_type.lower()
    if conv_type == "gps" and model_cfg.gps_layer == "graphgps":
        return GraphGPSModel(
            num_features=num_features,
            hidden_channels=model_cfg.hidden_channels,
            num_classes=num_classes,
            num_layers=model_cfg.num_layers,
            num_heads=model_cfg.num_heads,
            dropout=model_cfg.dropout,
            attn_dropout=model_cfg.attn_dropout,
            readout=readout,
            dtype=dtype,
            num_edge_features=num_edge_features,
            pe=pe,
            generator=generator,
        )
    if conv_type == "gatedgcn":
        return GatedGCNNet(
            num_features=num_features,
            hidden_channels=model_cfg.hidden_channels,
            num_classes=num_classes,
            num_layers=model_cfg.num_layers,
            dropout=model_cfg.dropout,
            readout=readout,
            dtype=dtype,
            num_edge_features=num_edge_features,
            generator=generator,
        )
    if conv_type == "gps":
        return GPSModel(
            num_features=num_features,
            hidden_channels=model_cfg.hidden_channels,
            num_classes=num_classes,
            num_layers=model_cfg.num_layers,
            num_heads=model_cfg.num_heads,
            dropout=model_cfg.dropout,
            local_conv=model_cfg.gps_local_conv.lower(),
            readout=readout,
            dtype=dtype,
            num_edge_features=num_edge_features,
            generator=generator,
        )
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
        num_heads=model_cfg.num_heads,
        generator=generator,
    )
