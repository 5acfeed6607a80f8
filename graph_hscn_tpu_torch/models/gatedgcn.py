"""GatedGCN model for edge-featured graph tasks: the counterpart of
``graph_hscn_tpu/models/gatedgcn.py`` (the LRGB baseline architecture):
  node/edge encoders -> L x GatedGCNConv (residual, LayerNorm) ->
  readout "none" (a Dense a node) or mean readout -> relu Dense -> Dense.

Parameters, against the flax module's compact names (``models/convert.py``
maps one onto the other): ``encoder`` (``Dense_0``), ``edge_encoder``
(``Dense_1``, only when the batches carry edge features), ``layers.i``
(``GatedGCNConv_i``), then the head's Dense layers in order: ``pool_dense``
and ``head`` (mean readout) or ``head`` alone (readout "none").
"""

from __future__ import annotations

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.layers import Dense, GatedGCNConv, dropout
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean


class GatedGCNNet(nn.Module):
    def __init__(self, num_features: int, hidden_channels: int,
                 num_classes: int, num_layers: int, dropout: float = 0.0,
                 readout: str = "mean", dtype: torch.dtype | None = None,
                 num_edge_features: int | None = None,
                 generator: torch.Generator | None = None):
        """``dtype``: the compute dtype of the encoders and layers (params,
        the head and the logits stay float32).  ``num_edge_features``: the
        width of the batches' edge features, or None for batches without
        them (the layers then start from zero edge states)."""
        super().__init__()
        self.hidden_channels = hidden_channels
        self.dropout = dropout
        self.readout = readout
        self.encoder = Dense(num_features, hidden_channels, dtype, generator)
        self.edge_encoder = (
            Dense(num_edge_features, hidden_channels, dtype, generator)
            if num_edge_features else None)
        self.layers = nn.ModuleList(
            GatedGCNConv(hidden_channels, dtype, generator)
            for _ in range(num_layers))
        self.pool_dense = (Dense(hidden_channels, hidden_channels,
                                 generator=generator)
                           if readout != "none" else None)
        self.head = Dense(hidden_channels, num_classes, generator=generator)

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N, C] (readout "none") or [G, C], float32.  Dropout is
        on in training mode and draws its bits from ``generator``."""
        x = self.encoder(batch.node_feat)
        if (batch.edge_feat is None) != (self.edge_encoder is None):
            raise ValueError(
                "GatedGCNNet was built "
                + ("without" if self.edge_encoder is None else "with")
                + " edge features and the batch has "
                + ("none" if batch.edge_feat is None else "some"))
        if batch.edge_feat is not None:
            e = self.edge_encoder(batch.edge_feat)
        else:
            e = torch.zeros(batch.num_edges_padded, self.hidden_channels,
                            dtype=x.dtype, device=x.device)
        for conv in self.layers:
            x, e = conv(x, e, batch.senders, batch.receivers,
                        batch.edge_mask, num_nodes=batch.num_nodes_padded,
                        plan=batch.spmm)
            x = dropout(x, self.dropout, self.training, generator)
        x = torch.where(batch.node_mask[:, None], x, 0.0).float()
        if self.readout == "none":
            return self.head(x)
        pooled = graph_readout_mean(x, batch.node_graph,
                                    batch.num_graphs_padded)
        return self.head(torch.relu(self.pool_dense(pooled)))
