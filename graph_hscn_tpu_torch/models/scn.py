"""SCN: the spectral clustering network trained with the relaxed MinCUT
objective; the counterpart of ``graph_hscn_tpu/models/scn.py`` (the
reference's hscn.py:19-64).

The whole padded batch runs at once: GraphConv message passing with
gcn-normalized edge weights on the flat arrays (sparse batches) or on the
per-graph blocks (slotted batches), then the MinCUT and orthogonality losses
on per-graph dense blocks [G, n_max, *] (``ops/dense.py:mincut_pool``).

Reference parity (quirk #7): messages use the normalized weights with a
self-loop diagonal, MinCUT the raw 0/1 adjacency.

Parameters: ``convs.i`` (flax ``GraphConv_i``) and ``cluster`` (flax
``Dense_0``).  The JAX SCN's optional MLP before the cluster layer
(``mlp_units``) is left out: ``build_scn`` never sets it there either.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.layers import ACTIVATIONS, Dense, GraphConv
from graph_hscn_tpu_torch.ops.dense import (batch_to_dense, mincut_pool,
                                            resolve_dense_adj, scatter_dense)
from graph_hscn_tpu_torch.ops.spmm import gcn_norm_weights


class SCN(nn.Module):
    def __init__(self, num_features: int, mp_units: Sequence[int],
                 mp_act: str, num_clusters: int, max_nodes: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.act = ACTIVATIONS[mp_act.lower()]
        self.max_nodes = max_nodes   # dense-block size of the losses
        dims = [num_features] + list(mp_units)
        self.convs = nn.ModuleList(
            GraphConv(a, b, generator=generator)
            for a, b in zip(dims[:-1], dims[1:]))
        self.cluster = Dense(dims[-1], num_clusters, generator=generator)

    def forward(self, batch: GraphBatch):
        """(s [N, K] softmax assignments, mc_loss, o_loss)."""
        n = batch.num_nodes_padded
        slot = batch.slot
        if slot is not None:
            # Raw unweighted adjacency for the losses; the messages take it
            # gcn-normalized, the self loops as a flat [N] diagonal.
            adj_raw = resolve_dense_adj(batch, weighted=False)
            inv = torch.rsqrt((adj_raw.sum(-1) + 1.0).clamp_min(1e-12))
            conv_kwargs = dict(
                dense_adj=adj_raw * inv[:, :, None] * inv[:, None, :],
                self_weight=(inv * inv).reshape(-1))
        else:
            w, diag = gcn_norm_weights(batch.senders, batch.receivers,
                                       batch.edge_mask, n,
                                       add_self_loops=True)
            conv_kwargs = dict(edge_weight=w, self_weight=diag,
                               plan=batch.spmm)
        x = batch.node_feat
        for conv in self.convs:
            x = self.act(conv(x, batch.senders, batch.receivers,
                              batch.edge_mask, num_nodes=n, **conv_kwargs))
        s_logits = self.cluster(x)

        if slot is not None:
            G = adj_raw.shape[0]
            adj = adj_raw
            mask = batch.node_mask.reshape(G, slot)
            s_dense = s_logits.reshape(G, slot, -1)
            x_dense = x.reshape(G, slot, -1)
        else:
            _, adj, mask = batch_to_dense(batch.replace(edge_weight=None),
                                          self.max_nodes)
            s_dense = scatter_dense(s_logits, batch, self.max_nodes)
            x_dense = scatter_dense(x, batch, self.max_nodes)
        _, _, mc_loss, o_loss = mincut_pool(x_dense, adj, s_dense, mask)
        return torch.softmax(s_logits, dim=-1), mc_loss, o_loss


def build_scn(hscn_cfg, num_features: int, max_nodes: int,
              generator: torch.Generator | None = None) -> SCN:
    """Mirror of the JAX ``build_scn`` (the reference's main.py:101-106)."""
    return SCN(num_features=num_features, mp_units=list(hscn_cfg.mp_units),
               mp_act=hscn_cfg.activation,
               num_clusters=hscn_cfg.num_clusters, max_nodes=max_nodes,
               generator=generator)
