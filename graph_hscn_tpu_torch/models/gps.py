"""GPS graph transformer (local message passing + per-graph global
attention, the GraphGPS recipe): the counterpart of
``graph_hscn_tpu/models/gps.py``.

Layer (pre-norm), as the JAX ``GPSLayer`` (gps.py:83-126):
  h_local  = x + Drop(relu(GCNConv(LN0(x))))              local "gcn"
           = x + Drop(GatedGCNConv(LN0(x), e))            local "gatedgcn"
  h_global = x + Drop(MHA(LN1(x), node mask))             dense per-graph
  h        = h_local + h_global
  out      = h + Drop(Dense(gelu(Dense_2H(LN2(h)))))       gelu: tanh form

The global attention runs over the slotted layout's [G, slot, H] blocks
(a batched masked softmax-matmul, stock torch ops: the JAX package runs it
in XLA with no Pallas kernel).  So GPS needs slotted batches; without
slots it raises, as JAX does.  The GCN local module takes the dense
adjacency normalized once a forward (``GCNConv.normalize_dense``, the
function JAX's layer applies to it each layer); the GatedGCN one takes no
plan on slotted batches, so its segment sums are plain ``index_add_``.

Parameters, against the flax module's compact names (``models/convert.py``
maps one onto the other): ``encoder`` (``Dense_0``), ``edge_encoder``
(``Dense_1``, local "gatedgcn" only), ``layers.i`` (``GPSLayer_i``),
``norm`` (``LayerNorm_0``), ``head`` (``Dense_1``, or ``Dense_2`` after
the edge encoder).  In a layer: ``norm_local``/``norm_global``/
``norm_ffn`` (``LayerNorm_0/1/2``), ``local`` (``GCNConv_0`` or
``GatedGCNConv_0``), ``attn`` (``GraphMHA_0``), ``ffn0``/``ffn1``
(``Dense_0/1``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.layers import (ACTIVATIONS, Dense, GCNConv,
                                               GatedGCNConv, LayerNorm,
                                               dropout, lecun_normal_)
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean

# The additive bias on padding keys: finite, so that a block with no real
# node (the dummy graph slot) softmaxes to uniform weights, not NaN.
NEG_INF = -1e9


class GraphMHA(nn.Module):
    """Multi-head self-attention over per-graph slot blocks, the JAX
    ``GraphMHA`` (gps.py:40-80).

    ``xb [G, S, H]``, ``mask [G, S]`` (True = real node).  Padding slots
    are excluded as keys by an additive ``NEG_INF`` bias and zeroed as
    queries on the way out; the softmax runs in float32 whatever the
    compute dtype.

    Parameters: ``query``, ``key``, ``value`` (``Dense`` H -> nh*hd; flax
    ``DenseGeneral`` kernels [H, nh, hd], biases [nh, hd]) and ``out``
    (nh*hd -> H; flax kernel [nh, hd, H]).  Initialised glorot-uniform on
    the flattened [in, nh*hd] shape, as flax's ``DenseGeneral`` is.
    """

    def __init__(self, hidden: int, num_heads: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.head_dim = hidden // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(hidden, hidden, dtype, generator))
        self.out = Dense(hidden, hidden, dtype, generator)

    def forward(self, xb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        G, S, _ = xb.shape
        nh, hd = self.num_heads, self.head_dim

        def proj(dense):
            return dense(xb).reshape(G, S, nh, hd)

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        scores = torch.einsum("gqhd,gkhd->ghqk", q, k) / math.sqrt(hd)
        bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :]
        attn = torch.softmax((scores + bias.to(scores.dtype)).float(), -1)
        out = torch.einsum("ghqk,gkhd->gqhd", attn.to(v.dtype), v)
        out = self.out(out.reshape(G, S, nh * hd))
        return torch.where(mask[:, :, None], out, 0.0)


class GPSLayer(nn.Module):
    """One pre-norm GPS layer (module docstring).  ``local_conv``: "gcn"
    or "gatedgcn" (edge states threaded through)."""

    def __init__(self, hidden: int, num_heads: int, dropout: float,
                 local_conv: str = "gcn", dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if local_conv not in ("gcn", "gatedgcn"):
            raise ValueError(f"unknown GPS local conv {local_conv!r}")
        self.hidden = hidden
        self.dropout = dropout
        self.local_conv = local_conv
        self.norm_local = LayerNorm(hidden, dtype)
        if local_conv == "gatedgcn":
            self.local = GatedGCNConv(hidden, dtype, generator,
                                      residual=False, norm="none")
        else:
            self.local = GCNConv(hidden, hidden, dtype=dtype,
                                 generator=generator)
        self.norm_global = LayerNorm(hidden, dtype)
        self.attn = GraphMHA(hidden, num_heads, dtype, generator)
        self.norm_ffn = LayerNorm(hidden, dtype)
        # flax nn.Dense's default kernel init (the JAX layer names none).
        self.ffn0 = Dense(hidden, 2 * hidden, dtype, generator)
        self.ffn1 = Dense(2 * hidden, hidden, dtype, generator)
        lecun_normal_(self.ffn0.weight, generator)
        lecun_normal_(self.ffn1.weight, generator)

    def forward(self, x, batch: GraphBatch, dense_adj, dense_diag,
                edge_state=None, generator: torch.Generator | None = None):
        """``dense_adj``/``dense_diag``: the normalized adjacency and
        self-loop diagonal (local "gcn"); ``edge_state``: the edge states
        (local "gatedgcn").  Returns (x', edge states)."""
        n = batch.num_nodes_padded

        def drop(h):
            return dropout(h, self.dropout, self.training, generator)

        h = self.norm_local(x)
        e_out = edge_state
        if self.local_conv == "gatedgcn":
            local, e_out = self.local(h, edge_state, batch.senders,
                                      batch.receivers, batch.edge_mask,
                                      num_nodes=n, plan=batch.spmm)
            h_local = x + drop(local)
        else:
            local = self.local(h, batch.senders, batch.receivers,
                               batch.edge_mask, num_nodes=n, plan=batch.spmm,
                               dense_adj=dense_adj, dense_diag=dense_diag)
            h_local = x + drop(torch.relu(local))
        g = self.norm_global(x)
        attn = self.attn(g.reshape(-1, batch.slot, g.shape[-1]),
                         batch.node_mask.reshape(-1, batch.slot))
        h_global = x + drop(attn.reshape(-1, self.hidden))
        h = h_local + h_global
        f = self.ffn1(ACTIVATIONS["gelu"](self.ffn0(self.norm_ffn(h))))
        return h + drop(f), e_out


class GPSModel(nn.Module):
    """Input projection -> L GPS layers -> LayerNorm -> head -> masked
    mean readout (or ``readout="none"``), the JAX ``GPSModel``
    (gps.py:129-171).  ``num_edge_features``: the width of the batches'
    edge features for the "gatedgcn" local module (None: the batches have
    none, and the edge encoder reads ones [E, 1], as JAX's does)."""

    def __init__(self, num_features: int, hidden_channels: int,
                 num_classes: int, num_layers: int, num_heads: int = 4,
                 dropout: float = 0.0, local_conv: str = "gcn",
                 readout: str = "mean", dtype: torch.dtype | None = None,
                 num_edge_features: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.local_conv = local_conv
        self.readout = readout
        self.encoder = Dense(num_features, hidden_channels, dtype, generator)
        self.edge_encoder = None
        if local_conv == "gatedgcn":
            self.edge_encoder = Dense(num_edge_features or 1,
                                      hidden_channels, dtype, generator)
        self.layers = nn.ModuleList(
            GPSLayer(hidden_channels, num_heads, dropout, local_conv, dtype,
                     generator) for _ in range(num_layers))
        self.norm = LayerNorm(hidden_channels, dtype)
        self.head = Dense(hidden_channels, num_classes, dtype, generator)

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N, C] (readout "none") or [G, C], float32.  Dropout is
        on in training mode and draws its bits from ``generator``."""
        if batch.slot is None:
            raise ValueError(
                "GPS global attention needs the slotted dense layout: keep "
                "runtime.dense_path at 'auto'/'dense' (a graph may exceed "
                "DENSE_PATH_MAX_NODES)")
        x = self.encoder(batch.node_feat)
        e = None
        if self.edge_encoder is not None:
            ef = (batch.edge_feat if batch.edge_feat is not None
                  else torch.ones(batch.num_edges_padded, 1,
                                  device=x.device))
            e = self.edge_encoder(ef)
        adj, diag = None, None
        if self.local_conv == "gcn":
            adj, diag = GCNConv.normalize_dense(resolve_dense_adj(batch))
        for layer in self.layers:
            x, e = layer(x, batch, adj, diag, edge_state=e,
                         generator=generator)
        x = self.head(self.norm(x))
        x = torch.where(batch.node_mask[:, None], x, 0.0).float()
        if self.readout == "none":
            return x
        return graph_readout_mean(x, batch.node_graph,
                                  batch.num_graphs_padded)
