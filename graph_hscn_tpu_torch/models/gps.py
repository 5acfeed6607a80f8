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
(a masked softmax-matmul a graph: on the card the hand-written kernels of
``ops/cuda/graph_attn_kernel.py`` over each graph's real nodes, on the CPU
their plain version; the JAX package runs it in XLA with no Pallas
kernel).  So GPS needs slotted batches; without slots it raises, as JAX
does.  The GCN local module takes the dense
adjacency normalized once a forward (``GCNConv.normalize_dense``, the
function JAX's layer applies to it each layer); the GatedGCN one takes no
plan on slotted batches, so its segment sums are plain ``index_add_``.

:class:`GraphGPSModel` (port-only; ``mp.gps_layer: graphgps``) is LRGB's
GraphGPS (Rampasek et al. 2022, ``graphgps/layer/gps_layer.py``) as its
Peptides-func config runs it, post-norm with BatchNorm over real rows:
  x   = [AtomEnc(x_cat) | LapPE]           (models/encoders.py)
  e   = BondEnc(e_cat)
  layer (GraphGPSLayer):
    CustomGatedGCN (GatedGCNConv(norm="batch")) from x_g, e^ of GatedGCN:
      x' = x + Drop(relu(BN_x(x_g)));  e = e + Drop(relu(BN_e(e^)))
    x_l = BN_l(x')
    x_a = BN_a(x + Drop(MHA(x, key mask, attention dropout)))
    h   = x_l + x_a
    out = BN_2(h + Drop(Dense(Drop(relu(Dense_2H(h))))))
  logits = SANGraphHead(x)                 mean over real nodes, 3 Dense

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

import numpy as np
import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.encoders import (ATOM_FEATURE_DIMS,
                                                 BOND_FEATURE_DIMS,
                                                 CategoryEmbedding,
                                                 LapPENodeEncoder,
                                                 SANGraphHead)
from graph_hscn_tpu_torch.models.layers import (ACTIVATIONS, BatchNorm, Dense,
                                               GCNConv, GatedGCNConv,
                                               LayerNorm, dropout,
                                               lecun_normal_)
from graph_hscn_tpu_torch.ops.cuda import graph_attn_kernel
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean

class GraphMHA(nn.Module):
    """Multi-head self-attention over per-graph slot blocks, the JAX
    ``GraphMHA`` (gps.py:40-80).

    ``xb [G, S, H]``, ``mask [G, S]`` (True = real node).  Padding slots
    are excluded as keys and zeroed as queries on the way out; the softmax
    runs in float32 whatever the compute dtype.  The attention between the
    projections is :func:`~graph_hscn_tpu_torch.ops.cuda.graph_attn_kernel.
    graph_attention`: the ``graph_attn`` kernels on the card, which score
    only each graph's tiles up to its last real node, and on the CPU the
    plain version (an additive ``NEG_INF`` key bias over whole blocks).

    Parameters: ``query``, ``key``, ``value`` (``Dense`` H -> nh*hd; flax
    ``DenseGeneral`` kernels [H, nh, hd], biases [nh, hd]) and ``out``
    (nh*hd -> H; flax kernel [nh, hd, H]).  Initialised glorot-uniform on
    the flattened [in, nh*hd] shape, as flax's ``DenseGeneral`` is.

    ``dropout`` (port-only, ``mp.attn_dropout``): in training the weights
    [G, nh, S, S] after the softmax are dropped as :func:`dropout` drops
    them, bits [G, nh, S, S] from the forward's ``generator`` on both
    routes, as ``torch.nn.MultiheadAttention``'s ``dropout`` does; at 0
    nothing is drawn.
    """

    def __init__(self, hidden: int, num_heads: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout: float = 0.0):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        self.dropout = dropout
        self.num_heads = num_heads
        self.head_dim = hidden // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(hidden, hidden, dtype, generator))
        self.out = Dense(hidden, hidden, dtype, generator)

    def forward(self, xb: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        G, S, _ = xb.shape
        nh, hd = self.num_heads, self.head_dim

        def proj(dense):
            return dense(xb).reshape(G, S, nh, hd)

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        out = graph_attn_kernel.graph_attention(q, k, v, mask, self.dropout,
                                                self.training, generator)
        out = self.out(out.reshape(G, S, nh * hd))
        return torch.where(mask[:, :, None], out, 0.0)

    @staticmethod
    def pairs_computed(n_node: np.ndarray, slot: int, on_card: bool) -> int:
        """The query-key pairs :meth:`forward` scores a head over blocks
        of ``slot`` rows holding ``n_node`` real nodes each, first: on the
        card (``on_card``) the kernels' visited tiles, sum of
        (ceil(n / TILE) * TILE)^2; on the CPU every pair of a block, the
        padding's too."""
        if not on_card:
            return len(n_node) * slot * slot
        tile = graph_attn_kernel.TILE
        rows = -(-np.asarray(n_node, np.int64) // tile) * tile
        return int((rows ** 2).sum())


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


class GraphGPSLayer(nn.Module):
    """One post-norm layer of LRGB's GraphGPS (module docstring): the
    local module ``local`` (GatedGCNConv in GraphGPS's form), the
    attention ``attn`` (:class:`GraphMHA` with its attention dropout), the
    FFN ``ffn0``/``ffn1`` with relu, and :class:`BatchNorm`s ``norm_local``,
    ``norm_attn``, ``norm_ffn`` over the real nodes.  ``dropout``: the
    node dropout, ``attn_dropout`` the attention weights'."""

    def __init__(self, hidden: int, num_heads: int, dropout: float,
                 attn_dropout: float, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.dropout = dropout
        self.local = GatedGCNConv(hidden, dtype, generator, residual=True,
                                  norm="batch", dropout=dropout)
        self.norm_local = BatchNorm(hidden)
        self.attn = GraphMHA(hidden, num_heads, dtype, generator,
                             attn_dropout)
        self.norm_attn = BatchNorm(hidden)
        self.ffn0 = Dense(hidden, 2 * hidden, dtype, generator)
        self.ffn1 = Dense(2 * hidden, hidden, dtype, generator)
        self.norm_ffn = BatchNorm(hidden)

    def forward(self, x, e, batch: GraphBatch,
                generator: torch.Generator | None = None):
        """Returns (x', e')."""
        mask = batch.node_mask

        def drop(h):
            return dropout(h, self.dropout, self.training, generator)

        local, e = self.local(x, e, batch.senders, batch.receivers,
                              batch.edge_mask,
                              num_nodes=batch.num_nodes_padded,
                              plan=batch.spmm, node_mask=mask,
                              generator=generator)
        h_local = self.norm_local(local, mask)
        attn = self.attn(x.reshape(-1, batch.slot, self.hidden),
                         mask.reshape(-1, batch.slot), generator)
        h_attn = self.norm_attn(x + drop(attn.reshape(-1, self.hidden)),
                                mask)
        h = h_local + h_attn
        f = self.ffn1(drop(torch.relu(self.ffn0(h))))
        return self.norm_ffn(h + drop(f), mask), e


class GraphGPSModel(nn.Module):
    """LRGB's GraphGPS on graph-level Peptides (module docstring): the
    node encoder ``atom`` (hidden - dim_pe wide, the whole hidden width
    without ``lap_pe``) beside ``lap_pe`` (:class:`LapPENodeEncoder`, from
    ``pe`` when its encoder is "lappe"), the edge encoder ``bond``,
    ``layers.i`` (:class:`GraphGPSLayer`), the ``head``
    (:class:`SANGraphHead`).  The inputs are OGB's categorical atom and
    bond features; slotted batches, as :class:`GPSModel`."""

    def __init__(self, num_features: int, hidden_channels: int,
                 num_classes: int, num_layers: int, num_heads: int = 4,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 readout: str = "mean", dtype: torch.dtype | None = None,
                 num_edge_features: int | None = None, pe=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if readout != "mean":
            raise ValueError("gps_layer graphgps has the san_graph head: a "
                             "graph-level task")
        if (num_features, num_edge_features) != (len(ATOM_FEATURE_DIMS),
                                                 len(BOND_FEATURE_DIMS)):
            raise ValueError(
                f"gps_layer graphgps embeds OGB's {len(ATOM_FEATURE_DIMS)} "
                f"atom and {len(BOND_FEATURE_DIMS)} bond features; the "
                f"dataset has {num_features} and {num_edge_features}")
        self.lap_pe = None
        width = hidden_channels
        if pe is not None:
            self.lap_pe = LapPENodeEncoder(pe.dim_pe, pe.layers,
                                           pe.eigen_max_freqs, generator)
            width -= pe.dim_pe
        self.atom = CategoryEmbedding(ATOM_FEATURE_DIMS, width, generator)
        self.bond = CategoryEmbedding(BOND_FEATURE_DIMS, hidden_channels,
                                      generator)
        self.layers = nn.ModuleList(
            GraphGPSLayer(hidden_channels, num_heads, dropout, attn_dropout,
                          dtype, generator) for _ in range(num_layers))
        self.head = SANGraphHead(hidden_channels, num_classes,
                                 generator=generator)

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [G, C], float32.  In training the sign flips and
        dropouts draw their bits from ``generator``, in that order."""
        if batch.slot is None:
            raise ValueError("GraphGPS's attention needs the slotted dense "
                             "layout (runtime.dense_path 'auto'/'dense')")
        if batch.edge_feat is None:
            raise ValueError("gps_layer graphgps needs the bond features")
        x = self.atom(batch.node_feat)
        if self.lap_pe is not None:
            x = torch.cat([x, self.lap_pe(batch, generator)], -1)
        x = torch.where(batch.node_mask[:, None], x, 0.0)
        e = torch.where(batch.edge_mask[:, None],
                        self.bond(batch.edge_feat), 0.0)
        for layer in self.layers:
            x, e = layer(x, e, batch, generator)
        return self.head(x, batch)
