"""HSCN: the heterogeneous virtual-node convolution network; the counterpart
of ``graph_hscn_tpu/models/hscn.py`` (the reference's hscn.py:67-140).

No hetero object exists: virtual nodes live in a dense [G*K, F] array
addressed by ``vid = graph_id * K + cluster``, and each layer runs three
relations:

  local->local     GCNConv (add_self_loops=False) on the batch's edges,
                   sparse (the CSR kernel with a plan) or a dense block a
                   graph; or GATConv when ``ll_conv`` is "GAT" (with a plan
                   the attention kernels, as the MPNN's GATConv takes them;
                   JAX's HSCN passes its ll GATConv no plan, and gathers:
                   the same function);
  local->virtual   bipartite GATConv: each real node attends to its
                   cluster's virtual node, softmax over the cluster's
                   members;
  virtual->virtual DenseGCN or DenseGAT over a per-graph K x K adjacency.

HeteroConv aggr="sum": "local" receives ll (plus, with
``virtual_feedback``, a projection of its cluster's virtual state), and
"virtual" receives lv + vv; ReLU after every layer for both types, then a
mean over each graph's local nodes (or none, node-level) and a two-layer
head.  Without ``virtual_feedback`` the lv and vv relations do not reach the
output (quirk #17); they run all the same, as in the JAX model.

Virtual topology (quirk #9): ``vv_pattern="triangular"`` is the reference's
{(i, j): i + j < num_active} over compacted active positions, self loops
included; "clique" is the full directed clique without self loops.

Parameters, against flax's names (``models/convert.py``): ``ll.l``
(``GCNConv_l``, or with ``ll_conv`` "GAT" ``GATConv_{2l}``), ``lv.l``
(``GATConv_l``, or ``GATConv_{2l+1}``), ``vv.l`` (``DenseGCN_l`` /
``DenseGAT_l``), ``vl.l`` (``VLDense_l``), ``pool_dense`` and ``head``
(``Dense_0``, ``Dense_1``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.layers import (ACTIVATIONS, Dense, GATConv,
                                               GCNConv, glorot_uniform_,
                                               leaky_relu, promote_dtype)
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean, segment_sum


def virtual_node_features(batch: GraphBatch, num_clusters: int,
                          index_shift: bool = False):
    """Initial virtual-node features: the mean of each (graph, cluster)'s
    member node features (the reference's hetero_data.py:56-59).

    Returns (x_v [G*K, F], v_active [G*K] bool, vid [N] int64).
    ``index_shift`` reproduces quirk #8: a node of the occupied cluster of
    compacted rank r gives its features to the occupied cluster of rank
    (r - 1) mod U, U the graph's occupied clusters (the reference compacts
    with np.unique, then rotates with Python's negative-index wrap).
    """
    K = num_clusters
    G = batch.num_graphs_padded
    dev = batch.node_feat.device
    vid = batch.node_graph * K + batch.cluster
    ones = batch.node_mask.to(batch.node_feat.dtype)
    count = segment_sum(ones, vid, G * K)
    if index_shift:
        occ = (count > 0).reshape(G, K)
        occ_i = occ.long()
        rank = torch.cumsum(occ_i, 1) - 1                    # [G, K]
        U = occ_i.sum(1)                                     # [G]
        # order[g, r]: the id of the occupied cluster of rank r; the free
        # slots sort to the back.
        sort_key = torch.where(occ, torch.arange(K, device=dev)[None, :], K)
        order = torch.argsort(sort_key, dim=1, stable=True)
        prev_rank = torch.remainder(rank - 1, U.clamp_min(1)[:, None])
        prev_id = torch.take_along_dim(order, prev_rank, dim=1)
        feat_cluster = prev_id[batch.node_graph, batch.cluster]
    else:
        feat_cluster = batch.cluster
    feat_vid = batch.node_graph * K + feat_cluster
    x_masked = torch.where(batch.node_mask[:, None], batch.node_feat, 0.0)
    x_v = segment_sum(x_masked, feat_vid, G * K)
    feat_count = segment_sum(ones, feat_vid, G * K)
    x_v = x_v / feat_count.clamp_min(1.0)[:, None]
    v_active = (count > 0) & batch.graph_mask.repeat_interleave(K)
    return x_v, v_active, vid


def vv_adjacency(v_active: torch.Tensor, num_graphs: int, num_clusters: int,
                 pattern: str, dtype: torch.dtype) -> torch.Tensor:
    """Per-graph K x K virtual adjacency A[g, dst, src] (the JAX
    ``_vv_adjacency``): "clique", all active pairs without self loops; or
    "triangular" (quirk #9), the pairs of compacted active positions with
    p_src + p_dst < num_active."""
    K = num_clusters
    act = v_active.reshape(num_graphs, K).to(dtype)
    pair = act[:, :, None] * act[:, None, :]
    if pattern == "clique":
        return pair * (1.0 - torch.eye(K, dtype=dtype, device=act.device))
    pos = torch.cumsum(act, 1) - 1.0                     # [G, K]
    num_active = act.sum(1)                              # [G]
    ok = (pos[:, :, None] + pos[:, None, :]) < num_active[:, None, None]
    return torch.where(ok, 1.0, 0.0).to(dtype) * pair


class DenseGCN(nn.Module):
    """GCNConv on a dense batched adjacency (the vv relation):
    out = D^-1/2 A D^-1/2 (X W) + b, in-degree normalization, no added
    self loops (PyG GCNConv(add_self_loops=False)).  Parameters:
    ``weight`` [out, in] (flax ``kernel``), ``bias``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x [G, K, F], adj [G, K, K] with adj[g, dst, src]."""
        deg_in = adj.sum(-1)
        inv = torch.where(deg_in > 0, torch.rsqrt(deg_in.clamp_min(1e-12)),
                          0.0)
        a_norm = adj * inv[:, :, None] * inv[:, None, :]
        x, w, a_norm = promote_dtype(x, self.weight, a_norm, dtype=self.dtype)
        out = torch.bmm(a_norm, x @ w.t())
        return out + self.bias.to(out.dtype)


class DenseGAT(nn.Module):
    """GATConv on a dense batched adjacency (the vv relation's other type;
    PyG semantics with add_self_loops=False), H heads of ``features``
    channels, concatenated.  Parameters: ``weight`` [H*C, in] (flax
    ``kernel_src``), ``att_src``/``att_dst`` [1, 1, H, C] as in flax,
    ``bias`` [H*C]."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.features = heads, features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(heads * features, in_features))
        glorot_uniform_(self.weight, generator)
        # flax glorot on a (1, 1, H, C) array: fan_in H, fan_out C.
        a = math.sqrt(6.0 / (heads + features))
        self.att_src = nn.Parameter(torch.empty(1, 1, heads, features))
        self.att_dst = nn.Parameter(torch.empty(1, 1, heads, features))
        with torch.no_grad():
            for att in (self.att_src, self.att_dst):
                att.uniform_(-a, a, generator=generator)
        self.bias = nn.Parameter(torch.zeros(heads * features))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        H, C = self.heads, self.features
        x, w = promote_dtype(x, self.weight, dtype=self.dtype)
        G, K = x.shape[0], x.shape[1]
        h = (x @ w.t()).reshape(G, K, H, C)
        a_s = (h * self.att_src.to(h.dtype)).sum(-1)          # [G, K, H]
        a_d = (h * self.att_dst.to(h.dtype)).sum(-1)
        e = leaky_relu(a_s[:, None, :, :] + a_d[:, :, None, :])  # [G,d,s,H]
        conn = (adj > 0)[..., None]
        e = torch.where(conn, e, -torch.inf)
        m = e.amax(dim=2, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        ex = torch.where(conn, torch.exp(e - m), 0.0)
        alpha = ex / ex.sum(dim=2, keepdim=True).clamp_min(1e-16)
        out = torch.einsum("gijh,gjhc->gihc", alpha, h).reshape(G, K, H * C)
        return out + self.bias.to(out.dtype)


class HSCN(nn.Module):
    def __init__(self, num_features: int, ll_conv: str,
                 vv_conv: str, activation: str, hidden_channels: int,
                 num_classes: int, num_layers: int, num_clusters: int,
                 num_heads: int = 1, vv_pattern: str = "triangular",
                 index_shift: bool = False, virtual_feedback: bool = False,
                 readout: str = "mean", dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ll_gat = ll_conv.upper() == "GAT"
        self.num_clusters = num_clusters
        self.vv_pattern = vv_pattern
        self.index_shift = index_shift
        self.readout = readout
        self.act = ACTIVATIONS[activation.lower()]
        hid, heads = hidden_channels, num_heads
        gat_feat = hid // heads
        self.ll, self.lv, self.vv = (nn.ModuleList() for _ in range(3))
        self.vl = nn.ModuleList() if virtual_feedback else None
        for layer in range(num_layers):
            # Local and virtual states start at the input width.
            f_in = num_features if layer == 0 else hid
            self.ll.append(
                GATConv(f_in, gat_feat, heads=heads, add_self_loops=False,
                        dtype=dtype, generator=generator) if self.ll_gat
                else GCNConv(f_in, hid, add_self_loops=False, dtype=dtype,
                             generator=generator))
            self.lv.append(GATConv(f_in, gat_feat, heads=heads,
                                   add_self_loops=False, dtype=dtype,
                                   generator=generator, dst_features=f_in))
            self.vv.append(
                DenseGAT(f_in, gat_feat, heads=heads, dtype=dtype,
                         generator=generator) if vv_conv.upper() == "GAT"
                else DenseGCN(f_in, hid, dtype=dtype, generator=generator))
            if virtual_feedback:
                # Zero-initialized: at init the model equals the
                # reference-faithful one.
                vl = Dense(f_in, hid, dtype=dtype, generator=generator)
                nn.init.zeros_(vl.weight)
                self.vl.append(vl)
        self.pool_dense = Dense(hid, hid, generator=generator)
        self.head = Dense(hid, num_classes, generator=generator)

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N, C] (readout "none") or [G, C], float32.  The model
        has no dropout; ``generator`` is accepted for the train loop."""
        if batch.cluster is None:
            raise ValueError("HSCN needs cluster assignments")
        K = self.num_clusters
        G, N = batch.num_graphs_padded, batch.num_nodes_padded
        x_l = batch.node_feat
        x_v, v_active, vid = virtual_node_features(batch, K,
                                                   self.index_shift)
        adj_vv = vv_adjacency(v_active, G, K, self.vv_pattern, x_l.dtype)
        dense_adj = resolve_dense_adj(batch)
        if self.ll_gat or dense_adj is None:
            ll_kwargs = {"plan": batch.spmm, "dense_adj": dense_adj}
        else:
            # The ll GCN's adjacency, normalized once for every layer (no
            # self loops: no diagonal).
            ll_kwargs = {"dense_adj": GCNConv.normalize_dense(
                dense_adj, add_self_loops=False)[0]}
        senders = torch.arange(N, device=vid.device)
        for layer in range(len(self.ll)):
            x_l_new = self.ll[layer](x_l, batch.senders, batch.receivers,
                                     batch.edge_mask, num_nodes=N,
                                     **ll_kwargs)
            lv_out = self.lv[layer](x_l, senders, vid, batch.node_mask,
                                    x_dst=x_v, num_dst_nodes=G * K)
            vv_out = self.vv[layer](x_v.reshape(G, K, -1),
                                    adj_vv).reshape(G * K, -1)
            if self.vl is not None:
                x_l_new = x_l_new + self.vl[layer](x_v)[vid]
            x_l = torch.relu(x_l_new)
            x_v = torch.where(v_active[:, None],
                              torch.relu(lv_out + vv_out), 0.0)
        x_l = torch.where(batch.node_mask[:, None], x_l, 0.0).float()
        if self.readout != "none":
            x_l = graph_readout_mean(x_l, batch.node_graph, G)
        return self.head(self.act(self.pool_dense(x_l)))


def build_hscn(model_cfg, num_features: int, num_classes: int,
               compat_triangular: bool = True,
               compat_index_shift: bool = False, readout: str = "mean",
               dtype: torch.dtype | None = None,
               generator: torch.Generator | None = None) -> HSCN:
    """Mirror of the JAX ``build_hscn`` (the reference's hscn.py:128-140).
    The lv relation is a GAT whatever ``lv_conv_type`` says (the
    reference's "must be GAT" slot), as in the JAX model."""
    return HSCN(
        num_features=num_features,
        ll_conv=model_cfg.ll_conv_type,
        vv_conv=model_cfg.vv_conv_type,
        activation=model_cfg.activation,
        hidden_channels=model_cfg.hidden_channels,
        num_classes=num_classes,
        num_layers=model_cfg.num_layers,
        num_clusters=model_cfg.num_clusters,
        num_heads=model_cfg.num_heads,
        vv_pattern="triangular" if compat_triangular else "clique",
        index_shift=compat_index_shift,
        virtual_feedback=model_cfg.virtual_feedback,
        readout=readout,
        dtype=dtype,
        generator=generator,
    )
