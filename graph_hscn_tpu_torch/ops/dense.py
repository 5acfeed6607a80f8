"""Dense-block view of a GraphBatch: the counterpart of
``graph_hscn_tpu/ops/dense.py``.

For molecular-scale graphs message passing runs as batched dense matmuls:
the flat node array is re-blocked into ``[G, slot, F]`` and the edge list
into per-graph ``[G, slot, slot]`` adjacencies, so every GCN layer is one
``torch.bmm``.  These functions build that view on the batch's device.
``mincut_pool`` is SCN's MinCUT pooling over such blocks.
"""

from __future__ import annotations

import math

import torch

from graph_hscn_tpu_torch.data.structures import GraphBatch


def build_dense_adj(batch: GraphBatch, weighted: bool = True) -> torch.Tensor:
    """Per-graph adjacency of a slotted batch, built on its device:
    [G-1, slot, slot] float32 with adj[g, dst_local, src_local].

    One ``index_add_`` over the edge list; masked (padding) edges land in a
    spare entry that is dropped.
    """
    slot = batch.slot
    if slot is None:
        raise ValueError("build_dense_adj requires slotted packing")
    G = batch.num_graphs_padded - 1
    g_e = batch.receivers // slot            # slot id == graph id (slotted)
    lr = batch.receivers - g_e * slot
    ls = batch.senders - g_e * slot
    w = (batch.edge_weight.float()
         if (weighted and batch.edge_weight is not None)
         else torch.ones(batch.senders.shape, dtype=torch.float32,
                         device=batch.senders.device))
    w = torch.where(batch.edge_mask, w, 0.0)
    flat = g_e * (slot * slot) + lr * slot + ls
    flat = torch.where(batch.edge_mask, flat, G * slot * slot)
    adj = torch.zeros(G * slot * slot + 1, dtype=torch.float32,
                      device=w.device)
    adj.index_add_(0, flat, w)
    return adj[:-1].reshape(G, slot, slot)


def resolve_dense_adj(batch: GraphBatch, weighted: bool = True):
    """``batch.dense_adj`` if the batch carries one, else the adjacency
    built from a slotted batch's edges, else None (the sparse path)."""
    if batch.dense_adj is not None:
        return batch.dense_adj
    if batch.slot is not None:
        return build_dense_adj(batch, weighted=weighted)
    return None


def _local_index(batch: GraphBatch) -> torch.Tensor:
    """Position of each node within its graph: global index minus the
    graph's offset in the flat (unslotted) layout."""
    n_node = batch.n_node
    offsets = torch.cat([torch.zeros(1, dtype=n_node.dtype,
                                     device=n_node.device),
                         torch.cumsum(n_node, 0)[:-1]])
    return (torch.arange(batch.num_nodes_padded, dtype=n_node.dtype,
                         device=n_node.device)
            - offsets[batch.node_graph])


def batch_to_dense(batch: GraphBatch, max_nodes: int):
    """GraphBatch -> (x [G, n_max, F], adj [G, n_max, n_max], mask
    [G, n_max]).

    G excludes the trailing dummy padding graph.  Nodes of graph g occupy
    the first n_node[g] rows of block g.  Weighted if batch.edge_weight is
    set.
    """
    G = batch.num_graphs_padded - 1
    F = batch.node_feat.shape[-1]
    local = _local_index(batch)
    flat_idx = batch.node_graph * max_nodes + local
    flat_idx = torch.where(batch.node_mask, flat_idx, G * max_nodes)
    feat = torch.where(batch.node_mask[:, None], batch.node_feat, 0.0)
    x = torch.zeros(G * max_nodes + 1, F, dtype=batch.node_feat.dtype,
                    device=feat.device)
    x[flat_idx] = feat
    x = x[:-1].reshape(G, max_nodes, F)
    # Scattering the mask itself: padding nodes all write False to the
    # spare slot, real nodes True to their own.
    mask = torch.zeros(G * max_nodes + 1, dtype=torch.bool,
                       device=feat.device)
    mask[flat_idx] = batch.node_mask
    mask = mask[:-1].reshape(G, max_nodes)

    eg = batch.node_graph[batch.receivers]
    ls = local[batch.senders]
    lr = local[batch.receivers]
    w = (batch.edge_weight.to(x.dtype) if batch.edge_weight is not None
         else torch.ones(ls.shape, dtype=x.dtype, device=x.device))
    w = torch.where(batch.edge_mask, w, 0.0)
    adj_idx = eg * (max_nodes * max_nodes) + lr * max_nodes + ls
    adj_idx = torch.where(batch.edge_mask, adj_idx,
                          G * max_nodes * max_nodes)
    adj = torch.zeros(G * max_nodes * max_nodes + 1, dtype=x.dtype,
                      device=x.device)
    adj.index_add_(0, adj_idx, w)
    adj = adj[:-1].reshape(G, max_nodes, max_nodes)
    return x, adj, mask


def scatter_dense(values: torch.Tensor, batch: GraphBatch,
                  max_nodes: int) -> torch.Tensor:
    """Flat [N, F] -> dense [G, n_max, F] by the batch layout, G without
    the dummy graph, padding rows 0 (the JAX ``models/scn.py:
    _scatter_dense``; differentiable in ``values``)."""
    G = batch.num_graphs_padded - 1
    flat_idx = batch.node_graph * max_nodes + _local_index(batch)
    flat_idx = torch.where(batch.node_mask, flat_idx, G * max_nodes)
    out = values.new_zeros(G * max_nodes + 1, values.shape[-1])
    out = out.index_put((flat_idx,),
                        torch.where(batch.node_mask[:, None], values, 0.0))
    return out[:-1].reshape(G, max_nodes, -1)


def dense_to_nodes(x_dense: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """[G, n_max, F] -> flat [N, F] aligned with batch.node_feat rows."""
    G, n_max, F = x_dense.shape
    idx = batch.node_graph * n_max + _local_index(batch)
    idx = idx.clamp(0, G * n_max - 1)
    out = x_dense.reshape(G * n_max, F)[idx]
    return torch.where(batch.node_mask[:, None], out, 0.0)


def mincut_pool(x, adj, s_logits, mask=None):
    """Relaxed MinCUT pooling losses (Bianchi et al. 2020), PyG's
    ``dense_mincut_pool`` batched: the JAX ``mincut_pool``
    (ops/dense.py:119-166).

    x [G, n, F], adj [G, n, n], s_logits [G, n, K], mask [G, n] bool or
    None.  Returns (x_pool [G, K, F], adj_pool [G, K, K], mincut_loss,
    ortho_loss), the losses means over the G blocks.  A block without
    edges has a zero denominator, clamped to 1e-12: its cut term is 0.
    """
    s = torch.softmax(s_logits, dim=-1)
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        x = x * m
        s = s * m
    x_pool = torch.einsum("gnk,gnf->gkf", s, x)
    adj_pool = torch.einsum("gnk,gnl->gkl", s, torch.bmm(adj, s))
    # MinCut numerator tr(S^T A S); denominator tr(S^T D S), D the
    # out-degree (row sums).
    num = torch.diagonal(adj_pool, dim1=-2, dim2=-1).sum(-1)
    deg = adj.sum(-1)
    den = torch.einsum("gnk,gnk->g", s * deg[..., None], s)
    mincut_loss = (-(num / den.clamp_min(1e-12))).mean()
    # Orthogonality: || SS^T / ||SS^T||_F - I / sqrt(K) ||_F.
    ss = torch.einsum("gnk,gnl->gkl", s, s)
    k = s.shape[-1]
    ss_norm = torch.linalg.norm(ss, dim=(-2, -1), keepdim=True)
    ident = torch.eye(k, dtype=x.dtype, device=x.device) / math.sqrt(k)
    ortho_loss = torch.linalg.norm(ss / ss_norm.clamp_min(1e-12) - ident,
                                   dim=(-2, -1)).mean()
    # Zero the pooled diagonal and renormalize, as PyG does.
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    adj_pool = torch.where(eye, 0.0, adj_pool)
    d = torch.sqrt(adj_pool.sum(-1) + 1e-15)
    adj_pool = adj_pool / d[..., None] / d[..., None, :]
    return x_pool, adj_pool, mincut_loss, ortho_loss
