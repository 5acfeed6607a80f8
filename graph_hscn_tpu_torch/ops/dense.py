"""Dense-block view of a GraphBatch: the counterpart of
``graph_hscn_tpu/ops/dense.py``.

For molecular-scale graphs message passing runs as batched dense matmuls:
the flat node array is re-blocked into ``[G, slot, F]`` and the edge list
into per-graph ``[G, slot, slot]`` adjacencies, so every GCN layer is one
``torch.bmm``.  These functions build that view on the batch's device.

``mincut_pool`` (SCN's dense MinCUT pooling) comes with the HSCN slice.
"""

from __future__ import annotations

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


def dense_to_nodes(x_dense: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """[G, n_max, F] -> flat [N, F] aligned with batch.node_feat rows."""
    G, n_max, F = x_dense.shape
    idx = batch.node_graph * n_max + _local_index(batch)
    idx = idx.clamp(0, G * n_max - 1)
    out = x_dense.reshape(G * n_max, F)[idx]
    return torch.where(batch.node_mask[:, None], out, 0.0)
