"""Core batch IR: padded, statically shaped graph batches.

The counterpart of ``graph_hscn_tpu/data/structures.py``.  A batch of graphs
is flattened once on the host into one record of fixed-shape numpy arrays:

- edges are sorted by receiver, so sparse aggregation is a segment reduction
  over contiguous runs (CSR), which the hand-written SpMM kernel consumes
  through the row pointers of the attached :class:`CsrPlan`;
- the final graph slot / node slot / edge slots are reserved for padding, so
  segment reductions over ``node_graph`` deposit padding into a dummy row
  that is masked out, rather than corrupting real graphs.

``GraphBatch.to(device)`` turns the record into torch tensors on a device:
index arrays become int64 (what ``index_select``/``index_add_`` take) and
the plan's arrays stay int32 (what the kernels take).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

Array = Any  # np.ndarray on the host, torch.Tensor after .to(device)

# Fields holding indices: int64 tensors on the device.
_INDEX_FIELDS = ("senders", "receivers", "node_graph", "n_node", "n_edge",
                 "cluster")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded batch of graphs in flattened (CSR-sorted) form.

    Shapes (all static within a bucket):
      N = padded node count, E = padded edge count, G = padded graph count.
      The LAST graph is the padding graph; padding nodes/edges belong to it.

    Attributes:
      node_feat:  [N, F]  node features (float).
      senders:    [E]     source node index per edge.
      receivers:  [E]     destination node index per edge; edges are sorted
                          ascending by receiver (padding edges last,
                          pointing at the final padding node).
      node_graph: [N]     graph id per node (padding nodes -> G-1).
      n_node:     [G]     real node count per graph.
      n_edge:     [G]     real edge count per graph.
      node_mask:  [N]     bool, True for real nodes.
      edge_mask:  [E]     bool, True for real edges.
      graph_mask: [G]     bool, True for real graphs.
      edge_feat:  [E, Fe] edge features, or None.
      edge_weight:[E]     optional float weight per edge, or None.
      y:          [G, C]  graph-level targets, or None.
      node_y:     [N, C]  node-level targets, or None.
      node_pe, eigvals, eigvecs: [N, K] optional positional encodings.
      cluster:    [N]     optional cluster assignment (HSCN), or None.
      spmm:       optional :class:`~graph_hscn_tpu_torch.ops.cuda.spmm_kernel.CsrPlan`
                  for the hand SpMM kernel, attached by the batcher.
      dense_adj:  [G-1, slot, slot] per-graph adjacency counts of a
                  slotted batch (adj[g, dst_local, src_local]), or None:
                  the device-resident dataset gathers it from its cache;
                  otherwise it is built on the device from the edges
                  (``ops/dense.py``).
      slot:       slot width of the slotted dense layout, or None.
    """

    node_feat: Array
    senders: Array
    receivers: Array
    node_graph: Array
    n_node: Array
    n_edge: Array
    node_mask: Array
    edge_mask: Array
    graph_mask: Array
    edge_feat: Array | None = None
    edge_weight: Array | None = None
    y: Array | None = None
    node_y: Array | None = None
    node_pe: Array | None = None
    eigvals: Array | None = None
    eigvecs: Array | None = None
    cluster: Array | None = None
    spmm: Any | None = None
    dense_adj: Array | None = None
    slot: int | None = None

    @property
    def slot_size(self) -> int | None:
        if self.slot is not None:
            return self.slot
        return None if self.dense_adj is None else self.dense_adj.shape[-1]

    @property
    def num_nodes_padded(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs_padded(self) -> int:
        return self.n_node.shape[0]

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device: torch.device | str) -> "GraphBatch":
        """The batch as torch tensors on ``device`` (indices int64, the
        plan's arrays int32)."""
        moved = {}
        for f in dataclasses.fields(self):
            a = getattr(self, f.name)
            if f.name in ("spmm", "slot") or a is None:
                continue
            if isinstance(a, np.ndarray):
                if f.name in _INDEX_FIELDS:
                    a = a.astype(np.int64)
                a = torch.from_numpy(a)
            moved[f.name] = a.to(device)
        if self.spmm is not None:
            moved["spmm"] = self.spmm.to(device)
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass(frozen=True)
class DenseGraphBatch:
    """Per-graph dense view: everything is a batched fixed-size block
    (numpy on the host).  Built from a ``GraphBatch`` by
    :func:`graph_hscn_tpu_torch.data.batching.to_dense`.

    Attributes:
      x:         [G, n_max, F]   node features, zero-padded.
      adj:       [G, n_max, n_max] dense adjacency (weighted if edge_weight).
      node_mask: [G, n_max]      bool.
      n_node:    [G]             int32.
      graph_mask:[G]             bool.
      y:         [G, C], or None.
    """

    x: Array
    adj: Array
    node_mask: Array
    n_node: Array
    graph_mask: Array
    y: Array | None = None

    @property
    def max_nodes(self) -> int:
        return self.x.shape[1]

    def replace(self, **kw) -> "DenseGraphBatch":
        return dataclasses.replace(self, **kw)
