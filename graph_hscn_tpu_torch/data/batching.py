"""Host-side graph packing: ragged graphs -> statically shaped GraphBatch.

The counterpart of ``graph_hscn_tpu/data/batching.py``, in numpy, giving
byte-identical arrays for the same graphs and budget.  Key design points:

- **Bucketed static shapes.** Batches are padded to (N_pad, E_pad, G_pad)
  budgets rounded up to fixed multiples, so every batch of a bucket has the
  same shapes: ``G_pad = batch_size + 1`` (one dummy graph),
  ``N_pad = round_up(batch_size * p95_nodes)``.
- **CSR ordering.** Edges are sorted by receiver within the flattened batch,
  so sparse aggregation is a contiguous segment reduction and the SpMM
  kernel consumes row pointers directly (the attached ``CsrPlan``).
- **Padding convention** (jraph-style): the final graph is a dummy that owns
  all padding nodes/edges; padding edges are self-loops on the final padding
  node, so they never touch real rows even if a kernel ignores masks.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from graph_hscn_tpu_torch.data.structures import GraphBatch


@dataclasses.dataclass(frozen=True)
class GraphData:
    """One ragged graph on the host (numpy). The analog of a PyG ``Data``."""

    x: np.ndarray                     # [n, F]
    edge_index: np.ndarray            # [2, e] int64/int32
    y: np.ndarray | None = None       # [C] or [1, C] graph targets
    edge_attr: np.ndarray | None = None   # [e, Fe]
    edge_weight: np.ndarray | None = None  # [e]
    node_y: np.ndarray | None = None  # [n, C] node targets
    node_pe: np.ndarray | None = None  # [n, K]
    eigvals: np.ndarray | None = None  # [n, K]
    eigvecs: np.ndarray | None = None  # [n, K]
    cluster: np.ndarray | None = None  # [n]

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def replace(self, **kw) -> "GraphData":
        return dataclasses.replace(self, **kw)


def round_up(x: int, multiple: int) -> int:
    return ((int(x) + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class PadBudget:
    """Static shape budget for one bucket of batches."""

    num_nodes: int
    num_edges: int
    num_graphs: int   # includes the +1 dummy graph

    @staticmethod
    def for_dataset(
        graphs: Sequence[GraphData],
        batch_size: int,
        node_multiple: int = 8,
        edge_multiple: int = 128,
        safety: float = 1.15,
    ) -> "PadBudget":
        """Budget covering `batch_size` graphs at dataset-mean sizes * safety.

        The batcher packs greedily up to the budget, so a generous budget
        means fewer, fuller batches; overflow graphs simply start the next
        batch.
        """
        n_nodes = np.array([g.num_nodes for g in graphs])
        n_edges = np.array([g.num_edges for g in graphs])
        max_n = int(n_nodes.max()) if len(n_nodes) else 1
        max_e = int(n_edges.max()) if len(n_edges) else 1

        def stat_budget(arr, mx):
            # Covers ~99.9% of random B-graph sums: B*mean + 3*std*sqrt(B).
            s = arr.mean() * batch_size + 3.0 * arr.std() * np.sqrt(batch_size)
            return max(int(s * safety), mx)

        budget_n = stat_budget(n_nodes, max_n) + 1
        budget_e = stat_budget(n_edges, max_e)
        return PadBudget(
            num_nodes=round_up(budget_n, node_multiple),
            num_edges=round_up(budget_e, edge_multiple),
            num_graphs=batch_size + 1,
        )


def bucketed_budgets(
    graphs: Sequence[GraphData],
    batch_size: int,
    num_buckets: int = 3,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    safety: float = 1.15,
    samples: int = 512,
) -> tuple[PadBudget, ...]:
    """K ascending budgets at quantiles of the batch-total distribution.

    Each emitted batch is padded to the SMALLEST bucket that fits it.  The
    last bucket is ``PadBudget.for_dataset``'s (covers everything the
    greedy packer emits).
    """
    base = PadBudget.for_dataset(graphs, batch_size, node_multiple,
                                 edge_multiple, safety)
    if num_buckets <= 1 or len(graphs) <= batch_size:
        return (base,)
    n = np.array([g.num_nodes for g in graphs])
    e = np.array([g.num_edges for g in graphs])
    rng = np.random.default_rng(0)
    sel = rng.integers(0, len(graphs), size=(samples, batch_size))
    sums_n = n[sel].sum(axis=1)
    sums_e = e[sel].sum(axis=1)
    buckets: list[PadBudget] = []
    for q in np.linspace(0.0, 1.0, num_buckets + 1)[1:-1]:
        bn = round_up(int(np.quantile(sums_n, q)) + 2, node_multiple)
        be = round_up(int(np.quantile(sums_e, q) * 1.02), edge_multiple)
        b = PadBudget(num_nodes=min(bn, base.num_nodes),
                      num_edges=min(be, base.num_edges),
                      num_graphs=base.num_graphs)
        if not buckets or (b.num_nodes, b.num_edges) > (
                buckets[-1].num_nodes, buckets[-1].num_edges):
            buckets.append(b)
    buckets.append(base)
    return tuple(buckets)


def pick_bucket(buckets: Sequence[PadBudget], num_nodes: int,
                num_edges: int, num_graphs: int) -> PadBudget:
    """Smallest bucket that fits (node budget is strict: one row reserved
    for padding, same rule as pack_batch)."""
    for b in buckets:
        if (num_nodes < b.num_nodes and num_edges <= b.num_edges
                and num_graphs < b.num_graphs):
            return b
    raise ValueError(f"no bucket fits n={num_nodes} e={num_edges} "
                     f"g={num_graphs}")


def pack_batch(
    graphs: Sequence[GraphData],
    budget: PadBudget,
    sort_edges_by_receiver: bool = True,
    with_spmm_plan: bool = False,
    slot_nodes: int | None = None,
) -> GraphBatch:
    """Flatten + pad a list of graphs into one GraphBatch (numpy arrays).

    Requires sum(n) < budget.num_nodes (strict: one node is reserved for
    padding) and sum(e) <= budget.num_edges and len(graphs) < num_graphs.

    ``with_spmm_plan`` attaches the SpMM kernel's ``CsrPlan`` (needs the
    receiver sort).  ``slot_nodes``: slotted dense mode — graph i occupies
    node rows [i*slot, i*slot + n_i); overrides budget.num_nodes with
    (num_graphs-1)*slot.
    """
    G = len(graphs)
    if G >= budget.num_graphs:
        raise ValueError(f"{G} graphs exceeds budget {budget.num_graphs - 1}")
    tot_n = sum(g.num_nodes for g in graphs)
    tot_e = sum(g.num_edges for g in graphs)
    if slot_nodes is not None:
        too_big = max(g.num_nodes for g in graphs)
        if too_big > slot_nodes:
            raise ValueError(f"graph with {too_big} nodes exceeds slot "
                             f"{slot_nodes}")
    elif tot_n >= budget.num_nodes:
        raise ValueError(f"{tot_n} nodes exceeds budget {budget.num_nodes - 1}")
    if tot_e > budget.num_edges:
        raise ValueError(f"{tot_e} edges exceeds budget {budget.num_edges}")
    if with_spmm_plan and not sort_edges_by_receiver:
        raise ValueError("the SpMM plan needs receiver-sorted edges")

    N, E, GP = budget.num_nodes, budget.num_edges, budget.num_graphs
    if slot_nodes is not None:
        N = (GP - 1) * slot_nodes
    F = graphs[0].x.shape[1]

    node_feat = np.zeros((N, F), dtype=np.float32)
    senders = np.full((E,), N - 1, dtype=np.int32)
    receivers = np.full((E,), N - 1, dtype=np.int32)
    node_graph = np.full((N,), GP - 1, dtype=np.int32)
    n_node = np.zeros((GP,), dtype=np.int32)
    n_edge = np.zeros((GP,), dtype=np.int32)
    node_mask = np.zeros((N,), dtype=bool)
    edge_mask = np.zeros((E,), dtype=bool)
    graph_mask = np.zeros((GP,), dtype=bool)

    has_edge_attr = graphs[0].edge_attr is not None
    has_edge_weight = graphs[0].edge_weight is not None
    edge_feat = None
    edge_weight = None
    if has_edge_attr:
        Fe = graphs[0].edge_attr.shape[1]
        edge_feat = np.zeros((E, Fe), dtype=np.float32)
    if has_edge_weight:
        edge_weight = np.zeros((E,), dtype=np.float32)

    y = None
    if graphs[0].y is not None:
        C = int(np.asarray(graphs[0].y).reshape(-1).shape[0])
        y = np.zeros((GP, C), dtype=np.float32)
    node_y = None
    if graphs[0].node_y is not None:
        Cn = graphs[0].node_y.shape[1]
        node_y = np.zeros((N, Cn), dtype=np.float32)

    def _opt_node_field(name):
        if getattr(graphs[0], name) is None:
            return None
        K = getattr(graphs[0], name).shape[1]
        return np.zeros((N, K), dtype=np.float32)

    node_pe = _opt_node_field("node_pe")
    eigvals = _opt_node_field("eigvals")
    eigvecs = _opt_node_field("eigvecs")
    cluster = (np.zeros((N,), dtype=np.int32)
               if graphs[0].cluster is not None else None)

    n_off = 0
    e_off = 0
    for gi, g in enumerate(graphs):
        if slot_nodes is not None:
            n_off = gi * slot_nodes
        n, e = g.num_nodes, g.num_edges
        node_feat[n_off:n_off + n] = g.x.astype(np.float32)
        senders[e_off:e_off + e] = g.edge_index[0] + n_off
        receivers[e_off:e_off + e] = g.edge_index[1] + n_off
        node_graph[n_off:n_off + n] = gi
        n_node[gi] = n
        n_edge[gi] = e
        node_mask[n_off:n_off + n] = True
        edge_mask[e_off:e_off + e] = True
        graph_mask[gi] = True
        if has_edge_attr:
            edge_feat[e_off:e_off + e] = g.edge_attr.astype(np.float32)
        if has_edge_weight:
            edge_weight[e_off:e_off + e] = g.edge_weight.astype(np.float32)
        if y is not None:
            y[gi] = np.asarray(g.y, dtype=np.float32).reshape(-1)
        if node_y is not None:
            node_y[n_off:n_off + n] = g.node_y.astype(np.float32)
        for arr, name in ((node_pe, "node_pe"), (eigvals, "eigvals"),
                          (eigvecs, "eigvecs")):
            if arr is not None:
                arr[n_off:n_off + n] = getattr(g, name).astype(np.float32)
        if cluster is not None:
            cluster[n_off:n_off + n] = g.cluster.astype(np.int32)
        n_off += n
        e_off += e

    if sort_edges_by_receiver:
        # Stable sort keeps same-receiver edges in insertion (sender) order.
        order = np.argsort(receivers, kind="stable")
        senders = senders[order]
        receivers = receivers[order]
        edge_mask = edge_mask[order]
        if edge_feat is not None:
            edge_feat = edge_feat[order]
        if edge_weight is not None:
            edge_weight = edge_weight[order]

    spmm = None
    if with_spmm_plan:
        from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import csr_plan
        spmm = csr_plan(senders, receivers, edge_mask, N)

    return GraphBatch(
        node_feat=node_feat, senders=senders, receivers=receivers,
        node_graph=node_graph, n_node=n_node, n_edge=n_edge,
        node_mask=node_mask, edge_mask=edge_mask, graph_mask=graph_mask,
        edge_feat=edge_feat, edge_weight=edge_weight, y=y, node_y=node_y,
        node_pe=node_pe, eigvals=eigvals, eigvecs=eigvecs, cluster=cluster,
        spmm=spmm, slot=slot_nodes,
    )


def iter_batches(
    graphs: Sequence[GraphData],
    batch_size: int,
    budget: PadBudget | Sequence[PadBudget],
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    drop_last: bool = False,
    with_spmm_plan: bool = False,
    slot_nodes: int | None = None,
) -> Iterable[GraphBatch]:
    """Greedy sequential packing into fixed-budget batches.

    Mirrors the reference DataLoader's fixed ``batch_size`` chunking
    (loader.py:48-60) but additionally respects node/edge budgets: if the
    next graph would overflow, the batch is emitted early.

    ``budget`` may be a sequence of ascending buckets (bucketed_budgets):
    groups are formed against the LARGEST bucket, then each group is
    packed to the smallest bucket that fits it.  A CSR plan is feasible for
    every batch, so no plan geometry needs pinning across batches.
    """
    buckets = (tuple(budget) if isinstance(budget, (tuple, list))
               else (budget,))
    largest = buckets[-1]

    def emit(group: list[GraphData], n: int, e: int) -> GraphBatch:
        b = (largest if len(buckets) == 1
             else pick_bucket(buckets, n, e, len(group)))
        return pack_batch(group, b, with_spmm_plan=with_spmm_plan,
                          slot_nodes=slot_nodes)

    idx = np.arange(len(graphs))
    if shuffle:
        rng = rng or np.random.default_rng(0)
        rng.shuffle(idx)
    cur: list[GraphData] = []
    cur_n = cur_e = 0
    for i in idx:
        g = graphs[int(i)]
        overflow = (
            len(cur) >= batch_size
            or (slot_nodes is None
                and cur_n + g.num_nodes >= largest.num_nodes)
            or cur_e + g.num_edges > largest.num_edges
        )
        if cur and overflow:
            yield emit(cur, cur_n, cur_e)
            cur, cur_n, cur_e = [], 0, 0
        cur.append(g)
        cur_n += g.num_nodes
        cur_e += g.num_edges
    if cur and not drop_last:
        yield emit(cur, cur_n, cur_e)


def csr_row_pointers(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Row pointers for receiver-sorted edges: rowptr[i]..rowptr[i+1] are the
    edge slots whose receiver is node i. Length num_nodes+1."""
    counts = np.bincount(receivers, minlength=num_nodes)
    rowptr = np.zeros((num_nodes + 1,), dtype=np.int32)
    np.cumsum(counts, out=rowptr[1:])
    return rowptr
