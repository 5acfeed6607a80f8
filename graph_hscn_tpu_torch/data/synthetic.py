"""Deterministic synthetic LRGB-like datasets.

The reference datasets (peptides_functional.py:63-75) are downloaded from
Dropbox and featurized with RDKit via ``ogb.utils.smiles2graph``; neither
network access nor RDKit is available here, so tests and benchmarks run on a
deterministic generator that reproduces the *statistical shape* of LRGB
peptides:

- node counts ~ lognormal around 150 (LRGB peptides mean ~150.9, max 444);
- chain ("backbone") topology plus ring closures, giving the sparse,
  long-diameter graphs whose long-range structure HSCN targets;
- 9 integer node features with OGB atom-feature cardinalities and 3 integer
  bond features (matching smiles2graph's output schema,
  peptides_functional.py:85-100);
- Peptides-func: 10 binary labels that are *learnable* functions of
  long-range graph statistics (so AP > random is meaningful in tests);
- Peptides-struct: 11 regression targets, z-scored per column like the
  reference (peptides_structural.py:83-86);
- PascalVOC-SP-like: ~480-node superpixel graphs with node-level 21-class
  labels (the reference's NotImplementedError branch, loader.py:108).

If real LRGB arrays are present (see data/lrgb.py), they take priority.
"""

from __future__ import annotations

import numpy as np

from graph_hscn_tpu_torch.data.batching import GraphData

# OGB atom-feature cardinalities (node feature columns of smiles2graph).
ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)

NUM_FUNC_CLASSES = 10
NUM_STRUCT_TARGETS = 11
NUM_VOC_CLASSES = 21


def _one_molecule(rng: np.random.Generator, mean_nodes: float = 150.0,
                  max_nodes: int = 444, min_nodes: int = 8) -> GraphData:
    n = int(np.clip(rng.lognormal(np.log(mean_nodes), 0.35), min_nodes,
                    max_nodes))
    # Backbone chain.
    src = np.arange(n - 1)
    dst = np.arange(1, n)
    # Ring closures: ~12% extra edges between nodes 3..8 apart.
    n_rings = max(1, int(0.12 * n))
    ring_a = rng.integers(0, max(1, n - 9), size=n_rings)
    ring_off = rng.integers(3, 9, size=n_rings)
    ring_b = np.minimum(ring_a + ring_off, n - 1)
    src = np.concatenate([src, ring_a])
    dst = np.concatenate([dst, ring_b])
    # Undirected: both directions (same as smiles2graph output).
    edge_index = np.stack([np.concatenate([src, dst]),
                           np.concatenate([dst, src])]).astype(np.int64)
    # Deduplicate.
    key = edge_index[0] * (max_nodes + 1) + edge_index[1]
    _, uniq = np.unique(key, return_index=True)
    edge_index = edge_index[:, np.sort(uniq)]
    e = edge_index.shape[1]

    x = np.stack(
        [rng.integers(0, min(d, 16), size=n) for d in ATOM_FEATURE_DIMS],
        axis=1).astype(np.int64)
    edge_attr = np.stack(
        [rng.integers(0, d, size=e) for d in BOND_FEATURE_DIMS],
        axis=1).astype(np.int64)
    return GraphData(x=x.astype(np.float32), edge_index=edge_index,
                     edge_attr=edge_attr.astype(np.float32))


def _func_labels(g: GraphData, rng: np.random.Generator) -> np.ndarray:
    """10 binary labels from long-range statistics (deterministic given g)."""
    n = g.num_nodes
    e = g.num_edges
    deg = np.bincount(g.edge_index[0], minlength=n)
    feats = np.array([
        n / 200.0,
        e / n,
        deg.max() / 6.0,
        g.x[:, 0].mean() / 8.0,
        g.x[:, 1].std(),
        g.x[:, 2].mean() / 6.0,
        (g.x[:, 0] > 8).mean(),
        g.x[: n // 2, 0].mean() - g.x[n // 2:, 0].mean(),
        g.edge_attr[:, 0].mean() / 2.0,
        float(n % 7) / 7.0,
    ])
    noise = rng.normal(0, 0.15, size=NUM_FUNC_CLASSES)
    return (feats + noise > np.median(feats)).astype(np.float32)


def _struct_targets(g: GraphData, rng: np.random.Generator) -> np.ndarray:
    n = g.num_nodes
    deg = np.bincount(g.edge_index[0], minlength=n)
    base = np.array([
        n, n ** 1.1, n ** 0.9,
        deg.sum(), deg.max() * n, deg.mean() * n,
        n + g.x[:, 0].sum() / 10, n - g.x[:, 1].sum() / 10, n * deg.mean(),
        g.x[:, 2].mean() * 5, g.x[:, 3].std() * 3,
    ], dtype=np.float64)
    return (base + rng.normal(0, 0.05 * np.abs(base) + 1e-3)).astype(
        np.float32)


def make_peptides_func(num_graphs: int = 512, seed: int = 0,
                       mean_nodes: float = 150.0) -> list[GraphData]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        g = _one_molecule(rng, mean_nodes=mean_nodes)
        out.append(g.replace(y=_func_labels(g, rng)))
    return out


def make_peptides_struct(num_graphs: int = 512, seed: int = 1,
                         mean_nodes: float = 150.0) -> list[GraphData]:
    rng = np.random.default_rng(seed)
    graphs, ys = [], []
    for _ in range(num_graphs):
        g = _one_molecule(rng, mean_nodes=mean_nodes)
        graphs.append(g)
        ys.append(_struct_targets(g, rng))
    y = np.stack(ys)
    # Per-column z-score, like peptides_structural.py:83-86.
    y = (y - y.mean(0)) / (y.std(0) + 1e-8)
    return [g.replace(y=y[i]) for i, g in enumerate(graphs)]


def make_voc_superpixels(num_graphs: int = 64, seed: int = 2,
                         mean_nodes: float = 480.0) -> list[GraphData]:
    """PascalVOC-SP-like node-classification graphs (8-NN superpixel style)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(np.clip(rng.normal(mean_nodes, 60), 100, 600))
        # Grid-ish: nodes on a sqrt(n) x sqrt(n) lattice with 4-neighborhood.
        side = int(np.ceil(np.sqrt(n)))
        coords = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                          -1).reshape(-1, 2)[:n]
        src, dst = [], []
        index = {tuple(c): i for i, c in enumerate(coords)}
        for i, (r, c) in enumerate(coords):
            for dr, dc in ((0, 1), (1, 0)):
                j = index.get((r + dr, c + dc))
                if j is not None:
                    src += [i, j]
                    dst += [j, i]
        edge_index = np.stack([np.array(src), np.array(dst)]).astype(np.int64)
        # Labels form spatially contiguous regions (a Voronoi partition of
        # the superpixel lattice), matching real VOC-SP semantics where a
        # node's class is the object its superpixel belongs to: neighboring
        # superpixels usually share a label, so message passing helps —
        # unlike i.i.d. per-node labels, which are adversarial for any
        # smoothing model.
        num_regions = max(4, int(rng.integers(6, 13)))
        anchors = rng.uniform(0, side, size=(num_regions, 2))
        anchor_cls = rng.integers(0, NUM_VOC_CLASSES, size=num_regions)
        d2 = ((coords[:, None, :] - anchors[None]) ** 2).sum(-1)
        labels = anchor_cls[d2.argmin(axis=1)]
        # Features: a fixed per-class signature (shared across graphs, like
        # RGB statistics of an object class) + per-node noise + coords.
        class_sig = np.random.default_rng(12345).normal(
            size=(NUM_VOC_CLASSES, 12)).astype(np.float32)
        x = rng.normal(size=(n, 14)).astype(np.float32)  # 12 RGB stats + 2 pos
        x[:, :12] = 0.8 * class_sig[labels] + 0.6 * x[:, :12]
        x[:, 12:] = coords / side
        node_y = np.zeros((n, NUM_VOC_CLASSES), dtype=np.float32)
        node_y[np.arange(n), labels] = 1.0
        out.append(GraphData(x=x, edge_index=edge_index, node_y=node_y))
    return out


def split_indices(num_graphs: int, seed: int = 42,
                  fractions=(0.7, 0.15, 0.15)) -> dict[str, np.ndarray]:
    """Deterministic random split (the reference uses pickled stratified
    splits, peptides_functional.py:108-115; we hash-split deterministically)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_graphs)
    n_train = int(fractions[0] * num_graphs)
    n_val = int(fractions[1] * num_graphs)
    return {
        "train": np.sort(idx[:n_train]),
        "val": np.sort(idx[n_train:n_train + n_val]),
        "test": np.sort(idx[n_train + n_val:]),
    }


def lattice_edges(side: int
                  ) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """One side x side 4-neighbour lattice, both directions of each edge
    (the giant graph of scripts/giant_graph_bench.py, without its
    locality reorder: nodes row-major), receiver-sorted, padded to a
    multiple of 128 edge slots as the batcher pads.

    Returns (N, senders, receivers, edge_mask); padding edges self-loop on
    node N-1 and are masked."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    pairs = ((idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :]))
    snd = np.concatenate([a.ravel() for p in pairs for a in (p[0], p[1])])
    rcv = np.concatenate([b.ravel() for p in pairs for b in (p[1], p[0])])
    order = np.argsort(rcv, kind="stable")
    pad = (-snd.size) % 128
    fill = np.full(pad, n - 1)
    mask = np.concatenate([np.ones(snd.size, bool), np.zeros(pad, bool)])
    return (n, np.concatenate([snd[order], fill]).astype(np.int32),
            np.concatenate([rcv[order], fill]).astype(np.int32), mask)
