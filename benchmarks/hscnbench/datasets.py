"""The traffic: frozen copies of the port's synthetic LRGB generators
(``graph_hscn_tpu_torch/data/synthetic.py``: ``make_peptides_func``,
``make_voc_superpixels``), and a writer of the ``data/lrgb.py`` ``.npz``
layout with LRGB's split ratios.

Frozen: later changes to the program's generator do not change what the
benchmark trains on.  The VOC lattice is built with array operations; it
gives the same edges in the same order as the original's loop (a test holds
the two equal).

A dataset is written once into ``CACHE_DIR/data/<key>/<dataset_name>.npz``,
the key naming the dataset, its size, its split and the generator's seed,
and read from there by every later run of the checkout through the port's
``data.data_dir``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from hscnbench import CACHE_DIR

# OGB atom- and bond-feature cardinalities (smiles2graph's schema).
ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)
NUM_FUNC_CLASSES = 10
NUM_VOC_CLASSES = 21


def _one_molecule(rng, mean_nodes=150.0, max_nodes=444, min_nodes=8):
    """(x [n, 9], edge_index [2, e], edge_attr [e, 3]) of one peptide."""
    n = int(np.clip(rng.lognormal(np.log(mean_nodes), 0.35), min_nodes,
                    max_nodes))
    src = np.arange(n - 1)
    dst = np.arange(1, n)
    n_rings = max(1, int(0.12 * n))
    ring_a = rng.integers(0, max(1, n - 9), size=n_rings)
    ring_off = rng.integers(3, 9, size=n_rings)
    ring_b = np.minimum(ring_a + ring_off, n - 1)
    src = np.concatenate([src, ring_a])
    dst = np.concatenate([dst, ring_b])
    edge_index = np.stack([np.concatenate([src, dst]),
                           np.concatenate([dst, src])]).astype(np.int64)
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
    return x.astype(np.float32), edge_index, edge_attr.astype(np.float32)


def _func_labels(x, edge_index, edge_attr, rng):
    n, e = x.shape[0], edge_index.shape[1]
    deg = np.bincount(edge_index[0], minlength=n)
    feats = np.array([
        n / 200.0, e / n, deg.max() / 6.0, x[:, 0].mean() / 8.0,
        x[:, 1].std(), x[:, 2].mean() / 6.0, (x[:, 0] > 8).mean(),
        x[: n // 2, 0].mean() - x[n // 2:, 0].mean(),
        edge_attr[:, 0].mean() / 2.0, float(n % 7) / 7.0,
    ])
    noise = rng.normal(0, 0.15, size=NUM_FUNC_CLASSES)
    return (feats + noise > np.median(feats)).astype(np.float32)


def make_peptides_func(num_graphs: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        x, ei, ea = _one_molecule(rng)
        out.append({"x": x, "edge_index": ei, "edge_attr": ea,
                    "y": _func_labels(x, ei, ea, rng)})
    return out


def voc_lattice(n: int, side: int) -> np.ndarray:
    """The original's edges: for each node i in order, its right (i+side)
    then its lower (i+1) neighbour, each as (i, j) then (j, i)."""
    i = np.arange(n)
    right = np.where(i + side < n, i + side, -1)
    down = np.where((i % side + 1 < side) & (i + 1 < n), i + 1, -1)
    nbr = np.stack([right, down], 1).reshape(-1)
    me = np.repeat(i, 2)
    ok = nbr >= 0
    a, b = me[ok], nbr[ok]
    src = np.stack([a, b], 1).reshape(-1)
    dst = np.stack([b, a], 1).reshape(-1)
    return np.stack([src, dst]).astype(np.int64)


def make_voc_superpixels(num_graphs: int, seed: int,
                         mean_nodes: float = 480.0) -> list[dict]:
    rng = np.random.default_rng(seed)
    class_sig = np.random.default_rng(12345).normal(
        size=(NUM_VOC_CLASSES, 12)).astype(np.float32)
    out = []
    for _ in range(num_graphs):
        n = int(np.clip(rng.normal(mean_nodes, 60), 100, 600))
        side = int(np.ceil(np.sqrt(n)))
        coords = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                          -1).reshape(-1, 2)[:n]
        edge_index = voc_lattice(n, side)
        num_regions = max(4, int(rng.integers(6, 13)))
        anchors = rng.uniform(0, side, size=(num_regions, 2))
        anchor_cls = rng.integers(0, NUM_VOC_CLASSES, size=num_regions)
        d2 = ((coords[:, None, :] - anchors[None]) ** 2).sum(-1)
        labels = anchor_cls[d2.argmin(axis=1)]
        x = rng.normal(size=(n, 14)).astype(np.float32)
        x[:, :12] = 0.8 * class_sig[labels] + 0.6 * x[:, :12]
        x[:, 12:] = coords / side
        out.append({"x": x, "edge_index": edge_index,
                    "node_label": labels.astype(np.int64)})
    return out


GENERATORS = {"peptides_func": make_peptides_func,
              "voc_superpixels": make_voc_superpixels}


def split_sizes(num_graphs: int, ratio: list[int]) -> tuple[int, int, int]:
    """Train, val and test sizes in LRGB's ``ratio`` (its published split
    counts), the remainder rounded into train."""
    total = sum(ratio)
    n_val = round(num_graphs * ratio[1] / total)
    n_test = round(num_graphs * ratio[2] / total)
    return num_graphs - n_val - n_test, n_val, n_test


def write_npz(path: Path, graphs: list[dict], sizes: tuple, seed: int
              ) -> None:
    """The ``data/lrgb.py`` layout: concatenated node and edge arrays with
    their pointers (edge endpoints global), graph targets ``y`` or node
    class ids ``node_y`` with ``num_node_classes``, and the split, drawn
    from ``seed``."""
    n = np.array([g["x"].shape[0] for g in graphs])
    e = np.array([g["edge_index"].shape[1] for g in graphs])
    node_ptr = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    edge_ptr = np.concatenate([[0], np.cumsum(e)]).astype(np.int64)
    arrays = {
        "node_feat": np.concatenate([g["x"] for g in graphs]),
        "edge_index": np.concatenate(
            [g["edge_index"] + node_ptr[i] for i, g in enumerate(graphs)],
            axis=1),
        "node_ptr": node_ptr, "edge_ptr": edge_ptr,
    }
    if "edge_attr" in graphs[0]:
        arrays["edge_feat"] = np.concatenate([g["edge_attr"]
                                              for g in graphs])
    if "y" in graphs[0]:
        arrays["y"] = np.stack([g["y"] for g in graphs])
    else:
        arrays["node_y"] = np.concatenate([g["node_label"] for g in graphs])
        arrays["num_node_classes"] = np.array(NUM_VOC_CLASSES)
    perm = np.random.default_rng(seed).permutation(len(graphs))
    n_tr, n_va, _ = sizes
    arrays["split_train"] = np.sort(perm[:n_tr])
    arrays["split_val"] = np.sort(perm[n_tr:n_tr + n_va])
    arrays["split_test"] = np.sort(perm[n_tr + n_va:])
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)   # atomic: a concurrent reader never sees half


def ensure_dataset(spec: dict) -> Path:
    """The directory holding ``<dataset_name>.npz`` for the workload's
    ``data`` spec (dataset_name, num_graphs, split_ratio, generator_seed),
    generated and written first if it is not there."""
    name, count = spec["dataset_name"], int(spec["num_graphs"])
    gseed = int(spec["generator_seed"])
    sizes = split_sizes(count, spec["split_ratio"])
    key = f"{name}-{count}-{'-'.join(map(str, sizes))}-seed{gseed}"
    d = CACHE_DIR / "data" / key
    path = d / f"{name}.npz"
    if not path.exists():
        d.mkdir(parents=True, exist_ok=True)
        graphs = GENERATORS[name](count, gseed)
        write_npz(path, graphs, sizes, gseed + 42)
    return d


def load_arrays(data_dir: Path, name: str) -> dict:
    """Every array of the dataset file, each read once."""
    with np.load(Path(data_dir) / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}
