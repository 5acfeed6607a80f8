"""Real LRGB dataset loading from cached arrays.

The reference downloads CSVs from Dropbox and featurizes SMILES with RDKit
(peptides_functional.py:63-106).  This environment has no network and no
RDKit, so the real-data path loads a pre-featurized ``.npz`` cache:

    <data_dir>/<dataset_name>.npz with keys:
      node_feat   [sum_n, F]   edge_index [2, sum_e]
      node_ptr    [G+1]        edge_ptr   [G+1]
      y           [G, C] (graph tasks) or node_y [sum_n, C]
      split_train / split_val / split_test  (int index arrays)

``scripts/convert_lrgb.py`` produces this cache from the original CSVs on a
machine that has RDKit+OGB installed.  If no cache exists, callers fall back
to the synthetic generator (data/pipeline.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from graph_hscn_tpu_torch.data.batching import GraphData


def try_load(data_dir: str, dataset_name: str):
    path = Path(data_dir) / f"{dataset_name}.npz"
    if not path.exists():
        return None, None
    z = np.load(path)
    node_ptr = z["node_ptr"]
    edge_ptr = z["edge_ptr"]
    num_graphs = len(node_ptr) - 1
    graph_level = "y" in z
    node_y = None
    if "node_y" in z:
        node_y = z["node_y"]
        if node_y.ndim == 1:
            # Node-level class labels (VOC superpixels) -> one-hot, the
            # layout the node-level loss/metrics consume.
            k = (int(z["num_node_classes"]) if "num_node_classes" in z
                 else int(node_y.max()) + 1)
            node_y = np.eye(k, dtype=np.float32)[node_y.astype(np.int64)]
        else:
            node_y = node_y.astype(np.float32)
    graphs = []
    for i in range(num_graphs):
        n0, n1 = int(node_ptr[i]), int(node_ptr[i + 1])
        e0, e1 = int(edge_ptr[i]), int(edge_ptr[i + 1])
        ei = z["edge_index"][:, e0:e1] - n0
        g = GraphData(
            x=z["node_feat"][n0:n1].astype(np.float32),
            edge_index=ei.astype(np.int64),
            edge_attr=(z["edge_feat"][e0:e1].astype(np.float32)
                       if "edge_feat" in z else None),
            y=z["y"][i] if graph_level else None,
            node_y=node_y[n0:n1] if node_y is not None else None,
        )
        graphs.append(g)
    split_idx = {k: z[f"split_{k}"] for k in ("train", "val", "test")}
    return graphs, split_idx
