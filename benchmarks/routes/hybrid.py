"""Route: the 2-D hybrid mesh, as ``runner._run`` routes a config
with ``mesh.axes: [data, model]`` and ``mesh.edge_partition: true``:
``parallel.hybrid.fit_hybrid`` -> ``sharded_gcn.fit_blocks``, one
full-batch step an epoch over every rank of the process group; each data
row holds a balanced half of the train graphs, edge-partitioned over its
ranks (halo exchange in the row, the loss and gradients all-reduced over
every rank; ``csr_spmm`` on each rank's local edges)."""

from __future__ import annotations

import numpy as np

from graph_hscn_tpu_torch import runner

# The sharded model's parameters: layers.<i> for the MPNN's convs.<i>.
PARAM_NAMES = (("convs.", "layers."),)
# fit_hybrid passes its sharded model no dropout, whatever mp.dropout
# says (copied from the JAX package, ROADMAP.md C): the reference drops
# nothing either.
DROPOUT = False
# A rank's forward gives its own block's rows, in the plan's node order:
# its logits and inputs are not the reference's rows.
OBSERVES_ROWS = False


def takes(cfg, dm) -> bool:
    """Whether the runner takes this route for ``cfg`` on ``dm``."""
    return runner._mesh_route(cfg, dm)[0] == "hybrid"


def slot(dm) -> None:
    return None


def train_order(ctx, epoch: int) -> list:
    """The global batch: every train graph, one step an epoch."""
    ids = [int(g) for g in ctx.split["train"]]
    n = int(np.diff(ctx.arrays["node_ptr"])[ids].sum())
    return [(ids, np.arange(n), n)]


def steps_per_epoch(ctx) -> int:
    return 1
