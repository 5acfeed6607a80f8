"""Route: the host loop of an MPNN config, as ``runner._run``
routes it with ``runtime.device_dataset: "off"``: ``train.loop.fit`` over
batches packed on the host each epoch (``DataModule.train_batches``, with
the CSR plan attached on the card, so that each ``GCNConv`` aggregates
through ``csr_spmm``)."""

from __future__ import annotations

import numpy as np

from graph_hscn_tpu_torch import runner

from hscnbench.routes_common import host_budget


def takes(cfg, dm) -> bool:
    """Whether the runner takes this route for ``cfg`` on ``dm``."""
    return (cfg.hscn is None and runner._mesh_route(cfg, dm)[0] is None
            and not runner._use_device_dataset(cfg, dm)
            and dm.slot_nodes is None)


def slot(dm) -> None:
    return None


def train_order(ctx, epoch: int) -> list:
    """The host packer's order worked out again: the train split shuffled
    by ``data.seed + epoch``, packed greedily up to batch_size graphs and
    the pad budget, each graph's nodes at the next rows."""
    n_budget, e_budget = host_budget(ctx)
    train = ctx.split["train"]
    nodes = np.diff(ctx.arrays["node_ptr"])
    edges = np.diff(ctx.arrays["edge_ptr"])
    idx = np.arange(len(train))
    np.random.default_rng(ctx.cfg.data.seed + epoch).shuffle(idx)
    out, cur, cn, ce = [], [], 0, 0
    for i in idx:
        g = int(train[i])
        if cur and (len(cur) >= ctx.cfg.data.batch_size
                    or cn + nodes[g] >= n_budget or ce + edges[g] > e_budget):
            out.append(cur)
            cur, cn, ce = [], 0, 0
        cur.append(g)
        cn += nodes[g]
        ce += edges[g]
    if cur:
        out.append(cur)
    return [(ids, np.arange(int(nodes[ids].sum())), n_budget)
            for ids in out]


def steps_per_epoch(ctx) -> int | None:
    return None     # counted by the batch iterator
