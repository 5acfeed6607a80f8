"""Route: the HSCN pipeline on the device-resident dataset, as
``runner._run`` routes a peptides HSCN config:
``hscn_pipeline.run_hscn_pipeline`` (device) -> SCN clustering captured
on the card (``train_clustering_device``) -> the HSCN fit
``train.loop.fit_on_device_dataset``, a replayed step a batch."""

from __future__ import annotations

import numpy as np

from graph_hscn_tpu_torch import runner

from hscnbench.routes_common import device_order, slot_rows


def takes(cfg, dm) -> bool:
    """Whether the runner takes this route for ``cfg`` on ``dm``."""
    return (cfg.hscn is not None and not cfg.mesh.edge_partition
            and runner._use_device_dataset(cfg, dm)
            and dm.slot_nodes is not None)


def slot(dm) -> int:
    return dm.slot_nodes


def train_order(ctx, epoch: int) -> list:
    return device_order(ctx, epoch, ctx.slot)


def stage_order(ctx, target: str, epoch: int) -> list:
    """The SCN's clustering steps (``target`` "scn"): every graph of the
    dataset, train, val and test in that order, shuffled by
    ``np.random.default_rng(training.seed + epoch)``, cut into rows of
    batch_size (the last padded), graph i of a row in slot i."""
    if target != "scn":
        raise KeyError(target)
    ids = np.concatenate([ctx.split[k] for k in ("train", "val", "test")])
    idx = np.arange(len(ids))
    np.random.default_rng(ctx.cfg.training.seed + epoch).shuffle(idx)
    bs = ctx.cfg.data.batch_size
    return [slot_rows(ctx, [int(ids[i]) for i in idx[r:r + bs]], bs,
                      ctx.slot) for r in range(0, len(idx), bs)]


def steps_per_epoch(ctx) -> int:
    return -(-len(ctx.split["train"]) // ctx.cfg.data.batch_size)
