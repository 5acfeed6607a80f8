"""Route: the device-resident dataset of an MPNN config, as
``runner._run`` routes it by ``runtime.device_dataset: auto``:
``train.loop.fit_device``, the epoch captured on the card, a replayed
step a batch."""

from __future__ import annotations

from graph_hscn_tpu_torch import runner

from hscnbench.routes_common import device_order, round_up


def takes(cfg, dm) -> bool:
    """Whether the runner takes this route for ``cfg`` on ``dm``."""
    return (cfg.hscn is None and runner._mesh_route(cfg, dm)[0] is None
            and runner._use_device_dataset(cfg, dm))


def slot(dm) -> int:
    """The device dataset's slot, as ``DeviceDataset.build`` sizes it."""
    graphs = dm.split("train") + dm.split("val") + dm.split("test")
    return dm.slot_nodes or round_up(max(g.num_nodes for g in graphs), 8)


def train_order(ctx, epoch: int) -> list:
    return device_order(ctx, epoch, ctx.slot)


def steps_per_epoch(ctx) -> int:
    return -(-len(ctx.split["train"]) // ctx.cfg.data.batch_size)
