"""What the routes' reference halves share: the orders and padded layouts
the program's batchers give, worked out again from the dataset file and
the seed."""

from __future__ import annotations

import numpy as np


def device_order(ctx, epoch: int, slot: int) -> list:
    """The device-resident fit's train rows: the train split's positions
    shuffled by ``np.random.default_rng(training.seed + epoch)``, cut into
    rows of batch_size (the last padded), graph i of a row in slot i."""
    train = ctx.split["train"]
    bs = ctx.cfg.data.batch_size
    idx = np.arange(len(train))
    np.random.default_rng(ctx.cfg.training.seed + epoch).shuffle(idx)
    return [slot_rows(ctx, [int(train[i]) for i in idx[r:r + bs]], bs, slot)
            for r in range(0, len(idx), bs)]


def slot_rows(ctx, ids: list, bs: int, slot: int) -> tuple:
    """(ids, each real node's row, the padded rows) of a slotted batch of
    ``bs`` slots holding the dataset graphs ``ids``, graph i in slot i."""
    nodes = np.diff(ctx.arrays["node_ptr"])
    rows = np.concatenate([i * slot + np.arange(nodes[g])
                           for i, g in enumerate(ids)])
    return ids, rows, bs * slot


def round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def host_budget(ctx) -> tuple[int, int]:
    """The host packer's pad budget over every graph of the dataset:
    batch_size graphs at the mean plus three standard deviations of a sum
    of batch_size sizes, times the pad safety, at least the largest graph
    (nodes + 1 spare row), rounded to 8 nodes and 128 edges."""
    bs, safety = ctx.cfg.data.batch_size, ctx.cfg.runtime.pad_safety

    def budget(sizes):
        s = sizes.mean() * bs + 3.0 * sizes.std() * np.sqrt(bs)
        return max(int(s * safety), int(sizes.max()))

    nodes = np.diff(ctx.arrays["node_ptr"])
    edges = np.diff(ctx.arrays["edge_ptr"])
    return round_up(budget(nodes) + 1, 8), round_up(budget(edges), 128)
