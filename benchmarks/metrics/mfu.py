"""mfu (%): model FLOPs of the train graphs that the measured window
completed, over the window's wall time and the peak of the chips the cell
uses (float32 outside the tensor cores: every cell runs
``matmul_precision: highest``).  The FLOPs are the configuration's count
(``configs/<config>.py:train_flops``) from each train graph's real nodes
and edges; evals are in the window's time and not in its FLOPs."""

import numpy as np

from hscnbench.peaks import PEAK_FLOPS_F32


def read(ctx):
    w = ctx.window
    train = ctx.split["train"]
    n = np.diff(ctx.arrays["node_ptr"])[train]
    e = np.diff(ctx.arrays["edge_ptr"])[train]
    flops = w.epochs * ctx.cell.reference.train_flops(
        ctx.cell.config, ctx.dims, n, e)
    return 100.0 * flops / w.wall_s / (PEAK_FLOPS_F32 * ctx.cell.chips)
