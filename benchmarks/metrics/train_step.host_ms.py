"""train_step.host_ms (ms): the host's wall time in one train step of the
window's epochs (``open_epoch + 1`` to ``close_epoch``, each with the
evals after it), from the port's ``train_step`` spans
(``utils/profiling.py``): on the host loop, making the batch on the device
and issuing the step; on a captured route, a replay.  Either includes any
wait for the device: a launch blocks while the card's launch queue is
full, so the span alone does not tell the host's cost to issue from
back-pressure.  Nothing to read from a program without spans."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    w = ctx.window
    epochs = range(w.open_epoch + 1, w.close_epoch + 1)
    rows = [v for (n, e), v in getattr(profiling, "span_totals", dict)()
            .items() if n == "train_step" and e in epochs]
    calls = sum(r["calls"] for r in rows)
    return 1e-6 * sum(r["total_ns"] for r in rows) / calls if calls else None
