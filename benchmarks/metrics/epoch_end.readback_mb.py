"""epoch_end.readback_mb (MB, 1e6 bytes): the bytes an epoch's passes
(the train pass and the evals after it) read back from the device for
the host metric (losses, scores, targets, masks), from the port's
``epoch_end.readback`` spans, per epoch of the window (``open_epoch + 1``
to ``close_epoch``).  Nothing to read without spans."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    w = ctx.window
    epochs = range(w.open_epoch + 1, w.close_epoch + 1)
    rows = [v for (n, e), v in getattr(profiling, "span_totals", dict)()
            .items() if n == "epoch_end.readback" and e in epochs]
    return (1e-6 * sum(r["bytes"] for r in rows) / len(epochs) if rows
            else None)
