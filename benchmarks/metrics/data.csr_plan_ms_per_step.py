"""data.csr_plan_ms_per_step (ms): the host's time in ``csr_plan`` (the
port's ``data.csr_plan`` spans, inside the packer) over the train steps
of the window's epochs (``open_epoch + 1`` to ``close_epoch``).  The eval
batches are packed once, in set-up, so every plan of these epochs is a
train batch's.  Nothing to read without spans or without plans."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    w = ctx.window
    epochs = range(w.open_epoch + 1, w.close_epoch + 1)
    totals = getattr(profiling, "span_totals", dict)()
    plan = sum(v["total_ns"] for (n, e), v in totals.items()
               if n == "data.csr_plan" and e in epochs)
    steps = sum(v["calls"] for (n, e), v in totals.items()
                if n == "train_step" and e in epochs)
    return 1e-6 * plan / steps if plan and steps else None
