"""epoch_end.metric_ms (ms): the host's time computing the metric and the
mean loss of an epoch's passes (the train pass and the evals after it),
from the port's ``epoch_end.metric`` spans, per epoch of the window
(``open_epoch + 1`` to ``close_epoch``).  Nothing to read without
spans."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    w = ctx.window
    epochs = range(w.open_epoch + 1, w.close_epoch + 1)
    ns = [v["total_ns"] for (n, e), v in getattr(
        profiling, "span_totals", dict)().items()
        if n == "epoch_end.metric" and e in epochs]
    return 1e-6 * sum(ns) / len(epochs) if ns else None
