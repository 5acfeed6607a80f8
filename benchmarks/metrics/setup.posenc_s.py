"""setup.posenc_s (s): the set-up's time giving every graph its Laplacian
eigen stats, computed or read from the file kept beside the dataset (the
port's ``setup.posenc`` span, inside ``setup.data``).  Nothing to read
without the span."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    ns = [v["total_ns"] for (n, _), v in getattr(
        profiling, "span_totals", dict)().items() if n == "setup.posenc"]
    return 1e-9 * sum(ns) if ns else None
