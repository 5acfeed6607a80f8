"""setup.clustering_s (s): the set-up's time in the HSCN pipeline's SCN
clustering and the write-back of its assignments (the port's
``setup.clustering`` span).  Nothing to read without spans or
clustering."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    ns = [v["total_ns"] for (n, _), v in getattr(
        profiling, "span_totals", dict)().items()
        if n == "setup.clustering"]
    return 1e-9 * sum(ns) if ns else None
