"""setup.data_s (s): the set-up's time reading the dataset and making its
data module and eval batches (the port's ``setup.data`` spans) and
placing the dataset on the device (``setup.device_dataset``).  Nothing to
read without spans."""

from graph_hscn_tpu_torch.utils import profiling


def read(ctx):
    ns = [v["total_ns"] for (n, _), v in getattr(
        profiling, "span_totals", dict)().items()
        if n in ("setup.data", "setup.device_dataset")]
    return 1e-9 * sum(ns) if ns else None
