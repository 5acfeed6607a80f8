"""CPU tests of the readers of the port's spans (``metrics/`` files that
read ``graph_hscn_tpu_torch.utils.profiling.span_totals``): a traced run
of each cell at a small size reads every one of its span metrics, and a
program without spans reads none of them, without raising.

    python -m pytest benchmarks/test_bench_spans.py -q
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hscnbench import harness, manifest  # noqa: E402

from graph_hscn_tpu_torch.utils import profiling  # noqa: E402

SMALL = {"peptides_func_hscn.device": 96, "voc_gcn.host_sparse": 48,
         "voc_gcn.device_dense": 48}
SPANS = {"train_step.host_ms", "data.csr_plan_ms_per_step",
         "epoch_end.metric_ms", "epoch_end.readback_mb", "setup.data_s",
         "setup.clustering_s", "host_loop.step_ms"}
# The span metrics each cell has to read: the host loop's step under its
# own name there (its rate is not an end-to-end metric).
EXPECTED = {"voc_gcn.host_sparse": {"host_loop.step_ms",
                                    "data.csr_plan_ms_per_step",
                                    "setup.data_s"}}
CAPTURED = {"train_step.host_ms", "epoch_end.metric_ms",
            "epoch_end.readback_mb", "setup.data_s"}


def traced_small(name: str, seed: int = 7) -> tuple[dict, manifest.Cell]:
    """A traced run of ``name`` on the CPU at a small size; the host
    loop's plans packed (the pallas backend: the kernel's plain twin
    aggregates on the CPU), as the card packs them."""
    cell = manifest.load_cell(name)
    cell.workload["observe_steps"] = min(4, harness.observe_steps(cell))
    if cell.workload["route"] == "host":
        cell.workload["overrides"]["runtime"]["spmm_backend"] = "pallas"
    profiling.reset_spans()
    result = harness.run_cell(name, seed, 0.5, True, time.perf_counter(),
                              device="cpu", cell=cell,
                              data_override={"num_graphs": SMALL[name]})
    return result, cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_each_span_metric_reads_in_its_cells(name):
    result, cell = traced_small(name)
    mine = {m["name"] for m in cell.per_layer} & SPANS
    assert mine >= EXPECTED.get(name, CAPTURED)
    values = {k: v["value"] for k, v in result["metrics"].items()}
    for metric in mine:
        assert metric in values, metric
        assert math.isfinite(values[metric]) and values[metric] > 0, metric
    # Set-up spans hold the whole of setup.data_s.
    totals = profiling.span_totals()
    assert values["setup.data_s"] == pytest.approx(1e-9 * sum(
        v["total_ns"] for (n, _), v in totals.items()
        if n in ("setup.data", "setup.device_dataset")))


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of the spans: the readers return None, not raise."""
    ctx = type("C", (), {})()
    ctx.window = type("W", (), {"open_epoch": 1, "close_epoch": 3})()
    monkeypatch.delattr(profiling, "span_totals")
    for metric in SPANS:
        assert manifest.metric_reader(metric).read(ctx) is None, metric
