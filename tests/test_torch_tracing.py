"""The port's spans (utils/profiling.py:span) on the CPU at small sizes:

- on the host loop, the device route and the device HSCN pipeline, the
  ``train_step`` and ``eval_step`` calls equal the fit's steps, an epoch
  pass has one ``epoch_end.readback`` and one ``epoch_end.metric``, and
  the readback's bytes are those of the tensors the pass reads back (on
  the host loop's F1 fit the losses and one vector of summed counts);
- the spans' epoch tags: set-up under None, a train epoch's spans and
  its evals' under that epoch;
- ``data.pack``'s self time is its total less its ``data.csr_plan``
  child's;
- under a ``torch.profiler`` the spans are its ranges, nested as in the
  registry, and the losses are those of the run without it; with no
  profiler no ``record_function`` is entered;
- the prefetch loader's worker thread counts as the inline packer does;
- on two gloo ranks, the data-parallel, edge-partitioned and hybrid fits
  record their collectives; a halo waited twice closes its span once.

No JAX here: the spans are the port's own.
"""

import copy
import json
from pathlib import Path

import pytest
import torch
import yaml

import torch_dist
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.runner import run_experiment
from graph_hscn_tpu_torch.train import loop
from graph_hscn_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def spans():
    """One torch thread, an empty registry, and the spmm backend as it
    was."""
    n, backend = torch.get_num_threads(), spmm.get_backend()
    torch.set_num_threads(1)
    profiling.reset_spans()
    try:
        yield
    finally:
        torch.set_num_threads(n)
        spmm.set_backend(backend)


def _raw(path: str, num_graphs: int = 16, epochs: int = 2,
         **changes) -> dict:
    """The shipped config ``path`` with ``num_graphs`` graphs, ``epochs``
    epochs and an eval every epoch; ``changes`` {"section.field": value}."""
    raw = yaml.safe_load((ROOT / "configs" / path).read_text())
    raw["data"]["num_graphs"] = num_graphs
    raw["training"].update(max_epochs=epochs, eval_period=1)
    for key, value in changes.items():
        section, field = key.split(".")
        raw.setdefault(section, {})[field] = value
    return raw


# The host loop with the CSR plan packed (the pallas backend: on the CPU
# the kernel's plain twin aggregates), the device route and the device
# HSCN pipeline, each 2 epochs over 16 graphs with an eval every epoch.
ROUTES = {
    "host": _raw("GCN/voc_superpixels_GCN_sparse.yaml",
                 **{"mp.num_layers": 2, "mp.hidden_channels": 16,
                    "data.batch_size": 4, "runtime.spmm_backend": "pallas"}),
    "device": _raw("GCN/peptides_func_GCN.yaml", **{"data.batch_size": 4}),
    "hscn": _raw("HSCN/peptides_func_HSCN.yaml",
                 **{"data.batch_size": 4, "hscn.cluster_epochs": 1}),
}


def _fit(raw: dict):
    return run_experiment(parse_config(copy.deepcopy(raw)), device="cpu")


def _losses(result) -> list:
    return [(h["train_loss"], h["validation_loss"], h["test_loss"])
            for h in result.history]


def _by(totals: dict, name: str, field: str = "calls") -> dict:
    """{epoch: ``field``} of span ``name``."""
    return {e: v[field] for (n, e), v in totals.items() if n == name}


@pytest.mark.parametrize("route", ROUTES)
def test_step_and_epoch_end_spans(route, monkeypatch):
    """(a) and (b): the step spans count the fit's steps, each pass one
    readback and one metric, the readback's bytes those ``collect``
    reads: the losses and the scores, targets and masks, or on a metric
    of counts (the host loop's VOC F1) the losses and the steps' counts
    summed to one row; set-up under None, each epoch's train and eval
    spans under it."""
    read = []
    collect = loop._StepRunner.collect

    def spy(self, losses, *outs):
        counted = self.stat is not None
        assert counted == (route == "host")
        read.append(losses.nbytes + (outs[0][0].nbytes if counted else
                                     sum(t.nbytes for t in outs)))
        return collect(self, losses, *outs)

    monkeypatch.setattr(loop._StepRunner, "collect", spy)
    result = _fit(ROUTES[route])
    totals = profiling.span_totals()
    assert sum(_by(totals, "train_step").values()) == result.num_train_steps
    assert sum(_by(totals, "eval_step").values()) == result.num_eval_batches
    # Each epoch: the train pass, then the val and test passes.
    passes = {0: 3, 1: 3}
    assert _by(totals, "epoch_end.readback") == passes
    assert _by(totals, "epoch_end.metric") == passes
    assert sum(_by(totals, "epoch_end.readback", "bytes").values()) == sum(
        read) > 0
    assert len(read) == 6

    # Epoch tags: the steps and ends under 0 and 1, set-up under None.
    assert set(_by(totals, "train_step")) == {0, 1}
    assert set(_by(totals, "eval_step")) == {0, 1}
    setup = {n: e for n, e in totals if n.startswith("setup.")}
    assert set(setup.values()) == {None}
    want = {"setup.data"} | ({"setup.device_dataset"} if route != "host"
                             else set())
    if route == "hscn":
        want.add("setup.clustering")
        assert _by(totals, "cluster_step") == {
            None: 2 * -(-16 // 4)}           # an epoch and the assignment
    assert set(setup) == want
    assert profiling._epoch is None
    if route == "host":
        assert set(_by(totals, "data.to_device")) == {0, 1}
    else:
        assert _by(totals, "setup.device_dataset") == {None: 1}
    # Bytes only where a metric reads them: the readback.
    assert {n for (n, _), v in totals.items() if v["bytes"]} == {
        "epoch_end.readback"}


def test_pack_self_time_leaves_out_its_plan():
    """(c): ``data.pack``'s self time is its total less the time of the
    ``data.csr_plan`` spans inside it, epoch by epoch."""
    _fit(ROUTES["host"])
    totals = profiling.span_totals()
    plan = _by(totals, "data.csr_plan", "total_ns")
    assert set(plan) == {None, 0, 1}
    assert _by(totals, "data.csr_plan") == _by(totals, "data.pack")
    for epoch, total in _by(totals, "data.pack", "total_ns").items():
        self_ns = totals[("data.pack", epoch)]["self_ns"]
        assert self_ns == total - plan[epoch]
        assert 0 < self_ns < total


def _intervals(events: list, name: str) -> list:
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == name and e.get("ph") == "X"]


def test_spans_are_profiler_ranges_only_under_a_profiler(monkeypatch,
                                                         tmp_path):
    """(d): with no profiler the fit enters no ``record_function`` (the
    name the spans call raises); under one, each span is a range of the
    trace, the children inside their parents, as many as the registry
    counts, and the losses are those of the run without it."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        plain = _fit(ROUTES["host"])
    untraced = profiling.span_totals()
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _fit(ROUTES["host"])
    assert _losses(traced) == _losses(plain)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    totals = profiling.span_totals()
    assert {k: v["calls"] for k, v in totals.items()} == {
        k: v["calls"] for k, v in untraced.items()}
    for name in ("train_step", "eval_step", "data.pack", "data.csr_plan",
                 "data.to_device", "epoch_end.readback", "epoch_end.metric",
                 "setup.data"):
        calls = sum(_by(totals, name).values())
        assert len(_intervals(events, name)) == calls > 0, name
    # Nested as in the registry: every plan in a pack, every move in a
    # train or eval step, and the set-up packs (the eval batches) in
    # ``setup.data``.
    for child, parents, want in (
            ("data.csr_plan", ("data.pack",), None),
            ("data.to_device", ("train_step", "eval_step"), None),
            ("data.pack", ("setup.data",), totals[("data.pack", None)])):
        outer = [i for p in parents for i in _intervals(events, p)]
        inner = _intervals(events, child)
        inside = sum(any(a <= s and e <= b for a, b in outer)
                     for s, e in inner)
        assert inside == (want["calls"] if want else len(inner)), child


def test_prefetch_worker_counts_as_the_inline_packer():
    """(e): with ``data.num_workers: 2`` the batches are packed on a worker
    thread; the spans count as the inline packer's, epoch by epoch."""
    counts = []
    for workers in (0, 2):
        profiling.reset_spans()
        raw = copy.deepcopy(ROUTES["host"])
        raw["data"]["num_workers"] = workers
        _fit(raw)
        counts.append({k: v["calls"] for k, v in
                       profiling.span_totals().items()})
    assert counts[0] == counts[1]
    assert counts[1][("data.pack", 1)] == counts[1][("train_step", 1)] > 1


def test_mesh_collectives_are_spans(tmp_path):
    """(f): on two gloo ranks, in one spawn: the data-parallel fit's one
    gradient and loss ``all_reduce`` a train step, and no halo; the
    edge-partitioned GCN's and the hybrid's the same ``all_reduce``, halo
    exchanges and row gathers, and every span closed on each rank."""
    dp = _raw("GCN/peptides_func_GCN_dp8.yaml",
              **{"mesh.shape": [2], "data.batch_size": 4,
                 "mp.hidden_channels": 16, "mp.num_layers": 2})
    edge = _raw("GCN/voc_superpixels_GCN_edge_partition.yaml",
                **{"mesh.shape": [2], "mp.hidden_channels": 16,
                   "mp.num_layers": 2})
    hybrid = _raw("GCN/voc_superpixels_GCN_hybrid.yaml",
                  **{"mesh.shape": [1, 2], "mp.hidden_channels": 16,
                     "mp.num_layers": 2})
    runs = [{"raw": dp}, {"raw": edge}, {"raw": hybrid}]
    outs = torch_dist.spawn("span_run", 2, {"runs": runs}, tmp_path,
                            timeout=120)
    for rank in outs:
        for name, run in zip(("dp", "edge", "hybrid"), rank):
            assert run["open"] == 0, name
            calls = {}
            for n, _, c in run["spans"]:
                calls[n] = calls.get(n, 0) + c
            assert calls["comm.all_reduce"] == run["steps"], name
            if name == "dp":
                assert "comm.halo" not in calls
                continue
            assert calls["comm.halo"] > 0 and run["halo"] > 0, name
            assert calls["comm.all_gather"] > 0, name


class _Done:
    def __init__(self):
        self.waits = 0

    def wait(self):
        self.waits += 1


def test_halo_waited_twice_closes_its_span_once():
    """A halo's ``comm.halo`` span runs from the send to the first wait; a
    second wait returns the same table and records nothing more, and no
    span is left open on the thread."""
    from graph_hscn_tpu_torch.parallel.edge_partition import Halo
    table, work = torch.ones(2, 3), _Done()
    with profiling.span("train_step"):
        halo = Halo(table, work, profiling.span("comm.halo").__enter__())
        assert halo.wait() is table
        assert halo.wait() is table
    assert work.waits == 1
    totals = profiling.span_totals()
    assert totals[("comm.halo", None)]["calls"] == 1
    step = totals[("train_step", None)]
    assert step["self_ns"] == step["total_ns"] - totals[
        ("comm.halo", None)]["total_ns"]
    assert profiling._open.stack == []
