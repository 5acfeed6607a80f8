"""CPU tests of the benchmark: discovery by name, the FLOP and byte
counts, the result line, the import check, the frozen traffic, and
``correct`` coming out false with the timed path broken underneath.

    python -m pytest benchmarks/test_bench_harness.py -q

Each run here drives the whole harness but its look for a card, on the
CPU at a small size (``run_cell(device="cpu", data_override=...)``).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hscnbench import BENCH_DIR, ROOT, datasets, harness, manifest  # noqa
from hscnbench.peaks import PEAK_BYTES_S, PEAK_FLOPS_F32  # noqa: E402
from hscnbench.trace import Trace  # noqa: E402

CELLS = ("peptides_func_hscn.device", "voc_gcn.host_sparse",
         "voc_gcn.device_dense")
SMALL = {"peptides_func_hscn.device": 96, "voc_gcn.host_sparse": 48,
         "voc_gcn.device_dense": 48}


# Train steps read at a small size: no more than its two warm-up epochs
# hold (on the CPU every step is eager; the card's replays are read by
# the probe's replay wrapper, tested alone below).
SMALL_STEPS = 4


def run_small(name: str, seed: int = 5) -> dict:
    cell = manifest.load_cell(name)
    cell.workload["observe_steps"] = min(SMALL_STEPS,
                                         harness.observe_steps(cell))
    return harness.run_cell(name, seed, 0.5, False, time.perf_counter(),
                            device="cpu", cell=cell,
                            data_override={"num_graphs": SMALL[name]})


def _manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_cell_is_found_by_name():
    m = _manifest()
    assert {w["name"] for w in m["workloads"]} == set(CELLS)
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.chips == w["chips"]
        entry = next(c for c in m["configs"] if c["name"] == w["config"])
        assert cell.config["reduced"] == entry["reduced"]
        assert cell.config["source"] == entry["source"]
        for metric in cell.per_layer:
            assert callable(manifest.metric_reader(metric["name"]).read)
        assert {e["name"] for e in cell.end_to_end} == {
            "train_graphs_per_s", "peak_mem_gib", "setup_s"}


def test_a_cell_added_as_files_alone(tmp_path):
    """A new cell is a workload file and a manifest entry: nothing that is
    already there changes."""
    bench = tmp_path / "benchmarks"
    for d in ("configs", "routes", "workloads", "metrics"):
        shutil.copytree(BENCH_DIR / d, bench / d)
    m = _manifest()
    m["workloads"].append({"name": "voc_gcn.host_half", "config": "voc_gcn",
                           "traffic": "host_half", "chips": 1,
                           "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    wl = json.loads((bench / "workloads" / "voc_gcn.host_sparse.json")
                    .read_text())
    wl["data"]["num_graphs"] = 1419
    (bench / "workloads" / "voc_gcn.host_half.json").write_text(
        json.dumps(wl))
    cell = manifest.load_cell("voc_gcn.host_half",
                              manifest_path=tmp_path / "BENCHMARK.json",
                              bench_dir=bench)
    assert cell.workload["data"]["num_graphs"] == 1419
    assert cell.route.__doc__.startswith("Route: the host loop")
    assert cell.per_layer == [
        p for p in m["per_layer"] if "workloads" not in p]


def test_flops_match_a_hand_count_on_two_graphs():
    """Two graphs of 3 and 2 nodes, 4 and 2 edges."""
    n, e = np.array([3, 2]), np.array([4, 2])
    gcn = manifest.load_cell("voc_gcn.host_sparse")
    dims = {"features": 14, "classes": 21}
    # 2·n·F_in·F_out + 2·(e + n)·F_out a layer, 14, 220 x 8, 21; x3.
    fwd = (2 * 5 * (14 * 220 + 7 * 220 * 220 + 220 * 21)
           + 2 * 11 * (8 * 220 + 21))
    assert gcn.reference.train_flops(gcn.config, dims, n, e) == 3 * fwd
    hscn = manifest.load_cell("peptides_func_hscn.device")
    dims = {"features": 9, "classes": 10}
    # Loss path: ll 1632 + 2752 + 2752, readout 80, dense and head
    # 2·(512 + 320): 8880, x3.  Virtual relations, forward only: 7673
    # (layer 0) + 12377 x 2, and the initial mean 45.
    assert hscn.reference.train_flops(hscn.config, dims, n, e) == (
        3 * 8880 + 7673 + 2 * 12377 + 45)


def test_csr_spmm_bytes_and_ops_of_a_small_csr():
    roof = manifest.metric_reader("csr_spmm_roofline")
    # 8 padded rows, 6 real, 10 edges, width 4: row_ptr 9 ints, col and w
    # 10 each, x 6 rows, out 8 rows; the transpose adds its int64 order.
    fwd = (4 * 9 + 8 * 10 + 4 * 4 * (6 + 8)) / PEAK_BYTES_S
    assert roof.launch_time(8, 6, 10, 4, False) == pytest.approx(fwd)
    assert roof.launch_time(8, 6, 10, 4, True) == pytest.approx(
        fwd + 80 / PEAK_BYTES_S)
    # Many edges of a wide row: the operations bound it.
    assert roof.launch_time(2, 2, 10 ** 6, 1000, False) == pytest.approx(
        2 * 10 ** 6 * 1000 / PEAK_FLOPS_F32)
    cell = manifest.load_cell("voc_gcn.host_sparse")
    dims = {"features": 14, "classes": 21}
    widths = cell.reference.spmm_launches(cell.config, dims)
    assert widths == ([220] * 8 + [21]) * 2
    ops = [("void (anonymous namespace)::csr_spmm_kernel<float, 4, 1, 2>"
            "(int const*)", i * 100, i * 100 + 10)
           for i in range(len(widths))]
    ops.append(("void csr_spmm_other(int)", 900, 990))
    # One train batch (forwards and transposes), one eval batch (forwards).
    ops += [ops[i] for i in range(9)]
    ctx = dataclasses.make_dataclass(
        "C", ["cell", "dims", "trace", "slice_batches", "slice_eval_batches",
              "slice_launches"])(
        cell, dims, Trace(ops, [], 1.0), [(8, 6, 10)], [(8, 5, 7)],
        {"csr_spmm": 27})
    want = (sum(roof.launch_time(8, 6, 10, f, i >= 9)
                for i, f in enumerate(widths))
            + sum(roof.launch_time(8, 5, 7, f, False) for f in widths[:9])
            ) / (270e-9)
    assert roof.read(ctx) == pytest.approx(100 * want)
    ctx.slice_launches = {"csr_spmm": 26}    # a launch the count lacks
    assert roof.read(ctx) is None


def test_the_probe_reads_a_step_that_a_replay_took():
    """On the card a captured step runs as a CUDA graph's replay, past
    every hook: after a replay the probe reads the weights back if the
    replay changed them."""
    from hscnbench.probe import Probe
    lin = torch.nn.Linear(3, 2)
    w = {n: torch.randn_like(p) for n, p in lin.named_parameters()}
    probe = Probe({"model": w}, observe="model", steps=3)
    try:
        opt = torch.optim.AdamW(lin.parameters(), lr=0.1)
        lin(torch.ones(4, 3)).sum().backward()
        opt.step()                  # eager: the optimizer's hook reads it
        assert len(probe.after_step["model"]) == 1
        assert set(probe.first_grad["model"]) == {"weight", "bias"}
        probe._replayed()           # a replay that changed nothing
        assert len(probe.after_step["model"]) == 1
        with torch.no_grad():
            lin.weight.add_(1.0)    # what a replayed train step does
        probe._replayed()
        assert len(probe.after_step["model"]) == 2
        torch.testing.assert_close(probe.after_step["model"][1]["weight"],
                                   lin.weight.detach())
    finally:
        probe.remove()


def test_trace_union_counts_overlap_once():
    t = Trace([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)],
              [("epoch_end", 22, 23)], 50e-9)
    assert t.busy_s() == pytest.approx(30e-9)
    assert t.idle_gaps() == [["epoch_end", pytest.approx(10e-9)]]
    assert t.top_ops(2) == [["b", pytest.approx(15e-9)],
                            ["a", pytest.approx(10e-9)]]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_keys(name):
    result = run_small(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_graphs_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == set(
        manifest.load_cell(name).workload["limits"])
    json.loads(json.dumps(result))


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("graph_hscn_tpu_torch", "graph_hscn_tpu_torch.runner",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "graph_hscn_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["graph_hscn_tpu", "jax"]


def _state_unchanged(monkeypatch):
    from graph_hscn_tpu_torch.train import optimizers
    step = optimizers.Optimizer.step

    def unchanged(self, applies=None):
        saved = [p.detach().clone() for p in self.params]
        step(self, applies)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
    monkeypatch.setattr(optimizers.Optimizer, "step", unchanged)


def _half_batch(monkeypatch):
    from graph_hscn_tpu_torch.train import loop
    criterion = loop.criterion

    def half(loss_fn, pred, true, mask, **kw):
        real = torch.nonzero(mask).reshape(-1)
        mask = mask.clone()
        mask[real[len(real) // 2:]] = False
        return criterion(loss_fn, pred, true, mask, **kw)
    monkeypatch.setattr(loop, "criterion", half)


def _cluster_altered(monkeypatch):
    from graph_hscn_tpu_torch import hscn_pipeline
    cluster = hscn_pipeline.train_clustering_device

    def altered(logger, ds, batch_size, scn, hscn_cfg, *a, **kw):
        ds, losses = cluster(logger, ds, batch_size, scn, hscn_cfg, *a, **kw)
        return ds.replace(cluster=(ds.cluster + 1)
                          % hscn_cfg.num_clusters), losses
    monkeypatch.setattr(hscn_pipeline, "train_clustering_device", altered)


def _virtual_altered(monkeypatch):
    """The virtual->virtual relation's output doubled where it is made:
    it reaches no logit, so only ``virtual_gap`` can see it."""
    from graph_hscn_tpu_torch.models import hscn
    forward = hscn.DenseGCN.forward
    monkeypatch.setattr(hscn.DenseGCN, "forward",
                        lambda self, x, adj: 2 * forward(self, x, adj))


def _scn_half_batch(monkeypatch):
    """The SCN's MinCUT and orthogonality losses over the first half of
    each batch's graphs."""
    from graph_hscn_tpu_torch.models import scn
    mincut = scn.mincut_pool

    def half(x, adj, s, mask=None):
        g = max(1, x.shape[0] // 2)
        return mincut(x[:g], adj[:g], s[:g],
                      None if mask is None else mask[:g])
    monkeypatch.setattr(scn, "mincut_pool", half)


FAULTS = [(cell, fault) for cell in CELLS
          for fault in (_state_unchanged, _half_batch)]
FAULTS += [("peptides_func_hscn.device", f)
           for f in (_cluster_altered, _virtual_altered, _scn_half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = run_small(name, seed=7)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]


def test_frozen_generators_equal_the_programs():
    from graph_hscn_tpu_torch.data import synthetic
    mine = datasets.make_voc_superpixels(6, 2)
    theirs = synthetic.make_voc_superpixels(6, seed=2)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a["x"], b.x)
        np.testing.assert_array_equal(a["edge_index"], b.edge_index)
        np.testing.assert_array_equal(np.eye(21)[a["node_label"]], b.node_y)
    mine = datasets.make_peptides_func(6, 0)
    theirs = synthetic.make_peptides_func(6, seed=0)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a["x"], b.x)
        np.testing.assert_array_equal(a["edge_index"], b.edge_index)
        np.testing.assert_array_equal(a["edge_attr"], b.edge_attr)
        np.testing.assert_array_equal(a["y"], b.y)


def test_the_dataset_file_is_read_by_the_ports_loader():
    from graph_hscn_tpu_torch.data import lrgb
    spec = {"dataset_name": "voc_superpixels", "num_graphs": 40,
            "split_ratio": [8498, 1428, 1429], "generator_seed": 3}
    d = datasets.ensure_dataset(spec)
    graphs, split = lrgb.try_load(str(d), "voc_superpixels")
    gen = datasets.make_voc_superpixels(40, 3)
    assert [len(split[k]) for k in ("train", "val", "test")] == [30, 5, 5]
    assert sorted(np.concatenate(list(split.values()))) == list(range(40))
    for g, h in zip(graphs, gen):
        np.testing.assert_array_equal(g.x, h["x"])
        np.testing.assert_array_equal(g.edge_index, h["edge_index"])
        np.testing.assert_array_equal(g.node_y.argmax(1), h["node_label"])
