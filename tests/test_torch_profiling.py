"""The support layer of the port (utils/profiling.py, utils/logger.py, the
HSCN walkthrough) against the JAX package's, on the CPU at small sizes:

- the epoch line's edge count (", X.XX M edges/s") on every route where
  JAX's carries one, with JAX's counts;
- ``runtime.debug_nans`` on the host loop, the device-resident route (and
  its fused twin), the HSCN pipeline and the edge-partitioned GCN: clean
  data trains as with the guard off, bit for bit; NaN in every graph's
  features raises before the first epoch line; NaN in one test graph does
  what each package does (ROADMAP.md, "Not port faults": JAX checks a
  program's outputs on the call that compiles it, and after a scoped
  ``jax.debug_nans(False)``, which its own tracing enters, no later call);
  on two gloo ranks both raise together, and ``fit_dp`` with a rank
  on the masked placeholder trains clean data as without the guard;
- ``runtime.profile_dir``: a trace of the device route's fit, a warning
  on the host loop;
- wandb (a stand-in module): the same project, keys and values as JAX's;
- ``StepTimer``'s report, and the walkthrough on the CPU.

Each package's NaN guard is process-wide: the ``guards`` fixture turns
both off again.
"""

import copy
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import torch_dist
from graph_hscn_tpu.config.config import parse_config as jax_parse
from graph_hscn_tpu.data import pipeline as jax_pipeline
from graph_hscn_tpu.runner import run_experiment as jax_run
from graph_hscn_tpu.utils import logger as jax_logger
from graph_hscn_tpu.utils.profiling import StepTimer as JaxStepTimer
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.data import pipeline
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.runner import run_experiment
from graph_hscn_tpu_torch.utils import logger as port_logger
from graph_hscn_tpu_torch.utils import profiling
from graph_hscn_tpu_torch.utils.profiling import StepTimer
from sharded_jax import mpnn_init_state

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: the suite runs several workers on
    shared cores, where torch's thread pool oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def guards():
    """Both packages' NaN guards and the spmm backends as they were."""
    from graph_hscn_tpu.ops import spmm as jax_spmm
    backends = spmm.get_backend(), jax_spmm.get_backend()
    yield
    jax.config.update("jax_debug_nans", False)
    profiling.nan_guard(False)
    spmm.set_backend(backends[0])
    jax_spmm.set_backend(backends[1])


def _raw(path: str, num_graphs: int, epochs: int = 1, **changes) -> dict:
    """The shipped config ``path`` with ``num_graphs`` graphs, ``epochs``
    epochs and an eval every epoch; ``changes`` {"section.field": value}."""
    raw = yaml.safe_load((ROOT / "configs" / path).read_text())
    raw["data"]["num_graphs"] = num_graphs
    raw["training"].update(max_epochs=epochs, eval_period=1)
    for key, value in changes.items():
        section, field = key.split(".")
        raw.setdefault(section, {})[field] = value
    return raw


# The routes, small: the host loop on sparse batches, the device-resident
# route and its fused twin, the HSCN pipeline (device-resident: its
# clustering and its fit) and the edge-partitioned GCN on one rank.  Graph
# 1 lands in the test split of each.
ROUTES = {
    "host_voc_gcn": _raw("GCN/voc_superpixels_GCN_sparse.yaml", 16,
                         **{"mp.num_layers": 2}),
    "device_gcn": _raw("GCN/peptides_func_GCN.yaml", 16),
    "device_fused": _raw("GCN/peptides_func_GCN_fused.yaml", 16),
    "hscn": _raw("HSCN/peptides_func_HSCN.yaml", 32,
                 **{"hscn.cluster_epochs": 1}),
    "edge_gcn": _raw("GCN/voc_superpixels_GCN_edge_partition.yaml", 16,
                     **{"mesh.shape": [1], "mp.num_layers": 2}),
}
# What NaN in graph 1 alone (a test graph) does: the port raises
# FloatingPointError on the first output that holds it, on every route.
# JAX checks only the calls that compile a program (ROADMAP.md): the test
# split's eval runs the program the val split compiled on the batch
# routes, so the fit ends with a NaN test loss; the HSCN's clustering
# meets the graph in its first, compiling, epoch; the edge-partitioned
# route compiles the test split's forward, and its de-optimized rerun of
# the sharded program recurses without end.
JAX_ONE_GRAPH = {"host_voc_gcn": None, "device_gcn": None,
                 "device_fused": None, "hscn": FloatingPointError,
                 "edge_gcn": RecursionError}
# NaN in every graph: JAX raises in its first program, FloatingPointError,
# or RecursionError where the de-optimized rerun recurses: on the
# edge-partitioned route, and on the fused route once the Pallas
# interpreter's inner programs are in the jit cache (ROADMAP.md; then it
# takes half a minute here, hence JAX's case first).
JAX_ALL_GRAPHS = (FloatingPointError, RecursionError)


class _Lines:
    """Each package's epoch lines, with their edge counts, recorded."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        for module, into in ((port_logger, self.port),
                             (jax_logger, self.jax)):
            real = module.Logger.log_train

            def spy(log, epoch, loss, perf, t0, num_edges=None, real=real,
                    into=into):
                into.append(num_edges)
                return real(log, epoch, loss, perf, t0, num_edges=num_edges)

            monkeypatch.setattr(module.Logger, "log_train", spy)


def _port(raw: dict, mode: str, nans: bool = True, **kwargs):
    """The port's run of ``raw`` on the data ``mode`` gives, with
    ``runtime.debug_nans`` as ``nans`` says: the guard is reset first, as
    in a fresh process (the runner turns it on and, as JAX, never off)."""
    cfg = parse_config(copy.deepcopy(raw))
    cfg.runtime.debug_nans = nans
    profiling.nan_guard(False)
    with torch_dist.poisoned(pipeline, mode):
        return run_experiment(cfg, device="cpu", **kwargs)


def _jax(raw: dict, mode: str, **kwargs):
    cfg = jax_parse(copy.deepcopy(raw))
    cfg.runtime.debug_nans = True
    with torch_dist.poisoned(jax_pipeline, mode):
        return jax_run(cfg, **kwargs)


def _losses(result) -> list:
    return [(h["train_loss"], h.get("validation_loss"), h.get("test_loss"))
            for h in result.history]


@pytest.mark.parametrize("route", ROUTES)
def test_debug_nans(route, guards, monkeypatch):
    """NaN in every graph: both packages raise before the first epoch line
    (JAX's case first, while its jit cache is cold).  Clean data: neither
    raises, the port's losses with the guard equal its losses without, bit
    for bit, and its epoch lines carry JAX's edge counts.  NaN in one test
    graph: each package as ``JAX_ONE_GRAPH`` says."""
    raw = ROUTES[route]
    assert 1 in jax_pipeline.DataModule.from_config(
        jax_parse(copy.deepcopy(raw)).data).split_idx["test"]
    lines = _Lines(monkeypatch)
    with pytest.raises(JAX_ALL_GRAPHS, match="nan|recursion"):
        _jax(raw, "all")
    with pytest.raises(FloatingPointError,
                       match=r"^invalid value \(nan\) encountered in "):
        _port(raw, "all")
    assert lines.port == lines.jax == [], "an epoch line before the raise"

    off = _port(raw, "clean", nans=False)
    assert not profiling._debug_nans
    on = _port(raw, "clean")
    assert profiling._debug_nans
    assert _losses(on) == _losses(off)
    assert np.isfinite(_losses(on)).all()
    ref = _jax(raw, "clean")
    assert lines.port == lines.jax + lines.jax, "edge counts differ"

    lines.port.clear(), lines.jax.clear()
    with pytest.raises(FloatingPointError, match="nan"):
        _port(raw, "one")
    if JAX_ONE_GRAPH[route] is None:
        jres = _jax(raw, "one")
        assert np.isnan(jres.history[-1]["test_loss"])
        assert np.isfinite(jres.history[-1]["validation_loss"])
        assert len(ref.history) == len(jres.history)
    else:
        with pytest.raises(JAX_ONE_GRAPH[route], match="nan|recursion"):
            _jax(raw, "one")
    # Both meet the graph at the same point: before the HSCN's first
    # epoch line (in its clustering), after the others' first.
    assert len(lines.port) == len(lines.jax) == (0 if route == "hscn"
                                                  else 1)


def test_jax_checks_only_compiling_calls_after_a_scoped_toggle(guards):
    """The rule behind JAX's one-test-graph result (JAX 0.9): with
    ``jax_debug_nans`` set globally, a call served from the jit cache is
    checked by a post hook that a scoped ``jax.debug_nans(False)`` (which
    JAX's own tracing enters, e.g. ``core.jaxpr_as_fun`` under Pallas'
    interpreter or ``vmap``) leaves overridden, for the thread, by a local
    None; the call that compiles is checked all the same."""
    from jax._src import api, config

    clean = np.ones(3, np.float32)
    nan = np.array([1.0, np.nan, 3.0], np.float32)
    # The thread as a fresh process has it: no local hook set.
    api._post_hook_state.set_local(config.config_ext.unset)
    jax.config.update("jax_debug_nans", True)
    f = jax.jit(lambda x: x * 2)
    g = jax.jit(lambda x: x + 1)
    try:
        f(clean)
        with pytest.raises(FloatingPointError):
            f(nan)                 # a cache hit, checked by the hook
        with jax.debug_nans(False):
            pass
        assert np.isnan(f(nan)).any()          # a cache hit: unchecked
        with pytest.raises(FloatingPointError):
            g(nan)                 # the compiling call: checked
    finally:
        api._post_hook_state.set_local(config.config_ext.unset)


def test_debug_nans_two_ranks_raise_together(tmp_path):
    """The edge-partitioned GCN on two gloo ranks with NaN in every
    graph: both ranks raise FloatingPointError at the same step, and the
    spawn returns (no rank waits in a collective).  Then, on the same
    ranks, ``fit_dp`` on clean data whose last train and test chunks
    hold one graph each, so that rank 1 steps and scores the masked
    placeholder: the guard does not fire, and the losses equal those of
    the run without it, bit for bit."""
    edge = _raw("GCN/voc_superpixels_GCN_edge_partition.yaml", 16,
                **{"mesh.shape": [2], "mp.num_layers": 2})
    dp = _raw("GCN/peptides_func_GCN_dp8.yaml", 16,
              **{"mesh.shape": [2], "data.batch_size": 2,
                 "mp.hidden_channels": 16, "mp.num_layers": 2})
    assert {k: len(v) for k, v in jax_pipeline.DataModule.from_config(
        jax_parse(copy.deepcopy(dp)).data).split_idx.items()} == {
            "train": 11, "val": 2, "test": 3}
    runs = [{"raw": edge, "mode": "all", "nans": True},
            {"raw": dp, "mode": "clean", "nans": True},
            {"raw": dp, "mode": "clean", "nans": False}]
    outs = torch_dist.spawn("nan_run", 2, {"runs": runs}, tmp_path,
                            timeout=120)
    assert outs[0][0]["raised"] == outs[1][0]["raised"]
    assert outs[0][0]["raised"].startswith("invalid value (nan) "
                                           "encountered in train step")
    for rank in outs:
        assert rank[1]["raised"] is None
        assert rank[1]["losses"] == rank[2]["losses"]
        assert np.isfinite(rank[1]["losses"]).all()


@pytest.mark.parametrize("route", ["hybrid", "host_dp"])
def test_edge_counts_follow_jax(route, guards, monkeypatch):
    """The hybrid at [1, 1] logs the train graphs' edges, as JAX's; the
    data-parallel fit logs none, as JAX's (the other routes' counts are
    held in test_debug_nans)."""
    if route == "hybrid":
        raw = _raw("GCN/voc_superpixels_GCN_hybrid.yaml", 12,
                   **{"mesh.shape": [1, 1], "mp.hidden_channels": 16,
                      "mp.num_layers": 2})
    else:
        raw = _raw("GCN/peptides_func_GCN_dp8.yaml", 16,
                   **{"mesh.shape": [2], "data.batch_size": 8,
                      "mp.hidden_channels": 16, "mp.num_layers": 2})
    lines = _Lines(monkeypatch)
    if route == "hybrid":
        run_experiment(parse_config(copy.deepcopy(raw)), device="cpu")
    else:
        # JAX's fit_dp takes two of the eight CPU devices tests/conftest.py
        # makes; the port's, one rank (data_parallel: the same fit_dp).
        one = copy.deepcopy(raw)
        one["mesh"]["shape"] = [1]
        run_experiment(parse_config(one), device="cpu", data_parallel=True)
    jax_run(jax_parse(copy.deepcopy(raw)))
    assert lines.port == lines.jax and len(lines.jax) == 1
    assert bool(lines.jax[0]) == (route == "hybrid")


def test_profile_dir_traces_the_device_route(tmp_path, guards, caplog):
    """A 2-epoch device-route fit with ``runtime.profile_dir`` writes one
    Chrome trace that parses and holds the step's operations, and trains
    as without it; the host loop warns once, names its route, and trains
    as without the key."""
    raw = _raw("GCN/peptides_func_GCN.yaml", 16, epochs=2)
    plain = _port(raw, "clean", nans=False)
    raw.setdefault("runtime", {})["profile_dir"] = str(tmp_path / "trace")
    traced = _port(raw, "clean", nans=False)
    assert _losses(traced) == _losses(plain)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::bmm" in names or "aten::matmul" in names
    assert "Optimizer.step#AdamW.step" in names

    host = _raw("GCN/voc_superpixels_GCN_sparse.yaml", 16, epochs=2,
                **{"mp.num_layers": 2})
    plain = _port(host, "clean", nans=False)
    host.setdefault("runtime", {})["profile_dir"] = str(tmp_path / "host")
    warned = _port(host, "clean", nans=False, log_file=tmp_path / "h.log")
    assert _losses(warned) == _losses(plain)
    text = (tmp_path / "h.log").read_text()
    assert text.count("WARNING") == 1
    assert "profile_dir is not traced on the host-loop route" in text
    assert not (tmp_path / "host").exists()


class _FakeWandb(types.SimpleNamespace):
    """A stand-in ``wandb`` module recording its calls."""

    def __init__(self):
        calls = []
        super().__init__(
            calls=calls, init=lambda **kw: calls.append(("init", kw)),
            log=lambda scalars: calls.append(("log", scalars)),
            finish=lambda: calls.append(("finish", {})))


def test_wandb_logs_as_jax(guards, monkeypatch):
    """With ``training.use_wandb`` and a stand-in wandb, a 2-epoch
    device-route fit from JAX's initial weights (dropout 0) inits the same
    project and logs the same keys in the same order, the values within
    1e-5 relative of JAX's; edges_per_sec is there and positive."""
    raw = _raw("GCN/peptides_func_GCN.yaml", 16, epochs=2,
               **{"mp.dropout": 0.0, "training.use_wandb": True})
    state = mpnn_init_state(raw)
    torch_dist.use_init(state, monkeypatch.setattr)
    port_w, jax_w = _FakeWandb(), _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", port_w)
    run_experiment(parse_config(copy.deepcopy(raw)), device="cpu")
    monkeypatch.setitem(sys.modules, "wandb", jax_w)
    jax_run(jax_parse(copy.deepcopy(raw)))
    assert [c[0] for c in port_w.calls] == [c[0] for c in jax_w.calls]
    assert port_w.calls[0] == jax_w.calls[0]
    assert port_w.calls[0][1]["project"] == "peptides_func_gcn_3"
    assert port_w.calls[-1][0] == "finish"
    for (_, got), (_, want) in zip(port_w.calls[1:-1], jax_w.calls[1:-1]):
        assert list(got) == list(want)
        for key, value in want.items():
            if key == "edges_per_sec":
                assert got[key] > 0
            else:
                np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                           err_msg=key)


def test_step_timer_reports_as_jax():
    """The same updates give the same report keys and counts."""
    timers = StepTimer(), JaxStepTimer()
    for t in timers:
        t.update(100, 10)
        t.update(50)
    reports = [t.report() for t in timers]
    assert list(reports[0]) == list(reports[1])
    for t in timers:
        assert (t.steps, t.edges, t.nodes) == (2, 150, 10)
    assert reports[0]["edges_per_sec"] == pytest.approx(
        150 / reports[0]["wall_sec"])
    timers[0].reset()
    assert timers[0].steps == 0


def test_walkthrough_runs_on_the_cpu(guards):
    """Every stage of the walkthrough at its own sizes, on the CPU."""
    from graph_hscn_tpu_torch.examples import hscn_walkthrough
    out = hscn_walkthrough.main(["--device", "cpu"])
    assert len(out["clusters"]) == 64
    active, slots = out["virtual_nodes"]
    assert 0 < active <= slots
    for stage in ("fit", "giant", "feedback"):
        losses = [h["train_loss"] for h in out[stage].history]
        assert losses and np.isfinite(losses).all(), stage
