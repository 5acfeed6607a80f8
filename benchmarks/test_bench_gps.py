"""CPU tests of the cell ``peptides_func_gps.device`` (LRGB's GraphGPS):
its plain reference (``configs/peptides_func_gps.py``) follows the port's
run and reads ``correct`` on seeds, and not under each planted fault of
the program; a traced run reads the cell's per-layer metrics, and a
program without the ``setup.posenc`` span and the ``gps.attn.*`` counters
reads none of the two new ones, without raising.  Each run drives the
whole harness at a small size: 48 graphs, batch 8, hidden 16, 2 heads, 2
layers, LapPE 4 wide, the lr warmed up over 2 steps.

    python -m pytest benchmarks/test_bench_gps.py -q
    python -m pytest benchmarks/test_bench_gps.py -q -m gpu   # a card
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hscnbench import harness, manifest  # noqa: E402
from test_bench_harness import _state_unchanged  # noqa: E402
from test_bench_reference import (_clip_off, _edges_zeroed,  # noqa: E402
                                  _half_batch)

from graph_hscn_tpu_torch.utils import profiling  # noqa: E402

NAME = "peptides_func_gps.device"
NEW_METRICS = ("gps.attn_real_share", "setup.posenc_s")
# Seeds inside the set the limits were read from on the CPU, and one not.
SEEDS = (301, 2 ** 31 + 31)


def small_cell() -> manifest.Cell:
    cell = manifest.load_cell(NAME)
    run = cell.config["run"]
    run["data"]["batch_size"] = 8
    run["mp"].update(hidden_channels=16, num_heads=2, num_layers=2)
    run["pe"].update(dim_pe=4)
    run["optim"]["warmup_steps"] = 2
    run["training"]["max_epochs"] = 6
    return cell


def run_small(seed: int, trace: bool = False, device: str | None = "cpu"):
    return harness.run_cell(NAME, seed, 0.5 if trace else 0.0, trace,
                            time.perf_counter(), device=device,
                            cell=small_cell(),
                            data_override={"num_graphs": 48})


def _bn_over_padding(monkeypatch):
    """BatchNorm statistics taken over the padding rows too."""
    from graph_hscn_tpu_torch.models import layers
    forward = layers.BatchNorm.forward
    monkeypatch.setattr(layers.BatchNorm, "forward",
                        lambda self, x, mask: forward(
                            self, x, torch.ones_like(mask)))


def _attention_dropout_off(monkeypatch):
    from graph_hscn_tpu_torch.models import gps
    init = gps.GraphMHA.__init__

    def off(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.dropout = 0.0
    monkeypatch.setattr(gps.GraphMHA, "__init__", off)


def _sign_flip_off(monkeypatch):
    """The LapPE encoder run as in eval: no sign drawn or applied."""
    from graph_hscn_tpu_torch.models import encoders
    forward = encoders.LapPENodeEncoder.forward

    def unflipped(self, batch, generator=None):
        was, self.training = self.training, False
        try:
            return forward(self, batch, generator)
        finally:
            self.training = was
    monkeypatch.setattr(encoders.LapPENodeEncoder, "forward", unflipped)


def _laplacian_sym(monkeypatch):
    """The eigen stats of the symmetric normalised Laplacian, whatever
    ``pe.eigen_laplacian_norm`` says (kept under a key of their own)."""
    from graph_hscn_tpu_torch.transform import posenc
    stats = posenc.posenc_stats
    monkeypatch.setattr(posenc, "posenc_stats", lambda dm, pe, *a, **k: stats(
        dm, dataclasses.replace(pe, eigen_laplacian_norm="sym"), *a, **k))


# Clipping off is not among them: at a global norm of 1 the clipping
# never acts on this model's first epoch (test_clipping_is_inert_in_epoch_0).
FAULTS = (_bn_over_padding, _attention_dropout_off, _sign_flip_off,
          _edges_zeroed, _half_batch, _state_unchanged, _laplacian_sym)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_cell_is_correct(seed):
    result = run_small(seed)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == set(
        manifest.load_cell(NAME).workload["limits"])


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run_small(7)
    assert result["correct"] is False, result["checks"]


def test_a_wrong_laplacian_fails_the_pe_gap(monkeypatch):
    _laplacian_sym(monkeypatch)
    check = run_small(7)["checks"]["pe_gap"]
    assert check["value"] > check["limit"], check


def test_missing_pairs_read_as_zero_fail_the_pe_gap(monkeypatch):
    """The program's eigvecs with a graph's missing pairs (a graph of 5
    nodes has 5 of 10) held as 0, not NaN, read inf; held as NaN, 0.  The
    cell's own graphs have 33 nodes or more, so there no pair is missing
    (PERF.md)."""
    ref = manifest.load_cell(NAME).reference
    monkeypatch.setitem(ref._SETTINGS, "freqs", 10)
    sizes = (5, 12)
    graph = torch.repeat_interleave(torch.arange(2), torch.tensor(sizes))
    chain = [(s + i, s + i + 1) for s, n in ((0, 5), (5, 12))
             for i in range(n - 1)]
    src, dst = torch.tensor(chain).T
    batch = type("B", (), {"graph": graph, "num_graphs": 2,
                           "src": torch.cat([src, dst]),
                           "dst": torch.cat([dst, src]),
                           "x": torch.zeros(17, 1),
                           "rows": torch.arange(17)})()
    vecs, _ = ref.eigen(batch, 10)
    assert torch.isnan(vecs[:5, 5:]).all()

    def gap(eigvecs):
        probe = type("P", (), {"batches": [type("Q", (), {
            "eigvecs": eigvecs})()]})()
        return ref.extra_checks(probe, batch, {})["pe_gap"]
    assert gap(vecs) == 0.0
    assert gap(torch.nan_to_num(vecs)) == math.inf


def test_clipping_is_inert_in_epoch_0(monkeypatch):
    """The global gradient norm of every train step the reference follows
    (epoch 0) stays under the clipping's 1.0, so that the fault of
    clipping off reads as sound: the scale it leaves out is 1."""
    from graph_hscn_tpu_torch.train import optimizers
    clip, norms = optimizers.clip_grad_norm, []

    def recorded(params, max_norm=1.0):
        norm = clip(params, max_norm)
        norms.append(float(norm))
        return norm
    monkeypatch.setattr(optimizers, "clip_grad_norm", recorded)
    assert run_small(7)["correct"] is True
    assert norms and max(norms) < 1.0, norms
    _clip_off(monkeypatch)
    assert run_small(7)["correct"] is True


def test_a_traced_run_reads_the_cells_metrics():
    profiling.reset_spans()
    result = run_small(9, trace=True)
    values = {k: v["value"] for k, v in result["metrics"].items()}
    cell = manifest.load_cell(NAME)
    for metric in cell.per_layer:
        name = metric["name"]
        assert name in values, name
        assert math.isfinite(values[name]) and values[name] >= 0, name
    assert 0 < values["gps.attn_real_share"] < 100
    assert values["setup.posenc_s"] > 0


def test_without_the_span_and_counters_nothing_is_read(monkeypatch):
    """The parent's program: the two readers return None, not raise."""
    ctx = type("C", (), {})()
    ctx.window = type("W", (), {"open_epoch": 1, "close_epoch": 3})()
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(profiling, "counter_totals")
    for metric in NEW_METRICS:
        assert manifest.metric_reader(metric).read(ctx) is None, metric


def test_the_share_reads_the_set_up_counts(monkeypatch):
    """The share is the counters' quotient, whatever epoch they carry;
    a computed count of 0 reads nothing."""
    counts = {("gps.attn.pairs_real", None): 20,
              ("gps.attn.pairs_computed", None): 100,
              ("gps.attn.pairs_real", 2): 10}
    monkeypatch.setattr(profiling, "counter_totals", lambda: counts)
    reader = manifest.metric_reader("gps.attn_real_share")
    assert reader.read(None) == pytest.approx(30.0)
    monkeypatch.setattr(profiling, "counter_totals", lambda: {
        ("gps.attn.pairs_real", None): 20})
    assert reader.read(None) is None


@pytest.mark.gpu
def test_the_control_fails_where_the_program_passes():
    """As ``test_bench_control.py`` holds the other cells, at the cell's
    own size: the reference in TF32, with its eigenpairs from a float32
    ``eigh``, fails one of the limits where the program passes them
    all."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs in TF32, which only a CUDA card has")
    limits = manifest.load_cell(NAME).workload["limits"]
    for seed in (11, 2 ** 31 + 12):
        r = harness.readings(NAME, seed)
        print(json.dumps({"seed": seed, "sound": r["sound"],
                          "control": r["control"]}))
        sound_ok, checks = harness.check.verdict(r["sound"], limits)
        assert sound_ok, (seed, {n: c for n, c in checks.items()
                                 if not c["value"] <= c["limit"]})
        control_ok, checks = harness.check.verdict(
            {**r["sound"], **r["control"]}, limits)
        assert not control_ok, (seed, checks)


@pytest.mark.gpu
def test_the_cell_on_the_card():
    """On a card, the captured device route at the small size: correct on
    three seeds, and not correct under each planted fault."""
    if not torch.cuda.is_available():
        pytest.skip("the captured route runs on a CUDA card alone")
    for seed in (31, 32, 2 ** 31 + 33):
        result = run_small(seed, device=None)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "checks": result["checks"]}))
        assert result["correct"] is True, result["checks"]
    for fault in FAULTS:
        with pytest.MonkeyPatch.context() as mp:
            fault(mp)
            result = run_small(7, device=None)
        print(json.dumps({"fault": fault.__name__, "checks":
                          result["checks"]}))
        assert result["correct"] is False, fault.__name__
