"""CPU tests of a cell on several ranks: the 2-D hybrid route
(``routes/hybrid.py``) on four gloo processes started by the benchmark's
own launcher, the harness's look for cards skipped, at a small size; a
sound run is correct, and one with the timed path broken underneath is
not.  The cell (``voc_gcn.hybrid_2x2``, ``fit_hybrid`` on a [2, 2] mesh)
lives in a manifest and a workload file of the test's own: it is not in
``BENCHMARK.json`` until it is proven on four cards.

    python -m pytest benchmarks/test_bench_ranks.py -q
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from hscnbench import ranks  # noqa: E402

ROOT = BENCH.parent
CELL = "voc_gcn.hybrid_2x2"
WORKLOAD = {
    "route": "hybrid",
    "data": {"dataset_name": "voc_superpixels", "num_graphs": 5678,
             "split_ratio": [8498, 1428, 1429], "generator_seed": 0},
    "overrides": {"mesh": {"axes": ["data", "model"], "shape": [2, 2],
                           "edge_partition": True}},
    "warmup_epochs": 3,
    "trace_epochs": 5,
    "limits": {"grad_gap": 1e-5, "step_change_gap": 1e-5,
               "epoch_loss_gap": 1e-5, "epoch_change_gap": 1e-5},
}

CHILD = """
import json, sys, time
sys.path.insert(0, {bench!r})
fault = {fault!r}
import torch
if fault == "state_unchanged":
    from graph_hscn_tpu_torch.train import optimizers
    step = optimizers.Optimizer.step
    def unchanged(self, applies=None):
        saved = [p.detach().clone() for p in self.params]
        step(self, applies)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
    optimizers.Optimizer.step = unchanged
elif fault == "exchange_left_out":
    from graph_hscn_tpu_torch.parallel import sharded_gcn
    sharded_gcn.all_reduce_grads = lambda params, group, loss=None: loss
elif fault == "half_batch":
    from graph_hscn_tpu_torch.parallel import sharded_gcn
    def half(logits, blk):
        real = torch.nonzero(blk.ok).reshape(-1)
        ok = blk.ok.clone()
        ok[real[len(real) // 2:]] = 0
        per = -(blk.y * torch.log_softmax(logits, -1)).sum(-1)
        return (per * ok).sum() / max(blk.real_rows // 2, 1)
    sharded_gcn.local_loss = half
from pathlib import Path
from hscnbench import manifest
from hscnbench.harness import run_cell
tmp = Path({tmp!r})
cell = manifest.load_cell({cell!r}, manifest_path=tmp / "BENCHMARK.json",
                          bench_dir=tmp / "benchmarks")
r = run_cell({cell!r}, 9, 0.5, False, time.perf_counter(), device="cpu",
             data_override={{"num_graphs": 40}}, cell=cell)
if r is not None:
    print(json.dumps(r))
"""


@pytest.fixture(scope="module")
def tmp_bench(tmp_path_factory):
    """A manifest with the four-rank cell beside the checkout's, and the
    cell's workload file, the rest of ``benchmarks/`` linked."""
    tmp = tmp_path_factory.mktemp("bench")
    with open(ROOT / "BENCHMARK.json") as f:
        m = json.load(f)
    m["workloads"].append({"name": CELL, "config": "voc_gcn",
                           "traffic": "hybrid_2x2", "chips": 4,
                           "why": "a test cell"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(m))
    bench = tmp / "benchmarks"
    (bench / "workloads").mkdir(parents=True)
    for d in ("configs", "routes", "metrics"):
        (bench / d).symlink_to(BENCH / d)
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(WORKLOAD))
    return tmp


def run_ranks(fault: str, tmp) -> dict:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    code = CHILD.format(bench=str(BENCH), fault=fault, cell=CELL,
                        tmp=str(tmp))
    out = ranks.launch("-c", [code], 4, time.perf_counter())
    assert out is not None
    return json.loads(out.strip().splitlines()[-1])


def test_a_sound_run_on_four_ranks_is_correct(tmp_bench):
    result = run_ranks("none", tmp_bench)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == 4


@pytest.mark.parametrize("fault", ["state_unchanged", "exchange_left_out",
                                   "half_batch"])
def test_a_broken_timed_path_on_four_ranks_is_not_correct(fault, tmp_bench):
    result = run_ranks(fault, tmp_bench)
    assert result["correct"] is False
