"""CPU tests of the reference interface (``hscnbench/reference.py``): what
a configuration's reference is handed (initial weights, batches with edge
features, dropout draws of any shape, a clipped and scheduled AdamW), held
to what the benchmark's cells read before these were added and to the
port's own rules; and a test cell of the port's GPS (``testcells/``, its
own manifest, not a cell of ``BENCHMARK.json``) that its plain reference
follows, with a planted fault for each part of the interface.

    python -m pytest benchmarks/test_bench_reference.py -q
    python -m pytest benchmarks/test_bench_reference.py -q -m gpu  # a card
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hscnbench import (BENCH_DIR, datasets, harness, manifest,  # noqa: E402
                       reference)
from hscnbench.routes_common import slot_rows  # noqa: E402
from test_bench_harness import CELLS, SMALL, _state_unchanged  # noqa: E402

TESTCELLS = BENCH_DIR / "testcells"
GPS = "peptides_func_gps_test.device"


# -- the parent's reference, frozen: what the three cells read before the
# interface took initial rules, edge features and draws of any shape ------

def _parent_make_weights(spec: dict, seed: int, device) -> dict:
    names = sorted(spec)
    sizes = [math.prod(spec[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for n, size in zip(names, sizes):
        shape = tuple(spec[n])
        if len(shape) == 1:
            w = torch.zeros(shape, device=device)
        else:
            fan_out, fan_in = ((shape[-2], shape[-1]) if len(shape) == 2
                               else (shape[-1], shape[-2]))
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w = (u[off:off + size] * a).reshape(shape)
        out[n] = w.contiguous()
        off += size
    return out


def _parent_make_batch(arrays: dict, ids, rows, n_pad: int, device) -> dict:
    node_ptr, edge_ptr = arrays["node_ptr"], arrays["edge_ptr"]
    xs, srcs, dsts, graph, ys, nys = [], [], [], [], [], []
    off = 0
    for gi, g in enumerate(ids):
        n0, n1 = node_ptr[g], node_ptr[g + 1]
        e0, e1 = edge_ptr[g], edge_ptr[g + 1]
        ei = arrays["edge_index"][:, e0:e1] - n0 + off
        xs.append(arrays["node_feat"][n0:n1])
        srcs.append(ei[0])
        dsts.append(ei[1])
        graph.append(np.full(n1 - n0, gi))
        if "y" in arrays:
            ys.append(arrays["y"][g])
        else:
            nys.append(arrays["node_y"][n0:n1])
        off += n1 - n0

    def t(a, dtype=None):
        return torch.as_tensor(np.concatenate(a) if isinstance(a, list)
                               else a, dtype=dtype, device=device)
    y = node_y = None
    if ys:
        y = torch.as_tensor(np.stack(ys), dtype=torch.float32,
                            device=device)
    else:
        k = int(arrays["num_node_classes"])
        node_y = torch.nn.functional.one_hot(
            t(nys, torch.int64), k).float()
    return dict(x=t(xs, torch.float32), src=t(srcs, torch.int64),
                dst=t(dsts, torch.int64), graph=t(graph, torch.int64),
                rows=torch.as_tensor(rows, device=device),
                num_graphs=len(ids), n_pad=int(n_pad), y=y, node_y=node_y)


def _parent_dropout_fn(rate: float, width: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)

    def drop(h, batch):
        if rate == 0.0:
            return h
        bits = torch.rand((batch.n_pad, width), generator=gen,
                          device=device)[batch.rows]
        return torch.where(bits >= rate, h / (1.0 - rate), 0.0)
    return drop


def _arrays(name: str, num_graphs: int) -> dict:
    spec = {**manifest.load_cell(name).workload["data"],
            "num_graphs": num_graphs}
    return datasets.load_arrays(datasets.ensure_dataset(spec),
                                spec["dataset_name"])


def _slotted(arrays: dict, ids: list, slot: int) -> tuple:
    ctx = type("C", (), {"arrays": arrays})
    return slot_rows(ctx, ids, len(ids), slot)


def _equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_read_what_they_read_before(name):
    """At each cell's own widths: the initial weights, the batch's fields
    and the dropout bits (at the cell's rate and at 0.3) are the parent's,
    bit for bit."""
    cell = manifest.load_cell(name)
    arrays = _arrays(name, SMALL[name])
    dims = {"features": int(arrays["node_feat"].shape[1]),
            "classes": int(arrays["y"].shape[1]) if "y" in arrays
            else int(arrays["num_node_classes"])}
    if "edge_feat" in arrays:
        dims["edge_features"] = int(arrays["edge_feat"].shape[1])
    ref = cell.reference
    for i, (t, spec) in enumerate(sorted(ref.targets(cell.config,
                                                      dims).items())):
        new = reference.make_weights(spec, 9 + i, "cpu",
                                     harness.initial_rule(ref, t))
        old = _parent_make_weights(spec, 9 + i, "cpu")
        assert list(new) == list(old)
        assert all(_equal(new[n], old[n]) for n in old), t
    ids = [int(g) for g in arrays["split_train"][:5]]
    rows, n_pad = _slotted(arrays, ids, 608)[1:]
    new = reference.make_batch(arrays, ids, rows, n_pad, "cpu")
    old = _parent_make_batch(arrays, ids, rows, n_pad, "cpu")
    assert all(_equal(getattr(new, k), v) for k, v in old.items())
    width = int(cell.config["run"].get("mp", {}).get("hidden_channels", 16))
    rate = float(cell.config["run"].get("mp", {}).get("dropout", 0.0))
    h = torch.randn(len(rows), width)
    for r in (rate, 0.3):
        a = reference.Dropout(r, width, 17, "cpu")
        b = _parent_dropout_fn(r, width, 17, "cpu")
        for _ in range(3):
            assert torch.equal(a(h, new), b(h, new))


def test_the_draw_gives_the_ports_dropout_bits_in_any_shape():
    """A mixed sequence of the port's draws (node rows of a padded batch,
    attention-shaped, flat; rates 0 and 1 drawing nothing) from one
    generator, replayed by one ``Dropout`` from the same seed."""
    from graph_hscn_tpu_torch.models.layers import dropout
    gen = torch.Generator().manual_seed(23)
    drop = reference.Dropout(0.2, 6, 23, "cpu")
    batch = reference.Batch(x=torch.zeros(5, 1), src=torch.zeros(0),
                            dst=torch.zeros(0), graph=torch.zeros(5),
                            rows=torch.tensor([0, 1, 2, 4, 7]),
                            num_graphs=2, n_pad=8)
    seq = [(8, 6), (2, 4, 5, 5), (8, 6), (7,), (3, 3), (8, 6)]
    rates = [0.2, 0.5, 0.2, 0.0, 1.0, 0.2]
    for shape, rate in zip(seq, rates):
        x = torch.randn(shape)
        want = dropout(x, rate, True, gen)
        if shape == (8, 6):
            got = drop(x[batch.rows], batch)
            want = want[batch.rows]
        else:
            got = drop.dropout(x, rate)
        assert torch.equal(got, want), (shape, rate)
    assert torch.equal(drop.bits((4, 3)), torch.rand((4, 3), generator=gen))


def test_edge_features_follow_the_batch_through_its_cuts():
    """``edge_attr`` is the file's, in the edges' order; the first half of
    a batch is the batch of its first graphs, edge features and ids too;
    the float64 copy carries it."""
    arrays = _arrays("peptides_func_hscn.device", 96)
    ids = [int(g) for g in arrays["split_train"][:6]]
    whole = reference.make_batch(arrays, ids, *_slotted(arrays, ids, 448)[1:],
                                 "cpu")
    assert whole.ids == tuple(ids)
    e = [slice(arrays["edge_ptr"][g], arrays["edge_ptr"][g + 1])
         for g in ids]
    assert torch.equal(whole.edge_attr, torch.as_tensor(
        np.concatenate([arrays["edge_feat"][s] for s in e])))
    assert whole.edge_attr.shape[0] == whole.src.shape[0]
    logits = torch.randn(whole.num_graphs, 10)
    cut, half = reference.first_half(logits, whole)
    first = reference.make_batch(arrays, ids[:3],
                                 *_slotted(arrays, ids[:3], 448)[1:], "cpu")
    assert torch.equal(cut, logits[:3])
    for f in ("x", "src", "dst", "graph", "rows", "y", "edge_attr", "ids",
              "num_graphs"):
        assert _equal(getattr(half, f), getattr(first, f)), f
    wide = reference.as_dtype(whole, torch.float64)
    assert wide.edge_attr.dtype == wide.x.dtype == torch.float64
    assert torch.equal(wide.edge_attr.float(), whole.edge_attr)
    voc = _arrays("voc_gcn.host_sparse", 48)
    ids = [int(g) for g in voc["split_train"][:2]]
    assert reference.make_batch(voc, ids, *_slotted(voc, ids, 608)[1:],
                                "cpu").edge_attr is None


@pytest.mark.parametrize("schedule,warmup", [
    ("constant", 0), ("constant", 3), ("cosine", 0), ("cosine", 2),
    ("linear", 0), ("linear", 2)])
def test_the_written_out_optimizer_is_the_ports(schedule, warmup):
    """Ten updates of the port's AdamW with clipping and the schedule
    (horizon 10) against the reference's, on the same gradients, some
    steps' global norm above 1 and some below: the lr a step, the clipped
    gradient and the weights agree to float32 rounding."""
    from graph_hscn_tpu_torch.train import optimizers
    lr, horizon = 0.01, 10
    rate = optimizers.learning_rate_schedule(lr, schedule, warmup, horizon)
    mine = reference.lr_schedule(lr, schedule, warmup, horizon)
    for t in range(horizon):
        want = float(rate(torch.tensor(float(t)))) if callable(rate) else rate
        assert mine(t) == pytest.approx(want, rel=1e-6, abs=1e-6 * lr), t
    gen = torch.Generator().manual_seed(3)
    init = {"w": torch.randn(4, 3, generator=gen),
            "b": torch.randn(3, generator=gen)}
    params = {n: torch.nn.Parameter(w.clone()) for n, w in init.items()}
    port = optimizers.build_optimizer(
        params.values(), "adamW", lr, 0.01, clip_grad_norm=True,
        schedule=schedule, warmup_steps=warmup, total_steps=horizon)
    ref = {n: w.clone() for n, w in init.items()}
    opt = reference.AdamW(ref, lr, 0.01, schedule=mine)
    norms = []
    for step in range(horizon):
        scale = 3.0 if step % 2 == 0 else 0.1
        grads = {n: scale * torch.randn(w.shape, generator=gen)
                 for n, w in init.items()}
        for n, p in params.items():
            p.grad = grads[n].clone()
        norms.append(float(torch.sqrt(sum((g * g).sum()
                                          for g in grads.values()))))
        port.step()
        clipped = reference.clip_by_global_norm(grads)
        for n, p in params.items():
            torch.testing.assert_close(clipped[n], p.grad, rtol=1e-6,
                                       atol=0)
        opt.step(ref, clipped)
        for n, p in params.items():
            torch.testing.assert_close(ref[n], p.detach(), rtol=1e-6,
                                       atol=1e-7)
    assert max(norms) > 1 > min(norms)


def test_the_references_import_nothing_of_the_program():
    """The plain half of the yardstick and every configuration's reference,
    the test cell's too, loaded in a fresh interpreter: no module of the
    port, of the JAX package or of JAX comes with them."""
    files = sorted(str(p) for p in list((BENCH_DIR / "configs").glob("*.py"))
                   + list((TESTCELLS / "configs").glob("*.py")))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from pathlib import Path\n"
        "from hscnbench import manifest, reference\n"
        "for f in sys.argv[2:]: manifest.load_module(Path(f))\n"
        "import json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH_DIR),
                          *files], capture_output=True, text=True,
                         check=True, timeout=120)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert len(files) >= 3
    assert not loaded & {"graph_hscn_tpu_torch", "graph_hscn_tpu", "jax",
                         "jaxlib", "flax"}


# -- the GPS test cell -----------------------------------------------------

def gps_cell(tmp: Path) -> manifest.Cell:
    """The test cell as the harness loads a cell: its manifest and
    configuration under ``testcells/``, its workload beside the
    benchmark's routes in ``tmp``."""
    shutil.copytree(BENCH_DIR / "routes", tmp / "routes")
    shutil.copytree(TESTCELLS / "workloads", tmp / "workloads")
    return manifest.load_cell(GPS, manifest_path=TESTCELLS / "manifest.json",
                              bench_dir=tmp)


def run_gps(tmp: Path, seed: int, device: str | None = "cpu") -> dict:
    return harness.run_cell(GPS, seed, 0.0, False, time.perf_counter(),
                            device=device, cell=gps_cell(tmp))


def _half_batch(monkeypatch):
    """The loss over the first half of each batch's real targets, the
    mean taken over them: kept by a running count on the device, which a
    captured step holds (a host-side ``nonzero`` cannot be captured)."""
    from graph_hscn_tpu_torch.train import loop
    criterion = loop.criterion

    def half(loss_fn, pred, true, mask, **kwargs):
        seen = torch.cumsum(mask.long(), 0)
        keep = mask & (seen <= mask.sum() // 2)
        return criterion(loss_fn, pred, true, keep, **kwargs)
    monkeypatch.setattr(loop, "criterion", half)


def _edges_zeroed(monkeypatch):
    """The GatedGCN's edge input zeroed where the program takes it."""
    from graph_hscn_tpu_torch.models import layers
    forward = layers.GatedGCNConv.forward

    def zeroed(self, x, edge_feat, *args, **kwargs):
        return forward(self, x, torch.zeros_like(edge_feat), *args,
                       **kwargs)
    monkeypatch.setattr(layers.GatedGCNConv, "forward", zeroed)


def _clip_off(monkeypatch):
    from graph_hscn_tpu_torch.train import optimizers
    monkeypatch.setattr(optimizers, "clip_grad_norm",
                        lambda params, max_norm=1.0: None)


def _constant_lr(monkeypatch):
    from graph_hscn_tpu_torch.train import optimizers
    monkeypatch.setattr(optimizers, "learning_rate_schedule",
                        lambda lr, *args, **kwargs: lr)


GPS_FAULTS = (_state_unchanged, _half_batch, _edges_zeroed, _clip_off,
              _constant_lr)
# Seeds the limits were set from (101-116 on the CPU) and one that was not.
GPS_SEEDS = (101, 2 ** 31 + 11)


@pytest.mark.parametrize("seed", GPS_SEEDS)
def test_the_gps_cell_is_correct(seed, tmp_path):
    result = run_gps(tmp_path, seed)
    assert result["correct"] is True, result["checks"]
    cell = gps_cell(tmp_path / "again")
    assert set(result["checks"]) == set(cell.workload["limits"])


@pytest.mark.parametrize("fault", GPS_FAULTS,
                         ids=[f.__name__[1:] for f in GPS_FAULTS])
def test_a_broken_gps_step_is_not_correct(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result = run_gps(tmp_path, 7)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]


@pytest.mark.gpu
def test_the_gps_cell_on_the_card(tmp_path):
    """On a card, the captured device route (the first row eager, then the
    step replayed as a CUDA graph with the dropout generator registered):
    correct on three seeds, and not correct under each planted fault."""
    if not torch.cuda.is_available():
        pytest.skip("the captured route runs on a CUDA card alone")
    for seed in (21, 22, 2 ** 31 + 23):
        result = run_gps(tmp_path / str(seed), seed, device=None)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "checks": result["checks"]}))
        assert result["correct"] is True, result["checks"]
    for fault in GPS_FAULTS:
        with pytest.MonkeyPatch.context() as mp:
            fault(mp)
            result = run_gps(tmp_path / fault.__name__, 7, device=None)
        print(json.dumps({"fault": fault.__name__, "checks":
                          result["checks"]}))
        assert result["correct"] is False, fault.__name__
