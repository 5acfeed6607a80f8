"""Macro-F1 reduced on the device (train/metrics.py: ``confusion_counts``,
``sum_step_counts``, ``macro_f1_from_counts``; train/loop.py's steps and
``_StepRunner.collect``), on the CPU at small sizes:

- the counts-based macro-F1 equals the host ``eval_macro_f1`` on the same
  outputs bit for bit, over several steps of a pass;
- a step's counts, run eagerly, equal numpy's;
- an F1 fit on the host loop and on the device route (eager rows) gives
  the history of the same fit with the host F1, bit for bit, reads back
  the losses and one count vector a pass, and counts its passes; the same
  fit under metric ``ap`` keeps the step outputs (loss, score, true, mask)
  and the output buffers of scores and targets, and counts none;
- ``evaluate_checkpoint`` scores a snapshot as the host F1 does, with and
  without the export of its scores.

No JAX here: the host F1 is the port's own, held against JAX's in
tests/test_torch_train.py.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.runner import run_experiment
from graph_hscn_tpu_torch.train import device_data, loop, metrics

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _outputs(case: str, C: int, seed: int = 0):
    """Scores [N, C] float32, one-hot targets [N, C] and a mask [N] of
    three steps, each a list of per-step arrays."""
    rng = np.random.default_rng(seed)
    steps = []
    for n in (57, 40, 63):
        score = rng.normal(size=(n, C)).astype(np.float32)
        label = rng.integers(0, C, n)
        mask = rng.uniform(size=n) > 0.25
        if case == "ties":
            # Maxima tied within a row: argmax takes the first.
            score = np.round(score).astype(np.float32)
            score[::3, :2] = 5.0
        elif case == "pred_only":
            # Class C - 1 is predicted but never true.
            label = rng.integers(0, C - 1, n)
            score[::4, C - 1] = 9.0
        elif case == "absent":
            # Class 0 is neither true nor predicted.
            label = rng.integers(1, C, n)
            score[:, 0] = -9.0
        elif case == "masked_step" and len(steps) == 1:
            mask[:] = False
        steps.append((score, np.eye(C, dtype=np.float32)[label], mask))
    return steps


CASES = [(case, C) for case in ("random", "ties", "pred_only", "absent",
                                "masked_step") for C in (21, 2)]


@pytest.mark.parametrize("case,C", CASES)
def test_counts_f1_equals_host_f1(case, C):
    """Each step's counts on the CPU, summed by ``sum_step_counts`` and
    finished on the host, give ``eval_macro_f1`` of the pass's masked rows
    bit for bit."""
    steps = _outputs(case, C)
    rows = torch.stack([metrics.confusion_counts(*map(torch.tensor, s))
                        for s in steps])
    got = metrics.macro_f1_from_counts(
        metrics.sum_step_counts(rows).numpy())
    score, true, mask = (np.concatenate(t) for t in zip(*steps))
    want = metrics.eval_macro_f1(true[mask], score[mask])
    assert got.hex() == want.hex()


@pytest.mark.parametrize("case,C", CASES)
def test_step_counts_equal_numpy(case, C):
    """A step's counts, run eagerly, equal numpy's confusion counts of its
    unmasked rows, entry true*C + pred."""
    for score, true, mask in _outputs(case, C, seed=1):
        got = metrics.confusion_counts(torch.tensor(score),
                                       torch.tensor(true),
                                       torch.tensor(mask))
        want = np.zeros(C * C, np.int64)
        np.add.at(want, (true.argmax(1) * C + score.argmax(1))[mask], 1)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def _raw(path: str, **changes) -> dict:
    """The shipped config ``path``, small: 16 graphs, 2 layers at 16,
    batch 4, 2 epochs with an eval every epoch."""
    raw = yaml.safe_load((ROOT / "configs" / path).read_text())
    raw["data"].update(num_graphs=16, batch_size=4)
    raw["mp"].update(num_layers=2, hidden_channels=16)
    raw["training"].update(max_epochs=2, eval_period=1)
    for key, value in changes.items():
        section, field = key.split(".")
        raw.setdefault(section, {})[field] = value
    return raw


ROUTES = {"host": "GCN/voc_superpixels_GCN_sparse.yaml",
          "device": "GCN/voc_superpixels_GCN.yaml"}


def _history(result) -> list:
    return [{k: (v.hex() if isinstance(v, float) else v)
             for k, v in h.items()} for h in result.history]


class _Spy:
    """What each pass hands ``collect`` and what the device route's epochs
    keep in their output buffers."""

    def __init__(self, monkeypatch):
        self.collected, self.buffers = [], []
        collect, call = loop._StepRunner.collect, device_data.RowSteps.__call__

        def spy_collect(runner, *tensors):
            self.collected.append([(tuple(t.shape), t.dtype)
                                   for t in tensors])
            return collect(runner, *tensors)

        def spy_call(steps, *args, **kwargs):
            out = call(steps, *args, **kwargs)
            self.buffers.append([(tuple(b.shape), b.dtype)
                                 for b in steps.outs])
            return out

        monkeypatch.setattr(loop._StepRunner, "collect", spy_collect)
        monkeypatch.setattr(device_data.RowSteps, "__call__", spy_call)


@pytest.mark.parametrize("route", ROUTES)
def test_f1_fit_equals_host_f1_fit(route, monkeypatch):
    """An F1 fit reduces each pass on the device: (losses [R], counts
    [R, 441]) reach ``collect``, the device route's buffers hold count
    rows, and ``sum_step_counts.passes`` rises by one a train pass and two
    an eval epoch; its history (losses and metrics of train, val and test)
    equals the same fit's with the host F1, bit for bit."""
    raw = _raw(ROUTES[route])
    spy = _Spy(monkeypatch)
    before = metrics.sum_step_counts.passes
    counted = run_experiment(parse_config(copy.deepcopy(raw)), device="cpu")
    assert metrics.sum_step_counts.passes - before == 2 * 3
    C = 21
    assert len(spy.collected) == 6
    for shapes in spy.collected:
        (losses, ldt), (rows, rdt) = shapes
        assert rdt == torch.int64 and rows == (losses[0], C * C)
    if route == "device":
        max_rows = -(-counted.num_train_steps // 2)
        assert spy.buffers and all(
            b == [((max_rows,), torch.float32),
                  ((max_rows, C * C), torch.int64)] for b in spy.buffers)

    spy.collected.clear(), spy.buffers.clear()
    monkeypatch.delitem(metrics.COUNT_METRICS, "f1")
    host = run_experiment(parse_config(copy.deepcopy(raw)), device="cpu")
    assert metrics.sum_step_counts.passes - before == 2 * 3
    assert [len(s) for s in spy.collected] == [4] * 6
    assert _history(counted) == _history(host)
    assert all(np.isfinite(h["test_perf"]) for h in counted.history)


@pytest.mark.parametrize("route", ROUTES)
def test_ap_fit_keeps_scores(route, monkeypatch):
    """The same fit under metric ``ap``: the steps return (loss, score,
    true, mask), the device route's buffers hold [max_rows, B*slot, 21]
    scores and targets, and no pass is counted."""
    raw = _raw(ROUTES[route], **{"training.metric": "ap"})
    spy = _Spy(monkeypatch)
    before = metrics.sum_step_counts.passes
    run_experiment(parse_config(copy.deepcopy(raw)), device="cpu")
    assert metrics.sum_step_counts.passes == before
    assert len(spy.collected) == 6
    for (losses, _), (scores, sdt), (trues, _), (masks, mdt) in (
            spy.collected):
        assert scores == trues and scores[-1] == 21 and sdt == torch.float32
        assert masks == scores[:-1] and mdt == torch.bool
    if route == "device":
        for (loss, _), (score, _), (true, _), (mask, _) in spy.buffers:
            # [max_rows, B*slot, C]: B = 4 graph slots of the dataset's
            # slot.
            assert score == true and score[1] % 4 == 0 and score[2] == 21
            assert mask == score[:2] and loss == score[:1]


def test_evaluate_checkpoint_counts(tmp_path, monkeypatch):
    """``run_eval`` of an F1 fit's best snapshot (``evaluate_checkpoint``):
    the metric reduced on the device, one count a split, equals the host
    F1's bit for bit, as does the one scored with the scores exported
    (``predict_out``, which keeps the host F1)."""
    from graph_hscn_tpu_torch.runner import run_eval

    raw = _raw(ROUTES["host"], **{"training.checkpoint_dir": str(tmp_path)})
    cfg = parse_config(copy.deepcopy(raw))
    run_experiment(cfg, device="cpu")
    before = metrics.sum_step_counts.passes
    counted = run_eval(cfg, "best", device="cpu")
    assert metrics.sum_step_counts.passes - before == 2
    exported = run_eval(cfg, "best", device="cpu",
                        predict_out=str(tmp_path / "p.npz"))
    assert metrics.sum_step_counts.passes - before == 2
    assert np.load(tmp_path / "p.npz")["val_scores"].shape[1] == 21
    monkeypatch.delitem(metrics.COUNT_METRICS, "f1")
    host = run_eval(cfg, "best", device="cpu")
    assert set(counted) == {"val", "test"}
    for split, want in host.items():
        assert (counted[split]["f1"].hex() == exported[split]["f1"].hex()
                == want["f1"].hex())
        assert counted[split]["loss"] == want["loss"]
