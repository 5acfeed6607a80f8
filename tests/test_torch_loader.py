"""The port's prefetching loader and native batcher
(graph_hscn_tpu_torch/data/loader.py, data/native.py) against the JAX
package's ``data/loader.py`` and ``data/native.py``.

- ``PrefetchLoader`` covers the dataset once an epoch, repeats for the
  same seed, packs slotted batches (the two cases of
  tests/test_prefetch_loader.py); its batches equal JAX's
  ``PrefetchLoader``'s on the same graphs, array for array (the native
  path, slots, node-level targets with the port's CSR plan, and a chunk
  over the budget split in halves); the native batcher serves graph-level
  targets without edge features, in both packages.
- The native batcher equals the numpy packer, contiguous and slotted (the
  first two cases of tests/test_native_batcher.py; the slotted dense
  adjacency equals the one built from the edges).
- ``data.num_workers: 2`` through ``run_experiment`` follows JAX's
  per-epoch losses from the same init (1e-4 relative), peptides on slots
  and sparse VOC with the plan (the host loop; numpy packs both: their
  graphs carry edge features or node-level targets); with shape buckets
  it warns and packs inline, as JAX does.
"""

from __future__ import annotations

import copy
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import sharded_jax
import torch_dist
from graph_hscn_tpu.config.config import parse_config as jparse
from graph_hscn_tpu.data import loader as jloader
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.batching import PadBudget as JaxBudget
from graph_hscn_tpu.runner import run_experiment as jax_run
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.data import native
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
from graph_hscn_tpu_torch.data.loader import PrefetchLoader
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.ops.dense import build_dense_adj
from graph_hscn_tpu_torch.runner import run_experiment

ROOT = Path(__file__).parents[1]
FIELDS = ("node_feat", "senders", "receivers", "node_graph", "n_node",
          "n_edge", "node_mask", "edge_mask", "graph_mask", "y", "node_y")


def assert_batches_equal(a, b):
    """Every array field of two GraphBatches (port or JAX) equal."""
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), name)
    assert a.slot == b.slot


def test_prefetch_covers_dataset():
    graphs = ts.make_peptides_func(num_graphs=37, seed=77, mean_nodes=40)
    budget = PadBudget.for_dataset(graphs, batch_size=8)
    loader = PrefetchLoader(graphs, 8, budget, shuffle=True, seed=3)
    batches = list(loader)
    total = sum(int(b.graph_mask.sum()) for b in batches)
    assert total == 37
    # Same seed -> identical batch composition.
    again = list(loader.epoch(3))
    for a, b in zip(batches, again):
        np.testing.assert_allclose(a.y, b.y)


def test_prefetch_slotted():
    graphs = ts.make_peptides_func(num_graphs=16, seed=78, mean_nodes=40)
    budget = PadBudget.for_dataset(graphs, batch_size=4)
    slot = ((max(g.num_nodes for g in graphs) + 7) // 8) * 8
    loader = PrefetchLoader(graphs, 4, budget, slot_nodes=slot)
    batches = list(loader)
    assert all(b.slot == slot for b in batches)
    assert sum(int(b.graph_mask.sum()) for b in batches) == 16


@pytest.mark.parametrize("case", ["native", "slotted", "node_plan",
                                  "overflow"])
def test_batches_equal_jax_loader(case):
    """An epoch of each loader on the same graphs, shuffled with the same
    seed: the same batches, array for array; the port's packs with the
    native batcher exactly where JAX's does."""
    maker = "make_voc_superpixels" if case == "node_plan" else \
        "make_peptides_func"
    kw = dict(num_graphs=29, seed=5, mean_nodes=40)
    jg, tg = getattr(js, maker)(**kw), getattr(ts, maker)(**kw)
    if case != "node_plan":
        # Graph-level targets and no edge features: the native batcher's
        # batches (synthetic peptides carry edge features, which it does
        # not pack).
        jg = [g.replace(edge_attr=None) for g in jg]
        tg = [g.replace(edge_attr=None) for g in tg]
    bs = 6
    jb, tb = JaxBudget.for_dataset(jg, bs), PadBudget.for_dataset(tg, bs)
    if case == "overflow":
        # Room for a fifth of a chunk's nodes: chunks split, recursively.
        jb = JaxBudget(jb.num_nodes // 5, jb.num_edges, jb.num_graphs)
        tb = PadBudget(tb.num_nodes // 5, tb.num_edges, tb.num_graphs)
    slot = (((max(g.num_nodes for g in tg) + 7) // 8) * 8
            if case == "slotted" else None)
    plan = case == "node_plan"
    want = list(jloader.PrefetchLoader(jg, bs, jb, shuffle=True, seed=0,
                                       slot_nodes=slot).epoch(11))
    loader = PrefetchLoader(tg, bs, tb, shuffle=True, seed=0,
                            slot_nodes=slot, with_spmm_plan=plan)
    got = list(loader.epoch(11))
    assert loader.use_native == (native.native_available() and not plan)
    assert len(got) == len(want)
    if case == "overflow":
        assert len(got) > -(-29 // bs)
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
        assert (a.spmm is not None) == plan


def test_worker_packs_off_the_main_thread():
    """The batches are packed on the worker thread (the main thread only
    takes them), ahead of the consumer."""
    graphs = ts.make_peptides_func(num_graphs=12, seed=1, mean_nodes=30)
    loader = PrefetchLoader(graphs, 4, PadBudget.for_dataset(graphs, 4))
    seen = []
    real = loader._pack_multi

    def spy(chunk):
        seen.append(threading.current_thread() is threading.main_thread())
        return real(chunk)

    loader._pack_multi = spy
    assert len(list(loader)) == 3
    assert seen == [False] * 3


@pytest.fixture(scope="module")
def graphs():
    return ts.make_peptides_func(num_graphs=12, seed=50, mean_nodes=50)


def test_native_matches_numpy_contiguous(graphs):
    if not native.native_available():
        pytest.skip("native library unavailable")
    budget = PadBudget.for_dataset(graphs, batch_size=12)
    assert_batches_equal(native.pack_batch_native(graphs, budget),
                         pack_batch(graphs, budget))


def test_native_matches_numpy_slotted(graphs):
    if not native.native_available():
        pytest.skip("native library unavailable")
    budget = PadBudget.for_dataset(graphs, batch_size=12)
    slot = ((max(g.num_nodes for g in graphs) + 7) // 8) * 8
    ref = pack_batch(graphs, budget, slot_nodes=slot)
    nat = native.pack_batch_native(graphs, budget, slot_nodes=slot,
                                   materialize_dense=True)
    assert_batches_equal(nat, ref)
    # The host's adjacency equals the one built from the edges.
    np.testing.assert_allclose(nat.dense_adj,
                               build_dense_adj(ref.to("cpu")).numpy())


def _raw(path: str, **changes) -> dict:
    raw = yaml.safe_load((ROOT / "configs" / path).read_text())
    raw["data"]["num_graphs"] = 24
    raw["training"].update(max_epochs=3, eval_period=1)
    for key, value in changes.items():
        section, field = key.split(".")
        raw.setdefault(section, {})[field] = value
    return raw


@pytest.mark.parametrize("path,changes", [
    ("GCN/peptides_func_GCN.yaml", {"runtime.device_dataset": "off",
                                    "mp.dropout": 0.0,
                                    "data.batch_size": 8}),
    ("GCN/voc_superpixels_GCN_sparse.yaml", {"mp.dropout": 0.0,
                                             "runtime.spmm_backend":
                                             "pallas",
                                             "mp.num_layers": 2,
                                             "data.batch_size": 8}),
], ids=["peptides-slots", "voc-plan"])
def test_num_workers_follows_jax(path, changes, monkeypatch):
    """``data.num_workers: 2``: the port's run_experiment (the host loop
    on the loader's batches) against JAX's from the same init: per-epoch
    train, val and test losses within 1e-4 relative."""
    raw = _raw(path, **{"data.num_workers": 2, **changes})
    torch_dist.use_init(sharded_jax.mpnn_init_state(raw),
                        monkeypatch.setattr)
    got = run_experiment(parse_config(raw), device="cpu")
    ref = jax_run(jparse(copy.deepcopy(raw)))
    assert len(got.history) == len(ref.history) == 3
    for a, b in zip(got.history, ref.history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                       err_msg=key)


def test_num_workers_with_buckets_packs_inline():
    """With shape buckets the loader does not apply: a warning, and the
    inline bucketed batches (JAX's fallback)."""
    cfg = parse_config(_raw("GCN/voc_superpixels_GCN_sparse.yaml", **{
        "data.num_workers": 2, "data.num_buckets": 3}))
    dm = DataModule.from_config(cfg.data)
    with pytest.warns(UserWarning, match="num_buckets"):
        batches = list(dm.train_batches(epoch_seed=4))
    dm.num_workers = 0
    for a, b in zip(batches, dm.train_batches(epoch_seed=4)):
        assert_batches_equal(a, b)
