"""The PyTorch port's data layer against the JAX package's: synthetic graphs,
packed batches (byte-identical numpy arrays), DataModule splits and batch
orders, and config parsing (every YAML under configs/, field by field)."""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_hscn_tpu.config.config import load_config as jax_load_config
from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.pipeline import DataModule

CONFIGS = sorted(str(p.relative_to(Path(__file__).parents[1]))
                 for p in (Path(__file__).parents[1] / "configs").rglob(
                     "*.yaml"))

BATCH_FIELDS = ("node_feat", "senders", "receivers", "node_graph", "n_node",
                "n_edge", "node_mask", "edge_mask", "graph_mask", "y",
                "node_y", "edge_feat", "edge_weight")

MAKERS = {
    "voc": (js.make_voc_superpixels, ts.make_voc_superpixels,
            dict(num_graphs=5, seed=3, mean_nodes=200.0)),
    "peptides_func": (js.make_peptides_func, ts.make_peptides_func,
                      dict(num_graphs=6, seed=4, mean_nodes=60.0)),
    "peptides_struct": (js.make_peptides_struct, ts.make_peptides_struct,
                        dict(num_graphs=6, seed=5, mean_nodes=60.0)),
}


def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for f in dataclasses.fields(ga):
            va, vb = getattr(ga, f.name), getattr(gb, f.name)
            assert (va is None) == (vb is None), f.name
            if va is not None:
                assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes()


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_synthetic_graphs_identical(name):
    jmake, tmake, kw = MAKERS[name]
    _same_graphs(jmake(**kw), tmake(**kw))


@pytest.mark.parametrize("name,slotted", [("voc", False),
                                          ("peptides_func", False),
                                          ("peptides_func", True),
                                          ("peptides_struct", False)])
def test_pack_batch_byte_identical(name, slotted):
    jmake, _, kw = MAKERS[name]
    graphs = jmake(**kw)
    slot = (max(g.num_nodes for g in graphs) + 7) // 8 * 8 if slotted else None
    jbudget = jb.PadBudget.for_dataset(graphs, batch_size=len(graphs))
    tbudget = tb.PadBudget.for_dataset(graphs, batch_size=len(graphs))
    assert dataclasses.asdict(jbudget) == dataclasses.asdict(tbudget)
    ja = jb.pack_batch(graphs, jbudget, slot_nodes=slot)
    ta = tb.pack_batch(graphs, tbudget, slot_nodes=slot,
                       with_spmm_plan=not slotted)
    for f in BATCH_FIELDS:
        va, vb = getattr(ja, f), getattr(ta, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            va = np.asarray(va)
            assert va.dtype == vb.dtype and va.shape == vb.shape, f
            assert va.tobytes() == vb.tobytes(), f
    assert ta.slot == slot


def test_bucketed_budgets_match():
    graphs = js.make_peptides_func(num_graphs=40, seed=6, mean_nodes=50.0)
    jbs = jb.bucketed_budgets(graphs, 8, num_buckets=3)
    tbs = tb.bucketed_budgets(graphs, 8, num_buckets=3)
    assert [dataclasses.asdict(b) for b in jbs] == [
        dataclasses.asdict(b) for b in tbs]
    for n, e, g in ((100, 300, 3), (jbs[-1].num_nodes - 1, 10, 2)):
        assert (dataclasses.asdict(jb.pick_bucket(jbs, n, e, g))
                == dataclasses.asdict(tb.pick_bucket(tbs, n, e, g)))


def test_csr_row_pointers_match():
    rcv = np.sort(np.random.default_rng(0).integers(0, 50, 300)).astype(
        np.int32)
    np.testing.assert_array_equal(jb.csr_row_pointers(rcv, 60),
                                  tb.csr_row_pointers(rcv, 60))


@pytest.mark.parametrize("cfg_path,num_buckets",
                         [("configs/GCN/voc_superpixels_GCN_sparse.yaml", 1),
                          ("configs/GCN/peptides_func_GCN.yaml", 2)])
def test_datamodule_splits_and_batch_orders(cfg_path, num_buckets):
    root = Path(__file__).parents[1]
    jcfg, tcfg = jax_load_config(root / cfg_path), load_config(root / cfg_path)
    for c in (jcfg, tcfg):
        c.data.num_graphs = 24
        c.data.batch_size = 5
        c.data.num_buckets = num_buckets
    jdm, tdm = JaxDataModule.from_config(jcfg.data), DataModule.from_config(
        tcfg.data)
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(jdm.split_idx[k], tdm.split_idx[k])
    assert ([dataclasses.asdict(b) for b in jdm.budgets]
            == [dataclasses.asdict(b) for b in tdm.budgets])
    for seed in (0, 7):
        jbatches = list(jdm.train_batches(epoch_seed=seed))
        tbatches = list(tdm.train_batches(epoch_seed=seed))
        assert len(jbatches) == len(tbatches)
        for a, b in zip(jbatches, tbatches):
            for f in ("node_feat", "senders", "n_node"):
                assert np.asarray(getattr(a, f)).tobytes() == getattr(
                    b, f).tobytes()
    for split in ("val", "test"):
        ja, ta = jdm.eval_batches(split), tdm.eval_batches(split)
        assert [np.asarray(b.n_node).tolist() for b in ja] == [
            b.n_node.tolist() for b in ta]


@pytest.mark.parametrize("cfg_path", CONFIGS)
def test_config_parses_identically(cfg_path):
    root = Path(__file__).parents[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the GPS head-dim advice
        jcfg = jax_load_config(root / cfg_path)
        tcfg = load_config(root / cfg_path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


def test_batch_to_device_dtypes():
    graphs = ts.make_voc_superpixels(num_graphs=2, seed=1, mean_nodes=120.0)
    b = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 2),
                      with_spmm_plan=True).to("cpu")
    assert b.senders.dtype == torch.int64 and b.node_graph.dtype == torch.int64
    assert b.node_feat.dtype == torch.float32
    assert b.edge_mask.dtype == torch.bool
    assert b.spmm.row_ptr.dtype == torch.int32
    assert b.spmm.t_order.dtype == torch.int64
    assert b.spmm.num_edges == int(b.edge_mask.sum())
