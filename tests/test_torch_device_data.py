"""The port's device-resident dataset (train/device_data.py), fit_device
and the runner's routes for the peptides configs, against the JAX
package's: DeviceDataset.build byte-identical, assemble equal on the same
index rows (dummies included), the epoch permutation identical, the
adjacency cache equal to the scatter build, and fit_device following the
JAX trajectory from the same initial weights with dropout off, for the
dense MPNN and the fused stack (graph-level) and the dense MPNN
(node-level, the route of the shipped VOC config).

Tolerance: loss and parameters rtol=1e-5, atol=1e-5*max|ref| (float32 sums
in another order); every array of the dataset and the assembled batch is
compared exactly.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu import runner as jax_runner
from graph_hscn_tpu.config.config import OptimConfig as JOptim
from graph_hscn_tpu.config.config import TrainingConfig as JTraining
from graph_hscn_tpu.config.config import load_config as jax_load_config
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
from graph_hscn_tpu.models.fused_gcn import FusedDenseGCN as JaxFusedDenseGCN
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.train import device_data as jdd
from graph_hscn_tpu.train.loop import fit_device as jax_fit_device
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu.utils.logger import Logger as JaxLogger
from graph_hscn_tpu_torch import runner
from graph_hscn_tpu_torch.config.config import (OptimConfig, TrainingConfig,
                                                load_config)
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (fused_gcn_params_from_jax,
                                                 mpnn_params_from_jax)
from graph_hscn_tpu_torch.models.fused_gcn import FusedDenseGCN
from graph_hscn_tpu_torch.models.mpnn import MPNN
from graph_hscn_tpu_torch.ops.dense import build_dense_adj
from graph_hscn_tpu_torch.train import device_data as tdd
from graph_hscn_tpu_torch.train.loop import fit_device
from graph_hscn_tpu_torch.utils.logger import Logger

ROOT = Path(__file__).parents[1]
PEPTIDES = ROOT / "configs" / "GCN" / "peptides_func_GCN.yaml"
PEPTIDES_FUSED = ROOT / "configs" / "GCN" / "peptides_func_GCN_fused.yaml"
VOC = ROOT / "configs" / "GCN" / "voc_superpixels_GCN.yaml"


def assert_close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max()),
                                               1e-30))


def _graphs(n=8, seed=61):
    """The same peptides graphs from each package's generator."""
    return (js.make_peptides_func(num_graphs=n, seed=seed, mean_nodes=35),
            ts.make_peptides_func(num_graphs=n, seed=seed, mean_nodes=35))


def test_build_is_byte_identical():
    jg, tg = _graphs()
    ref = jdd.DeviceDataset.build(jg, device_put=False)
    got = tdd.DeviceDataset.build(tg)
    assert (got.slot, got.e_slot) == (ref.slot, ref.e_slot)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name in ("slot", "e_slot"):
            continue
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert b.dtype == a.dtype and b.tobytes() == a.tobytes(), f.name
    assert got.adj is None           # no cache on the host


@pytest.mark.parametrize("idx", [[3, 0, 7, 5], [2, 6, -1, -1]])
def test_assemble_matches_jax(idx):
    jg, tg = _graphs()
    jds = jdd.DeviceDataset.build(jg)
    tds = tdd.DeviceDataset.build(tg, device="cpu")
    assert tds.adj is not None and tds.adj.dtype == torch.int16
    ref = jax.jit(jdd.assemble)(jds, jnp.asarray(idx, jnp.int32))
    got = tdd.assemble(tds, torch.tensor(idx, dtype=torch.int32))
    assert got.slot == ref.slot and got.slot_size == ref.slot_size
    for f in dataclasses.fields(ref):
        if f.name in ("slot", "spmm"):
            continue
        a, b = getattr(ref, f.name), getattr(got, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f.name)
    assert got.senders.dtype == torch.int64     # as GraphBatch.to makes them
    # The cached adjacency equals the scatter build from the edges, dummy
    # slots zeroed.
    np.testing.assert_array_equal(
        got.dense_adj.numpy(),
        build_dense_adj(got.replace(dense_adj=None)).numpy())


def test_epoch_permutation_matches_jax():
    for args in ((10, 4, 0, True), (37, 8, 5, True), (9, 4, 1, False)):
        np.testing.assert_array_equal(tdd.epoch_permutation(*args),
                                      jdd.epoch_permutation(*args))


def test_cache_budget_and_weighted_graphs(monkeypatch):
    jg, tg = _graphs(4, seed=2)
    weighted = [g.replace(edge_weight=np.ones(g.num_edges, np.float32))
                for g in tg]
    with pytest.raises(ValueError, match="edge_weight"):
        tdd.DeviceDataset.build(weighted, device="cpu")
    ds = tdd.DeviceDataset.build(tg, device="cpu")
    need = ds.num_graphs * ds.slot * ds.slot * 2
    monkeypatch.setattr(tdd, "ADJ_CACHE_BUDGET_BYTES", need)
    assert tdd.DeviceDataset.build(tg, device="cpu").adj is not None
    monkeypatch.setattr(tdd, "ADJ_CACHE_BUDGET_BYTES", need - 1)
    assert tdd.DeviceDataset.build(tg, device="cpu").adj is None
    # Without the cache, assemble leaves the adjacency to the scatter build.
    b = tdd.assemble(tdd.DeviceDataset.build(tg, device="cpu"),
                     torch.tensor([1, 0]))
    assert b.dense_adj is None and b.slot == ds.slot


def test_cache_refuses_counts_past_int16():
    jg, tg = _graphs(1, seed=3)
    g = tg[0]
    many = np.tile(np.array([[0], [1]]), (1, 40000))
    ds = tdd.DeviceDataset.build(
        [g.replace(edge_index=np.concatenate([g.edge_index, many], 1),
                   edge_attr=None)])
    with pytest.raises(ValueError, match="32767"):
        tdd.build_adj_cache(ds.to("cpu"))


def _follow_jax(jmodel, model, jg, tg, training, batch_size,
                node_level=False):
    """fit_device on both packages from the same initial weights, dropout
    off: every epoch's train, val and test loss, and the final weights,
    within 1e-5 relative.  ``model`` is the port's model, its weights to be
    carried over from the JAX init."""
    split = js.split_indices(len(jg), seed=50)
    parts = [[g[i] for i in split[k]] for g in (jg, tg)
             for k in ("train", "val", "test")]
    jparts, tparts = parts[:3], parts[3:]
    optim = dict(optim_type="adamW", lr=0.01, weight_decay=5e-4)
    jres = jax_fit_device(jmodel, *jparts, batch_size=batch_size,
                          optim_cfg=JOptim(**optim),
                          training_cfg=JTraining(**training),
                          logger=JaxLogger(metric_name=training["metric"]),
                          node_level=node_level)
    # fit_device's initial weights: init_state on an assembled batch with
    # the training seed (the weights depend on the shapes only).
    ds = jdd.DeviceDataset.build(sum(jparts, []))
    example = jax.jit(jdd.assemble)(ds, jnp.arange(batch_size,
                                                   dtype=jnp.int32))
    init = jax_init_state(jmodel, jax_build_opt("adamW", 0.01, 5e-4),
                          example, seed=training["seed"]).params
    convert = (fused_gcn_params_from_jax if isinstance(model, FusedDenseGCN)
               else mpnn_params_from_jax)
    model.load_state_dict(convert(jax.tree_util.tree_map(np.asarray, init)))
    final_ref = convert(jax.tree_util.tree_map(np.asarray, jres.state.params))
    tres = fit_device(model, *tparts, batch_size=batch_size,
                      optim_cfg=OptimConfig(**optim),
                      training_cfg=TrainingConfig(**training),
                      logger=Logger(metric_name=training["metric"]),
                      device="cpu", node_level=node_level)
    assert tres.epochs_run == jres.epochs_run == training["epochs"]
    assert tres.num_train_steps == training["epochs"] * -(
        -len(tparts[0]) // batch_size)
    for th, jh in zip(tres.history, jres.history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-5)
    for name, p in model.state_dict().items():
        assert_close(p, final_ref[name])


@pytest.mark.parametrize("fused", [False, True])
def test_fit_device_follows_jax(fused):
    """Two epochs of graph-level fit_device on peptides graphs (for the
    fused stack, the JAX kernels in interpret mode)."""
    jg = js.make_peptides_func(num_graphs=40, seed=8, mean_nodes=30)
    tg = ts.make_peptides_func(num_graphs=40, seed=8, mean_nodes=30)
    training = dict(model_type="gcn", loss_fn="cross_entropy", metric="ap",
                    epochs=2, eval_period=1, patience=50, min_delta=0.0,
                    seed=4)
    if fused:
        jmodel = JaxFusedDenseGCN(hidden_channels=16, num_classes=10,
                                  num_layers=3, interpret=True)
        model = FusedDenseGCN(9, 16, 10, 3)
    else:
        jmodel = JaxMPNN(conv_type="gcn", activation="relu", num_features=9,
                         hidden_channels=16, num_classes=10, num_layers=3)
        model = MPNN(conv_type="gcn", activation="relu", num_features=9,
                     hidden_channels=16, num_classes=10, num_layers=3)
    _follow_jax(jmodel, model, jg, tg, training, batch_size=8)


def test_fit_device_node_level_follows_jax():
    """Two epochs of node-level fit_device on VOC-superpixels graphs, the
    route of configs/GCN/voc_superpixels_GCN.yaml: node targets assembled
    from the device dataset, the dense MPNN without readout."""
    jg = js.make_voc_superpixels(num_graphs=12, seed=9, mean_nodes=100.0)
    tg = ts.make_voc_superpixels(num_graphs=12, seed=9, mean_nodes=100.0)
    training = dict(model_type="gcn", loss_fn="softmax_cross_entropy",
                    metric="f1", epochs=2, eval_period=1, patience=50,
                    min_delta=0.0, seed=5)
    kw = dict(conv_type="gcn", activation="relu", num_features=14,
              hidden_channels=16, num_classes=21, num_layers=3,
              readout="none")
    _follow_jax(JaxMPNN(**kw), MPNN(**kw), jg, tg, training, batch_size=4,
                node_level=True)


def _small(path, num_graphs=48):
    cfg = load_config(path)
    cfg.data.num_graphs = num_graphs
    cfg.data.batch_size = 8
    cfg.training.epochs = 2
    cfg.training.eval_period = 1
    return cfg


@pytest.mark.parametrize("path,fused", [(PEPTIDES, False),
                                        (PEPTIDES_FUSED, True)])
def test_run_experiment_peptides_routes_as_jax(path, fused):
    """Both shipped-width peptides configs, shrunk, train on the CPU through
    the device-resident dataset with finite losses; the port picks the
    route the JAX runner picks for the same config and data."""
    cfg = _small(path)
    result = runner.run_experiment(cfg, device="cpu")
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert isinstance(result.model, FusedDenseGCN if fused else MPNN)
    assert result.num_train_steps == 2 * -(-33 // 8)

    jcfg = jax_load_config(path)
    jcfg.data.num_graphs = 48
    jdm = JaxDataModule.from_config(jcfg.data)
    assert jdm.enable_dense_slots()
    dm = DataModule.from_config(cfg.data)
    assert dm.enable_dense_slots() and dm.slot_nodes == jdm.slot_nodes
    assert runner._use_fused_stack(cfg, dm, torch.device("cpu")) == \
        jax_runner._use_fused_stack(jcfg, jdm, False) == fused
    assert runner._use_device_dataset(cfg, dm) == \
        jax_runner._use_device_dataset(jcfg, jdm) is True


def test_run_experiment_voc_takes_node_level_fit_device(monkeypatch):
    """The shipped node-level VOC config (device_dataset: auto), shrunk,
    takes the JAX runner's route: fit_device with node targets and the
    dense MPNN without readout, not the host loop nor the fused stack."""
    cfg = load_config(VOC)
    cfg.data.num_graphs = 12
    cfg.data.batch_size = 4
    cfg.training.epochs = 1
    cfg.training.eval_period = 1
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return fit_device(*args, **kw)

    def host_fit(*args, **kw):
        raise AssertionError("took the host fit loop")

    monkeypatch.setattr(runner, "fit_device", spy)
    monkeypatch.setattr(runner, "fit", host_fit)
    result = runner.run_experiment(cfg, device="cpu")
    assert seen["node_level"] is True
    assert isinstance(result.model, MPNN) and result.model.readout == "none"
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    assert len(losses) == 3 and np.isfinite(losses).all()

    jcfg = jax_load_config(VOC)
    jcfg.data.num_graphs = 12
    jdm = JaxDataModule.from_config(jcfg.data)
    dm = DataModule.from_config(cfg.data)
    assert dm.task_level == jdm.task_level == "node"
    assert dm.enable_dense_slots() == jdm.enable_dense_slots()
    assert dm.slot_nodes == jdm.slot_nodes
    assert seen["slot"] == dm.slot_nodes
    assert runner._use_fused_stack(cfg, dm, torch.device("cpu")) == \
        jax_runner._use_fused_stack(jcfg, jdm, True) is False
    assert runner._use_device_dataset(cfg, dm) == \
        jax_runner._use_device_dataset(jcfg, jdm) is True


def test_full_size_peptides_shapes():
    """The shipped peptides config at its full size: 512 graphs, slot 392,
    9 features, 10 classes; the device dataset's estimate (7.2 MB) and the
    adjacency cache (157 MB) both fit their budgets."""
    cfg = load_config(PEPTIDES)
    dm = DataModule.from_config(cfg.data)
    assert dm.enable_dense_slots()
    assert (len(dm.graphs), dm.slot_nodes, dm.num_features,
            dm.num_classes) == (512, 392, 9, 10)
    assert runner._use_device_dataset(cfg, dm)
    assert 512 * 392 * 392 * 2 <= tdd.ADJ_CACHE_BUDGET_BYTES
