"""The port's one-program epoch (train/device_data.py:make_epoch_fn and the
device clustering of train/clustering.py) against the JAX package's
``lax.scan`` epochs, on the CPU, where the port runs the same step eagerly
row by row (on the card it is captured once as a CUDA graph and replayed:
tests/test_torch_cuda.py).

Each case builds one DeviceDataset from the same graphs on both sides,
carries the JAX initial weights over, turns dropout off, and runs 2 train
epochs, each followed by an eval epoch, over permutations whose last row
ends in -1 dummy slots (a graph count that is not a multiple of B).

Tolerance: per-row losses and scores, train and eval, rtol=1e-5,
atol=1e-5*max|ref| (float32 sums in another order); trues and masks
exactly; the final weights at 1e-4*max|ref| (PERF.md section 2: Adam
divides each gradient by its own running size, so a float32 rounding in a
near-zero gradient moves its weight by up to about lr).  The GatedGCN's
scores are its raw regression outputs (L1 loss, no sigmoid), read from
weights that already differ at that level; after the first update they
are held at the weights' 1e-4*max|ref| (they drift to 9.4e-5 of max|ref|
by the 12th row while the losses stay within 5e-6 and the weights within
9e-6).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.config.config import load_config as jax_load_config
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
from graph_hscn_tpu.models import hscn as jhscn
from graph_hscn_tpu.models.fused_gcn import FusedDenseGCN as JaxFusedDenseGCN
from graph_hscn_tpu.models.gatedgcn import GatedGCNNet as JaxGatedGCNNet
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.models.scn import build_scn as jax_build_scn
from graph_hscn_tpu.train import clustering as jclustering
from graph_hscn_tpu.train import device_data as jdd
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu_torch.config.config import HSCNConfig, load_config
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (fused_gcn_params_from_jax,
                                                 gatedgcn_params_from_jax,
                                                 hscn_params_from_jax,
                                                 mpnn_params_from_jax,
                                                 scn_params_from_jax)
from graph_hscn_tpu_torch.models.fused_gcn import FusedDenseGCN
from graph_hscn_tpu_torch.models.gatedgcn import GatedGCNNet
from graph_hscn_tpu_torch.models.hscn import build_hscn
from graph_hscn_tpu_torch.models.mpnn import MPNN
from graph_hscn_tpu_torch.models.scn import build_scn
from graph_hscn_tpu_torch.train import capture
from graph_hscn_tpu_torch.train import clustering
from graph_hscn_tpu_torch.train import device_data as tdd
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

ROOT = Path(__file__).parents[1]
PEPTIDES_HSCN = ROOT / "configs" / "HSCN" / "peptides_func_HSCN.yaml"
NUM_GRAPHS, BATCH = 22, 4     # 6 rows, the last with 2 dummy slots
K = 3                          # HSCN clusters


def assert_close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-30))


def _peptides(num_graphs, seed):
    kw = dict(num_graphs=num_graphs, seed=seed, mean_nodes=24)
    return js.make_peptides_func(**kw), ts.make_peptides_func(**kw)


def _with_clusters(graphs, seed):
    rng = np.random.default_rng(seed)
    return [g.replace(cluster=rng.integers(0, K, g.num_nodes)
                      .astype(np.int32)) for g in graphs]


def _case(name):
    """(jax graphs, port graphs, jax model, port model, converter, loss_fn,
    node_level) of one model family, all widths 16 or less."""
    if name == "mpnn":
        jg, tg = _peptides(NUM_GRAPHS, 21)
        kw = dict(conv_type="gcn", activation="relu", num_features=9,
                  hidden_channels=16, num_classes=10, num_layers=2)
        return (jg, tg, JaxMPNN(**kw), MPNN(**kw), mpnn_params_from_jax,
                "cross_entropy", False)
    if name == "fused":
        jg, tg = _peptides(NUM_GRAPHS, 22)
        return (jg, tg, JaxFusedDenseGCN(hidden_channels=16, num_classes=10,
                                         num_layers=2, interpret=True),
                FusedDenseGCN(9, 16, 10, 2), fused_gcn_params_from_jax,
                "cross_entropy", False)
    if name == "gatedgcn":
        kw = dict(num_graphs=NUM_GRAPHS, seed=23, mean_nodes=20)
        jg, tg = js.make_peptides_struct(**kw), ts.make_peptides_struct(**kw)
        return (jg, tg,
                JaxGatedGCNNet(hidden_channels=16, num_classes=11,
                               num_layers=2),
                GatedGCNNet(9, 16, 11, 2, num_edge_features=3),
                lambda p: gatedgcn_params_from_jax(p, True), "l1", False)
    if name == "node_mpnn":
        kw = dict(num_graphs=NUM_GRAPHS, seed=24, mean_nodes=100.0)
        jg, tg = (js.make_voc_superpixels(**kw),
                  ts.make_voc_superpixels(**kw))
        kw = dict(conv_type="gcn", activation="relu", num_features=14,
                  hidden_channels=16, num_classes=21, num_layers=2,
                  readout="none")
        return (jg, tg, JaxMPNN(**kw), MPNN(**kw), mpnn_params_from_jax,
                "softmax_cross_entropy", True)
    if name == "hscn":
        jg, tg = _peptides(NUM_GRAPHS, 25)
        jg, tg = _with_clusters(jg, 5), _with_clusters(tg, 5)
        kw = dict(hidden_channels=8, num_layers=2, num_clusters=K,
                  num_heads=2, virtual_feedback=True)
        jmodel = jhscn.HSCN(lv_conv="GAT", ll_conv="GCN", vv_conv="GCN",
                            activation="relu", num_classes=10,
                            readout="mean", **kw)
        model = build_hscn(HSCNConfig(ll_conv_type="GCN",
                                      vv_conv_type="GCN", **kw), 9, 10,
                           readout="mean")
        return (jg, tg, jmodel, model, hscn_params_from_jax,
                "cross_entropy", False)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["mpnn", "fused", "gatedgcn", "node_mpnn",
                                  "hscn"])
def test_epochs_follow_jax(name):
    """2 train epochs of make_epoch_fn (AdamW, lr 0.01, weight decay 5e-4),
    each followed by an eval epoch, from the JAX initial weights: every
    row's loss, score, true and mask, and the weights after."""
    jg, tg, jmodel, model, convert, loss_fn, node_level = _case(name)
    jds = jdd.DeviceDataset.build(jg)
    ds = tdd.DeviceDataset.build(tg, device="cpu")
    assert ds.slot == jds.slot and ds.adj is not None
    perms = [tdd.epoch_permutation(NUM_GRAPHS, BATCH, 7 + e)
             for e in range(2)]
    order = tdd.epoch_permutation(NUM_GRAPHS, BATCH, 0, shuffle=False)
    assert perms[0].shape == (6, BATCH) and (perms[0][-1] < 0).sum() == 2
    np.testing.assert_array_equal(perms[1], jdd.epoch_permutation(
        NUM_GRAPHS, BATCH, 8))

    tx = jax_build_opt("adamW", 0.01, 5e-4)
    example = jax.jit(jdd.assemble)(jds, jnp.asarray(order[0]))
    state = jax_init_state(jmodel, tx, example, seed=4)
    init = jax.tree_util.tree_map(np.asarray, state.params)
    jtrain, jeval = jdd.make_epoch_fn(jmodel, tx, loss_fn,
                                      node_level=node_level)
    jouts = []
    for perm in perms:
        state, outs = jtrain(state, jds, jnp.asarray(perm))
        jouts.append((outs, jeval(state, jds, jnp.asarray(order))))

    model.load_state_dict(convert(init))
    opt = build_optimizer(model.parameters(), "adamW", 0.01, 5e-4)
    train_epoch, eval_epoch = tdd.make_epoch_fn(
        model, opt, ds, BATCH, len(perms[0]), loss_fn,
        node_level=node_level, generator=torch.Generator().manual_seed(0))
    assert not train_epoch.capture and not eval_epoch.capture
    score_tol = 1e-4 if loss_fn == "l1" else 1e-5
    for epoch, (perm, (jtr, jev)) in enumerate(zip(perms, jouts)):
        got_train = [t.clone() for t in train_epoch(perm)]
        got_eval = eval_epoch(order)
        for kind, got, ref in (("train", got_train, jtr),
                               ("eval", got_eval, jev)):
            loss, score, true, mask = (t.numpy() for t in got)
            jloss, jscore, jtrue, jmask = (np.asarray(a) for a in ref)
            assert loss.shape == jloss.shape == (6,)
            assert_close(loss, jloss)
            if epoch == 0 and kind == "train":   # the initial weights
                assert_close(score[0], jscore[0])
            assert_close(score, jscore, score_tol)
            np.testing.assert_array_equal(true, jtrue)
            np.testing.assert_array_equal(mask, jmask)
    assert train_epoch.replays == eval_epoch.replays == 0
    final = convert(jax.tree_util.tree_map(np.asarray, state.params))
    assert set(final) == set(model.state_dict())
    for key, p in model.state_dict().items():
        assert_close(p, final[key], 1e-4)


def test_clustering_epochs_follow_jax(monkeypatch):
    """Device clustering (SCN mp_units [8, 8], K=3) on 12 peptides graphs
    in batches of 4, 2 epochs, from the JAX initial weights: every MinCUT
    step's loss, and the assignments written into the dataset, equal.  Every row is full: on a slotted batch with an empty
    graph slot the JAX gradient is NaN (tests/test_torch_scn.py,
    test_mincut_pool_empty_block_stays_finite).  The assignments are held
    on every slot, padded nodes too, as JAX writes them."""
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(PEPTIDES_HSCN)
        cfg.data.num_graphs, cfg.data.batch_size = 12, 4
        cfg.hscn.mp_units, cfg.hscn.num_clusters = [8, 8], 3
        cfg.hscn.cluster_epochs = 2
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    jdm, dm = JaxDataModule.from_config(jcfg.data), DataModule.from_config(
        cfg.data)
    assert jdm.enable_dense_slots() and dm.enable_dense_slots()
    jds = jdd.DeviceDataset.build(jdm.graphs, slot=jdm.slot_nodes,
                                  with_cluster=True)
    ds = tdd.DeviceDataset.build(dm.graphs, slot=dm.slot_nodes,
                                 device="cpu", with_cluster=True)
    jmodel = jax_build_scn(jcfg.hscn, jdm.num_features, jds.slot)
    params = jmodel.init(jax.random.PRNGKey(7), jdm.example_batch(),
                         train=False)["params"]

    class FixedInit:            # the JAX trainer starts from ``params``
        def init(self, *args, **kwargs):
            return {"params": params}

        def apply(self, *args, **kwargs):
            return jmodel.apply(*args, **kwargs)

    class Quiet:
        def info(self, msg):
            pass

        def wandb_log(self, d):
            pass

    # Each scan's per-row outputs on the JAX side, each epoch's on ours.
    jrows, rows = [], []
    scan = jax.lax.scan

    def spy_scan(f, init, xs, *args, **kwargs):
        carry, ys = scan(f, init, xs, *args, **kwargs)
        jax.debug.callback(lambda y: jrows.append(np.asarray(y)), ys,
                           ordered=True)
        return carry, ys

    class SpyRowSteps(tdd.RowSteps):
        def __call__(self, perm, step_seconds=None):
            outs = super().__call__(perm, step_seconds)
            rows.append(outs[0].clone().numpy())
            return outs

    monkeypatch.setattr(jax.lax, "scan", spy_scan)
    monkeypatch.setattr(clustering, "RowSteps", SpyRowSteps)
    jds = jclustering.train_clustering_device(
        Quiet(), jds, 4, FixedInit(), jcfg.hscn, jcfg.optim, seed=3)
    jax.effects_barrier()
    model = build_scn(cfg.hscn, dm.num_features, ds.slot)
    model.load_state_dict(scn_params_from_jax(params))
    ds, means = clustering.train_clustering_device(
        Quiet(), ds, 4, model, cfg.hscn, cfg.optim, seed=3)

    assert [r.shape for r in rows] == [r.shape for r in jrows] == [
        (3,), (3,), (3, 4, ds.slot)]
    for got, ref in zip(rows[:2], jrows[:2]):
        assert_close(got, ref)
    np.testing.assert_allclose(means, [r.mean() for r in rows[:2]],
                               rtol=1e-6)
    # Every slot row as JAX writes it, padded nodes included.
    np.testing.assert_array_equal(ds.cluster.numpy(), np.asarray(jds.cluster))


def test_replay_counts_add_a_capture_once_per_replay():
    """The launch accounting of a captured step: what a capture added to a
    counter is taken back (a capture launches nothing) and added again at
    every replay; counters the step leaves alone do not move."""

    class Counter:
        launches = 0

    a, b = Counter(), Counter()
    a.launches, b.launches = 5, 2
    counts = capture.ReplayCounts([a, b])
    with counts.capturing():
        a.launches += 3          # the step's Python increments, at capture
    assert (a.launches, b.launches) == (5, 2) and counts.deltas == (3, 0)
    for _ in range(4):
        counts.replayed()
    assert (a.launches, b.launches) == (17, 2)
    with pytest.raises(RuntimeError):
        with counts.capturing():     # a capture that fails still restores
            a.launches += 1
            raise RuntimeError("capture failed")
    assert a.launches == 17


def test_counted_kernels_are_the_port_wrappers():
    names = [k.__name__ for k in capture.counted_kernels()]
    assert names == ["csr_spmm", "edge_sddmm", "fused_gcn_fwd",
                     "fused_gcn_bwd", "spmm_mh", "sddmm_mh",
                     "segment_reduce", "graph_attn", "graph_attn_bwd"]
    assert all(isinstance(k.launches, int)
               for k in capture.counted_kernels())


def test_capture_is_for_the_card_only():
    """capture=None runs eagerly on the CPU; capture=True there raises
    (no fallback either way); the optimizer takes the capturable flag."""
    assert tdd.resolve_capture(None, "cpu") is False
    assert tdd.resolve_capture(False, "cpu") is False
    assert tdd.resolve_capture(None, torch.device("cuda")) is True
    with pytest.raises(ValueError, match="CUDA"):
        tdd.resolve_capture(True, "cpu")
    params = [torch.nn.Parameter(torch.zeros(2))]
    for t in ("adamW", "adam"):
        for flag in (False, True):
            opt = build_optimizer(params, t, 0.01, 0.0, capturable=flag)
            assert opt.opt.param_groups[0]["capturable"] is flag
