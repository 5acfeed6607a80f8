"""The port's LR schedules and gradient accumulation (train/optimizers.py)
and the schedule's horizon in both fits (train/loop.py) against the JAX
package's optax chains: ``learning_rate_schedule`` at every step against
optax's schedules; the lr each update uses (optax counts the updates
already applied: with warmup the first has lr 0); ``batch_accumulation``
2 and 3 against ``optax.MultiSteps`` through the one-program epoch
(``make_epoch_fn``), over epochs whose length k does not divide, under
decaying schedules whose horizon is ``ceil(total / k)``; the host fit's
and the device route's horizons; and 2 epochs of the device route
(``fit_on_device_dataset``, eager on the CPU) against JAX's ``fit_device``
on the peptides-struct GCN and GPS configs, shrunk.

Tolerances: schedules 1e-7 absolute (float32 lr values near 1e-3; XLA's
and torch's cos may round one ulp apart); losses rtol=1e-5; weights
1e-4*max|ref| (PERF.md section 2: Adam divides each gradient by its own
running size).
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
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.models.mpnn import build_mpnn as jax_build_mpnn
from graph_hscn_tpu.train import device_data as jdd
from graph_hscn_tpu.train import loop as jloop
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu.train.optimizers import \
    learning_rate_schedule as jax_schedule
from graph_hscn_tpu.utils.logger import Logger as JaxLogger
from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (gps_params_from_jax,
                                                 mpnn_params_from_jax)
from graph_hscn_tpu_torch.models.mpnn import MPNN, build_mpnn
from graph_hscn_tpu_torch.train import device_data as tdd
from graph_hscn_tpu_torch.train import loop
from graph_hscn_tpu_torch.train.optimizers import (build_optimizer,
                                                   learning_rate_schedule)
from graph_hscn_tpu_torch.utils.logger import Logger

ROOT = Path(__file__).parents[1]
GCN_STRUCT = ROOT / "configs" / "GCN" / "peptides_struct_GCN.yaml"
GPS_STRUCT = ROOT / "configs" / "GPS" / "peptides_struct_GPS.yaml"
NUM_GRAPHS, BATCH = 22, 5     # 5 rows an epoch, the last with 3 dummies


def assert_close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=1e-5,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-30))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("lr,schedule,warmup,total", [
    (0.001, "constant", 7, None),
    (0.001, "cosine", 10, 60),
    (0.01, "cosine", 0, 40),
    (0.001, "cosine", 100, 26),    # horizon shorter than the warmup
    (0.003, "linear", 6, 50),
    (0.003, "linear", 0, 30),
])
def test_schedule_matches_optax_at_every_step(lr, schedule, warmup, total):
    """The port's schedule against the JAX package's optax one at every
    count 0 .. past the horizon, within 1e-7; evaluated on a float32
    tensor of counts, as the captured step evaluates it on the card."""
    ref_fn = jax_schedule(lr, schedule, warmup, total)
    fn = learning_rate_schedule(lr, schedule, warmup, total)
    steps = max(total or 0, warmup) + 20
    ref = np.array([float(ref_fn(jnp.asarray(i, jnp.int32)))
                    for i in range(steps)])
    got = fn(torch.arange(steps, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)


def test_constant_schedule_stays_a_float():
    """The constant schedule without warmup is the float lr in both
    packages, and the optimizer keeps it in its param groups untouched:
    the constant-lr paths do the arithmetic they did before schedules."""
    assert learning_rate_schedule(0.01) == jax_schedule(0.01) == 0.01
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = build_optimizer(params, "adamW", 0.01, 5e-4)
    assert opt.schedule is None
    params[0].grad = torch.ones(3)
    opt.step()
    assert opt.opt.param_groups[0]["lr"] == 0.01


@pytest.mark.parametrize("k", [1, 2, 3])
def test_lr_of_each_update(k):
    """The lr each applied update uses is the schedule at the count of
    updates already applied (0 first: with warmup the first update leaves
    the weights as they are), advancing once every k mini-batches over a
    horizon of ceil(total / k) updates; AdamW with cosine decay."""
    total, warmup = 12, 2
    params = [torch.nn.Parameter(torch.linspace(-1, 1, 4))]
    start = params[0].detach().clone()
    opt = build_optimizer(params, "adamW", 0.01, 5e-4, batch_accumulation=k,
                          schedule="cosine", warmup_steps=warmup,
                          total_steps=total)
    ref = jax_schedule(0.01, "cosine", warmup, -(-total // k))
    applied = 0
    for i in range(total):
        applies = i % k == k - 1
        before = params[0].detach().clone()
        params[0].grad = torch.full((4,), 0.5 + i)
        opt.step()
        assert opt.minibatches == i + 1
        if not applies:    # accumulated only
            assert torch.equal(params[0].detach(), before)
            continue
        lr = opt.opt.param_groups[0]["lr"]
        assert abs(lr - float(ref(applied))) <= 1e-7
        if applied == 0:
            assert lr == 0.0 and torch.equal(params[0].detach(), start)
        applied += 1
    assert float(opt.updates) == applied == total // k


def _epoch_case():
    jg = js.make_peptides_func(num_graphs=NUM_GRAPHS, seed=71, mean_nodes=24)
    tg = ts.make_peptides_func(num_graphs=NUM_GRAPHS, seed=71, mean_nodes=24)
    kw = dict(conv_type="gcn", activation="relu", num_features=9,
              hidden_channels=16, num_classes=10, num_layers=2)
    return jg, tg, JaxMPNN(**kw), MPNN(**kw)


@pytest.mark.parametrize("k,optim_type,schedule,warmup,clip", [
    (2, "adamW", "cosine", 2, False),
    (3, "adamW", "cosine", 1, True),
    (2, "adam", "linear", 0, False),
    (3, "adagrad", "constant", 2, False),
])
def test_accumulation_follows_optax_multisteps(k, optim_type, schedule,
                                               warmup, clip):
    """``batch_accumulation`` k through make_epoch_fn against JAX's
    make_epoch_fn with optax.MultiSteps: 2 epochs of 5 rows (k does not
    divide 5, so the accumulator carries across the epoch boundary), the
    schedule's horizon 10 mini-batches (ceil(10 / k) updates): every row's
    loss (the loss before the row's step), and the weights after."""
    jg, tg, jmodel, model = _epoch_case()
    jds = jdd.DeviceDataset.build(jg)
    ds = tdd.DeviceDataset.build(tg, device="cpu")
    perms = [tdd.epoch_permutation(NUM_GRAPHS, BATCH, 3 + e)
             for e in range(2)]
    assert len(perms[0]) == 5 and 5 % k
    opt_kw = dict(batch_accumulation=k, clip_grad_norm=clip,
                  schedule=schedule, warmup_steps=warmup, total_steps=10)
    tx = jax_build_opt(optim_type, 0.01, 5e-4, **opt_kw)
    example = jax.jit(jdd.assemble)(jds, jnp.asarray(perms[0][0]))
    state = jax_init_state(jmodel, tx, example, seed=2)
    init = np_tree(state.params)
    jtrain, _ = jdd.make_epoch_fn(jmodel, tx, "cross_entropy")
    jlosses = []
    for perm in perms:
        state, outs = jtrain(state, jds, jnp.asarray(perm))
        jlosses.append(np.asarray(outs[0]))

    model.load_state_dict(mpnn_params_from_jax(init))
    opt = build_optimizer(model.parameters(), optim_type, 0.01, 5e-4,
                          **opt_kw)
    train_epoch, _ = tdd.make_epoch_fn(model, opt, ds, BATCH, 5,
                                       "cross_entropy")
    for perm, jl in zip(perms, jlosses):
        assert_close(train_epoch(perm)[0].numpy(), jl)
    assert opt.minibatches == 10 and float(opt.updates) == 10 // k
    final = mpnn_params_from_jax(np_tree(state.params))
    for name, p in model.state_dict().items():
        assert_close(p.numpy(), final[name], 1e-4)


def _recorded_horizons(monkeypatch):
    """Spies on both packages' build_optimizer inside their fit loops:
    each call's total_steps, in order."""
    seen = {"jax": [], "torch": []}
    real_j, real_t = jloop.build_optimizer, loop.build_optimizer

    def spy_j(*args, **kw):
        seen["jax"].append(kw.get("total_steps"))
        return real_j(*args, **kw)

    def spy_t(*args, **kw):
        seen["torch"].append(kw.get("total_steps"))
        return real_t(*args, **kw)

    monkeypatch.setattr(jloop, "build_optimizer", spy_j)
    monkeypatch.setattr(loop, "build_optimizer", spy_t)
    return seen


def _configs(path, num_graphs=40, **changes):
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(path)
        cfg.data.num_graphs = num_graphs
        cfg.data.batch_size = 8
        cfg.mpnn.dropout = 0.0
        cfg.training.epochs = 2
        cfg.training.eval_period = 1
        for key, value in changes.items():
            section, field = key.split(".")
            setattr(getattr(cfg, section), field, value)
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_host_fit_horizon_is_jax(schedule, monkeypatch):
    """The host fit's schedule horizon: epochs x the training batches of
    epoch 0, by one counting pass over the packer when the schedule
    decays (none for the constant one), as the JAX fit computes it."""
    seen = _recorded_horizons(monkeypatch)
    jcfg, cfg = _configs(GCN_STRUCT, **{"optim.schedule": schedule,
                                        "optim.warmup_steps": 2})
    dms = [JaxDataModule.from_config(jcfg.data),
           DataModule.from_config(cfg.data)]
    jmodel = jax_build_mpnn(jcfg.mpnn, 9, 11)
    jloop.fit(jmodel, lambda e: dms[0].train_batches(epoch_seed=e),
              dms[0].eval_batches("val"), dms[0].eval_batches("test"),
              jcfg.optim, jcfg.training, JaxLogger(metric_name="mae"))
    model = build_mpnn(cfg.mpnn, 9, 11)
    loop.fit(model, lambda e: dms[1].train_batches(epoch_seed=e),
             dms[1].eval_batches("val"), dms[1].eval_batches("test"),
             cfg.optim, cfg.training, Logger(metric_name="mae"), "cpu")
    n_batches = sum(1 for _ in dms[1].train_batches(epoch_seed=0))
    want = None if schedule == "constant" else 2 * n_batches
    assert seen["torch"] == seen["jax"] == [want]


def _device_route(path, convert, **changes):
    """2 epochs of fit_device on both packages from the same initial
    weights, dropout off, at a config's shrunk width: (JAX result, port
    result, final weights of each in the port's names)."""
    jcfg, cfg = _configs(path, **changes)
    jdm = JaxDataModule.from_config(jcfg.data)
    dm = DataModule.from_config(cfg.data)
    assert jdm.enable_dense_slots() and dm.enable_dense_slots()
    jmodel = jax_build_mpnn(jcfg.mpnn, jdm.num_features, jdm.num_classes)
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       num_edge_features=dm.num_edge_features)
    splits = [[dmx.split(s) for s in ("train", "val", "test")]
              for dmx in (jdm, dm)]
    kw = dict(batch_size=cfg.data.batch_size, slot=dm.slot_nodes,
              compat_sigmoid_score=cfg.compat.sigmoid_regression_score)
    jres = jloop.fit_device(jmodel, *splits[0], optim_cfg=jcfg.optim,
                            training_cfg=jcfg.training,
                            logger=JaxLogger(metric_name="mae"), **kw)
    # fit_device's initial weights: init_state on an assembled batch with
    # the training seed (the weights depend on the shapes only).
    jds = jdd.DeviceDataset.build(sum(splits[0], []), slot=dm.slot_nodes)
    example = jax.jit(jdd.assemble)(jds, jnp.arange(8, dtype=jnp.int32))
    init = jax_init_state(jmodel, jax_build_opt("adamW", 0.01, 0.0),
                          example, seed=cfg.training.seed).params
    model.load_state_dict(convert(np_tree(init)))
    tres = loop.fit_device(model, *splits[1], optim_cfg=cfg.optim,
                           training_cfg=cfg.training,
                           logger=Logger(metric_name="mae"), device="cpu",
                           **kw)
    return (jres, tres, convert(np_tree(jres.state.params)),
            model.state_dict())


@pytest.mark.parametrize("case", ["gcn_struct", "gps_struct_accumulate"])
def test_device_route_follows_jax_fit_device(case, monkeypatch):
    """2 epochs of the device route (eager row by row on the CPU) against
    JAX's fit_device: every epoch's train, val and test loss within 1e-5
    relative, and the horizon both pass their optimizer (epochs x
    ceil(n_train / B)).  ``gcn_struct``: the shipped
    configs/GCN/peptides_struct_GCN.yaml (L1 loss, sigmoid regression
    score) at 40 graphs; ``gps_struct_accumulate``: the shipped
    configs/GPS/peptides_struct_GPS.yaml (GatedGCN local module, 3 edge
    features, cosine schedule) at hidden 16, 2 layers, 2 heads, with a
    3-step warmup and batch_accumulation 2 (4 rows an epoch)."""
    seen = _recorded_horizons(monkeypatch)
    if case == "gcn_struct":
        jres, tres, final, got = _device_route(GCN_STRUCT,
                                               mpnn_params_from_jax)
    else:
        jres, tres, final, got = _device_route(
            GPS_STRUCT, gps_params_from_jax,
            **{"mpnn.hidden_channels": 16, "mpnn.num_layers": 2,
               "mpnn.num_heads": 2, "optim.warmup_steps": 3,
               "optim.batch_accumulation": 2})
    assert seen["torch"] == seen["jax"] == [2 * -(-32 // 8)]
    assert tres.epochs_run == jres.epochs_run == 2
    for th, jh in zip(tres.history, jres.history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-5)
    for name, p in got.items():
        if name.endswith("attn.key.bias"):
            continue     # zero gradient in exact arithmetic: Adam's noise
        assert_close(p.numpy(), final[name], 1e-4)
