"""The port's checkpoints, resume and eval/predict mode
(train/checkpoint.py, train/loop.py, runner.py:run_eval, main.py) against
the JAX package's: the six tests of tests/test_checkpoint.py carried over,
a resumed fit from carried-over weights against JAX's resumed fit, resumed
runs against uninterrupted ones (lr, accumulation, dropout bits, every
route), and two behaviours of the JAX ``run_eval`` the port copies.

Tolerances: a resumed fit against JAX's, 1e-5 relative (the train step's
own criterion, tests/test_torch_train.py); eval-only against the fit's best
val loss, rtol=1e-5 and atol=1e-6 (JAX's own, tests/test_checkpoint.py);
a resumed port run against an uninterrupted one on the CPU, bit for bit
(the same arithmetic on the same state).
"""

import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from graph_hscn_tpu.config.config import parse_config as jax_parse_config
from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
from graph_hscn_tpu.models.mpnn import build_mpnn as jax_build_mpnn
from graph_hscn_tpu.runner import run_eval as jax_run_eval
from graph_hscn_tpu.runner import run_experiment as jax_run_experiment
from graph_hscn_tpu.train import clustering as jax_clustering
from graph_hscn_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from graph_hscn_tpu.train.loop import fit as jax_fit
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu.utils.logger import Logger as JaxLogger
from graph_hscn_tpu_torch import hscn_pipeline, runner
from graph_hscn_tpu_torch.config.config import load_config, parse_config
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import mpnn_params_from_jax
from graph_hscn_tpu_torch.models.mpnn import build_mpnn
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.runner import run_eval, run_experiment
from graph_hscn_tpu_torch.train.checkpoint import Checkpointer
from graph_hscn_tpu_torch.train.loop import fit
from graph_hscn_tpu_torch.train.optimizers import build_optimizer
from graph_hscn_tpu_torch.utils.logger import Logger

ROOT = Path(__file__).parents[1]
CONFIGS = ROOT / "configs"


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
def restore_backend():
    prev = spmm.get_backend()
    try:
        yield
    finally:
        spmm.set_backend(prev)


def _raw(checkpoint_dir, epochs=4, eval_period=2, fused="auto", **extra):
    """The small peptides GCN of tests/test_checkpoint.py, as a raw config
    both packages parse."""
    raw = {
        "data": {"dataset_name": "peptides_func", "batch_size": 8,
                 "num_graphs": 32},
        "mp": {"conv_type": "gcn", "activation": "relu",
               "hidden_channels": 16, "num_layers": 2, "dropout": 0.0},
        "optim": {"optim_type": "adamW", "lr": 0.01, "weight_decay": 5e-4},
        "training": {"model_type": "gcn", "use_wandb": False,
                     "loss_fn": "cross_entropy", "metric": "ap",
                     "max_epochs": epochs, "eval_period": eval_period,
                     "min_delta": 0.0, "patience": 50,
                     "checkpoint_dir": str(checkpoint_dir)},
        "runtime": {"fused_stack": fused},
    }
    for key, value in extra.items():
        raw.setdefault(key, {}).update(value)
    return raw


def _best_val(result) -> float:
    return min(h["validation_loss"] for h in result.history
               if "validation_loss" in h)


def test_checkpoint_roundtrip(tmp_path):
    """A fit with a checkpointer leaves best and latest snapshots; latest
    restores into a fresh model as the fit's final weights, and best as
    weights other than the fresh model's."""
    cfg = parse_config(_raw(tmp_path / "ckpt", epochs=4, eval_period=2))
    cfg.training.checkpoint_every = 1
    result = run_experiment(cfg, device="cpu")
    ck = Checkpointer(tmp_path / "ckpt")
    assert ck.has("best") and ck.has("latest")
    assert ck.meta("latest") == {"epoch": 3}
    assert int(ck.meta("best")["epoch"]) >= 0
    fresh = build_mpnn(cfg.mpnn, 9, 10, generator=torch.Generator()
                       .manual_seed(123))
    latest, _ = ck.restore("latest")
    fresh.load_state_dict(latest["model"])
    for name, p in result.model.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[name].numpy(),
                                      p.numpy())
    best, meta = ck.restore("best")
    assert set(best) == {"model", "optimizer", "generator", "step"}
    rows = result.num_train_steps // 4
    assert best["step"] == rows * (int(meta["epoch"]) + 1)
    assert not np.allclose(best["model"]["convs.0.weight"].numpy(),
                           build_mpnn(cfg.mpnn, 9, 10).state_dict()
                           ["convs.0.weight"].numpy())


class _Interrupted(Exception):
    pass


@pytest.fixture
def interrupt_after(monkeypatch):
    """``interrupt_after(epoch)``: run_experiment's fits stop with an
    exception right after saving the latest snapshot of ``epoch``, as a
    run killed there would."""

    def arm(epoch: int):
        class Stopping(Checkpointer):
            def save_latest(self, state, e):
                super().save_latest(state, e)
                if e == epoch:
                    raise _Interrupted

        monkeypatch.setattr(runner, "Checkpointer", Stopping)

    return arm


def _route_cfg(path, checkpoint_dir, changes):
    cfg = load_config(path)
    cfg.data.num_graphs, cfg.data.batch_size = 40, 8
    cfg.training.epochs, cfg.training.eval_period = 4, 1
    cfg.training.checkpoint_every, cfg.training.patience = 1, 100
    cfg.training.checkpoint_dir = str(checkpoint_dir)
    for key, value in changes.items():
        section, field = key.split(".")
        setattr(getattr(cfg, section), field, value)
    return cfg


@pytest.mark.parametrize("path,changes", [
    # The device route (eager on the CPU), dropout 0.2.
    ("GCN/peptides_func_GCN.yaml", {}),
    # The host loop on sparse batches, the kernel's plain versions.
    ("GCN/voc_superpixels_GCN_sparse.yaml", {"runtime.spmm_backend":
                                             "pallas", "data.num_graphs": 16,
                                             "mpnn.num_layers": 2}),
    # Cosine schedule with warmup, accumulation over 3 rows (5 an epoch).
    ("GPS/peptides_struct_GPS.yaml", {"optim.batch_accumulation": 3,
                                      "optim.warmup_steps": 4,
                                      "mpnn.num_layers": 1}),
    # The HSCN pipeline: clustering again first, then the HSCN's snapshot.
    ("HSCN/peptides_func_HSCN.yaml", {"hscn.cluster_epochs": 1}),
    # Trainable SignNet inside the captured route's model.
    ("GCN/peptides_func_GCN_PE.yaml", {"compat.frozen_random_signnet":
                                       False, "data.num_graphs": 24}),
])
def test_auto_resume_follows_the_uninterrupted_run(
        path, changes, tmp_path, interrupt_after, restore_backend):
    """A 4-epoch run killed after epoch 1's latest snapshot, then run
    again with the same checkpoint_dir (a fresh model, optimizer and
    Checkpointer): it starts at epoch 2, never repeats one, and its train
    losses and final weights equal an uninterrupted run's bit for bit."""
    full = run_experiment(_route_cfg(CONFIGS / path, tmp_path / "full",
                                     changes), device="cpu")
    cfg = _route_cfg(CONFIGS / path, tmp_path / "cut", changes)
    interrupt_after(1)
    with pytest.raises(_Interrupted):
        run_experiment(cfg, device="cpu")
    assert Checkpointer(tmp_path / "cut").meta("latest") == {"epoch": 1}
    resumed = run_experiment(cfg, device="cpu")
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    assert resumed.epochs_run == 4
    assert ([h["train_loss"] for h in resumed.history]
            == [h["train_loss"] for h in full.history[2:]])
    for name, p in resumed.model.state_dict().items():
        np.testing.assert_array_equal(
            p.numpy(), full.model.state_dict()[name].numpy())


def test_resumed_lr_and_accumulation_rows_match(tmp_path):
    """The optimizer wrapper's state through a checkpoint file mid-run:
    cosine with warmup and accumulation over 3 rows, cut after row 7 (in
    the middle of an accumulation); every later row's lr, its
    accumulate-or-apply choice and the weights equal the uninterrupted
    run's."""
    torch.manual_seed(0)
    data = [torch.randn(4, 3) for _ in range(14)]

    def run(rows, model=None, state=None):
        model = model or torch.nn.Linear(3, 2)
        opt = build_optimizer(model.parameters(), "adamW", 0.01, 5e-4,
                              batch_accumulation=3, clip_grad_norm=True,
                              schedule="cosine", warmup_steps=2,
                              total_steps=14)
        if state is not None:
            opt.load_state_dict(state)
        seen = []
        for x in rows:
            applies = opt.next_applies()
            opt.zero_grad()
            model(x).square().mean().backward()
            opt.step(applies)
            seen.append((applies, opt.opt.param_groups[0]["lr"]))
        return model, opt, seen

    torch.manual_seed(1)
    full_model, _, full_seen = run(data)
    torch.manual_seed(1)
    model, opt, _ = run(data[:7])
    ck = Checkpointer(tmp_path)
    ck.save_latest({"model": model.state_dict(),
                    "optimizer": opt.state_dict()}, epoch=0)
    state, _ = ck.restore("latest")
    fresh = torch.nn.Linear(3, 2)
    fresh.load_state_dict(state["model"])
    fresh, opt2, seen = run(data[7:], fresh, state["optimizer"])
    assert opt2.minibatches == 14 and float(opt2.updates) == 4
    assert seen == full_seen[7:]
    for a, b in zip(fresh.parameters(), full_model.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    with pytest.raises(RuntimeError, match="before its first step"):
        opt2.load_state_dict(state["optimizer"])


def test_resumed_fit_follows_jax(tmp_path, restore_backend):
    """2 epochs, then a resumed 2 more, in both packages from the same
    initial weights (dropout 0, the host fit on sparse batches): the
    resumed epochs' train and val losses within 1e-5 relative of JAX's."""
    raw = _raw(None, fused="off")
    raw["data"] = {"dataset_name": "voc_superpixels", "batch_size": 4,
                   "num_graphs": 12}
    raw["training"].update(loss_fn="softmax_cross_entropy", metric="f1",
                           eval_period=1)
    jcfg, tcfg = jax_parse_config(raw), parse_config(raw)
    jdm = JaxDataModule.from_config(jcfg.data)
    jmodel = jax_build_mpnn(jcfg.mpnn, jdm.num_features, jdm.num_classes,
                            readout="none")
    tx = jax_build_opt("adamW", 0.01, 5e-4)
    example = next(iter(jdm.train_batches(epoch_seed=jdm.seed)))
    init = jax.tree_util.tree_map(np.asarray, jax_init_state(
        jmodel, tx, example, seed=jcfg.training.seed).params)

    def jax_run(epochs):
        jcfg.training.epochs = epochs
        jcfg.training.checkpoint_every = 1
        return jax_fit(
            jmodel, lambda e: jdm.train_batches(epoch_seed=jdm.seed + e),
            jdm.eval_batches("val"), jdm.eval_batches("test"), jcfg.optim,
            jcfg.training, JaxLogger(metric_name="f1"),
            node_level=True, checkpointer=JaxCheckpointer(tmp_path / "j"))

    spmm.set_backend("pallas")
    tdm = DataModule.from_config(tcfg.data)
    tdm.with_spmm_plan = True

    def port_run(epochs):
        tcfg.training.epochs = epochs
        tcfg.training.checkpoint_every = 1
        model = build_mpnn(tcfg.mpnn, tdm.num_features, tdm.num_classes,
                           readout="none")
        model.load_state_dict(mpnn_params_from_jax(init))
        return fit(
            model, lambda e: tdm.train_batches(epoch_seed=tdm.seed + e),
            tdm.eval_batches("val"), tdm.eval_batches("test"), tcfg.optim,
            tcfg.training, Logger(metric_name="f1"), "cpu",
            node_level=True, checkpointer=Checkpointer(tmp_path / "t"))

    jax_run(2)
    port_run(2)
    jres, tres = jax_run(4), port_run(4)
    assert [h["epoch"] for h in tres.history] == [2, 3]
    assert [h["epoch"] for h in jres.history] == [2, 3]
    for key in ("train_loss", "validation_loss"):
        np.testing.assert_allclose([h[key] for h in tres.history],
                                   [h[key] for h in jres.history],
                                   rtol=1e-5)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_eval_only_mode(fused, tmp_path):
    """run_eval restores the best snapshot and reproduces the training
    run's best val loss (the device route trains, host batches evaluate);
    ``fused: on`` restores the FusedDenseGCN's parameters through
    run_eval's fused branch (the kernels' plain versions on the CPU)."""
    cfg = parse_config(_raw(tmp_path / "ckpt", fused=fused))
    result = run_experiment(cfg, device="cpu")
    assert type(result.model).__name__ == ("FusedDenseGCN" if fused == "on"
                                           else "MPNN")
    scores = run_eval(cfg, which="best", device="cpu")
    assert set(scores) == {"val", "test"}
    assert np.isfinite(scores["test"]["ap"])
    np.testing.assert_allclose(scores["val"]["loss"], _best_val(result),
                               rtol=1e-5, atol=1e-6)


def test_predict_export(tmp_path, monkeypatch):
    """``main --eval best --predict OUT.npz`` on the CPU writes each
    split's scores and targets over its real rows; --predict without
    --eval is a parser error; the eval of an edge-partitioned config of
    this graph-level task raises, as its training does (node-level tasks
    only; the edge-partitioned eval is tests/test_torch_sharded_gcn.py)."""
    import yaml

    from graph_hscn_tpu_torch import main as cli
    raw = _raw(tmp_path / "ck", epochs=2, eval_period=1)
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(yaml.safe_dump(raw))
    monkeypatch.setattr(cli, "LOGS_DIR", tmp_path / "logs")
    out = tmp_path / "preds.npz"
    for argv in (["--cfg", str(cfg_file)],
                 ["--cfg", str(cfg_file), "--eval", "best", "--predict",
                  str(out)]):
        monkeypatch.setattr(sys, "argv", ["main", "--device", "cpu", *argv])
        cli.main()
    z = np.load(out)
    assert set(z.files) == {"val_scores", "val_targets", "test_scores",
                            "test_targets"}
    dm = DataModule.from_config(parse_config(raw).data)
    for split in ("val", "test"):
        n = len(dm.split_idx[split])
        assert z[f"{split}_scores"].shape == (n, 10)
        assert z[f"{split}_targets"].shape == (n, 10)
        assert np.isfinite(z[f"{split}_scores"]).all()
    monkeypatch.setattr(sys, "argv", ["main", "--cfg", str(cfg_file),
                                      "--predict", str(out)])
    with pytest.raises(SystemExit):
        cli.main()
    ep = parse_config(_raw(tmp_path / "ck", mesh={
        "axes": ["data"], "shape": [1], "edge_partition": True}))
    with pytest.raises(ValueError, match="node-level"):
        run_eval(ep, device="cpu")


def test_async_write_roundtrip(tmp_path):
    """Async (default) writes land as sync writes do, reads fence on the
    write in flight, back-to-back saves keep their order, and a failing
    background write re-raises at the next fence."""
    rng = np.random.default_rng(0)
    state = {"model": {"w": torch.from_numpy(rng.normal(size=(4, 3))
                                             .astype(np.float32))},
             "optimizer": {"m": torch.zeros(4, 3), "minibatches": 7},
             "generator": torch.Generator().manual_seed(1).get_state(),
             "step": 7}
    ck_async = Checkpointer(tmp_path / "a")
    ck_async.save_latest(state, epoch=3)
    assert ck_async.has("latest")
    assert ck_async.meta("latest") == {"epoch": 3}
    restored, meta = ck_async.restore("latest")
    np.testing.assert_array_equal(restored["model"]["w"].numpy(),
                                  state["model"]["w"].numpy())
    assert restored["step"] == 7 and meta == {"epoch": 3}
    assert restored["optimizer"]["minibatches"] == 7

    ck_sync = Checkpointer(tmp_path / "s", async_writes=False)
    ck_sync.save_latest(state, epoch=3)
    r2, _ = ck_sync.restore("latest")
    assert torch.equal(r2["generator"], restored["generator"])

    for epoch in range(4, 8):
        ck_async.save_latest(state, epoch=epoch)
    assert ck_async.meta("latest") == {"epoch": 7}
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "latest", "latest.meta.json"]

    ck_bad = Checkpointer(tmp_path / "b")
    shutil.rmtree(tmp_path / "b")
    ck_bad.save_latest(state, epoch=0)
    with pytest.raises(Exception):
        ck_bad.wait()
    ck_bad.wait()                      # the error is raised once
    assert not ck_bad.has("latest")


def _pe_fused_raw(checkpoint_dir):
    raw = _raw(checkpoint_dir, epochs=1, eval_period=1, fused="on",
                pe={"use": True, "dim_in": 9, "dim_emb": 9, "dim_pe": 4,
                    "eig_max_freqs": 8, "phi_hidden_dim": 8,
                    "phi_out_dim": 4},
                compat={"frozen_random_signnet": False})
    raw["data"]["num_graphs"] = 16      # the fused kernel interprets in JAX
    return raw


def test_fused_trainable_signnet_snapshot_cannot_be_evaluated(tmp_path):
    """A JAX behaviour the port copies (ROADMAP queue C, not port faults):
    run_experiment wraps the fused stack in a trainable SignNet
    (runner.py:142-145), run_eval wraps only build_mpnn's model
    (:403-406), so the fused stack's snapshot does not restore in eval
    mode, in either package."""
    cfg = parse_config(_pe_fused_raw(tmp_path / "t"))
    result = run_experiment(cfg, device="cpu")
    assert type(result.model).__name__ == "EncodedModel"
    with pytest.raises(RuntimeError, match="encoder"):
        run_eval(cfg, device="cpu")
    jcfg = jax_parse_config(_pe_fused_raw(tmp_path / "j"))
    jax_run_experiment(jcfg)
    with pytest.raises(Exception):
        jax_run_eval(jcfg)


def test_eval_reclusters_on_the_host(tmp_path, monkeypatch):
    """A JAX behaviour the port copies (ROADMAP queue C, not port faults):
    an HSCN trained on the device route (train_clustering_device) is
    evaluated after the host clustering (train_clustering), in both
    packages.  The two routes batch the graphs in different orders
    (dm.graphs shuffled on the host; train|val|test on the device), so
    their clusters can differ once a dataset spans several batches."""
    raw = {"data": {"dataset_name": "peptides_func", "batch_size": 8,
                    "num_graphs": 24},
           "hscn": {"num_clusters": 4, "cluster_epochs": 2,
                    "mp_units": [8], "hidden_channels": 8, "num_layers": 1},
           "optim": {"optim_type": "adamW", "lr": 0.01,
                     "weight_decay": 5e-4},
           "training": {"model_type": "hscn", "use_wandb": False,
                        "loss_fn": "cross_entropy", "metric": "ap",
                        "max_epochs": 1, "eval_period": 1,
                        "checkpoint_dir": str(tmp_path / "t")}}
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, out))
            return out

        monkeypatch.setattr(module, name, wrapped)

    for module in (hscn_pipeline, jax_clustering):
        spy(module, "train_clustering")
        spy(module, "train_clustering_device")
    cfg = parse_config(raw)
    run_experiment(cfg, device="cpu")
    run_eval(cfg, device="cpu")
    raw["training"]["checkpoint_dir"] = str(tmp_path / "j")
    jcfg = jax_parse_config(raw)
    jax_run_experiment(jcfg)
    jax_run_eval(jcfg)
    names = [n for n, _ in calls]
    assert names == ["train_clustering_device", "train_clustering"] * 2
    # The port's two routes: the device route's clusters (in its dataset,
    # train|val|test order) against the host route's (dm.graphs order).
    (_, (ds, _)), (_, (host, _)) = calls[:2]
    dm = DataModule.from_config(cfg.data)
    order = np.concatenate([dm.split_idx[s] for s in ("train", "val",
                                                      "test")])
    device_clusters = ds.cluster.numpy()
    same = [np.array_equal(device_clusters[i, :dm.graphs[g].num_nodes],
                           host[g]) for i, g in enumerate(order)]
    assert len(same) == 24
    print(f"graphs clustered alike by the two routes: {sum(same)} of 24")


def test_logger_warns_without_wandb(tmp_path, monkeypatch):
    """training.use_wandb with no wandb installed: one warning, and the run
    goes on (the JAX logger's utils/logger.py:35-41); with wandb installed
    the port raises, since it does not log to it."""
    import importlib.util

    from graph_hscn_tpu_torch.utils import logger as logger_mod
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    log = Logger(log_file=tmp_path / "l.log", use_wandb=True)
    log.finish()
    text = (tmp_path / "l.log").read_text()
    assert text.count("WARNING") == 1 and "wandb unavailable" in text
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: object())
    with pytest.raises(NotImplementedError, match="item 12"):
        logger_mod.Logger(use_wandb=True)
