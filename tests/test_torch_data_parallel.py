"""The port's data-parallel training (graph_hscn_tpu_torch/parallel/
data_parallel.py) and ``runtime.multihost`` (parallel/mesh.py) against
the JAX package's ``data_parallel.py`` and ``maybe_init_distributed``.

- ``pack_for_devices``: every device's sub-batch array-equal to JAX's
  stacked batch (balance, the empty-device placeholder on slots, edge
  features).
- The DP step at D = 1 (one gloo rank in this process), 2 and 4 (gloo
  ranks, ``tests/torch_dist.py``) against JAX's ``make_dp_train_step`` at
  the same D on the CPU mesh, from JAX's init: the loss within 1e-5
  relative, the summed gradients within 1e-4 * max|ref|, 3 AdamW steps'
  losses within 1e-4 relative and the weights by
  ``sharded_jax.assert_post_adam``; the dense-slot GCN, the sparse GCN
  with its CSR plans (the kernels' plain versions), GatedGCN with edge
  features and a final partial batch with empty devices.  The DP step at
  D ranks equals the port's single-device step on the concatenated batch
  (loss 1e-5 relative, gradients 1e-4 * max|ref|), and so does the eval
  step JAX's.
- The shrunk ``configs/GCN/peptides_func_GCN_dp8.yaml`` through
  ``run_experiment`` at ``mesh.shape: [2]`` follows JAX's ``fit_dp``
  epoch by epoch (1e-4 relative); single-process ``run_eval`` scores the
  DP snapshot; on one rank the shipped config raises JAX's ValueError.
- ``runtime.multihost``: the launcher variables of torchrun and of the
  JAX package and the three modes; the JAX package's variables start the
  port on two processes.
"""

from __future__ import annotations

import copy
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import sharded_jax
import torch_dist
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.batching import PadBudget as JaxBudget
from graph_hscn_tpu.models.gatedgcn import GatedGCNNet as JaxGatedGCN
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.parallel import data_parallel as jdp
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_opt
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.batching import PadBudget
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (gatedgcn_params_from_jax,
                                                 mpnn_params_from_jax)
from graph_hscn_tpu_torch.parallel import data_parallel as pdp
from graph_hscn_tpu_torch.parallel import mesh as pmesh
from graph_hscn_tpu_torch.runner import run_eval, run_experiment
from sharded_jax import assert_post_adam, run_ranks

ROOT = Path(__file__).parents[1]
DP8 = ROOT / "configs" / "GCN" / "peptides_func_GCN_dp8.yaml"
FIELDS = ("node_feat", "senders", "receivers", "node_graph", "n_node",
          "n_edge", "node_mask", "edge_mask", "graph_mask", "edge_feat",
          "edge_weight", "y", "node_y", "node_pe", "eigvals", "eigvecs",
          "cluster")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _graphs(maker: str, **kw):
    return getattr(js, maker)(**kw), getattr(ts, maker)(**kw)


def _slot(graphs) -> int:
    return ((max(g.num_nodes for g in graphs) + 7) // 8) * 8


@pytest.mark.parametrize("case", ["balance", "empty_slotted",
                                  "edge_features"])
def test_pack_for_devices_equals_jax(case):
    """Every device's sub-batch equals JAX's row of the stacked batch,
    array for array: 33 graphs over 8 devices (no device more than 2
    graphs above another), 3 graphs on slots over 8 (5 placeholders,
    fully masked), edge features over 8."""
    maker, kw, bs, slot = {
        "balance": ("make_peptides_func", dict(num_graphs=33, seed=8,
                                               mean_nodes=30), 6, False),
        "empty_slotted": ("make_peptides_func", dict(num_graphs=3, seed=9,
                                                     mean_nodes=30), 1, True),
        "edge_features": ("make_peptides_struct", dict(num_graphs=16,
                                                       seed=5), 2, False),
    }[case]
    jg, tg = _graphs(maker, **kw)
    slot = _slot(tg) if slot else None
    want = jdp.pack_for_devices(jg, 8, JaxBudget.for_dataset(jg, bs),
                                slot_nodes=slot)
    got = pdp.pack_for_devices(tg, 8, PadBudget.for_dataset(tg, bs),
                               slot_nodes=slot)
    assert len(got) == 8
    for d, b in enumerate(got):
        for name in FIELDS:
            ref = getattr(want, name)
            if ref is None:
                assert getattr(b, name) is None, name
            else:
                np.testing.assert_array_equal(getattr(b, name),
                                              np.asarray(ref)[d], name)
        assert b.slot == slot
    counts = np.array([int(b.graph_mask.sum()) for b in got])
    assert counts.sum() == kw["num_graphs"]
    if case == "balance":
        assert counts.max() - counts.min() <= 2
    if case == "empty_slotted":
        assert (counts == 0).sum() == 5
        for b in got:
            if not b.graph_mask.any():
                assert not b.node_mask.any() and not b.edge_mask.any()
    # A rank packs its own sub-batch alone, the same one.
    mine = pdp.pack_for_devices(tg, 8, PadBudget.for_dataset(tg, bs),
                                slot_nodes=slot, ranks=[3])[0]
    np.testing.assert_array_equal(mine.node_feat, got[3].node_feat)


@functools.lru_cache(maxsize=None)
def _model_case(name: str):
    """(JAX graphs, port graphs, JAX model, JAX's init, the port's model
    kind and kwargs, loss_fn, converter, slotted) of one DP case."""
    if name == "gatedgcn":
        jg, tg = _graphs("make_peptides_struct", num_graphs=16, seed=5)
        jmodel = JaxGatedGCN(hidden_channels=16, num_classes=11,
                             num_layers=2)
        kind, kwargs = "gatedgcn", dict(num_features=9, hidden_channels=16,
                                        num_classes=11, num_layers=2,
                                        num_edge_features=3)
        loss_fn = "l1"

        def convert(p):
            return gatedgcn_params_from_jax(p, True)
    else:
        n = 3 if name == "partial" else 24
        jg, tg = _graphs("make_peptides_func", num_graphs=n,
                         seed=9 if name == "partial" else 7, mean_nodes=30)
        kw = dict(conv_type="gcn", activation="relu", num_features=9,
                  hidden_channels=16, num_classes=10, num_layers=3)
        jmodel, kind, kwargs = JaxMPNN(**kw), "mpnn", kw
        loss_fn, convert = "cross_entropy", mpnn_params_from_jax
    slot = _slot(tg) if name in ("gcn_dense", "partial") else None
    example = jdp.pack_for_devices(jg, 1, JaxBudget.for_dataset(jg, len(jg)),
                                   slot_nodes=slot)
    params = jax_init_state(jmodel, jax_opt("adamW", 0.01, 5e-4),
                            jax.tree_util.tree_map(lambda x: x[0], example),
                            seed=3).params
    return jg, tg, jmodel, params, kind, kwargs, loss_fn, convert, slot


def _dp_cases(D: int) -> tuple[dict, dict]:
    """(the ranks' cases, JAX's references) of the four DP models at D:
    the dense-slot GCN (with the eval step), the sparse GCN with its CSR
    plans, GatedGCN with edge features (L1), and 3 graphs (a rank without
    a graph at D = 4) on slots with plans."""
    cases, refs = {}, {}
    for name in ("gcn_dense", "gcn_sparse", "gatedgcn", "partial"):
        (jg, tg, jmodel, params, kind, kwargs, loss_fn, convert,
         slot) = _model_case(name)
        per_dev = -(-len(tg) // D)
        refs[name] = sharded_jax.dp_reference(
            jmodel, params, jg, D, JaxBudget.for_dataset(jg, per_dev), slot,
            loss_fn, False, convert, evaluate=name == "gcn_dense")
        cases[name] = dict(kind=kind, kwargs=kwargs, state=refs[name]["init"],
                           graphs=tg,
                           budget=PadBudget.for_dataset(tg, per_dev),
                           slot=slot, plan=name in ("gcn_sparse", "partial"),
                           loss_fn=loss_fn, node_level=False,
                           eval=name == "gcn_dense")
    return cases, refs


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(got, ref, rtol=rtol)


def _grads_close(got: dict, ref: dict, what: str):
    top = max(np.abs(g).max() for g in ref.values())
    for name, g in ref.items():
        err = np.abs(got[name] - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), 1e-3 * top), (
            what, name, err)


@pytest.mark.parametrize("D", (1, 2, 4))
def test_dp_steps_match_jax(D, tmp_path):
    """The module docstring's DP-step criteria at D ranks; every rank ends
    with the same weights."""
    cases, refs = _dp_cases(D)
    outs = run_ranks("dp_cases", D, {"cases": cases}, tmp_path)
    for name, ref in refs.items():
        lr_sum = 0.01 * len(ref["step_losses"])
        for out in (o[name] for o in outs):
            _close(out["loss"], ref["loss"])
            _grads_close(out["grads"], ref["grads"], name)
            np.testing.assert_allclose(out["step_losses"],
                                       ref["step_losses"], rtol=1e-4)
            assert_post_adam(out["final"], ref["final"], ref["init"],
                             lr_sum)
            if "eval_loss" in ref:
                _close(out["eval_loss"], ref["eval_loss"])
        first = outs[0][name]
        assert sum(o[name]["rows"] for o in outs) == len(cases[name]["graphs"])
        _close(first["single_loss"], first["loss"])
        _grads_close(first["grads"], first["single_grads"], name)
        for out in outs[1:]:
            for k, w in first["final"].items():
                np.testing.assert_array_equal(out[name]["final"][k], w)
    if D == 4:
        # 3 graphs on 4 ranks: one rank holds only the placeholder.
        assert min(o["partial"]["rows"] for o in outs) == 0


def _dp8(**changes) -> dict:
    """The shipped DP config shrunk: 48 graphs, global batch 16, hidden
    16, 3 epochs with an eval every epoch, no dropout (the ranks' bits
    differ from JAX's); ``changes`` {"section.field": value}."""
    raw = yaml.safe_load(DP8.read_text())
    raw["data"].update(num_graphs=48, batch_size=16)
    raw["mp"].update(hidden_channels=16, num_layers=3, dropout=0.0)
    raw["training"].update(max_epochs=3, eval_period=1)
    for key, value in changes.items():
        section, field = key.split(".")
        raw.setdefault(section, {})[field] = value
    return raw


def test_run_experiment_follows_jax_fit_dp(tmp_path):
    """The shrunk dp8 config at mesh.shape [2] on 2 gloo ranks against
    JAX's run_experiment at 2 devices: per-epoch train, val and test losses
    within 1e-4 relative; run_eval of the DP snapshot, on one process,
    equals the fit's best val loss (the val split is one global batch,
    so the DP and single-device means agree), its predict export the val
    and test graphs' rows."""
    from graph_hscn_tpu.config.config import parse_config as jparse
    from graph_hscn_tpu.runner import run_experiment as jax_run
    raw = _dp8(**{"mesh.shape": [2], "training.checkpoint_dir":
                  str(tmp_path / "ck"), "training.checkpoint_every": 1})
    outs = torch_dist.spawn("run_cli", 2, dict(
        raw=raw, predict=str(tmp_path / "p.npz"),
        state=sharded_jax.mpnn_init_state(raw)), tmp_path)
    jraw = copy.deepcopy(raw)
    jraw["training"].pop("checkpoint_dir")
    ref = jax_run(jparse(jraw))
    n_train = len(DataModule.from_config(parse_config(raw).data).split(
        "train"))
    for out in outs:
        assert out["steps"] == 3 * -(-n_train // 16)   # global batches
        assert len(out["history"]) == len(ref.history) == 3
        for got, want in zip(out["history"], ref.history):
            for key in ("train_loss", "validation_loss", "test_loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=key)
        np.testing.assert_allclose(out["eval"]["val"]["loss"], out["best"],
                                   rtol=1e-5, atol=1e-6)
    # The same snapshot scored by this one process (no group).
    cfg = parse_config(raw)
    again = run_eval(cfg, "best", device="cpu")
    np.testing.assert_allclose(again["val"]["loss"], outs[0]["best"],
                               rtol=1e-5, atol=1e-6)
    z = np.load(tmp_path / "p.npz")
    assert z["val_scores"].shape == z["val_targets"].shape
    assert z["val_scores"].shape[1] == 10


def test_shipped_dp_config_raises_on_one_rank():
    """shape [8] on one rank: JAX's device-count ValueError."""
    raw = yaml.safe_load(DP8.read_text())
    raw["data"]["num_graphs"] = 24
    with pytest.raises(ValueError, match=r"mesh.shape=\[8\] needs 8 "
                       "devices, have 1"):
        run_experiment(parse_config(raw), device="cpu")


# --- runtime.multihost ------------------------------------------------------

TORCHRUN = {"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "1",
            "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
JAXVARS = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234",
           "JAX_NUM_PROCESSES": "3", "JAX_PROCESS_ID": "2"}


@pytest.mark.parametrize("mode,environ,want", [
    ("auto", {}, None),
    ("off", TORCHRUN, None),
    ("off", JAXVARS, None),
    ("auto", TORCHRUN, {"init_method": "env://", "world_size": 4,
                        "rank": 2, "local_rank": 1}),
    ("on", TORCHRUN, {"init_method": "env://", "world_size": 4,
                      "rank": 2, "local_rank": 1}),
    ("auto", JAXVARS, {"init_method": "tcp://10.0.0.1:1234",
                       "world_size": 3, "rank": 2, "local_rank": 2}),
    ("on", {"COORDINATOR_ADDRESS": "h:9"}, {
        "init_method": "tcp://h:9", "world_size": 1, "rank": 0,
        "local_rank": 0}),
], ids=["auto-none", "off-torchrun", "off-jax", "auto-torchrun",
        "on-torchrun", "auto-jax", "on-legacy"])
def test_launcher_env(mode, environ, want):
    """JAX's maybe_init_distributed modes: "auto" joins where a launcher's
    variables are set, "on" always, "off" never; torchrun's variables or
    the JAX package's (host:port, process count, process id)."""
    assert pmesh.launcher_env(mode, environ) == want
    if want is None and mode == "off":
        assert pmesh.launcher_env("auto", environ) is not None


def test_multihost_on_without_launcher_raises(monkeypatch):
    """"on" with no launcher variables raises before any work, as JAX
    re-raises a failed initialize under "on"; "off" trains alone."""
    for key in list(TORCHRUN) + list(JAXVARS) + ["COORDINATOR_ADDRESS"]:
        monkeypatch.delenv(key, raising=False)
    raw = _dp8(**{"runtime.multihost": "on", "mesh.shape": [1]})
    with pytest.raises(RuntimeError, match="multihost: on"):
        run_experiment(parse_config(raw), device="cpu")
    with pytest.raises(ValueError, match="multihost"):
        pmesh.launcher_env("sometimes")
    # "off": WORLD_SIZE set, yet the process is its own 1-rank world.
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert pmesh.world_size("off") == 1
    assert pmesh.resolve_mesh_shape([-1], pmesh.world_size("off")) == [1]
    raw = _dp8(**{"runtime.multihost": "off", "mesh.shape": [-1],
                  "training.max_epochs": 1})
    result = run_experiment(parse_config(raw), device="cpu")
    assert result.epochs_run == 1 and not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_jax_launcher_variables_start_the_port(tmp_path):
    """Two processes of ``run_experiment`` given only
    the JAX package's variables (JAX_COORDINATOR_ADDRESS on localhost,
    JAX_NUM_PROCESSES 2, JAX_PROCESS_ID) and ``runtime.multihost: on``
    join one gloo group and train the DP config at mesh.shape [2]; rank 0
    logs, both exit 0."""
    cfg = tmp_path / "dp.yaml"
    cfg.write_text(yaml.safe_dump(_dp8(**{
        "mesh.shape": [2], "runtime.multihost": "on",
        "training.max_epochs": 2})))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in TORCHRUN and k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_NUM_PROCESSES="2")
    run = ("import sys; from graph_hscn_tpu_torch.config.config import "
           "load_config; from graph_hscn_tpu_torch.runner import "
           "run_experiment; run_experiment(load_config(sys.argv[1]), "
           "device='cpu')")
    procs = [subprocess.Popen(
        [sys.executable, "-c", run, str(cfg)], cwd=tmp_path,
        env=dict(env, JAX_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "Data-parallel training over 2 ranks" in logs[0]
    assert "Epoch: 1 -- Loss" in logs[0]
