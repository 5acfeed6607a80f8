"""The port's training layer against the JAX package's: optimizer steps from
carried-over weights follow the JAX train step, the loss branches and
metrics agree, and run_experiment trains end to end on the CPU and routes
the configurations of later slices to a clear NotImplementedError."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.train import metrics as jax_metrics
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.loop import make_train_step as jax_make_train_step
from graph_hscn_tpu.train.loss import criterion as jax_criterion
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.models.convert import mpnn_params_from_jax
from graph_hscn_tpu_torch.models.mpnn import MPNN
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.runner import run_experiment
from graph_hscn_tpu_torch.train import metrics
from graph_hscn_tpu_torch.train.loop import make_train_step
from graph_hscn_tpu_torch.train.loss import criterion
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

ROOT = Path(__file__).parents[1]
SPARSE_VOC = ROOT / "configs" / "GCN" / "voc_superpixels_GCN_sparse.yaml"


@pytest.fixture
def restore_backend():
    prev = spmm.get_backend()
    try:
        yield
    finally:
        spmm.set_backend(prev)


@pytest.mark.parametrize("optim_type,clip", [("adamW", False),
                                             ("adamW", True),
                                             ("adam", False),
                                             ("adagrad", False)])
def test_optimizer_steps_follow_jax(optim_type, clip, restore_backend):
    """3 steps with dropout 0 from carried-over weights: the loss of every
    step and the final params within 1e-5 relative of the JAX train step
    (train/loop.py:73-113).  The port runs its kernel path (plain versions
    on the CPU), JAX its XLA path: the same function.  Adagrad follows
    optax's scale_by_rss rule (rsqrt(acc + eps), 0 where acc is 0)."""
    graphs = js.make_voc_superpixels(num_graphs=6, seed=41, mean_nodes=100.0)
    budget = jb.PadBudget.for_dataset(graphs, batch_size=2)
    jbatches = [jb.pack_batch(graphs[i:i + 2], budget) for i in (0, 2, 4)]
    tbatches = [tb.pack_batch(graphs[i:i + 2], tb.PadBudget.for_dataset(
        graphs, batch_size=2), with_spmm_plan=True).to("cpu")
        for i in (0, 2, 4)]
    lr, wd = 0.01, 1e-3
    jmodel = JaxMPNN(conv_type="gcn", activation="relu", num_features=14,
                     hidden_channels=16, num_classes=21, num_layers=3,
                     dropout=0.0, readout="none")
    tx = jax_build_opt(optim_type, lr, wd, clip_grad_norm=clip)
    state = jax_init_state(jmodel, tx, jbatches[0], seed=3)
    init_params = jax.tree_util.tree_map(np.asarray, state.params)
    jstep, _ = jax_make_train_step(jmodel, tx, "softmax_cross_entropy",
                                   node_level=True)
    jlosses = []
    for b in jbatches:
        state, loss, *_ = jstep(state, b)
        jlosses.append(float(loss))

    spmm.set_backend("pallas")
    model = MPNN(conv_type="gcn", activation="relu", num_features=14,
                 hidden_channels=16, num_classes=21, num_layers=3,
                 dropout=0.0, readout="none")
    model.load_state_dict(mpnn_params_from_jax(init_params))
    opt = build_optimizer(model.parameters(), optim_type, lr, wd,
                          clip_grad_norm=clip)
    step, _ = make_train_step(model, opt, "softmax_cross_entropy",
                              node_level=True)
    tlosses = [float(step(b)[0]) for b in tbatches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    final = mpnn_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        state.params))
    for name, p in model.state_dict().items():
        ref = final[name].numpy()
        np.testing.assert_allclose(p.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_optimizer_options_of_later_slices_raise():
    """Schedules and accumulation are ported (tests/test_torch_schedule.py);
    what neither package can build still raises: a decaying schedule with
    no horizon, an unknown schedule or optimizer, accumulation below 1."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="total_steps"):
        build_optimizer(p, "adamW", 0.01, 0.0, schedule="cosine")
    with pytest.raises(ValueError, match="schedule"):
        build_optimizer(p, "adamW", 0.01, 0.0, schedule="step",
                        total_steps=10)
    with pytest.raises(ValueError, match="batch_accumulation"):
        build_optimizer(p, "adamW", 0.01, 0.0, batch_accumulation=0)
    with pytest.raises(ValueError):
        build_optimizer(p, "sgd", 0.01, 0.0)


@pytest.mark.parametrize("loss_fn,compat", [("cross_entropy", False),
                                            ("l1", False), ("mae", True),
                                            ("softmax_cross_entropy", False)])
def test_criterion_matches_jax(loss_fn, compat):
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(9, 4)).astype(np.float32)
    if loss_fn == "softmax_cross_entropy":
        true = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 9)]
    else:
        true = (rng.uniform(size=(9, 4)) > 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 0], bool)
    jl, js_ = jax_criterion(loss_fn, pred, true, mask,
                            compat_sigmoid_score=compat)
    tl, ts = criterion(loss_fn, torch.tensor(pred), torch.tensor(true),
                       torch.tensor(mask), compat_sigmoid_score=compat)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js_), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError):
        criterion("hinge", torch.tensor(pred), torch.tensor(true),
                  torch.tensor(mask))


@pytest.mark.parametrize("name", ["f1", "ap", "mae"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(6)
    if name == "f1":
        y = np.eye(5)[rng.integers(0, 5, 200)]
        s = rng.normal(size=(200, 5))
    else:
        y = (rng.uniform(size=(200, 3)) > 0.6).astype(np.float64)
        s = np.round(rng.uniform(size=(200, 3)), 1)   # ties, as in AP
    assert metrics.METRICS[name](y, s) == jax_metrics.METRICS[name](y, s)


def _small_cfg(path=SPARSE_VOC, **runtime):
    cfg = load_config(path)
    cfg.data.num_graphs = 24
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


def test_run_experiment_trains_on_cpu(restore_backend):
    """The sparse VOC config, shrunk (24 graphs, 2 layers), through the
    kernel path's plain versions on the CPU: train loss falls."""
    cfg = _small_cfg(spmm_backend="pallas")
    cfg.mpnn.num_layers = 2
    cfg.training.epochs = 6
    cfg.training.eval_period = 3
    result = run_experiment(cfg, device="cpu", step_timing=True)
    losses = [h["train_loss"] for h in result.history]
    assert result.epochs_run == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "validation_loss" in result.history[0]
    assert result.num_train_steps == len(result.step_seconds) == 6
    assert result.num_eval_batches == 3 * 2 * 1   # 3 evals x (val + test)


def test_run_experiment_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(_small_cfg())


# GIN and GPS are ported (tests/test_torch_gin.py, tests/test_torch_gps.py),
# and so are positional encodings and checkpoints
# (tests/test_torch_posenc.py, tests/test_torch_checkpoint.py): their cases
# left this list; the others keep their ids.
@pytest.mark.parametrize("path,change,error,match", [
    # The data-parallel and hybrid meshes are ported
    # (tests/test_torch_data_parallel.py, tests/test_torch_hybrid.py): a
    # mesh past the devices raises JAX's ValueError, in both packages.
    pytest.param("GCN/peptides_func_GCN_dp8.yaml", {"mesh.shape": [16]},
                 ValueError, "needs 16 devices",
                 id="GCN/peptides_func_GCN_dp8.yaml-change2-mesh"),
    # The edge-partitioned HSCN is ported (tests/test_torch_sharded_scn.py,
    # tests/test_torch_sharded_hscn.py): on the graph-level peptides
    # config it raises JAX's ValueError, in both packages.
    pytest.param("HSCN/peptides_func_HSCN.yaml", {"mesh.edge_partition": True},
                 ValueError, "node-level",
                 id="HSCN/peptides_func_HSCN.yaml-change4-HSCN"),
    pytest.param("GCN/voc_superpixels_GCN_sparse.yaml",
                 {"mesh.shape": [16]}, ValueError, "needs 16 devices",
                 id="GCN/voc_superpixels_GCN_sparse.yaml-change5-mesh"),
    pytest.param("GCN/voc_superpixels_GCN_sparse.yaml",
                 {"runtime.debug_nans": True}, NotImplementedError,
                 "debug_nans",
                 id="GCN/voc_superpixels_GCN_sparse.yaml-change7-debug_nans"),
    # Keys JAX reads and the port does not yet: refused, not ignored.
    pytest.param("GCN/peptides_func_GCN.yaml",
                 {"runtime.profile_dir": "trace"}, NotImplementedError,
                 "profile_dir.*item 12",
                 id="GCN/peptides_func_GCN.yaml-profile_dir"),
    # runtime.multihost is ported: "on" without a launcher's variables
    # raises, as JAX re-raises a failed initialize under "on".
    pytest.param("HSCN/peptides_func_HSCN.yaml",
                 {"runtime.multihost": "on"}, RuntimeError,
                 "multihost: on",
                 id="HSCN/peptides_func_HSCN.yaml-multihost"),
])
def test_run_experiment_later_slices_raise(path, change, error, match):
    """The paths of later slices raise NotImplementedError naming their
    ROADMAP item; a ValueError case is JAX's own refusal, which JAX's
    run_experiment raises on the same config too; "multihost: on" without
    a launcher raises RuntimeError."""
    cfgs = [_small_cfg(ROOT / "configs" / path)]
    if error is ValueError:
        from graph_hscn_tpu.config.config import load_config as jax_load
        cfgs.append(jax_load(ROOT / "configs" / path))
        cfgs[-1].data.num_graphs = 24
    for cfg in cfgs:
        for key, value in change.items():
            section, field = key.split(".")
            setattr(getattr(cfg, section), field, value)
    with pytest.raises(error, match=match):
        run_experiment(cfgs[0], device="cpu")
    if error is ValueError:
        from graph_hscn_tpu.runner import run_experiment as jax_run
        with pytest.raises(error, match=match):
            jax_run(cfgs[1])


def test_dense_path_on_large_graphs_is_refused():
    cfg = _small_cfg(dense_path="dense")
    with pytest.raises(ValueError, match="max slot"):
        run_experiment(cfg, device="cpu")


def test_main_cli_trains_on_cpu(tmp_path, monkeypatch, restore_backend):
    import yaml

    from graph_hscn_tpu_torch import main as cli
    raw = yaml.safe_load(SPARSE_VOC.read_text())
    raw["data"]["num_graphs"] = 24
    raw["mp"]["num_layers"] = 2
    raw["training"]["max_epochs"] = 2
    cfg_file = tmp_path / "voc.yaml"
    cfg_file.write_text(yaml.safe_dump(raw))
    monkeypatch.setattr(cli, "LOGS_DIR", tmp_path / "logs")
    monkeypatch.setattr(sys, "argv", ["main", "--cfg", str(cfg_file),
                                      "--device", "cpu"])
    cli.main()
    log = (tmp_path / "logs" / "voc_superpixels_gcn_torch.log").read_text()
    assert "Epoch: 1 -- Loss" in log
