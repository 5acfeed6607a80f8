"""The port's GIN (models/layers.py ``GINConv``, ``MLP``; the GIN ``MPNN``
with ``use_layer_norm``) against the JAX package's, weights carried across
by ``models/convert.py``: ``GINConv`` on slotted batches (the einsum over
the raw adjacency) and on sparse batches (``gather_scatter``: the CSR
kernel's plain version on the CPU with a plan, plain gathers without),
forward and gradients; ``MLP``; the GIN ``MPNN`` with and without
LayerNorm on both layouts; ``use_batch_norm: true`` failing in both
packages (JAX at the first train step, the port at build); and the
shipped GIN config through ``run_experiment``, on its own route and on
the sparse one, where each ``GINConv`` runs ``csr_spmm`` (3 forwards and 2
transposes a train step, 3 forwards an eval batch).

Tolerances (float32): rtol=1e-5, atol=1e-5*max|ref| for the layers'
forwards and gradients; the MPNN's gradients at 1e-4*max|ref| (float32
sums in another order through LayerNorm and three layers, as
tests/test_torch_gatedgcn.py holds its nets).  JAX's sparse path is its
XLA one (``segment_sum``, the function ``spmm_pallas`` computes).
"""

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu import runner as jax_runner
from graph_hscn_tpu.config.config import load_config as jax_load_config
from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
from graph_hscn_tpu.models.layers import GINConv as JaxGINConv
from graph_hscn_tpu.models.layers import MLP as JaxMLP
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.ops.dense import resolve_dense_adj as jax_dense_adj
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.loop import make_train_step as jax_make_train_step
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu_torch import runner
from graph_hscn_tpu_torch.config.config import MPNNConfig, load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import mpnn_params_from_jax
from graph_hscn_tpu_torch.models.layers import MLP, GINConv
from graph_hscn_tpu_torch.models.mpnn import MPNN, build_mpnn
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.ops.cuda import spmm_kernel
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj

ROOT = Path(__file__).parents[1]
GIN = ROOT / "configs" / "GIN" / "peptides_func_GIN.yaml"


def assert_close(got, ref, tol=1e-5):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def pallas_backend():
    """The port's kernel path (plain versions on the CPU), restored
    afterwards."""
    prev = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        yield
    finally:
        spmm.set_backend(prev)


def _batches(layout, num_graphs=3, seed=51):
    """(JAX batch, port batch) of peptides graphs: slotted, or flat with
    the CSR plan attached (the JAX batch keeps none: its XLA path)."""
    graphs = js.make_peptides_func(num_graphs=num_graphs, seed=seed,
                                   mean_nodes=24.0)
    slot = (((max(g.num_nodes for g in graphs) + 8) // 8) * 8
            if layout == "slots" else None)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 4),
                           slot_nodes=slot)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 4),
                           slot_nodes=slot,
                           with_spmm_plan=layout == "plan").to("cpu")
    return jbatch, tbatch


def _conv_params(params):
    return mpnn_params_from_jax({"GINConv_0": np_tree(params)})


@pytest.mark.parametrize("layout", ["slots", "plan", "flat"])
def test_gin_conv_matches_jax(layout, pallas_backend, monkeypatch):
    """GINConv 9 -> 16 on one batch: the output, dx and every parameter
    gradient.  Slotted: both take the raw adjacency (no normalization);
    with a plan the port runs SpmmFunction (csr_spmm's plain version,
    forward and the transpose for dx)."""
    jbatch, tbatch = _batches(layout)
    x = np.asarray(jbatch.node_feat, np.float32)
    jconv = JaxGINConv(features=16)
    adj = jax_dense_adj(jbatch)

    def apply(p, xx):
        return jconv.apply({"params": p}, xx, jbatch.senders,
                           jbatch.receivers, jbatch.edge_mask,
                           num_nodes=jbatch.num_nodes_padded, dense_adj=adj)

    params = jconv.init(jax.random.PRNGKey(3), jnp.asarray(x),
                        jbatch.senders, jbatch.receivers, jbatch.edge_mask,
                        num_nodes=jbatch.num_nodes_padded,
                        dense_adj=adj)["params"]
    out, vjp = jax.vjp(apply, params, jnp.asarray(x))
    cot = np.random.default_rng(2).normal(size=out.shape).astype(np.float32)
    jgrads, jdx = vjp(jnp.asarray(cot))

    conv = GINConv(9, 16)
    conv.load_state_dict({k[len("convs.0."):]: v
                          for k, v in _conv_params(params).items()})
    tx = torch.tensor(x, requires_grad=True)
    calls = []
    real = spmm_kernel.SpmmFunction.apply

    def counted(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(spmm_kernel.SpmmFunction, "apply", counted)
    got = conv(tx, tbatch.senders, tbatch.receivers, tbatch.edge_mask,
               num_nodes=tbatch.num_nodes_padded,
               dense_adj=resolve_dense_adj(tbatch), plan=tbatch.spmm)
    assert len(calls) == (layout == "plan")
    (got * torch.tensor(cot)).sum().backward()
    assert_close(got, out)
    assert_close(tx.grad, jdx)
    want = _conv_params(jgrads)
    for name, p in conv.named_parameters():
        assert_close(p.grad, want["convs.0." + name])


def test_mlp_matches_jax():
    """MLP 7 -> (12, 5, 3), relu between and none after the last (the
    JAX MLP's defaults, as GIN uses it): output and gradients."""
    x = np.random.default_rng(4).normal(size=(6, 7)).astype(np.float32)
    jmlp = JaxMLP(features=(12, 5, 3))
    params = jmlp.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    out, vjp = jax.vjp(lambda p: jmlp.apply({"params": p}, jnp.asarray(x)),
                       params)
    (jgrads,) = vjp(jnp.ones_like(out))
    mlp = MLP(7, (12, 5, 3))
    convert = (lambda tree: {
        f"layers.{i}.{k}": torch.from_numpy(np.ascontiguousarray(
            np.asarray(v).T if k == "weight" else np.asarray(v)))
        for i in range(3) for k, v in (
            ("weight", tree[f"Dense_{i}"]["kernel"]),
            ("bias", tree[f"Dense_{i}"]["bias"]))})
    mlp.load_state_dict(convert(np_tree(params)))
    got = mlp(torch.tensor(x))
    got.sum().backward()
    assert_close(got, out)
    want = convert(np_tree(jgrads))
    for name, p in mlp.named_parameters():
        assert_close(p.grad, want[name])


@pytest.mark.parametrize("layout", ["slots", "plan"])
@pytest.mark.parametrize("layer_norm", [False, True])
def test_gin_mpnn_matches_jax(layout, layer_norm, pallas_backend):
    """The GIN MPNN (3 layers, hidden 16, compat double relu), with and
    without use_layer_norm (a LayerNorm after the relu of each hidden
    layer), slotted and sparse: logits and every parameter gradient."""
    jbatch, tbatch = _batches(layout)
    kw = dict(conv_type="gin", activation="relu", num_features=9,
              hidden_channels=16, num_classes=10, num_layers=3,
              use_layer_norm=layer_norm)
    jmodel = JaxMPNN(**kw)
    params = jmodel.init(jax.random.PRNGKey(6), jbatch, train=False)["params"]
    logits, vjp = jax.vjp(
        lambda p: jmodel.apply({"params": p}, jbatch, train=False), params)
    cot = np.random.default_rng(3).normal(size=logits.shape).astype(
        np.float32)
    (jgrads,) = vjp(jnp.asarray(cot))
    assert ("LayerNorm_1" in params) == layer_norm
    model = MPNN(**kw)
    model.load_state_dict(mpnn_params_from_jax(np_tree(params)))
    model.eval()
    out = model(tbatch)
    (out * torch.tensor(cot)).sum().backward()
    assert_close(out, logits)
    want = mpnn_params_from_jax(np_tree(jgrads))
    assert set(want) == set(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        assert_close(p.grad, want[name], 1e-4)


def test_batch_norm_fails_in_both_packages():
    """use_batch_norm: true.  The JAX MPNN builds an nn.BatchNorm
    (models/mpnn.py:93-95) whose train step keeps no batch_stats
    (train/loop.py:106-114): its first train step raises flax's
    ScopeCollectionNotFound.  The port refuses it at build with a
    ValueError citing both places."""
    jbatch, _ = _batches("slots")
    kw = dict(conv_type="gin", activation="relu", num_features=9,
              hidden_channels=16, num_classes=10, num_layers=3,
              use_batch_norm=True)
    jmodel = JaxMPNN(**kw)
    tx = jax_build_opt("adamW", 0.001, 5e-4)
    with pytest.raises(flax.errors.ScopeCollectionNotFound):
        state = jax_init_state(jmodel, tx, jbatch, seed=0)
        step, _ = jax_make_train_step(jmodel, tx, "cross_entropy")
        step(state, jbatch)
    with pytest.raises(ValueError, match="mpnn.py:93-95") as err:
        MPNN(**kw)
    assert "loop.py:125-135" in str(err.value)
    cfg = load_config(GIN)
    cfg.mpnn.use_batch_norm = True
    with pytest.raises(ValueError, match="use_batch_norm"):
        build_mpnn(cfg.mpnn, 9, 10)


def _small(**changes):
    cfg = load_config(GIN)
    cfg.data.num_graphs = 48
    cfg.data.batch_size = 8
    cfg.mpnn.dropout = 0.0
    cfg.training.epochs = 2
    cfg.training.eval_period = 1
    for key, value in changes.items():
        section, field = key.split(".")
        setattr(getattr(cfg, section), field, value)
    return cfg


def test_gin_config_routes_as_jax(monkeypatch):
    """The shipped GIN config, shrunk, takes the JAX runner's route (dense
    slots, the device-resident dataset: captured on the card) and trains
    with finite losses; with use_layer_norm too."""
    seen = {}
    fit_device = runner.fit_device

    def spy(*args, **kw):
        seen.update(kw)
        return fit_device(*args, **kw)

    monkeypatch.setattr(runner, "fit_device", spy)
    monkeypatch.setattr(runner, "fit", None)
    for layer_norm in (False, True):
        cfg = _small(**{"mpnn.use_layer_norm": layer_norm})
        result = runner.run_experiment(cfg, device="cpu")
        losses = [v for h in result.history for k, v in h.items()
                  if k.endswith("_loss")]
        assert len(losses) == 6 and np.isfinite(losses).all()
        assert isinstance(result.model, MPNN)
        assert result.model.conv_type == "gin"
        assert (result.model.norms is not None) == layer_norm
    jcfg = jax_load_config(GIN)
    jcfg.data.num_graphs = 48
    jdm = JaxDataModule.from_config(jcfg.data)
    dm = DataModule.from_config(cfg.data)
    assert dm.enable_dense_slots() and jdm.enable_dense_slots()
    assert seen["slot"] == dm.slot_nodes == jdm.slot_nodes
    assert runner._use_fused_stack(cfg, dm, torch.device("cpu")) == \
        jax_runner._use_fused_stack(jcfg, jdm, False) is False
    assert runner._use_device_dataset(cfg, dm) == \
        jax_runner._use_device_dataset(jcfg, jdm) is True


def test_sparse_gin_runs_csr_spmm_in_every_conv(monkeypatch, pallas_backend):
    """The GIN config on sparse batches (runtime.dense_path: sparse,
    device_dataset: off: the host loop with the CSR plan): each GINConv
    calls csr_spmm forward, and the transpose for dx in every layer but
    the first (its input, the node features, takes no gradient), so 3
    forwards and 2 transposes a train step, 3 forwards an eval batch, as
    chip_smoke.py counts the kernel's launches on the card."""
    cfg = _small(**{"runtime.dense_path": "sparse",
                    "runtime.device_dataset": "off",
                    "runtime.spmm_backend": "pallas"})
    calls = {"forward": 0, "transpose": 0}
    real = spmm_kernel.csr_spmm

    def counted(x, row_ptr, col, w, order=None):
        calls["transpose" if order is not None else "forward"] += 1
        return real(x, row_ptr, col, w, order)

    monkeypatch.setattr(spmm_kernel, "csr_spmm", counted)
    result = runner.run_experiment(cfg, device="cpu")
    steps, evals = result.num_train_steps, result.num_eval_batches
    assert steps and evals
    assert calls == {"forward": 3 * steps + 3 * evals,
                     "transpose": 2 * steps}
    losses = [h["train_loss"] for h in result.history]
    assert np.isfinite(losses).all()


def test_build_mpnn_gin_and_norm_flags():
    """build_mpnn's GIN branch: three GINConvs (MLPs of two Dense), and
    a LayerNorm a hidden layer only with use_layer_norm."""
    cfg = MPNNConfig(conv_type="gin", activation="relu", hidden_channels=8,
                     num_layers=3, use_layer_norm=True)
    model = build_mpnn(cfg, 9, 10)
    assert [type(c).__name__ for c in model.convs] == ["GINConv"] * 3
    assert [len(c.mlp.layers) for c in model.convs] == [2, 2, 2]
    assert len(model.norms) == 2
    assert model.convs[2].mlp.layers[1].weight.shape == (10, 10)
