"""The port's GPS transformer (models/gps.py) against the JAX package's
(graph_hscn_tpu/models/gps.py), with weights carried across by
``models/convert.py``: ``GraphMHA`` forward and its input and weight
gradients (``jax.vjp`` against autograd), a batch with an all-padding
dummy graph block included; ``GPSLayer`` and ``GPSModel`` with both local
modules (GCN, GatedGCN) at graph and node level; JAX's padding-invariance
case; the no-slot ``ValueError`` of both; 3 AdamW steps under the cosine
schedule with a short warmup following the JAX trajectory; and the GPS
configs through ``run_experiment`` on the CPU, routed as JAX routes them.

Tolerances (float32): ``GraphMHA`` rtol=1e-5, atol=1e-5*max|ref|;
layers and models the same for the forward, atol=1e-4*max|ref| for the
gradients (float32 sums in another order through LayerNorms and several
layers, as tests/test_torch_gatedgcn.py holds its nets); the weights after
3 AdamW steps at 1e-4*max|ref| (PERF.md section 2).  The attention's key
bias has a zero gradient in exact arithmetic (it shifts all of a query's
scores alike): its gradients are held at the scale of all the gradients,
and after Adam steps (which move it by rounding noise alone) it is held
within the sum of the lrs applied, on both sides.
"""

from pathlib import Path

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
from graph_hscn_tpu.models import gps as jgps
from graph_hscn_tpu.ops.dense import resolve_dense_adj as jax_dense_adj
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.loop import make_train_step as jax_make_train_step
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu_torch import runner
from graph_hscn_tpu_torch.config.config import MPNNConfig, load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (gps_layer_params_from_jax,
                                                 gps_params_from_jax)
from graph_hscn_tpu_torch.models.gps import GPSLayer, GPSModel, GraphMHA
from graph_hscn_tpu_torch.models.layers import GCNConv
from graph_hscn_tpu_torch.models.mpnn import build_mpnn
from graph_hscn_tpu_torch.ops.dense import resolve_dense_adj
from graph_hscn_tpu_torch.train.loop import make_train_step
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

ROOT = Path(__file__).parents[1]
GPS_FUNC = ROOT / "configs" / "GPS" / "peptides_func_GPS.yaml"
GPS_STRUCT = ROOT / "configs" / "GPS" / "peptides_struct_GPS.yaml"
GPS_VOC = ROOT / "configs" / "GPS" / "voc_superpixels_GPS.yaml"
HIDDEN, HEADS = 16, 4


def assert_close(got, ref, tol=1e-5):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def assert_grads_close(got: dict, want: dict, tol=1e-4):
    """Every gradient at rtol=1e-5, atol=tol times the largest of them all:
    some are zero in exact arithmetic (the attention's key bias, which
    shifts a query's scores all alike) and hold rounding noise alone."""
    assert set(got) == set(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, g in got.items():
        np.testing.assert_allclose(
            g.detach().numpy(), np.asarray(want[name]), rtol=1e-5,
            atol=tol * scale, err_msg=name)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(kind, num_graphs=3, seed=41):
    if kind == "voc":
        return js.make_voc_superpixels(num_graphs=num_graphs, seed=seed,
                                       mean_nodes=50.0)
    if kind == "struct":
        return js.make_peptides_struct(num_graphs=num_graphs, seed=seed,
                                       mean_nodes=24.0)
    return js.make_peptides_func(num_graphs=num_graphs, seed=seed,
                                 mean_nodes=24.0)


def _batches(graphs, extra_graphs=1, slot=None):
    """(JAX batch, port batch) of ``graphs`` in dense slots: one more graph
    slot than graphs (``extra_graphs`` all-padding blocks besides the
    dummy slot) and padding nodes in every block."""
    slot = slot or ((max(g.num_nodes for g in graphs) + 8) // 8) * 8
    budget = jb.PadBudget.for_dataset(graphs, len(graphs) + extra_graphs)
    jbatch = jb.pack_batch(graphs, budget, slot_nodes=slot)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(
        graphs, len(graphs) + extra_graphs), slot_nodes=slot).to("cpu")
    return jbatch, tbatch


# --- GraphMHA --------------------------------------------------------------

def test_graph_mha_matches_jax():
    """Forward, input and weight gradients on [G=4, S=8, H=16] blocks with
    4 heads; block 2 has no real node (all padding: uniform softmax, no
    NaN), the others padding rows of their own; padding rows come out 0."""
    rng = np.random.default_rng(3)
    G, S = 4, 8
    xb = rng.normal(size=(G, S, HIDDEN)).astype(np.float32)
    mask = np.zeros((G, S), bool)
    for g, n in enumerate((8, 5, 0, 3)):
        mask[g, :n] = True
    jmha = jgps.GraphMHA(hidden=HIDDEN, num_heads=HEADS)
    params = jmha.init(jax.random.PRNGKey(1), jnp.asarray(xb),
                       jnp.asarray(mask))["params"]
    out, vjp = jax.vjp(lambda p, x: jmha.apply({"params": p}, x,
                                               jnp.asarray(mask)),
                       params, jnp.asarray(xb))
    cot = rng.normal(size=out.shape).astype(np.float32)
    jgrads, jdx = vjp(jnp.asarray(cot))

    def convert(tree):
        return {k[len("attn."):]: v for k, v in gps_layer_params_from_jax(
            {"GraphMHA_0": np_tree(tree)}).items()}

    mha = GraphMHA(HIDDEN, HEADS)
    mha.load_state_dict(convert(params))
    x = torch.tensor(xb, requires_grad=True)
    got = mha(x, torch.tensor(mask))
    (got * torch.tensor(cot)).sum().backward()
    assert torch.isfinite(got).all() and torch.isfinite(x.grad).all()
    assert not got[~torch.tensor(mask)].any()
    assert_close(got, out)
    assert_close(x.grad, jdx)
    assert_grads_close({k: p.grad for k, p in mha.named_parameters()},
                       convert(jgrads), 1e-5)


# --- GPSLayer and GPSModel -------------------------------------------------

LAYER_CASES = {
    # (graphs, local conv, readout)
    "func_gcn_mean": ("func", "gcn", "mean"),
    "struct_gatedgcn_mean": ("struct", "gatedgcn", "mean"),
    "voc_gcn_none": ("voc", "gcn", "none"),
    "voc_gatedgcn_none": ("voc", "gatedgcn", "none"),
}


@pytest.mark.parametrize("local", ["gcn", "gatedgcn"])
def test_gps_layer_matches_jax(local):
    """One GPSLayer (hidden 16, 4 heads, no dropout) on a slotted peptides
    batch: x' and e' and every parameter and input gradient."""
    graphs = _graphs("struct")
    jbatch, tbatch = _batches(graphs)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(tbatch.num_nodes_padded, HIDDEN)).astype(np.float32)
    x[~tbatch.node_mask.numpy()] = 0.0
    e = rng.normal(size=(tbatch.num_edges_padded, HIDDEN)).astype(np.float32)
    e[~tbatch.edge_mask.numpy()] = 0.0
    jlayer = jgps.GPSLayer(hidden=HIDDEN, num_heads=HEADS, dropout=0.0,
                           local_conv=local)
    adj = jax_dense_adj(jbatch)
    edge = jnp.asarray(e) if local == "gatedgcn" else None
    params = jlayer.init(jax.random.PRNGKey(2), jnp.asarray(x), jbatch, adj,
                         False, edge_state=edge)["params"]

    def apply(p, xx, ee):
        return jlayer.apply({"params": p}, xx, jbatch, adj, False,
                            edge_state=ee)

    (jx, je), vjp = jax.vjp(apply, params, jnp.asarray(x), edge)
    cot_x = rng.normal(size=jx.shape).astype(np.float32)
    cot_e = (rng.normal(size=je.shape).astype(np.float32)
             if je is not None else None)
    jgrads, jdx, jde = vjp((jnp.asarray(cot_x),
                            None if cot_e is None else jnp.asarray(cot_e)))

    layer = GPSLayer(HIDDEN, HEADS, 0.0, local).eval()
    layer.load_state_dict(gps_layer_params_from_jax(np_tree(params)))
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(e, requires_grad=True) if edge is not None else None
    adj_n, diag_n = GCNConv.normalize_dense(resolve_dense_adj(tbatch))
    gx, ge = layer(tx, tbatch, adj_n, diag_n, edge_state=te)
    loss = (gx * torch.tensor(cot_x)).sum()
    if ge is not None:
        loss = loss + (ge * torch.tensor(cot_e)).sum()
    loss.backward()
    assert_close(gx, jx)
    assert_close(tx.grad, jdx, 1e-4)
    if local == "gatedgcn":
        assert_close(ge, je)
        assert_close(te.grad, jde, 1e-4)
    else:
        assert ge is None and je is None
    assert_grads_close({k: p.grad for k, p in layer.named_parameters()},
                       gps_layer_params_from_jax(np_tree(jgrads)))


def _model_pair(kind, local, readout, graphs, jbatch, tbatch, seed=7):
    """(JAX GPSModel, its params, the port's with them carried across)."""
    nf = graphs[0].x.shape[1]
    nef = (graphs[0].edge_attr.shape[1]
           if graphs[0].edge_attr is not None else None)
    nc = {"voc": 21, "struct": 11, "func": 10}[kind]
    jmodel = jgps.GPSModel(num_features=nf, hidden_channels=HIDDEN,
                           num_classes=nc, num_layers=2, num_heads=HEADS,
                           local_conv=local, readout=readout)
    params = jmodel.init(jax.random.PRNGKey(seed), jbatch,
                         train=False)["params"]
    model = GPSModel(nf, HIDDEN, nc, 2, HEADS, local_conv=local,
                     readout=readout, num_edge_features=nef)
    model.load_state_dict(gps_params_from_jax(np_tree(params)))
    return jmodel, params, model


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_gps_model_matches_jax(case):
    """GPSModel (2 layers, hidden 16, 4 heads) through convert.py: logits
    and every parameter gradient, graph level (peptides-func with the GCN
    local module, peptides-struct with GatedGCN and its 3 edge features)
    and node level (VOC, no edge features: the GatedGCN edge encoder reads
    ones), each batch with an all-padding graph block."""
    kind, local, readout = LAYER_CASES[case]
    graphs = _graphs(kind)
    jbatch, tbatch = _batches(graphs, extra_graphs=2)
    jmodel, params, model = _model_pair(kind, local, readout, graphs,
                                        jbatch, tbatch)
    logits, vjp = jax.vjp(
        lambda p: jmodel.apply({"params": p}, jbatch, train=False), params)
    cot = np.random.default_rng(1).normal(size=logits.shape).astype(
        np.float32)
    (jgrads,) = vjp(jnp.asarray(cot))
    model.eval()
    out = model(tbatch)
    (out * torch.tensor(cot)).sum().backward()
    assert out.dtype == torch.float32 and out.shape == logits.shape
    assert torch.isfinite(out).all()
    assert_close(out, logits)
    assert_grads_close({k: p.grad for k, p in model.named_parameters()},
                       gps_params_from_jax(np_tree(jgrads)))


def test_gps_padding_invariance():
    """JAX's test_gps_padding_invariance on the port: extra padding graphs
    do not change the real graphs' logits (hidden 32, 2 layers, 4 heads,
    as there), and both packages agree on both batches."""
    graphs = js.make_peptides_func(num_graphs=6, seed=0, mean_nodes=40)
    outs = []
    for extra in (1, 5):
        jbatch, tbatch = _batches(graphs, extra_graphs=extra, slot=128)
        jmodel = jgps.GPSModel(num_features=9, hidden_channels=32,
                               num_classes=10, num_layers=2, num_heads=4)
        params = jmodel.init(jax.random.PRNGKey(0), jbatch, train=False)
        model = GPSModel(9, 32, 10, 2, 4).eval()
        model.load_state_dict(gps_params_from_jax(np_tree(params)))
        with torch.no_grad():
            got = model(tbatch).numpy()
        assert_close(got, jmodel.apply(params, jbatch, train=False))
        outs.append(got)
    G = len(graphs)
    np.testing.assert_allclose(outs[1][:G], outs[0][:G], rtol=1e-5,
                               atol=1e-5)


def test_gps_requires_slotted_layout():
    """Without slots both packages raise the ValueError naming the slotted
    layout."""
    graphs = _graphs("func", 4)
    budget = jb.PadBudget.for_dataset(graphs, 4)
    jbatch = jb.pack_batch(graphs, budget)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 4)
                           ).to("cpu")
    with pytest.raises(ValueError, match="slotted"):
        jgps.GPSModel(num_features=9, hidden_channels=HIDDEN, num_classes=10,
                      num_layers=1, num_heads=HEADS).init(
            jax.random.PRNGKey(0), jbatch, train=False)
    with pytest.raises(ValueError, match="slotted"):
        GPSModel(9, HIDDEN, 10, 1, HEADS)(tbatch)


@pytest.mark.parametrize("local", ["gcn", "gatedgcn"])
def test_three_adamw_cosine_steps_follow_jax(local):
    """3 AdamW steps (lr 0.003, weight decay 5e-4, cosine schedule with 1
    warmup step over a horizon of 6, dropout 0) on three slotted peptides
    batches from the JAX initial weights: the losses and the weights after
    each step.  The first update has lr 0 (optax counts the updates
    already applied)."""
    kind = "struct" if local == "gatedgcn" else "func"
    loss_fn = "l1" if kind == "struct" else "cross_entropy"
    pairs = [_batches(_graphs(kind, 3, seed=60 + i), slot=64)
             for i in range(3)]
    graphs = _graphs(kind, 3, seed=60)
    jmodel, params, model = _model_pair(kind, local, "mean", graphs,
                                        *pairs[0])
    opt_kw = dict(schedule="cosine", warmup_steps=1, total_steps=6)
    tx = jax_build_opt("adamW", 0.003, 5e-4, **opt_kw)
    state = jax_init_state(jmodel, tx, pairs[0][0], seed=0)
    state.params = params
    state.opt_state = tx.init(params)
    jstep, _ = jax_make_train_step(jmodel, tx, loss_fn)
    opt = build_optimizer(model.parameters(), "adamW", 0.003, 5e-4, **opt_kw)
    step, _ = make_train_step(model, opt, loss_fn)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    lr_sum = 0.0
    for i, (jbatch, tbatch) in enumerate(pairs):
        state, jloss, *_ = jstep(state, jbatch)
        loss = step(tbatch)[0]
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        ref = gps_params_from_jax(np_tree(state.params))
        lr_sum += float(opt.opt.param_groups[0]["lr"])
        for name, p in model.state_dict().items():
            if name.endswith("attn.key.bias"):
                # Its gradient is zero in exact arithmetic (it shifts a
                # query's scores all alike): Adam moves it by rounding noise
                # alone, in each package its own, by at most about lr a
                # step.  Held to that bound, not to each other.
                assert np.abs(ref[name]).max() <= lr_sum
                assert float(p.abs().max()) <= lr_sum
            else:
                assert_close(p, ref[name], 1e-4)
            if i == 0:     # lr 0 at the first update
                assert torch.equal(p, initial[name])


# --- the configs through run_experiment ------------------------------------

def _small(path, num_graphs=32, **changes):
    cfg = load_config(path)
    cfg.data.num_graphs = num_graphs
    cfg.data.batch_size = 8
    cfg.mpnn.hidden_channels = HIDDEN
    cfg.mpnn.num_layers = 2
    cfg.mpnn.num_heads = 2
    cfg.mpnn.dropout = 0.0
    cfg.training.epochs = 2
    cfg.training.eval_period = 1
    for key, value in changes.items():
        section, field = key.split(".")
        setattr(getattr(cfg, section), field, value)
    return cfg


@pytest.mark.parametrize("path,num_graphs", [(GPS_FUNC, 32),
                                             (GPS_STRUCT, 32),
                                             (GPS_VOC, 24)])
def test_gps_configs_train_on_the_device_route_as_jax(path, num_graphs,
                                                      monkeypatch):
    """The three GPS configs, shrunk (VOC at the 24 graphs of JAX's own
    test_gps_node_level_cli_smoke), train with finite losses through the
    route the JAX runner takes for the same config and data: the
    device-resident dataset (fit_device; captured on the card).  The VOC
    graphs exceed the 512-node slot limit, so neither package takes dense
    slots, and both route them to the device dataset, whose batches are
    slotted at the largest graph's size: GPS trains there in both."""
    cfg = _small(path, num_graphs)
    seen = {}
    fit_device = runner.fit_device

    def spy(*args, **kw):
        seen.update(kw)
        return fit_device(*args, **kw)

    monkeypatch.setattr(runner, "fit_device", spy)
    monkeypatch.setattr(runner, "fit", None)
    result = runner.run_experiment(cfg, device="cpu")
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert isinstance(result.model, GPSModel)

    jcfg = jax_load_config(path)
    jcfg.data.num_graphs = num_graphs
    jdm = JaxDataModule.from_config(jcfg.data)
    dm = DataModule.from_config(cfg.data)
    assert dm.enable_dense_slots() == jdm.enable_dense_slots() == (
        path != GPS_VOC)
    assert seen["slot"] == dm.slot_nodes == jdm.slot_nodes
    assert seen["node_level"] == (path == GPS_VOC)
    assert runner._use_device_dataset(cfg, dm) == \
        jax_runner._use_device_dataset(jcfg, jdm) is True


def test_gps_without_slots_raises_in_both():
    """The VOC GPS config on the host loop (device_dataset off): its
    graphs exceed the slot limit, so the batches carry no slots, and both
    packages raise the slotted-layout ValueError; no fallback."""
    cfg = _small(GPS_VOC, 24, **{"runtime.device_dataset": "off"})
    with pytest.raises(ValueError, match="slotted"):
        runner.run_experiment(cfg, device="cpu")
    jcfg = jax_load_config(GPS_VOC)
    jcfg.data.num_graphs = 24
    jcfg.data.batch_size = 8
    jcfg.mpnn.hidden_channels = HIDDEN
    jcfg.mpnn.num_heads = 2
    jcfg.runtime.device_dataset = "off"
    jcfg.training.epochs = 1
    with pytest.raises(ValueError, match="slotted"):
        jax_runner.run_experiment(jcfg)


def test_build_mpnn_builds_gps():
    """build_mpnn's GPS branch reads the local module and the edge width."""
    cfg = MPNNConfig(conv_type="gps", activation="relu", hidden_channels=16,
                     num_layers=3, num_heads=2, gps_local_conv="gatedgcn")
    model = build_mpnn(cfg, 9, 11, num_edge_features=3)
    assert isinstance(model, GPSModel) and len(model.layers) == 3
    assert model.edge_encoder.weight.shape == (16, 3)
    assert model.layers[0].local.norm_x is None
