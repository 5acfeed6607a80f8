"""The port's HSCN against the JAX package's: ``virtual_node_features``
(with and without quirk #8's index shift, on graphs with empty clusters),
the vv adjacency (triangular and clique), ``DenseGCN``, ``DenseGAT``, the
bipartite ``GATConv`` on unsorted receivers, the whole ``HSCN`` over its
grid of relation types, feedback and readouts (logits, every layer's
relation outputs and virtual states, gradients), 5 AdamW steps from mapped
weights, the ``__graft_entry__`` flagship setup, and the HSCN configs
through ``run_experiment`` on the CPU.

Without ``virtual_feedback`` the lv and vv relations do not reach the
logits (quirk #17), so every layer's virtual state x_v is held on its own,
and feedback runs with nonzero ``VLDense`` weights.

Tolerances (float32): forward values rtol=1e-5, atol=1e-5*max|ref|;
gradients and weights after optimizer steps atol=1e-4*max|ref|.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.models import hscn as jhscn
from graph_hscn_tpu.models.layers import GATConv as JaxGATConv
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.loop import make_train_step as jax_make_train_step
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu_torch import hscn_pipeline
from graph_hscn_tpu_torch.config.config import HSCNConfig, load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models import hscn
from graph_hscn_tpu_torch.models.convert import hscn_params_from_jax
from graph_hscn_tpu_torch.models.layers import GATConv
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.runner import run_experiment
from graph_hscn_tpu_torch.train.loop import make_train_step
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

ROOT = Path(__file__).parents[1]
HSCN_CONFIGS = ROOT / "configs" / "HSCN"
K = 3


def assert_close(got, ref, tol=1e-5):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture
def pallas_backend():
    prev = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        yield
    finally:
        spmm.set_backend(prev)


@pytest.fixture(scope="module")
def graphs():
    """5 peptides graphs with cluster ids: graph 1 uses clusters {0, 2}
    only, graph 2 only cluster 1, graph 3 only {2}; the others all K."""
    gs = js.make_peptides_func(num_graphs=5, seed=17, mean_nodes=22.0)
    rng = np.random.default_rng(4)
    pools = [[0, 1, 2], [0, 2], [1], [2], [0, 1, 2]]
    return [g.replace(cluster=rng.choice(p, size=g.num_nodes)
                      .astype(np.int32)) for g, p in zip(gs, pools)]


def pack(graphs, layout: str, dataset=None):
    """(JAX batch, port batch on the CPU): "plan" (the port's batch with
    its CSR plan; JAX's on the CPU takes its XLA path either way) or
    "slotted"; padded to the budget of ``dataset`` (default: the graphs)
    in batches of len(graphs)."""
    dataset = dataset or graphs
    slot = (((max(g.num_nodes for g in dataset) + 7) // 8) * 8
            if layout == "slotted" else None)
    n = len(graphs)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(dataset, n),
                           slot_nodes=slot)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(dataset, n),
                           slot_nodes=slot,
                           with_spmm_plan=layout == "plan").to("cpu")
    return jbatch, tbatch


def assert_grad_close(got, ref, scale: float):
    """A gradient within 1e-4*max|ref|, max|ref| taken no smaller than
    1e-3 of ``scale``, the largest gradient of the case.  The floor is for
    the bipartite GAT's receiver side (x_dst, kernel_dst, att_dst): it
    shifts all of a receiver's logits before leaky_relu, so where they all
    lie on one side of its kink the softmax absorbs the shift and the
    gradient is 0 but for rounding (~1e-9 of the scale), on both sides."""
    ref = np.asarray(ref, np.float32)
    floor = max(float(np.abs(ref).max()), 1e-3 * scale)
    np.testing.assert_allclose(
        np.asarray(got.detach(), np.float32), ref, rtol=1e-5,
        atol=1e-4 * floor)


def tensors(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


# --- the virtual nodes ----------------------------------------------------

@pytest.mark.parametrize("index_shift", [False, True])
def test_virtual_node_features_match_jax(graphs, index_shift):
    """x_v, v_active and vid, on graphs with empty clusters; with the index
    shift a graph's features move to its cyclically previous occupied
    cluster, which differs from the unshifted result."""
    jbatch, tbatch = pack(graphs, "plan")
    jx, jact, jvid = jhscn.virtual_node_features(jbatch, K, index_shift)
    x_v, act, vid = hscn.virtual_node_features(tbatch, K, index_shift)
    assert_close(x_v, jx)
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(vid.numpy(), np.asarray(jvid))
    assert not act.numpy().reshape(-1, K)[:-1].all()   # empty clusters
    if index_shift:
        x0, _, _ = hscn.virtual_node_features(tbatch, K, False)
        assert not torch.equal(x_v, x0)


@pytest.mark.parametrize("pattern", ["triangular", "clique"])
def test_vv_adjacency_matches_jax(pattern):
    rng = np.random.default_rng(8)
    act = rng.random(6 * 5) < 0.6
    act[:5] = [True, True, False, True, True]
    ref = jhscn._vv_adjacency(jnp.asarray(act), 6, 5, pattern, jnp.float32)
    got = hscn.vv_adjacency(torch.tensor(act), 6, 5, pattern, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if pattern == "triangular":
        assert got[0].diagonal().any()   # some self loops (quirk #9)


def relation_case(rel: str, heads: int):
    """(JAX module, port module, inputs) of a vv relation on random
    [G, K, F] states and a triangular adjacency."""
    rng = np.random.default_rng(heads)
    G, F, C = 4, 5, 6
    x = rng.normal(size=(G, K, F)).astype(np.float32)
    act = rng.random(G * K) < 0.7
    adj = jhscn._vv_adjacency(jnp.asarray(act), G, K, "triangular",
                              jnp.float32)
    if rel == "gcn":
        return (jhscn.DenseGCN(features=C), hscn.DenseGCN(F, C), x, adj)
    return (jhscn.DenseGAT(features=C, heads=heads),
            hscn.DenseGAT(F, C, heads=heads), x, adj)


def nonzero_bias(params):
    """The params with biases set to a fixed nonzero pattern, so that the
    bias gradients are held too."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (0.1 * jnp.sin(1.0 + jnp.arange(v.size, dtype=v.dtype)
                                       ).reshape(v.shape)
                         if path[-1].key == "bias" else v), params)


@pytest.mark.parametrize("rel,heads", [("gcn", 1), ("gat", 1), ("gat", 2)])
def test_dense_relation_matches_jax(rel, heads):
    """DenseGCN and DenseGAT (H=1 and H=2): the output and the gradients of
    a fixed random weighting of it with respect to the weights and x."""
    jmod, mod, x, adj = relation_case(rel, heads)
    params = nonzero_bias(jmod.init(jax.random.PRNGKey(1), x, adj)["params"])
    r = np.random.default_rng(3).normal(
        size=jmod.apply({"params": params}, x, adj).shape).astype(np.float32)

    def jloss(p, xx):
        out = jmod.apply({"params": p}, xx, adj)
        return jnp.sum(out * r), out

    (_, jout), (jg, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        params, x)
    state = {"weight": torch.tensor(np.asarray(params.get(
        "kernel", params.get("kernel_src"))).T)}
    state.update({k: torch.tensor(np.asarray(v)) for k, v in params.items()
                  if not k.startswith("kernel")})
    mod.load_state_dict(state)
    tx, tadj = tensors(x, adj)
    tx.requires_grad_(True)
    out = mod(tx, tadj)
    (out * torch.tensor(r)).sum().backward()
    assert_close(out, jout)
    assert_close(tx.grad, jgx, 1e-4)
    for name, p in mod.named_parameters():
        key = "kernel_src" if rel == "gat" else "kernel"
        ref = (np.asarray(jg[key]).T if name == "weight"
               else jg[name])
        assert_close(p.grad, ref, 1e-4)


@pytest.mark.parametrize("heads", [1, 2])
def test_bipartite_gat_matches_jax(graphs, heads, pallas_backend):
    """The lv relation: every real node attends to its cluster's virtual
    node (receivers vid, not sorted), no self loops; the output and the
    gradients with respect to the weights, x and x_dst.  The port's batch
    has a CSR plan and the kernel backend: the bipartite branch ignores
    both."""
    jbatch, tbatch = pack(graphs, "plan")
    x_v, _, vid = jhscn.virtual_node_features(jbatch, K)
    N, G = tbatch.num_nodes_padded, tbatch.num_graphs_padded
    senders = jnp.arange(N, dtype=jnp.int32)
    assert (np.diff(np.asarray(vid)[np.asarray(jbatch.node_mask)]) < 0).any()
    F = jbatch.node_feat.shape[1]
    jconv = JaxGATConv(features=4, heads=heads, add_self_loops=False)
    args = (senders, vid, jbatch.node_mask)
    params = nonzero_bias(jconv.init(
        jax.random.PRNGKey(heads), jbatch.node_feat, *args, x_dst=x_v,
        num_dst_nodes=G * K)["params"])
    r = np.random.default_rng(2).normal(size=(G * K, 4 * heads)).astype(
        np.float32)

    def jloss(p, x, xd):
        out = jconv.apply({"params": p}, x, *args, x_dst=xd,
                          num_dst_nodes=G * K)
        return jnp.sum(out * r), out

    (_, jout), (jg, jgx, jgxd) = jax.value_and_grad(
        jloss, (0, 1, 2), has_aux=True)(params, jbatch.node_feat, x_v)
    conv = GATConv(F, 4, heads=heads, add_self_loops=False, dst_features=F)
    conv.load_state_dict({k.replace("lv.0.", ""): v for k, v in
                          hscn_params_from_jax({"GATConv_0": params}).items()})
    x = tbatch.node_feat.clone().requires_grad_(True)
    xd = torch.tensor(np.asarray(x_v), requires_grad=True)
    out = conv(x, torch.arange(N), torch.tensor(np.asarray(vid)).long(),
               tbatch.node_mask, plan=tbatch.spmm, x_dst=xd,
               num_dst_nodes=G * K)
    (out * torch.tensor(r)).sum().backward()
    assert_close(out, jout)
    pairs = [(x.grad, jgx), (xd.grad, jgxd),
             (conv.weight.grad.t(), jg["kernel_src"]),
             (conv.weight_dst.grad.t(), jg["kernel_dst"])] + [
                 (getattr(conv, k).grad, jg[k])
                 for k in ("att_src", "att_dst", "bias")]
    scale = max(float(np.abs(np.asarray(ref)).max()) for _, ref in pairs)
    for got, ref in pairs:
        assert_grad_close(got, ref, scale)


# --- the model ------------------------------------------------------------

def jax_model(ll, vv, feedback, readout, heads=2, num_classes=5):
    return jhscn.HSCN(lv_conv="GAT", ll_conv=ll, vv_conv=vv,
                      activation="relu", hidden_channels=8,
                      num_classes=num_classes, num_layers=2, num_clusters=K,
                      num_heads=heads, virtual_feedback=feedback,
                      readout=readout)


def port_model(ll, vv, feedback, readout, num_features, heads=2,
               num_classes=5):
    cfg = HSCNConfig(ll_conv_type=ll, vv_conv_type=vv, hidden_channels=8,
                     num_layers=2, num_clusters=K, num_heads=heads,
                     virtual_feedback=feedback)
    return hscn.build_hscn(cfg, num_features, num_classes, readout=readout)


def jax_params(jmodel, jbatch, feedback):
    """Initial params with nonzero biases and, with feedback, nonzero
    VLDense kernels (their zero init would hide the channel)."""
    params = nonzero_bias(jmodel.init(jax.random.PRNGKey(5), jbatch,
                                      train=False)["params"])
    if feedback:
        rng = np.random.default_rng(6)
        params = {k: (dict(v, kernel=jnp.asarray(rng.normal(
            scale=0.3, size=v["kernel"].shape).astype(np.float32)))
            if k.startswith("VLDense") else v) for k, v in params.items()}
    return params


def relation_outputs(model):
    """Forward hooks keeping each layer's ll, lv and vv outputs."""
    seen = {}
    for rel in ("ll", "lv", "vv"):
        for i, m in enumerate(getattr(model, rel)):
            m.register_forward_hook(
                lambda _m, _a, out, key=(rel, i): seen.__setitem__(key, out))
    return seen


def jax_relation_outputs(inter, ll_gat: bool, vv_gat: bool, layers: int):
    """The same from flax's captured intermediates."""
    out = {}
    for i in range(layers):
        out["ll", i] = inter[f"GATConv_{2 * i}" if ll_gat
                             else f"GCNConv_{i}"]["__call__"][0]
        out["lv", i] = inter[f"GATConv_{2 * i + 1}" if ll_gat
                             else f"GATConv_{i}"]["__call__"][0]
        out["vv", i] = inter[f"DenseGAT_{i}" if vv_gat
                             else f"DenseGCN_{i}"]["__call__"][0]
    return out


GRID = [(ll, vv, fb, ro) for ll in ("GCN", "GAT") for vv in ("GCN", "GAT")
        for fb in (False, True) for ro in ("mean", "none")]


@pytest.mark.parametrize("ll,vv,feedback,readout", GRID)
def test_hscn_matches_jax(graphs, ll, vv, feedback, readout, pallas_backend):
    """The HSCN (hidden 8, 2 layers, K=3, 2 heads) with weights carried
    across, on a batch with a CSR plan (the port's ll relation takes the
    kernel path's plain versions): the logits; every layer's ll, lv and vv
    outputs and its virtual state x_v = relu(lv + vv) on active clusters;
    and the gradient of a fixed random weighting of the logits with
    respect to every parameter (0 where one does not reach them)."""
    jbatch, tbatch = pack(graphs, "plan")
    jmodel = jax_model(ll, vv, feedback, readout)
    params = jax_params(jmodel, jbatch, feedback)
    jlogits, state = jmodel.apply({"params": params}, jbatch, train=False,
                                  capture_intermediates=True,
                                  mutable=["intermediates"])
    r = np.random.default_rng(9).normal(size=jlogits.shape).astype(
        np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jmodel.apply(
        {"params": p}, jbatch, train=False) * r))(params)
    model = port_model(ll, vv, feedback, readout, tbatch.node_feat.shape[1])
    model.load_state_dict(hscn_params_from_jax(params))
    seen = relation_outputs(model)
    logits = model(tbatch)
    (logits * torch.tensor(r)).sum().backward()
    assert_close(logits, jlogits)
    want = jax_relation_outputs(state["intermediates"], ll == "GAT",
                                vv == "GAT", 2)
    active = hscn.virtual_node_features(tbatch, K)[1].numpy()[:, None]

    def x_v(lv, vv):
        lv, vv = np.asarray(lv), np.asarray(vv).reshape(len(active), -1)
        return np.where(active, np.maximum(lv + vv, 0.0), 0.0)

    for i in range(2):
        for rel in ("ll", "lv", "vv"):
            assert_close(seen[rel, i], want[rel, i])
        assert_close(x_v(seen["lv", i].detach(), seen["vv", i].detach()),
                     x_v(want["lv", i], want["vv", i]))
    grads = hscn_params_from_jax(jgrads)
    assert set(grads) == {k for k, _ in model.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_grad_close(g, grads[name], scale)
    inert = [n for n in grads if n.startswith(("lv.", "vv."))]
    assert any(np.abs(grads[n].numpy()).max() > 0 for n in inert) == feedback


@pytest.mark.parametrize("index_shift,triangular", [(True, True),
                                                   (False, False)])
def test_hscn_slotted_matches_jax(graphs, index_shift, triangular):
    """The dense-slot branch (ll GCN on the normalized block adjacency),
    with feedback, quirk #8's index shift and the triangular vv pattern, or
    neither and the clique: logits and gradients."""
    jbatch, tbatch = pack(graphs, "slotted")
    pattern = "triangular" if triangular else "clique"
    jmodel = jax_model("GCN", "GCN", True, "mean").clone(
        index_shift=index_shift, vv_pattern=pattern)
    params = jax_params(jmodel, jbatch, True)
    r = np.random.default_rng(1).normal(
        size=(tbatch.num_graphs_padded, 5)).astype(np.float32)
    jlogits = jmodel.apply({"params": params}, jbatch)
    jgrads = jax.grad(lambda p: jnp.sum(jmodel.apply({"params": p}, jbatch)
                                        * r))(params)
    cfg = HSCNConfig(hidden_channels=8, num_layers=2, num_clusters=K,
                     num_heads=2, virtual_feedback=True)
    model = hscn.build_hscn(cfg, tbatch.node_feat.shape[1], 5,
                            compat_triangular=triangular,
                            compat_index_shift=index_shift)
    model.load_state_dict(hscn_params_from_jax(params))
    logits = model(tbatch)
    (logits * torch.tensor(r)).sum().backward()
    assert_close(logits, jlogits)
    grads = hscn_params_from_jax(jgrads)
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in model.named_parameters():
        # The last layer's lv and vv reach no logit: no gradient (JAX: 0).
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_grad_close(g, grads[name], scale)


@pytest.mark.parametrize("ll,vv,feedback,layout", [
    ("GCN", "GCN", True, "plan"), ("GAT", "GAT", False, "slotted")])
def test_hscn_training_follows_jax(graphs, ll, vv, feedback, layout,
                                   pallas_backend):
    """5 AdamW steps (the peptides HSCN config's optimizer, lr 0.01, weight
    decay 5e-4) from mapped weights, cross entropy on graph labels: each
    step's loss within 1e-5 relative of JAX's, and the weights after within
    1e-4*max|ref| (relations the loss does not reach still decay)."""
    jbatches, tbatches = zip(*(pack(graphs[i:i + 2], layout, graphs)
                               for i in (0, 2, 3, 1, 0)))
    nf, nc = graphs[0].x.shape[1], graphs[0].y.shape[-1]
    jmodel = jax_model(ll, vv, feedback, "mean", num_classes=nc)
    tx = jax_build_opt("adamW", 0.01, 5e-4)
    state = jax_init_state(jmodel, tx, jbatches[0], seed=2)
    params = jax_params(jmodel, jbatches[0], feedback)
    state = dataclasses.replace(state, params=params,
                                opt_state=tx.init(params))
    jstep, _ = jax_make_train_step(jmodel, tx, "cross_entropy")
    jlosses = []
    for b in jbatches:
        state, loss, *_ = jstep(state, b)
        jlosses.append(float(loss))
    model = port_model(ll, vv, feedback, "mean", nf, num_classes=nc)
    model.load_state_dict(hscn_params_from_jax(params))
    opt = build_optimizer(model.parameters(), "adamW", 0.01, 5e-4)
    step, _ = make_train_step(model, opt, "cross_entropy")
    losses = [float(step(b)[0]) for b in tbatches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    final = hscn_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        state.params))
    for name, p in model.state_dict().items():
        assert_close(p, final[name], 1e-4)


def test_graft_entry_setup_matches_jax():
    """The flagship setup of ``__graft_entry__.entry()`` (hidden 32, 3
    layers, K=4, peptides-like batch of 8 graphs with random clusters):
    the port's logits equal JAX's with the weights carried across."""
    from __graft_entry__ import _make_hscn_and_batch
    jmodel, jbatch, jcfg = _make_hscn_and_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, train=False)[
        "params"]
    jlogits = jmodel.apply({"params": params}, jbatch, train=False)
    fields = {f.name for f in dataclasses.fields(GraphBatch)}
    tbatch = GraphBatch(**{k: getattr(jbatch, k) for k in fields
                           if k != "slot"}).to("cpu")
    cfg = HSCNConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(HSCNConfig)})
    model = hscn.build_hscn(cfg, tbatch.node_feat.shape[1], 10)
    model.load_state_dict(hscn_params_from_jax(params))
    assert (cfg.hidden_channels, cfg.num_layers, cfg.num_clusters) == (32, 3,
                                                                       4)
    with torch.no_grad():
        assert_close(model(tbatch), jlogits)


# --- the pipeline ---------------------------------------------------------

@pytest.mark.parametrize("name", [
    "peptides_func_HSCN", "peptides_func_HSCN_parity",
    "peptides_func_HSCN_feedback", "voc_superpixels_HSCN",
    "voc_superpixels_HSCN_sparse"])
def test_hscn_configs_train_through_run_experiment(name, monkeypatch):
    """Each single-device HSCN config, shrunk (24 graphs, 2 epochs, 1
    clustering epoch), through run_experiment on the CPU: finite losses;
    the clusters clustering assigned are the ones the HSCN's batches carry
    (their counts by cluster id, over 2 epochs of train, val and test
    batches, twice clustering's); and the route the JAX runner takes."""
    cfg = load_config(HSCN_CONFIGS / f"{name}.yaml")
    cfg.data.num_graphs = 24
    cfg.training.epochs = 2
    cfg.training.eval_period = 1
    cfg.hscn.cluster_epochs = 1
    k = cfg.hscn.num_clusters
    assigned, seen, routes = [], [], []
    for fn, counts in (("train_clustering", lambda out: np.concatenate(
            out[0])), ("train_clustering_device", lambda out: out[0].cluster[
                (torch.arange(out[0].slot)[None, :]
                 < out[0].n_node[:, None])].numpy())):
        def wrapped(*a, fn=fn, counts=counts, orig=getattr(hscn_pipeline,
                                                           fn), **kw):
            out = orig(*a, **kw)
            routes.append(fn)
            assigned.append(np.bincount(counts(out), minlength=k))
            return out
        monkeypatch.setattr(hscn_pipeline, fn, wrapped)
    orig_vnf = hscn.virtual_node_features

    def recording(batch, *a, **kw):
        seen.append(np.bincount(batch.cluster[batch.node_mask].numpy(),
                                minlength=k))
        return orig_vnf(batch, *a, **kw)

    monkeypatch.setattr(hscn, "virtual_node_features", recording)
    prev = spmm.get_backend()
    try:
        result = run_experiment(cfg, device="cpu")
    finally:
        spmm.set_backend(prev)
    losses = [v for h in result.history for key, v in h.items()
              if key.endswith("_loss")]
    assert result.epochs_run == 2 and np.isfinite(losses).all()
    assert len(result.cluster_losses) == 1
    assert np.isfinite(result.cluster_losses).all()
    device_route = name in ("peptides_func_HSCN", "peptides_func_HSCN_parity",
                            "peptides_func_HSCN_feedback",
                            "voc_superpixels_HSCN")
    assert routes == ["train_clustering_device" if device_route
                      else "train_clustering"]
    np.testing.assert_array_equal(sum(seen), 2 * assigned[0])


def test_edge_partition_hscn_still_raises():
    """Named when the edge-partitioned HSCN raised: the shipped config
    (mesh.shape [-1], here one rank) trains as shipped but for its data
    and epochs (8 graphs, 2 clustering epochs, 2 epochs), through the
    sharded SCN and HSCN (parallel/sharded_scn.py), with finite losses
    and its splits' plans."""
    cfg = load_config(HSCN_CONFIGS
                      / "voc_superpixels_HSCN_edge_partition.yaml")
    assert cfg.mesh.shape == [-1] and cfg.mesh.edge_partition
    cfg.data.num_graphs = 8
    cfg.hscn.cluster_epochs = cfg.training.epochs = 2
    result = run_experiment(cfg, device="cpu")
    assert result.num_train_steps == 2 and len(result.cluster_losses) == 2
    assert np.isfinite(result.cluster_losses).all()
    assert all(np.isfinite(h["train_loss"]) for h in result.history)
    assert set(result.partition) == {"train", "val", "test"}
