"""The port's SCN clustering stage against the JAX package's: ``GraphConv``
(sparse with and without a CSR plan, dense-slot; with and without the
self-loop weight), ``mincut_pool`` (a masked batch, an edgeless graph
block), the SCN on the sparse and the dense-slot branch, and the two
clustering trainers, host and device-resident, for 3 steps from mapped
weights.

Tolerances (float32): forward values rtol=1e-5, atol=1e-5*max|ref|;
gradients and losses after optimizer steps atol=1e-4*max|ref|.  Cluster
assignments are an argmax: they are held equal on every node whose top
two softmax values differ by more than 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.config.config import HSCNConfig as JaxHSCNConfig
from graph_hscn_tpu.config.config import load_config as jax_load_config
from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
from graph_hscn_tpu.models.layers import GraphConv as JaxGraphConv
from graph_hscn_tpu.models.scn import build_scn as jax_build_scn
from graph_hscn_tpu.ops import dense as jdense
from graph_hscn_tpu.ops.spmm import gcn_norm_weights as jax_gcn_norm
from graph_hscn_tpu.train import clustering as jclustering
from graph_hscn_tpu.train import device_data as jdd
from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import scn_params_from_jax
from graph_hscn_tpu_torch.models.layers import GraphConv
from graph_hscn_tpu_torch.models.scn import build_scn
from graph_hscn_tpu_torch.ops import dense, spmm
from graph_hscn_tpu_torch.ops.cuda import spmm_kernel
from graph_hscn_tpu_torch.ops.spmm import gcn_norm_weights
from graph_hscn_tpu_torch.train import clustering
from graph_hscn_tpu_torch.train.device_data import DeviceDataset, assemble

ROOT = Path(__file__).parents[1]
PEPTIDES_HSCN = ROOT / "configs" / "HSCN" / "peptides_func_HSCN.yaml"
GAP = 1e-5    # top-2 softmax gap above which assignments must agree


def assert_close(got, ref, tol=1e-5):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


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


@pytest.fixture(scope="module")
def graphs():
    return js.make_peptides_func(num_graphs=5, seed=31, mean_nodes=28.0)


def pack(graphs, layout: str):
    """(JAX batch, port batch on the CPU) of the same graphs: "sparse",
    "plan" (the port's batch with its CSR plan) or "slotted"."""
    slot = (((max(g.num_nodes for g in graphs) + 7) // 8) * 8
            if layout == "slotted" else None)
    n = len(graphs)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, n),
                           slot_nodes=slot)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, n),
                           slot_nodes=slot,
                           with_spmm_plan=layout == "plan").to("cpu")
    return jbatch, tbatch


# --- GraphConv ------------------------------------------------------------

@pytest.mark.parametrize("self_weight", [True, False])
@pytest.mark.parametrize("layout", ["sparse", "plan", "slotted"])
def test_graph_conv_matches_jax(graphs, layout, self_weight, pallas_backend,
                                monkeypatch):
    """GraphConv with gcn-normalized weights (SCN's use): the output and the
    gradients of a fixed random weighting of it with respect to the
    kernels, the bias and x.  "plan" runs the port's CSR kernel path (its
    plain version here)."""
    jbatch, tbatch = pack(graphs, layout)
    n = tbatch.num_nodes_padded
    feats = 6
    calls = []
    if layout == "slotted":
        adj = jdense.build_dense_adj(jbatch, weighted=False)
        deg = jnp.sum(adj, -1) + 1.0
        inv = jax.lax.rsqrt(deg)
        jkw = dict(dense_adj=adj * inv[:, :, None] * inv[:, None, :],
                   self_weight=(inv * inv).reshape(-1))
        tkw = {k: torch.tensor(np.asarray(v)) for k, v in jkw.items()}
    else:
        w, diag = jax_gcn_norm(jbatch.senders, jbatch.receivers,
                               jbatch.edge_mask, n)
        jkw = dict(edge_weight=w, self_weight=diag)
        tw, tdiag = gcn_norm_weights(tbatch.senders, tbatch.receivers,
                                     tbatch.edge_mask, n)
        tkw = dict(edge_weight=tw, self_weight=tdiag, plan=tbatch.spmm)
    if not self_weight:
        jkw.pop("self_weight")
        tkw.pop("self_weight")
    args = (jbatch.senders, jbatch.receivers, jbatch.edge_mask)
    jconv = JaxGraphConv(features=feats)
    params = jconv.init(jax.random.PRNGKey(2), jbatch.node_feat, *args,
                        num_nodes=n, **jkw)["params"]
    params = dict(params, bias=jnp.linspace(-0.5, 0.5, feats))
    r = np.random.default_rng(5).normal(size=(n, feats)).astype(np.float32)

    def jloss(p, x):
        out = jconv.apply({"params": p}, x, *args, num_nodes=n, **jkw)
        return jnp.sum(out * r), out

    (_, jout), (jg, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        params, jbatch.node_feat)
    conv = GraphConv(tbatch.node_feat.shape[1], feats)
    conv.load_state_dict({
        k.removeprefix("convs.0."): v for k, v in
        scn_params_from_jax({"GraphConv_0": params}).items()})
    x = tbatch.node_feat.clone().requires_grad_(True)
    orig = spmm_kernel.csr_spmm_plain
    monkeypatch.setattr(spmm_kernel, "csr_spmm_plain",
                        lambda *a: calls.append(1) or orig(*a))
    out = conv(x, tbatch.senders, tbatch.receivers, tbatch.edge_mask,
               num_nodes=n, **tkw)
    (out * torch.tensor(r)).sum().backward()
    assert bool(calls) == (layout == "plan")
    assert_close(out, jout)
    assert_close(conv.weight_rel.grad.t(), jg["kernel_rel"], 1e-4)
    assert_close(conv.weight_root.grad.t(), jg["kernel_root"], 1e-4)
    assert_close(conv.bias.grad, jg["bias"], 1e-4)
    assert_close(x.grad, jgx, 1e-4)


# --- mincut_pool ----------------------------------------------------------

@pytest.mark.parametrize("case", ["masked", "edgeless"])
def test_mincut_pool_matches_jax(case):
    """x_pool, adj_pool and both losses; and the gradients of a fixed
    random weighting of all four with respect to s_logits and x.  "masked":
    3 graph blocks with padding rows; "edgeless": block 1 has no edge, so
    its MinCUT denominator is 0 and clamped (its cut term stays 0)."""
    rng = np.random.default_rng(11)
    G, n, F, K = 3, 7, 4, 3
    x = rng.normal(size=(G, n, F)).astype(np.float32)
    s_logits = rng.normal(size=(G, n, K)).astype(np.float32)
    adj = (rng.random((G, n, n)) < 0.4).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1)) * (1 - np.eye(n))
    mask = np.ones((G, n), bool)
    if case == "masked":
        mask[0, 5:] = False
        mask[2, 3:] = False
    else:
        adj[1] = 0.0
        mask[1, 6:] = False
    adj = (adj * mask[:, :, None] * mask[:, None, :]).astype(np.float32)
    wts = [rng.normal(size=s).astype(np.float32)
           for s in ((G, K, F), (G, K, K), (), ())]

    def jfn(s, xx):
        outs = jdense.mincut_pool(xx, jnp.asarray(adj), s, jnp.asarray(mask))
        return sum(jnp.sum(o * w) for o, w in zip(outs, wts)), outs

    (_, jouts), (jgs, jgx) = jax.value_and_grad(jfn, (0, 1), has_aux=True)(
        jnp.asarray(s_logits), jnp.asarray(x))
    ts = torch.tensor(s_logits, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    outs = dense.mincut_pool(tx, torch.tensor(adj), ts, torch.tensor(mask))
    sum((o * torch.tensor(w)).sum() for o, w in zip(outs, wts)).backward()
    for got, ref in zip(outs, jouts):
        assert bool(torch.isfinite(got).all())
        assert_close(got, ref)
    if case == "edgeless":
        assert float(outs[2].detach()) != 0.0   # the other blocks still cut
    assert_close(ts.grad, jgs, 1e-4)
    assert_close(tx.grad, jgx, 1e-4)


def test_mincut_pool_empty_block_stays_finite():
    """A graph block with every row masked (an empty graph slot): the
    outputs equal JAX's, and the port's gradients are finite, equal to
    JAX's on the other blocks and 0 on the empty one.  JAX's are NaN
    there: the Frobenius norm of the block's zero S S^T has an infinite
    derivative at 0 (sqrt), which torch's norm takes as 0."""
    rng = np.random.default_rng(12)
    G, n, F, K = 2, 6, 3, 3
    x = rng.normal(size=(G, n, F)).astype(np.float32)
    s_logits = rng.normal(size=(G, n, K)).astype(np.float32)
    adj = np.zeros((G, n, n), np.float32)
    adj[0, [0, 1, 2], [1, 2, 0]] = 1.0
    adj[0] = np.maximum(adj[0], adj[0].T)
    mask = np.zeros((G, n), bool)
    mask[0] = True

    def jfn(s, xx):
        _, _, mc, o = jdense.mincut_pool(xx, jnp.asarray(adj), s,
                                         jnp.asarray(mask))
        return mc + o

    jval, jgs = jax.value_and_grad(jfn)(jnp.asarray(s_logits),
                                        jnp.asarray(x))
    jgs = np.asarray(jgs)
    assert np.isnan(jgs[1]).all() and np.isfinite(jgs[0]).all()
    ts = torch.tensor(s_logits, requires_grad=True)
    _, _, mc, o = dense.mincut_pool(torch.tensor(x), torch.tensor(adj), ts,
                                    torch.tensor(mask))
    (mc + o).backward()
    assert_close(mc + o, jval)
    assert bool(torch.isfinite(ts.grad).all())
    assert_close(ts.grad[0], jgs[0], 1e-4)
    assert not ts.grad[1].any()


# --- SCN ------------------------------------------------------------------

SCN_CFG = JaxHSCNConfig(activation="relu", hidden_channels=8, num_layers=2,
                        num_clusters=3, mp_units=[8, 8])


def jax_scn(jbatch, max_nodes):
    model = jax_build_scn(SCN_CFG, jbatch.node_feat.shape[1], max_nodes)
    params = model.init(jax.random.PRNGKey(7), jbatch, train=False)["params"]
    # Nonzero biases, so that the bias gradients are held too.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (v + 0.1 * jnp.sin(jnp.arange(v.size, dtype=v.dtype)
                                           ).reshape(v.shape)
                         if path[-1].key == "bias" else v), params)
    return model, params


@pytest.mark.parametrize("layout", ["sparse", "plan", "slotted"])
def test_scn_matches_jax(graphs, layout, pallas_backend):
    """SCN (mp_units [8, 8], K=3) on the sparse branch (with and without
    the port's CSR plan) and on the dense-slot branch: s, mc_loss, o_loss
    and the gradient of mc + o with respect to every parameter."""
    jbatch, tbatch = pack(graphs, layout)
    max_nodes = ((max(g.num_nodes for g in graphs) + 7) // 8) * 8
    jmodel, params = jax_scn(jbatch, max_nodes)

    def jloss(p):
        s, mc, o = jmodel.apply({"params": p}, jbatch, train=True)
        return mc + o, (s, mc, o)

    (_, (js_, jmc, jo)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    model = build_scn(SCN_CFG, tbatch.node_feat.shape[1], max_nodes)
    model.load_state_dict(scn_params_from_jax(params))
    s, mc, o = model(tbatch)
    (mc + o).backward()
    assert_close(s, js_)
    assert_close(mc, jmc)
    assert_close(o, jo)
    want = scn_params_from_jax(jgrads)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert_close(p.grad, want[name], 1e-4)


class RecordingLogger:
    """A logger that keeps the clustering losses (the JAX trainer reports
    each epoch's mean through ``wandb_log``)."""

    def __init__(self):
        self.losses = []

    def info(self, msg):
        pass

    def wandb_log(self, d):
        self.losses.append(d["cluster_loss"])


class FixedInit:
    """A JAX SCN whose ``init`` returns given params: the JAX trainers
    start from the weights the port is given."""

    def __init__(self, model, params):
        self.model, self.params = model, params

    def init(self, *args, **kwargs):
        return {"params": self.params}

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


def small_dms(layout: str, num_graphs: int, batch_size: int):
    """The peptides HSCN config's data on both sides, shrunk; "slotted"
    turns dense slots on."""
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(PEPTIDES_HSCN)
        cfg.data.num_graphs = num_graphs
        cfg.data.batch_size = batch_size
        cfg.hscn.mp_units = [8, 8]
        cfg.hscn.num_clusters = 3
        cfg.hscn.cluster_epochs = 3
        cfgs.append(cfg)
    jdm = JaxDataModule.from_config(cfgs[0].data)
    dm = DataModule.from_config(cfgs[1].data)
    if layout == "slotted":
        assert jdm.enable_dense_slots() and dm.enable_dense_slots()
    return cfgs, jdm, dm


def clear_gap(s: np.ndarray) -> np.ndarray:
    """Rows of softmax values whose top two differ by more than GAP."""
    top = np.sort(s, axis=-1)
    return (top[:, -1] - top[:, -2]) > GAP


@pytest.mark.parametrize("layout", ["sparse", "slotted"])
def test_train_clustering_follows_jax(layout):
    """train_clustering on the full dataset (5 graphs, one batch) for 3
    epochs of one step each, from mapped weights: each epoch's loss within
    1e-4 relative of JAX's, and equal assignments on every node with a
    clear top-2 gap (almost all of them).  The batch holds exactly the 5
    graphs: on a slotted batch with an empty graph slot the JAX gradient
    is NaN (test_mincut_pool_empty_block_stays_finite)."""
    (jcfg, cfg), jdm, dm = small_dms(layout, 5, 5)
    max_nodes = ((jdm.max_nodes_per_graph() + 7) // 8) * 8
    jmodel, params = jax_scn(jdm.example_batch(), max_nodes)
    jlog = RecordingLogger()
    jclusters = jclustering.train_clustering(
        jlog, jdm, FixedInit(jmodel, params), jcfg.hscn, jcfg.optim, seed=3)
    model = build_scn(cfg.hscn, dm.num_features, max_nodes)
    model.load_state_dict(scn_params_from_jax(params))
    clusters, losses = clustering.train_clustering(
        RecordingLogger(), dm, model, cfg.hscn, cfg.optim, seed=3,
        device="cpu")
    assert len(jlog.losses) == len(losses) == 3
    np.testing.assert_allclose(losses, jlog.losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    ok = total = 0
    with torch.no_grad():
        for g, c, jc in zip(dm.graphs, clusters, jclusters):
            b = tb.pack_batch([g], tb.PadBudget.for_dataset([g], 1),
                              slot_nodes=dm.slot_nodes).to("cpu")
            s = model(b)[0][b.node_mask].numpy()
            assert (s.argmax(-1) == c).all()
            clear = clear_gap(s)
            np.testing.assert_array_equal(c[clear], jc[clear])
            ok, total = ok + clear.sum(), total + len(c)
    assert ok >= 0.9 * total


def test_train_clustering_device_follows_jax():
    """train_clustering_device on 6 peptides graphs in batches of 3 (2 steps
    an epoch, no dummy slot, as above), from mapped weights: each epoch's
    loss, and the assignments written back into the dataset, as in
    JAX."""
    (jcfg, cfg), jdm, dm = small_dms("slotted", 6, 3)
    jds = jdd.DeviceDataset.build(jdm.graphs, slot=jdm.slot_nodes,
                                  with_cluster=True)
    ds = DeviceDataset.build(dm.graphs, slot=dm.slot_nodes, device="cpu",
                             with_cluster=True)
    assert ds.cluster is not None and not ds.cluster.any()
    jmodel, params = jax_scn(jdm.example_batch(), jds.slot)
    jlog = RecordingLogger()
    jds = jclustering.train_clustering_device(
        jlog, jds, 3, FixedInit(jmodel, params), jcfg.hscn, jcfg.optim,
        seed=3)
    model = build_scn(cfg.hscn, dm.num_features, ds.slot)
    model.load_state_dict(scn_params_from_jax(params))
    ds, losses = clustering.train_clustering_device(
        RecordingLogger(), ds, 3, model, cfg.hscn, cfg.optim, seed=3)
    np.testing.assert_allclose(losses, jlog.losses, rtol=1e-4)
    jcluster = np.asarray(jds.cluster)
    with torch.no_grad():
        batch = assemble(ds, torch.arange(ds.num_graphs, dtype=torch.int32))
        s = model(batch)[0].reshape(ds.num_graphs, ds.slot, -1).numpy()
    real = np.arange(ds.slot)[None, :] < ds.n_node.numpy()[:, None]
    clear = clear_gap(s.reshape(-1, s.shape[-1])).reshape(real.shape) & real
    got = ds.cluster.numpy()
    np.testing.assert_array_equal(got[real], s.argmax(-1)[real])
    np.testing.assert_array_equal(got[clear], jcluster[clear])
    assert clear.sum() >= 0.9 * real.sum()
