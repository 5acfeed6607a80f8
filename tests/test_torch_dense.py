"""The port's slotted dense path against the JAX package's: the dense
adjacency builders and re-blockers (ops/dense.py, batching.to_dense), the
dense GCNConv branch and the dense MPNN, forward and gradients with the
weights carried across; and the port's dense output against its own sparse
output on the same graphs.

Tolerance rtol=1e-5, atol=1e-5*max|ref| (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.models.layers import GCNConv as JaxGCNConv
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.ops import dense as jdense
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.models.convert import mpnn_params_from_jax
from graph_hscn_tpu_torch.models.layers import GCNConv
from graph_hscn_tpu_torch.models.mpnn import MPNN
from graph_hscn_tpu_torch.ops import dense


def assert_close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max()),
                                               1e-30))


@pytest.fixture(scope="module")
def graphs():
    return js.make_peptides_func(num_graphs=4, seed=71, mean_nodes=30.0)


def _slot(graphs):
    return ((max(g.num_nodes for g in graphs) + 7) // 8) * 8


def _batches(graphs, slot, weighted=False):
    """(JAX batch, port batch on the CPU) of the same graphs, slotted (or
    flat with slot None), optionally with random edge weights."""
    if weighted:
        rng = np.random.default_rng(3)
        graphs = [g.replace(edge_weight=rng.uniform(0.5, 2.0, g.num_edges)
                            .astype(np.float32)) for g in graphs]
    n = len(graphs)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, n),
                           slot_nodes=slot)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, n),
                           slot_nodes=slot)
    return jbatch, tbatch.to("cpu")


@pytest.mark.parametrize("weighted", [False, True])
def test_build_dense_adj_matches_jax(graphs, weighted):
    slot = _slot(graphs)
    jbatch, tbatch = _batches(graphs, slot, weighted)
    for w in (True, False):
        ref = np.asarray(jdense.build_dense_adj(jbatch, weighted=w))
        got = dense.build_dense_adj(tbatch, weighted=w)
        assert got.shape == (len(graphs), slot, slot)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            dense.resolve_dense_adj(tbatch, weighted=w).numpy(), ref)


def test_resolve_dense_adj_routes(graphs):
    _, flat = _batches(graphs, None)
    assert dense.resolve_dense_adj(flat) is None
    with pytest.raises(ValueError, match="slotted"):
        dense.build_dense_adj(flat)
    _, slotted = _batches(graphs, _slot(graphs))
    given = torch.ones(len(graphs), 2, 2)
    assert dense.resolve_dense_adj(slotted.replace(dense_adj=given)) is given


@pytest.mark.parametrize("weighted", [False, True])
def test_batch_to_dense_and_back_match_jax(graphs, weighted):
    jbatch, tbatch = _batches(graphs, None, weighted)
    n_max = _slot(graphs)
    jx, jadj, jmask = jdense.batch_to_dense(jbatch, n_max)
    x, adj, mask = dense.batch_to_dense(tbatch, n_max)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert_close(adj, jadj)
    back = dense.dense_to_nodes(x, tbatch)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jdense.dense_to_nodes(jx, jbatch)))
    np.testing.assert_array_equal(back.numpy(), tbatch.node_feat.numpy())


def test_to_dense_matches_jax(graphs):
    n = len(graphs)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, n))
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, n))
    ref = jb.to_dense(jbatch, _slot(graphs))
    got = tb.to_dense(tbatch, _slot(graphs))
    for f in ("x", "adj", "node_mask", "n_node", "graph_mask", "y"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)))
    assert got.max_nodes == _slot(graphs)


@pytest.mark.parametrize("weighted", [False, True])
def test_dense_gcn_conv_matches_jax(graphs, weighted):
    """The dense GCNConv branch on the stack's once-normalized adjacency
    (the JAX layer's dense_pre_normalized), and the gradients of x and the
    weights."""
    slot = _slot(graphs)
    jbatch, tbatch = _batches(graphs, slot, weighted)
    a, d = JaxGCNConv.normalize_dense(jdense.build_dense_adj(jbatch))
    kw_j = dict(dense_adj=a, dense_diag=d, dense_pre_normalized=True)
    a, d = GCNConv.normalize_dense(dense.build_dense_adj(tbatch))
    kw_t = dict(dense_adj=a, dense_diag=d)
    layer = JaxGCNConv(features=12)
    args = (jbatch.senders, jbatch.receivers, jbatch.edge_mask)
    params = layer.init(jax.random.PRNGKey(1), jbatch.node_feat, *args,
                        **kw_j)["params"]
    ref, vjp = jax.vjp(lambda x, p: layer.apply({"params": p}, x, *args,
                                                **kw_j),
                       jnp.asarray(jbatch.node_feat), params)
    cot = np.random.default_rng(2).normal(size=ref.shape).astype(np.float32)
    jdx, jdp = vjp(jnp.asarray(cot))

    conv = GCNConv(9, 12)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(np.asarray(params["kernel"]).T))
        conv.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    x = tbatch.node_feat.clone().requires_grad_()
    out = conv(x, tbatch.senders, tbatch.receivers, tbatch.edge_mask, **kw_t)
    (out * torch.tensor(cot)).sum().backward()
    assert_close(out.detach(), ref)
    assert_close(x.grad, jdx)
    assert_close(conv.weight.grad.T, jdp["kernel"])
    assert_close(conv.bias.grad, jdp["bias"])


def test_normalize_dense_matches_jax(graphs):
    slot = _slot(graphs)
    jbatch, tbatch = _batches(graphs, slot)
    adj = dense.build_dense_adj(tbatch)
    for loops, norm in ((True, True), (False, True), (True, False)):
        ja, jd = JaxGCNConv.normalize_dense(jnp.asarray(adj.numpy()), loops,
                                            norm)
        ta, td = GCNConv.normalize_dense(adj, loops, norm)
        assert_close(ta, ja)
        assert (td is None) == (jd is None)
        if td is not None:
            assert_close(td, jd)


@pytest.mark.parametrize("readout", ["mean", "none"])
def test_dense_mpnn_matches_jax_and_sparse(graphs, readout):
    """The dense MPNN (one normalization a forward) against the JAX dense
    MPNN, logits and gradients; and equal to the port's sparse MPNN on the
    same graphs packed without slots."""
    slot = _slot(graphs)
    jbatch, tbatch = _batches(graphs, slot)
    jmodel = JaxMPNN(conv_type="gcn", activation="relu", num_features=9,
                     hidden_channels=16, num_classes=10, num_layers=3,
                     dropout=0.0, readout=readout)
    params = jmodel.init(jax.random.PRNGKey(7), jbatch, train=False)["params"]
    ref, vjp = jax.vjp(
        lambda p: jmodel.apply({"params": p}, jbatch, train=False), params)
    cot = np.random.default_rng(3).normal(size=ref.shape).astype(np.float32)
    (jgrads,) = vjp(jnp.asarray(cot))

    model = MPNN(conv_type="gcn", activation="relu", num_features=9,
                 hidden_channels=16, num_classes=10, num_layers=3,
                 readout=readout)
    model.load_state_dict(mpnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    out = model(tbatch)
    (out * torch.tensor(cot)).sum().backward()
    assert_close(out.detach(), ref)
    for i in range(3):
        jg = jgrads[f"GCNConv_{i}"]
        assert_close(model.convs[i].weight.grad.T, jg["kernel"])
        assert_close(model.convs[i].bias.grad, jg["bias"])

    _, flat = _batches(graphs, None)
    sparse = model(flat).detach()
    if readout == "mean":
        g = len(graphs)
        assert_close(out.detach()[:g], sparse[:g])
    else:
        assert_close(out.detach()[tbatch.node_mask],
                     sparse[flat.node_mask])
