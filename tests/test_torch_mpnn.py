"""The port's GCN MPNN against the JAX package's, weights carried across by
models/convert.py: logits and every parameter gradient agree, on the kernel
path (JAX: spmm_pallas in interpret mode; port: SpmmFunction with the plain
versions on the CPU) and on the plain path.

Tolerance rtol=1e-5, atol=1e-5*max|ref| (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.data import batching as jb
from graph_hscn_tpu.data import synthetic as js
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.ops import spmm as jax_spmm
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.models.convert import mpnn_params_from_jax
from graph_hscn_tpu_torch.models.layers import ACTIVATIONS
from graph_hscn_tpu_torch.models.mpnn import MPNN, build_mpnn
from graph_hscn_tpu_torch.ops import spmm

CASES = {
    # node-level VOC graphs (readout none) and graph-level peptides (mean)
    "voc": (js.make_voc_superpixels, dict(num_graphs=3, seed=31,
                                          mean_nodes=150.0), 14, 21, "none"),
    "peptides": (js.make_peptides_func, dict(num_graphs=3, seed=32,
                                             mean_nodes=40.0), 9, 10,
                 "mean"),
}


def assert_close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max()),
                                               1e-30))


@pytest.fixture
def backend(request):
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend(request.param)
    spmm.set_backend(request.param)
    try:
        yield request.param
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)


@pytest.mark.parametrize("backend", ["pallas", "xla"], indirect=True)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mpnn_logits_and_grads_match_jax(case, backend):
    make, kw, nf, nc, readout = CASES[case]
    graphs = make(**kw)
    budget = jb.PadBudget.for_dataset(graphs, batch_size=len(graphs))
    jbatch = jb.pack_batch(graphs, budget,
                           with_spmm_plan=backend == "pallas")
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(
        graphs, batch_size=len(graphs)),
        with_spmm_plan=backend == "pallas").to("cpu")
    jmodel = JaxMPNN(conv_type="gcn", activation="relu", num_features=nf,
                     hidden_channels=16, num_classes=nc, num_layers=3,
                     dropout=0.0, readout=readout)
    params = jmodel.init(jax.random.PRNGKey(5), jbatch, train=False)["params"]
    logits, vjp = jax.vjp(
        lambda p: jmodel.apply({"params": p}, jbatch, train=False), params)
    cot = np.random.default_rng(1).normal(size=logits.shape).astype(
        np.float32)
    (jgrads,) = vjp(jnp.asarray(cot))

    model = MPNN(conv_type="gcn", activation="relu", num_features=nf,
                 hidden_channels=16, num_classes=nc, num_layers=3,
                 dropout=0.0, readout=readout)
    model.load_state_dict(mpnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    out = model(tbatch)
    (out * torch.tensor(cot)).sum().backward()
    assert out.dtype == torch.float32
    assert_close(out.detach(), logits)
    for i in range(3):
        jg = jgrads[f"GCNConv_{i}"]
        assert_close(model.convs[i].weight.grad.T, jg["kernel"])
        assert_close(model.convs[i].bias.grad, jg["bias"])


@pytest.mark.parametrize("normalize,self_loops,bias,weighted", [
    (False, True, False, True), (True, False, True, True),
    (True, True, True, False)])
def test_gcn_conv_flags_match_jax(normalize, self_loops, bias, weighted):
    """GCNConv's normalize / add_self_loops / use_bias branches and a given
    edge_weight, against the flax layer on the same weights."""
    from graph_hscn_tpu.models.layers import GCNConv as JaxGCNConv
    from graph_hscn_tpu_torch.models.layers import GCNConv
    graphs = js.make_voc_superpixels(num_graphs=2, seed=35, mean_nodes=90.0)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 2))
    b = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 2)).to("cpu")
    ew = np.random.default_rng(2).uniform(0.5, 2.0, b.num_edges_padded
                                          ).astype(np.float32)
    args = dict(edge_weight=jnp.asarray(ew)) if weighted else {}
    layer = JaxGCNConv(features=7, add_self_loops=self_loops,
                       normalize=normalize, use_bias=bias)
    params = layer.init(jax.random.PRNGKey(0), jbatch.node_feat,
                        jbatch.senders, jbatch.receivers, jbatch.edge_mask,
                        **args)["params"]
    ref = layer.apply({"params": params}, jbatch.node_feat, jbatch.senders,
                      jbatch.receivers, jbatch.edge_mask, **args)
    conv = GCNConv(14, 7, add_self_loops=self_loops, normalize=normalize,
                   use_bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(np.asarray(params["kernel"]).T))
        if bias:
            conv.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    out = conv(b.node_feat, b.senders, b.receivers, b.edge_mask,
               edge_weight=torch.tensor(ew) if weighted else None)
    assert_close(out.detach(), ref)


def test_mpnn_bf16_compute_matches_jax():
    """runtime.compute_dtype bfloat16: bf16 compute, f32 params and logits,
    on the plain path of both packages, held at bf16's resolution."""
    graphs = js.make_voc_superpixels(num_graphs=2, seed=33, mean_nodes=120.0)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 2))
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 2)
                           ).to("cpu")
    jmodel = JaxMPNN(conv_type="gcn", activation="relu", num_features=14,
                     hidden_channels=16, num_classes=21, num_layers=3,
                     readout="none", dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(6), jbatch, train=False)
    ref = np.asarray(jmodel.apply(params, jbatch, train=False))
    model = MPNN(conv_type="gcn", activation="relu", num_features=14,
                 hidden_channels=16, num_classes=21, num_layers=3,
                 readout="none", dtype=torch.bfloat16)
    model.load_state_dict(mpnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    out = model(tbatch).detach()
    assert out.dtype == torch.float32
    assert model.convs[0].weight.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-2,
                               atol=2e-2 * float(np.abs(ref).max()))


def test_dropout_and_init_follow_flax_rules():
    """Dropout keeps 1 - rate and scales by 1/(1 - rate) only in training
    mode; weights are glorot-uniform in [-a, a], biases zero."""
    graphs = js.make_voc_superpixels(num_graphs=2, seed=34, mean_nodes=100.0)
    batch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 2)
                          ).to("cpu")
    model = MPNN(conv_type="gcn", activation="relu", num_features=14,
                 hidden_channels=32, num_classes=21, num_layers=2,
                 dropout=0.5, readout="none",
                 generator=torch.Generator().manual_seed(0))
    w = model.convs[0].weight
    a = np.sqrt(6.0 / (14 + 32))
    assert w.abs().max() <= a and w.abs().max() > 0.9 * a
    assert not model.convs[0].bias.any()
    model.eval()
    e1, e2 = model(batch), model(batch)
    assert torch.equal(e1, e2)
    model.train()
    g = torch.Generator().manual_seed(1)
    t1 = model(batch, generator=g)
    t2 = model(batch, generator=torch.Generator().manual_seed(1))
    assert torch.equal(t1, t2) and not torch.equal(t1, e1)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-3, 3, 13)
    np.testing.assert_allclose(ACTIVATIONS["gelu"](x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("conv_type", ["gat", "gin", "gatedgcn", "gps"])
def test_build_mpnn_other_convs_are_later_slices(conv_type):
    from graph_hscn_tpu_torch.config.config import MPNNConfig
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_mpnn(MPNNConfig(conv_type=conv_type, activation="relu",
                              num_heads=1), 9, 10)
