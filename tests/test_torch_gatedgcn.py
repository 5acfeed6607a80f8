"""The port's GatedGCN family against the JAX package's: the segment-reduce
kernel's plain version against ``segment_reduce_pallas`` in interpret mode
(receiver view and the transpose view, float32 and bfloat16);
``segment_sum_planned`` and ``gather_planned`` forward and gradients on both
sides (mirroring tests/test_planned_segment_ops.py); the flax LayerNorm;
``GatedGCNConv`` and ``GatedGCNNet`` with weights carried across, with and
without a plan, with and without edge features, both readouts; 3 AdamW
steps following the JAX trajectory; both GatedGCN configs through
``run_experiment`` on the CPU; and the functions of the TPU's HBM kernels
(B4a-c), the port's ``SpmmFunction`` against ``spmm_pallas_hbm`` and
``edge_sddmm`` against ``sddmm_pallas_hbm``.

Tolerances (float32): rtol=1e-5, atol=1e-5*max|ref| for forwards,
atol=1e-4*max|ref| for gradients; float32 sums taken in another order (edge
order on the CPU, one-hot matmuls in the Pallas kernels).  bfloat16
messages: both sides sum exact bfloat16 values in float32, held at the
float32 level.
"""

import dataclasses
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
from graph_hscn_tpu.models.gatedgcn import GatedGCNNet as JaxGatedGCNNet
from graph_hscn_tpu.models.layers import GatedGCNConv as JaxGatedGCNConv
from graph_hscn_tpu.models.mpnn import build_mpnn as jax_build_mpnn
from graph_hscn_tpu.ops import segment as jax_segment
from graph_hscn_tpu.ops import spmm as jax_spmm
from graph_hscn_tpu.ops.pallas.sddmm_kernel import (sddmm_pallas_hbm,
                                                    segment_reduce_pallas)
from graph_hscn_tpu.ops.pallas.spmm_kernel import spmm_pallas_hbm
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.loop import make_train_step as jax_make_train_step
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu_torch import runner
from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (
    gated_gcn_conv_params_from_jax, gatedgcn_params_from_jax)
from graph_hscn_tpu_torch.models.gatedgcn import GatedGCNNet
from graph_hscn_tpu_torch.models.layers import GatedGCNConv, LayerNorm
from graph_hscn_tpu_torch.models.mpnn import build_mpnn
from graph_hscn_tpu_torch.ops import segment, spmm
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import edge_sddmm_plain
from graph_hscn_tpu_torch.ops.cuda.segment_reduce_kernel import (
    segment_reduce, segment_reduce_plain)
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import SpmmFunction
from graph_hscn_tpu_torch.train.loop import make_train_step
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

ROOT = Path(__file__).parents[1]
VOC_GATED = ROOT / "configs" / "GatedGCN" / "voc_superpixels_GatedGCN_sparse.yaml"
PEPTIDES_GATED = ROOT / "configs" / "GatedGCN" / "peptides_struct_GatedGCN.yaml"


def assert_close(got, ref, tol=1e-5):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def grads_of(model, names) -> dict:
    """Each named parameter's gradient, zeros for one the loss does not
    reach (as JAX reports it)."""
    params = dict(model.named_parameters())
    return {k: (params[k].grad if params[k].grad is not None
                else torch.zeros_like(params[k])) for k in names}


@pytest.fixture
def both_backends(request):
    """Both packages on one spmm backend, restored afterwards."""
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend(request.param)
    spmm.set_backend(request.param)
    try:
        yield request.param
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)


@pytest.fixture(scope="module")
def voc():
    """(JAX batch with a Pallas plan, port batch with a CSR plan on the
    CPU): the same VOC graphs, padding nodes and edges included."""
    graphs = js.make_voc_superpixels(num_graphs=3, seed=23, mean_nodes=60.0)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 3),
                           with_spmm_plan=True)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 3),
                           with_spmm_plan=True).to("cpu")
    assert tbatch.num_edges_padded > tbatch.spmm.num_edges
    assert not tbatch.node_mask.all()
    return jbatch, tbatch


# --- the segment-reduce kernel (B5) ---------------------------------------

@pytest.mark.parametrize("view", ["receiver", "transpose"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [64, 5])
def test_segment_reduce_plain_matches_pallas(voc, view, dtype, f):
    """segment_reduce_plain against segment_reduce_pallas in interpret mode,
    on the plan's receiver view (row_ptr) and its transpose view
    (t_row_ptr, the rows taken in t_order, as gather_planned's sender side
    calls it).  Padding edge rows hold garbage: both drop them.  Padding
    nodes have no edges: 0."""
    jbatch, tbatch = voc
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    plan, jplan = tbatch.spmm, jbatch.spmm
    e_plan = jplan.t_order.shape[0]
    msgs = np.random.default_rng(f).normal(size=(e, f)).astype(np.float32)
    jm = jnp.pad(jnp.asarray(msgs), ((0, e_plan - e), (0, 0))).astype(dtype)
    if view == "receiver":
        ref = segment_reduce_pallas(jm, jplan, n, interpret=True)
        got = segment_reduce_plain(torch.tensor(msgs).to(getattr(torch, dtype)),
                                   plan.row_ptr)
    else:
        jview = dataclasses.replace(jplan, wr=jplan.t_wr,
                                    rcv_rel=jplan.t_rcv_rel)
        ref = segment_reduce_pallas(jnp.take(jm, jplan.t_order, axis=0),
                                    jview, n, interpret=True)
        got = segment_reduce_plain(torch.tensor(msgs).to(getattr(torch, dtype)),
                                   plan.t_row_ptr, plan.t_order)
    assert got.dtype == torch.float32 and got.shape == (n, f)
    assert_close(got, ref)
    assert not got[~tbatch.node_mask].any()


def test_segment_reduce_plain_hand_case():
    """Rows 1 and 3 empty (0), slots past row_ptr[N] never reach a row
    (NaN there stays out), and an order takes the rows it names."""
    msgs = torch.tensor([[1.0, 10.0], [2.0, 20.0], [4.0, 40.0],
                         [8.0, 80.0], [float("nan"), float("nan")]])
    row_ptr = torch.tensor([0, 2, 2, 4, 4], dtype=torch.int32)
    out = segment_reduce_plain(msgs, row_ptr)
    np.testing.assert_array_equal(out.numpy(), [[3, 30], [0, 0], [12, 120],
                                                [0, 0]])
    order = torch.tensor([3, 0, 2, 1, 4])
    out = segment_reduce(msgs, row_ptr, order)   # CPU: the plain version
    np.testing.assert_array_equal(out.numpy(), [[9, 90], [0, 0], [6, 60],
                                                [0, 0]])


def test_segment_reduce_refuses_non_cuda_devices():
    msgs = torch.empty(4, 8, device="meta")
    rp = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce(msgs, rp)


# --- the planned segment ops ---------------------------------------------

@pytest.mark.parametrize("both_backends", ["pallas"], indirect=True)
def test_segment_sum_planned_matches_jax(voc, both_backends):
    """Forward (the kernel's plain version through the autograd Function)
    and d msgs = g[receivers], against the JAX Pallas path; masked edge
    rows are zero, as the contract asks."""
    jbatch, tbatch = voc
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    rng = np.random.default_rng(0)
    mask = tbatch.edge_mask.numpy()[:, None]
    msgs = (rng.normal(size=(e, 32)) * mask).astype(np.float32)
    g = rng.normal(size=(n, 32)).astype(np.float32)
    ref, vjp = jax.vjp(lambda m: jax_segment.segment_sum_planned(
        m, jbatch.receivers, n, plan=jbatch.spmm, interpret=True),
        jnp.asarray(msgs))
    (ref_dm,) = vjp(jnp.asarray(g))
    m = torch.tensor(msgs, requires_grad=True)
    out = segment.segment_sum_planned(m, tbatch.receivers, n,
                                      plan=tbatch.spmm)
    out.backward(torch.tensor(g))
    assert_close(out, ref)
    assert_close(m.grad, ref_dm, 1e-4)


@pytest.mark.parametrize("both_backends", ["pallas"], indirect=True)
@pytest.mark.parametrize("side,idx_name", [("receiver", "receivers"),
                                           ("sender", "senders")])
def test_gather_planned_matches_jax(voc, both_backends, side, idx_name):
    """Forward equals x[idx]; the backward (segment_reduce by receiver, or
    by sender through t_order) against the JAX Pallas path, given zero
    cotangents on masked edges; and, on real nodes, index_select's own
    backward."""
    jbatch, tbatch = voc
    n = tbatch.num_nodes_padded
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    ge = (rng.normal(size=(tbatch.num_edges_padded, 32))
          * tbatch.edge_mask.numpy()[:, None]).astype(np.float32)
    jidx = getattr(jbatch, idx_name)
    ref, vjp = jax.vjp(lambda x: jax_segment.gather_planned(
        x, jidx, plan=jbatch.spmm, side=side, interpret=True), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(ge))
    xt = torch.tensor(x, requires_grad=True)
    idx = getattr(tbatch, idx_name)
    out = segment.gather_planned(xt, idx, plan=tbatch.spmm, side=side)
    out.backward(torch.tensor(ge))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    assert_close(xt.grad, ref_dx, 1e-4)
    plain = torch.zeros(n, 32).index_add_(0, idx, torch.tensor(ge))
    assert_close(xt.grad, plain, 1e-4)


@pytest.mark.parametrize("both_backends", ["xla"], indirect=True)
def test_planned_ops_fall_back_without_a_kernel(voc, both_backends):
    """Backend "xla", or no plan: segment_sum and index_select, as the JAX
    fallbacks; no segment_reduce call."""
    jbatch, tbatch = voc
    n = tbatch.num_nodes_padded
    rng = np.random.default_rng(2)
    msgs = rng.normal(size=(tbatch.num_edges_padded, 8)).astype(np.float32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    for plan in (tbatch.spmm, None):
        out = segment.segment_sum_planned(torch.tensor(msgs),
                                          tbatch.receivers, n, plan=plan)
        ref = jax_segment.segment_sum_planned(jnp.asarray(msgs),
                                              jbatch.receivers, n, plan=None)
        assert_close(out, ref)
        got = segment.gather_planned(torch.tensor(x), tbatch.senders,
                                     plan=plan, side="sender")
        np.testing.assert_array_equal(got.numpy(), x[tbatch.senders.numpy()])
    with pytest.raises(ValueError, match="side"):
        segment.gather_planned(torch.tensor(x), tbatch.senders, side="both")


# --- LayerNorm, GatedGCNConv ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_is_flax(dtype):
    """flax nn.LayerNorm (epsilon 1e-6, float32 statistics) with a scale
    and bias: output and gradients; rows of small variance
    make torch's default epsilon (1e-5) miss the float32 tolerance."""
    import flax.linen as fnn
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(16, 24)) * np.where(np.arange(16) < 8, 1.0, 1e-3)
         [:, None]).astype(np.float32)
    scale = rng.normal(size=24).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    g = rng.normal(size=(16, 24)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    ln = fnn.LayerNorm(dtype=jdt)
    p = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ref, vjp = jax.vjp(lambda x, p: ln.apply(p, x),
                       jnp.asarray(x).astype(dtype), p)
    ref_dx, ref_dp = vjp(jnp.asarray(g).astype(ref.dtype))
    norm = LayerNorm(24, dtype=None if dtype == "float32" else torch.bfloat16)
    with torch.no_grad():
        norm.scale.copy_(torch.tensor(scale))
        norm.bias.copy_(torch.tensor(bias))
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    out = norm(xt)
    out.backward(torch.tensor(g).to(out.dtype))
    assert str(out.dtype) == f"torch.{ref.dtype}"
    if dtype == "float32":
        assert_close(out, ref)
        assert_close(xt.grad, ref_dx, 1e-4)
        assert_close(norm.scale.grad, ref_dp["params"]["scale"], 1e-4)
        assert_close(norm.bias.grad, ref_dp["params"]["bias"], 1e-4)
        torch_eps = torch.nn.functional.layer_norm(
            torch.tensor(x), (24,), torch.tensor(scale), torch.tensor(bias))
        assert np.abs(torch_eps.numpy() - np.asarray(ref)).max() > \
            1e-3 * np.abs(np.asarray(ref)).max()
    else:   # the same float32 values rounded once to bfloat16: one ulp
        np.testing.assert_allclose(out.detach().float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("both_backends", ["pallas", "xla"], indirect=True)
@pytest.mark.parametrize("edge_width", [None, 16])
def test_gated_gcn_conv_matches_jax(voc, both_backends, edge_width):
    """The layer with mapped weights: x' and e', dx, de and every parameter
    gradient.  "pallas": the planned ops (the kernel's plain version) on
    both sides; "xla": the plain gathers and segment sums.  edge_width None
    starts from zero edge states (VOC), 16 from edge features (the encoded
    ones of peptides-struct)."""
    jbatch, tbatch = voc
    n, e, c = tbatch.num_nodes_padded, tbatch.num_edges_padded, 16
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, c)).astype(np.float32)
    mask = tbatch.edge_mask.numpy()[:, None]
    ef = (np.zeros((e, c), np.float32) if edge_width is None else
          (rng.normal(size=(e, edge_width)) * mask).astype(np.float32))
    args = (jbatch.senders, jbatch.receivers, jbatch.edge_mask)
    jconv = JaxGatedGCNConv(features=c)
    params = jconv.init(jax.random.PRNGKey(5), jnp.asarray(x),
                        jnp.asarray(ef), *args, num_nodes=n)["params"]
    (ref_x, ref_e), vjp = jax.vjp(lambda x, ef, p: jconv.apply(
        {"params": p}, x, ef, *args, num_nodes=n, plan=jbatch.spmm),
        jnp.asarray(x), jnp.asarray(ef), params)
    gx = rng.normal(size=(n, c)).astype(np.float32)
    ge = rng.normal(size=(e, c)).astype(np.float32)
    ref_dx, ref_de, ref_dp = vjp((jnp.asarray(gx), jnp.asarray(ge)))

    conv = GatedGCNConv(c)
    conv.load_state_dict(gated_gcn_conv_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(ef, requires_grad=True)
    out_x, out_e = conv(xt, et, tbatch.senders, tbatch.receivers,
                        tbatch.edge_mask, num_nodes=n, plan=tbatch.spmm)
    (out_x * torch.tensor(gx)).sum().add((out_e * torch.tensor(ge)).sum()
                                         ).backward()
    assert_close(out_x, ref_x)
    assert_close(out_e, ref_e)
    assert not out_e[~tbatch.edge_mask].any()
    assert_close(xt.grad, ref_dx, 1e-4)
    assert_close(et.grad, ref_de, 1e-4)
    want = gated_gcn_conv_params_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_dp))
    for name, g in grads_of(conv, want).items():
        assert_close(g, want[name], 1e-4)


@pytest.mark.parametrize("both_backends", ["pallas", "xla"], indirect=True)
def test_gated_gcn_conv_bf16_matches_jax(voc, both_backends):
    """bfloat16 compute (float32 parameters and LayerNorm statistics): x'
    and e' in bfloat16, within 2^-7 (relative and of max|ref|), a bfloat16
    ulp or two: the packages round intermediate sums at other points."""
    jbatch, tbatch = voc
    n, e, c = tbatch.num_nodes_padded, tbatch.num_edges_padded, 16
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, c)).astype(np.float32)
    ef = (rng.normal(size=(e, c))
          * tbatch.edge_mask.numpy()[:, None]).astype(np.float32)
    args = (jbatch.senders, jbatch.receivers, jbatch.edge_mask)
    jconv = JaxGatedGCNConv(features=c, dtype=jnp.bfloat16)
    params = jconv.init(jax.random.PRNGKey(7), jnp.asarray(x),
                        jnp.asarray(ef), *args, num_nodes=n)["params"]
    refs = jconv.apply({"params": params}, jnp.asarray(x), jnp.asarray(ef),
                       *args, num_nodes=n, plan=jbatch.spmm)
    conv = GatedGCNConv(c, dtype=torch.bfloat16)
    conv.load_state_dict(gated_gcn_conv_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    outs = conv(torch.tensor(x), torch.tensor(ef), tbatch.senders,
                tbatch.receivers, tbatch.edge_mask, num_nodes=n,
                plan=tbatch.spmm)
    for out, ref in zip(outs, refs):
        assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(out.detach().float().numpy(), ref,
                                   rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * np.abs(ref).max())


def test_gated_gcn_conv_takes_the_kernel_only_with_a_plan(voc, monkeypatch):
    """Backend "pallas" with a plan: 2 segment_reduce calls forward (the
    segment sums) and 3 backward (the gathers); without a plan, or on
    backend "xla" or "auto" off the card, none."""
    _, tbatch = voc
    calls = []

    def counting(*a):
        calls.append(1)
        return segment_reduce(*a)

    monkeypatch.setattr(segment, "segment_reduce", counting)
    conv = GatedGCNConv(14)
    e0 = torch.zeros(tbatch.num_edges_padded, 14)
    prev = spmm.get_backend()
    try:
        for name, plan, fwd, bwd in (("pallas", tbatch.spmm, 2, 3),
                                     ("pallas", None, 0, 0),
                                     ("xla", tbatch.spmm, 0, 0),
                                     ("auto", tbatch.spmm, 0, 0)):
            spmm.set_backend(name)
            calls.clear()
            x, _ = conv(tbatch.node_feat, e0, tbatch.senders,
                        tbatch.receivers, tbatch.edge_mask, plan=plan)
            assert len(calls) == fwd, (name, calls)
            x.sum().backward()
            assert len(calls) == fwd + bwd, (name, calls)
    finally:
        spmm.set_backend(prev)


# --- GatedGCNNet ------------------------------------------------------------

NET_CASES = {
    # (graphs, batch layout, readout, backend)
    "voc_plan_none": ("voc", "plan", "none", "pallas"),
    "voc_flat_none": ("voc", "flat", "none", "xla"),
    "voc_plan_mean": ("voc", "plan", "mean", "pallas"),
    "peptides_plan_mean": ("peptides", "plan", "mean", "pallas"),
    "peptides_slots_mean": ("peptides", "slots", "mean", "xla"),
    "peptides_flat_none": ("peptides", "flat", "none", "xla"),
}


def _net_batches(kind, layout, num_graphs=3, seed=31):
    if kind == "voc":
        graphs = js.make_voc_superpixels(num_graphs=num_graphs, seed=seed,
                                         mean_nodes=70.0)
    else:
        graphs = js.make_peptides_struct(num_graphs=num_graphs, seed=seed,
                                         mean_nodes=30.0)
    slot = (((max(g.num_nodes for g in graphs) + 7) // 8) * 8
            if layout == "slots" else None)
    kw = dict(with_spmm_plan=layout == "plan", slot_nodes=slot)
    return graphs, kw


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_gatedgcn_net_matches_jax(case):
    """The net (2 layers, hidden 16) through convert.py: logits and every
    parameter gradient, with (peptides) and without (VOC) edge features,
    both readouts, on the planned path (backend "pallas" both sides) and
    the plain one."""
    kind, layout, readout, name = NET_CASES[case]
    graphs, kw = _net_batches(kind, layout)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 3), **kw)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 3),
                           **kw).to("cpu")
    nf = graphs[0].x.shape[1]
    nef = None if graphs[0].edge_attr is None else graphs[0].edge_attr.shape[1]
    nc = 21 if kind == "voc" else 11
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend(name)
    spmm.set_backend(name)
    try:
        jmodel = JaxGatedGCNNet(hidden_channels=16, num_classes=nc,
                                num_layers=2, readout=readout)
        params = jmodel.init(jax.random.PRNGKey(7), jbatch,
                             train=False)["params"]
        logits, vjp = jax.vjp(
            lambda p: jmodel.apply({"params": p}, jbatch, train=False),
            params)
        cot = np.random.default_rng(1).normal(size=logits.shape).astype(
            np.float32)
        (jgrads,) = vjp(jnp.asarray(cot))
        model = GatedGCNNet(nf, 16, nc, 2, readout=readout,
                            num_edge_features=nef)
        model.load_state_dict(gatedgcn_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), nef is not None))
        model.eval()
        out = model(tbatch)
        (out * torch.tensor(cot)).sum().backward()
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)
    assert out.dtype == torch.float32 and out.shape == logits.shape
    assert_close(out, logits)
    want = gatedgcn_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads),
                                    nef is not None)
    assert set(want) == set(dict(model.named_parameters()))
    for pname, g in grads_of(model, want).items():
        assert_close(g, want[pname], 1e-4)


def test_gatedgcn_net_refuses_a_batch_it_was_not_built_for():
    graphs, kw = _net_batches("peptides", "flat")
    batch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 3),
                          **kw).to("cpu")
    with pytest.raises(ValueError, match="edge features"):
        GatedGCNNet(9, 8, 11, 1)(batch)


def test_convert_refuses_a_tree_of_another_shape():
    with pytest.raises(ValueError, match="Dense"):
        gatedgcn_params_from_jax({"Dense_0": {"kernel": np.zeros((2, 2)),
                                              "bias": np.zeros(2)}}, True)


# --- configs, routes and training -----------------------------------------

def _small_cfgs(path, num_graphs, batch_size, layers=2):
    """The port's and the JAX package's parse of a GatedGCN config,
    shrunk."""
    cfgs = load_config(path), jax_load_config(path)
    for cfg in cfgs:
        cfg.data.num_graphs = num_graphs
        cfg.data.batch_size = batch_size
        cfg.mpnn.num_layers = layers
        cfg.training.epochs = 2
        cfg.training.eval_period = 1
    return cfgs


def test_voc_gatedgcn_config_is_the_sparse_twin():
    """The new config is the shipped edge-partition one without its mesh,
    on the sparse path, with num_graphs 128."""
    import yaml
    ours = yaml.safe_load(VOC_GATED.read_text())
    shipped = yaml.safe_load((ROOT / "configs" / "GatedGCN" /
                              "voc_superpixels_GatedGCN_edge_partition.yaml")
                             .read_text())
    assert ours.pop("runtime") == {"device_dataset": "off",
                                   "dense_path": "sparse"}
    assert ours["data"].pop("num_graphs") == 128
    shipped.pop("mesh")
    assert ours == shipped
    cfg, jcfg = load_config(VOC_GATED), jax_load_config(VOC_GATED)
    assert (cfg.mpnn.hidden_channels, cfg.mpnn.num_layers,
            cfg.data.batch_size) == (jcfg.mpnn.hidden_channels,
                                     jcfg.mpnn.num_layers,
                                     jcfg.data.batch_size) == (64, 4, 32)


@pytest.mark.parametrize("path,batch_size", [(VOC_GATED, 4),
                                             (PEPTIDES_GATED, 8)])
def test_gatedgcn_configs_route_as_jax(path, batch_size, monkeypatch):
    """Both GatedGCN configs, shrunk, train on the CPU through
    run_experiment with finite losses, along the route the JAX runner
    picks: VOC on the host fit loop with CSR plans on its batches (backend
    "pallas" here, a card in production: 5 segment_reduce calls a layer a
    train step, 2 an eval batch), peptides-struct on dense slots and the
    device-resident dataset with edge features and no plan."""
    cfg, jcfg = _small_cfgs(path, 24, batch_size)
    sparse = path == VOC_GATED
    seen = {}
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen["route"] = name
            if name == "fit":
                seen["plans"] = all(b.spmm is not None for b in args[2])
            return fn(*args, **kw)
        monkeypatch.setattr(runner, name, wrapped)

    def counting(*a):
        calls.append(1)
        return segment_reduce(*a)

    spy("fit", runner.fit)
    spy("fit_device", runner.fit_device)
    monkeypatch.setattr(segment, "segment_reduce", counting)
    prev = spmm.get_backend()
    try:
        cfg.runtime.spmm_backend = "pallas" if sparse else "auto"
        result = runner.run_experiment(cfg, device="cpu")
    finally:
        spmm.set_backend(prev)
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert isinstance(result.model, GatedGCNNet)
    assert (result.model.edge_encoder is None) == sparse
    layers = cfg.mpnn.num_layers
    steps, evals = result.num_train_steps, result.num_eval_batches
    assert len(calls) == ((5 * steps + 2 * evals) * layers if sparse else 0)

    jdm = JaxDataModule.from_config(jcfg.data)
    dm = DataModule.from_config(cfg.data)
    if not sparse:
        assert dm.enable_dense_slots() and jdm.enable_dense_slots()
        assert dm.slot_nodes == jdm.slot_nodes
    assert seen["route"] == ("fit" if sparse else "fit_device")
    assert runner._use_device_dataset(cfg, dm) == \
        jax_runner._use_device_dataset(jcfg, jdm) == (not sparse)
    assert runner._use_fused_stack(cfg, dm, torch.device("cuda")) == \
        jax_runner._use_fused_stack(jcfg, jdm, dm.task_level == "node") \
        is False
    if sparse:
        assert seen["plans"]


@pytest.mark.parametrize("path,layout", [(VOC_GATED, "plan"),
                                         (PEPTIDES_GATED, "slots")])
def test_gatedgcn_training_follows_jax(path, layout):
    """3 AdamW steps of each GatedGCN config, shrunk to 2 layers at its own
    widths and optimizer, dropout 0, from mapped weights: each step's loss
    within 1e-5 relative of the JAX train step, and the final weights
    (weight decay on the last layer's unused edge LayerNorm included) at
    the gradients' tolerance, 1e-4*max|ref|: Adam divides each gradient by
    its own running size, so an element whose gradient is near 0 moves by
    about lr whatever its size, and a float32 sum in another order changes
    that move by more than the forward tolerance (6.5e-6 in a 64 x 64
    kernel at lr 0.005, max|ref| 0.22)."""
    cfg, jcfg = _small_cfgs(path, 6, 2)
    cfg.mpnn.dropout = jcfg.mpnn.dropout = 0.0
    kind = "voc" if path == VOC_GATED else "peptides"
    graphs, kw = _net_batches(kind, layout, num_graphs=6, seed=41)
    budget_j = jb.PadBudget.for_dataset(graphs, 2)
    budget_t = tb.PadBudget.for_dataset(graphs, 2)
    jbatches = [jb.pack_batch(graphs[i:i + 2], budget_j, **kw)
                for i in (0, 2, 4)]
    tbatches = [tb.pack_batch(graphs[i:i + 2], budget_t, **kw).to("cpu")
                for i in (0, 2, 4)]
    nf = graphs[0].x.shape[1]
    nef = None if graphs[0].edge_attr is None else graphs[0].edge_attr.shape[1]
    nc = 21 if kind == "voc" else 11
    node_level = kind == "voc"
    readout = "none" if node_level else "mean"
    loss_fn = cfg.training.loss_fn
    o = cfg.optim
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend("pallas")
    spmm.set_backend("pallas")
    try:
        jmodel = jax_build_mpnn(jcfg.mpnn, nf, nc, readout=readout)
        tx = jax_build_opt(o.optim_type, o.lr, o.weight_decay)
        state = jax_init_state(jmodel, tx, jbatches[0], seed=3)
        init = jax.tree_util.tree_map(np.asarray, state.params)
        jstep, _ = jax_make_train_step(jmodel, tx, loss_fn,
                                       node_level=node_level)
        jlosses = []
        for b in jbatches:
            state, loss, *_ = jstep(state, b)
            jlosses.append(float(loss))

        model = build_mpnn(cfg.mpnn, nf, nc, readout=readout,
                           num_edge_features=nef)
        model.load_state_dict(gatedgcn_params_from_jax(init, nef is not None))
        opt = build_optimizer(model.parameters(), o.optim_type, o.lr,
                              o.weight_decay)
        step, _ = make_train_step(model, opt, loss_fn, node_level=node_level)
        tlosses = [float(step(b)[0]) for b in tbatches]
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    final = gatedgcn_params_from_jax(jax.tree_util.tree_map(
        np.asarray, state.params), nef is not None)
    assert set(final) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert_close(p, final[name], 1e-4)


# --- B4a-c: the HBM kernels' functions -----------------------------------

@pytest.fixture(scope="module")
def planned():
    """The batch of tests/test_pallas_spmm.py's HBM tests, packed by both
    packages."""
    graphs = js.make_peptides_func(num_graphs=8, seed=11, mean_nodes=60)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(
        graphs, batch_size=8, edge_multiple=256), with_spmm_plan=True)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(
        graphs, batch_size=8, edge_multiple=256),
        with_spmm_plan=True).to("cpu")
    return jbatch, tbatch


@pytest.mark.parametrize("stream_out", [False, True])
def test_spmm_function_matches_spmm_pallas_hbm(planned, stream_out):
    """B4a (stream_out False) and B4b (True) compute B1's function; their
    dw is B4c (sddmm_pallas_hbm).  The port's SpmmFunction with
    weight_needs_grad=True (csr_spmm and edge_sddmm, plain versions on the
    CPU) against spmm_pallas_hbm in interpret mode at F = 128: values, dx
    and dw on the real edges."""
    jbatch, tbatch = planned
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    rng = np.random.default_rng(12)
    x0 = rng.normal(size=(n, 128)).astype(np.float32)
    w0 = rng.uniform(0.5, 1.5, size=e).astype(np.float32)
    g = rng.normal(size=(n, 128)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x, w: spmm_pallas_hbm(
        x, jbatch.spmm, edge_weight=w, num_nodes=n, interpret=True,
        stream_out=stream_out), jnp.asarray(x0), jnp.asarray(w0))
    ref_dx, ref_dw = vjp(jnp.asarray(g))
    x = torch.tensor(x0, requires_grad=True)
    w = torch.tensor(w0, requires_grad=True)
    out = SpmmFunction.apply(x, w, tbatch.spmm, True)
    out.backward(torch.tensor(g))
    mask = tbatch.edge_mask.numpy()
    assert_close(out, ref)
    assert_close(x.grad, ref_dx, 1e-4)
    assert_close(w.grad[mask], np.asarray(ref_dw)[:e][mask], 1e-4)
    assert not w.grad[~mask].any()


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16")])
def test_edge_sddmm_matches_sddmm_pallas_hbm(planned, dtypes):
    """B4c's function, the per-edge dots <h_src[send], h_dst[recv]>, at
    F = 128: edge_sddmm's plain version against sddmm_pallas_hbm in
    interpret mode; 0 on the padding edges."""
    jbatch, tbatch = planned
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    rng = np.random.default_rng(13)
    hs = rng.normal(size=(n, 128)).astype(np.float32)
    hd = rng.normal(size=(n, 128)).astype(np.float32)
    ref = sddmm_pallas_hbm(jnp.asarray(hs).astype(dtypes[0]),
                           jnp.asarray(hd).astype(dtypes[1]), jbatch.spmm,
                           interpret=True)[:e]
    p = tbatch.spmm
    got = edge_sddmm_plain(torch.tensor(hs).to(getattr(torch, dtypes[0])),
                           torch.tensor(hd).to(getattr(torch, dtypes[1])),
                           p.row, p.col, p.num_edges)
    assert_close(got, ref)
    assert not got[p.num_edges:].any()
