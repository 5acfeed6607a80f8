"""The port's GAT family against the JAX package's: segment_max and
segment_softmax; the multi-head kernels spmm_mh, sddmm_mh and
gat_edge_logits (the port's plain versions through their autograd
Functions, the JAX Pallas kernels in interpret mode), forward and VJP;
GATConv on every branch the port has (sparse gather path against JAX's
"xla" backend, sparse kernel path against JAX's Pallas path, the dense-slot
branch), with weights carried across; the GAT MPNN through convert.py; the
runner's routes for both GAT configs; and 3 AdamW steps of each config,
shrunk, following the JAX trajectory.

Tolerance rtol=1e-5, atol=1e-5*max|ref| in float32: float32 sums taken in
another order (edge order on the CPU, one-hot matmuls in the Pallas
kernels).  bfloat16: the kernels' float32 outputs are held at the same
level, since both sides round each term at the same points; an output the
VJP casts back to bfloat16 is held at rtol 2**-8, one bfloat16 ulp, since
a float32 sum in another order can flip the last rounding.
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
from graph_hscn_tpu.models.layers import GATConv as JaxGATConv
from graph_hscn_tpu.models.mpnn import MPNN as JaxMPNN
from graph_hscn_tpu.models.mpnn import build_mpnn as jax_build_mpnn
from graph_hscn_tpu.ops import segment as jax_segment
from graph_hscn_tpu.ops import spmm as jax_spmm
from graph_hscn_tpu.ops.dense import build_dense_adj as jax_build_dense_adj
from graph_hscn_tpu.ops.pallas import multihead_kernel as jmh
from graph_hscn_tpu.train.loop import init_state as jax_init_state
from graph_hscn_tpu.train.loop import make_train_step as jax_make_train_step
from graph_hscn_tpu.train.optimizers import build_optimizer as jax_build_opt
from graph_hscn_tpu_torch import runner
from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import mpnn_params_from_jax
from graph_hscn_tpu_torch.models.layers import GATConv
from graph_hscn_tpu_torch.models.mpnn import MPNN, build_mpnn
from graph_hscn_tpu_torch.ops import segment, spmm
from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import (
    SddmmMhFunction, SpmmMhFunction, gat_edge_logits, sddmm_mh,
    sddmm_mh_plain, spmm_mh, spmm_mh_plain)
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import rows_of_slots
from graph_hscn_tpu_torch.ops.dense import build_dense_adj
from graph_hscn_tpu_torch.train.loop import make_train_step
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

ROOT = Path(__file__).parents[1]
VOC_GAT = ROOT / "configs" / "GAT" / "voc_superpixels_GAT_sparse.yaml"
PEPTIDES_GAT = ROOT / "configs" / "GAT" / "peptides_func_GAT.yaml"
BF16_ULP = 2.0 ** -8


def assert_close(got, ref, rtol=1e-5):
    got = np.asarray(torch.as_tensor(got).detach().float() if isinstance(
        got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-5 * max(float(np.abs(ref).max()),
                                               1e-30))


@pytest.fixture(scope="module")
def batches():
    """(JAX batch with a Pallas plan, port batch with a CSR plan on the
    CPU), the same VOC graphs packed by each package, padding included."""
    graphs = js.make_voc_superpixels(num_graphs=3, seed=21, mean_nodes=60.0)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 3),
                           with_spmm_plan=True)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 3),
                           with_spmm_plan=True).to("cpu")
    assert tbatch.num_edges_padded > tbatch.spmm.num_edges
    return jbatch, tbatch


@pytest.fixture
def backend(request):
    """Both packages on one backend ("pallas": the kernel path, "xla": the
    gather path), restored afterwards (module-global state)."""
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend(request.param)
    spmm.set_backend(request.param)
    try:
        yield request.param
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)


# --- segment ops ---------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_segment_max_and_softmax_match_jax(masked):
    """Segments 2 and 5 are empty (max -inf, softmax rows absent); with a
    mask, segment 4's entries are all masked (weight 0, no NaN)."""
    rng = np.random.default_rng(1)
    ids = np.array([0, 0, 0, 1, 3, 3, 4, 4, 6, 6, 6, 6])
    logits = rng.normal(size=(ids.size, 3)).astype(np.float32)
    mask = np.ones((ids.size, 1), bool)
    if masked:
        mask[[1, 6, 7, 9]] = False
    cot = rng.normal(size=logits.shape).astype(np.float32)
    jmax = jax_segment.segment_max(jnp.asarray(logits), jnp.asarray(ids), 7)
    tmax = segment.segment_max(torch.tensor(logits), torch.tensor(ids), 7)
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    assert np.isneginf(tmax.numpy()[[2, 5]]).all()

    ref, vjp = jax.vjp(lambda x: jax_segment.segment_softmax(
        x, jnp.asarray(ids), 7, mask=jnp.asarray(mask) if masked else None),
        jnp.asarray(logits))
    (ref_dx,) = vjp(jnp.asarray(cot))
    x = torch.tensor(logits, requires_grad=True)
    out = segment.segment_softmax(x, torch.tensor(ids), 7,
                                  mask=torch.tensor(mask) if masked else None)
    out.backward(torch.tensor(cot))
    assert_close(out, ref)
    assert_close(x.grad, ref_dx)
    assert np.isfinite(x.grad.numpy()).all()
    if masked:
        assert not out.detach().numpy()[~mask[:, 0]].any()


# --- the multi-head kernels ----------------------------------------------

HC_CASES = [(1, 2), (1, 16), (1, 21), (4, 2), (4, 16), (4, 21)]


@pytest.mark.parametrize("heads,c", HC_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_mh_matches_jax(batches, heads, c, dtype):
    """Forward, dx (spmm_mh on the transpose) and d alpha (sddmm_mh), the
    port's plain versions through SpmmMhFunction against spmm_mh in
    interpret mode.  bfloat16: both round each term bf16(f32(x_j) *
    alpha); dx is cast back to bfloat16 (one ulp)."""
    jbatch, tbatch = batches
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    rng = np.random.default_rng(10 * heads + c)
    x = rng.normal(size=(n, heads * c)).astype(np.float32)
    alpha = rng.uniform(0.1, 1.0, size=(e, heads)).astype(np.float32)
    g = rng.normal(size=(n, heads * c)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x, a: jmh.spmm_mh(
        x, a, jbatch.spmm, heads=heads, num_nodes=n, interpret=True),
        jnp.asarray(x).astype(dtype), jnp.asarray(alpha))
    ref_dx, ref_da = vjp(jnp.asarray(g))

    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    at = torch.tensor(alpha, requires_grad=True)
    out = SpmmMhFunction.apply(xt, at, tbatch.spmm)
    out.backward(torch.tensor(g))
    assert out.dtype == torch.float32 and xt.grad.dtype == xt.dtype
    assert_close(out, ref)
    assert_close(xt.grad, ref_dx, rtol=BF16_ULP if dtype == "bfloat16"
                 else 1e-5)
    mask = tbatch.edge_mask.numpy()
    assert_close(at.grad[mask], np.asarray(ref_da)[mask])
    assert not at.grad[~mask].any()


@pytest.mark.parametrize("heads,c", HC_CASES)
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_sddmm_mh_matches_jax(batches, heads, c, dtypes):
    """Forward (0 on padding) and both operand gradients (two spmm_mh
    launches), against sddmm_mh in interpret mode; mixed dtypes as
    spmm_mh's backward calls it (bfloat16 x, float32 g)."""
    jbatch, tbatch = batches
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    rng = np.random.default_rng(7 * heads + c)
    hs = rng.normal(size=(n, heads * c)).astype(np.float32)
    hd = rng.normal(size=(n, heads * c)).astype(np.float32)
    mask = tbatch.edge_mask.numpy()
    ge = rng.normal(size=(e, heads)).astype(np.float32) * mask[:, None]
    ref, vjp = jax.vjp(lambda s, d: jmh.sddmm_mh(
        s, d, jbatch.spmm, heads=heads, interpret=True)[:e],
        jnp.asarray(hs).astype(dtypes[0]), jnp.asarray(hd).astype(dtypes[1]))
    ref_ds, ref_dd = vjp(jnp.asarray(ge))

    ts = torch.tensor(hs).to(getattr(torch, dtypes[0])).requires_grad_()
    td = torch.tensor(hd).to(getattr(torch, dtypes[1])).requires_grad_()
    out = SddmmMhFunction.apply(ts, td, tbatch.spmm, heads)
    out.backward(torch.tensor(ge))
    assert out.dtype == torch.float32 and out.shape == (e, heads)
    assert_close(out, ref)
    assert not out[~torch.tensor(mask)].any()
    for got, want, dt in ((ts.grad, ref_ds, dtypes[0]),
                          (td.grad, ref_dd, dtypes[1])):
        assert got.dtype == getattr(torch, dt)
        assert_close(got, want, rtol=BF16_ULP if dt == "bfloat16" else 1e-5)


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_edge_logits_match_jax(batches, heads):
    """e[k, h] = a_src[send_k, h] + a_dst[recv_k, h] through one C = 2
    SDDMM; gradients reach both node-level coefficient arrays."""
    jbatch, tbatch = batches
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    rng = np.random.default_rng(heads)
    a_src = rng.normal(size=(n, heads)).astype(np.float32)
    a_dst = rng.normal(size=(n, heads)).astype(np.float32)
    mask = tbatch.edge_mask.numpy()
    ge = rng.normal(size=(e, heads)).astype(np.float32) * mask[:, None]
    ref, vjp = jax.vjp(lambda s, d: jmh.gat_edge_logits(
        s, d, jbatch.spmm, interpret=True)[:e],
        jnp.asarray(a_src), jnp.asarray(a_dst))
    ref_ds, ref_dd = vjp(jnp.asarray(ge))
    ts = torch.tensor(a_src, requires_grad=True)
    td = torch.tensor(a_dst, requires_grad=True)
    out = gat_edge_logits(ts, td, tbatch.spmm)
    out.backward(torch.tensor(ge))
    assert_close(out, ref)
    s, r = tbatch.senders.numpy(), tbatch.receivers.numpy()
    np.testing.assert_array_equal(out.detach().numpy()[mask],
                                  (a_src[s] + a_dst[r])[mask])
    assert_close(ts.grad, ref_ds)
    assert_close(td.grad, ref_dd)


def _spmm_mh_other_rounding(x, alpha, row_ptr, col, rule):
    """spmm_mh_plain with another bf16 rule: "unrounded" leaves out the
    bf16(x * alpha) rounding point; "csr_spmm" rounds as csr_spmm's terms
    do, bf16(bf16(alpha) * x)."""
    n, (e, heads) = row_ptr.numel() - 1, alpha.shape
    c = x.shape[1] // heads
    a = alpha.float()
    if rule == "csr_spmm":
        a = a.to(torch.bfloat16).float()
    msgs = x.index_select(0, col.long()).float().view(e, heads, c) * a[..., None]
    if rule == "csr_spmm":
        msgs = msgs.to(torch.bfloat16).float()
    out = torch.zeros(n + 1, heads * c)
    return out.index_add_(0, rows_of_slots(row_ptr, e),
                          msgs.view(e, heads * c))[:n]


@pytest.mark.parametrize("rule", ["unrounded", "csr_spmm"])
def test_bf16_tolerance_catches_a_missing_rounding_point(batches, rule):
    """The card's bf16 tolerance for spmm_mh (1e-4*max|ref|,
    tests/test_torch_cuda.py) fails a kernel that rounds its terms by
    another rule, while the plain version agrees with the Pallas kernel in
    interpret mode far inside it."""
    jbatch, tbatch = batches
    n, e = tbatch.num_nodes_padded, tbatch.num_edges_padded
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, 64)).astype(np.float32)
    alpha = rng.uniform(0.1, 1.0, size=(e, 4)).astype(np.float32)
    ref = np.asarray(jmh.spmm_mh(jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(alpha), jbatch.spmm, heads=4,
                                 num_nodes=n, interpret=True))
    p = tbatch.spmm
    xb, at = torch.tensor(x).to(torch.bfloat16), torch.tensor(alpha)
    tol = 1e-4 * float(np.abs(ref).max())
    good = spmm_mh_plain(xb, at, p.row_ptr, p.col).numpy()
    bad = _spmm_mh_other_rounding(xb, at, p.row_ptr, p.col, rule).numpy()
    assert np.abs(good - ref).max() < 0.1 * tol
    assert np.abs(bad - ref).max() > tol


def test_multihead_wrappers_refuse_non_cuda_devices():
    x = torch.empty(4, 8, device="meta")
    rp = torch.zeros(5, dtype=torch.int32, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        spmm_mh(x, torch.zeros(2, 4, device="meta"), rp, idx)
    with pytest.raises(ValueError, match="CUDA"):
        sddmm_mh(x, x, idx, idx, 2, 4)


def test_sddmm_mh_plain_is_the_per_head_dot():
    """A hand-checked case: two heads of C = 3, one padding edge."""
    hs = torch.arange(12, dtype=torch.float32).view(2, 6)
    hd = torch.ones(2, 6)
    row = torch.tensor([0, 1, 1], dtype=torch.int32)
    col = torch.tensor([1, 0, 1], dtype=torch.int32)
    out = sddmm_mh_plain(hs, hd, row, col, 2, 2)
    np.testing.assert_array_equal(out.numpy(), [[6 + 7 + 8, 9 + 10 + 11],
                                                [0 + 1 + 2, 3 + 4 + 5],
                                                [0, 0]])


# --- GATConv --------------------------------------------------------------

def _layers(jlayer, jbatch, n, seed=0, **kw):
    """The flax layer's params and the port's layer carrying them."""
    params = jlayer.init(jax.random.PRNGKey(seed), jbatch.node_feat,
                         jbatch.senders, jbatch.receivers, jbatch.edge_mask,
                         num_nodes=n, **kw)["params"]
    conv = GATConv(jbatch.node_feat.shape[-1], jlayer.features,
                   heads=jlayer.heads, concat=jlayer.concat,
                   add_self_loops=jlayer.add_self_loops)
    conv.load_state_dict(_conv_state(params))
    return params, conv


def _conv_state(params):
    state = mpnn_params_from_jax({"GATConv_0": params})
    return {k.split(".", 2)[2]: v for k, v in state.items()}


def _check_grads(conv, params_grad):
    assert_close(conv.weight.grad.T, params_grad["kernel_src"])
    for name in ("att_src", "att_dst", "bias"):
        assert_close(getattr(conv, name).grad, params_grad[name])


GAT_CASES = [(1, True, True), (4, True, True), (4, False, True),
             (4, True, False), (1, False, False), (4, False, False)]


@pytest.mark.parametrize("backend", ["pallas", "xla"], indirect=True)
@pytest.mark.parametrize("heads,loops,concat", GAT_CASES)
def test_gat_conv_matches_jax(batches, backend, heads, loops, concat):
    """The sparse branches with mapped weights: backend "pallas" holds the
    port's kernel path (gat_edge_logits, spmm_mh, divide after
    aggregation) against the JAX Pallas path, "xla" the gather paths;
    outputs, dx and every parameter gradient."""
    jbatch, tbatch = batches
    n = tbatch.num_nodes_padded
    c = 5
    jlayer = JaxGATConv(features=c, heads=heads, concat=concat,
                        add_self_loops=loops)
    params, conv = _layers(jlayer, jbatch, n)
    args = (jbatch.senders, jbatch.receivers, jbatch.edge_mask)
    ref, vjp = jax.vjp(lambda x, p: jlayer.apply(
        {"params": p}, x, *args, num_nodes=n, plan=jbatch.spmm),
        jnp.asarray(jbatch.node_feat), params)
    cot = np.random.default_rng(heads).normal(size=ref.shape).astype(
        np.float32)
    ref_dx, ref_dp = vjp(jnp.asarray(cot))
    x = tbatch.node_feat.clone().requires_grad_()
    out = conv(x, tbatch.senders, tbatch.receivers, tbatch.edge_mask,
               num_nodes=n, plan=tbatch.spmm)
    (out * torch.tensor(cot)).sum().backward()
    assert out.shape == (n, heads * c if concat else c)
    assert_close(out, ref)
    assert_close(x.grad, ref_dx)
    _check_grads(conv, ref_dp)


def test_gat_conv_takes_the_kernels_only_with_a_plan(batches, monkeypatch):
    """Backend "pallas" with a plan runs the kernels' Functions (here their
    plain versions): 2 SDDMMs forward a layer with self loops, and 1
    SpMM; without a plan, or on backend "xla", neither."""
    _, tbatch = batches
    from graph_hscn_tpu_torch.models import layers
    calls = []
    monkeypatch.setattr(layers, "gat_edge_logits", lambda *a: calls.append(
        "sddmm") or gat_edge_logits(*a))
    real_apply = SpmmMhFunction.apply
    monkeypatch.setattr(layers.SpmmMhFunction, "apply", lambda *a: calls.append(
        "spmm") or real_apply(*a))
    conv = GATConv(14, 4, heads=2)
    prev = spmm.get_backend()
    try:
        for name, plan, want in (("pallas", tbatch.spmm, 3),
                                 ("pallas", None, 0), ("xla", tbatch.spmm, 0),
                                 ("auto", tbatch.spmm, 0)):
            spmm.set_backend(name)
            calls.clear()
            conv(tbatch.node_feat, tbatch.senders, tbatch.receivers,
                 tbatch.edge_mask, plan=plan)
            assert len(calls) == want, (name, calls)
    finally:
        spmm.set_backend(prev)


def test_bipartite_gat_is_the_hscn_slice(batches, monkeypatch):
    """The bipartite branch (HSCN's local->virtual relation, ported with the
    HSCN slice; held against JAX in tests/test_torch_hscn.py) takes no
    kernel, even with a plan on the kernel backend, as in the JAX layer:
    its receivers need not be sorted.  It needs a GATConv built with
    dst_features."""
    _, tbatch = batches
    from graph_hscn_tpu_torch.models import layers
    calls = []
    monkeypatch.setattr(layers, "gat_edge_logits", lambda *a: calls.append(
        "sddmm") or gat_edge_logits(*a))
    real_apply = SpmmMhFunction.apply
    monkeypatch.setattr(layers.SpmmMhFunction, "apply",
                        lambda *a: calls.append("spmm") or real_apply(*a))
    n = tbatch.num_nodes_padded
    dst = torch.arange(n) % 5    # 5 receivers, unsorted
    x_dst = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dst_features"):
        GATConv(14, 4, heads=2)(tbatch.node_feat, torch.arange(n), dst,
                                tbatch.node_mask, x_dst=x_dst)
    conv = GATConv(14, 4, heads=2, add_self_loops=False, dst_features=3)
    prev = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        outs = [conv(tbatch.node_feat, torch.arange(n), dst,
                     tbatch.node_mask, plan=plan, x_dst=x_dst)
                for plan in (tbatch.spmm, None)]
    finally:
        spmm.set_backend(prev)
    assert not calls
    assert outs[0].shape == (5, 8) and torch.equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def slotted():
    """The same peptides graphs, slotted (JAX and port) and flat (port)."""
    graphs = js.make_peptides_func(num_graphs=4, seed=71, mean_nodes=30.0)
    slot = ((max(g.num_nodes for g in graphs) + 7) // 8) * 8
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 4),
                           slot_nodes=slot)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 4),
                           slot_nodes=slot).to("cpu")
    flat = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 4)
                         ).to("cpu")
    return jbatch, tbatch, flat


@pytest.mark.parametrize("heads,loops,concat", [(1, True, True),
                                                (4, True, False),
                                                (2, False, True)])
def test_dense_gat_conv_matches_jax(slotted, heads, loops, concat):
    """The dense-slot branch (masked dense attention a graph block) with
    mapped weights: output, dx and every parameter gradient; and equal to
    the port's own sparse branch on the same graphs packed flat."""
    jbatch, tbatch, flat = slotted
    n, c = tbatch.num_nodes_padded, 6
    jadj = jax_build_dense_adj(jbatch)
    jlayer = JaxGATConv(features=c, heads=heads, concat=concat,
                        add_self_loops=loops)
    params, conv = _layers(jlayer, jbatch, n, seed=2, dense_adj=jadj)
    args = (jbatch.senders, jbatch.receivers, jbatch.edge_mask)
    ref, vjp = jax.vjp(lambda x, p: jlayer.apply(
        {"params": p}, x, *args, num_nodes=n, dense_adj=jadj),
        jnp.asarray(jbatch.node_feat), params)
    cot = np.random.default_rng(heads).normal(size=ref.shape).astype(
        np.float32)
    ref_dx, ref_dp = vjp(jnp.asarray(cot))
    x = tbatch.node_feat.clone().requires_grad_()
    out = conv(x, tbatch.senders, tbatch.receivers, tbatch.edge_mask,
               num_nodes=n, dense_adj=build_dense_adj(tbatch))
    (out * torch.tensor(cot)).sum().backward()
    assert_close(out, ref)
    assert_close(x.grad, ref_dx)
    _check_grads(conv, ref_dp)

    sparse = conv(flat.node_feat, flat.senders, flat.receivers,
                  flat.edge_mask).detach()
    assert_close(out.detach()[tbatch.node_mask], sparse[flat.node_mask])
    with pytest.raises(ValueError, match="edge_weight"):
        conv(x, tbatch.senders, tbatch.receivers, tbatch.edge_mask,
             edge_weight=torch.ones(tbatch.num_edges_padded),
             dense_adj=build_dense_adj(tbatch))


@pytest.mark.parametrize("in_features,c,heads,concat", [(14, 16, 4, True),
                                                        (64, 21, 4, False),
                                                        (9, 16, 1, True)])
def test_gat_init_bounds(batches, in_features, c, heads, concat):
    """glorot-uniform as flax draws it: kernel_src [in, H*C] with bound
    sqrt(6/(in + H*C)); att_src/att_dst (1, H, C) with fan_in H and fan_out
    C, bound sqrt(6/(H + C)); zero bias of H*C (concat) or C.  The flax
    layer's own draws respect the same bounds."""
    conv = GATConv(in_features, c, heads=heads, concat=concat,
                   generator=torch.Generator().manual_seed(0))
    a_w = np.sqrt(6.0 / (in_features + heads * c))
    a_att = np.sqrt(6.0 / (heads + c))
    assert conv.weight.shape == (heads * c, in_features)
    assert 0.9 * a_w < float(conv.weight.detach().abs().max()) <= a_w
    for att in (conv.att_src, conv.att_dst):
        assert att.shape == (1, heads, c)
        assert 0.8 * a_att < float(att.detach().abs().max()) <= a_att
    assert conv.bias.shape == (heads * c if concat else c,)
    assert not conv.bias.any()
    jbatch, _ = batches
    x = jnp.zeros((jbatch.num_nodes_padded, in_features))
    jp = JaxGATConv(features=c, heads=heads, concat=concat).init(
        jax.random.PRNGKey(3), x, jbatch.senders, jbatch.receivers,
        jbatch.edge_mask)["params"]
    assert float(jnp.abs(jp["kernel_src"]).max()) <= a_w
    for name in ("att_src", "att_dst"):
        assert 0.8 * a_att < float(jnp.abs(jp[name]).max()) <= a_att


# --- the GAT MPNN ---------------------------------------------------------

MPNN_CASES = {
    # (graphs, batch layout, features, classes, readout, heads)
    "voc_h4_kernels": ("voc", "plan", 14, 21, "none", 4),
    "voc_h4_gather": ("voc", "flat", 14, 21, "none", 4),
    "peptides_h1_dense": ("peptides", "slots", 9, 10, "mean", 1),
    "peptides_h1_kernels": ("peptides", "plan", 9, 10, "mean", 1),
}


def _mpnn_batches(kind, layout):
    if kind == "voc":
        graphs = js.make_voc_superpixels(num_graphs=3, seed=31,
                                         mean_nodes=80.0)
    else:
        graphs = js.make_peptides_func(num_graphs=3, seed=32, mean_nodes=40.0)
    slot = (((max(g.num_nodes for g in graphs) + 7) // 8) * 8
            if layout == "slots" else None)
    kw = dict(with_spmm_plan=layout == "plan", slot_nodes=slot)
    jbatch = jb.pack_batch(graphs, jb.PadBudget.for_dataset(graphs, 3), **kw)
    tbatch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 3),
                           **kw).to("cpu")
    return jbatch, tbatch


@pytest.mark.parametrize("case", sorted(MPNN_CASES))
def test_gat_mpnn_matches_jax(case):
    """The GAT MPNN (2 layers: hidden heads concatenated, output heads
    averaged) through convert.py: logits and every parameter gradient, on
    the kernel path ("pallas" both sides), the gather path ("xla") and the
    dense-slot branch."""
    kind, layout, nf, nc, readout, heads = MPNN_CASES[case]
    jbatch, tbatch = _mpnn_batches(kind, layout)
    name = "pallas" if layout == "plan" else "xla"
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend(name)
    spmm.set_backend(name)
    try:
        kw = dict(conv_type="gat", activation="relu", num_features=nf,
                  hidden_channels=16, num_classes=nc, num_layers=2,
                  dropout=0.0, readout=readout, num_heads=heads)
        jmodel = JaxMPNN(**kw)
        params = jmodel.init(jax.random.PRNGKey(5), jbatch,
                             train=False)["params"]
        logits, vjp = jax.vjp(
            lambda p: jmodel.apply({"params": p}, jbatch, train=False),
            params)
        cot = np.random.default_rng(1).normal(size=logits.shape).astype(
            np.float32)
        (jgrads,) = vjp(jnp.asarray(cot))
        model = MPNN(**kw)
        model.load_state_dict(mpnn_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        model.eval()
        out = model(tbatch)
        (out * torch.tensor(cot)).sum().backward()
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)
    assert out.dtype == torch.float32
    assert_close(out, logits)
    widths = [(16 // heads, heads, True), (nc, heads, False)]
    for i, (c, h, concat) in enumerate(widths):
        conv = model.convs[i]
        assert (conv.features, conv.heads, conv.concat) == (c, h, concat)
        _check_grads(conv, jgrads[f"GATConv_{i}"])


# --- routes and training --------------------------------------------------

def _small_cfgs(path, num_graphs, batch_size, layers=2):
    """The port's and the JAX package's parse of a GAT config, shrunk."""
    cfgs = load_config(path), jax_load_config(path)
    for cfg in cfgs:
        cfg.data.num_graphs = num_graphs
        cfg.data.batch_size = batch_size
        cfg.mpnn.num_layers = layers
        cfg.training.epochs = 2
        cfg.training.eval_period = 1
    return cfgs


def test_voc_gat_config_is_the_sparse_twin():
    """The new config is the shipped edge-partition one without the mesh,
    on the sparse path, with num_graphs 128; 4 heads written out."""
    import yaml
    ours = yaml.safe_load(VOC_GAT.read_text())
    shipped = yaml.safe_load((ROOT / "configs" / "GAT" /
                              "voc_superpixels_GAT_edge_partition.yaml")
                             .read_text())
    assert ours.pop("runtime") == {"device_dataset": "off",
                                   "dense_path": "sparse"}
    assert ours["data"].pop("num_graphs") == 128
    assert ours["mp"].pop("num_heads") == 4
    shipped.pop("mesh")
    assert ours == shipped
    cfg = load_config(VOC_GAT)
    assert cfg.mpnn.num_heads == jax_load_config(VOC_GAT).mpnn.num_heads == 4


@pytest.mark.parametrize("path,batch_size", [(VOC_GAT, 4),
                                             (PEPTIDES_GAT, 8)])
def test_gat_configs_route_as_jax(path, batch_size, monkeypatch):
    """Both GAT configs, shrunk, train on the CPU through run_experiment
    with finite losses, along the route the JAX runner picks: VOC on the
    host fit loop with CSR plans on its batches (backend "pallas" here, a
    card in production), peptides on dense slots and the device-resident
    dataset; neither takes the fused stack."""
    cfg, jcfg = _small_cfgs(path, 24, batch_size)
    sparse = path == VOC_GAT
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen["route"] = name
            if name == "fit":
                seen["plans"] = all(b.spmm is not None for b in args[2])
            return fn(*args, **kw)
        monkeypatch.setattr(runner, name, wrapped)

    spy("fit", runner.fit)
    spy("fit_device", runner.fit_device)
    prev = spmm.get_backend()
    try:
        cfg.runtime.spmm_backend = "pallas" if sparse else "auto"
        result = runner.run_experiment(cfg, device="cpu")
    finally:
        spmm.set_backend(prev)
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert isinstance(result.model, MPNN)
    assert result.model.conv_type == "gat"
    assert result.model.convs[0].heads == cfg.mpnn.num_heads

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


@pytest.mark.parametrize("path,layout", [(VOC_GAT, "plan"),
                                         (PEPTIDES_GAT, "slots")])
def test_gat_training_follows_jax(path, layout):
    """3 AdamW steps of each GAT config, shrunk to 2 layers at its own
    widths, heads and optimizer, dropout 0, from mapped weights: each
    step's loss and the final weights within 1e-5 relative of the JAX
    train step (VOC: both kernel paths; peptides: the dense-slot branch)."""
    cfg, jcfg = _small_cfgs(path, 6, 2)
    cfg.mpnn.dropout = jcfg.mpnn.dropout = 0.0
    kind = "voc" if path == VOC_GAT else "peptides"
    graphs = (js.make_voc_superpixels(num_graphs=6, seed=41, mean_nodes=70.0)
              if kind == "voc" else
              js.make_peptides_func(num_graphs=6, seed=41, mean_nodes=35.0))
    slot = (((max(g.num_nodes for g in graphs) + 7) // 8) * 8
            if layout == "slots" else None)
    kw = dict(with_spmm_plan=layout == "plan", slot_nodes=slot)
    budget_j = jb.PadBudget.for_dataset(graphs, 2)
    budget_t = tb.PadBudget.for_dataset(graphs, 2)
    jbatches = [jb.pack_batch(graphs[i:i + 2], budget_j, **kw)
                for i in (0, 2, 4)]
    tbatches = [tb.pack_batch(graphs[i:i + 2], budget_t, **kw).to("cpu")
                for i in (0, 2, 4)]
    nf = graphs[0].x.shape[1]
    nc = 21 if kind == "voc" else 10
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

        model = build_mpnn(cfg.mpnn, nf, nc, readout=readout)
        model.load_state_dict(mpnn_params_from_jax(init))
        opt = build_optimizer(model.parameters(), o.optim_type, o.lr,
                              o.weight_decay)
        step, _ = make_train_step(model, opt, loss_fn, node_level=node_level)
        tlosses = [float(step(b)[0]) for b in tbatches]
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    final = mpnn_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        state.params))
    assert set(final) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert_close(p, final[name])


def test_main_cli_trains_gat_on_cpu(tmp_path, monkeypatch):
    """python -m graph_hscn_tpu_torch.main --cfg <the VOC GAT config,
    shrunk> --device cpu: an epoch's loss in the log."""
    import sys

    import yaml

    from graph_hscn_tpu_torch import main as cli
    raw = yaml.safe_load(VOC_GAT.read_text())
    raw["data"]["num_graphs"] = 16
    raw["data"]["batch_size"] = 8
    raw["mp"]["num_layers"] = 2
    raw["training"]["max_epochs"] = 1
    cfg_file = tmp_path / "voc_gat.yaml"
    cfg_file.write_text(yaml.safe_dump(raw))
    monkeypatch.setattr(cli, "LOGS_DIR", tmp_path / "logs")
    monkeypatch.setattr(sys, "argv", ["main", "--cfg", str(cfg_file),
                                      "--device", "cpu"])
    cli.main()
    log = (tmp_path / "logs" / "voc_superpixels_gat_torch.log").read_text()
    assert "Epoch: 0 -- Loss" in log
