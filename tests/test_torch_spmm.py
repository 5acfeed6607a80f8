"""The port's sparse aggregation against the JAX package's Pallas kernels
(interpret mode on the CPU): gather_scatter forward and gradients against
spmm_pallas, edge_sddmm against sddmm_pallas, the CSR plan against a dense
adjacency, and gcn_norm_weights.

Tolerance rtol=1e-5, atol=1e-5*max|ref|: float32 sums taken in another
order (edge order on the CPU, one-hot matmuls in the Pallas kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.data.batching import PadBudget as JaxPadBudget
from graph_hscn_tpu.data.batching import pack_batch as jax_pack_batch
from graph_hscn_tpu.data.synthetic import make_voc_superpixels
from graph_hscn_tpu.ops import spmm as jax_spmm
from graph_hscn_tpu.ops.pallas.sddmm_kernel import sddmm_pallas
from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import (edge_sddmm,
                                                        edge_sddmm_plain)
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (SpmmFunction,
                                                       csr_plan, csr_spmm,
                                                       csr_spmm_plain)


def assert_close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    atol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def graphs():
    return make_voc_superpixels(num_graphs=3, seed=21, mean_nodes=150.0)


@pytest.fixture(scope="module")
def batches(graphs):
    """(JAX batch with a Pallas plan, port batch with a CSR plan), one set of
    graphs packed by each package, padding edges included."""
    budget = JaxPadBudget.for_dataset(graphs, batch_size=3)
    jb = jax_pack_batch(graphs, budget, with_spmm_plan=True)
    assert jb.spmm is not None
    tb = pack_batch(graphs, PadBudget.for_dataset(graphs, batch_size=3),
                    with_spmm_plan=True)
    assert tb.num_edges_padded > tb.spmm.num_edges   # has padding edges
    return jb, tb


@pytest.fixture
def pallas_backends():
    """Both packages on their kernel path; restored afterwards (the
    backends are module-global and test files share worker processes)."""
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend("pallas")
    spmm.set_backend("pallas")
    try:
        yield
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)


@pytest.mark.parametrize("weighted,weight_needs_grad,f", [
    (False, False, 16), (True, False, 16), (True, True, 16), (True, True, 5)])
def test_gather_scatter_matches_pallas(batches, pallas_backends, weighted,
                                       weight_needs_grad, f):
    jb, tb = batches
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    rng = np.random.default_rng(f + 10 * weighted)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=e).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)

    def jf(x, w):
        return jax_spmm.gather_scatter(
            x, jb.senders, jb.receivers, num_nodes=n,
            edge_weight=w if weighted else None, plan=jb.spmm,
            weight_needs_grad=weight_needs_grad)

    ref, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(g))

    b = tb.to("cpu")
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = spmm.gather_scatter(xt, b.senders, b.receivers, num_nodes=n,
                              edge_weight=wt if weighted else None,
                              plan=b.spmm,
                              weight_needs_grad=weight_needs_grad)
    assert out.dtype == torch.float32
    out.backward(torch.tensor(g))
    assert_close(out.detach(), ref)
    assert_close(xt.grad, ref_dx)
    if weighted and weight_needs_grad:
        mask = np.asarray(jb.edge_mask)
        assert_close(wt.grad.numpy()[mask], np.asarray(ref_dw)[mask])
        assert not wt.grad.numpy()[~mask].any()
    else:
        # Detached weights: no gradient on either side.
        assert wt.grad is None
        assert not np.asarray(ref_dw).any()


def test_gather_scatter_bf16_matches_pallas(batches, pallas_backends):
    """bf16 operands: both return f32 and dx in bf16.  Both round each
    term as the Pallas tile body does (spmm_kernel.py:223,230): the weight
    to bf16, then the message bf16(w) * x_j to bf16, summed in f32; so the
    forward agrees to f32 summation order (atol 1e-5*max|ref|).  dx is a
    float32 sum rounded to bf16 on both sides, held at the same level."""
    jb, tb = batches
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=e).astype(np.float32)
    g = rng.normal(size=(n, 8)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    ref, vjp = jax.vjp(lambda x: jax_spmm.gather_scatter(
        x, jb.senders, jb.receivers, num_nodes=n, edge_weight=wj,
        plan=jb.spmm), xj)
    (ref_dx,) = vjp(jnp.asarray(g))
    b = tb.to("cpu")
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    out = spmm.gather_scatter(xt, b.senders, b.receivers, num_nodes=n,
                              edge_weight=torch.tensor(w).to(torch.bfloat16),
                              plan=b.spmm)
    out.backward(torch.tensor(g))
    assert out.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    for got, want in ((out.detach(), ref), (xt.grad.float(), ref_dx)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-5,
            atol=1e-5 * float(np.abs(want).max()))


def test_csr_spmm_plain_rounds_bf16_terms():
    """The plain version's bf16 terms: bf16(bf16(w) * x) summed in f32;
    its float32 path sums w * x unrounded."""
    x = torch.tensor([[1.0 + 2 ** -7], [3.0]])
    w = torch.tensor([1.0 + 2 ** -9, 1.0 / 3.0])
    row_ptr = torch.tensor([0, 2, 2], dtype=torch.int32)
    col = torch.tensor([0, 1], dtype=torch.int32)
    bf = torch.bfloat16
    want = sum(float((w[i].to(bf).float() * x[i].to(bf).float()).to(bf))
               for i in range(2))
    out = csr_spmm_plain(x.to(bf), row_ptr, col, w)
    assert out[0, 0].item() == np.float32(want) and out[1, 0] == 0
    exact = float(w[0] * x[0, 0]) + float(w[1] * x[1, 0])
    f32 = csr_spmm_plain(x, row_ptr, col, w)
    np.testing.assert_allclose(f32[0, 0].item(), exact, rtol=1e-7)


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_gather_scatter_plain_path_matches_xla(batches, backend):
    """Backend "xla" (and "auto" on the CPU) take the plain path over every
    edge slot, like the JAX XLA path, padding edges included."""
    jb, tb = batches
    n = tb.num_nodes_padded
    x = np.random.default_rng(5).normal(size=(n, 6)).astype(np.float32)
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend("xla")
    spmm.set_backend(backend)
    try:
        ref = jax_spmm.gather_scatter(jnp.asarray(x), jb.senders,
                                      jb.receivers, num_nodes=n)
        b = tb.to("cpu")
        out, msgs = spmm.gather_scatter(torch.tensor(x), b.senders,
                                        b.receivers, num_nodes=n,
                                        plan=b.spmm, messages_out=True)
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)
    assert_close(out, ref)
    assert msgs.shape == (tb.num_edges_padded, 6)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float32")])
def test_edge_sddmm_matches_sddmm_pallas(batches, dtypes):
    jb, tb = batches
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    rng = np.random.default_rng(7)
    hs = rng.normal(size=(n, 12)).astype(np.float32)
    hd = rng.normal(size=(n, 12)).astype(np.float32)
    js, jd = (jnp.asarray(hs).astype(dtypes[0]),
              jnp.asarray(hd).astype(dtypes[1]))
    ref = np.asarray(sddmm_pallas(js, jd, jb.spmm, interpret=True))[:e]
    p = tb.spmm.to("cpu")
    ts = torch.tensor(hs).to(getattr(torch, dtypes[0]))
    td = torch.tensor(hd).to(getattr(torch, dtypes[1]))
    out = edge_sddmm(ts, td, p.row, p.col, p.num_edges)
    assert out.dtype == torch.float32 and out.shape == (e,)
    assert_close(out, ref)
    assert not out[p.num_edges:].any()
    assert_close(edge_sddmm_plain(ts, td, p.row, p.col, p.num_edges), ref)


def test_csr_plan_matches_dense_adjacency(batches):
    _, tb = batches
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    p = tb.spmm
    mask = tb.edge_mask
    rng = np.random.default_rng(9)
    w = rng.uniform(0.5, 1.5, size=e).astype(np.float32)
    dense = np.zeros((n, n), np.float64)
    np.add.at(dense, (tb.receivers[mask], tb.senders[mask]), w[mask])
    x = rng.normal(size=(n, 7))
    pt = p.to("cpu")
    wt = torch.tensor(w)
    fwd = csr_spmm_plain(torch.tensor(x, dtype=torch.float32), pt.row_ptr,
                         pt.col, wt)
    bwd = csr_spmm_plain(torch.tensor(x, dtype=torch.float32), pt.t_row_ptr,
                         pt.t_col, wt[pt.t_order])
    assert_close(fwd, dense @ x)
    assert_close(bwd, dense.T @ x)
    # The transpose order is the JAX plan's: a stable sort by sender.
    np.testing.assert_array_equal(p.t_order,
                                  np.argsort(tb.senders, kind="stable"))
    assert p.row_ptr[-1] == p.t_row_ptr[-1] == int(mask.sum())


def test_csr_plan_rejects_bad_layouts():
    snd = np.array([0, 1, 2, 3], np.int32)
    rcv = np.array([1, 0, 2, 3], np.int32)
    with pytest.raises(ValueError, match="receiver-sorted"):
        csr_plan(snd, rcv, np.ones(4, bool), 5)
    with pytest.raises(ValueError, match="before the padding"):
        csr_plan(snd, np.sort(rcv), np.array([1, 0, 1, 0], bool), 5)
    with pytest.raises(ValueError, match="outside"):
        csr_plan(snd, np.sort(rcv), np.ones(4, bool), 3)


def test_kernel_wrappers_refuse_non_cuda_devices():
    """On a device that is neither the CPU nor CUDA the wrappers raise
    instead of falling back to their plain versions."""
    x = torch.empty(4, 3, device="meta")
    rp = torch.zeros(5, dtype=torch.int32, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmm(x, rp, idx, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        edge_sddmm(x, x, idx, idx, 2)


def test_spmm_function_checks_plan_shapes(batches):
    _, tb = batches
    p = tb.spmm.to("cpu")
    with pytest.raises(ValueError, match="do not fit the plan"):
        SpmmFunction.apply(torch.zeros(3, 2), torch.zeros(3), p, False)


@pytest.mark.parametrize("weighted,self_loops", [(False, True), (True, True),
                                                 (False, False)])
def test_gcn_norm_weights_match_jax(batches, weighted, self_loops):
    jb, tb = batches
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    ew = np.random.default_rng(11).uniform(0.5, 2.0, e).astype(np.float32)
    jw, jdiag = jax_spmm.gcn_norm_weights(
        jb.senders, jb.receivers, jb.edge_mask, n, add_self_loops=self_loops,
        edge_weight=jnp.asarray(ew) if weighted else None)
    b = tb.to("cpu")
    tw, tdiag = spmm.gcn_norm_weights(
        b.senders, b.receivers, b.edge_mask, n, add_self_loops=self_loops,
        edge_weight=torch.tensor(ew) if weighted else None)
    assert_close(tw, jw)
    if self_loops:
        assert_close(tdiag, jdiag)
    else:
        assert tdiag is None and jdiag is None
