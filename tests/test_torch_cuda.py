"""The port's CUDA kernels on the card, each against its plain PyTorch
version (marker ``gpu``; each test skips where there is no CUDA card).

On a machine with the card, from the repository root (no JAX needed, hence
no conftest):

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

Tolerance: float32 sums in another order, rtol=1e-5, atol=1e-5*max|ref|.
spmm_mh in bfloat16 is held at rtol=1e-4, atol=1e-4*max|ref|: kernel and
plain version round each term bf16(f32(x_j) * alpha) alike, while another
rounding rule fails it (tests/test_torch_gat.py,
test_bf16_tolerance_catches_a_missing_rounding_point).
The fused GCN stack is held as chip_smoke.py's [fused] phase holds it:
every output finite and within tol*max|ref| of its plain version, tol 1e-5
in float32 and 1e-4 in bfloat16, the plain version run by
graph_hscn_tpu_torch.ops.fused_gcn.plain_reference: in bfloat16 with its
matrix products summed in order, the kernels' order.  Kernel and plain
version round the same float32 values to bfloat16 at the same points, so
in that order every rounded output (hidden h, logits, dx) agrees bit for
bit; cuBLAS picks its own order by shape, and a sum next to a rounding
midpoint then rounds one bfloat16 ulp (0.4%) away.  A kernel that leaves
out a rounding point fails 1e-4 (tests/test_torch_fused_gcn.py,
test_bf16_tolerance_catches_a_missing_rounding_point).
segment_reduce in bfloat16 is held at rtol=1e-4, atol=1e-4*max|ref|: both
sum the same exact bfloat16 values in float32, in another order.
"""

import numpy as np
import pytest
import torch

from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
from graph_hscn_tpu_torch.data.synthetic import (lattice_edges,
                                                  make_voc_superpixels)
from graph_hscn_tpu_torch.ops import segment, spmm
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import (edge_sddmm,
                                                        edge_sddmm_plain)
from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import (SpmmMhFunction,
                                                            gat_edge_logits,
                                                            sddmm_mh,
                                                            sddmm_mh_plain,
                                                            spmm_mh,
                                                            spmm_mh_plain)
from graph_hscn_tpu_torch.ops.cuda.segment_reduce_kernel import (
    segment_reduce, segment_reduce_plain)
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (csr_plan, csr_spmm,
                                                       csr_spmm_plain)
from graph_hscn_tpu_torch.ops.fused_gcn import (dropout_bits_plain,
                                                dropout_threshold,
                                                folded_operator,
                                                fused_gcn_bwd,
                                                fused_gcn_bwd_plain,
                                                fused_gcn_fwd,
                                                fused_gcn_fwd_plain,
                                                fused_gcn_stack, fused_plan,
                                                plain_reference)

pytestmark = pytest.mark.gpu


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def assert_close(got, ref, tol=1e-5):
    ref = ref.detach().float().cpu()
    torch.testing.assert_close(got.detach().float().cpu(), ref, rtol=tol,
                               atol=tol * max(float(ref.abs().max()), 1e-6))


def assert_fused_close(got, ref, dtype, rounded=False):
    """The fused kernels' criterion (module docstring): finite, max |got -
    ref| <= tol * max|ref|; a ``rounded`` bfloat16 output bit for bit."""
    got, ref = got.detach().float(), ref.detach().float()
    tol = ((1e-5 if dtype == torch.float32 else 1e-4)
           * max(float(ref.abs().max()), 1e-6))
    err = float((got - ref).abs().max())
    assert bool(got.isfinite().all()) and err <= tol, (
        f"max |err| {err:.3e} > tolerance {tol:.3e}")
    if rounded and dtype == torch.bfloat16:
        assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def batch():
    graphs = make_voc_superpixels(num_graphs=16, seed=51)
    b = pack_batch(graphs, PadBudget.for_dataset(graphs, 16),
                   with_spmm_plan=True)
    return b


# Widths that reach every launch plan csr_spmm and edge_sddmm build, in
# float32 and bfloat16 (held so by tests/test_torch_spmm_plan.py): the VOC
# GCN path's 64 and 21, the lattices' 128, and widths for the narrower
# vectors, the passes, the lane groups and the edges in flight (1 to 136).
ROW_WIDTHS = [1, 2, 3, 4, 6, 8, 9, 18, 21, 34, 36, 64, 65, 66, 68, 128, 129,
              130, 132, 136]


@pytest.mark.parametrize("f", ROW_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_matches_plain(batch, f, dtype):
    """Every plan: the forward, and the transpose with the weights gathered
    beforehand and with them read in t_order by the kernel (order), against
    the plain version on w[t_order]; each twice, bit for bit (a fixed
    summation order); one launch a call."""
    need_card()
    p = batch.spmm.to("cuda")
    n = p.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(f)
    x = torch.randn(n, f, device="cuda", generator=gen).to(dtype)
    w = torch.rand(p.col.numel(), device="cuda", generator=gen)
    before = csr_spmm.launches
    for rp, col, ww, order in ((p.row_ptr, p.col, w, None),
                               (p.t_row_ptr, p.t_col, w[p.t_order], None),
                               (p.t_row_ptr, p.t_col, w, p.t_order)):
        out = csr_spmm(x, rp, col, ww, order)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == (n, f)
        ref_w = ww if order is None else ww[order]
        assert_close(out, csr_spmm_plain(x, rp, col, ref_w))
        assert torch.equal(out, csr_spmm(x, rp, col, ww, order))
    assert csr_spmm.launches == before + 6


@pytest.mark.parametrize("f", ROW_WIDTHS)
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_edge_sddmm_matches_plain(batch, f, dtypes):
    """Every plan and every pair of operand dtypes (the plan is the
    narrower operand's); the padding edges are 0; twice, bit for bit; one
    launch a call."""
    need_card()
    p = batch.spmm.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(200 + f)
    hs = torch.randn(p.num_nodes, f, device="cuda", generator=gen)
    hd = torch.randn(p.num_nodes, f, device="cuda", generator=gen)
    hs, hd = hs.to(dtypes[0]), hd.to(dtypes[1])
    before = edge_sddmm.launches
    out = edge_sddmm(hs, hd, p.row, p.col, p.num_edges)
    torch.cuda.synchronize()
    assert edge_sddmm.launches == before + 1
    assert out.shape == (p.col.numel(),)
    assert_close(out, edge_sddmm_plain(hs, hd, p.row, p.col, p.num_edges))
    assert not out[p.num_edges:].any()
    assert torch.equal(out, edge_sddmm(hs, hd, p.row, p.col, p.num_edges))


@pytest.mark.parametrize("weight_needs_grad", [False, True])
def test_gather_scatter_grads_match_cpu(batch, weight_needs_grad):
    """The kernel path's forward and gradients on the card against the same
    autograd.Function on the CPU (plain versions)."""
    need_card()
    n, e = batch.num_nodes_padded, batch.num_edges_padded
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.normal(size=(n, 32)).astype(np.float32))
    w0 = torch.tensor(rng.uniform(0.5, 1.5, e).astype(np.float32))
    g = torch.tensor(rng.normal(size=(n, 32)).astype(np.float32))
    prev = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        res = {}
        for dev in ("cpu", "cuda"):
            b = batch.to(dev)
            x = x0.to(dev, copy=True).requires_grad_()
            w = w0.to(dev, copy=True).requires_grad_()
            out = spmm.gather_scatter(x, b.senders, b.receivers,
                                      edge_weight=w, plan=b.spmm,
                                      weight_needs_grad=weight_needs_grad)
            out.backward(g.to(dev))
            res[dev] = (out, x.grad, w.grad)
    finally:
        spmm.set_backend(prev)
    (out_c, dx_c, dw_c), (out_g, dx_g, dw_g) = res["cpu"], res["cuda"]
    assert_close(out_g, out_c)
    assert_close(dx_g, dx_c)
    if weight_needs_grad:
        assert_close(dw_g, dw_c)
    else:
        assert dw_g is None and dw_c is None


def test_wrappers_refuse_what_the_kernels_do_not_take(batch):
    need_card()
    p = batch.spmm.to("cuda")
    n = p.num_nodes
    x = torch.randn(n, 8, device="cuda")
    w = torch.rand(p.col.numel(), device="cuda")
    with pytest.raises(TypeError):
        csr_spmm(x.double(), p.row_ptr, p.col, w)
    with pytest.raises(TypeError):
        csr_spmm(x, p.row_ptr.long(), p.col, w)
    with pytest.raises(ValueError, match="contiguous"):
        csr_spmm(torch.randn(8, n, device="cuda").t(), p.row_ptr, p.col, w)
    with pytest.raises(ValueError, match="rows"):
        csr_spmm(x[:-1], p.row_ptr, p.col, w)
    with pytest.raises(ValueError, match="cpu"):
        csr_spmm(x, p.row_ptr.cpu(), p.col, w)
    with pytest.raises(TypeError):
        edge_sddmm(x.half(), x, p.row, p.col, p.num_edges)


@pytest.mark.parametrize("f", [21, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_kernels_on_hub_and_empty_rows(f, dtype):
    """A row of 100 edges on each side of the plan (several rounds of a
    lane group's index loads), a plan whose every other row has no edge,
    and one with no edge at all: csr_spmm (forward, and transpose with
    order) and edge_sddmm against their plain versions; empty rows are
    zeros."""
    need_card()
    p = hub_plan(hub_edges=100)
    assert int((p.row_ptr[1:] - p.row_ptr[:-1]).max()) >= 100
    assert int((p.t_row_ptr[1:] - p.t_row_ptr[:-1]).max()) >= 100
    n, e = p.num_nodes, p.col.numel()
    gen = torch.Generator(device="cuda").manual_seed(f)
    x = torch.randn(n, f, device="cuda", generator=gen).to(dtype)
    g = torch.randn(n, f, device="cuda", generator=gen)
    w = torch.rand(e, device="cuda", generator=gen)
    assert_close(csr_spmm(x, p.row_ptr, p.col, w),
                 csr_spmm_plain(x, p.row_ptr, p.col, w))
    assert_close(csr_spmm(x, p.t_row_ptr, p.t_col, w, p.t_order),
                 csr_spmm_plain(x, p.t_row_ptr, p.t_col, w[p.t_order]))
    dots = edge_sddmm(x, g, p.row, p.col, p.num_edges)
    assert_close(dots, edge_sddmm_plain(x, g, p.row, p.col, p.num_edges))
    assert not dots[p.num_edges:].any()
    # Every other row keeps no edge: the CSR of the rows' first edges.
    counts = (p.row_ptr[1:] - p.row_ptr[:-1]).clone()
    counts[::2] = 0
    sparse_ptr = torch.zeros_like(p.row_ptr)
    sparse_ptr[1:] = counts.cumsum(0)
    keep = torch.repeat_interleave(counts > 0, p.row_ptr[1:]
                                   - p.row_ptr[:-1])
    col = p.col.clone()   # slots past sparse_ptr[N] are not read
    col[:int(sparse_ptr[-1])] = p.col[:p.num_edges][keep]
    out = csr_spmm(x, sparse_ptr, col, w)
    assert_close(out, csr_spmm_plain(x, sparse_ptr, col, w))
    assert not out[counts == 0].any()
    empty = csr_spmm(x, torch.zeros_like(p.row_ptr), p.col, w)
    torch.cuda.synchronize()
    assert empty.shape == (n, f) and not empty.any()


def test_csr_kernels_take_views_that_are_not_16_byte_aligned(batch):
    """x (and edge_sddmm's operands) as contiguous views 4 bytes into
    their storage: the wrappers copy them to aligned memory, and the
    results match the plain versions."""
    need_card()
    p = batch.spmm.to("cuda")
    n, f = p.num_nodes, 64
    store = torch.randn(n * f + 1, device="cuda")
    x = store[1:].view(n, f)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w = torch.rand(p.col.numel(), device="cuda")
    assert_close(csr_spmm(x, p.row_ptr, p.col, w),
                 csr_spmm_plain(x, p.row_ptr, p.col, w))
    assert_close(csr_spmm(x, p.t_row_ptr, p.t_col, w, p.t_order),
                 csr_spmm_plain(x, p.t_row_ptr, p.t_col, w, p.t_order))
    assert_close(edge_sddmm(x, x, p.row, p.col, p.num_edges),
                 edge_sddmm_plain(x, x, p.row, p.col, p.num_edges))


def test_run_experiment_on_the_card_launches_the_kernel():
    need_card()
    from pathlib import Path

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.runner import run_experiment
    cfg = load_config(Path(__file__).parents[1] / "configs" / "GCN"
                      / "voc_superpixels_GCN_sparse.yaml")
    cfg.data.num_graphs = 24
    cfg.mpnn.num_layers = 2
    cfg.training.epochs = 1
    before = csr_spmm.launches
    result = run_experiment(cfg)
    assert np.isfinite(result.history[0]["train_loss"])
    assert csr_spmm.launches - before == (2 * 2 * result.num_train_steps
                                          + 2 * result.num_eval_batches)


# The GAT path's widths (H*C = 64, 84 and 8, C not a power of two) and
# widths that reach every launch plan the kernels build (held so by
# tests/test_torch_multihead_plan.py): one head of an odd width (one lane
# a row), a head of 5 values (one value a load), 8 heads of 32 (two lanes
# a head), 50 values a head (8 vectors a lane), 129 (vector chunks past
# what a group holds at once), 33 heads (two head passes, by edge), one
# head of 1, 4, 8 or 12 values (the narrow vector widths), and 4 heads of 3
# or 10 (the row layout's narrower vectors).
MH_WIDTHS = [(4, 16), (4, 21), (4, 2), (1, 16), (1, 7), (3, 5), (8, 32),
             (3, 50), (3, 129), (33, 2), (1, 1), (1, 4), (1, 8), (1, 12),
             (4, 3), (4, 10)]


@pytest.mark.parametrize("heads,c", MH_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_mh_matches_plain(batch, heads, c, dtype):
    """Forward, transpose with alpha permuted beforehand, and transpose with
    the permutation folded into the kernel (order = t_order)."""
    need_card()
    p = batch.spmm.to("cuda")
    n = p.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(heads * c)
    x = torch.randn(n, heads * c, device="cuda", generator=gen).to(dtype)
    alpha = torch.rand(p.col.numel(), heads, device="cuda", generator=gen)
    a_t = alpha[p.t_order].contiguous()
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    before = spmm_mh.launches
    for rp, col, a, order, a_ref in (
            (p.row_ptr, p.col, alpha, None, alpha),
            (p.t_row_ptr, p.t_col, a_t, None, a_t),
            (p.t_row_ptr, p.t_col, alpha, p.t_order, a_t)):
        out = spmm_mh(x, a, rp, col, order)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == (n, heads * c)
        assert_close(out, spmm_mh_plain(x, a_ref, rp, col), tol)
    assert spmm_mh.launches == before + 3


@pytest.mark.parametrize("heads,c", MH_WIDTHS + [(1, 2)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_sddmm_mh_matches_plain(batch, heads, c, dtypes):
    need_card()
    p = batch.spmm.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(c)
    hs = torch.randn(p.num_nodes, heads * c, device="cuda", generator=gen)
    hd = torch.randn(p.num_nodes, heads * c, device="cuda", generator=gen)
    hs, hd = hs.to(dtypes[0]), hd.to(dtypes[1])
    before = sddmm_mh.launches
    out = sddmm_mh(hs, hd, p.row, p.col, p.num_edges, heads)
    torch.cuda.synchronize()
    assert sddmm_mh.launches == before + 1
    assert out.shape == (p.col.numel(), heads)
    assert_close(out, sddmm_mh_plain(hs, hd, p.row, p.col, p.num_edges,
                                     heads))
    assert not out[p.num_edges:].any()


def hub_plan(n=3000, hub_edges=1500, seed=0):
    """A plan whose node 0 receives ``hub_edges`` edges and whose node 1
    sends as many (hub rows on both sides, many chunks of a lane group),
    beside ~2 random edges a node and 100 padding slots."""
    rng = np.random.default_rng(seed)
    snd = np.concatenate([rng.integers(0, n, hub_edges), np.ones(hub_edges),
                          rng.integers(0, n, 2 * n)]).astype(np.int32)
    rcv = np.concatenate([np.zeros(hub_edges), rng.integers(0, n, hub_edges),
                          rng.integers(0, n, 2 * n)]).astype(np.int32)
    srt = np.argsort(rcv, kind="stable")
    snd = np.concatenate([snd[srt], np.full(100, n - 1, np.int32)])
    rcv = np.concatenate([rcv[srt], np.full(100, n - 1, np.int32)])
    mask = np.arange(snd.size) < srt.size
    return csr_plan(snd, rcv, mask, n).to("cuda")


@pytest.mark.parametrize("heads,c", [(4, 16), (4, 21), (4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multihead_kernels_on_hub_rows(heads, c, dtype):
    """A row of 1,500 edges on each side of the plan: both kernels, the
    transpose with the folded order, against their plain versions."""
    need_card()
    p = hub_plan()
    assert int((p.row_ptr[1:] - p.row_ptr[:-1]).max()) >= 1000
    assert int((p.t_row_ptr[1:] - p.t_row_ptr[:-1]).max()) >= 1000
    n, f = p.num_nodes, heads * c
    gen = torch.Generator(device="cuda").manual_seed(c)
    x = torch.randn(n, f, device="cuda", generator=gen).to(dtype)
    g = torch.randn(n, f, device="cuda", generator=gen)
    alpha = torch.rand(p.col.numel(), heads, device="cuda", generator=gen)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    assert_close(spmm_mh(x, alpha, p.row_ptr, p.col),
                 spmm_mh_plain(x, alpha, p.row_ptr, p.col), tol)
    assert_close(spmm_mh(x, alpha, p.t_row_ptr, p.t_col, p.t_order),
                 spmm_mh_plain(x, alpha[p.t_order], p.t_row_ptr, p.t_col),
                 tol)
    out = sddmm_mh(x, g, p.row, p.col, p.num_edges, heads)
    assert_close(out, sddmm_mh_plain(x, g, p.row, p.col, p.num_edges, heads))
    assert not out[p.num_edges:].any()


@pytest.mark.parametrize("heads,c", [(4, 16), (4, 21), (4, 2)])
def test_multihead_kernels_on_empty_rows(batch, heads, c):
    """A plan with no real edge: spmm_mh writes zero rows, sddmm_mh zeros
    every slot, with no zero-fill launch."""
    need_card()
    p = batch.spmm.to("cuda")
    n, e = p.num_nodes, p.col.numel()
    empty = torch.zeros_like(p.row_ptr)
    x = torch.randn(n, heads * c, device="cuda")
    alpha = torch.rand(e, heads, device="cuda")
    out = spmm_mh(x, alpha, empty, p.col)
    dots = sddmm_mh(x, x, p.row, p.col, 0, heads)
    torch.cuda.synchronize()
    assert out.shape == (n, heads * c) and not out.any()
    assert dots.shape == (e, heads) and not dots.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multihead_kernels_run_twice_bit_identical(batch, dtype):
    """Fixed summation orders: each kernel gives the same bits twice, on
    every role of the GAT step."""
    need_card()
    p = batch.spmm.to("cuda")
    n, e = p.num_nodes, p.col.numel()
    for heads, c in ((4, 16), (4, 21), (4, 2), (3, 50)):
        x = torch.randn(n, heads * c, device="cuda").to(dtype)
        g = torch.randn(n, heads * c, device="cuda")
        alpha = torch.rand(e, heads, device="cuda")
        runs = [
            lambda: spmm_mh(x, alpha, p.row_ptr, p.col),
            lambda: spmm_mh(x, alpha, p.t_row_ptr, p.t_col, p.t_order),
            lambda: sddmm_mh(x, g, p.row, p.col, p.num_edges, heads)]
        for run in runs:
            assert torch.equal(run(), run())


def test_multihead_grads_match_cpu(batch):
    """SpmmMhFunction and gat_edge_logits on the card (kernels) against
    the CPU (plain versions): outputs and every gradient."""
    need_card()
    n, e = batch.num_nodes_padded, batch.num_edges_padded
    rng = np.random.default_rng(8)
    x0 = torch.tensor(rng.normal(size=(n, 84)).astype(np.float32))
    a0 = torch.tensor(rng.uniform(0.1, 1.0, (e, 4)).astype(np.float32))
    s0 = torch.tensor(rng.normal(size=(n, 4)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(n, 84)).astype(np.float32))
    ge = torch.tensor(rng.normal(size=(e, 4)).astype(np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        b = batch.to(dev)
        x, a, s, d = (t.to(dev, copy=True).requires_grad_()
                      for t in (x0, a0, s0, -s0))
        out = SpmmMhFunction.apply(x, a, b.spmm)
        out.backward(g.to(dev))
        logits = gat_edge_logits(s, d, b.spmm)
        logits.backward(ge.to(dev) * b.edge_mask[:, None])
        res[dev] = (out, x.grad, a.grad, logits, s.grad, d.grad)
    for got, ref in zip(res["cuda"], res["cpu"]):
        assert_close(got, ref)


def test_multihead_wrappers_refuse_what_the_kernels_do_not_take(batch):
    need_card()
    p = batch.spmm.to("cuda")
    n = p.num_nodes
    x = torch.randn(n, 8, device="cuda")
    a = torch.rand(p.col.numel(), 4, device="cuda")
    with pytest.raises(TypeError):
        spmm_mh(x.double(), a, p.row_ptr, p.col)
    with pytest.raises(TypeError):
        spmm_mh(x, a.to(torch.bfloat16), p.row_ptr, p.col)
    with pytest.raises(ValueError, match="multiple"):
        spmm_mh(torch.randn(n, 9, device="cuda"), a, p.row_ptr, p.col)
    with pytest.raises(ValueError, match="length"):
        spmm_mh(x, a[:-1].contiguous(), p.row_ptr, p.col)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_mh(torch.randn(8, n, device="cuda").t(), a, p.row_ptr, p.col)
    with pytest.raises(TypeError):
        spmm_mh(x, a, p.t_row_ptr, p.t_col, p.t_order.int())
    with pytest.raises(ValueError, match="multiple"):
        sddmm_mh(x, x, p.row, p.col, p.num_edges, 3)
    with pytest.raises(TypeError):
        sddmm_mh(x.half(), x, p.row, p.col, p.num_edges, 4)


def test_run_experiment_gat_on_the_card_launches_the_kernels():
    """The VOC GAT config, shrunk to 2 layers: a train step launches 4
    spmm_mh and 3 sddmm_mh a layer, an eval batch 1 and 2."""
    need_card()
    from pathlib import Path

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.runner import run_experiment
    cfg = load_config(Path(__file__).parents[1] / "configs" / "GAT"
                      / "voc_superpixels_GAT_sparse.yaml")
    cfg.data.num_graphs = 48
    cfg.mpnn.num_layers = 2
    cfg.training.epochs = 1
    s0, d0 = spmm_mh.launches, sddmm_mh.launches
    result = run_experiment(cfg)
    assert np.isfinite(result.history[0]["train_loss"])
    steps, evals = result.num_train_steps, result.num_eval_batches
    assert steps > 0 and evals > 0
    assert spmm_mh.launches - s0 == 2 * (4 * steps + evals)
    assert sddmm_mh.launches - d0 == 2 * (3 * steps + 2 * evals)


DIMS = (9, 16, 16, 10)        # peptides-func: F0 9, hidden 16, 10 classes


def fused_inputs(dtype, graphs=8, slot=392, seed=0):
    """A_hat of random symmetric graphs (~2 edges a node), x, weights and
    biases at the peptides widths, on the card."""
    gen = torch.Generator().manual_seed(seed)
    adj = (torch.rand(graphs, slot, slot, generator=gen) < 2.0 / slot)
    adj = (adj | adj.transpose(1, 2)).float()
    a_hat = folded_operator(adj).to(dtype).cuda()
    x = torch.randn(graphs, slot, DIMS[0], generator=gen).to(dtype).cuda()
    ws = [(0.4 * torch.randn(DIMS[i], DIMS[i + 1], generator=gen))
          .to(dtype).cuda() for i in range(len(DIMS) - 1)]
    bs = [(0.1 * torch.randn(DIMS[i + 1], generator=gen)).cuda()
          for i in range(len(DIMS) - 1)]
    return a_hat, x, ws, bs


def dropout_spec(kind, graphs, slot):
    if kind == "none":
        return 0.0, None
    if kind == "seed":
        return 0.2, {"seed": 1234567}
    gen = torch.Generator().manual_seed(9)
    return 0.2, {"bits": [
        torch.randint(-2 ** 31, 2 ** 31, (graphs, slot, f), generator=gen,
                      dtype=torch.int32).cuda() for f in DIMS[1:-1]]}


# Input seeds: 0, and 1223 and 1227, on which the plain version in cuBLAS's
# order rounds a bfloat16 value one ulp away from the kernel's, and misses
# 1e-4*max|ref| (its h W sums in another order at 8 graph blocks).
@pytest.mark.parametrize("inputs", [0, 1223, 1227])
@pytest.mark.parametrize("kind", ["none", "bits", "seed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gcn_fwd_matches_plain(dtype, kind, inputs):
    need_card()
    a_hat, x, ws, bs = fused_inputs(dtype, seed=inputs)
    rate, dropout = dropout_spec(kind, x.shape[0], x.shape[1])
    before = fused_gcn_fwd.launches
    outs = fused_gcn_fwd(a_hat, x, ws, bs, rate, dropout)
    torch.cuda.synchronize()
    assert fused_gcn_fwd.launches == before + 1
    refs = plain_reference(fused_gcn_fwd_plain, a_hat, x, ws, bs, rate,
                           dropout)
    for l, (got, ref) in enumerate(zip(outs, refs)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert_fused_close(got, ref, dtype, rounded=True)
        if kind == "seed" and l < len(outs) - 1:
            # Philox bits match the plain version's: every element they
            # drop is exactly 0 in the kernel's output.
            bits = dropout_bits_plain(1234567, *got.shape, l, "cuda")
            dropped = bits < dropout_threshold(rate)
            assert 0.15 < dropped.float().mean() < 0.25
            assert not got[dropped].any()


# Cotangent seeds: 2, and 48, 771 (no dropout) and 623, 728 (dropout 0.2),
# on which the plain version in cuBLAS's order rounds a bfloat16 dx element
# one ulp away from the kernel's, beyond 1e-4*max|ref| (its dy W^T sums in
# another order at 8 graph blocks).
@pytest.mark.parametrize("cotangent", [2, 48, 771, 623, 728])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gcn_bwd_matches_plain(dtype, rate, cotangent):
    need_card()
    a_hat, x, ws, bs = fused_inputs(dtype, seed=1)
    dropout = {"seed": 77} if rate else None
    acts = fused_gcn_fwd_plain(a_hat, x, ws, bs, rate, dropout)[:-1]
    g = torch.randn(*x.shape[:2], DIMS[-1], device="cuda",
                    generator=torch.Generator(device="cuda")
                    .manual_seed(cotangent))
    before = fused_gcn_bwd.launches
    dx, dws, dbs = fused_gcn_bwd(a_hat, x, ws, acts, g, rate)
    torch.cuda.synchronize()
    assert fused_gcn_bwd.launches == before + 1
    rdx, rdws, rdbs = plain_reference(fused_gcn_bwd_plain, a_hat, x, ws,
                                      acts, g, rate)
    assert dx.dtype == dtype
    assert_fused_close(dx, rdx, dtype, rounded=True)
    for got, ref in zip(dws + dbs, rdws + rdbs):
        assert got.dtype == torch.float32
        assert_fused_close(got, ref, dtype)
    # Deterministic: partials a graph block, summed in a fixed order.
    again = fused_gcn_bwd(a_hat, x, ws, acts, g, rate)
    for a, b in zip([dx] + dws + dbs, [again[0]] + again[1] + again[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_fused_bf16_matches_plain_in_order_over_many_inputs(direction):
    """Many bfloat16 inputs at 8 graph blocks, where cuBLAS's order differs
    from the kernels' on some of them: every output within 1e-4*max|ref| of
    the plain version summed in order, the rounded ones bit for bit.
    Forward: 60 input seeds without dropout; backward: 200 cotangents at
    the inputs of test_fused_gcn_bwd_matches_plain, without and with
    dropout."""
    need_card()
    bf16 = torch.bfloat16
    if direction == "fwd":
        for seed in range(1200, 1260):
            a_hat, x, ws, bs = fused_inputs(bf16, seed=seed)
            outs = fused_gcn_fwd(a_hat, x, ws, bs)
            refs = plain_reference(fused_gcn_fwd_plain, a_hat, x, ws, bs)
            for got, ref in zip(outs, refs):
                assert_fused_close(got, ref, bf16, rounded=True)
        return
    a_hat, x, ws, bs = fused_inputs(bf16, seed=1)
    for rate in (0.0, 0.2):
        dropout = {"seed": 77} if rate else None
        acts = fused_gcn_fwd_plain(a_hat, x, ws, bs, rate, dropout)[:-1]
        for seed in range(100):
            g = torch.randn(*x.shape[:2], DIMS[-1], device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed))
            dx, dws, dbs = fused_gcn_bwd(a_hat, x, ws, acts, g, rate)
            rdx, rdws, rdbs = plain_reference(fused_gcn_bwd_plain, a_hat, x,
                                              ws, acts, g, rate)
            assert_fused_close(dx, rdx, bf16, rounded=True)
            for got, ref in zip(dws + dbs, rdws + rdbs):
                assert_fused_close(got, ref, bf16)


WIDE_DIMS = (9, 128, 128, 128, 128, 10)   # peptides_func_GCN_dp8.yaml


def plan_inputs(dims, dtype, graphs, slot, seed):
    """A_hat of random symmetric graphs (~2 edges a node), x, weights and
    biases at ``dims``, on the card."""
    gen = torch.Generator().manual_seed(seed)
    adj = (torch.rand(graphs, slot, slot, generator=gen) < 2.0 / slot)
    adj = (adj | adj.transpose(1, 2)).float()
    a_hat = folded_operator(adj).to(dtype).cuda()
    x = torch.randn(graphs, slot, dims[0], generator=gen).to(dtype).cuda()
    scale = [0.4, 0.15][dims[1] > 16]
    ws = [(scale * torch.randn(dims[i], dims[i + 1], generator=gen))
          .to(dtype).cuda() for i in range(len(dims) - 1)]
    bs = [(0.1 * torch.randn(dims[i + 1], generator=gen)).cuda()
          for i in range(len(dims) - 1)]
    return a_hat, x, ws, bs


def check_fused_against_plain(slot, graphs, dims, dtype, kind):
    """Both kernels against their plain versions: forward, then the
    backward over the plain forward's activations, run twice and equal bit
    for bit; one launch counted a call."""
    a_hat, x, ws, bs = plan_inputs(dims, dtype, graphs, slot, seed=slot)
    if kind == "none":
        rate, dropout = 0.0, None
    elif kind == "seed":
        rate, dropout = 0.2, {"seed": 4242}
    else:
        gen = torch.Generator().manual_seed(3)
        rate, dropout = 0.2, {"bits": [
            torch.randint(-2 ** 31, 2 ** 31, (graphs, slot, f),
                          generator=gen, dtype=torch.int32).cuda()
            for f in dims[1:-1]]}
    f0, b0 = fused_gcn_fwd.launches, fused_gcn_bwd.launches
    outs = fused_gcn_fwd(a_hat, x, ws, bs, rate, dropout)
    torch.cuda.synchronize()
    assert fused_gcn_fwd.launches == f0 + 1
    refs = plain_reference(fused_gcn_fwd_plain, a_hat, x, ws, bs, rate,
                           dropout)
    for got, ref in zip(outs, refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert_fused_close(got, ref, dtype, rounded=True)
    acts = refs[:-1]
    g = torch.randn(graphs, slot, dims[-1], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    first = fused_gcn_bwd(a_hat, x, ws, acts, g, rate)
    again = fused_gcn_bwd(a_hat, x, ws, acts, g, rate)
    torch.cuda.synchronize()
    assert fused_gcn_bwd.launches == b0 + 2
    rdx, rdws, rdbs = plain_reference(fused_gcn_bwd_plain, a_hat, x, ws,
                                      acts, g, rate)
    got = [first[0]] + first[1] + first[2]
    for i, (a, b, ref) in enumerate(zip(got, [again[0]] + again[1] + again[2],
                                        [rdx] + rdws + rdbs)):
        assert torch.equal(a, b)
        assert_fused_close(a, ref, dtype, rounded=i == 0)


@pytest.mark.parametrize("kind", ["none", "bits", "seed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [DIMS, WIDE_DIMS], ids=["h16", "h128"])
@pytest.mark.parametrize("graphs", [1, 3, 32])
@pytest.mark.parametrize("slot", [8, 392, 512])
def test_fused_kernels_match_plain_across_plans(slot, graphs, dims, dtype,
                                                kind):
    """The slots and widths whose launch plans differ (clusters of 4 and 8,
    one or two feature passes, whole and split staging, blocks with no
    rows), A_hat resident and x's rows in shared memory."""
    need_card()
    check_fused_against_plain(slot, graphs, dims, dtype, kind)


@pytest.mark.parametrize("kind", ["none", "seed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slot,graphs,dims", [
    (1024, 3, DIMS), (2048, 1, DIMS), (1024, 2, WIDE_DIMS),
    (392, 3, (64, 16, 10)), (1024, 2, (64, 16, 10))],
    ids=["s1024-h16", "s2048-h16", "s1024-h128", "s392-x64", "s1024-x64"])
def test_fused_kernels_stream_a_hat_and_read_x_from_global(slot, graphs,
                                                           dims, dtype, kind):
    """The plans' other branches: S >= 1024, where A_hat's slice does not
    fit even at clusters of 8 and is streamed in tiles (the last one
    short), and an input width above the hidden widths, whose x the
    forward reads from global memory instead of its h rows."""
    need_card()
    plan = fused_plan(graphs, slot, dims, dtype)
    assert plan.resident == (slot < 1024)
    check_fused_against_plain(slot, graphs, dims, dtype, kind)


def test_fused_gcn_stack_grads_match_cpu():
    """The autograd Function on the card (kernels) against the CPU (plain
    versions), forward and every gradient, with external dropout bits."""
    need_card()
    rng = np.random.default_rng(4)
    G, S = 4, 64
    x0 = torch.tensor(rng.normal(size=(G, S, DIMS[0])).astype(np.float32))
    adj = torch.tensor((rng.random((G, S, S)) < 0.05).astype(np.float32))
    params0 = [(torch.tensor(0.3 * rng.normal(size=(DIMS[i], DIMS[i + 1])),
                             dtype=torch.float32),
                torch.tensor(0.1 * rng.normal(size=DIMS[i + 1]),
                             dtype=torch.float32))
               for i in range(3)]
    bits = [torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (G, S, f)),
                         dtype=torch.int32) for f in DIMS[1:-1]]
    g = torch.tensor(rng.normal(size=(G, S, DIMS[-1])).astype(np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        x = x0.to(dev, copy=True).requires_grad_()
        params = [{"kernel": k.to(dev, copy=True).requires_grad_(),
                   "bias": b.to(dev, copy=True).requires_grad_()}
                  for k, b in params0]
        out = fused_gcn_stack(x, adj.to(dev), params,
                              {"bits": [b.to(dev) for b in bits]}, 0.3)
        out.backward(g.to(dev))
        res[dev] = [out, x.grad] + [t.grad for p in params
                                    for t in p.values()]
    for got, ref in zip(res["cuda"], res["cpu"]):
        assert_close(got, ref)


def test_fused_wrappers_refuse_what_the_kernels_do_not_take():
    need_card()
    a_hat, x, ws, bs = fused_inputs(torch.float32, graphs=2, slot=16)
    with pytest.raises(TypeError):
        fused_gcn_fwd(a_hat, x.to(torch.bfloat16), ws, bs)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_gcn_fwd(a_hat[:, :14, :14].contiguous(),
                      x[:, :14].contiguous(), ws, bs)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gcn_fwd(a_hat.transpose(1, 2), x, ws, bs)
    with pytest.raises(ValueError, match="bit arrays"):
        fused_gcn_fwd(a_hat, x, ws, bs, 0.2, {"bits": []})
    with pytest.raises(TypeError, match="int32"):
        fused_gcn_fwd(a_hat, x, ws, bs, 0.2, {"bits": [
            torch.zeros(2, 16, 16, device="cuda")] * 2})


@pytest.mark.parametrize("config,fused", [
    ("peptides_func_GCN_fused.yaml", True),
    ("peptides_func_GCN.yaml", False)])
def test_run_experiment_peptides_on_the_card(config, fused):
    """Both peptides configs train on the device-resident dataset; the
    fused one launches fused_gcn_fwd once a train step and an eval batch,
    fused_gcn_bwd once a train step; the unfused one neither."""
    need_card()
    from pathlib import Path

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.runner import run_experiment
    cfg = load_config(Path(__file__).parents[1] / "configs" / "GCN" / config)
    cfg.data.num_graphs = 96
    cfg.training.epochs = 1
    f0, b0 = fused_gcn_fwd.launches, fused_gcn_bwd.launches
    result = run_experiment(cfg)
    assert np.isfinite(result.history[0]["train_loss"])
    steps, evals = result.num_train_steps, result.num_eval_batches
    assert steps > 0 and evals > 0
    assert fused_gcn_fwd.launches - f0 == (steps + evals if fused else 0)
    assert fused_gcn_bwd.launches - b0 == (steps if fused else 0)


@pytest.mark.parametrize("f", [64, 21, 128, 130, 1])
@pytest.mark.parametrize("side", ["receiver", "sender"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_reduce_matches_plain(batch, f, side, dtype):
    """The receiver side (row_ptr over the edges in their order) and the
    sender side (t_row_ptr, rows taken in t_order) at GatedGCN's width (64)
    and others (odd, past one 128-feature pass, 1); padding edge rows hold
    NaN, which the kernel never reads; padding nodes are empty rows (0)."""
    need_card()
    p = batch.spmm.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(f)
    msgs = torch.randn(p.col.numel(), f, device="cuda", generator=gen)
    msgs[p.num_edges:] = float("nan")
    msgs = msgs.to(dtype)
    rp, order = ((p.row_ptr, None) if side == "receiver"
                 else (p.t_row_ptr, p.t_order))
    before = segment_reduce.launches
    out = segment_reduce(msgs, rp, order)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (p.num_nodes, f)
    assert out.isfinite().all()
    assert_close(out, segment_reduce_plain(msgs, rp, order),
                 1e-5 if dtype == torch.float32 else 1e-4)
    assert not out[~torch.as_tensor(batch.node_mask, device="cuda")].any()


def test_segment_reduce_empty_rows_and_offsets():
    """A CSR with many empty rows (every third row, and a run of 50 at the
    end) on a view of the messages that starts past an aligned address
    (scalar loads): the kernel writes 0 there and agrees elsewhere."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    counts = torch.randint(0, 6, (1000,), device="cuda", generator=gen)
    counts[::3] = 0
    counts[-50:] = 0
    rp = torch.zeros(1001, dtype=torch.int32, device="cuda")
    rp[1:] = counts.cumsum(0).to(torch.int32)
    e = int(rp[-1])
    base = torch.randn(e + 1, 64, device="cuda", generator=gen)
    for msgs in (base[:e], base.view(-1)[1:e * 64 + 1].view(e, 64)):
        out = segment_reduce(msgs, rp)
        torch.cuda.synchronize()
        assert_close(out, segment_reduce_plain(msgs, rp))
        assert not out[counts == 0].any()


def test_planned_segment_ops_grads_match_cpu(batch):
    """segment_sum_planned and gather_planned (both sides) on the card
    (kernel) against the CPU (plain version): outputs and gradients."""
    need_card()
    n, e = batch.num_nodes_padded, batch.num_edges_padded
    rng = np.random.default_rng(6)
    x0 = torch.tensor(rng.normal(size=(n, 64)).astype(np.float32))
    m0 = torch.tensor((rng.normal(size=(e, 64))
                       * batch.edge_mask[:, None]).astype(np.float32))
    g = torch.tensor(rng.normal(size=(n, 64)).astype(np.float32))
    ge = torch.tensor((rng.normal(size=(e, 64))
                       * batch.edge_mask[:, None]).astype(np.float32))
    prev = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        res = {}
        for dev in ("cpu", "cuda"):
            b = batch.to(dev)
            m = m0.to(dev, copy=True).requires_grad_()
            x = x0.to(dev, copy=True).requires_grad_()
            out = segment.segment_sum_planned(m, b.receivers, n, plan=b.spmm)
            out.backward(g.to(dev))
            gr = segment.gather_planned(x, b.receivers, plan=b.spmm)
            gs = segment.gather_planned(x, b.senders, plan=b.spmm,
                                        side="sender")
            (gr * ge.to(dev)).sum().add((gs * ge.to(dev)).sum()).backward()
            res[dev] = (out, m.grad, gr, gs, x.grad)
    finally:
        spmm.set_backend(prev)
    for got, ref in zip(res["cuda"], res["cpu"]):
        assert_close(got, ref)


def test_segment_reduce_refuses_what_the_kernel_does_not_take(batch):
    need_card()
    p = batch.spmm.to("cuda")
    m = torch.randn(p.col.numel(), 8, device="cuda")
    with pytest.raises(TypeError):
        segment_reduce(m.double(), p.row_ptr)
    with pytest.raises(TypeError):
        segment_reduce(m, p.row_ptr.long())
    with pytest.raises(TypeError, match="order"):
        segment_reduce(m, p.t_row_ptr, p.t_order.int())
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce(torch.randn(8, p.col.numel(), device="cuda").t(),
                       p.row_ptr)


def test_run_experiment_gatedgcn_on_the_card_launches_the_kernel():
    """The VOC GatedGCN config, shrunk to 2 layers: a train step launches
    5 segment_reduce a layer, an eval batch 2."""
    need_card()
    from pathlib import Path

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.runner import run_experiment
    cfg = load_config(Path(__file__).parents[1] / "configs" / "GatedGCN"
                      / "voc_superpixels_GatedGCN_sparse.yaml")
    cfg.data.num_graphs = 48
    cfg.mpnn.num_layers = 2
    cfg.training.epochs = 1
    before = segment_reduce.launches
    result = run_experiment(cfg)
    assert np.isfinite(result.history[0]["train_loss"])
    steps, evals = result.num_train_steps, result.num_eval_batches
    assert steps > 0 and evals > 0
    assert segment_reduce.launches - before == 2 * (5 * steps + 2 * evals)


@pytest.fixture(scope="module")
def lattice():
    """The 142 x 142 lattice (N = 20,164, 80,088 edges), the size at which
    the TPU routes the SpMM to its HBM-streamed kernel (B4a)."""
    n, snd, rcv, mask = lattice_edges(142)
    return csr_plan(snd, rcv, mask, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_and_edge_sddmm_at_the_hbm_size(lattice, dtype):
    """csr_spmm forward and transpose and edge_sddmm at F = 128 on the
    142 x 142 lattice, against their plain versions."""
    need_card()
    p = lattice.to("cuda")
    n = p.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(n, 128, device="cuda", generator=gen).to(dtype)
    g = torch.randn(n, 128, device="cuda", generator=gen)
    w = torch.rand(p.col.numel(), device="cuda", generator=gen)
    for rp, col, ww in ((p.row_ptr, p.col, w),
                        (p.t_row_ptr, p.t_col, w[p.t_order].contiguous())):
        out = csr_spmm(x, rp, col, ww)
        torch.cuda.synchronize()
        assert_close(out, csr_spmm_plain(x, rp, col, ww))
    dots = edge_sddmm(x, g, p.row, p.col, p.num_edges)
    torch.cuda.synchronize()
    assert_close(dots, edge_sddmm_plain(x, g, p.row, p.col, p.num_edges))
    assert not dots[p.num_edges:].any()


def test_sparse_hscn_on_the_card_matches_the_cpu():
    """The VOC sparse HSCN config's model at full width (hidden 32, 3
    layers, K = 8) on a 4-graph batch with its CSR plan, virtual_feedback
    on and nonzero VLDense weights: logits and every parameter gradient on
    the card (csr_spmm, 3 launches forward and 3 backward) within
    1e-4*max|ref| of the CPU's (the kernel's plain version)."""
    need_card()
    import copy
    from pathlib import Path

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.hscn import build_hscn
    from graph_hscn_tpu_torch.train.loss import criterion
    cfg = load_config(Path(__file__).parents[1] / "configs" / "HSCN"
                      / "voc_superpixels_HSCN_sparse.yaml")
    cfg.data.num_graphs = 16
    cfg.hscn.virtual_feedback = True
    dm = DataModule.from_config(cfg.data)
    rng = np.random.default_rng(3)
    graphs = [g.replace(cluster=rng.integers(0, cfg.hscn.num_clusters,
                                             g.num_nodes).astype(np.int32))
              for g in dm.split("train")[:4]]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4),
                       with_spmm_plan=True)
    gen = torch.Generator().manual_seed(4)
    model = build_hscn(cfg.hscn, dm.num_features, dm.num_classes,
                       readout="none", generator=gen)
    with torch.no_grad():
        for vl in model.vl:
            vl.weight.normal_(0.0, 0.3, generator=gen)
    outs = {}
    prev = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(model).to(dev)
            b = batch.to(dev)
            before = csr_spmm.launches
            logits = m(b)
            loss, _ = criterion(cfg.training.loss_fn, logits, b.node_y,
                                b.node_mask)
            loss.backward()
            outs[dev] = [logits.detach()] + [
                p.grad if p.grad is not None else torch.zeros_like(p)
                for p in m.parameters()]
            launched = csr_spmm.launches - before
    finally:
        spmm.set_backend(prev)
    assert launched == 2 * cfg.hscn.num_layers
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        assert bool(got.isfinite().all())
        assert_close(got, ref, 1e-4)


def test_sparse_gin_on_the_card_matches_the_cpu():
    """The peptides GIN config's model at full width (hidden 16, 3 layers)
    on a 4-graph batch with its CSR plan (runtime.dense_path sparse): the
    0/1 edge mask as csr_spmm's weights, 3 launches forward and 2
    transposes backward (layer 0's input takes no gradient); logits and
    every parameter gradient on the card within 1e-4*max|ref| of the
    CPU's (the kernel's plain version), in eval mode (no dropout) and
    under the config's ``matmul_precision: highest`` (GIN's unnormalised
    sums give logits of ~100, which TF32's rounding of the Dense inputs
    moves by ~4e-4 of their largest)."""
    need_card()
    import copy
    from pathlib import Path

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.loss import criterion
    cfg = load_config(Path(__file__).parents[1] / "configs" / "GIN"
                      / "peptides_func_GIN.yaml")
    cfg.data.num_graphs = 16
    dm = DataModule.from_config(cfg.data)
    graphs = dm.split("train")[:4]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4),
                       with_spmm_plan=True)
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       generator=torch.Generator().manual_seed(4))
    model.eval()
    outs = {}
    prev = spmm.get_backend(), torch.get_float32_matmul_precision()
    spmm.set_backend("pallas")
    set_matmul_precision(cfg.runtime.matmul_precision)
    try:
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(model).to(dev)
            b = batch.to(dev)
            before = csr_spmm.launches
            logits = m(b)
            loss, _ = criterion(cfg.training.loss_fn, logits, b.y,
                                b.graph_mask)
            loss.backward()
            outs[dev] = [logits.detach()] + [p.grad for p in m.parameters()]
            launched = csr_spmm.launches - before
    finally:
        spmm.set_backend(prev[0])
        set_matmul_precision("highest" if prev[1] == "highest"
                             else "default")
    assert launched == 2 * cfg.mpnn.num_layers - 1
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        assert bool(got.isfinite().all())
        assert_close(got, ref, 1e-4)


# --- the captured epoch (train/device_data.py:make_epoch_fn) ---------------

def epoch_setup(fused: bool, num_graphs: int = 44, dropout: float = 0.2):
    """A small peptides device dataset on the card (44 graphs: 6 train rows
    of 4, the last with dummy slots) and a model of 3 layers, hidden 16,
    with dropout, its weights from seed 0."""
    from graph_hscn_tpu_torch.data.synthetic import make_peptides_func
    from graph_hscn_tpu_torch.models.fused_gcn import FusedDenseGCN
    from graph_hscn_tpu_torch.models.mpnn import MPNN
    from graph_hscn_tpu_torch.train.device_data import DeviceDataset
    graphs = make_peptides_func(num_graphs=num_graphs, seed=12,
                                mean_nodes=30)
    ds = DeviceDataset.build(graphs, device="cuda")
    gen = torch.Generator().manual_seed(0)
    if fused:
        model = FusedDenseGCN(9, 16, 10, 3, dropout=dropout, generator=gen)
    else:
        model = MPNN(conv_type="gcn", activation="relu", num_features=9,
                     hidden_channels=16, num_classes=10, num_layers=3,
                     dropout=dropout, generator=gen)
    split_ids = {"train": np.arange(22), "val": np.arange(22, 33),
                 "test": np.arange(33, num_graphs)}
    return ds, model, split_ids


def fit_captured(model, ds, split_ids, capture, epochs=2):
    from graph_hscn_tpu_torch.config.config import OptimConfig, TrainingConfig
    from graph_hscn_tpu_torch.train.loop import fit_on_device_dataset
    from graph_hscn_tpu_torch.utils.logger import Logger
    training = TrainingConfig(model_type="gcn", loss_fn="cross_entropy",
                              metric="ap", epochs=epochs, eval_period=1,
                              patience=50, min_delta=0.0, seed=3)
    return fit_on_device_dataset(
        model, ds, split_ids, 4, OptimConfig(optim_type="adamW", lr=0.01,
                                             weight_decay=5e-4),
        training, Logger(metric_name="ap"), "cuda", capture=capture)


@pytest.mark.parametrize("fused", [False, True])
def test_captured_fit_follows_the_eager_fit(fused):
    """fit_on_device_dataset captured (train and eval steps as CUDA graphs,
    each row a replay) against the same fit run eagerly row by row (the
    same capturable AdamW), from the same weights, dropout 0.2 from the
    same generator seed: every
    epoch's train, val and test loss within 1e-4 relative, and the weights
    after at 1e-4*max|ref|.  The replays draw the eager steps' dropout bits
    (a different draw moves the losses by far more).  The fused stack's
    launches: one fused_gcn_fwd a train step and an eval batch, one
    fused_gcn_bwd a train step, replays included."""
    need_card()
    import copy
    ds, model, split_ids = epoch_setup(fused)
    results = {}
    for capture in (True, False):
        m = copy.deepcopy(model).cuda()
        f0, b0 = fused_gcn_fwd.launches, fused_gcn_bwd.launches
        res = fit_captured(m, ds, split_ids, capture)
        steps, evals = res.num_train_steps, res.num_eval_batches
        assert (steps, evals) == (12, 2 * (3 + 3))
        assert fused_gcn_fwd.launches - f0 == (steps + evals if fused else 0)
        assert fused_gcn_bwd.launches - b0 == (steps if fused else 0)
        assert res.replays == ({"train": steps - 1, "eval": evals - 1}
                               if capture else {"train": 0, "eval": 0})
        results[capture] = res
    for got, ref in zip(results[True].history, results[False].history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4)
    want = results[False].model.state_dict()
    for name, p in results[True].model.state_dict().items():
        assert_close(p, want[name], 1e-4)


def test_capture_and_replays_do_not_sync_with_the_host():
    """The fused stack's train and eval epochs (the eager first rows, the
    captures and the replays) under torch.cuda.set_sync_debug_mode("error"):
    no step syncs with the host.  Only the permutation's upload and the
    readback sit outside."""
    need_card()
    from graph_hscn_tpu_torch.train.device_data import (epoch_permutation,
                                                        make_epoch_fn)
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer
    ds, model, _ = epoch_setup(True)
    model = model.cuda()
    opt = build_optimizer(model.parameters(), "adamW", 0.01, 5e-4,
                          capturable=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    train_epoch, eval_epoch = make_epoch_fn(
        model, opt, ds, 4, 11, "cross_entropy", generator=gen)
    for epoch_fn, perm in ((train_epoch, epoch_permutation(44, 4, 0)),
                           (eval_epoch, epoch_permutation(44, 4, 0, False))):
        for _ in range(2):
            nb = epoch_fn.load(perm)
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(nb):
                    epoch_fn.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            losses = epoch_fn.outs[0][:nb].cpu()
            assert bool(losses.isfinite().all())
        assert epoch_fn.replays == 2 * nb - 1


def test_capturable_adamw_follows_the_plain_one():
    """AdamW built capturable (its step count on the card) against the plain
    one over 5 steps on the same gradients: the weights within 1e-6."""
    need_card()
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer
    rng = np.random.default_rng(5)
    w0 = [torch.tensor(rng.normal(size=s).astype(np.float32))
          for s in ((16, 9), (16,), (10, 16))]
    grads = [[torch.tensor(rng.normal(size=w.shape).astype(np.float32))
              for w in w0] for _ in range(5)]
    final = {}
    for flag in (True, False):
        params = [torch.nn.Parameter(w.cuda()) for w in w0]
        opt = build_optimizer(params, "adamW", 0.01, 5e-4, capturable=flag)
        for gs in grads:
            opt.zero_grad()
            for p, g in zip(params, gs):
                p.grad = g.cuda()
            opt.step()
        final[flag] = params
    for got, ref in zip(final[True], final[False]):
        torch.testing.assert_close(got.detach().cpu(), ref.detach().cpu(),
                                   rtol=1e-6, atol=1e-6)


def test_captured_clustering_follows_the_eager_one():
    """train_clustering_device (SCN mp_units [16, 16], K=4) on 24 peptides
    graphs in batches of 8, 2 epochs, captured and eager from the same
    weights: the epochs' losses within 1e-5 relative and the same
    assignments on every node whose top two values differ by more than
    1e-5; no kernel launches (the batches carry no plan)."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.config.config import HSCNConfig, OptimConfig
    from graph_hscn_tpu_torch.data.synthetic import make_peptides_func
    from graph_hscn_tpu_torch.models.scn import build_scn
    from graph_hscn_tpu_torch.train.capture import counted_kernels
    from graph_hscn_tpu_torch.train.clustering import train_clustering_device
    from graph_hscn_tpu_torch.train.device_data import (DeviceDataset,
                                                        assemble)

    class Quiet:
        def info(self, msg):
            pass

    graphs = make_peptides_func(num_graphs=24, seed=13, mean_nodes=30)
    ds = DeviceDataset.build(graphs, device="cuda", with_cluster=True)
    hcfg = HSCNConfig(mp_units=[16, 16], num_clusters=4, cluster_epochs=2)
    scn = build_scn(hcfg, 9, ds.slot,
                    generator=torch.Generator().manual_seed(2))
    out = {}
    before = [k.launches for k in counted_kernels()]
    for capture in (True, False):
        m = copy.deepcopy(scn).cuda()
        out[capture] = (m,) + train_clustering_device(
            Quiet(), ds, 8, m, hcfg, OptimConfig(optim_type="adamW",
                                                 lr=0.01,
                                                 weight_decay=5e-4),
            seed=3, capture=capture)
    assert [k.launches for k in counted_kernels()] == before
    np.testing.assert_allclose(out[True][2], out[False][2], rtol=1e-5)
    m, ds_eager, _ = out[False]
    with torch.no_grad():
        s = m(assemble(ds_eager, torch.arange(24, dtype=torch.int32,
                                              device="cuda")))[0]
    top = s.topk(2, dim=-1).values
    clear = ((top[:, 0] - top[:, 1]) > 1e-5).reshape(24, -1).cpu()
    got, ref = out[True][1].cluster.cpu(), ds_eager.cluster.cpu()
    assert torch.equal(got[clear], ref[clear])


def gps_setup(local: str):
    """A small peptides device dataset on the card (44 graphs; peptides-
    struct with its 3 edge features for the GatedGCN local module) and a
    GPSModel of 2 layers, hidden 16, 2 heads, dropout 0.2, weights from
    seed 0."""
    from graph_hscn_tpu_torch.data.synthetic import (make_peptides_func,
                                                     make_peptides_struct)
    from graph_hscn_tpu_torch.models.gps import GPSModel
    from graph_hscn_tpu_torch.train.device_data import DeviceDataset
    make = make_peptides_struct if local == "gatedgcn" else \
        make_peptides_func
    graphs = make(num_graphs=44, seed=14, mean_nodes=30)
    ds = DeviceDataset.build(graphs, device="cuda")
    nef = 3 if local == "gatedgcn" else None
    model = GPSModel(9, 16, 11 if nef else 10, 2, 2, dropout=0.2,
                     local_conv=local, num_edge_features=nef,
                     generator=torch.Generator().manual_seed(0))
    split_ids = {"train": np.arange(22), "val": np.arange(22, 33),
                 "test": np.arange(33, 44)}
    return ds, model, split_ids


def fit_both(model, ds, split_ids, loss_fn, optim):
    """fit_on_device_dataset captured and eager (capture=False, the same
    capturable optimizer) from copies of ``model``, 2 epochs of B=4:
    {capture: FitResult}."""
    import copy

    from graph_hscn_tpu_torch.config.config import OptimConfig, TrainingConfig
    from graph_hscn_tpu_torch.train.loop import fit_on_device_dataset
    from graph_hscn_tpu_torch.utils.logger import Logger
    metric = "mae" if loss_fn == "l1" else "ap"
    training = TrainingConfig(model_type="gps", loss_fn=loss_fn,
                              metric=metric, epochs=2, eval_period=1,
                              patience=50, min_delta=0.0, seed=3)
    return {capture: fit_on_device_dataset(
        copy.deepcopy(model).cuda(), ds, split_ids, 4, OptimConfig(**optim),
        training, Logger(metric_name=metric), "cuda", capture=capture)
        for capture in (True, False)}


def assert_fits_agree(results, lr_sum):
    """Captured against eager: every epoch's losses within 1e-4 relative,
    the weights at 1e-4*max|ref|; an attention key bias (zero gradient in
    exact arithmetic, moved by rounding noise alone) within the sum of the
    lrs applied."""
    for got, ref in zip(results[True].history, results[False].history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4)
    want = results[False].model.state_dict()
    for name, p in results[True].model.state_dict().items():
        if name.endswith("attn.key.bias"):
            assert float(p.abs().max()) <= lr_sum
        else:
            assert_close(p, want[name], 1e-4)


@pytest.mark.parametrize("local", ["gcn", "gatedgcn"])
def test_captured_gps_fit_follows_the_eager_fit(local):
    """A GPS fit on the device route, captured against eager, dropout 0.2
    from the same generator seed, AdamW under the cosine schedule with 3
    warmup steps (the lr a tensor the captured step writes): 12 train steps,
    one captured train graph (11 replays)."""
    need_card()
    ds, model, split_ids = gps_setup(local)
    results = fit_both(model, ds, split_ids,
                       "l1" if local == "gatedgcn" else "cross_entropy",
                       dict(optim_type="adamW", lr=0.003, weight_decay=5e-4,
                            schedule="cosine", warmup_steps=3))
    for res in results.values():
        assert res.num_train_steps == 12
    assert results[True].replays["train"] == 11
    assert results[False].replays == {"train": 0, "eval": 0}
    assert_fits_agree(results, 12 * 0.003)


def test_captured_accumulation_follows_the_eager_fit():
    """batch_accumulation 2 on the device route (the dense MPNN, dropout
    0.2, AdamW, cosine with 2 warmup updates over ceil(12 / 2) = 6):
    captured, two train graphs (accumulate; accumulate and apply), the host
    picking one a row, against eager; 12 train steps, 10 of them replays."""
    need_card()
    ds, model, split_ids = epoch_setup(False)
    results = fit_both(model, ds, split_ids, "cross_entropy",
                       dict(optim_type="adamW", lr=0.01, weight_decay=5e-4,
                            batch_accumulation=2, schedule="cosine",
                            warmup_steps=2))
    assert results[True].replays["train"] == 12 - 2
    assert_fits_agree(results, 6 * 0.01)


def test_captured_lr_follows_the_schedule():
    """The lr the captured optimizer uses, read back after each replayed
    row: the schedule at the count of updates already applied, within
    1e-7, at every one of 112 steps (steps 0, 1, 99, 100 and the last
    among them), with the shipped peptides-struct GPS schedule (AdamW,
    cosine, 100 warmup steps) over a horizon of 112."""
    need_card()
    from graph_hscn_tpu_torch.train.device_data import (epoch_permutation,
                                                        make_epoch_fn)
    from graph_hscn_tpu_torch.train.optimizers import (build_optimizer,
                                                       learning_rate_schedule)
    ds, model, _ = epoch_setup(False, dropout=0.0)
    model = model.cuda()
    total = 112
    opt = build_optimizer(model.parameters(), "adamW", 0.001, 5e-4,
                          schedule="cosine", warmup_steps=100,
                          total_steps=total, capturable=True)
    sched = learning_rate_schedule(0.001, "cosine", 100, total)
    train_epoch, _ = make_epoch_fn(model, opt, ds, 4, 11, "cross_entropy")
    perm = epoch_permutation(44, 4, 0)
    used = []
    while len(used) < total:
        nb = train_epoch.load(perm)
        for _ in range(min(nb, total - len(used))):
            train_epoch.step()
            used.append(float(opt.opt.param_groups[0]["lr"]))
    assert train_epoch.replays == total - 1
    want = sched(torch.arange(total, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(used, want, rtol=0, atol=1e-7)
    assert used[0] == 0.0 and abs(used[100] - 0.001) <= 1e-7


def test_a_host_sync_in_the_step_makes_the_captured_fit_raise():
    """A model whose forward syncs with the host (``.item()``) trains
    eagerly but cannot be captured: the captured fit raises at its capture
    and does not go back to the eager loop.  (Last in the file: a failed
    capture is left to the process to clean up.)"""
    need_card()
    ds, model, split_ids = epoch_setup(False)

    class Syncing(type(model)):
        def forward(self, batch, generator=None):
            out = super().forward(batch, generator=generator)
            return out * (1.0 + 0.0 * float(out.sum().item()))

    model.__class__ = Syncing
    model = model.cuda()
    with pytest.raises(RuntimeError):
        fit_captured(model, ds, split_ids, capture=True, epochs=1)
    torch.cuda.synchronize()


# --- checkpoints and positional encodings ----------------------------------

class _Interrupted(Exception):
    pass


def fit_checkpointed(model, ds, split_ids, ck, optim, epochs=4):
    """fit_on_device_dataset captured, as fit_captured, with a
    checkpointer saving the latest snapshot after every epoch."""
    from graph_hscn_tpu_torch.config.config import OptimConfig, TrainingConfig
    from graph_hscn_tpu_torch.train.loop import fit_on_device_dataset
    from graph_hscn_tpu_torch.utils.logger import Logger
    training = TrainingConfig(model_type="gcn", loss_fn="cross_entropy",
                              metric="ap", epochs=epochs, eval_period=1,
                              patience=50, min_delta=0.0, seed=3,
                              checkpoint_every=1)
    return fit_on_device_dataset(
        model, ds, split_ids, 4, OptimConfig(**optim), training,
        Logger(metric_name="ap"), "cuda", checkpointer=ck)


@pytest.mark.parametrize("fused,optim", [
    (False, dict(optim_type="adamW", lr=0.01, weight_decay=5e-4,
                 batch_accumulation=2, schedule="cosine", warmup_steps=2)),
    (True, dict(optim_type="adamW", lr=0.01, weight_decay=5e-4)),
])
def test_captured_fit_resumed_mid_run_follows_the_uninterrupted_one(
        fused, optim, tmp_path):
    """A captured 4-epoch fit, dropout 0.2, killed after epoch 1's latest
    snapshot and resumed by a fresh model, optimizer and Checkpointer: the
    restore lands before the resumed fit captures its steps, so its replays
    step the restored optimizer state (capturable AdamW's device step, the
    tensor lr, the accumulator) and draw the restored dropout bits.  Epochs
    2-3's train and val losses within 1e-6 relative of the uninterrupted
    captured fit's, and the final weights at 1e-6*max|ref|."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.train.checkpoint import Checkpointer

    class Stopping(Checkpointer):
        def save_latest(self, state, epoch):
            super().save_latest(state, epoch)
            if epoch == 1:
                raise _Interrupted

    ds, model, split_ids = epoch_setup(fused)
    full = fit_checkpointed(copy.deepcopy(model).cuda(), ds, split_ids,
                            Checkpointer(tmp_path / "full"), optim)
    with pytest.raises(_Interrupted):
        fit_checkpointed(copy.deepcopy(model).cuda(), ds, split_ids,
                         Stopping(tmp_path / "cut"), optim)
    resumed = fit_checkpointed(copy.deepcopy(model).cuda(), ds, split_ids,
                               Checkpointer(tmp_path / "cut"), optim)
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    assert resumed.replays["train"] == resumed.num_train_steps - (
        2 if optim.get("batch_accumulation", 1) > 1 else 1)
    for got, ref in zip(resumed.history, full.history[2:]):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6)
    want = full.model.state_dict()
    for name, p in resumed.model.state_dict().items():
        assert_close(p, want[name], 1e-6)


def test_encoded_model_on_the_card_matches_the_cpu():
    """The trainable SignNet with a GCN MPNN core (EncodedModel) on a
    4-graph peptides batch with its eigen stats, card against CPU under
    matmul_precision highest (pinned, then restored): logits and every
    parameter gradient within 1e-4*max|ref|."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.config.config import PEConfig
    from graph_hscn_tpu_torch.data.synthetic import make_peptides_func
    from graph_hscn_tpu_torch.models.encoded import wrap_with_signnet
    from graph_hscn_tpu_torch.models.mpnn import MPNN
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.loss import criterion
    from graph_hscn_tpu_torch.transform.posenc import compute_posenc_stats
    graphs = [compute_posenc_stats(g) for g in
              make_peptides_func(num_graphs=4, seed=7)]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4))
    gen = torch.Generator().manual_seed(5)
    model = wrap_with_signnet(
        MPNN(conv_type="gcn", activation="relu", num_features=9,
             hidden_channels=16, num_classes=10, num_layers=3,
             generator=gen),
        PEConfig(dim_in=9, dim_emb=9, dim_pe=4), 9, generator=gen)
    model.eval()
    outs = {}
    prev = torch.get_float32_matmul_precision()
    set_matmul_precision("highest")
    try:
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(model).to(dev)
            b = batch.to(dev)
            logits = m(b)
            loss, _ = criterion("cross_entropy", logits, b.y, b.graph_mask)
            loss.backward()
            outs[dev] = [logits.detach()] + [p.grad for p in m.parameters()]
    finally:
        set_matmul_precision("highest" if prev == "highest" else "default")
    assert len(outs["cpu"]) == 1 + len(list(model.parameters()))
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        assert bool(got.isfinite().all())
        assert_close(got, ref, 1e-4)


# --- the edge-partitioned models (parallel/sharded_gcn.py) ----------------

@pytest.mark.parametrize("conv", ["gcn", "gat"])
def test_sharded_model_on_the_card_matches_the_cpu(conv):
    """The sharded GCN and GAT (hidden 64, 4 heads for GAT) on a 1-rank
    mesh over an 8-graph VOC batch, locality-reordered: the card (a 1-rank
    NCCL group, the kernels on the local-edge CsrPlan) against the CPU (a
    1-rank gloo group, the plain path) under matmul_precision highest
    (pinned, then restored): logits within 1e-5*max|ref|, the loss and
    every gradient within 1e-4*max|ref|; the kernels launched a layer as
    the fit counts them."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (
        build_sharded_model, gather_logits, loss_and_grads, partition_arrays)
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    graphs = make_voc_superpixels(num_graphs=8, seed=17)
    b = pack_batch(graphs, PadBudget.for_dataset(graphs, 8))
    model = build_sharded_model(conv, [14, 64, 64, 21], heads=4,
                                generator=torch.Generator().manual_seed(2))
    kernels = {"gcn": (csr_spmm,), "gat": (spmm_mh, sddmm_mh)}[conv]
    outs = {}
    prev = torch.get_float32_matmul_precision()
    set_matmul_precision("highest")
    try:
        for dev in ("cpu", "cuda"):
            with process_group(torch.device(dev)) as device:
                blk = partition_arrays(
                    b.senders, b.receivers, b.edge_mask, b.node_feat,
                    b.node_y, b.node_mask, make_mesh(("data",), (1,), device),
                    use_plan=dev == "cuda").block
                m = copy.deepcopy(model).to(device)
                before = [k.launches for k in kernels]
                logits = gather_logits(m, blk)
                m.train()
                loss = loss_and_grads(m, blk)
                torch.cuda.synchronize()
                launched = [k.launches - n for k, n in zip(kernels, before)]
                outs[dev] = [logits, loss.reshape(1)] + [
                    p.grad for p in m.parameters()]
    finally:
        set_matmul_precision("highest" if prev == "highest" else "default")
    # GCN: 2 layers of width 64 (forward, then forward + transpose); GAT:
    # 3 layers of H*C >= 64 (spmm_mh forward, forward + dx; sddmm_mh d alpha).
    assert launched == ([6] if conv == "gcn" else [9, 3])
    for i, (ref, got) in enumerate(zip(outs["cpu"], outs["cuda"])):
        assert bool(got.isfinite().all())
        assert_close(got, ref, 1e-5 if i == 0 else 1e-4)


# --- the data-parallel and hybrid meshes, the loader ------------------------

def test_dp_step_on_the_card_is_the_single_device_step():
    """fit_dp's train step on a 1-rank NCCL group against the single-device
    train step (train/loop.py) on the same batch, both on the card, with
    the sparse GCN's CSR plan (csr_spmm), under matmul_precision highest
    (pinned, then restored): the loss and every gradient within
    1e-5*max|ref|; 2 csr_spmm a layer each."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.data.synthetic import make_peptides_func
    from graph_hscn_tpu_torch.models.mpnn import MPNN
    from graph_hscn_tpu_torch.parallel.data_parallel import (
        make_dp_train_step, pack_for_devices)
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.loop import make_train_step
    graphs = make_peptides_func(num_graphs=16, seed=3)
    batch = pack_for_devices(graphs, 1, PadBudget.for_dataset(graphs, 16),
                             with_spmm_plan=True)[0].to("cuda")
    model = MPNN("gcn", "relu", 9, 64, 10, 3,
                 generator=torch.Generator().manual_seed(1)).cuda()

    class NoStep:
        minibatches = 0

        def zero_grad(self):
            pass

        def step(self, applies=None):
            pass

    prev = torch.get_float32_matmul_precision()
    set_matmul_precision("highest")
    outs = {}
    try:
        with process_group(torch.device("cuda")) as device:
            dp = copy.deepcopy(model)
            step = make_dp_train_step(dp, NoStep(), "cross_entropy",
                                      make_mesh(("data",), (1,), device))
            before = csr_spmm.launches
            loss = step(batch, 0)[0]
            torch.cuda.synchronize()
            launched = csr_spmm.launches - before
            outs["dp"] = [loss.reshape(1)] + [p.grad for p in dp.parameters()]
        single = copy.deepcopy(model)
        train_step, _ = make_train_step(single, NoStep(), "cross_entropy")
        loss = train_step(batch)[0]
        outs["single"] = [loss.reshape(1)] + [p.grad
                                              for p in single.parameters()]
    finally:
        set_matmul_precision("highest" if prev == "highest" else "default")
    assert launched == 2 * 3
    for got, ref in zip(outs["dp"], outs["single"]):
        assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("conv", ["gcn", "gat"])
def test_hybrid_block_on_the_card_matches_the_cpu(conv):
    """The hybrid GCN and GAT (one head, as fit_hybrid builds it; hidden
    64) on a (1, 1) mesh over a 6-graph VOC split: the card (a 1-rank NCCL
    group, the kernels on the block's CsrPlan) against the CPU (gloo, the
    plain path) under matmul_precision highest (pinned, then restored):
    logits within 1e-5*max|ref|, the loss and gradients within
    1e-4*max|ref|; the kernels launched as the fit counts them."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.parallel.hybrid import (build_hybrid_split,
                                                      hybrid_block)
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (
        build_sharded_model, gather_logits, loss_and_grads)
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    split = build_hybrid_split(make_voc_superpixels(num_graphs=6, seed=21),
                               1, 1)
    model = build_sharded_model(conv, [14, 64, 64, 21], heads=1,
                                generator=torch.Generator().manual_seed(5))
    kernels = {"gcn": (csr_spmm,), "gat": (spmm_mh, sddmm_mh)}[conv]
    outs = {}
    prev = torch.get_float32_matmul_precision()
    set_matmul_precision("highest")
    try:
        for dev in ("cpu", "cuda"):
            with process_group(torch.device(dev)) as device:
                mesh = make_mesh(("data", "model"), (1, 1), device)
                blk = hybrid_block(*split[:4], mesh, use_plan=dev == "cuda")
                m = copy.deepcopy(model).to(device)
                before = [k.launches for k in kernels]
                logits = gather_logits(m, blk)
                m.train()
                loss = loss_and_grads(m, blk)
                if dev == "cuda":
                    torch.cuda.synchronize()
                launched = [k.launches - n for k, n in zip(kernels, before)]
                outs[dev] = [logits, loss.reshape(1)] + [
                    p.grad for p in m.parameters()]
    finally:
        set_matmul_precision("highest" if prev == "highest" else "default")
    # Two layers of width 64: GCN forward, then forward + transpose; GAT
    # one head of C = 64: spmm_mh forward, forward + dx, sddmm_mh d alpha.
    assert launched == ([6] if conv == "gcn" else [6, 2])
    for i, (ref, got) in enumerate(zip(outs["cpu"], outs["cuda"])):
        assert bool(got.isfinite().all())
        assert_close(got, ref, 1e-5 if i == 0 else 1e-4)


def test_prefetched_batches_train_as_inline_ones_on_the_card():
    """Two epochs of the host fit on the card with data.num_workers 2 (the
    worker packs, the main thread uploads) against the same fit on the
    same batches packed inline beforehand: equal losses."""
    need_card()
    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.train.loop import fit
    from graph_hscn_tpu_torch.utils.logger import Logger
    from pathlib import Path
    cfg = load_config(Path(__file__).parents[1] / "configs" / "GCN"
                      / "voc_superpixels_GCN_sparse.yaml")
    cfg.data.num_graphs, cfg.data.num_workers = 40, 2
    cfg.training.epochs, cfg.mpnn.dropout = 2, 0.0
    dm = DataModule.from_config(cfg.data)
    dm.with_spmm_plan = True
    epochs = {e: list(dm.train_batches(epoch_seed=dm.seed + e))
              for e in range(2)}
    results = []
    for source in ("loader", "inline"):
        model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                           readout="none",
                           generator=torch.Generator().manual_seed(3))
        batches = ((lambda e: dm.train_batches(epoch_seed=dm.seed + e))
                   if source == "loader" else (lambda e: epochs[e]))
        results.append(fit(model.cuda(), batches, dm.eval_batches("val"),
                           dm.eval_batches("test"), cfg.optim, cfg.training,
                           Logger(quiet=True), "cuda", node_level=True))
    for a, b in zip(*(r.history for r in results)):
        assert a["train_loss"] == b["train_loss"]
        assert a["validation_loss"] == b["validation_loss"]
