"""The port on the card (marker ``gpu``; each test skips where there is no
CUDA card): its CUDA kernels, each against its plain PyTorch version; the
models that launch them against the CPU; the captured epoch against the
eager one; and the runner's routes (run_experiment, run_eval, main
--predict, the mesh routes on a 1-rank NCCL group) with their kernels'
launches, checkpoints, traces and NaN guard.  The kernels' times are
chip_smoke.py's.

On a machine with the card, from the repository root (no JAX needed, hence
no conftest):

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

Tolerance: float32 sums in another order, rtol=1e-5, atol=1e-5*max|ref|.
spmm_mh in bfloat16 is held at rtol=1e-4, atol=1e-4*max|ref|: kernel and
plain version round each term bf16(f32(x_j) * alpha) alike, while another
rounding rule fails it (tests/test_torch_gat.py,
test_bf16_tolerance_catches_a_missing_rounding_point).
The fused GCN stack: every output finite and within tol*max|ref| of its
plain version, tol 1e-5 in float32 and 1e-4 in bfloat16, the plain version
run by graph_hscn_tpu_torch.ops.fused_gcn.plain_reference: in bfloat16
with its matrix products summed in order, the kernels' order.  Kernel and plain
version round the same float32 values to bfloat16 at the same points, so
in that order every rounded output (hidden h, logits, dx) agrees bit for
bit; cuBLAS picks its own order by shape, and a sum next to a rounding
midpoint then rounds one bfloat16 ulp (0.4%) away.  A kernel that leaves
out a rounding point fails 1e-4 (tests/test_torch_fused_gcn.py,
test_bf16_tolerance_catches_a_missing_rounding_point).
segment_reduce in bfloat16 is held at rtol=1e-4, atol=1e-4*max|ref|: both
sum the same exact bfloat16 values in float32, in another order.
graph_attn (GraphMHA's attention) is held against its plain version run in
float64 on the same inputs (and the same dropout bits): float32 sums in
another order, rtol=1e-5, atol=1e-5*max|ref|, on the output at real query
rows and on every gradient.  With bfloat16 inputs the kernels read the
bfloat16 values exactly and sum in float32, and round each output once to
bfloat16 (a relative step of 2^-8), and the backward reads the rounded
output: rtol=atol/max|ref|=1e-2.
"""

from pathlib import Path

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


CONFIGS = Path(__file__).parents[1] / "configs"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def shipped_raw(name: str, changes: dict | None = None) -> dict:
    """configs/<name>.yaml as the YAML's dict, with ``changes``
    ({"section.field": value}, by the config object's names: ``mpnn`` for
    the YAML's ``mp``) set."""
    import yaml
    raw = yaml.safe_load((CONFIGS / f"{name}.yaml").read_text())
    for key, value in (changes or {}).items():
        section, field = key.split(".")
        raw.setdefault({"mpnn": "mp"}.get(section, section), {})[field] = value
    return raw


def shipped(name: str, changes: dict | None = None):
    """The ExperimentConfig of :func:`shipped_raw`."""
    from graph_hscn_tpu_torch.config.config import parse_config
    return parse_config(shipped_raw(name, changes))


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


# A sparse-batch config's model at full width and the kernels its forward
# and backward launch a layer ({kernel: launches}, ``L`` layers): GIN on
# sparse batches (the 0/1 edge mask as csr_spmm's weights; the transpose in
# every layer but the first, whose input takes no gradient), and the VOC
# sparse GCN, GAT (with self loops) and GatedGCN.
SPARSE_MODELS = {
    "gin": ("GIN/peptides_func_GIN", lambda L: {"csr_spmm": 2 * L - 1}),
    "gcn": ("GCN/voc_superpixels_GCN_sparse",
            lambda L: {"csr_spmm": 2 * L}),
    "gat": ("GAT/voc_superpixels_GAT_sparse",
            lambda L: {"spmm_mh": 4 * L, "sddmm_mh": 3 * L}),
    "gatedgcn": ("GatedGCN/voc_superpixels_GatedGCN_sparse",
                 lambda L: {"segment_reduce": 5 * L}),
}


@pytest.mark.parametrize("model", SPARSE_MODELS)
def test_sparse_mpnn_on_the_card_matches_the_cpu(model):
    """A sparse-batch config's model at full width on a 4-graph batch with
    its CSR plan: logits and every parameter gradient on the card (the
    kernels, launched as ``SPARSE_MODELS`` says) within 1e-4*max|ref| of
    the CPU's (the kernels' plain versions), in eval mode (no dropout) and
    under the config's ``matmul_precision`` (GIN's ``highest``: its
    unnormalised sums give logits of ~100, which TF32's rounding of the
    Dense inputs moves by ~4e-4 of their largest).  A parameter the loss
    does not reach (the last GatedGCN layer's edge LayerNorm) has a zero
    gradient on both."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.capture import counted_kernels
    from graph_hscn_tpu_torch.train.loss import criterion
    name, per_layer = SPARSE_MODELS[model]
    cfg = shipped(name, {"data.num_graphs": 16})
    dm = DataModule.from_config(cfg.data)
    node_level = dm.task_level == "node"
    graphs = dm.split("train")[:4]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4),
                       with_spmm_plan=True)
    net = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                     readout="none" if node_level else "mean",
                     generator=torch.Generator().manual_seed(4),
                     num_edge_features=dm.num_edge_features)
    net.eval()
    outs = {}
    prev = spmm.get_backend(), torch.get_float32_matmul_precision()
    spmm.set_backend("pallas")
    set_matmul_precision(cfg.runtime.matmul_precision)
    try:
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(net).to(dev)
            b = batch.to(dev)
            before = {k.__name__: k.launches for k in counted_kernels()}
            logits = m(b)
            true, mask = ((b.node_y, b.node_mask) if node_level
                          else (b.y, b.graph_mask))
            loss, _ = criterion(cfg.training.loss_fn, logits, true, mask)
            loss.backward()
            outs[dev] = [logits.detach()] + [
                torch.zeros_like(p) if p.grad is None else p.grad
                for p in m.parameters()]
            launched = {k.__name__: k.launches - before[k.__name__]
                        for k in counted_kernels()}
    finally:
        spmm.set_backend(prev[0])
        set_matmul_precision("highest" if prev[1] == "highest"
                             else "default")
    want = dict.fromkeys(launched, 0)
    want.update(per_layer(cfg.mpnn.num_layers))
    assert launched == want
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        assert bool(got.isfinite().all())
        assert_close(got, ref, 1e-4)


# --- graph_attn (GraphMHA's attention, ops/cuda/graph_attn_kernel.py) ----

def attn_inputs(n_nodes, S, nh, hd, dtype=torch.float32, seed=0):
    """q, k, v [G, S, nh, hd] on the card and the node mask [G, S]:
    ``n_nodes`` real nodes a graph, first, or a given mask [G, S]."""
    mask = (torch.as_tensor(n_nodes) if torch.is_tensor(n_nodes)
            and n_nodes.dtype == torch.bool
            else torch.arange(S)[None, :] < torch.as_tensor(n_nodes)[:, None])
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(mask.shape[0], S, nh, hd, generator=g).to(dtype)
               .cuda() for _ in range(3))
    return q, k, v, mask.cuda()


def attn_both(q, k, v, mask, rate, training=True, seed=9):
    """graph_attention on the card (the kernels) and its plain version in
    float64, each from a CUDA generator seeded alike (the same bits), and
    each backward of a cotangent zero on padding query rows (what GraphMHA's
    mask after the output projection passes back): ((out, dq, dk, dv),
    (out, dq, dk, dv)), the outputs zeroed on padding query rows."""
    from graph_hscn_tpu_torch.ops.cuda.graph_attn_kernel import (
        graph_attention, graph_attention_plain)
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    cot = cot.cuda() * mask[:, :, None, None]
    res = []
    for fn, dtype in ((graph_attention, q.dtype),
                      (graph_attention_plain, torch.float64)):
        ins = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out = fn(*ins, mask, rate, training, gen)
        (out.float() * cot).sum().backward()
        out = torch.where(mask[:, :, None, None], out, 0.0)
        res.append((out.detach(), *(t.grad for t in ins)))
    return res


def assert_attn_close(got, ref, dtype):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and bool(a.isfinite().all()), name
        assert_close(a, b, tol)


def cell_node_counts(graphs: int = 128):
    """Node counts of the peptides_func_gps cell's graphs (the generator's
    lognormal around 150 nodes, clipped to 8..444)."""
    from graph_hscn_tpu_torch.data.synthetic import make_peptides_func
    return [g.num_nodes for g in make_peptides_func(num_graphs=graphs,
                                                    seed=0)]


def test_graph_attn_matches_plain_at_the_cell_shape():
    """The peptides_func_gps cell's attention: 128 graphs at slot 448, 4
    heads of 24, dropout 0.5 in training, the cell's node counts; forward
    and every gradient; one forward and one backward launch."""
    need_card()
    from graph_hscn_tpu_torch.ops.cuda.graph_attn_kernel import (
        graph_attn, graph_attn_bwd)
    before = (graph_attn.launches, graph_attn_bwd.launches)
    q, k, v, mask = attn_inputs(cell_node_counts(), 448, 4, 24)
    got, ref = attn_both(q, k, v, mask, 0.5)
    assert_attn_close(got, ref, torch.float32)
    assert (graph_attn.launches, graph_attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("hd,rate,training", [
    (16, 0.0, True), (16, 0.2, False), (4, 0.1, True), (20, 0.3, True),
    (64, 0.5, True), (40, 0.0, True)])
def test_graph_attn_matches_plain_at_each_head_width(hd, rate, training):
    """Head widths 16 (the shipped GPS configs, rate 0; and in eval), 4
    (parallel/dryrun.py's), 20 and 40 (padded in registers), 64 (the
    widest), on 12 graphs at slot 70 (a last tile of 6 rows)."""
    need_card()
    rng = np.random.default_rng(hd)
    n = rng.integers(1, 71, size=12)
    q, k, v, mask = attn_inputs(n, 70, 2, hd, seed=hd)
    got, ref = attn_both(q, k, v, mask, rate, training)
    assert_attn_close(got, ref, torch.float32)


def test_graph_attn_odd_blocks_and_a_non_prefix_mask():
    """An all-padding block (the dummy slot: output and gradients 0), a
    full slot, a one-node graph, and a mask with holes (padding keys inside
    visited tiles excluded exactly), dropout 0.5."""
    need_card()
    S = 96
    mask = torch.arange(S)[None, :] < torch.tensor([[0], [S], [1], [50]])
    holes = torch.rand(S, generator=torch.Generator().manual_seed(3)) < 0.6
    mask = torch.cat([mask, holes[None, :]])
    q, k, v, mask = attn_inputs(mask, S, 4, 24, seed=5)
    got, ref = attn_both(q, k, v, mask, 0.5)
    assert_attn_close(got, ref, torch.float32)
    for t in got:
        assert not t[0].any()


def test_graph_attn_bfloat16():
    """bfloat16 q, k, v (GraphMHA's compute dtype): read as such, softmax
    and sums in float32, outputs rounded once; the cell's widths on 32
    graphs, dropout 0.5."""
    need_card()
    q, k, v, mask = attn_inputs(cell_node_counts(32), 448, 4, 24,
                                dtype=torch.bfloat16)
    got, ref = attn_both(q, k, v, mask, 0.5)
    assert_attn_close(got, ref, torch.bfloat16)


def test_graph_attn_under_capture_and_replay():
    """graph_attention's forward and backward captured as a CUDA graph with
    its dropout generator registered: each replay gives what an eager call
    from the same generator state gives, bit for bit (fixed sums, no
    atomics), and draws new bits each replay."""
    need_card()
    from graph_hscn_tpu_torch.ops.cuda.graph_attn_kernel import (
        graph_attention)
    q, k, v, mask = attn_inputs(cell_node_counts(16), 448, 4, 24)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    gen = torch.Generator(device="cuda").manual_seed(21)

    def step():
        for t in ins:
            t.grad = None
        out = graph_attention(*ins, mask, 0.5, True, gen)
        out.sum().backward()
        return out

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()      # builds and loads the kernels outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = step()
    gen.manual_seed(33)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([out.clone()] + [t.grad.clone() for t in ins])
    assert not torch.equal(replays[0][0], replays[1][0])
    gen.manual_seed(33)
    for want in replays:
        eager = step()
        for a, b in zip([eager] + [t.grad for t in ins], want):
            assert torch.equal(a, b)


def test_graph_attn_refuses_what_the_kernels_do_not_take():
    """A head wider than 64, mixed dtypes, a dropout rate of 1: ValueError
    or TypeError, no launch."""
    need_card()
    from graph_hscn_tpu_torch.ops.cuda.graph_attn_kernel import (
        extent, graph_attention, graph_attn)
    before = graph_attn.launches
    q, k, v, mask = attn_inputs([3, 4], 8, 1, 65)
    with pytest.raises(ValueError, match="head width"):
        graph_attn(q, k, v, mask, extent(mask))
    q, k, v, mask = attn_inputs([3, 4], 8, 2, 8)
    with pytest.raises(TypeError):
        graph_attn(q, k.bfloat16(), v, mask, extent(mask))
    with pytest.raises(ValueError, match="rate"):
        graph_attention(q, k, v, mask, 1.0, True)
    assert graph_attn.launches == before


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


def test_captured_f1_epochs_reduce_counts_on_the_card(monkeypatch):
    """A node-level F1 fit on the card (24 VOC-like graphs, the GCN at 2
    layers of 16, dropout 0.1): its train and eval steps return (loss,
    counts) and are captured and replayed under
    torch.cuda.set_sync_debug_mode("error"), no step syncing with the host;
    the fit's history, captured and eager, equals the same fit's with the
    host F1 (scores and targets read back) bit for bit; and the passes are
    counted, one a train epoch and two an eval epoch."""
    need_card()
    import copy
    from graph_hscn_tpu_torch.config.config import OptimConfig, TrainingConfig
    from graph_hscn_tpu_torch.models.mpnn import MPNN
    from graph_hscn_tpu_torch.train import metrics
    from graph_hscn_tpu_torch.train.device_data import (DeviceDataset,
                                                        epoch_permutation,
                                                        make_epoch_fn)
    from graph_hscn_tpu_torch.train.loop import fit_on_device_dataset
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer
    from graph_hscn_tpu_torch.utils.logger import Logger
    graphs = make_voc_superpixels(num_graphs=24, seed=19)
    ds = DeviceDataset.build(graphs, device="cuda")
    model = MPNN(conv_type="gcn", activation="relu", num_features=14,
                 hidden_channels=16, num_classes=21, num_layers=2,
                 dropout=0.1, readout="none",
                 generator=torch.Generator().manual_seed(0))
    split_ids = {"train": np.arange(16), "val": np.arange(16, 20),
                 "test": np.arange(20, 24)}

    m = copy.deepcopy(model).cuda()
    opt = build_optimizer(m.parameters(), "adamW", 0.002, 1e-5,
                          capturable=True)
    stat = metrics.COUNT_METRICS["f1"].step
    train_epoch, eval_epoch = make_epoch_fn(
        m, opt, ds, 4, 4, "softmax_cross_entropy", node_level=True,
        generator=torch.Generator(device="cuda").manual_seed(1), stat=stat)
    for epoch_fn, perm in ((train_epoch, epoch_permutation(16, 4, 0)),
                           (eval_epoch, epoch_permutation(16, 4, 0, False))):
        for _ in range(2):
            nb = epoch_fn.load(perm)
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(nb):
                    epoch_fn.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            losses, counts = epoch_fn.outs
            assert counts.shape == (4, 21 * 21) and counts.dtype == torch.int64
            # Each row counts the real nodes of its four graphs.
            assert bool(losses.isfinite().all())
            assert int(counts.sum()) == sum(
                graphs[i].num_nodes for i in perm.reshape(-1) if i >= 0)
        assert epoch_fn.replays == 2 * nb - 1

    def fit(capture):
        training = TrainingConfig(model_type="gcn",
                                  loss_fn="softmax_cross_entropy",
                                  metric="f1", epochs=2, eval_period=1,
                                  patience=50, min_delta=0.0, seed=3)
        return fit_on_device_dataset(
            copy.deepcopy(model).cuda(), ds, split_ids, 4,
            OptimConfig(optim_type="adamW", lr=0.002, weight_decay=1e-5),
            training, Logger(metric_name="f1"), "cuda", node_level=True,
            capture=capture)

    before = metrics.sum_step_counts.passes
    counted = {capture: fit(capture) for capture in (True, False)}
    assert metrics.sum_step_counts.passes - before == 2 * 2 * 3
    monkeypatch.delitem(metrics.COUNT_METRICS, "f1")
    for capture, res in counted.items():
        assert res.history == fit(capture).history, capture
    assert metrics.sum_step_counts.passes - before == 2 * 2 * 3


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

        def wandb_log(self, scalars):
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

@pytest.mark.parametrize("conv", ["gcn", "gat", "gatedgcn", "hscn"])
def test_sharded_model_on_the_card_matches_the_cpu(conv):
    """The sharded GCN, GAT and GatedGCN (hidden 64, 4 heads for GAT) and
    HSCN (hidden 64, 3 layers, 8 clusters, 4 heads) on a 1-rank mesh over
    an 8-graph VOC batch, locality-reordered: the card (a 1-rank NCCL
    group, the kernels on the local-edge CsrPlan) against the CPU (a
    1-rank gloo group, the plain path) under matmul_precision highest
    (pinned, then restored): logits within 1e-5*max|ref|, the loss and
    every gradient within 1e-4*max|ref| (0 on both for a parameter the
    loss does not reach: the last GatedGCN layer's edge LayerNorm); the
    kernels launched a layer as the fit counts them.  The HSCN takes on
    both the clusters that the sharded SCN (one GraphConv of 64) assigns
    on the CPU, and the SCN's MinCUT and orthogonality losses on the card
    are within 1e-5 relative of the CPU's."""
    need_card()
    import copy

    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (
        build_sharded_model, gather_logits, loss_and_grads, partition_arrays)
    from graph_hscn_tpu_torch.parallel.sharded_hscn import ShardedHSCN
    from graph_hscn_tpu_torch.parallel.sharded_scn import ShardedSCN
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    graphs = make_voc_superpixels(num_graphs=8, seed=17)
    b = pack_batch(graphs, PadBudget.for_dataset(graphs, 8))
    gen = torch.Generator().manual_seed(2)
    scn = ShardedSCN(14, [64], 8, generator=gen) if conv == "hscn" else None
    model = (ShardedHSCN(14, 64, 21, 3, 8, heads=4, generator=gen)
             if conv == "hscn" else
             build_sharded_model(conv, [14, 64, 64, 21], heads=4,
                                 generator=gen))
    kernels = {"gcn": (csr_spmm,), "gat": (spmm_mh, sddmm_mh),
               "gatedgcn": (segment_reduce,), "hscn": (csr_spmm,)}[conv]
    outs, scn_losses, clusters, args = {}, {}, None, ()
    prev = torch.get_float32_matmul_precision()
    set_matmul_precision("highest")
    try:
        for dev in ("cpu", "cuda"):
            with process_group(torch.device(dev)) as device:
                blk = partition_arrays(
                    b.senders, b.receivers, b.edge_mask, b.node_feat,
                    b.node_y, b.node_mask, make_mesh(("data",), (1,), device),
                    use_plan=dev == "cuda", outdeg=scn is not None).block
                if scn is not None:
                    s = copy.deepcopy(scn).to(device)
                    with torch.no_grad():
                        scn_losses[dev] = [float(t) for t in s.losses(blk)]
                    if clusters is None:
                        clusters = s.assign(blk).cpu()
                    args = (clusters.to(device),)
                m = copy.deepcopy(model).to(device)
                before = [k.launches for k in kernels]
                logits = gather_logits(m, blk, *args)
                m.train()
                loss = loss_and_grads(m, blk, *args)
                torch.cuda.synchronize()
                launched = [k.launches - n for k, n in zip(kernels, before)]
                outs[dev] = [logits, loss.reshape(1)] + [
                    torch.zeros_like(p) if p.grad is None else p.grad
                    for p in m.parameters()]
    finally:
        set_matmul_precision("highest" if prev == "highest" else "default")
    # GCN: 2 layers of width 64 (forward, then forward + transpose); GAT:
    # 3 layers of H*C >= 64 (spmm_mh forward, forward + dx; sddmm_mh d
    # alpha); GatedGCN: 3 layers, 2 segment sums forward, then 2 + 3
    # gather-backwards; HSCN: its ll GCNConv in each of 3 layers (forward,
    # then forward + transpose).
    assert launched == {"gcn": [6], "gat": [9, 3], "gatedgcn": [21],
                        "hscn": [9]}[conv]
    if scn is not None:
        np.testing.assert_allclose(scn_losses["cuda"], scn_losses["cpu"],
                                   rtol=1e-5)
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


# --- the runner's routes on the card (run_experiment, run_eval, main) ------

ONE_RANK = {"mesh.shape": [1]}
# Each route's kernel launches on its shipped config cut to a few graphs,
# {kernel: (a train step, an eval batch)}; on the mesh routes an eval
# forward, on a 1-rank NCCL group the runner makes.  The VOC sparse GCN,
# GAT and GatedGCN at 2 layers: csr_spmm forward and dx a layer; spmm_mh 4
# and sddmm_mh 3 a layer (1 and 2 an eval batch); segment_reduce 2 sums
# forward and 3 gather-backwards a layer.  The peptides configs on the
# device route: the fused stack's two kernels once a step (counted per
# replay), the unfused MPNN none.  The sparse HSCN: the
# ll GCNConv of each of its 3 layers, forward and dx (none while
# clustering); GIN on sparse batches: 3 forwards and 2 transposes; the
# three GPS configs on the captured device route (peptides-func's GCN
# local module, peptides-struct's GatedGCN one with its cosine schedule,
# VOC's node-level one): a graph_attn a layer (4) and its backward,
# counted per replay; the PE config, its SignNet frozen into the features
# or trained inside the captured graphs: none; the edge-partitioned and
# hybrid fits: the layers at least WIDTH_GATE wide (GCN and the HSCN's ll
# GCN 3, GAT's 4 of H*C >= 64, GatedGCN 4: 2 segment sums forward and 3
# gather-backwards a layer; the hybrid GAT's one head of 64, 3), GIN none.
TWO_LAYERS = {"data.num_graphs": 48, "mpnn.num_layers": 2}
GPS_ATTN = {"graph_attn": (4, 4), "graph_attn_bwd": (4, 0)}
LAUNCH_ROUTES = {
    "voc_gcn_sparse": ("GCN/voc_superpixels_GCN_sparse", TWO_LAYERS,
                       {"csr_spmm": (4, 2)}),
    "voc_gat_sparse": ("GAT/voc_superpixels_GAT_sparse", TWO_LAYERS,
                       {"spmm_mh": (8, 2), "sddmm_mh": (6, 4)}),
    "voc_gatedgcn_sparse": ("GatedGCN/voc_superpixels_GatedGCN_sparse",
                            TWO_LAYERS, {"segment_reduce": (10, 4)}),
    "peptides_fused": ("GCN/peptides_func_GCN_fused", {"data.num_graphs": 96},
                       {"fused_gcn_fwd": (1, 1), "fused_gcn_bwd": (1, 0)}),
    "peptides": ("GCN/peptides_func_GCN", {"data.num_graphs": 96}, {}),
    "voc_hscn_sparse": ("HSCN/voc_superpixels_HSCN_sparse",
                        {"data.num_graphs": 48, "hscn.cluster_epochs": 1},
                        {"csr_spmm": (6, 3)}),
    "gin_sparse": ("GIN/peptides_func_GIN",
                   {"data.num_graphs": 96, "runtime.dense_path": "sparse",
                    "runtime.device_dataset": "off"},
                   {"csr_spmm": (5, 3)}),
    "gps": ("GPS/peptides_func_GPS", {"data.num_graphs": 96}, GPS_ATTN),
    "gps_struct": ("GPS/peptides_struct_GPS", {"data.num_graphs": 96},
                   GPS_ATTN),
    "gps_voc": ("GPS/voc_superpixels_GPS", {"data.num_graphs": 48},
                GPS_ATTN),
    "pe_frozen": ("GCN/peptides_func_GCN_PE", {"data.num_graphs": 96}, {}),
    "pe_trainable": ("GCN/peptides_func_GCN_PE",
                     {"data.num_graphs": 96,
                      "compat.frozen_random_signnet": False}, {}),
    "edge_partition_gcn": ("GCN/voc_superpixels_GCN_edge_partition",
                           {**ONE_RANK, "data.num_graphs": 48},
                           {"csr_spmm": (6, 3)}),
    "edge_partition_gat": ("GAT/voc_superpixels_GAT_edge_partition",
                           {**ONE_RANK, "data.num_graphs": 48},
                           {"spmm_mh": (8, 4), "sddmm_mh": (4, 0)}),
    "edge_partition_gin": ("GCN/voc_superpixels_GCN_edge_partition",
                           {**ONE_RANK, "data.num_graphs": 48,
                            "mpnn.conv_type": "gin"}, {}),
    "edge_partition_gatedgcn": (
        "GatedGCN/voc_superpixels_GatedGCN_edge_partition",
        {**ONE_RANK, "data.num_graphs": 48}, {"segment_reduce": (20, 8)}),
    "edge_partition_hscn": ("HSCN/voc_superpixels_HSCN_edge_partition",
                            {"data.num_graphs": 48,
                             "hscn.cluster_epochs": 1},
                            {"csr_spmm": (6, 3)}),
    "hybrid_gcn": ("GCN/voc_superpixels_GCN_hybrid",
                   {"mesh.shape": [1, 1], "data.num_graphs": 48},
                   {"csr_spmm": (6, 3)}),
    "hybrid_gat": ("GCN/voc_superpixels_GCN_hybrid",
                   {"mesh.shape": [1, 1], "data.num_graphs": 48,
                    "mpnn.conv_type": "gat"},
                   {"spmm_mh": (6, 3), "sddmm_mh": (3, 0)}),
}


def fit_shipped(name: str, changes: dict, epochs: int = 2,
                data_parallel: bool = False):
    """run_experiment of a shipped config with ``changes``, ``epochs``
    epochs and an eval each (``data_parallel``: fit_dp, as
    run_experiment's); ({kernel: launches in the run}, the FitResult)."""
    from graph_hscn_tpu_torch.runner import run_experiment
    from graph_hscn_tpu_torch.train.capture import counted_kernels
    cfg = shipped(name, changes)
    cfg.training.epochs, cfg.training.eval_period = epochs, 1
    before = {k.__name__: k.launches for k in counted_kernels()}
    result = run_experiment(cfg, data_parallel=data_parallel)
    return {k.__name__: k.launches - before[k.__name__]
            for k in counted_kernels()}, result


def assert_launched(launched: dict, result, per: dict) -> None:
    """Finite losses, and every kernel's launches ``per``'s {kernel: (a
    train step, an eval batch)} over the fit's steps and eval batches (0
    for a kernel left out)."""
    steps, evals = result.num_train_steps, result.num_eval_batches
    assert steps > 0 and evals > 0
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    assert losses and np.isfinite(losses).all()
    want = dict.fromkeys(launched, 0)
    want.update({k: a * steps + b * evals for k, (a, b) in per.items()})
    assert launched == want


@pytest.mark.parametrize("route", LAUNCH_ROUTES)
def test_run_experiment_launches_each_routes_kernels(route):
    """Each route through run_experiment, 2 epochs: finite losses, and
    every kernel's launches those of ``LAUNCH_ROUTES`` (0 for a kernel the
    route does not run)."""
    need_card()
    name, changes, per = LAUNCH_ROUTES[route]
    assert_launched(*fit_shipped(name, changes), per)


# configs/GCN/peptides_func_GCN_dp8.yaml's widths (global batch 128,
# hidden 128, 5 layers) on one rank, without dropout, and its fused and
# sparse twins: {kernel: (a train step, an eval batch)}, the fused stack's
# two kernels once a step, csr_spmm forward and dx in each layer.
DP_ROUTES = {
    "dense": ({}, {}),
    "fused": ({"runtime.fused_stack": "on"},
              {"fused_gcn_fwd": (1, 1), "fused_gcn_bwd": (1, 0)}),
    "sparse": ({"runtime.dense_path": "sparse"}, {"csr_spmm": (10, 5)}),
}


@pytest.mark.parametrize("route", DP_ROUTES)
def test_fit_dp_at_one_rank_follows_the_single_device_fit(route):
    """fit_dp (run_experiment's data_parallel) on a 1-rank NCCL group, 256
    graphs, 2 epochs: every kernel's launches as ``DP_ROUTES`` counts them,
    and each epoch's train, val and test loss within 1e-5 relative of the
    single-device host fit of the same model from the same seed on the
    same global batches."""
    need_card()
    from graph_hscn_tpu_torch.parallel.data_parallel import pack_for_devices
    from graph_hscn_tpu_torch.runner import _data, _model, _setup_run
    from graph_hscn_tpu_torch.train.loop import fit
    from graph_hscn_tpu_torch.utils.logger import Logger
    name = "GCN/peptides_func_GCN_dp8"
    twin, per = DP_ROUTES[route]
    changes = {**ONE_RANK, "data.num_graphs": 256, "mpnn.dropout": 0.0,
               **twin}
    launched, dp = fit_shipped(name, changes, data_parallel=True)
    assert_launched(launched, dp, per)
    cfg = shipped(name, changes)
    cfg.training.epochs, cfg.training.eval_period = 2, 1
    device, dtype = _setup_run(cfg, torch.device("cuda"))
    logger = Logger(quiet=True)
    dm = _data(cfg, device, logger)
    budget = PadBudget.for_dataset(dm.graphs, dm.batch_size)

    def global_batches(split, seed=None):
        graphs = dm.split(split)
        idx = np.arange(len(graphs))
        if seed is not None:
            np.random.default_rng(seed).shuffle(idx)
        return [pack_for_devices([graphs[int(j)] for j in
                                  idx[i:i + dm.batch_size]], 1, budget,
                                 slot_nodes=dm.slot_nodes,
                                 with_spmm_plan=dm.with_spmm_plan)[0]
                for i in range(0, len(idx), dm.batch_size)]

    ref = fit(_model(cfg, dm, device, dtype, logger),
              lambda epoch: global_batches("train",
                                           cfg.training.seed + epoch),
              global_batches("val"), global_batches("test"), cfg.optim,
              cfg.training, logger, device,
              compat_sigmoid_score=cfg.compat.sigmoid_regression_score)
    assert len(dp.history) == len(ref.history) == 2
    for a, b in zip(dp.history, ref.history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5)


# Eval-only mode: (config, changes, the kernel an eval forward launches and
# how often, the eval forwards: None for the host batches of val and test).
EVAL_ROUTES = {
    "fused": ("GCN/peptides_func_GCN_fused", {"data.num_graphs": 96},
              "fused_gcn_fwd", 1, None),
    "voc_sparse": ("GCN/voc_superpixels_GCN_sparse", {"data.num_graphs": 48},
                   "csr_spmm", 4, None),
    "edge_partition_gcn": ("GCN/voc_superpixels_GCN_edge_partition",
                           {**ONE_RANK, "data.num_graphs": 48}, "csr_spmm",
                           3, 2),
    "hybrid_gcn": ("GCN/voc_superpixels_GCN_hybrid",
                   {"mesh.shape": [1, 1], "data.num_graphs": 48},
                   "csr_spmm", 3, 2),
}


@pytest.mark.parametrize("route", EVAL_ROUTES)
def test_run_eval_and_predict_on_the_card(route, tmp_path):
    """A 2-epoch fit snapshotted into ``training.checkpoint_dir``; then
    run_eval(cfg, "best"): the val loss the fit's best within rtol 1e-5,
    atol 1e-6 (the JAX package's criterion, tests/test_checkpoint.py), its
    kernel launched once a forward as counted; then ``python -m
    graph_hscn_tpu_torch.main --eval best --predict out.npz`` in a
    subprocess: val and test scores and targets, finite, a row for each
    real graph (each real node at node level)."""
    need_card()
    import subprocess
    import sys

    import yaml

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.runner import _data, run_eval
    from graph_hscn_tpu_torch.train.capture import counted_kernels
    from graph_hscn_tpu_torch.utils.logger import Logger
    name, changes, kernel, per, forwards = EVAL_ROUTES[route]
    changes = {**changes, "training.checkpoint_dir": str(tmp_path / "ck")}
    _, fit = fit_shipped(name, changes)
    cfg = shipped(name, changes)
    if forwards is None:
        dm = _data(cfg, torch.device("cuda"), Logger(quiet=True))
        forwards = len(dm.eval_batches("val")) + len(dm.eval_batches("test"))
    before = {k.__name__: k.launches for k in counted_kernels()}
    scores = run_eval(cfg, "best")
    launched = {k.__name__: k.launches - before[k.__name__]
                for k in counted_kernels()}
    np.testing.assert_allclose(scores["val"]["loss"], fit.best_val_loss,
                               rtol=1e-5, atol=1e-6)
    assert launched == {**dict.fromkeys(launched, 0),
                        kernel: per * forwards}
    cfg_file, out = tmp_path / "cfg.yaml", tmp_path / "out.npz"
    cfg_file.write_text(yaml.safe_dump(shipped_raw(name, changes)))
    run = subprocess.run(
        [sys.executable, "-m", "graph_hscn_tpu_torch.main", "--cfg",
         str(cfg_file), "--eval", "best", "--predict", str(out)],
        cwd=CONFIGS.parent, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    z = np.load(out)
    assert set(z.files) == {"val_scores", "val_targets", "test_scores",
                            "test_targets"}
    dm = DataModule.from_config(cfg.data)
    for split in ("val", "test"):
        rows = (len(dm.split_idx[split]) if dm.task_level == "graph"
                else sum(g.num_nodes for g in dm.split(split)))
        for k in ("scores", "targets"):
            a = z[f"{split}_{k}"]
            assert a.shape == (rows, dm.num_classes)
            assert np.isfinite(a).all()


class _Cut(Exception):
    pass


@pytest.mark.parametrize("route", ["voc_sparse", "edge_partition_gcn",
                                   "edge_partition_hscn"])
def test_run_experiment_resumed_mid_run_follows_the_uninterrupted_one(
        route, tmp_path, monkeypatch):
    """The host loop (the sparse VOC GCN, dropout 0.1) and the
    edge-partitioned GCN and HSCN on a 1-rank NCCL group, 4 epochs
    snapshotted each epoch: uninterrupted, then cut after epoch 1's latest
    snapshot and run again, resuming from it.  Epochs 2-3's train losses
    within 1e-6 relative of the uninterrupted run's."""
    need_card()
    from graph_hscn_tpu_torch import runner
    from graph_hscn_tpu_torch.train.checkpoint import Checkpointer
    name, changes = {
        "voc_sparse": ("GCN/voc_superpixels_GCN_sparse", {}),
        "edge_partition_gcn": ("GCN/voc_superpixels_GCN_edge_partition",
                               ONE_RANK),
        "edge_partition_hscn": ("HSCN/voc_superpixels_HSCN_edge_partition",
                                {"hscn.cluster_epochs": 1})}[route]

    def cfg(directory):
        c = shipped(name, {**changes, "data.num_graphs": 48,
                           "training.checkpoint_dir": str(directory),
                           "training.checkpoint_every": 1,
                           "training.patience": 1000})
        c.training.epochs, c.training.eval_period = 4, 1
        return c

    class Stopping(Checkpointer):
        def save_latest(self, state, epoch):
            super().save_latest(state, epoch)
            if epoch == 1:
                raise _Cut

    full = runner.run_experiment(cfg(tmp_path / "full"))
    with monkeypatch.context() as m:
        m.setattr(runner, "Checkpointer", Stopping)
        with pytest.raises(_Cut):
            runner.run_experiment(cfg(tmp_path / "cut"))
    resumed = runner.run_experiment(cfg(tmp_path / "cut"))
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    np.testing.assert_allclose([h["train_loss"] for h in resumed.history],
                               [h["train_loss"] for h in full.history[2:]],
                               rtol=1e-6)


def test_hscn_clusters_alike_on_the_host_and_device_routes():
    """configs/HSCN/peptides_func_HSCN.yaml cut to 64 graphs and 2
    clustering epochs: the host clustering (what run_eval runs again) and
    the device route's captured clustering (what the device route trains
    with), each from the SCN weights its route draws, give every graph the
    same clusters."""
    need_card()
    from graph_hscn_tpu_torch import hscn_pipeline as hp
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.train.clustering import train_clustering_device
    from graph_hscn_tpu_torch.train.device_data import DeviceDataset
    from graph_hscn_tpu_torch.utils.logger import Logger
    cfg = shipped("HSCN/peptides_func_HSCN",
                  {"data.num_graphs": 64, "hscn.cluster_epochs": 2})
    dm = DataModule.from_config(cfg.data)
    dm.enable_dense_slots()
    hp.cluster_on_host(cfg, dm, Logger(quiet=True), torch.device("cuda"))
    order = np.concatenate([dm.split_idx[s] for s in ("train", "val",
                                                      "test")])
    ds = DeviceDataset.build([dm.graphs[i] for i in order],
                             slot=dm.slot_nodes, device="cuda",
                             with_cluster=True)
    scn, _ = hp._models(cfg, dm, ds.slot, torch.device("cuda"), None)
    ds, _ = train_clustering_device(Logger(quiet=True), ds, dm.batch_size,
                                    scn, cfg.hscn, cfg.optim,
                                    seed=cfg.training.seed)
    device_clusters = ds.cluster.cpu().numpy()
    for i, g in enumerate(order):
        host = dm.graphs[g].cluster
        np.testing.assert_array_equal(device_clusters[i, :len(host)], host)


def test_profile_dir_traces_the_replayed_fused_kernels():
    """runtime.profile_dir over the fused peptides config's captured fit
    (2 epochs): one Chrome trace, whose fused_gcn_fwd and fused_gcn_bwd
    kernel events (those inside replayed graphs included) equal the
    wrappers' replay accounting."""
    need_card()
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as trace_dir:
        launched, result = fit_shipped(
            "GCN/peptides_func_GCN_fused",
            {"data.num_graphs": 96, "runtime.profile_dir": trace_dir})
        files = sorted(Path(trace_dir).glob("*.pt.trace.json"))
        assert len(files) == 1
        events = json.loads(files[0].read_text())["traceEvents"]
    assert result.replays["train"] > 0
    for kernel in ("fused_gcn_fwd", "fused_gcn_bwd"):
        seen = sum(1 for e in events if e.get("cat") == "kernel"
                   and f"{kernel}_kernel" in e.get("name", ""))
        assert seen == launched[kernel] > 0


@pytest.mark.parametrize("route", ["fused", "voc_sparse"])
def test_debug_nans_on_the_card(route):
    """runtime.debug_nans on the captured route (the fused peptides config:
    a check an epoch, outside the graphs) and the host loop (the sparse
    VOC GCN, csr_spmm: a check a step): the losses with the guard equal
    the losses without, bit for bit (the fused route's under torch's
    deterministic algorithms: its readout's index_add_ sums in a
    run-dependent order otherwise); NaN in every graph raises
    FloatingPointError."""
    need_card()
    import contextlib

    import torch.utils.deterministic as det
    from torch_dist import poisoned

    from graph_hscn_tpu_torch.data import pipeline
    from graph_hscn_tpu_torch.runner import run_experiment
    from graph_hscn_tpu_torch.utils.profiling import nan_guard
    name, changes = {
        "fused": ("GCN/peptides_func_GCN_fused", {"data.num_graphs": 96}),
        "voc_sparse": ("GCN/voc_superpixels_GCN_sparse",
                       {"data.num_graphs": 48})}[route]

    @contextlib.contextmanager
    def deterministic():
        saved = (torch.are_deterministic_algorithms_enabled(),
                 det.fill_uninitialized_memory)
        torch.use_deterministic_algorithms(True)
        det.fill_uninitialized_memory = False
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(saved[0])
            det.fill_uninitialized_memory = saved[1]

    losses = []
    try:
        with deterministic() if route == "fused" else contextlib.nullcontext():
            for nans in (False, True):
                nan_guard(False)
                result = fit_shipped(name, {**changes,
                                            "runtime.debug_nans": nans})[1]
                losses.append([(h["train_loss"], h["validation_loss"],
                                h["test_loss"]) for h in result.history])
        assert losses[0] == losses[1]
        assert np.isfinite(losses[0]).all()
        nan_guard(False)
        cfg = shipped(name, {**changes, "runtime.debug_nans": True})
        cfg.training.epochs = 2
        with poisoned(pipeline, "all"), pytest.raises(FloatingPointError,
                                                       match="nan"):
            run_experiment(cfg)
    finally:
        nan_guard(False)


def test_batched_eigh_on_the_card_matches_the_host_stats():
    """batched_eigh in float64 on the card (cuSOLVER) against the host
    stats (numpy's LAPACK) of 4 peptides graphs: every real eigenvalue
    within 1e-5, and the projector onto the k smallest eigenvectors (k <=
    6, after the widest spectral gap there) within 1e-4."""
    need_card()
    from graph_hscn_tpu_torch.data.synthetic import make_peptides_func
    from graph_hscn_tpu_torch.transform.posenc import (batched_eigh,
                                                       compute_posenc_stats)
    graphs = make_peptides_func(num_graphs=4, seed=7)
    n_max = max(g.num_nodes for g in graphs)
    adj = np.zeros((4, n_max, n_max))
    mask = np.zeros((4, n_max), bool)
    for i, g in enumerate(graphs):
        np.add.at(adj[i], (g.edge_index[1], g.edge_index[0]), 1.0)
        mask[i, :g.num_nodes] = True
    evals, evects = batched_eigh(torch.from_numpy(adj).cuda(),
                                 torch.from_numpy(mask).cuda())
    evals, evects = evals.cpu().numpy(), evects.cpu().numpy()
    for i, g in enumerate(graphs):
        n = g.num_nodes
        host = compute_posenc_stats(g, max_freqs=n)
        # Padding adds eigenvalue-1 pairs with no support on real nodes.
        real = np.sort(np.argsort(-np.abs(evects[i, :n]).sum(0))[:n])
        lam, vec = evals[i][real], evects[i, :n][:, real]
        np.testing.assert_allclose(lam, host.eigvals[0], atol=1e-5)
        k = 1 + int(np.argmax(np.diff(lam[:7])))
        p, q = vec[:, :k], host.eigvecs[:, :k]
        np.testing.assert_allclose(p @ p.T, q @ q.T, atol=1e-4)


def test_walkthrough_runs_on_the_card():
    """Every stage of the HSCN walkthrough (graph_hscn_tpu_torch/examples)
    at its own sizes, on the card: 64 graphs clustered, finite losses."""
    need_card()
    from graph_hscn_tpu_torch.examples import hscn_walkthrough
    out = hscn_walkthrough.main(["--device", "cuda"])
    assert len(out["clusters"]) == 64
    for stage in ("fit", "giant", "feedback"):
        losses = [h["train_loss"] for h in out[stage].history]
        assert losses and np.isfinite(losses).all(), stage
