"""csr_spmm's and edge_sddmm's launch plans and the folded transpose order
(graph_hscn_tpu_torch/ops/cuda/spmm_kernel.py, sddmm_kernel.py), on the CPU.

``csr_spmm_plan`` and ``edge_sddmm_plan`` lay a gathered row of F values
over a lane group; each kernel walks a row by its plan, so a plan that
covers a value twice, or misses one, is a wrong sum on the card, and a plan
the C source does not build fails there.  ``csr_spmm(..., order=t_order)``
is the function of ``csr_spmm(..., w[t_order])``: on the CPU its plain
version, bit for bit (the kernel is held to it in tests/test_torch_cuda.py),
and SpmmFunction's dx, which takes that path, matches jax.vjp of the JAX
package's gather_scatter on its Pallas kernel (interpret mode) at
rtol=1e-5, atol=1e-5*max|ref| (float32 sums in another order).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hscn_tpu.data.batching import PadBudget as JaxPadBudget
from graph_hscn_tpu.data.batching import pack_batch as jax_pack_batch
from graph_hscn_tpu.data.synthetic import make_voc_superpixels
from graph_hscn_tpu.ops import spmm as jax_spmm
from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
from graph_hscn_tpu_torch.ops import spmm
from graph_hscn_tpu_torch.ops.cuda import spmm_kernel
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import edge_sddmm_plan
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (SpmmFunction,
                                                       csr_spmm,
                                                       csr_spmm_plain,
                                                       csr_spmm_plan)
from graph_hscn_tpu_torch.ops.cuda.vectors import RowPlan
from test_torch_cuda import ROW_WIDTHS

CSRC = (Path(__file__).resolve().parents[1] / "graph_hscn_tpu_torch"
        / "csrc")
DTYPES = [torch.float32, torch.bfloat16]
RULES = {"csr_spmm": csr_spmm_plan, "edge_sddmm": edge_sddmm_plan}
# The widths chip_smoke.py launches the two kernels at: the VOC GCN path's
# 64 and 21, the lattices' 128, and the floor's 1.
SMOKE_WIDTHS = [1, 21, 64, 128]


def covered(p: RowPlan) -> list[int]:
    """Every value index a group's lanes read over all chunks, as the
    kernels compute them (csrc/csr_spmm.cu, csrc/edge_sddmm.cu): lane l
    reads vector j = k0 + q * L + l in pass q of chunk k0."""
    nv = p.f // p.vec
    seen = []
    for lane in range(p.lanes):
        for k0 in range(0, nv, p.passes * p.lanes):
            for q in range(p.passes):
                j = k0 + q * p.lanes + lane
                if j < nv:
                    seen.extend(j * p.vec + v for v in range(p.vec))
    return seen


def instance(kernel: str, p: RowPlan) -> tuple[int, ...]:
    """The template arguments of the C instance that runs plan p."""
    return ((p.vec, p.passes, p.batch) if kernel == "csr_spmm"
            else (p.vec, p.passes))


def source_instances(kernel: str, dtype: torch.dtype) -> set[tuple]:
    """The instances the C source's dispatch builds for x (csr_spmm) or
    the narrower operand (edge_sddmm) of ``dtype``, read from the source:
    csr_spmm's ``launch_if<float|bf16, V, VP, B>``, edge_sddmm's
    ``launch_if<float, float, V, VP>`` and, for a bfloat16 operand,
    dispatch_bf16's ``launch_if<TS, TD, V, VP>``."""
    text = (CSRC / f"{kernel}.cu").read_text()
    if kernel == "csr_spmm":
        t = "float" if dtype == torch.float32 else "bf16"
        pattern = rf"launch_if<{t}, (\d+), (\d+), (\d+)>"
    else:
        t = "float, float" if dtype == torch.float32 else "TS, TD"
        pattern = rf"launch_if<{t}, (\d+), (\d+)>"
    return {tuple(map(int, m)) for m in re.findall(pattern, text)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["csr_spmm", "edge_sddmm"])
def test_plans_cover_the_row_exactly(kernel, dtype):
    """F = 1..160: the group's lanes x VP x V read every value of the row
    once; V values are at most 16 bytes and divide F (so every vector is
    aligned) and V is the widest such vector; a lane takes at most 8
    values of a row an edge (csr_spmm) or 16 a chunk (edge_sddmm), or one
    vector; a group is a power of two of lanes, at most 32 (edge_sddmm:
    8; csr_spmm at least 2, so that a warp's lanes hold its 32/L + 1 row
    pointers); csr_spmm holds B edges in flight, B * F at most 256 values,
    within one round of the group's index loads."""
    esize = dtype.itemsize
    for f in range(1, 161):
        p = RULES[kernel](f, dtype)
        assert p.f == f
        assert sorted(covered(p)) == list(range(f)), (kernel, f)
        assert f % p.vec == 0 and p.vec * esize <= 16
        assert f % (2 * p.vec) or 2 * p.vec * esize > 16
        most = 8 if kernel == "csr_spmm" else 16
        assert p.passes * p.vec <= max(most, p.vec)
        assert 1 <= p.lanes <= 32 and p.lanes & (p.lanes - 1) == 0
        if kernel == "csr_spmm":
            assert p.lanes >= 2   # the warp's row pointers: 32/L + 1 lanes
            assert p.batch in (1, 2, 4) and p.batch <= p.lanes
            assert p.batch * f <= 256 or p.batch == 1
        else:
            assert p.lanes <= 8 and p.batch == 1


@pytest.mark.parametrize("kernel", ["csr_spmm", "edge_sddmm"])
def test_plans_are_pure_cached_and_refuse_empty_rows(kernel):
    """The same (F, dtype) gives the same plan object (the wrappers ask at
    every call); F < 1 raises."""
    rule = RULES[kernel]
    for dtype in DTYPES:
        assert rule(64, dtype) is rule(64, dtype)
        assert rule(64, dtype) == RULES[kernel].__wrapped__(64, dtype)
    hits = rule.cache_info().hits
    rule(21, torch.float32)
    rule(21, torch.float32)
    assert rule.cache_info().hits > hits
    for f in (0, -1):
        with pytest.raises(ValueError, match="row of"):
            rule(f, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["csr_spmm", "edge_sddmm"])
def test_the_sources_build_every_plan_and_the_card_tests_reach_it(kernel,
                                                                  dtype):
    """Over F = 1..4096 the rule's plans are the C source's instances, no
    more and no fewer; chip_smoke.py's widths are among them, and the card
    tests' widths (ROW_WIDTHS) reach each of them."""
    built = source_instances(kernel, dtype)
    assert built
    rule = RULES[kernel]
    assert {instance(kernel, rule(f, dtype)) for f in range(1, 4097)} == built
    assert {instance(kernel, rule(f, dtype)) for f in SMOKE_WIDTHS} <= built
    assert {instance(kernel, rule(f, dtype)) for f in ROW_WIDTHS} == built


@pytest.mark.parametrize("kernel,f,dtype,want", [
    ("csr_spmm", 64, torch.float32, (4, 2, 8, 4)),
    ("csr_spmm", 21, torch.float32, (1, 4, 8, 4)),
    ("csr_spmm", 128, torch.float32, (4, 2, 16, 2)),
    ("csr_spmm", 64, torch.bfloat16, (8, 1, 8, 4)),
    ("csr_spmm", 21, torch.bfloat16, (1, 4, 8, 4)),
    ("csr_spmm", 128, torch.bfloat16, (8, 1, 16, 2)),
    ("edge_sddmm", 64, torch.float32, (4, 4, 4, 1)),
    ("edge_sddmm", 21, torch.float32, (1, 8, 2, 1)),
    ("edge_sddmm", 128, torch.float32, (4, 4, 8, 1)),
    ("edge_sddmm", 64, torch.bfloat16, (8, 2, 4, 1)),
    ("edge_sddmm", 128, torch.bfloat16, (8, 2, 8, 1)),
])
def test_plan_at_the_path_widths(kernel, f, dtype, want):
    """(V, VP, L, B) at the VOC GCN path's widths (64 hidden, 21 classes)
    and the lattices' 128: a row of 21 spreads over 8 lanes (csr_spmm) or
    2 (edge_sddmm), and a group takes a row of 64 or 128 in one chunk."""
    p = RULES[kernel](f, dtype)
    assert (p.vec, p.passes, p.lanes, p.batch) == want
    if f != 21:
        assert p.chunks == 1


@pytest.fixture(scope="module")
def graphs():
    return make_voc_superpixels(num_graphs=3, seed=21, mean_nodes=150.0)


@pytest.fixture(scope="module")
def batches(graphs):
    """(JAX batch with a Pallas plan, port batch with a CSR plan), one set
    of graphs packed by each package, padding edges included."""
    jb = jax_pack_batch(graphs, JaxPadBudget.for_dataset(graphs, 3),
                        with_spmm_plan=True)
    tb = pack_batch(graphs, PadBudget.for_dataset(graphs, 3),
                    with_spmm_plan=True).to("cpu")
    assert tb.num_edges_padded > tb.spmm.num_edges   # has padding edges
    return jb, tb


@pytest.mark.parametrize("f", [1, 21, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_csr_spmm_order_is_the_permuted_weights(batches, f, dtype):
    """The transpose with order = t_order equals the transpose of
    w[t_order], bit for bit, through the plain version and the wrapper."""
    p = batches[1].spmm
    rng = np.random.default_rng(f)
    n, e = p.num_nodes, p.col.numel()
    x = torch.tensor(rng.normal(size=(n, f)).astype(np.float32)).to(dtype)
    w = torch.tensor(rng.uniform(0.1, 1.0, e).astype(np.float32))
    want = csr_spmm_plain(x, p.t_row_ptr, p.t_col, w[p.t_order])
    for fn in (csr_spmm_plain, csr_spmm):
        got = fn(x, p.t_row_ptr, p.t_col, w, p.t_order)
        assert got.dtype == torch.float32 and got.shape == (n, f)
        assert torch.equal(got, want)


def assert_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(ref).max()),
                                               1e-30))


@pytest.mark.parametrize("f", [5, 21, 64])
def test_spmm_function_dx_through_order_matches_pallas(batches, f):
    """dx of the weighted SpMM on the port's kernel path (SpmmFunction: the
    transpose reads w in t_order) against jax.vjp of the JAX package's
    gather_scatter on spmm_pallas, float32."""
    jb, tb = batches
    n, e = tb.num_nodes_padded, tb.num_edges_padded
    rng = np.random.default_rng(40 + f)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=e).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    prev_j, prev_t = jax_spmm.get_backend(), spmm.get_backend()
    jax_spmm.set_backend("pallas")
    spmm.set_backend("pallas")
    try:
        ref, vjp = jax.vjp(lambda x: jax_spmm.gather_scatter(
            x, jb.senders, jb.receivers, num_nodes=n,
            edge_weight=jnp.asarray(w), plan=jb.spmm), jnp.asarray(x))
        (ref_dx,) = vjp(jnp.asarray(g))
        xt = torch.tensor(x, requires_grad=True)
        out = spmm.gather_scatter(xt, tb.senders, tb.receivers, num_nodes=n,
                                  edge_weight=torch.tensor(w), plan=tb.spmm)
        out.backward(torch.tensor(g))
    finally:
        jax_spmm.set_backend(prev_j)
        spmm.set_backend(prev_t)
    assert_close(out.detach(), ref)
    assert_close(xt.grad, ref_dx)


def test_backward_gathers_nothing_in_t_order(batches, monkeypatch):
    """SpmmFunction's dx hands t_order and the weights as they are to
    csr_spmm, and nothing outside the kernel's call takes the weights in
    t_order."""
    p = batches[1].spmm
    calls, gathers, inside = [], [], [False]
    real_csr_spmm = spmm_kernel.csr_spmm
    real_index_select = torch.Tensor.index_select

    def spy(x, row_ptr, col, w, order=None):
        calls.append((order, w))
        inside[0] = True
        try:
            return real_csr_spmm(x, row_ptr, col, w, order)
        finally:
            inside[0] = False

    def index_select_spy(self, dim, index):
        if not inside[0] and index is p.t_order:
            gathers.append(self.shape)
        return real_index_select(self, dim, index)

    monkeypatch.setattr(spmm_kernel, "csr_spmm", spy)
    monkeypatch.setattr(torch.Tensor, "index_select", index_select_spy)
    rng = np.random.default_rng(3)
    n, e = p.num_nodes, p.col.numel()
    x = torch.tensor(rng.normal(size=(n, 8)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(rng.uniform(0.1, 1.0, e).astype(np.float32))
    SpmmFunction.apply(x, w, p, False).sum().backward()
    # forward (no order), dx (t_order, the weights unpermuted)
    assert [o is p.t_order for o, _ in calls] == [False, True]
    assert torch.equal(calls[1][1], w)
    assert gathers == []
