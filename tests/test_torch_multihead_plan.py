"""The multi-head kernels' launch plan and the folded transpose order
(graph_hscn_tpu_torch/ops/cuda/multihead_kernel.py), on the CPU.

``multihead_plan`` lays a row of H heads of C values over a lane group;
both kernels walk a row by it, so a plan that covers a value twice, or
misses one, is a wrong sum on the card.  ``spmm_mh(..., order=t_order)``
is the function of ``spmm_mh(..., alpha[t_order])``: on the CPU its plain
version, bit for bit (the kernel is held to it in tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from graph_hscn_tpu_torch.data import batching as tb
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import (
    MultiheadPlan, SddmmMhFunction, SpmmMhFunction, multihead_plan, spmm_mh)
from test_torch_cuda import MH_WIDTHS

HC_CASES = [(1, 2), (1, 16), (1, 21), (4, 2), (4, 16), (4, 21)]

# The instances csrc/spmm_mh.cu and csrc/sddmm_mh.cu build (their
# ``dispatch``): (V, VP, row layout, B) by the dtype of x (spmm_mh) or of
# the narrower operand (sddmm_mh).  A plan outside them fails on the card.
INSTANCES = {
    ("spmm_mh", torch.float32): {
        (1, 1, False, 4), (1, 4, False, 4), (2, 1, False, 4),
        (2, 4, False, 1), (2, 4, True, 1), (4, 1, False, 4),
        (4, 2, False, 1), (4, 2, True, 1)},
    ("spmm_mh", torch.bfloat16): {
        (1, 1, False, 4), (1, 4, False, 4), (2, 1, False, 4),
        (2, 4, False, 4), (2, 4, True, 4), (4, 1, False, 4),
        (4, 4, False, 1), (4, 4, True, 1), (8, 1, False, 4),
        (8, 2, False, 1), (8, 2, True, 1)},
    ("sddmm_mh", torch.float32): {
        (1, 1, False, 1), (2, 1, False, 1), (4, 1, False, 1),
        (4, 2, False, 1), (4, 4, False, 1)},
    ("sddmm_mh", torch.bfloat16): {
        (1, 1, False, 1), (2, 1, False, 1), (4, 1, False, 1),
        (8, 1, False, 1)},
}


def instance(p: MultiheadPlan) -> tuple[int, int, bool, int]:
    return p.vec, p.passes, p.row_layout, p.batch


@pytest.fixture(scope="module")
def plan():
    graphs = ts.make_voc_superpixels(num_graphs=3, seed=21, mean_nodes=60.0)
    batch = tb.pack_batch(graphs, tb.PadBudget.for_dataset(graphs, 3),
                          with_spmm_plan=True).to("cpu")
    assert batch.num_edges_padded > batch.spmm.num_edges
    return batch.spmm


def covered(p: MultiheadPlan) -> list[int]:
    """Every value index a group's lanes read over all passes, as the
    kernels compute them (csrc/spmm_mh.cu, csrc/sddmm_mh.cu)."""
    seen = []
    if p.row_layout:
        n = p.heads * p.c // p.vec
        for lane in range(p.lanes):
            for k0 in range(0, n, p.passes * p.lanes):
                for q in range(p.passes):
                    j = k0 + q * p.lanes + lane
                    if j < n:
                        seen.extend(j * p.vec + v for v in range(p.vec))
        return seen
    nv = p.c // p.vec
    S = p.lanes_per_head
    for hp in range(p.head_passes):
        for lane in range(p.lanes):
            h = hp * p.heads_a_pass + lane // S
            for k0 in range(0, nv, p.passes * S):
                for q in range(p.passes):
                    k = k0 + q * S + lane % S
                    if h < p.heads and k < nv:
                        seen.extend(h * p.c + k * p.vec + v
                                    for v in range(p.vec))
    return seen


def heads_of(p: MultiheadPlan, first: int) -> set[int]:
    """The heads of a vector's values."""
    return {(first + v) // p.c for v in range(p.vec)}


@pytest.mark.parametrize("heads", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["spmm_mh", "sddmm_mh"])
def test_plans_cover_the_row_exactly(kernel, heads, dtype):
    """C = 1..64, the plan the kernel takes: lanes x V x passes read every
    value of the row once; V values are at most 16 bytes and divide the
    head (head layout) or the row (row layout), so the row's bytes; a
    vector lies in one head (head layout) or two (row layout); a lane holds
    at most 4 vectors and 64 bytes at once; a group is a power of two of at
    most 32 lanes; the head layout takes the widest vector."""
    esize = dtype.itemsize
    for c in range(1, 65):
        p = multihead_plan(kernel, heads, c, dtype)
        assert (p.heads, p.c) == (heads, c)
        assert sorted(covered(p)) == list(range(heads * c)), (heads, c)
        assert (heads * c * esize) % (p.vec * esize) == 0
        assert p.vec * esize <= 16 and p.passes in (1, 2, 4)
        assert p.passes * p.vec * esize <= 64
        for v in (p.lanes, p.lanes_per_head):
            assert 1 <= v <= 32 and v & (v - 1) == 0
        assert p.lanes % p.lanes_per_head == 0
        assert p.rows_a_warp * p.lanes == 32
        assert p.batch in (1, 4)
        if kernel == "sddmm_mh":   # one thread an (edge, head)
            assert (p.lanes, p.batch) == (1, 1)
        if p.row_layout:
            assert kernel == "spmm_mh" and heads == 4 and p.vec <= c
            assert all(len(heads_of(p, j)) <= 2
                       for j in range(0, heads * c, p.vec))
        else:
            # Twice V would not divide C or pass 16 bytes.
            assert c % p.vec == 0
            assert c % (2 * p.vec) or 2 * p.vec * esize > 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["spmm_mh", "sddmm_mh"])
def test_the_kernels_build_every_plan_and_the_card_tests_reach_it(kernel,
                                                                  dtype):
    """Over H = 1..64 and C = 1..256 the plans are the kernel's instances,
    no more and no fewer, and the card tests' widths (MH_WIDTHS) reach
    each of them."""
    want = INSTANCES[kernel, dtype]
    assert {instance(multihead_plan(kernel, h, c, dtype))
            for h in range(1, 65) for c in range(1, 257)} == want
    assert {instance(multihead_plan(kernel, h, c, dtype))
            for h, c in MH_WIDTHS} == want


@pytest.mark.parametrize("kernel,heads,c,dtype,want", [
    ("spmm_mh", 4, 16, torch.float32, ("head", 4, 2, 2, 8, 1)),
    ("spmm_mh", 4, 21, torch.float32, ("row", 4, 2, 1, 16, 1)),
    ("spmm_mh", 4, 2, torch.float32, ("head", 2, 1, 1, 4, 4)),
    ("spmm_mh", 4, 16, torch.bfloat16, ("head", 8, 2, 1, 4, 1)),
    ("spmm_mh", 4, 21, torch.bfloat16, ("row", 4, 4, 1, 8, 1)),
    ("spmm_mh", 4, 2, torch.bfloat16, ("head", 2, 1, 1, 4, 4)),
    ("spmm_mh", 3, 50, torch.float32, ("head", 2, 4, 8, 32, 1)),
    ("sddmm_mh", 4, 16, torch.float32, ("head", 4, 4, 1, 1, 1)),
    ("sddmm_mh", 4, 21, torch.float32, ("head", 1, 1, 1, 1, 1)),
    ("sddmm_mh", 4, 2, torch.float32, ("head", 2, 1, 1, 1, 1)),
    ("sddmm_mh", 4, 16, torch.bfloat16, ("head", 8, 1, 1, 1, 1)),
])
def test_plan_at_the_gat_widths(kernel, heads, c, dtype, want):
    """(layout, V, VP, S, L, B) at the VOC GAT path's widths (C = 16 hidden,
    21 classes, 2 for the logits) and a wider test row: spmm_mh's row
    layout only where a head has no aligned vector as wide as the row's
    (C = 21), 32 bytes a lane, 4 edges in flight only where a lane's share
    is smaller; sddmm_mh one thread an (edge, head), a float32 head of
    four float4s in flight at once, else one vector."""
    p = multihead_plan(kernel, heads, c, dtype)
    assert ("row" if p.row_layout else "head", p.vec, p.passes,
            p.lanes_per_head, p.lanes, p.batch) == want
    if kernel == "spmm_mh" or dtype == torch.float32 and c != 21:
        assert p.vec_chunks == 1


def test_plan_refuses_an_empty_row_and_other_kernels():
    with pytest.raises(ValueError):
        multihead_plan("spmm_mh", 0, 16, torch.float32)
    with pytest.raises(ValueError, match="kernel"):
        multihead_plan("csr_spmm", 4, 16, torch.float32)


@pytest.mark.parametrize("heads,c", HC_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_mh_order_is_the_permuted_alpha(plan, heads, c, dtype):
    """The transpose with order = t_order equals the transpose of
    alpha[t_order], bit for bit."""
    rng = np.random.default_rng(100 * heads + c)
    n, e = plan.num_nodes, plan.col.numel()
    x = torch.tensor(rng.normal(size=(n, heads * c)).astype(np.float32))
    x = x.to(dtype)
    alpha = torch.tensor(rng.uniform(0.1, 1.0, (e, heads)).astype(np.float32))
    got = spmm_mh(x, alpha, plan.t_row_ptr, plan.t_col, plan.t_order)
    want = spmm_mh(x, alpha[plan.t_order], plan.t_row_ptr, plan.t_col)
    assert got.dtype == torch.float32 and got.shape == (n, heads * c)
    assert torch.equal(got, want)


def test_backwards_gather_nothing_in_t_order(plan, monkeypatch):
    """SpmmMhFunction's dx and SddmmMhFunction's d h_src hand t_order to
    spmm_mh instead of permuting alpha or the cotangent first."""
    from graph_hscn_tpu_torch.ops.cuda import multihead_kernel as mk
    calls = []

    def spy(x, alpha, row_ptr, col, order=None):
        calls.append(order)
        return spmm_mh(x, alpha, row_ptr, col, order)

    monkeypatch.setattr(mk, "spmm_mh", spy)
    rng = np.random.default_rng(3)
    n, e = plan.num_nodes, plan.col.numel()
    x = torch.tensor(rng.normal(size=(n, 8)).astype(np.float32),
                     requires_grad=True)
    a = torch.tensor(rng.uniform(0.1, 1.0, (e, 4)).astype(np.float32),
                     requires_grad=True)
    SpmmMhFunction.apply(x, a, plan).sum().backward()
    hs, hd = (torch.tensor(rng.normal(size=(n, 8)).astype(np.float32),
                           requires_grad=True) for _ in range(2))
    SddmmMhFunction.apply(hs, hd, plan, 4).sum().backward()
    # forward, dx (t_order); d h_src (t_order), d h_dst (none)
    assert [o is plan.t_order for o in calls] == [False, True, True, False]
