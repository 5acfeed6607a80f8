"""The port's edge-partition host plans and sharded SpMM programs
(graph_hscn_tpu_torch/parallel/edge_partition.py, parallel/mesh.py)
against the JAX package's on the same inputs.

- The host plans (numpy on both sides) are EQUAL to JAX's at D = 1, 2, 4
  and 8: the receiver partition, every key of the halo plan (``eidx_*``
  too), the Cuthill-McKee order, the node reorder and the receiver re-sort.
- The rank's local-edge ``CsrPlan`` through ``csr_spmm_plain`` (the
  kernel's plain version, forward and transpose) equals the plain gather
  and ``index_add_`` over the same edges within 1e-6 * max|ref|.
- The v1, v2 and v3 sharded SpMM programs at D = 2 and 4 (gloo ranks, one
  process each, ``tests/torch_dist.py``) against JAX's
  ``make_sharded_spmm*`` on a D-device CPU mesh within 1e-5 * max|ref|
  (float sums in another order); MinCUT pooling's contractions
  (``make_sharded_mincut_contractions``) likewise.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist
from graph_hscn_tpu.parallel import edge_partition as jep
from graph_hscn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import csr_spmm_plain
from graph_hscn_tpu_torch.ops.segment import segment_sum
from graph_hscn_tpu_torch.parallel import edge_partition as ep
from graph_hscn_tpu_torch.parallel import mesh as pmesh
from sharded_jax import voc_batch

DEVICES = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _edges(D):
    b = voc_batch(D, num_graphs=3, seed=5, mean_nodes=150)
    return (b["senders"], b["receivers"], b["edge_mask"],
            b["node_feat"].shape[0], b)


def _reordered(D):
    """A batch whose node order is Cuthill-McKee's and whose edges are
    re-sorted by receiver (JAX's functions), with its node arrays."""
    snd, rcv, em, n, b = _edges(D)
    perm = jep.locality_reorder(snd, rcv, em, n, node_mask=b["node_mask"])
    s, r, x = jep.apply_node_reorder(perm, snd, rcv, b["node_feat"])
    s, r, em, _ = jep.sort_edges_by_receiver(s, r, em, n)
    return s, r, em, n, x


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("D", DEVICES)
def test_partition_edges_by_receiver_equals_jax(D):
    snd, rcv, em, n, _ = _edges(D)
    _equal(ep.partition_edges_by_receiver(snd, rcv, em, n, D),
           jep.partition_edges_by_receiver(snd, rcv, em, n, D))


@pytest.mark.parametrize("D", DEVICES)
def test_plan_halo_exchange_equals_jax(D):
    """Every key, on the packed batch and on its reordered twin."""
    for snd, rcv, em, n in (_edges(D)[:4], _reordered(D)[:4]):
        want = jep.plan_halo_exchange(snd, rcv, em, n, D)
        got = ep.plan_halo_exchange(snd, rcv, em, n, D)
        assert set(want) >= {"eidx_loc", "eidx_hal", "send_idx"}
        _equal(got, want)


@pytest.mark.parametrize("D", DEVICES)
def test_locality_reorder_equals_jax(D):
    snd, rcv, em, n, b = _edges(D)
    for mask in (b["node_mask"], None):
        _equal(ep.locality_reorder(snd, rcv, em, n, node_mask=mask),
               jep.locality_reorder(snd, rcv, em, n, node_mask=mask))


@pytest.mark.parametrize("D", DEVICES)
def test_apply_node_reorder_equals_jax(D):
    snd, rcv, em, n, b = _edges(D)
    perm = jep.locality_reorder(snd, rcv, em, n, node_mask=b["node_mask"])
    arrays = (b["node_feat"], b["node_y"], b["node_mask"])
    _equal(ep.apply_node_reorder(perm, snd, rcv, *arrays),
           jep.apply_node_reorder(perm, snd, rcv, *arrays))


@pytest.mark.parametrize("D", DEVICES)
def test_sort_edges_by_receiver_equals_jax(D):
    snd, rcv, em, n, b = _edges(D)
    perm = jep.locality_reorder(snd, rcv, em, n, node_mask=b["node_mask"])
    s, r = jep.apply_node_reorder(perm, snd, rcv)
    _equal(ep.sort_edges_by_receiver(s, r, em, n),
           jep.sort_edges_by_receiver(s, r, em, n))


@pytest.mark.parametrize("D", (1, 2, 4))
def test_local_csr_plan_sums_the_local_edges(D):
    """Each rank's local-edge CsrPlan through csr_spmm_plain (forward, and
    the transpose with the weights read in t_order) equals the plain sums
    over the same edges, within 1e-6 * max|ref|; on the reordered batch
    too (the plan needs the receiver re-sort, checked below)."""
    rng = np.random.default_rng(D)
    for snd, rcv, em, n in (_edges(D)[:4], _reordered(D)[:4]):
        plan = ep.plan_halo_exchange(snd, rcv, em, n, D)
        nb = plan["block_size"]
        for rank in range(D):
            p = ep.local_csr_plan(plan, rank).to("cpu")
            s = torch.from_numpy(plan["snd_loc"][rank]).long()
            r = torch.from_numpy(plan["rcv_loc"][rank]).long()
            m = torch.from_numpy(plan["mask_loc"][rank])
            w = torch.where(m, torch.from_numpy(rng.uniform(
                0.5, 1.5, m.shape[0]).astype(np.float32)), 0.0)
            x = torch.from_numpy(rng.normal(size=(nb, 16)).astype(
                np.float32))
            assert p.num_edges == int(m.sum())
            for got, want in (
                    (csr_spmm_plain(x, p.row_ptr, p.col, w),
                     segment_sum(x[s] * w[:, None], r, nb)),
                    (csr_spmm_plain(x, p.t_row_ptr, p.t_col, w, p.t_order),
                     segment_sum(x[r] * w[:, None], s, nb))):
                tol = 1e-6 * float(want.abs().max())
                assert float((got - want).abs().max()) <= tol


def test_local_csr_plan_needs_the_receiver_resort():
    """After apply_node_reorder the edges are no longer receiver-sorted:
    the CSR plan refuses them (the JAX package's windowed plans once went
    silently infeasible there), and sort_edges_by_receiver restores it."""
    snd, rcv, em, n, b = _edges(2)
    perm = ep.locality_reorder(snd, rcv, em, n, node_mask=b["node_mask"])
    s, r = ep.apply_node_reorder(perm, snd, rcv)
    with pytest.raises(ValueError, match="receiver-sorted"):
        ep.local_csr_plan(ep.plan_halo_exchange(s, r, em, n, 2), 0)
    s, r, m, _ = ep.sort_edges_by_receiver(s, r, em, n)
    ep.local_csr_plan(ep.plan_halo_exchange(s, r, m, n, 2), 0)


@pytest.mark.parametrize("D", (2, 4))
def test_sharded_spmm_programs_match_jax(D, tmp_path):
    """v1 (all-gather), v2 (targeted halo) and v3 (halo overlapped with
    the local sum) on D gloo ranks against JAX's three programs on D CPU
    devices; every rank's block, within 1e-5 * max|ref|."""
    snd, rcv, em, n, _ = _edges(D)
    x = np.random.default_rng(7).normal(size=(n, 24)).astype(np.float32)
    outs = torch_dist.spawn("spmm_programs", D, dict(
        x=x, senders=snd, receivers=rcv, edge_mask=em), tmp_path)

    mesh = jax_make_mesh(("data",), (D,), devices=jax.devices()[:D])
    plan = jep.plan_halo_exchange(snd, rcv, em, n, D)
    nb = plan["block_size"]
    snd_d, rcv_d, m_d, _, _ = jep.partition_edges_by_receiver(
        snd, rcv, em, n, D)
    xb = x.reshape(D, nb, -1)
    refs = {
        "v1": jep.make_sharded_spmm(mesh)(
            *jep.shard_arrays(mesh, xb, snd_d, rcv_d, m_d)),
        "v2": jep.make_sharded_spmm_halo(mesh)(*jep.shard_arrays(
            mesh, xb, plan["send_idx"], plan["snd_remap"],
            plan["rcv_local"], plan["mask"])),
        "v3": jep.make_sharded_spmm_overlap(mesh)(*jep.shard_arrays(
            mesh, xb, plan["send_idx"], plan["snd_loc"], plan["rcv_loc"],
            plan["mask_loc"], plan["snd_hal"], plan["rcv_hal"],
            plan["mask_hal"])),
    }
    for version, ref in refs.items():
        ref = np.asarray(ref).reshape(n, -1)
        got = np.concatenate([o[version] for o in outs])
        tol = 1e-5 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol, version
    # Every rank's diagonal halo slots are padding (send local row 0).
    assert not plan["send_idx"][np.arange(D), np.arange(D)].any()


@pytest.mark.parametrize("D", (2, 4))
def test_sharded_mincut_contractions_match_jax(D, tmp_path):
    """S^T X and S^T A S (MinCUT pooling's contractions) on D gloo ranks
    against JAX's ``make_sharded_mincut_contractions`` on D CPU devices
    and the dense products, within 1e-5 * max|ref|, the same on every
    rank."""
    snd, rcv, em, n, _ = _edges(D)
    rng = np.random.default_rng(1)
    s = rng.normal(size=(n, 4)).astype(np.float32)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    outs = torch_dist.spawn("mincut_contractions", D, dict(
        s=s, x=x, senders=snd, receivers=rcv, edge_mask=em), tmp_path)

    mesh = jax_make_mesh(("data",), (D,), devices=jax.devices()[:D])
    snd_d, rcv_d, m_d, nb, _ = jep.partition_edges_by_receiver(
        snd, rcv, em, n, D)
    stx, stas = jep.make_sharded_mincut_contractions(mesh)(
        *jep.shard_arrays(mesh, s.reshape(D, nb, -1), x.reshape(D, nb, -1),
                          snd_d, rcv_d, m_d))
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (rcv[em], snd[em]), 1.0)
    for ref, dense, key in ((stx, s.T @ x, "stx"),
                            (stas, s.T @ a @ s, "stas")):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ref, dense, rtol=0,
                                   atol=1e-5 * np.abs(dense).max())
        for out in outs:
            assert np.abs(out[key] - ref).max() <= 1e-5 * np.abs(ref).max()
        for out in outs[1:]:
            np.testing.assert_array_equal(out[key], outs[0][key])


def test_mesh_shape_against_the_group(tmp_path):
    """-1 resolves against the group's world size; a shape larger than
    the group raises JAX's ValueError; a 1-rank gloo group is made and destroyed by process_group when none
    exists."""
    assert pmesh.resolve_mesh_shape([-1], 4) == [4]
    assert pmesh.resolve_mesh_shape([2, -1], 8) == [2, 4]
    assert not dist.is_initialized()
    with pmesh.process_group(torch.device("cpu")) as device:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert device == torch.device("cpu")
        assert pmesh.resolve_mesh_shape([-1]) == [1]
        mesh = pmesh.make_mesh(("data",), (-1,), device)
        assert (mesh.shape, mesh.rank, mesh.size) == ((1,), 0, 1)
        with pytest.raises(ValueError, match="needs 8 devices, have 1"):
            pmesh.make_mesh(("data",), (8,), device)
        # The exchange and the all-gather on one rank: the identity.
        x = torch.arange(12.0).reshape(6, 2).requires_grad_()
        halo = ep.start_halo(x, torch.tensor([5, 0, 2]))
        table = halo.wait()
        assert torch.equal(table, x.detach()[[5, 0, 2]])
        table.sum().backward()
        assert x.grad[:, 0].tolist() == [1, 0, 1, 0, 0, 1]
        assert torch.equal(ep.all_gather_rows(x.detach()), x.detach())
    assert not dist.is_initialized()
