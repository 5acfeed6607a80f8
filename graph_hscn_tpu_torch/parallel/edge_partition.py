"""Edge-partitioned message passing across the ranks of a process group:
the counterpart of ``graph_hscn_tpu/parallel/edge_partition.py``.

A packed batch is sharded by *contiguous node blocks*: rank d owns node
rows [d*Nb, (d+1)*Nb) and every edge whose RECEIVER lies in its block.
Senders may live on other ranks, so aggregation needs their features (the
"halo").

Host side (numpy, copies of the JAX package's functions, equal to them on
the same inputs): :func:`partition_edges_by_receiver`,
:func:`plan_halo_exchange` (with :func:`_split_local_halo` and the
``eidx_*`` indices), the Cuthill-McKee :func:`locality_reorder`,
:func:`apply_node_reorder` and :func:`sort_edges_by_receiver`.  Every rank
builds the whole plan and keeps its own block (:func:`rank_block`, JAX's
``shard_arrays``).  :func:`local_csr_plan` is JAX's ``local_spmm_plans``:
the ``CsrPlan`` of the rank's local-sender edges, for ``csr_spmm`` and
``spmm_mh``; unlike the TPU's windowed plans it always exists.

Device side: :func:`start_halo` issues the halo ``all_to_all`` (async) and
returns a :class:`Halo` whose ``wait`` yields the rank's [D*H, F] halo
table; its backward is the same exchange of the gradient.  The three
sharded SpMM programs of JAX (v1 all-gather, v2 targeted halo, v3 halo
overlapped with the local aggregation) are :func:`make_sharded_spmm`,
:func:`make_sharded_spmm_halo` and :func:`make_sharded_spmm_overlap`;
MinCUT pooling's contractions, :func:`make_sharded_mincut_contractions`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import CsrPlan, csr_plan
from graph_hscn_tpu_torch.ops.segment import segment_sum


def partition_edges_by_receiver(senders: np.ndarray, receivers: np.ndarray,
                                edge_mask: np.ndarray, num_nodes: int,
                                num_devices: int):
    """Host-side: split edges into per-device groups by receiver block.

    Returns (senders [D, Eb], receivers_local [D, Eb], mask [D, Eb],
    block_size, edge ids [D, Eb]) with per-device edge arrays padded to a
    common length (padding edges point at local row 0 with mask False).
    """
    assert num_nodes % num_devices == 0, (
        f"num_nodes {num_nodes} must divide evenly across {num_devices} "
        "devices — pad the batch budget accordingly")
    nb = num_nodes // num_devices
    owner = receivers // nb
    eids = np.arange(senders.shape[0], dtype=np.int32)
    groups_s, groups_r, groups_m, groups_e = [], [], [], []
    for d in range(num_devices):
        sel = (owner == d) & edge_mask
        groups_s.append(senders[sel])
        groups_r.append(receivers[sel] - d * nb)
        groups_m.append(np.ones(sel.sum(), bool))
        groups_e.append(eids[sel])
    eb = max(len(g) for g in groups_s)
    eb = ((eb + 127) // 128) * 128 if eb else 128
    D = num_devices
    out_s = np.zeros((D, eb), np.int32)
    out_r = np.zeros((D, eb), np.int32)
    out_m = np.zeros((D, eb), bool)
    out_e = np.zeros((D, eb), np.int32)
    for d in range(D):
        k = len(groups_s[d])
        out_s[d, :k] = groups_s[d]
        out_r[d, :k] = groups_r[d]
        out_m[d, :k] = groups_m[d]
        out_e[d, :k] = groups_e[d]
    return out_s, out_r, out_m, nb, out_e


def plan_halo_exchange(senders: np.ndarray, receivers: np.ndarray,
                       edge_mask: np.ndarray, num_nodes: int,
                       num_devices: int):
    """Host-side plan for the targeted (v2) halo exchange.

    For each (owner o, needer d) pair, the set of o-local node ids whose
    features d needs (senders of d's edges living in o's block), padded to a
    uniform halo width H (a multiple of 8; padding slots send local row 0
    and no edge reads them).  Each device's edge senders are remapped to
    point into ``concat([own block, halo buffer])``.

    Returns dict with:
      send_idx   [D, D, H]  local ids device o sends to device d
                            (row o = what o sends, one slot per dest)
      snd_remap  [D, Eb]    per-device sender index into [Nb + D*H] rows
      rcv_local  [D, Eb], mask [D, Eb], block_size, halo_width
    plus the local/halo split of the same edges (the v3 overlap path):
      snd_loc [D, El], rcv_loc [D, El], mask_loc [D, El]   (own-block ids)
      snd_hal [D, Eh], rcv_hal [D, Eh], mask_hal [D, Eh]   (halo-table ids)
    plus ``eidx_loc [D, El]`` / ``eidx_hal [D, Eh]``: each group edge's
    index into the ORIGINAL edge array (per-edge data, such as GatedGCN's
    edge features, is gathered into the same per-device layout with them).
    """
    assert num_nodes % num_devices == 0
    nb = num_nodes // num_devices
    D = num_devices
    snd_d, rcv_d, mask_d, _, eidx_d = partition_edges_by_receiver(
        senders, receivers, edge_mask, num_nodes, D)
    eb = snd_d.shape[1]

    # needed[d][o] = sorted unique global ids in o's block needed by d;
    # o == d is empty (own-block senders are read locally, no exchange).
    needed = [[np.unique(snd_d[d][(mask_d[d]) &
                                  (snd_d[d] // nb == o)])
               if o != d else np.zeros((0,), np.int64)
               for o in range(D)] for d in range(D)]
    H = max((len(ids) for row in needed for ids in row), default=1)
    H = max(((H + 7) // 8) * 8, 8)

    send_idx = np.zeros((D, D, H), np.int32)
    for d in range(D):
        for o in range(D):
            ids = needed[d][o]
            send_idx[o, d, :len(ids)] = ids - o * nb   # o-local ids

    # Remap each device's senders into [own Nb | halo D*H] row space, one
    # searchsorted per (needer, owner) pair (``needed[d][o]`` is sorted
    # unique).
    snd_remap = np.zeros((D, eb), np.int32)
    for d in range(D):
        snd = snd_d[d]
        m = mask_d[d]
        owner_of = snd // nb
        own = m & (owner_of == d)
        snd_remap[d, own] = snd[own] - d * nb
        for o in range(D):
            if o == d:
                continue
            sel = m & (owner_of == o)
            if not sel.any():
                continue
            slots = np.searchsorted(needed[d][o], snd[sel])
            snd_remap[d, sel] = nb + o * H + slots
    plan = dict(send_idx=send_idx, snd_remap=snd_remap, rcv_local=rcv_d,
                mask=mask_d, block_size=nb, halo_width=H)
    plan.update(_split_local_halo(snd_remap, rcv_d, mask_d, nb, eidx_d))
    return plan


def local_csr_plan(plan: dict, rank: int) -> CsrPlan:
    """The ``CsrPlan`` of rank ``rank``'s LOCAL-sender edges of a halo
    plan, over its ``block_size`` rows: the kernels' plan for the local
    aggregation.  The local edges keep the batch's receiver-sorted order
    (partition and split preserve it) with their padding last, which is
    what ``csr_plan`` needs; a plan built from edges that are not sorted
    by receiver raises."""
    return csr_plan(plan["snd_loc"][rank], plan["rcv_loc"][rank],
                    plan["mask_loc"][rank], plan["block_size"])


def locality_reorder(senders: np.ndarray, receivers: np.ndarray,
                     edge_mask: np.ndarray, num_nodes: int,
                     node_mask: np.ndarray | None = None) -> np.ndarray:
    """Cuthill-McKee node reordering to shrink the halo exchange.

    Contiguous-block partitioning means halo volume is set entirely by the
    node ordering: an edge is "halo" iff its endpoints land in different
    blocks.  A BFS (Cuthill-McKee) order clusters each neighborhood into a
    narrow index band, so far fewer edges straddle block boundaries and
    ``plan_halo_exchange``'s halo width H (which sets the per-layer
    all_to_all volume D*H*F) drops accordingly.

    Runs scipy's sparse-graph reverse Cuthill-McKee on the real-node
    subgraph.  Padding nodes (node_mask False) are appended at the end,
    keeping real nodes compact.

    Returns ``perm`` with ``perm[new_id] = old_id`` (a bijection over
    ``num_nodes``); apply with :func:`apply_node_reorder`.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    em = np.asarray(edge_mask, bool)
    s = np.asarray(senders)[em].astype(np.int64)
    r = np.asarray(receivers)[em].astype(np.int64)
    real = (np.ones(num_nodes, bool) if node_mask is None
            else np.asarray(node_mask, bool))
    real_ids = np.flatnonzero(real)
    compact = np.full(num_nodes, -1, np.int64)
    compact[real_ids] = np.arange(real_ids.size)
    keep = real[s] & real[r]
    cs, cr = compact[s[keep]], compact[r[keep]]
    if real_ids.size:
        adj = sp.csr_matrix(
            (np.ones(2 * cs.size, np.int8),
             (np.concatenate([cs, cr]), np.concatenate([cr, cs]))),
            shape=(real_ids.size, real_ids.size))
        order = reverse_cuthill_mckee(adj, symmetric_mode=True)
        perm_real = real_ids[np.asarray(order, np.int64)]
    else:
        perm_real = real_ids
    return np.concatenate([perm_real, np.flatnonzero(~real)])


def apply_node_reorder(perm: np.ndarray, senders: np.ndarray,
                       receivers: np.ndarray, *node_arrays):
    """Apply a ``perm[new] = old`` node permutation: edge endpoints are
    remapped through the inverse, node-indexed arrays gathered into the
    new order.  Masked (padding) edge endpoints map like any other id —
    they stay in range and are gated by edge_mask downstream.

    The edge ORDER is unchanged, so after remapping it is no longer sorted
    by (new) receiver, which the CSR plans need: call
    :func:`sort_edges_by_receiver` afterwards."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    new_s = inv[np.asarray(senders)].astype(np.int32)
    new_r = inv[np.asarray(receivers)].astype(np.int32)
    return (new_s, new_r) + tuple(np.asarray(a)[perm] for a in node_arrays)


def sort_edges_by_receiver(senders: np.ndarray, receivers: np.ndarray,
                           edge_mask: np.ndarray, num_nodes: int):
    """Stable receiver sort with masked edges last — restores the
    batcher's edge-order invariant after :func:`apply_node_reorder`.

    Returns (senders, receivers, edge_mask, edge_perm) with
    ``edge_perm[new_pos] = old_pos``; any per-edge side arrays (edge
    features, stored edge indices) must be composed through it.
    """
    em = np.asarray(edge_mask, bool)
    key = np.where(em, np.asarray(receivers), num_nodes)
    eo = np.argsort(key, kind="stable").astype(np.int32)
    return (np.asarray(senders)[eo], np.asarray(receivers)[eo], em[eo],
            eo)


def _split_local_halo(snd_remap, rcv_local, mask, nb, eidx):
    """Split each device's edges into local-sender (id < Nb) and
    halo-sender groups, padded separately to 128-multiples.  Also carries
    each edge's original-array index (for per-edge feature gathers)."""
    D = snd_remap.shape[0]
    groups = {"loc": ([], [], []), "hal": ([], [], [])}
    for d in range(D):
        m = mask[d]
        is_loc = (snd_remap[d] < nb) & m
        is_hal = (snd_remap[d] >= nb) & m
        groups["loc"][0].append(snd_remap[d][is_loc])
        groups["loc"][1].append(rcv_local[d][is_loc])
        groups["loc"][2].append(eidx[d][is_loc])
        groups["hal"][0].append(snd_remap[d][is_hal] - nb)
        groups["hal"][1].append(rcv_local[d][is_hal])
        groups["hal"][2].append(eidx[d][is_hal])

    def pad(ss, rr, ee):
        e = max(max((len(g) for g in ss), default=0), 1)
        e = ((e + 127) // 128) * 128
        s = np.zeros((D, e), np.int32)
        r = np.zeros((D, e), np.int32)
        mk = np.zeros((D, e), bool)
        ei = np.zeros((D, e), np.int32)
        for d in range(D):
            k = len(ss[d])
            s[d, :k] = ss[d]
            r[d, :k] = rr[d]
            mk[d, :k] = True
            ei[d, :k] = ee[d]
        return s, r, mk, ei

    ls, lr, lm, le = pad(*groups["loc"])
    hs, hr, hm, he = pad(*groups["hal"])
    return dict(snd_loc=ls, rcv_loc=lr, mask_loc=lm, eidx_loc=le,
                snd_hal=hs, rcv_hal=hr, mask_hal=hm, eidx_hal=he)


def rank_block(a: np.ndarray, rank: int, num_devices: int) -> np.ndarray:
    """Rank ``rank``'s contiguous block of a node-indexed array (JAX's
    ``shard_arrays`` of the [D, Nb, ...] reshape, for one device)."""
    nb = a.shape[0] // num_devices
    return a[rank * nb:(rank + 1) * nb]


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 of [D*H, F] (slot block d goes to
    rank d), issued with ``async_op``; returns (inbound, work).  The
    inbound table may be read only after ``work.wait()``.  Backward: the
    same exchange of the gradient (the transpose of a permutation of
    blocks is its inverse, which all_to_all is)."""

    @staticmethod
    def forward(ctx, outbound, group):
        ctx.group = group
        inbound = torch.empty_like(outbound)
        work = dist.all_to_all_single(inbound, outbound, group=group,
                                      async_op=True)
        return inbound, work

    @staticmethod
    def backward(ctx, g, _):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class Halo:
    """A halo exchange in flight: :meth:`wait` returns the [D*H, F] table
    (block o = what rank o sent this one)."""

    def __init__(self, inbound: torch.Tensor, work):
        self._inbound, self._work = inbound, work

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._inbound


def start_halo(x_blk: torch.Tensor, send_idx: torch.Tensor,
               group=None) -> Halo:
    """Issue the halo exchange of ``x_blk`` [Nb, F]: ``send_idx`` [D*H]
    (the rank's row of the plan's send_idx, flattened) picks the rows
    each rank needs from this one.  Differentiable; the backward of the
    gather is an ``index_add_`` into the rows sent, and the padding slots
    (local row 0) receive a zero gradient, since no edge reads them."""
    outbound = x_blk.index_select(0, send_idx).contiguous()
    return Halo(*_AllToAll.apply(outbound, group))


def all_gather_rows(x_blk: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's [Nb, F] block, concatenated in rank order: [D*Nb, F]
    (not differentiable)."""
    parts = [torch.empty_like(x_blk)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x_blk.contiguous(), group=group)
    return torch.cat(parts)


def make_sharded_spmm(group=None):
    """v1: f(x_blk [Nb, F], snd [Eb] (global ids), rcv_local [Eb], mask
    [Eb]) -> [Nb, F], the rank's rows of ``out[i] = sum_{e->i}
    x[send[e]]``: the node features all-gathered, then aggregated into
    the owned rows."""

    def per_rank(x_blk, snd, rcv_local, mask):
        x_full = all_gather_rows(x_blk, group)
        msgs = torch.where(mask[:, None], x_full.index_select(0, snd), 0.0)
        return segment_sum(msgs, rcv_local, x_blk.shape[0])

    return per_rank


def make_sharded_spmm_halo(group=None):
    """v2: the same with the targeted halo exchange (plan from
    :func:`plan_halo_exchange`): f(x_blk, send_idx [D*H], snd_remap [Eb],
    rcv_local [Eb], mask [Eb]).  Comms D*H*F a rank instead of N*F."""

    def per_rank(x_blk, send_idx, snd_remap, rcv_local, mask):
        halo = start_halo(x_blk, send_idx, group).wait()
        table = torch.cat([x_blk, halo])
        msgs = torch.where(mask[:, None], table.index_select(0, snd_remap),
                           0.0)
        return segment_sum(msgs, rcv_local, x_blk.shape[0])

    return per_rank


def make_sharded_spmm_overlap(group=None):
    """v3: the halo exchange issued first and waited for last, the
    local-sender aggregation in between (on NCCL the collective runs on
    its own stream meanwhile): f(x_blk, send_idx, snd_loc, rcv_loc, m_loc,
    snd_hal, rcv_hal, m_hal).  The same sum as v2 up to float
    reassociation across the two groups."""

    def per_rank(x_blk, send_idx, snd_loc, rcv_loc, m_loc, snd_hal, rcv_hal,
                 m_hal):
        nb = x_blk.shape[0]
        pending = start_halo(x_blk, send_idx, group)
        msgs = torch.where(m_loc[:, None], x_blk.index_select(0, snd_loc),
                           0.0)
        out = segment_sum(msgs, rcv_loc, nb)
        halo = pending.wait()
        msgs_h = torch.where(m_hal[:, None], halo.index_select(0, snd_hal),
                             0.0)
        return out + segment_sum(msgs_h, rcv_hal, nb)

    return per_rank


def make_sharded_mincut_contractions(group=None):
    """f(s_blk [Nb, K], x_blk [Nb, F], snd [Eb] (global ids), rcv_local
    [Eb], mask [Eb]) -> (S^T X [K, F], S^T A S [K, K]), the same on every
    rank: MinCUT pooling's contractions as the rank's partial products
    summed over the ranks, A S from the all-gathered assignments (not
    differentiable)."""

    def per_rank(s_blk, x_blk, snd, rcv_local, mask):
        stx = s_blk.t() @ x_blk
        s_full = all_gather_rows(s_blk, group)
        msgs = torch.where(mask[:, None], s_full.index_select(0, snd), 0.0)
        a_s = segment_sum(msgs, rcv_local, s_blk.shape[0])
        out = torch.cat([stx, s_blk.t() @ a_s], 1)
        dist.all_reduce(out, group=group)
        return out[:, :x_blk.shape[1]], out[:, x_blk.shape[1]:]

    return per_rank
