"""Hybrid 2-D parallelism, data-parallel graph groups times
edge-partitioned node blocks: the counterpart of
``graph_hscn_tpu/parallel/hybrid.py``.

A 2-D mesh ``("data", "model")`` of shape (Ddp, Dep): the split is
balanced into Ddp graph GROUPS (:func:`balance_groups`), each group packed
into one padded batch whose node blocks spread over the Dep ranks of its
data row, exactly as the 1-D edge partition (contiguous node blocks,
receiver-owned edges, the halo exchange a layer).  Every group's halo plan
is padded to common widths (:func:`build_hybrid_split`), so the blocks
stack with a leading axis of Ddp*Dep in rank order (group-major); each
rank keeps its own (group, block).

The port's sharded models run unchanged (parallel/sharded_gcn.py,
parallel/sharded_gps.py); their ``Block`` carries two groups: the halo
``all_to_all`` and GPS's ring ride the row group (JAX's ``axis="model"``),
the loss and gradient ``all_reduce`` and the logits' ``all_gather`` span
every rank (JAX's ``grad_axes=("data", "model")``); the loss divides by
the real rows of ALL groups.  On the card the local aggregation takes the
hand kernels on the rank's local CSR plan (B1 for GCN, B6/B7 for GAT), the
port's dispatch rule; JAX's ``fit_hybrid`` attaches no TPU plan and runs
plain segment ops there: the same function.

Copied from JAX as they stand (held by tests in both packages):
``fit_hybrid`` passes no dropout, no compute dtype and no head count (a
hybrid run trains in float32 without dropout and its GAT has one head,
whatever ``mp.dropout``, ``runtime.compute_dtype`` or ``mp.num_heads``
say), and its schedule's horizon is the epoch count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch, round_up
from graph_hscn_tpu_torch.ops.spmm import kernel_enabled
from graph_hscn_tpu_torch.parallel.edge_partition import (
    apply_node_reorder, local_csr_plan, locality_reorder, plan_halo_exchange,
    sort_edges_by_receiver)
from graph_hscn_tpu_torch.parallel.mesh import Mesh
from graph_hscn_tpu_torch.parallel.sharded_gcn import (Block, Split,
                                                       build_sharded_model,
                                                       fit_blocks)

_PLAN_KEYS = ("send_idx", "snd_loc", "rcv_loc", "mask_loc", "snd_hal",
              "rcv_hal", "mask_hal")


def balance_groups(graphs, num_groups: int) -> list[list[int]]:
    """LPT (largest-first) balance of graphs into ``num_groups`` groups by
    node count.  Returns a list of index lists; every group is non-empty
    when len(graphs) >= num_groups."""
    order = np.argsort([-g.num_nodes for g in graphs])
    loads = np.zeros(num_groups)
    groups: list[list[int]] = [[] for _ in range(num_groups)]
    for i in order:
        d = int(np.argmin(loads))
        groups[d].append(int(i))
        loads[d] += graphs[int(i)].num_nodes
    return groups


def _pad_axis(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    if a.shape[axis] == size:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - a.shape[axis])
    return np.pad(a, pad)


def build_hybrid_split(graphs, d_dp: int, d_ep: int, reorder: bool = True):
    """Pack a split into stacked hybrid blocks (numpy, JAX's arrays).

    Returns (plan, x, y, ok, meta): every plan array and x [Ddp*Dep, Nb,
    F], y [Ddp*Dep, Nb, C], ok [Ddp*Dep, Nb] has the leading axis Ddp*Dep
    (group-major, a row-major (Ddp, Dep) reshape), the plan also
    ``gid_blocks`` (group-local graph ids), ``block_size`` and
    ``halo_width`` (the padded H); meta carries the groups' masks, labels
    and edges for the host-side metrics."""
    groups = balance_groups(graphs, d_dp)
    # One shared budget: every group's graphs must fit in one batch.
    need_n = max(sum(graphs[i].num_nodes for i in g) for g in groups) + 1
    need_e = max(sum(graphs[i].num_edges for i in g) for g in groups)
    budget = PadBudget(num_nodes=round_up(need_n, d_ep * 8),
                       num_edges=round_up(max(need_e, 1), 128),
                       num_graphs=max(len(g) for g in groups) + 1)

    per_group = []
    for g in groups:
        # A split smaller than Ddp leaves a group empty: a dummy graph
        # with every node masked out, contributing nothing.
        empty = not g
        b = pack_batch([graphs[i] for i in (g or [0])], budget)
        n = b.num_nodes_padded
        snd, rcv, em = b.senders, b.receivers, b.edge_mask
        x = b.node_feat
        y = (b.node_y if b.node_y is not None
             else np.zeros((n, 1), np.float32))
        ok = b.node_mask
        gid = b.node_graph.astype(np.int32)
        if empty:
            ok = np.zeros_like(ok)
            y = np.zeros_like(y)
        if reorder:
            perm = locality_reorder(snd, rcv, em, n, node_mask=ok)
            snd, rcv, x, y, ok, gid = apply_node_reorder(
                perm, snd, rcv, x, y, ok, gid)
            # The CSR plans need the receiver sort back.
            snd, rcv, em, _ = sort_edges_by_receiver(snd, rcv, em, n)
        plan = plan_halo_exchange(snd, rcv, em, n, d_ep)
        per_group.append((plan, x, y, ok, (snd, rcv, em), gid))

    # Common padded shapes across groups.
    H = max(p["halo_width"] for p, *_ in per_group)
    el = max(p["snd_loc"].shape[1] for p, *_ in per_group)
    eh = max(p["snd_hal"].shape[1] for p, *_ in per_group)
    nb = per_group[0][0]["block_size"]

    stacked: dict[str, list[np.ndarray]] = {k: [] for k in _PLAN_KEYS}
    xs, ys, oks, gids = [], [], [], []
    for plan, x, y, ok, _, gid in per_group:
        hg = plan["halo_width"]
        # Halo-table indices are o*Hg + slot; restride to the padded H.
        snd_hal = plan["snd_hal"]
        snd_hal = (snd_hal // hg) * H + (snd_hal % hg)
        stacked["send_idx"].append(_pad_axis(plan["send_idx"], 2, H))
        for key, width in (("snd_loc", el), ("rcv_loc", el),
                           ("mask_loc", el), ("rcv_hal", eh),
                           ("mask_hal", eh)):
            stacked[key].append(_pad_axis(plan[key], 1, width))
        stacked["snd_hal"].append(_pad_axis(snd_hal, 1, eh))
        xs.append(x.reshape(d_ep, nb, -1))
        ys.append(y.reshape(d_ep, nb, -1))
        oks.append(ok.reshape(d_ep, nb))
        gids.append(gid.reshape(d_ep, nb))

    plan_out = {k: np.concatenate(v, axis=0) for k, v in stacked.items()}
    plan_out["gid_blocks"] = np.concatenate(gids, axis=0)
    plan_out.update(block_size=nb, halo_width=H)
    meta = dict(block_size=nb, halo_width=H, groups=groups,
                node_y=np.concatenate([p[2].reshape(-1, p[2].shape[-1])
                                       for p in per_group], axis=0),
                node_mask=np.concatenate([p[3].reshape(-1)
                                          for p in per_group], axis=0),
                group_edges=[p[4] for p in per_group])
    return (plan_out, np.concatenate(xs, axis=0), np.concatenate(ys, axis=0),
            np.concatenate(oks, axis=0), meta)


def hybrid_block(plan: dict, x, y, ok, mesh: Mesh, use_plan: bool = False,
                 graph_ids: bool = False) -> Block:
    """This rank's ``Block`` of a stacked hybrid split: its row of every
    array (the leading axis is the global rank), the halo over its data
    row, the loss and logits over every rank and every group's real rows;
    with ``use_plan`` its local edges' ``CsrPlan``, with ``graph_ids`` its
    group-local graph ids (GPS)."""
    r = mesh.rank
    return Block(plan, x[r], y[r], ok[r], r, int(ok.sum()), mesh.device,
                 mesh.row_group, local_csr_plan(plan, r) if use_plan else None,
                 split_group=mesh.group,
                 gid=(plan["gid_blocks"][r].astype(np.int64) if graph_ids
                      else None))


def fit_hybrid(dm, mesh: Mesh, mpnn_cfg, optim_cfg, training_cfg, logger,
               checkpointer=None, reorder: bool = True,
               eval_only: str | None = None,
               predictions_sink: dict | None = None,
               step_timing: bool = False):
    """CLI-reachable hybrid training (``mesh.axes: [data, model]``,
    ``mesh.edge_partition: true``; the JAX ``fit_hybrid``): full-batch
    node-level training where each data row owns a balanced group of
    graphs and edge-partitions it over its ranks; ``fit_blocks``' eval
    cadence, early stop and checkpoints, or with ``eval_only`` the
    restored snapshot's ({split: {"loss", metric}}, meta)."""
    if training_cfg.loss_fn != "softmax_cross_entropy":
        raise ValueError("hybrid path computes node-level softmax cross "
                         "entropy; set loss_fn: softmax_cross_entropy")
    d_dp, d_ep = mesh.shape
    conv = mpnn_cfg.conv_type.lower()
    if conv not in ("gcn", "gat", "gps"):
        raise ValueError("hybrid path supports conv_type gcn, gat or gps, "
                         f"got {mpnn_cfg.conv_type!r}")
    if conv == "gps" and mpnn_cfg.gps_local_conv.lower() != "gcn":
        raise ValueError(
            "the hybrid 2-D mesh implements the GCN local block for "
            "GPS; gps_local_conv: gatedgcn runs on the 1-D "
            "edge-partition mesh (mesh.axes: [data]) or single-device "
            "— its receiver-resident edge state is not sharded over "
            "the 2-D group layout")
    use_plan = conv != "gps" and kernel_enabled(
        torch.empty(0, device=mesh.device))
    splits = {}
    for name in ("train", "val", "test"):
        t0 = time.perf_counter()
        plan, x, y, ok, meta = build_hybrid_split(dm.split(name), d_dp, d_ep,
                                                  reorder=reorder)
        blk = hybrid_block(plan, x, y, ok, mesh, use_plan,
                           graph_ids=conv == "gps")
        r = mesh.rank
        info = dict(rows=meta["node_mask"].shape[0],
                    block_rows=meta["block_size"],
                    edges=sum(int(e[2].sum()) for e in meta["group_edges"]),
                    halo_width=meta["halo_width"],
                    local_edges=int(plan["mask_loc"][r].sum()),
                    halo_edges=int(plan["mask_hal"][r].sum()),
                    seconds=time.perf_counter() - t0)
        splits[name] = Split(meta["node_mask"], meta["node_y"], blk, None,
                             info)
        logger.info(f"[hybrid {d_dp}x{d_ep}] {name}: {d_dp} groups x {d_ep} "
                    f"blocks x {meta['block_size']} rows, halo "
                    f"H={meta['halo_width']}")
    if use_plan:
        logger.info("[hybrid] local aggregation: csr_spmm / spmm_mh kernels "
                    "on the rank's block")
    dims = ([dm.num_features]
            + [mpnn_cfg.hidden_channels] * (mpnn_cfg.num_layers - 1)
            + [dm.num_classes])
    # JAX passes the hybrid GAT no head count (one head) and GPS its own.
    model = build_sharded_model(
        conv, dims, heads=mpnn_cfg.num_heads if conv == "gps" else 1,
        generator=torch.Generator().manual_seed(training_cfg.seed),
        hidden=mpnn_cfg.hidden_channels).to(mesh.device)
    return fit_blocks(model, splits, mesh, optim_cfg, training_cfg, logger,
                      checkpointer, eval_only, predictions_sink, step_timing)
