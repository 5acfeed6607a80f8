"""One step of every mesh path on tiny shapes, over the ranks of the
default process group: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

    torchrun --nproc_per_node 4 -m graph_hscn_tpu_torch.parallel.dryrun \\
        --device cpu

Every rank runs :func:`dryrun_multichip` (the world an even number of
ranks) and gets the same finite losses: a data-parallel step on an HSCN
and on the slotted GPS, an edge-partitioned GCN step, a checkpoint round
trip under the mesh (rank 0 writes, every rank restores) with an
eval-only pass, a sharded HSCN and SCN step, the ring-attention GPS with
its GCN and GatedGCN local blocks, the sharded GatedGCN, and a step on
the hybrid 2-D mesh (2 rows).  Rank 0 prints them.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from graph_hscn_tpu_torch.config.config import HSCNConfig
from graph_hscn_tpu_torch.data.batching import PadBudget
from graph_hscn_tpu_torch.data.synthetic import (make_peptides_func,
                                                 make_voc_superpixels)
from graph_hscn_tpu_torch.models.gps import GPSModel
from graph_hscn_tpu_torch.models.hscn import build_hscn
from graph_hscn_tpu_torch.parallel.data_parallel import (make_dp_train_step,
                                                         pack_for_devices)
from graph_hscn_tpu_torch.parallel.edge_partition import rank_block
from graph_hscn_tpu_torch.parallel.hybrid import (build_hybrid_split,
                                                  hybrid_block)
from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
from graph_hscn_tpu_torch.parallel.sharded_gcn import (build_sharded_model,
                                                       gather_logits,
                                                       loss_and_grads,
                                                       partition_split)
from graph_hscn_tpu_torch.parallel.sharded_hscn import ShardedHSCN
from graph_hscn_tpu_torch.parallel.sharded_scn import (ShardedSCN,
                                                       scn_loss_and_grads)
from graph_hscn_tpu_torch.train.checkpoint import Checkpointer
from graph_hscn_tpu_torch.train.metrics import METRICS
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

K = 4   # clusters


def _with_clusters(graphs, seed: int):
    rng = np.random.default_rng(seed)
    return [g.replace(cluster=rng.integers(0, K, size=g.num_nodes)
                      .astype(np.int32)) for g in graphs]


def _dp_step(model, graphs, mesh, slot=None) -> float:
    """One AdamW DP step of ``model`` on 2 graphs a rank."""
    budget = PadBudget.for_dataset(graphs, batch_size=2)
    batch = pack_for_devices(graphs, mesh.size, budget, slot_nodes=slot,
                             ranks=[mesh.rank])[0].to(mesh.device)
    opt = build_optimizer(model.parameters(), "adamW", 0.01, 5e-4)
    step = make_dp_train_step(model.to(mesh.device), opt, "cross_entropy",
                              mesh)
    return float(step(batch, 0)[0])


def _sharded(conv: str, blk, heads: int = 2, **kw) -> float:
    """One summed loss and gradient pass of a sharded ``conv`` [14, 8,
    21] on ``blk``."""
    model = build_sharded_model(conv, [14, 8, 21], heads=heads, hidden=8,
                                generator=torch.Generator().manual_seed(0),
                                **kw).to(blk.x.device)
    model.train()
    return float(loss_and_grads(model, blk))


def dryrun_multichip(device: torch.device | str = "cpu") -> dict:
    """Every mesh path once over the default group; returns the losses
    (and the eval-only F1), the same on every rank."""
    device = torch.device(device)
    D = dist.get_world_size()
    if D % 2:
        raise ValueError(f"the hybrid step takes 2 rows: {D} ranks")
    mesh = make_mesh(("data",), (D,), device)
    gen = torch.Generator().manual_seed(0)
    out = {}

    cfg = HSCNConfig(activation="relu", hidden_channels=8, num_layers=2,
                     num_clusters=K)
    out["dp_hscn_loss"] = _dp_step(
        build_hscn(cfg, 9, 10, generator=gen),
        _with_clusters(make_peptides_func(num_graphs=2 * D, seed=1,
                                          mean_nodes=20), 1), mesh)
    gps_graphs = make_peptides_func(num_graphs=2 * D, seed=4, mean_nodes=20)
    slot = ((max(g.num_nodes for g in gps_graphs) + 7) // 8) * 8
    out["gps_dp_loss"] = _dp_step(
        GPSModel(9, 8, 10, 2, num_heads=2, dropout=0.1, generator=gen),
        gps_graphs, mesh, slot)

    vg = make_voc_superpixels(num_graphs=2, seed=3, mean_nodes=120)
    split = partition_split(vg, mesh, reorder=False, graph_ids=True,
                            outdeg=True)
    blk = split.block
    gcn = build_sharded_model("gcn", [14, 8, 21], generator=gen).to(device)
    gcn.train()
    out["edge_partition_loss"] = float(loss_and_grads(gcn, blk))

    # Checkpoint round trip under the mesh: rank 0 writes, every rank
    # restores the same weights bit for bit; their eval-only forward
    # agrees with the saved weights' (on the card within rounding: its
    # scatter-adds sum in no fixed order).
    where = [tempfile.mkdtemp(prefix="dryrun_ckpt_") if mesh.rank == 0
             else None]
    dist.broadcast_object_list(where)
    ck = Checkpointer(where[0])
    saved = {k: v.clone() for k, v in gcn.state_dict().items()}
    if mesh.rank == 0:
        ck.save_latest({"model": saved, "step": 3}, epoch=3)
        ck.wait()
    dist.barrier()
    state, meta = ck.restore("latest", device)
    assert int(meta["epoch"]) == 3, meta
    assert all(torch.equal(state["model"][k], v) for k, v in saved.items()), \
        "restored weights differ"
    before = gather_logits(gcn, blk)
    gcn.load_state_dict(state["model"])
    after = gather_logits(gcn, blk)
    assert float((after - before).abs().max()) <= (
        1e-5 * float(before.abs().max())), "restored forward differs"
    ok = torch.from_numpy(split.node_mask)
    out["eval_f1"] = float(METRICS["f1"](split.node_y[split.node_mask],
                                         after.cpu()[ok].numpy()))
    dist.barrier()
    if mesh.rank == 0:
        shutil.rmtree(where[0])

    clusters = np.random.default_rng(2).integers(
        0, K, size=split.info["rows"]).astype(np.int64)
    hscn = ShardedHSCN(14, 8, 21, 2, K, heads=2, generator=gen).to(device)
    hscn.train()
    out["sharded_hscn_loss"] = float(loss_and_grads(
        hscn, blk, torch.from_numpy(rank_block(clusters, mesh.rank,
                                               D)).to(device)))
    scn = ShardedSCN(14, [8], K, generator=gen).to(device)
    out["sharded_scn_loss"] = float(scn_loss_and_grads(scn, blk))
    assert int(scn.assign(blk).max()) < K

    out["ring_gps_loss"] = _sharded("gps", blk)
    out["ring_gps_gated_loss"] = _sharded("gps", blk, local_conv="gatedgcn")
    out["gatedgcn_ep_loss"] = _sharded("gatedgcn", blk)

    mesh2d = make_mesh(("data", "model"), (2, D // 2), device)
    hg = make_voc_superpixels(num_graphs=4, seed=6, mean_nodes=80)
    hblk = hybrid_block(*build_hybrid_split(hg, 2, D // 2)[:4], mesh2d)
    out["hybrid2d_loss"] = _sharded("gcn", hblk)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    with process_group(torch.device(args.device)) as device:
        out = dryrun_multichip(device)
        if dist.get_rank() == 0:
            print(f"dryrun_multichip({dist.get_world_size()}): ok, " + ", ".join(
                f"{k}={v:.4f}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main()
