"""SCN clustering pre-training (stage 1 of the HSCN pipeline); the
counterpart of ``graph_hscn_tpu/train/clustering.py``.

The whole padded batch takes one optimizer step on ``mc_loss + o_loss``
(the reference steps a graph at a time, train_clustering.py:20-70).
Clustering trains on the full dataset, train+val+test (the reference's
main.py:107 passes all of it), shuffled each epoch with
``np.random.default_rng(seed + epoch)``.  Then one inference pass assigns
``argmax_k s`` to every node.

The host path packs its batches without a CSR plan, as the JAX package's
does, so SCN's aggregation takes plain ops and no kernel runs.  The
device-resident path assembles slotted batches on the device, an epoch a
Python loop over the permutation's rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from graph_hscn_tpu_torch.data.batching import iter_batches
from graph_hscn_tpu_torch.train.device_data import (DeviceDataset, assemble,
                                                    epoch_permutation)
from graph_hscn_tpu_torch.train.optimizers import build_optimizer


def _train_epochs(logger, scn, optim_cfg, epochs: int, batches_of,
                  ) -> list[float]:
    """``epochs`` epochs of MinCUT steps over ``batches_of(epoch)``;
    returns each epoch's mean loss."""
    opt = build_optimizer(scn.parameters(), optim_cfg.optim_type,
                          optim_cfg.lr, optim_cfg.weight_decay)
    scn.train()
    means = []
    for epoch in range(epochs):
        t0 = time.time()
        losses = []
        for batch in batches_of(epoch):
            _, mc, o = scn(batch)
            loss = mc + o
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        means.append(float(torch.stack(losses).mean()))
        logger.info(f"Clustering epoch {epoch}: loss={means[-1]:.4f} "
                    f"({time.time() - t0:.2f}s)")
    scn.eval()
    return means


def train_clustering(logger, dm, scn, hscn_cfg, optim_cfg, seed: int = 0,
                     device: torch.device | str = "cuda"
                     ) -> tuple[list[np.ndarray], list[float]]:
    """Train ``scn`` (on ``device``) over ``dm.graphs`` for
    ``hscn_cfg.cluster_epochs`` epochs.  Returns (one int32 array of
    cluster ids a graph, in dataset order; each epoch's mean loss)."""
    losses = _train_epochs(
        logger, scn, optim_cfg, hscn_cfg.cluster_epochs,
        lambda epoch: (b.to(device) for b in iter_batches(
            dm.graphs, dm.batch_size, dm.budget, shuffle=True,
            rng=np.random.default_rng(seed + epoch),
            slot_nodes=dm.slot_nodes)))
    logger.info("Generating cluster assignments...")
    clusters: list[np.ndarray] = []
    with torch.no_grad():
        for batch in iter_batches(dm.graphs, dm.batch_size, dm.budget,
                                  shuffle=False, slot_nodes=dm.slot_nodes):
            s, _, _ = scn(batch.to(device))
            assign = s.argmax(-1).cpu().numpy()
            ng, nm = batch.node_graph, batch.node_mask
            for gi in range(int(batch.graph_mask.sum())):
                clusters.append(assign[nm & (ng == gi)].astype(np.int32))
    if len(clusters) != len(dm.graphs):
        raise RuntimeError(f"{len(clusters)} cluster arrays for "
                           f"{len(dm.graphs)} graphs")
    return clusters, losses


def train_clustering_device(logger, ds: DeviceDataset, batch_size: int, scn,
                            hscn_cfg, optim_cfg, seed: int = 0
                            ) -> tuple[DeviceDataset, list[float]]:
    """Clustering over a device-resident dataset: every epoch visits all
    of it in ``epoch_permutation(NG, batch_size, seed + epoch)`` order;
    then the assignments [NG, slot] are written back into the dataset's
    ``cluster`` field, in dataset order.  Returns (the dataset with its
    clusters, each epoch's mean loss)."""
    NG = ds.num_graphs
    dev = ds.nodes.device

    def rows(epoch: int):
        perm = torch.from_numpy(epoch_permutation(NG, batch_size,
                                                  seed + epoch)).to(dev)
        return (assemble(ds, row) for row in perm)

    losses = _train_epochs(logger, scn, optim_cfg, hscn_cfg.cluster_epochs,
                           rows)
    order = epoch_permutation(NG, batch_size, 0, shuffle=False)
    with torch.no_grad():
        preds = torch.stack([
            scn(assemble(ds, row))[0].argmax(-1).reshape(len(row), -1)
            for row in torch.from_numpy(order).to(dev)])   # [NB, B, slot]
    flat = preds.reshape(-1, ds.slot)
    idx = torch.from_numpy(order.reshape(-1)).to(dev).long()
    cluster = torch.zeros(NG, ds.slot, dtype=torch.int32, device=dev)
    cluster[idx[idx >= 0]] = flat[idx >= 0].to(torch.int32)
    return ds.replace(cluster=cluster), losses
