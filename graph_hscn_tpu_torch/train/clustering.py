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
device-resident path assembles slotted batches on the device; as the JAX
package runs each epoch and the assignment pass as one ``lax.scan``, it
runs the MinCUT step and the assignment step row by row through
``device_data.RowSteps``: on the card each is captured once as a CUDA graph
and replayed, on the CPU it runs eagerly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from graph_hscn_tpu_torch.data.batching import iter_batches
from graph_hscn_tpu_torch.train.device_data import (DeviceDataset, RowSteps,
                                                    epoch_permutation,
                                                    resolve_capture,
                                                    row_buffers)
from graph_hscn_tpu_torch.train.optimizers import build_optimizer


def train_clustering(logger, dm, scn, hscn_cfg, optim_cfg, seed: int = 0,
                     device: torch.device | str = "cuda"
                     ) -> tuple[list[np.ndarray], list[float]]:
    """Train ``scn`` (on ``device``) over ``dm.graphs`` for
    ``hscn_cfg.cluster_epochs`` epochs.  Returns (one int32 array of
    cluster ids a graph, in dataset order; each epoch's mean loss)."""
    opt = build_optimizer(scn.parameters(), optim_cfg.optim_type,
                          optim_cfg.lr, optim_cfg.weight_decay)
    scn.train()
    means = []
    for epoch in range(hscn_cfg.cluster_epochs):
        t0 = time.time()
        losses = []
        for batch in iter_batches(dm.graphs, dm.batch_size, dm.budget,
                                  shuffle=True,
                                  rng=np.random.default_rng(seed + epoch),
                                  slot_nodes=dm.slot_nodes):
            _, mc, o = scn(batch.to(device))
            loss = mc + o
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        means.append(float(torch.stack(losses).mean()))
        logger.info(f"Clustering epoch {epoch}: loss={means[-1]:.4f} "
                    f"({time.time() - t0:.2f}s)")
    scn.eval()
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
    return clusters, means


def train_clustering_device(logger, ds: DeviceDataset, batch_size: int, scn,
                            hscn_cfg, optim_cfg, seed: int = 0,
                            capture: bool | None = None
                            ) -> tuple[DeviceDataset, list[float]]:
    """Clustering over a device-resident dataset: every epoch visits all
    of it in ``epoch_permutation(NG, batch_size, seed + epoch)`` order;
    then the assignment pass (the JAX ``infer_all``) writes ``argmax_k s``
    of every row into a static [NB, B, slot] buffer, and from there into
    the dataset's ``cluster`` field in dataset order.  ``capture`` as in
    ``loop.fit_on_device_dataset``: None captures the MinCUT step and the
    assignment step on a CUDA device, False runs them eagerly there (with
    the same capturable optimizer).  Returns (the dataset with its
    clusters, each epoch's mean loss)."""
    NG = ds.num_graphs
    dev = ds.nodes.device
    capture = resolve_capture(capture, dev)
    opt = build_optimizer(scn.parameters(), optim_cfg.optim_type,
                          optim_cfg.lr, optim_cfg.weight_decay,
                          capturable=dev.type == "cuda")
    order = epoch_permutation(NG, batch_size, 0, shuffle=False)
    rows, counter, pool = row_buffers(len(order), batch_size, dev, capture)

    def mincut_step(batch):
        _, mc, o = scn(batch)
        loss = mc + o
        opt.zero_grad()
        loss.backward()
        opt.step()
        return (loss.detach(),)

    @torch.no_grad()
    def assign_step(batch):
        s, _, _ = scn(batch)
        return (s.argmax(-1).reshape(batch_size, -1).to(torch.int32),)

    train_epoch = RowSteps(mincut_step, ds, rows, counter, capture, pool)
    infer_all = RowSteps(assign_step, ds, rows, counter, capture, pool)
    scn.train()
    means = []
    for epoch in range(hscn_cfg.cluster_epochs):
        t0 = time.time()
        (losses,) = train_epoch(epoch_permutation(NG, batch_size,
                                                  seed + epoch))
        means.append(float(losses.mean()))
        logger.info(f"Clustering epoch {epoch}: loss={means[-1]:.4f} "
                    f"({time.time() - t0:.2f}s)")
    scn.eval()
    (preds,) = infer_all(order)                       # [NB, B, slot]
    flat = preds.reshape(-1, ds.slot)
    ids = order.reshape(-1)
    keep = np.flatnonzero(ids >= 0)
    cluster = torch.zeros(NG, ds.slot, dtype=torch.int32, device=dev)
    cluster.index_copy_(0, torch.from_numpy(ids[keep]).long().to(dev),
                        flat.index_select(0, torch.from_numpy(keep).to(dev)))
    return ds.replace(cluster=cluster), means
