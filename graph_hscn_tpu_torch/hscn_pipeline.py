"""The 4-stage HSCN pipeline (the reference's main.py:100-119); the
counterpart of ``graph_hscn_tpu/hscn_pipeline.py``:

  1. SCN clustering pre-train          (train/clustering.py)
  2. the graph rewrite -> clusters      (a field on the graphs, or on the
                                         device dataset; the rewrite itself
                                         is tensor ops in the HSCN forward)
  3. batches with cluster ids
  4. supervised HSCN training           (train/loop.py)

Two routes, as the JAX runner picks them: the host loop ``fit`` over
batches packed on the host (sparse with a CSR plan, or slotted), or the
device-resident dataset, shared by clustering and the HSCN fit.

As in JAX, the device-resident route's HSCN fit logs the train split's
edges a second; the host route's does not.  Stages 1 and 2, on either
route, are the ``setup.clustering`` span (utils/profiling.py).

With a ``Checkpointer`` the HSCN fit saves and resumes as any fit does;
its snapshots hold the HSCN's weights only.  The clusters are not in
them: a resumed run clusters again first, which is deterministic given
``training.seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_hscn_tpu_torch.config.config import ExperimentConfig
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.hscn import build_hscn
from graph_hscn_tpu_torch.models.scn import build_scn
from graph_hscn_tpu_torch.train.clustering import (train_clustering,
                                                   train_clustering_device)
from graph_hscn_tpu_torch.train.device_data import DeviceDataset
from graph_hscn_tpu_torch.train.loop import (FitResult, fit,
                                             fit_on_device_dataset)
from graph_hscn_tpu_torch.utils.profiling import span


def _models(cfg: ExperimentConfig, dm: DataModule, max_nodes: int, device,
            compute_dtype):
    """(SCN, HSCN) on ``device``, their initial weights drawn in turn from
    one generator seeded with ``training.seed``."""
    gen = torch.Generator().manual_seed(cfg.training.seed)
    scn = build_scn(cfg.hscn, dm.num_features, max_nodes=max_nodes,
                    generator=gen)
    model = build_hscn(cfg.hscn, dm.num_features, dm.num_classes,
                       compat_triangular=cfg.compat.vv_triangular_pattern,
                       compat_index_shift=cfg.compat.cluster_index_shift,
                       readout="none" if dm.task_level == "node" else "mean",
                       dtype=compute_dtype, generator=gen)
    return scn.to(device), model.to(device)


def run_hscn_pipeline(cfg: ExperimentConfig, dm: DataModule, logger,
                      device: torch.device, compute_dtype=None,
                      use_device_dataset: bool = False,
                      step_timing: bool = False,
                      checkpointer=None) -> FitResult:
    """Cluster, then train the HSCN on ``device``; the result's
    ``cluster_losses`` are the clustering epochs' mean losses."""
    if use_device_dataset:
        return run_hscn_pipeline_device(cfg, dm, logger, device,
                                        compute_dtype, step_timing,
                                        checkpointer)
    model, cluster_losses = cluster_on_host(cfg, dm, logger, device,
                                            compute_dtype)
    with span("setup.data"):    # the eval batches, with their clusters
        val, test = dm.eval_batches("val"), dm.eval_batches("test")
    result = fit(
        model,
        # A fresh batch composition every epoch, seed + epoch as in the
        # device-resident route.
        lambda epoch: dm.train_batches(epoch_seed=dm.seed + epoch),
        val, test,
        cfg.optim, cfg.training, logger, device,
        node_level=dm.task_level == "node",
        compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
        step_timing=step_timing, checkpointer=checkpointer)
    result.cluster_losses = cluster_losses
    return result


def cluster_on_host(cfg: ExperimentConfig, dm: DataModule, logger,
                    device: torch.device, compute_dtype=None) -> tuple:
    """Stages 1 and 2 on host batches: cluster, and write each graph's
    cluster ids into ``dm.graphs``.  Returns (the HSCN to train, untrained,
    the clustering epochs' mean losses)."""
    scn, model = _models(cfg, dm, _round8(dm.max_nodes_per_graph()), device,
                         compute_dtype)
    with span("setup.clustering"):
        clusters, cluster_losses = train_clustering(
            logger, dm, scn, cfg.hscn, cfg.optim, seed=cfg.training.seed,
            device=device)
        dm.graphs = [g.replace(cluster=c)
                     for g, c in zip(dm.graphs, clusters)]
    return model, cluster_losses


def run_hscn_pipeline_device(cfg: ExperimentConfig, dm: DataModule, logger,
                             device: torch.device, compute_dtype=None,
                             step_timing: bool = False,
                             checkpointer=None) -> FitResult:
    """The device-resident route: one dataset on ``device`` (train, val,
    test in that order) for the clustering pre-train, the assignments
    written back into it, and the HSCN fit.  On the card each stage
    captures its steps as CUDA graphs, which read the dataset by address:
    the fit's are captured on the dataset clustering returns, after the
    clusters are written, and nothing rebuilds it after."""
    splits = {k: dm.split(k) for k in ("train", "val", "test")}
    all_graphs = splits["train"] + splits["val"] + splits["test"]
    ds = DeviceDataset.build(all_graphs, slot=dm.slot_nodes, device=device,
                             with_cluster=True)
    n_tr, n_va = len(splits["train"]), len(splits["val"])
    split_ids = {"train": np.arange(n_tr),
                 "val": np.arange(n_tr, n_tr + n_va),
                 "test": np.arange(n_tr + n_va, len(all_graphs))}
    scn, model = _models(cfg, dm, ds.slot, device, compute_dtype)
    with span("setup.clustering"):
        ds, cluster_losses = train_clustering_device(
            logger, ds, dm.batch_size, scn, cfg.hscn, cfg.optim,
            seed=cfg.training.seed)
        if ds.cluster.is_cuda:      # the assignments in place
            torch.cuda.synchronize(ds.cluster.device)
    result = fit_on_device_dataset(
        model, ds, split_ids, dm.batch_size, cfg.optim, cfg.training,
        logger, device, node_level=dm.task_level == "node",
        compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
        step_timing=step_timing, checkpointer=checkpointer,
        train_edges=sum(g.num_edges for g in splits["train"]))
    result.cluster_losses = cluster_losses
    return result


def _round8(x: int) -> int:
    return ((x + 7) // 8) * 8
