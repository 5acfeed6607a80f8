"""Walkthrough of the full Graph-HSCN pipeline, stage by stage, on the
PyTorch/CUDA port: the counterpart of ``examples/hscn_walkthrough.py``
(the reference's exploratory notebook, notebooks/01-hetero.ipynb), with its
stages and sizes.

    python -m graph_hscn_tpu_torch.examples.hscn_walkthrough      # the card
    python -m graph_hscn_tpu_torch.examples.hscn_walkthrough --device cpu

Stages: SCN MinCUT clustering and the cluster occupancy; the virtual-node
rewrite of an example batch; the HSCN fit on host batches; the
edge-partitioned HSCN pipeline at ``mesh.shape: [-1]`` (one rank a device,
here one); the HSCN with the virtual feedback channel.  Each stage is a
function of the device and its sizes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from graph_hscn_tpu_torch.config.config import (DataConfig, HSCNConfig,
                                                OptimConfig, TrainingConfig,
                                                parse_config)
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.hscn import (build_hscn,
                                              virtual_node_features)
from graph_hscn_tpu_torch.models.scn import build_scn
from graph_hscn_tpu_torch.runner import resolve_device, run_experiment
from graph_hscn_tpu_torch.train.clustering import train_clustering
from graph_hscn_tpu_torch.train.loop import FitResult, fit
from graph_hscn_tpu_torch.utils.logger import Logger

HSCN_CFG = HSCNConfig(activation="relu", num_clusters=4, cluster_epochs=3,
                      mp_units=[16])
OPTIM_CFG = OptimConfig(optim_type="adamW", lr=0.005, weight_decay=5e-4)


def stage_data(logger, num_graphs: int = 64) -> DataModule:
    """Stage 0: peptides-func molecular graphs, batches of 8."""
    dm = DataModule.from_config(DataConfig(dataset_name="peptides_func",
                                           batch_size=8,
                                           num_graphs=num_graphs))
    logger.info(f"{len(dm.graphs)} molecular graphs; mean "
                f"{np.mean([g.num_nodes for g in dm.graphs]):.0f} nodes")
    return dm


def stage_clustering(logger, dm: DataModule, device,
                     hscn_cfg: HSCNConfig = HSCN_CFG) -> list[np.ndarray]:
    """Stage 1: SCN spectral clustering (MinCUT) over the whole dataset;
    returns each graph's cluster ids."""
    scn = build_scn(hscn_cfg, dm.num_features, max_nodes=512,
                    generator=torch.Generator().manual_seed(0)).to(device)
    clusters, _ = train_clustering(logger, dm, scn, hscn_cfg, OPTIM_CFG,
                                   device=device)
    sizes = np.bincount(np.concatenate(clusters),
                        minlength=hscn_cfg.num_clusters)
    logger.info(f"cluster occupancy across the dataset: {sizes.tolist()}")
    return clusters


def stage_rewrite(logger, dm: DataModule, clusters, device,
                  num_clusters: int = 4) -> tuple[int, int]:
    """Stage 2: the virtual-node rewrite, tensor ops on an example batch.
    Returns (active virtual nodes, virtual-node slots)."""
    dm.graphs = [g.replace(cluster=c) for g, c in zip(dm.graphs, clusters)]
    x_v, v_active, _ = virtual_node_features(
        dm.example_batch().to(device), num_clusters)
    active = int(v_active.sum())
    logger.info(f"virtual nodes in example batch: {active} active of "
                f"{x_v.shape[0]} slots")
    return active, x_v.shape[0]


def stage_fit(logger, dm: DataModule, device, epochs: int = 5,
              hscn_cfg: HSCNConfig = HSCN_CFG) -> FitResult:
    """Stages 3+4: the HSCN trained on the cluster-annotated batches."""
    model = build_hscn(hscn_cfg, dm.num_features, dm.num_classes,
                       generator=torch.Generator().manual_seed(0))
    training_cfg = TrainingConfig(model_type="hscn", loss_fn="cross_entropy",
                                  metric="ap", epochs=epochs, eval_period=2,
                                  patience=50, min_delta=0.0)
    result = fit(model.to(device),
                 lambda epoch: dm.train_batches(epoch_seed=dm.seed + epoch),
                 dm.eval_batches("val"), dm.eval_batches("test"),
                 OPTIM_CFG, training_cfg, logger, device)
    logger.info(f"done: val AP "
                f"{result.history[-1].get('validation_perf', 0):.3f}")
    return result


def _hscn_raw(dataset: str, batch_size: int, num_graphs: int,
              num_clusters: int, loss_fn: str, metric: str,
              epochs: int, cluster_epochs: int, **hscn) -> dict:
    return {
        "data": {"dataset_name": dataset, "batch_size": batch_size,
                 "num_graphs": num_graphs},
        "hscn": {"activation": "relu", "hidden_channels": 8,
                 "num_layers": 2, "num_clusters": num_clusters,
                 "cluster_epochs": cluster_epochs, "mp_units": [8], **hscn},
        "optim": {"optim_type": "adamW", "lr": 0.01, "weight_decay": 5e-4},
        "training": {"model_type": "hscn", "use_wandb": False,
                     "loss_fn": loss_fn, "metric": metric,
                     "max_epochs": epochs, "eval_period": 2,
                     "min_delta": 0.0, "patience": 50},
    }


def stage_giant(logger, device, num_graphs: int = 12, epochs: int = 4,
                cluster_epochs: int = 2) -> FitResult:
    """The same pipeline at giant-graph scale: with
    ``mesh.edge_partition`` each split is one batch whose node blocks
    spread over the ranks; the MinCUT clustering and the hetero conv both
    exchange halos (parallel/sharded_scn.py, parallel/sharded_hscn.py).
    ``mesh.shape: [-1]`` takes every rank of the group, one here."""
    raw = _hscn_raw("voc_superpixels", 4, num_graphs, 4,
                    "softmax_cross_entropy", "f1", epochs, cluster_epochs)
    raw["mesh"] = {"axes": ["data"], "shape": [-1], "edge_partition": True}
    result = run_experiment(parse_config(raw), device=device)
    logger.info(f"giant-graph HSCN pipeline: val F1 "
                f"{result.history[-1].get('validation_perf', 0):.3f}")
    return result


def stage_feedback(logger, device, num_graphs: int = 32, epochs: int = 4,
                   cluster_epochs: int = 2) -> FitResult:
    """The virtual->local feedback channel: the reference's HSCN routes
    nothing back from virtual to local nodes, so its virtual pathway
    cannot move a prediction (quirk #17); ``hscn.virtual_feedback`` adds
    a v->l projection a layer, zero at init, so that the model starts as
    the reference's and training grows the channel where it helps."""
    raw = _hscn_raw("peptides_func", 8, num_graphs, 3, "cross_entropy",
                    "ap", epochs, cluster_epochs, virtual_feedback=True)
    result = run_experiment(parse_config(raw), device=device)
    logger.info(f"HSCN with virtual feedback: val AP "
                f"{result.history[-1].get('validation_perf', 0):.3f}")
    return result


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; 'cpu' for a CPU "
                             "run)")
    device = resolve_device(parser.parse_args(argv).device)
    logger = Logger(metric_name="ap")
    try:
        dm = stage_data(logger)
        clusters = stage_clustering(logger, dm, device)
        active, slots = stage_rewrite(logger, dm, clusters, device)
        return {"clusters": clusters, "virtual_nodes": (active, slots),
                "fit": stage_fit(logger, dm, device),
                "giant": stage_giant(logger, device),
                "feedback": stage_feedback(logger, device)}
    finally:
        logger.finish()


if __name__ == "__main__":
    main()
