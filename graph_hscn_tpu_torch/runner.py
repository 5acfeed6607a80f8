"""Experiment runner: config -> data -> model -> training.

The counterpart of ``graph_hscn_tpu/runner.py`` (the reference's
run_train, main.py:85-120), single-device MPNN path.  Execution paths are
routed as in the JAX package (runner.py:49-61 and :120-238); the paths of
later slices raise ``NotImplementedError`` naming their ROADMAP item, so no
config falls through to a path it did not ask for.

Runs on ``cuda`` unless the caller passes another device; without a card
that raises.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_hscn_tpu_torch.config import defaults as D
from graph_hscn_tpu_torch.config.config import ExperimentConfig
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.layers import resolve_dtype
from graph_hscn_tpu_torch.models.mpnn import build_mpnn
from graph_hscn_tpu_torch.ops import spmm as spmm_mod
from graph_hscn_tpu_torch.train.loop import FitResult, fit
from graph_hscn_tpu_torch.utils.logger import Logger


def resolve_device(device: torch.device | str | None) -> torch.device:
    """None -> the CUDA card, which must exist; anything else as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' (--device cpu) for a CPU run")
    return device


def set_matmul_precision(precision: str) -> None:
    """``runtime.matmul_precision``: "highest" is full float32 everywhere
    (no TF32 in matmuls or cuDNN); anything else lets both use TF32."""
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("highest" if not tf32 else "high")


def run_experiment(cfg: ExperimentConfig, device=None, log_file=None,
                   step_timing: bool = False) -> FitResult:
    device = resolve_device(device)
    set_matmul_precision(cfg.runtime.matmul_precision)
    compute_dtype = resolve_dtype(cfg.runtime.compute_dtype)
    if cfg.runtime.spmm_backend in ("xla", "pallas"):
        spmm_mod.set_backend(cfg.runtime.spmm_backend)
    if cfg.runtime.debug_nans:
        raise NotImplementedError(
            "runtime.debug_nans (utils/profiling.py): ROADMAP queue A, "
            "item 12")
    if cfg.training.checkpoint_dir:
        raise NotImplementedError(
            "training.checkpoint_dir (train/checkpoint.py): ROADMAP queue A, "
            "item 5")
    logger = Logger(log_file=log_file, metric_name=cfg.training.metric)
    try:
        return _run(cfg, device, compute_dtype, logger, step_timing)
    finally:
        logger.finish()


def _run(cfg, device, compute_dtype, logger, step_timing) -> FitResult:
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    logger.info(f"Dataset {cfg.data.dataset_name}: {len(dm.graphs)} graphs, "
                f"budget nodes={dm.budget.num_nodes} "
                f"edges={dm.budget.num_edges}")
    if dm.budgets is not None and len(dm.budgets) > 1:
        logger.info("Shape buckets: " + ", ".join(
            f"(n={b.num_nodes}, e={b.num_edges})" for b in dm.budgets))

    # Execution-path selection, as in the JAX runner: slotted dense blocks
    # for molecular-scale graphs, CSR plans for the sparse kernel path.
    if cfg.runtime.dense_path in ("auto", "dense"):
        enabled = dm.enable_dense_slots(max_slot=D.DENSE_PATH_MAX_NODES)
        if enabled:
            logger.info(f"Dense slotted path on: slot={dm.slot_nodes}")
        elif cfg.runtime.dense_path == "dense":
            raise ValueError("dense path requested but a graph exceeds "
                             f"max slot {D.DENSE_PATH_MAX_NODES}")
    if cfg.runtime.spmm_backend in ("auto", "pallas") and not dm.slot_nodes:
        dm.with_spmm_plan = (device.type == "cuda"
                             or cfg.runtime.spmm_backend == "pallas")

    if cfg.pe is not None:
        raise NotImplementedError(
            "positional encodings (transform/posenc.py): ROADMAP queue A, "
            "item 9")
    node_level = dm.task_level == "node"
    shape = _resolve_mesh_shape(cfg.mesh.shape)
    mesh_size = int(np.prod(shape))
    if cfg.hscn is not None:
        raise NotImplementedError("HSCN pipeline: ROADMAP slice 3 "
                                  "(queue A, item 7)")
    if _use_fused_stack(cfg, dm, device):
        raise NotImplementedError("fused GCN stack (kernel B2): ROADMAP "
                                  "slice 2 (queue A, item 6)")
    if mesh_size > 1 or cfg.mesh.edge_partition:
        raise NotImplementedError("mesh.shape > 1 / mesh.edge_partition: "
                                  "ROADMAP queue A, item 11")
    if _use_device_dataset(cfg, dm):
        raise NotImplementedError("device-resident dataset "
                                  "(train/device_data.py): ROADMAP slice 2 "
                                  "(queue A, item 10)")

    # Initial weights from a seeded generator on the host, then moved.
    init_gen = torch.Generator().manual_seed(cfg.training.seed)
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       compat=cfg.compat.double_relu,
                       readout="none" if node_level else "mean",
                       dtype=compute_dtype, generator=init_gen).to(device)
    if compute_dtype is not None:
        logger.info(f"Mixed precision: {cfg.runtime.compute_dtype} "
                    "compute, f32 params/logits.")
    return fit(
        model,
        # Fresh batch composition every epoch (reference DataLoader
        # shuffle=True semantics, loader.py:48-60).
        lambda epoch: dm.train_batches(epoch_seed=dm.seed + epoch),
        dm.eval_batches("val"), dm.eval_batches("test"),
        cfg.optim, cfg.training, logger, device,
        node_level=node_level,
        compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
        step_timing=step_timing)


def _resolve_mesh_shape(shape) -> list[int]:
    """Config mesh shape with ``-1`` ("all remaining devices on that axis")
    resolved against the visible CUDA devices."""
    shape = list(shape)
    if -1 in shape:
        fixed = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = max(torch.cuda.device_count(), 1) // fixed
    return shape


def _use_fused_stack(cfg: ExperimentConfig, dm, device) -> bool:
    """The JAX runner's rule (runner.py:241-268), with the accelerator test
    on the port's device."""
    mode = cfg.runtime.fused_stack
    if mode == "off" or cfg.mpnn is None:
        return False
    eligible = (cfg.mpnn.conv_type.lower() == "gcn"
                and cfg.mpnn.activation.lower() == "relu"
                and not cfg.mpnn.use_batch_norm
                and not cfg.mpnn.use_layer_norm
                and dm.slot_nodes is not None)
    if mode == "on":
        if not eligible:
            raise ValueError("fused_stack requested but config ineligible "
                             "(needs gcn+relu+dense slots)")
        return True
    # "auto": matmul_precision: highest marks an accuracy-pinned run, which
    # takes the unfused path.
    if cfg.runtime.matmul_precision == "highest":
        return False
    return eligible and device.type == "cuda"


def _use_device_dataset(cfg: ExperimentConfig, dm) -> bool:
    mode = cfg.runtime.device_dataset
    if mode == "off":
        return False
    slot = dm.slot_nodes or (((dm.max_nodes_per_graph() + 7) // 8) * 8)
    est_mb = (len(dm.graphs) * slot * dm.num_features * 4) / 1e6
    fits = est_mb <= cfg.runtime.device_dataset_max_mb
    if mode == "on":
        return True
    return fits
