"""Experiment runner: config -> data -> model -> training.

The counterpart of ``graph_hscn_tpu/runner.py`` (the reference's
run_train, main.py:85-120):

  MPNN: the GCN, GAT or GIN ``MPNN``, ``GatedGCNNet``, the GPS
        transformer ``GPSModel`` or the fused ``FusedDenseGCN``, trained
        by the host loop ``fit`` or the device-resident ``fit_device``
        (on the card its steps captured as CUDA graphs);
  HSCN: SCN MinCUT clustering -> cluster ids on the graphs -> ``HSCN``
        (hscn_pipeline.py), on host batches or the device-resident
        dataset.

  mesh: ``mesh.edge_partition`` on a 1-D mesh: the sharded GCN, GIN,
        GAT, GatedGCN or ring-attention GPS over the ranks of a process
        group (parallel/sharded_gcn.py), or with ``hscn:`` the sharded
        SCN clustering and HSCN (parallel/sharded_scn.py); on a 2-D mesh
        the hybrid of graph groups and node blocks (parallel/hybrid.py);
        a mesh of more than one rank without ``edge_partition`` trains
        data-parallel (parallel/data_parallel.py).  One rank a device;
        the group is the launcher's (``runtime.multihost``), or without
        one the run makes a 1-rank one.

With ``pe`` set, the eigen stats (and the frozen SignNet transform) come
first, or the trainable SignNet wraps the model; with
``training.checkpoint_dir`` every fit saves and resumes; :func:`run_eval`
is the eval-only mode of ``main.py --eval``.

Execution paths are routed as in the JAX package (runner.py:49-61, :63-67,
:71-118, :120-238, :322-360); the keys of later slices raise
``NotImplementedError`` naming their ROADMAP item, so no config trains as
if it had not set them.

Runs on ``cuda`` unless the caller passes another device; without a card
that raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from graph_hscn_tpu_torch.config import defaults as D
from graph_hscn_tpu_torch.config.config import ExperimentConfig
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.hscn_pipeline import (cluster_on_host,
                                                 run_hscn_pipeline)
from graph_hscn_tpu_torch.models.encoded import wrap_with_signnet
from graph_hscn_tpu_torch.models.fused_gcn import FusedDenseGCN
from graph_hscn_tpu_torch.models.layers import resolve_dtype
from graph_hscn_tpu_torch.models.mpnn import build_mpnn
from graph_hscn_tpu_torch.ops import spmm as spmm_mod
from graph_hscn_tpu_torch.parallel.data_parallel import fit_dp
from graph_hscn_tpu_torch.parallel.hybrid import fit_hybrid
from graph_hscn_tpu_torch.parallel.mesh import (launcher_env, make_mesh,
                                                process_group,
                                                resolve_mesh_shape, this_rank,
                                                world_size)
from graph_hscn_tpu_torch.parallel.sharded_gcn import fit_edge_partitioned
from graph_hscn_tpu_torch.parallel.sharded_scn import \
    fit_hscn_edge_partitioned
from graph_hscn_tpu_torch.train.checkpoint import Checkpointer
from graph_hscn_tpu_torch.train.loop import (FitResult, evaluate_checkpoint,
                                             fit, fit_device)
from graph_hscn_tpu_torch.transform.posenc import attach_posenc
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


def _refuse_later_slices(cfg: ExperimentConfig) -> None:
    """The runtime keys whose paths are not ported raise, naming their
    ROADMAP item, so that no config trains as if it had not set them."""
    rt = cfg.runtime
    if rt.debug_nans:
        raise NotImplementedError(
            "runtime.debug_nans (utils/profiling.py): ROADMAP queue A, "
            "item 12")
    if rt.profile_dir:
        raise NotImplementedError(
            "runtime.profile_dir (utils/profiling.py:trace): ROADMAP queue "
            "A, item 12")


def _setup_run(cfg: ExperimentConfig, device) -> tuple:
    """The process-wide settings of a run: the device (checked), the
    matmul precision and the spmm backend.  Returns (device, compute
    dtype)."""
    device = resolve_device(device)
    set_matmul_precision(cfg.runtime.matmul_precision)
    if cfg.runtime.spmm_backend in ("xla", "pallas"):
        spmm_mod.set_backend(cfg.runtime.spmm_backend)
    return device, resolve_dtype(cfg.runtime.compute_dtype)


def _checkpointer(cfg: ExperimentConfig) -> Checkpointer | None:
    return (Checkpointer(cfg.training.checkpoint_dir)
            if cfg.training.checkpoint_dir else None)


def run_experiment(cfg: ExperimentConfig, device=None, log_file=None,
                   step_timing: bool = False,
                   data_parallel: bool = False) -> FitResult:
    """Train ``cfg`` on ``device``, routed as the JAX runner routes it.
    ``data_parallel`` (no config key) takes ``fit_dp`` even on one rank:
    the yardstick that ``chip_smoke.py`` holds against the single-device
    fit and ``parallel/compare_ranks.py`` against D ranks."""
    _refuse_later_slices(cfg)
    # "on" without a launcher's variables raises here, before any work.
    launcher_env(cfg.runtime.multihost)
    device, compute_dtype = _setup_run(cfg, device)
    logger = Logger(log_file=log_file, metric_name=cfg.training.metric,
                    use_wandb=cfg.training.use_wandb,
                    quiet=this_rank(cfg.runtime.multihost) != 0)
    try:
        return _run(cfg, device, compute_dtype, logger, step_timing,
                    data_parallel)
    finally:
        logger.finish()


def _data(cfg: ExperimentConfig, device, logger) -> DataModule:
    """The dataset, its execution path (slotted dense blocks for
    molecular-scale graphs, CSR plans for the sparse kernel path, as the
    JAX runner picks them) and, with ``pe``, its positional encodings."""
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    logger.info(f"Dataset {cfg.data.dataset_name}: {len(dm.graphs)} graphs, "
                f"budget nodes={dm.budget.num_nodes} "
                f"edges={dm.budget.num_edges}")
    if dm.budgets is not None and len(dm.budgets) > 1:
        logger.info("Shape buckets: " + ", ".join(
            f"(n={b.num_nodes}, e={b.num_edges})" for b in dm.budgets))
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
        attach_posenc(dm, cfg.pe, logger,
                      frozen_random=cfg.compat.frozen_random_signnet,
                      seed=cfg.training.seed, device=device)
    return dm


def _model(cfg: ExperimentConfig, dm, device, compute_dtype, logger,
           signnet_on_fused: bool = True) -> torch.nn.Module:
    """The MPNN branch's model on ``device``: the fused stack or
    ``build_mpnn``, behind a trainable SignNet when ``pe`` is set and
    ``compat.frozen_random_signnet`` is false.  ``signnet_on_fused=False``
    leaves the fused stack unwrapped, as the JAX ``run_eval`` does
    (runner.py:388-406).  Initial weights from a generator seeded with
    ``training.seed`` on the host, the core's first."""
    init_gen = torch.Generator().manual_seed(cfg.training.seed)
    readout = "none" if dm.task_level == "node" else "mean"
    fused = _use_fused_stack(cfg, dm, device)
    wrap = (cfg.pe is not None and not cfg.compat.frozen_random_signnet
            and (signnet_on_fused or not fused))
    # The core reads the encoder's output, dim_emb wide.
    in_features = cfg.pe.dim_emb if wrap else dm.num_features
    if fused:
        logger.info("Fused GCN stack on"
                    + (f" ({cfg.runtime.compute_dtype} compute, f32 "
                       "accumulation/logits)."
                       if compute_dtype is not None else "."))
        model = FusedDenseGCN(
            num_features=in_features,
            hidden_channels=cfg.mpnn.hidden_channels,
            num_classes=dm.num_classes, num_layers=cfg.mpnn.num_layers,
            dropout=cfg.mpnn.dropout, readout=readout, dtype=compute_dtype,
            generator=init_gen)
    else:
        model = build_mpnn(cfg.mpnn, in_features, dm.num_classes,
                           compat=cfg.compat.double_relu, readout=readout,
                           dtype=compute_dtype, generator=init_gen,
                           num_edge_features=dm.num_edge_features)
        if compute_dtype is not None:
            logger.info(f"Mixed precision: {cfg.runtime.compute_dtype} "
                        "compute, f32 params/logits.")
    if wrap:
        model = wrap_with_signnet(model, cfg.pe, dm.num_features,
                                  generator=init_gen)
    return model.to(device)


def _needs_group(cfg: ExperimentConfig, eval_mode: bool = False) -> bool:
    """Whether the run takes a mesh route (JAX's runner.py:84-94 and
    :151-206; ``run_eval`` only with ``edge_partition``, runner.py:322)
    or joins a launcher's group anyway (``runtime.multihost: on``)."""
    if cfg.hscn is not None or eval_mode:
        return bool(cfg.mesh.edge_partition)
    shape = resolve_mesh_shape(cfg.mesh.shape,
                               world_size(cfg.runtime.multihost))
    return (int(np.prod(shape)) > 1 or cfg.mesh.edge_partition
            or cfg.runtime.multihost == "on")


def _group_for(cfg: ExperimentConfig, device, eval_mode: bool = False):
    """The process group of a run that needs one (:func:`_needs_group`),
    made as ``runtime.multihost`` says; a plain run keeps ``device``."""
    if _needs_group(cfg, eval_mode):
        return process_group(device, cfg.runtime.multihost)
    return contextlib.nullcontext(device)


def _mesh_route(cfg: ExperimentConfig, dm, eval_mode: bool = False
                ) -> tuple[str | None, list[int]]:
    """(route, shape): the mesh route JAX's runner picks
    (runner.py:84-94, :151-206; in ``run_eval`` :322-360), None for a
    single-device run; "dp" (``fit_dp``), "edge" (the 1-D edge partition,
    or an HSCN's), "hybrid" (``fit_hybrid``).  Raises JAX's ValueErrors:
    too few ranks, a graph-level task or a trainable SignNet on an
    edge-partitioned path, a 2-D HSCN mesh."""
    world = world_size(cfg.runtime.multihost)
    shape = resolve_mesh_shape(cfg.mesh.shape, world)
    if cfg.hscn is not None:
        # JAX's HSCN takes the mesh only with edge_partition, and then
        # even on one device (runner.py:84-94).
        if not cfg.mesh.edge_partition:
            return None, shape
        if dm.task_level != "node":
            raise ValueError("mesh.edge_partition targets node-level tasks "
                             "(giant-graph full-batch training)")
        if len(shape) != 1:
            raise ValueError("edge-partitioned HSCN takes a 1-D mesh")
        if cfg.pe is not None and not cfg.compat.frozen_random_signnet:
            raise ValueError("edge-partitioned paths support PE only as the "
                             "precomputed transform; set "
                             "compat.frozen_random_signnet: true")
        return "edge", shape
    size = int(np.prod(shape))
    # edge_partition is honoured on one device too; a data-parallel config
    # is scored on one device by run_eval.
    if not cfg.mesh.edge_partition and (size == 1 or eval_mode):
        return None, shape
    if world < size:
        raise ValueError(f"mesh.shape={shape} needs {size} devices, "
                         f"have {world}")
    if not cfg.mesh.edge_partition:
        return "dp", shape
    if dm.task_level != "node":
        raise ValueError("mesh.edge_partition targets node-level tasks "
                         "(giant-graph full-batch training)")
    if cfg.pe is not None and not cfg.compat.frozen_random_signnet:
        # The trainable SignNet wraps a model the sharded programs do not
        # use: refused rather than trained without PE.
        raise ValueError("edge-partitioned paths support PE only as the "
                         "precomputed transform; set "
                         "compat.frozen_random_signnet: true")
    return ("hybrid" if len(shape) == 2 else "edge"), shape


def _edge_partitioned(cfg: ExperimentConfig, dm, route: str, shape, device,
                      compute_dtype, logger, **kwargs):
    """``fit_edge_partitioned``, for an HSCN config
    ``fit_hscn_edge_partitioned``, or on a 2-D mesh ``fit_hybrid``, on a
    mesh of ``shape`` over the default process group."""
    mesh = make_mesh(tuple(cfg.mesh.axes), tuple(shape), device)
    if route == "hybrid":
        logger.info(f"Hybrid {shape[0]}x{shape[1]} training (axes "
                    f"{list(cfg.mesh.axes)}: DP groups x halo-exchange edge "
                    f"partition, {dist.get_backend()}).")
        return fit_hybrid(dm, mesh, cfg.mpnn, cfg.optim, cfg.training,
                          logger, checkpointer=_checkpointer(cfg),
                          reorder=cfg.mesh.locality_reorder, **kwargs)
    if cfg.hscn is not None:
        logger.info(f"Edge-partitioned HSCN pipeline over {mesh.size} "
                    f"ranks on {device} (sharded SCN clustering + "
                    f"halo-exchange hetero conv, {dist.get_backend()}).")
        return fit_hscn_edge_partitioned(
            dm, mesh, cfg.hscn, cfg.optim, cfg.training, logger,
            checkpointer=_checkpointer(cfg),
            reorder=cfg.mesh.locality_reorder,
            vv_pattern=("triangular" if cfg.compat.vv_triangular_pattern
                        else "clique"),
            dtype=compute_dtype, **kwargs)
    logger.info(f"Edge-partitioned {cfg.mpnn.conv_type} over "
                f"{mesh.size} ranks on {device} (halo exchange, "
                f"{dist.get_backend()}).")
    return fit_edge_partitioned(
        dm, mesh, cfg.mpnn, cfg.optim, cfg.training, logger,
        checkpointer=_checkpointer(cfg),
        reorder=cfg.mesh.locality_reorder, dtype=compute_dtype, **kwargs)


def _data_parallel(cfg: ExperimentConfig, dm, model, device, logger,
                   shape, step_timing: bool = False) -> FitResult:
    """``fit_dp`` of ``model`` (on ``device``) over a mesh of ``shape`` on
    the default process group."""
    mesh = make_mesh(tuple(cfg.mesh.axes), tuple(shape), device)
    logger.info(f"Data-parallel training over {mesh.size} ranks "
                f"(mesh axes {list(cfg.mesh.axes)}, {dist.get_backend()}).")
    return fit_dp(model, dm, mesh, cfg.optim, cfg.training, logger,
                  node_level=dm.task_level == "node",
                  compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
                  checkpointer=_checkpointer(cfg), step_timing=step_timing)


def _run(cfg, device, compute_dtype, logger, step_timing,
         data_parallel: bool = False) -> FitResult:
    group = (process_group(device, cfg.runtime.multihost) if data_parallel
             else _group_for(cfg, device))
    with group as device:
        dm = _data(cfg, device, logger)
        route, shape = _mesh_route(cfg, dm)
        if data_parallel:
            if route not in (None, "dp") or cfg.hscn is not None:
                raise ValueError("data_parallel takes an MPNN config "
                                 "without mesh.edge_partition")
            route = "dp"
        if route in ("edge", "hybrid"):
            return _edge_partitioned(cfg, dm, route, shape, device,
                                     compute_dtype, logger,
                                     step_timing=step_timing)
        if cfg.hscn is not None:
            return run_hscn_pipeline(
                cfg, dm, logger, device, compute_dtype,
                use_device_dataset=_use_device_dataset(cfg, dm),
                step_timing=step_timing, checkpointer=_checkpointer(cfg))
        model = _model(cfg, dm, device, compute_dtype, logger)
        if route == "dp":
            return _data_parallel(cfg, dm, model, device, logger, shape,
                                  step_timing)
        if _use_device_dataset(cfg, dm):
            logger.info("Device-resident dataset path on.")
            return fit_device(
                model, dm.split("train"), dm.split("val"), dm.split("test"),
                batch_size=cfg.data.batch_size, optim_cfg=cfg.optim,
                training_cfg=cfg.training, logger=logger, device=device,
                node_level=dm.task_level == "node",
                compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
                slot=dm.slot_nodes, step_timing=step_timing,
                checkpointer=_checkpointer(cfg))
        return fit(
            model,
            # Fresh batch composition every epoch (reference DataLoader
            # shuffle=True semantics, loader.py:48-60).
            lambda epoch: dm.train_batches(epoch_seed=dm.seed + epoch),
            dm.eval_batches("val"), dm.eval_batches("test"),
            cfg.optim, cfg.training, logger, device,
            node_level=dm.task_level == "node",
            compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
            step_timing=step_timing, checkpointer=_checkpointer(cfg))


def run_eval(cfg: ExperimentConfig, which: str = "best", device=None,
             log_file=None, predict_out: str | None = None) -> dict:
    """Eval-only mode (the JAX ``run_eval``): restore snapshot ``which``
    ("best" or "latest") from ``training.checkpoint_dir`` and score the val
    and test splits on host batches.  Returns {split: {"loss", metric}}.

    For the HSCN pipeline the clusters are not in the snapshot: clustering
    is deterministic given ``training.seed``, so the host clustering
    (``train_clustering``) runs again before the restore, whichever route
    clustered in training, as in the JAX package.

    ``predict_out``: the path of an ``.npz`` to receive each split's
    scores and targets over its real rows (``{split}_scores``,
    ``{split}_targets``).
    """
    if not cfg.training.checkpoint_dir:
        raise ValueError("eval mode needs training.checkpoint_dir")
    device, compute_dtype = _setup_run(cfg, device)
    logger = Logger(log_file=log_file, metric_name=cfg.training.metric,
                    quiet=this_rank(cfg.runtime.multihost) != 0)
    try:
        with _group_for(cfg, device, eval_mode=True) as device:
            return _eval(cfg, which, device, compute_dtype, logger,
                         predict_out)
    finally:
        logger.finish()


def _eval(cfg, which, device, compute_dtype, logger, predict_out) -> dict:
    dm = _data(cfg, device, logger)
    sink = {} if predict_out else None
    route, shape = _mesh_route(cfg, dm, eval_mode=True)
    if route is not None:
        # The sharded forward restores the sharded model's snapshot
        # (fit_edge_partitioned's or fit_hybrid's eval-only mode).
        results, meta = _edge_partitioned(
            cfg, dm, route, shape, device, compute_dtype, logger,
            eval_only=which, predictions_sink=sink)
    else:
        if cfg.hscn is not None:
            model, _ = cluster_on_host(cfg, dm, logger, device,
                                       compute_dtype)
        else:
            model = _model(cfg, dm, device, compute_dtype, logger,
                           signnet_on_fused=False)
        results, meta = evaluate_checkpoint(
            model, {"val": dm.eval_batches("val"),
                    "test": dm.eval_batches("test")},
            cfg.training, Checkpointer(cfg.training.checkpoint_dir),
            device, which=which, node_level=dm.task_level == "node",
            compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
            predictions_sink=sink)
    for split, m in results.items():
        logger.info(f"[eval:{which}] {split}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in m.items()))
    if meta:
        logger.info(f"[eval:{which}] snapshot meta: {meta}")
    if sink is not None and this_rank() == 0:
        # Rank 0 writes.
        arrays = {f"{split}_{k}": v for split, d in sink.items()
                  for k, v in d.items()}
        np.savez(predict_out, **arrays)
        logger.info(f"[predict] wrote {', '.join(sorted(arrays))} "
                    f"to {predict_out}")
    return results


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
