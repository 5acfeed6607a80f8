"""Data-parallel training over the ranks of a process group: the
counterpart of ``graph_hscn_tpu/parallel/data_parallel.py``.

Each rank owns a full padded sub-batch of whole graphs (no edge crosses a
rank), runs its forward and backward alone, and the gradients and the loss
are summed over the ranks in one ``all_reduce`` of a flat buffer
(``sharded_gcn.all_reduce_grads``; JAX's ``psum``), so every rank takes the
same optimizer step: the single-device update on the concatenated global
batch, up to the order of the sums.

- :func:`pack_for_devices`: every rank packs the same global chunk with
  JAX's largest-first balance (:func:`assign_devices`) and the same
  per-device budget, and keeps its own sub-batch; a device left without a
  graph gets the masked placeholder of :func:`_empty_batch`.  The
  sub-batches equal JAX's stacked ones, array for array (the CSR plan is
  the port's own: JAX's windowed plan is a TPU device).
- :func:`make_dp_train_step`: any model the runner builds (the MPNN, the
  fused stack, GatedGCN, GPS on slots, an HSCN); the local loss sum over
  the GLOBAL element count, the count all-reduced before the backward
  pass; dropout from a generator a rank seeded from (seed, step, rank),
  JAX's ``fold_in(axis_index)`` (the bits differ from JAX's).
- :func:`make_dp_eval_step`: the loss numerator and denominator summed
  over the ranks.
- :func:`fit_dp`: the CLI's route for a mesh larger than one rank without
  ``edge_partition``; the eval splits packed and uploaded once, the train
  split repacked every epoch (shuffled with ``seed + epoch``); scores,
  targets and masks gathered so every rank scores alike.  A snapshot has
  the single-device model's layout (rank 0 writes, every rank restores),
  so single-process ``run_eval`` scores it.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from graph_hscn_tpu_torch.data.batching import GraphData, PadBudget, pack_batch
from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.parallel.mesh import Mesh
from graph_hscn_tpu_torch.parallel.sharded_gcn import (all_reduce_grads,
                                                       dropout_generator)
from graph_hscn_tpu_torch.train.loop import (FitResult, _maybe_resume,
                                             run_fit_loop, snapshot_state)
from graph_hscn_tpu_torch.train.loss import criterion
from graph_hscn_tpu_torch.train.metrics import METRICS
from graph_hscn_tpu_torch.train.optimizers import build_optimizer
from graph_hscn_tpu_torch.utils.profiling import check_nans, training_state


def assign_devices(graphs: list[GraphData], num_devices: int,
                   budget: PadBudget) -> list[list[int]]:
    """JAX's balance: graphs largest first (its ``np.argsort`` of minus
    the node counts), each to the open device with the least nodes so far,
    at most ``budget.num_graphs - 1`` a device.  Returns each device's
    graph indices, in the order they were placed."""
    cap = budget.num_graphs - 1
    shards: list[list[int]] = [[] for _ in range(num_devices)]
    order = np.argsort([-g.num_nodes for g in graphs])  # big-first balance
    loads = np.zeros(num_devices)
    for i in order:
        open_devs = [d for d in range(num_devices) if len(shards[d]) < cap]
        assert open_devs, (f"{len(graphs)} graphs exceed capacity "
                           f"{cap} * {num_devices} devices")
        d = min(open_devs, key=lambda d: loads[d])
        shards[d].append(int(i))
        loads[d] += graphs[int(i)].num_nodes
    return shards


def pack_for_devices(graphs: list[GraphData], num_devices: int,
                     budget: PadBudget, slot_nodes: int | None = None,
                     with_spmm_plan: bool = False,
                     ranks=None) -> list[GraphBatch]:
    """The sub-batches of ``ranks`` (default: every device), each packed
    with the same per-device ``budget`` (``slot_nodes``/``with_spmm_plan``
    to ``pack_batch``); a device without a graph gets the placeholder."""
    shards = assign_devices(graphs, num_devices, budget)
    kw = dict(slot_nodes=slot_nodes, with_spmm_plan=with_spmm_plan)
    return [pack_batch([graphs[i] for i in shards[d]], budget, **kw)
            if shards[d] else _empty_batch(graphs[0], budget, **kw)
            for d in (range(num_devices) if ranks is None else ranks)]


def _empty_batch(proto: GraphData, budget: PadBudget,
                 slot_nodes: int | None = None,
                 with_spmm_plan: bool = False) -> GraphBatch:
    """One zero graph of one node shaped as ``proto``, packed, with every
    graph, node and edge masked out."""
    def node_field(name):
        v = getattr(proto, name)
        return None if v is None else np.zeros((1, v.shape[1]), np.float32)

    tiny = GraphData(
        x=node_field("x"),
        edge_index=np.zeros((2, 0), np.int64),
        y=None if proto.y is None else np.zeros_like(np.asarray(proto.y)),
        edge_attr=(None if proto.edge_attr is None
                   else np.zeros((0, proto.edge_attr.shape[1]), np.float32)),
        edge_weight=(None if proto.edge_weight is None
                     else np.zeros((0,), np.float32)),
        node_y=node_field("node_y"),
        node_pe=node_field("node_pe"),
        eigvals=node_field("eigvals"),
        eigvecs=node_field("eigvecs"),
        cluster=(None if proto.cluster is None
                 else np.zeros((1,), np.int32)),
    )
    b = pack_batch([tiny], budget, slot_nodes=slot_nodes,
                   with_spmm_plan=with_spmm_plan)
    return b.replace(graph_mask=np.zeros_like(b.graph_mask),
                     node_mask=np.zeros_like(b.node_mask),
                     edge_mask=np.zeros_like(b.edge_mask))


def per_elem(loss_fn: str, pred: torch.Tensor, true: torch.Tensor):
    """The per-element loss and the score (JAX's DP ``per_elem``:
    "cross_entropy" BCE-with-logits, "softmax_cross_entropy" softmax NLL,
    "l1"/"mae" L1)."""
    if loss_fn == "cross_entropy":
        per = (pred.clamp_min(0) - pred * true
               + torch.log1p(torch.exp(-pred.abs())))
        return per, torch.sigmoid(pred)
    if loss_fn in ("l1", "mae"):
        return (pred - true).abs(), pred
    if loss_fn == "softmax_cross_entropy":
        logp = torch.log_softmax(pred, dim=-1)
        return -(true * logp).sum(-1, keepdim=True), torch.softmax(pred, -1)
    raise ValueError(f"Unknown loss_fn {loss_fn}")


def _targets(batch: GraphBatch, node_level: bool):
    return ((batch.node_y, batch.node_mask) if node_level
            else (batch.y, batch.graph_mask))


def make_dp_train_step(model: torch.nn.Module, opt, loss_fn: str,
                       mesh: Mesh, node_level: bool = False, seed: int = 0):
    """The DP train step: ``step(batch, step_index)`` on this rank's
    sub-batch (on its device) returns (the global loss, this rank's score,
    true, mask), every rank having taken the same optimizer step."""
    params = list(model.parameters())

    def train_step(batch: GraphBatch, step_index: int):
        model.train()
        true, mask = _targets(batch, node_level)
        # softmax CE counts one element a row; BCE and L1 one a class.
        width = 1 if loss_fn == "softmax_cross_entropy" else true.shape[-1]
        count = (mask.float().sum() * width).reshape(1)
        dist.all_reduce(count, group=mesh.group)
        for p in params:
            p.grad = None
        gen = dropout_generator(seed, step_index, mesh.rank, mesh.device)
        pred = model(batch, generator=gen)
        per, score = per_elem(loss_fn, pred, true)
        local = (per * mask[:, None].to(pred.dtype)).sum()
        loss = local / count[0].clamp_min(1.0)
        loss.backward()
        loss = all_reduce_grads(params, mesh.group, loss.detach())
        opt.step()
        return loss, score.detach(), true, mask

    return train_step


def make_dp_eval_step(model: torch.nn.Module, loss_fn: str, mesh: Mesh,
                      node_level: bool = False,
                      compat_sigmoid_score: bool = False):
    """The DP eval step: ``step(batch)`` returns (the global loss, this
    rank's score, true, mask); the loss is the ranks' sum of loss times
    real rows over their sum of real rows."""

    @torch.no_grad()
    def eval_step(batch: GraphBatch):
        model.eval()
        true, mask = _targets(batch, node_level)
        loss, score = criterion(loss_fn, model(batch), true, mask,
                                compat_sigmoid_score=compat_sigmoid_score)
        cnt = mask.float().sum()
        parts = torch.stack([loss * cnt, cnt])
        dist.all_reduce(parts, group=mesh.group)
        return parts[0] / parts[1].clamp_min(1.0), score, true, mask

    return eval_step


def _gathered(parts: list[torch.Tensor], group) -> np.ndarray:
    """An epoch's per-batch tensors [rows, ...] of every rank, in JAX's
    order: batch by batch, each batch's devices in rank order."""
    local = torch.stack(parts)                          # [B, rows, ...]
    if local.dtype == torch.bool:                       # gloo sends no bool
        return _gathered([t.to(torch.uint8) for t in parts], group) > 0
    every = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, local.contiguous(), group=group)
    out = torch.stack(every, 1).cpu().numpy()           # [B, D, rows, ...]
    return out.reshape(-1, *out.shape[3:])


def fit_dp(model: torch.nn.Module, dm, mesh: Mesh, optim_cfg, training_cfg,
           logger, node_level: bool = False,
           compat_sigmoid_score: bool = False, checkpointer=None,
           step_timing: bool = False) -> FitResult:
    """Data-parallel training (the JAX ``fit_dp``): the eval cadence,
    early stop and checkpoints of ``run_fit_loop``, each step one
    all-reduced step over the mesh's ranks.  A global batch is
    ``batch_size`` graphs balanced over the ranks with a per-device budget
    for ``ceil(batch_size / D)`` graphs; the schedule's horizon is
    ``epochs * ceil(n_train / batch_size)``.  ``model`` is on
    ``mesh.device``, the same initial weights on every rank."""
    D, device = mesh.size, mesh.device
    per_dev = max(1, -(-dm.batch_size // D))      # ceil(batch / D)
    budget = PadBudget.for_dataset(dm.graphs, per_dev)
    metric_fn = METRICS[training_cfg.metric]

    def batches(split: str, shuffle: bool, seed: int):
        graphs = dm.split(split)
        idx = np.arange(len(graphs))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for i in range(0, len(idx), dm.batch_size):
            chunk = [graphs[int(j)] for j in idx[i:i + dm.batch_size]]
            yield pack_for_devices(chunk, D, budget,
                                   slot_nodes=dm.slot_nodes,
                                   with_spmm_plan=dm.with_spmm_plan,
                                   ranks=[mesh.rank])[0].to(device)

    eval_batches = {split: list(batches(split, False, 0))
                    for split in ("val", "test")}
    steps_per_epoch = -(-len(dm.split("train")) // dm.batch_size)
    opt = build_optimizer(model.parameters(), optim_cfg.optim_type,
                          optim_cfg.lr, optim_cfg.weight_decay,
                          optim_cfg.batch_accumulation,
                          optim_cfg.clip_grad_norm,
                          schedule=optim_cfg.schedule,
                          warmup_steps=optim_cfg.warmup_steps,
                          total_steps=training_cfg.epochs * steps_per_epoch)
    # The snapshot's generator: the steps draw from one a (step, rank).
    gen = torch.Generator(device=device)
    gen.manual_seed(training_cfg.seed)
    start_epoch, best_loss = _maybe_resume(model, opt, gen, checkpointer,
                                           device, logger)
    train_step = make_dp_train_step(model, opt, training_cfg.loss_fn, mesh,
                                    node_level=node_level,
                                    seed=training_cfg.seed)
    eval_step = make_dp_eval_step(model, training_cfg.loss_fn, mesh,
                                  node_level=node_level,
                                  compat_sigmoid_score=compat_sigmoid_score)
    counts = {"train": 0, "eval": 0}
    step_seconds: list[float] = []

    def collect(outs):
        losses, scores, trues, masks = zip(*outs)
        y_pred, y_true, m = (_gathered(list(t), mesh.group)
                             for t in (scores, trues, masks))
        loss = float(torch.stack(losses).mean())
        y_pred = y_pred.reshape(-1, y_pred.shape[-1])
        y_true = y_true.reshape(-1, y_true.shape[-1])
        m = m.reshape(-1)
        return loss, metric_fn(y_true[m], y_pred[m])

    def check(out, where, state=()):
        """``runtime.debug_nans``: a step's loss, this rank's scores and
        targets (and ``state``), the flags all-reduced over the mesh."""
        check_nans(where, [("loss", out[0]), ("scores", out[1]),
                           ("targets", out[2])], state, group=mesh.group)

    def train_epoch(epoch):
        outs = []
        for batch in batches("train", True, training_cfg.seed + epoch):
            t0 = time.perf_counter()
            outs.append(train_step(batch, opt.minibatches))
            check(outs[-1], "train step", training_state(model, opt))
            counts["train"] += 1
            if step_timing:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_seconds.append(time.perf_counter() - t0)
        # No edge count: JAX's fit_dp logs none (data_parallel.py:288).
        return (*collect(outs), None)

    def evaluate(split):
        counts["eval"] += len(eval_batches[split])
        outs = [eval_step(b) for b in eval_batches[split]]
        for out in outs:
            check(out, "eval step")
        return collect(outs)

    # Every rank restored above; rank 0 alone writes.
    best, history, stopped, epochs_run = run_fit_loop(
        training_cfg, logger, train_epoch, evaluate,
        checkpointer if mesh.rank == 0 else None,
        lambda: snapshot_state(model, opt, gen), start_epoch, best_loss)
    return FitResult(model=model, best_val_loss=best, history=history,
                     stopped_early=stopped, epochs_run=epochs_run,
                     num_train_steps=counts["train"],
                     num_eval_batches=counts["eval"],
                     step_seconds=step_seconds)
