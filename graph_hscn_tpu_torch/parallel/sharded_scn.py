"""Edge-partitioned SCN (the MinCUT clustering stage) and the whole
edge-partitioned HSCN pipeline: the counterpart of
``graph_hscn_tpu/parallel/sharded_scn.py``.

The SCN's GraphConv stack runs over node blocks sharded across the ranks
(the sharded GCN's layout: receiver-owned edges, the halo exchange a
layer, the self-loop-folded gcn_norm weights); the local aggregation takes
``csr_spmm`` (B1, ``SpmmFunction`` on the rank's local-edge ``CsrPlan``,
the weights taking no gradient) where a layer's input is ``WIDTH_GATE``
columns or more.  The MinCUT objective is GLOBAL (one set of K clusters
over the whole node space), built from per-rank partial contractions on
the raw unweighted adjacency:

    S^T A S      the rank's s.T @ (A s)                     [K, K]
    tr(S^T D S)  sum_i outdeg_i ||s_i||^2 over its rows     scalar
    S^T S        the rank's gram                            [K, K]

The gradient convention (JAX's docstring, sharded_scn.py:14-31): the
partials' sum over the ranks feeds ONE loss that every rank computes
alike, so the upstream gradient of the sum is already the global one on
every rank.  :class:`SumPartials` sums them in its forward and is the
identity in its backward; the parameter gradients are then all-reduced
(summed).  A sum whose backward summed too would give D times the
gradient.  The opposite convention, for sums inside a per-rank loss, is
parallel/sharded_hscn.py's.

:func:`fit_hscn_edge_partitioned` is the CLI route of ``hscn:`` with
``mesh.edge_partition: true``: every split packed as one batch, the SCN
trained full-batch over train, val and test each clustering epoch, the
argmax assignment of each split, then the sharded HSCN trained with the
fit loop's cadence, checkpoints, eval-only mode and predictions.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from graph_hscn_tpu_torch.models.layers import ACTIVATIONS, glorot_uniform_
from graph_hscn_tpu_torch.ops.segment import segment_sum
from graph_hscn_tpu_torch.ops.spmm import kernel_enabled
from graph_hscn_tpu_torch.parallel.mesh import Mesh
from graph_hscn_tpu_torch.parallel.sharded_gcn import (
    Affine, _cast, all_reduce_grads, fit_blocks, local_aggregate,
    partition_split)
from graph_hscn_tpu_torch.parallel.sharded_hscn import ShardedHSCN
from graph_hscn_tpu_torch.train.optimizers import build_optimizer
from graph_hscn_tpu_torch.utils.profiling import check_nans, training_state


class SumPartials(torch.autograd.Function):
    """The sum over the ranks of partials that feed a loss every rank
    computes alike: forward ``all_reduce`` SUM, backward the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GraphConvLayer(nn.Module):
    """JAX's ``{"kernel_rel", "kernel_root" [in, out], "bias"}``."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.weight_rel = nn.Parameter(torch.empty(features, in_features))
        self.weight_root = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight_rel, generator)
        glorot_uniform_(self.weight_root, generator)
        self.bias = nn.Parameter(torch.zeros(features))


class ShardedSCN(nn.Module):
    """``make_sharded_scn``'s program (sharded_scn.py:77-260): the
    GraphConv stack (``mp_units``, activation ``mp_act``) and the
    assignment head to K logits.  ``dtype`` (bfloat16): the stack's
    features and halo in it; the assignment logits, the softmax and every
    MinCUT contraction in float32."""

    def __init__(self, num_features: int, mp_units, num_clusters: int,
                 mp_act: str = "relu", dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.K, self.dtype = num_clusters, dtype
        self.act = mp_act.lower()
        dims = [num_features] + list(mp_units)
        self.layers = nn.ModuleList(
            _GraphConvLayer(a, b, generator)
            for a, b in zip(dims[:-1], dims[1:]))
        self.head = Affine(dims[-1], num_clusters, generator)

    def logits(self, blk) -> torch.Tensor:
        """The assignment logits [Nb, K] float32."""
        act = ACTIVATIONS[self.act]
        w_loc, w_hal, diag = _cast(self.dtype, *blk.gcn_norm())
        (h,) = _cast(self.dtype, blk.x)
        for layer in self.layers:
            pending = blk.halo(h)
            agg = local_aggregate(h, w_loc, blk)
            halo = pending.wait()
            agg = agg + segment_sum(halo.index_select(0, blk.snd_hal)
                                    * w_hal[:, None], blk.rcv_hal, blk.nb)
            agg = agg + diag[:, None] * h
            rel, root, bias = _cast(self.dtype, layer.weight_rel,
                                    layer.weight_root, layer.bias)
            h = act(F.linear(agg, rel) + F.linear(h, root) + bias)
        return F.linear(h.float(), self.head.weight, self.head.bias)

    def forward(self, blk) -> torch.Tensor:
        """The MinCUT loss plus the orthogonality loss (0-d), the same on
        every rank."""
        mc, o = self.losses(blk)
        return mc + o

    def losses(self, blk) -> tuple[torch.Tensor, torch.Tensor]:
        """(MinCUT loss, orthogonality loss) of the whole split."""
        K, nb = self.K, blk.nb
        s = torch.softmax(self.logits(blk), -1) * blk.ok[:, None].float()
        s_halo = blk.halo(s).wait()
        a_s = local_aggregate(s, blk.m_loc.float(), blk)
        a_s = a_s + segment_sum(torch.where(
            blk.m_hal[:, None], s_halo.index_select(0, blk.snd_hal), 0.0),
            blk.rcv_hal, nb)
        parts = torch.cat([(s.t() @ a_s).reshape(-1),
                           (blk.outdeg * (s * s).sum(-1)).sum().reshape(1),
                           (s.t() @ s).reshape(-1)])
        parts = SumPartials.apply(parts, blk.group)
        stas, den = parts[:K * K].reshape(K, K), parts[K * K]
        ss = parts[K * K + 1:].reshape(K, K)
        mc = -(torch.trace(stas) / den.clamp_min(1e-12))
        ident = torch.eye(K, device=ss.device) / K ** 0.5
        o = torch.linalg.norm(ss / torch.linalg.norm(ss).clamp_min(1e-12)
                              - ident)
        return mc, o

    @torch.no_grad()
    def assign(self, blk) -> torch.Tensor:
        """The rank's cluster ids [Nb] int64 (argmax of the logits)."""
        return self.logits(blk).argmax(-1)


def scn_loss_and_grads(model: ShardedSCN, blk) -> torch.Tensor:
    """The SCN's loss (every rank's alike) and the gradient of every
    parameter, summed over the ranks (``p.grad``).  Returns the loss."""
    for p in model.parameters():
        p.grad = None
    loss = model(blk)
    loss.backward()
    all_reduce_grads(list(model.parameters()), blk.group)
    return loss.detach()


def fit_hscn_edge_partitioned(dm, mesh: Mesh, hscn_cfg, optim_cfg,
                              training_cfg, logger, checkpointer=None,
                              reorder: bool = True,
                              vv_pattern: str = "clique",
                              eval_only: str | None = None,
                              predictions_sink: dict | None = None,
                              dtype=None, step_timing: bool = False):
    """The edge-partitioned HSCN pipeline (the JAX
    ``fit_hscn_edge_partitioned``): each split packed as one batch over
    the mesh's ranks (locality reorder, receiver re-sort, the out-degree,
    the halo plan and the local ``CsrPlan``), then

      1. the sharded SCN trained full-batch for ``cluster_epochs``
         epochs, a step on train, val and test each epoch (the reference
         clusters the whole dataset);
      2. each split's argmax assignment;
      3. the sharded HSCN trained with node-level softmax cross entropy,
         one step an epoch, with ``run_fit_loop``'s cadence, early stop
         and checkpoints.

    Every rank runs this alike.  The clusters are not in a snapshot: a
    resumed or eval-only run clusters again (deterministic given
    ``training.seed``).  Returns a ``FitResult`` (``cluster_losses``,
    ``partition``), or with ``eval_only`` ({split: {"loss", metric}},
    meta), each split's scores and targets in ``predictions_sink``."""
    if training_cfg.loss_fn != "softmax_cross_entropy":
        raise ValueError(
            "edge-partitioned HSCN computes node-level softmax cross "
            "entropy; set loss_fn: softmax_cross_entropy")
    if dtype is not None:
        logger.info("[hscn-partition] mixed precision: bf16 streams + halo "
                    "payloads; MinCUT contractions, lv softmax statistics, "
                    "and logits stay f32.")
    K = hscn_cfg.num_clusters
    use_plan = kernel_enabled(torch.empty(0, device=mesh.device))
    splits = {}
    for name in ("train", "val", "test"):
        splits[name] = s = partition_split(dm.split(name), mesh, reorder,
                                           use_plan, outdeg=True)
        i = s.info
        logger.info(f"[hscn-partition] {name}: {i['rows']} node rows over "
                    f"{mesh.size} devices, halo width H={i['halo_width']}"
                    f"{' (locality-reordered)' if reorder else ''}")
    if use_plan:
        logger.info("[hscn-partition] local aggregation: csr_spmm on the "
                    "rank's block (SCN stack, HSCN ll relation) at 64 "
                    "columns or more")
    gen = torch.Generator().manual_seed(training_cfg.seed)

    # ---- Stage 1: the sharded SCN, trained on the whole dataset. ----
    scn = ShardedSCN(dm.num_features, hscn_cfg.mp_units, K,
                     hscn_cfg.activation, dtype, gen).to(mesh.device)
    scn_opt = build_optimizer(scn.parameters(), optim_cfg.optim_type,
                              optim_cfg.lr, optim_cfg.weight_decay)
    cluster_losses = []
    for ep in range(hscn_cfg.cluster_epochs):
        t0 = time.time()
        losses = []
        for name in ("train", "val", "test"):
            losses.append(scn_loss_and_grads(scn, splits[name].block))
            scn_opt.step()
            check_nans("clustering step", [("loss", losses[-1])],
                       training_state(scn, scn_opt), group=mesh.group)
        cluster_losses.append(float(torch.stack(losses).mean()))
        logger.info(f"Clustering epoch {ep}: loss={cluster_losses[-1]:.4f} "
                    f"({time.time() - t0:.2f}s)")
        logger.wandb_log({"cluster_loss": cluster_losses[-1]})

    # ---- Stage 2: each split's assignment. ----
    clusters = {name: scn.assign(s.block) for name, s in splits.items()}
    del scn, scn_opt

    # ---- Stage 3: the sharded HSCN. ----
    model = ShardedHSCN(
        dm.num_features, hscn_cfg.hidden_channels, dm.num_classes,
        hscn_cfg.num_layers, K, heads=hscn_cfg.num_heads,
        virtual_feedback=hscn_cfg.virtual_feedback, vv_pattern=vv_pattern,
        dtype=dtype, generator=gen).to(mesh.device)
    result = fit_blocks(model, splits, mesh, optim_cfg, training_cfg, logger,
                        checkpointer, eval_only, predictions_sink,
                        step_timing, args={k: (c,) for k, c in
                                           clusters.items()})
    if not eval_only:
        result.cluster_losses = cluster_losses
    return result
