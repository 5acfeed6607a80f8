"""Edge-partitioned full-batch training of GCN, GIN and GAT: the
counterpart of ``graph_hscn_tpu/parallel/sharded_gcn.py``.

Each split is packed into ONE padded batch whose contiguous node blocks
are spread over the ranks of a process group (parallel/edge_partition.py):
rank d owns node rows [d*Nb, (d+1)*Nb) and the edges whose receiver it
owns, and a layer exchanges only its boundary rows (the halo) with one
``all_to_all`` (:func:`~graph_hscn_tpu_torch.parallel.edge_partition.start_halo`).
The exchange is issued before the local-sender aggregation and waited for
after it, so on NCCL it runs on its own stream meanwhile: the port's form
of JAX's v3 overlap.

- GCN (:class:`ShardedGCN`): the in-degree symmetric normalisation with
  the self loop folded in, the sender side's ``dinv`` exchanged once a
  block; the local aggregation below 64 columns is a plain gather and
  ``index_add_`` (JAX's width gate), at 64 or more ``SpmmFunction`` on the
  rank's local-edge ``CsrPlan`` (``csr_spmm`` forward and transpose; the
  weights take no gradient); the halo edges are plain, as in JAX.
- GIN (:class:`ShardedGIN`): ``MLP(x + sum_j x_j)``, plain aggregation (no
  kernel in either package).
- GAT (:class:`ShardedGAT`): attention logits, max and softmax in float32
  and plain torch (the receiver's softmax is local: every incoming edge
  lives on its owner); the local aggregation of all heads in one
  ``SpmmMhFunction`` (``spmm_mh``, with ``sddmm_mh`` for d alpha) at
  H*C >= 64; hidden layers concatenate heads, the output layer averages.
  The max shift is detached, as in the port's ``GATConv`` (the softmax is
  invariant to it, so its total gradient is zero).

``dtype`` (bfloat16): params stay float32 masters, features, halo payloads
and aggregations run in ``dtype``, the logits return float32.  Dropout
draws its bits from a generator a rank, seeded from (seed, epoch, rank):
JAX folds the mesh index into its key, and its streams differ from these.

Each rank's loss is its real rows' cross entropy summed and divided by the
GLOBAL real-row count; ``backward`` then one ``all_reduce`` of a flat
buffer of every gradient and the loss makes the replicated update (JAX's
``psum`` of the loss and the grads).  :func:`fit_edge_partitioned` is the
CLI's route (``mesh.edge_partition: true``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
from graph_hscn_tpu_torch.models.layers import (Dense, dropout,
                                                glorot_uniform_, leaky_relu)
from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import SpmmMhFunction
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import CsrPlan, SpmmFunction
from graph_hscn_tpu_torch.ops.segment import segment_max, segment_sum
from graph_hscn_tpu_torch.ops.spmm import kernel_enabled
from graph_hscn_tpu_torch.parallel.edge_partition import (
    Halo, all_gather_rows, apply_node_reorder, local_csr_plan,
    locality_reorder, plan_halo_exchange, rank_block, sort_edges_by_receiver,
    start_halo)
from graph_hscn_tpu_torch.parallel.mesh import Mesh
from graph_hscn_tpu_torch.train.loop import (FitResult, _maybe_resume,
                                             is_eval_epoch, run_fit_loop,
                                             snapshot_state)
from graph_hscn_tpu_torch.train.metrics import METRICS
from graph_hscn_tpu_torch.train.optimizers import build_optimizer

# Below this many columns (H*C for GAT) the local aggregation stays a
# plain gather and index_add_, as JAX's width gate (sharded_gcn.py:91-93).
WIDTH_GATE = 64
KERNEL_CONVS = ("gcn", "gat")


class Block:
    """One split's block on this rank, on its device.

    x [Nb, F], y [Nb, C], ok [Nb] (real rows); the halo plan's rank rows:
    send_idx [D*H], snd/rcv/m_loc [El] (local senders), snd/rcv/m_hal [Eh]
    (senders in the halo table); ``csr``: the local edges' ``CsrPlan``, or
    None where the kernels do not run; ``real_rows``: the split's real
    rows over every rank (the loss's divisor)."""

    def __init__(self, plan: dict, x, y, ok, rank: int, real_rows: int,
                 device, group, csr: CsrPlan | None):
        def idx(key):
            return torch.from_numpy(plan[key][rank].astype(np.int64)).to(
                device)

        self.nb = plan["block_size"]
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        self.y = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        self.ok = torch.from_numpy(np.ascontiguousarray(ok)).to(device)
        self.send_idx = torch.from_numpy(
            plan["send_idx"][rank].reshape(-1).astype(np.int64)).to(device)
        self.snd_loc, self.rcv_loc = idx("snd_loc"), idx("rcv_loc")
        self.snd_hal, self.rcv_hal = idx("snd_hal"), idx("rcv_hal")
        self.m_loc = torch.from_numpy(plan["mask_loc"][rank]).to(device)
        self.m_hal = torch.from_numpy(plan["mask_hal"][rank]).to(device)
        self.csr = csr.to(device) if csr is not None else None
        self.real_rows = real_rows
        self.group = group
        self._gcn_norm = None

    def halo(self, h: torch.Tensor) -> Halo:
        """Issue the exchange of ``h`` [Nb, F]'s boundary rows."""
        return start_halo(h, self.send_idx, self.group)

    def gcn_norm(self):
        """(w_loc [El], w_hal [Eh], diag [Nb]) float32: the GCN weights
        ``dinv[send] * dinv[recv]`` (0 on padding edges) and the self
        loop's ``dinv**2``, with ``deg`` the global in-degree plus one (all
        of a row's edges are on its owner).  The sender's ``dinv`` of a
        halo edge comes from its owner in one exchange, the first time a
        forward asks (every rank asks at the same forward)."""
        if self._gcn_norm is None:
            with torch.no_grad():
                ones_l = self.m_loc.float()
                ones_h = self.m_hal.float()
                deg = (segment_sum(ones_l, self.rcv_loc, self.nb)
                       + segment_sum(ones_h, self.rcv_hal, self.nb) + 1.0)
                dinv = torch.rsqrt(deg)
                dinv_halo = self.halo(dinv[:, None]).wait()[:, 0]
                w_loc = torch.where(self.m_loc, dinv[self.snd_loc]
                                    * dinv[self.rcv_loc], 0.0)
                w_hal = torch.where(self.m_hal, dinv_halo[self.snd_hal]
                                    * dinv[self.rcv_hal], 0.0)
                self._gcn_norm = (w_loc, w_hal, dinv * dinv)
        return self._gcn_norm


def local_aggregate(h: torch.Tensor, w: torch.Tensor,
                    blk: Block) -> torch.Tensor:
    """sum over the rank's local-sender edges of w_e * h[send_e] into
    [Nb, F], in h's dtype: ``csr_spmm`` (``SpmmFunction``, the weights
    taking no gradient) at F >= WIDTH_GATE with a plan, else plain."""
    if blk.csr is not None and h.shape[-1] >= WIDTH_GATE:
        return SpmmFunction.apply(h, w, blk.csr, False).to(h.dtype)
    return segment_sum(h.index_select(0, blk.snd_loc) * w[:, None],
                       blk.rcv_loc, blk.nb)


def local_aggregate_mh(zh: torch.Tensor, w: torch.Tensor,
                       blk: Block) -> torch.Tensor:
    """All heads: sum over local-sender edges of w[e, h] * zh[send_e, h]
    into [Nb, H, C], in zh's dtype: ``spmm_mh`` (``SpmmMhFunction``) at
    H*C >= WIDTH_GATE with a plan, else plain."""
    nb, heads, c = zh.shape
    if blk.csr is not None and heads * c >= WIDTH_GATE:
        out = SpmmMhFunction.apply(zh.reshape(nb, heads * c), w, blk.csr)
        return out.reshape(nb, heads, c).to(zh.dtype)
    return segment_sum(zh.index_select(0, blk.snd_loc) * w[..., None],
                       blk.rcv_loc, nb)


def _cast(dtype, *tensors):
    return tensors if dtype is None else tuple(t.to(dtype) for t in tensors)


class _GCNLayer(nn.Module):
    """JAX's ``{"kernel" [in, out], "bias"}``: weight [out, in], bias."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features))


class ShardedGCN(nn.Module):
    """The GCN stack of ``make_sharded_gcn`` (sharded_gcn.py:156-302):
    ReLU and dropout between layers, logits [Nb, C] float32."""

    def __init__(self, dims: list[int], dtype=None, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.layers = nn.ModuleList(
            _GCNLayer(dims[i], dims[i + 1], generator)
            for i in range(len(dims) - 1))

    def forward(self, blk: Block, generator=None) -> torch.Tensor:
        w_loc, w_hal, diag = _cast(self.dtype, *blk.gcn_norm())
        (h,) = _cast(self.dtype, blk.x)
        last = len(self.layers) - 1
        for li, layer in enumerate(self.layers):
            weight, bias = _cast(self.dtype, layer.weight, layer.bias)
            h = F.linear(h, weight)
            pending = blk.halo(h)
            agg = local_aggregate(h, w_loc, blk)
            halo = pending.wait()
            agg = agg + segment_sum(
                halo.index_select(0, blk.snd_hal) * w_hal[:, None],
                blk.rcv_hal, blk.nb)
            h = agg + diag[:, None] * h + bias
            if li != last:
                h = dropout(F.relu(h), self.dropout, self.training,
                            generator)
        return h.float()


class _GINLayer(nn.Module):
    """JAX's ``{"w1", "b1", "w2", "b2"}``: ``lin1`` and ``lin2``."""

    def __init__(self, in_features: int, features: int, dtype=None,
                 generator=None):
        super().__init__()
        self.lin1 = Dense(in_features, features, dtype, generator)
        self.lin2 = Dense(features, features, dtype, generator)


class ShardedGIN(nn.Module):
    """The GIN stack of ``make_sharded_gin`` (sharded_gcn.py:607-698):
    ``x' = MLP(x + sum_j x_j)`` (eps = 0), the unweighted sum over the
    same halo layout, ReLU and dropout between layers."""

    def __init__(self, dims: list[int], dtype=None, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.layers = nn.ModuleList(
            _GINLayer(dims[i], dims[i + 1], dtype, generator)
            for i in range(len(dims) - 1))

    def forward(self, blk: Block, generator=None) -> torch.Tensor:
        (h,) = _cast(self.dtype, blk.x)
        last = len(self.layers) - 1
        for li, layer in enumerate(self.layers):
            pending = blk.halo(h)
            agg = segment_sum(torch.where(
                blk.m_loc[:, None], h.index_select(0, blk.snd_loc), 0.0),
                blk.rcv_loc, blk.nb)
            halo = pending.wait()
            agg = agg + segment_sum(torch.where(
                blk.m_hal[:, None], halo.index_select(0, blk.snd_hal), 0.0),
                blk.rcv_hal, blk.nb)
            h = layer.lin2(F.relu(layer.lin1(h + agg)))
            if li != last:
                h = dropout(F.relu(h), self.dropout, self.training,
                            generator)
        return h.float()


class _GATLayer(nn.Module):
    """JAX's ``{"kernel" [in, H*C], "att_src", "att_dst" [H, C],
    "bias"}``: weight [H*C, in], att_src, att_dst, bias; glorot-uniform
    kernel, attention vectors U(-a, a) with a = sqrt(6 / (1 + C)), zero
    bias."""

    def __init__(self, in_features: int, heads: int, c: int, bias: int,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(heads * c, in_features))
        glorot_uniform_(self.weight, generator)
        a = (6.0 / (1 + c)) ** 0.5
        self.att_src = nn.Parameter(torch.empty(heads, c).uniform_(
            -a, a, generator=generator))
        self.att_dst = nn.Parameter(torch.empty(heads, c).uniform_(
            -a, a, generator=generator))
        self.bias = nn.Parameter(torch.zeros(bias))


class ShardedGAT(nn.Module):
    """The multi-head GAT of ``make_sharded_gat`` (sharded_gcn.py:728-903),
    the self edge in each node's softmax: hidden layers have C = width // H
    and concatenate heads, the output layer C = num_classes and averages
    them."""

    def __init__(self, dims: list[int], heads: int = 1, dtype=None,
                 dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        layers = []
        for i in range(len(dims) - 1):
            last = i == len(dims) - 2
            if not last and dims[i + 1] % heads:
                raise ValueError(f"width {dims[i + 1]} is not a multiple of "
                                 f"{heads} heads")
            c = dims[i + 1] if last else dims[i + 1] // heads
            layers.append(_GATLayer(dims[i], heads, c,
                                    dims[i + 1] if last else heads * c,
                                    generator))
        self.layers = nn.ModuleList(layers)

    def forward(self, blk: Block, generator=None) -> torch.Tensor:
        nb = blk.nb
        m_loc, m_hal = blk.m_loc[:, None], blk.m_hal[:, None]
        (h,) = _cast(self.dtype, blk.x)
        last = len(self.layers) - 1
        for li, layer in enumerate(self.layers):
            heads, c = layer.att_src.shape
            (weight,) = _cast(self.dtype, layer.weight)
            z = F.linear(h, weight)                          # [Nb, H*C]
            pending = blk.halo(z)
            zh = z.reshape(nb, heads, c)
            zh32 = zh.float()
            a_src = (zh32 * layer.att_src).sum(-1)           # [Nb, H]
            a_dst = (zh32 * layer.att_dst).sum(-1)
            e_loc = leaky_relu(a_src.index_select(0, blk.snd_loc)
                               + a_dst.index_select(0, blk.rcv_loc))
            e_self = leaky_relu(a_src + a_dst)
            halo_h = pending.wait().reshape(-1, heads, c)
            a_src_halo = (halo_h.float() * layer.att_src).sum(-1)
            e_hal = leaky_relu(a_src_halo.index_select(0, blk.snd_hal)
                               + a_dst.index_select(0, blk.rcv_hal))
            e_loc = torch.where(m_loc, e_loc, -torch.inf)
            e_hal = torch.where(m_hal, e_hal, -torch.inf)
            with torch.no_grad():
                m = torch.maximum(segment_max(e_loc, blk.rcv_loc, nb),
                                  segment_max(e_hal, blk.rcv_hal, nb))
                m = torch.maximum(m, e_self)
                m = torch.where(torch.isfinite(m), m, 0.0)
            exp_loc = torch.where(m_loc, torch.exp(
                e_loc - m.index_select(0, blk.rcv_loc)), 0.0)
            exp_hal = torch.where(m_hal, torch.exp(
                e_hal - m.index_select(0, blk.rcv_hal)), 0.0)
            exp_self = torch.exp(e_self - m)
            denom = (segment_sum(exp_loc, blk.rcv_loc, nb)
                     + segment_sum(exp_hal, blk.rcv_hal, nb)
                     + exp_self).clamp_min(1e-16)            # [Nb, H]
            wl, wh, wself, bias = _cast(self.dtype, exp_loc, exp_hal,
                                        exp_self, layer.bias)
            agg = local_aggregate_mh(zh, wl, blk)            # [Nb, H, C]
            agg = agg + segment_sum(
                halo_h.index_select(0, blk.snd_hal) * wh[..., None],
                blk.rcv_hal, nb)
            out = ((agg + zh * wself[..., None]).float()
                   / denom[..., None])
            (out,) = _cast(self.dtype, out)
            out = out.mean(1) if li == last else out.reshape(nb, heads * c)
            h = out + bias
            if li != last:
                h = dropout(F.relu(h), self.dropout, self.training,
                            generator)
        return h.float()


def build_sharded_model(conv: str, dims: list[int], heads: int = 1,
                        dtype=None, dropout: float = 0.0,
                        generator: torch.Generator | None = None
                        ) -> nn.Module:
    """``conv`` "gcn", "gin" or "gat" over ``dims`` (input, hidden...,
    classes); GatedGCN and GPS raise (ROADMAP queue A, item 11.2)."""
    if conv == "gcn":
        return ShardedGCN(dims, dtype, dropout, generator)
    if conv == "gin":
        return ShardedGIN(dims, dtype, dropout, generator)
    if conv == "gat":
        return ShardedGAT(dims, heads, dtype, dropout, generator)
    if conv in ("gatedgcn", "gps"):
        raise NotImplementedError(
            f"edge-partitioned {conv} (parallel/sharded_"
            f"{'gatedgcn' if conv == 'gatedgcn' else 'gps'}.py): ROADMAP "
            "queue A, item 11.2")
    raise ValueError("edge-partitioned path supports conv_type gcn, gat, "
                     f"gin, gatedgcn or gps, got {conv!r}")


def dropout_generator(seed: int, epoch: int, rank: int,
                      device) -> torch.Generator:
    """The dropout bits of one epoch on one rank: a generator on ``device``
    seeded from (seed, epoch, rank), so masks differ across ranks and
    repeat for the same (seed, epoch)."""
    key = np.random.SeedSequence([seed, epoch, rank]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def local_loss(logits: torch.Tensor, blk: Block) -> torch.Tensor:
    """The rank's share of the split's mean cross entropy: its real rows'
    sum over the split's real rows (JAX's ``/ gcnt``)."""
    per = -(blk.y * torch.log_softmax(logits, -1)).sum(-1)
    return (per * blk.ok).sum() / max(blk.real_rows, 1)


def loss_and_grads(model: nn.Module, blk: Block,
                   generator=None) -> torch.Tensor:
    """The split's loss and the gradient of every parameter, both summed
    over the ranks in one ``all_reduce`` of a flat buffer; the gradients
    are left in ``p.grad``.  Returns the loss (0-d, on the device)."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss = local_loss(model(blk, generator), blk)
    loss.backward()
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=blk.group)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat[-1]


@torch.no_grad()
def gather_logits(model: nn.Module, blk: Block) -> torch.Tensor:
    """The split's logits [N, C] float32 on every rank: the model's
    forward in eval mode, the blocks all-gathered."""
    model.eval()
    return all_gather_rows(model(blk), blk.group)


@dataclasses.dataclass
class Split:
    """One packed split: the host's node mask and targets over all N rows
    in block order, this rank's ``Block``, the node order (``perm[new] =
    old``, None without the reorder), and what the plan made (``info``:
    rows, block rows, real edges, halo width, the rank's local and halo
    edges, host seconds)."""

    node_mask: np.ndarray
    node_y: np.ndarray
    block: Block
    perm: np.ndarray | None
    info: dict


def partition_arrays(senders, receivers, edge_mask, node_feat, node_y,
                     node_mask, mesh: Mesh, reorder: bool = True,
                     use_plan: bool = False) -> Split:
    """A packed batch's arrays (receiver-sorted edges, rows a multiple of
    the mesh size) as a :class:`Split`: its nodes reordered by
    Cuthill-McKee and its edges re-sorted by receiver when ``reorder``,
    the halo exchange planned, and ``mesh.rank``'s block kept on
    ``mesh.device`` (with its local edges' ``CsrPlan`` when
    ``use_plan``).  Every rank computes the same plan."""
    t0 = time.perf_counter()
    D, rank = mesh.size, mesh.rank
    n = node_feat.shape[0]
    snd, rcv, em = senders, receivers, edge_mask
    x, y, ok = node_feat, node_y, node_mask
    perm = None
    if reorder:
        perm = locality_reorder(snd, rcv, em, n, node_mask=ok)
        snd, rcv, x, y, ok = apply_node_reorder(perm, snd, rcv, x, y, ok)
        # The CSR plans need the receiver sort back.
        snd, rcv, em, _ = sort_edges_by_receiver(snd, rcv, em, n)
    plan = plan_halo_exchange(snd, rcv, em, n, D)
    csr = local_csr_plan(plan, rank) if use_plan else None
    blk = Block(plan, rank_block(x, rank, D), rank_block(y, rank, D),
                rank_block(ok, rank, D), rank, int(ok.sum()), mesh.device,
                mesh.group, csr)
    info = dict(rows=n, block_rows=plan["block_size"],
                edges=int(em.sum()), halo_width=plan["halo_width"],
                local_edges=int(plan["mask_loc"][rank].sum()),
                halo_edges=int(plan["mask_hal"][rank].sum()),
                seconds=time.perf_counter() - t0)
    return Split(ok, y, blk, perm, info)


def partition_split(graphs, mesh: Mesh, reorder: bool = True,
                    use_plan: bool = False) -> Split:
    """Pack ``graphs`` into one batch (rows a multiple of D*8, the JAX
    budget) and :func:`partition_arrays` it; ``info["seconds"]`` covers
    the packing too."""
    t0 = time.perf_counter()
    budget = PadBudget.for_dataset(graphs, batch_size=len(graphs),
                                   node_multiple=mesh.size * 8)
    b = pack_batch(graphs, budget)
    split = partition_arrays(b.senders, b.receivers, b.edge_mask,
                             b.node_feat, b.node_y, b.node_mask, mesh,
                             reorder, use_plan)
    split.info["seconds"] = time.perf_counter() - t0
    return split


def fit_edge_partitioned(dm, mesh: Mesh, mpnn_cfg, optim_cfg, training_cfg,
                         logger, checkpointer=None, reorder: bool = True,
                         eval_only: str | None = None, dtype=None,
                         predictions_sink: dict | None = None,
                         step_timing: bool = False):
    """CLI-reachable edge-partitioned training (``mesh.edge_partition:
    true``, the JAX ``fit_edge_partitioned``): each split packed into one
    batch whose node blocks spread over the mesh's ranks, one full-batch
    step an epoch, the eval cadence and early stop of ``run_fit_loop``.
    Node-level softmax cross entropy only.

    Every rank runs this with the same arguments and reaches the same
    collectives in the same order: evaluation all-gathers the logits, so
    every rank scores the same numbers and stops at the same epoch.  Rank
    0 alone writes snapshots; every rank restores them.

    Returns a ``FitResult`` (``partition``: each split's plan ``info``),
    or with ``eval_only`` ("best" or "latest") the restored snapshot's
    ({split: {"loss", metric}}, meta) for val and test, each split's
    scores and targets over its real rows put in ``predictions_sink``.
    """
    if training_cfg.loss_fn != "softmax_cross_entropy":
        raise ValueError(
            "edge-partitioned path computes node-level softmax cross "
            "entropy; set loss_fn: softmax_cross_entropy")
    if mpnn_cfg.use_batch_norm or mpnn_cfg.use_layer_norm:
        raise ValueError(
            "edge-partitioned paths implement no batch/layer norm (norms "
            "need cross-device statistics the sharded per-device programs "
            "don't compute); set use_batch_norm/use_layer_norm: false")
    conv = mpnn_cfg.conv_type.lower()
    drop = float(mpnn_cfg.dropout or 0.0)
    dims = ([dm.num_features]
            + [mpnn_cfg.hidden_channels] * (mpnn_cfg.num_layers - 1)
            + [dm.num_classes])
    model = build_sharded_model(
        conv, dims, heads=mpnn_cfg.num_heads, dtype=dtype, dropout=drop,
        generator=torch.Generator().manual_seed(training_cfg.seed)
    ).to(mesh.device)
    use_plan = (conv in KERNEL_CONVS
                and kernel_enabled(torch.empty(0, device=mesh.device)))
    if dtype is not None:
        logger.info("[edge-partition] mixed precision: bf16 compute + "
                    "halo payloads, f32 params/logits.")
    splits = {}
    for name in ("train", "val", "test"):
        splits[name] = partition_split(dm.split(name), mesh, reorder,
                                       use_plan)
        i = splits[name].info
        logger.info(f"[edge-partition] {name}: {i['rows']} node rows over "
                    f"{mesh.size} devices, halo width H={i['halo_width']}"
                    f"{' (locality-reordered)' if reorder else ''}; plan "
                    f"{i['seconds']:.2f} s")
    if use_plan:
        logger.info("[edge-partition] local aggregation: csr_spmm / spmm_mh "
                    "kernels on the rank's block")
    metric_fn = METRICS[training_cfg.metric]
    counts = {"train": 0, "eval": 0}

    def scores(split):
        """(logits over the real rows [R, C] on the host, targets [R, C])."""
        s = splits[split]
        counts["eval"] += 1
        logits = gather_logits(model, s.block).cpu()
        return logits[torch.from_numpy(s.node_mask)], s.node_y[s.node_mask]

    def evaluate(split):
        logits, y = scores(split)
        logp = torch.log_softmax(logits, -1)
        loss = float(-(torch.from_numpy(y) * logp).sum(-1).mean())
        return loss, metric_fn(y, logits.numpy())

    if eval_only:
        if checkpointer is None or not checkpointer.has(eval_only):
            raise FileNotFoundError(f"no '{eval_only}' snapshot to evaluate")
        state, meta = checkpointer.restore(eval_only, mesh.device)
        model.load_state_dict(state["model"])
        results = {}
        for split in ("val", "test"):
            loss, perf = evaluate(split)
            results[split] = {"loss": loss, training_cfg.metric: perf}
            if predictions_sink is not None:
                logits, y = scores(split)
                predictions_sink[split] = {"scores": logits.numpy(),
                                           "targets": y}
        return results, meta

    # One step an epoch: the schedule's horizon is the epoch count.
    opt = build_optimizer(model.parameters(), optim_cfg.optim_type,
                          optim_cfg.lr, optim_cfg.weight_decay,
                          optim_cfg.batch_accumulation,
                          optim_cfg.clip_grad_norm,
                          schedule=optim_cfg.schedule,
                          warmup_steps=optim_cfg.warmup_steps,
                          total_steps=training_cfg.epochs)
    # Re-seeded every epoch (dropout_generator's key); held so that a
    # snapshot has the state the fit loop's format expects.
    gen = torch.Generator(device=mesh.device)
    start_epoch, best_loss = _maybe_resume(model, opt, gen, checkpointer,
                                           mesh.device, logger)
    blk = splits["train"].block
    step_seconds = []

    def train_epoch(epoch):
        t0 = time.perf_counter()
        model.train()
        g = (dropout_generator(training_cfg.seed, epoch, mesh.rank,
                               mesh.device) if drop > 0.0 else None)
        loss = loss_and_grads(model, blk, g)
        opt.step()
        counts["train"] += 1
        if step_timing:
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            step_seconds.append(time.perf_counter() - t0)
        # The train metric needs its own forward: eval epochs only.
        perf = (evaluate("train")[1]
                if is_eval_epoch(epoch, training_cfg.epochs,
                                 training_cfg.eval_period) else float("nan"))
        return float(loss), perf

    # Every rank restored above; rank 0 alone writes.
    best, history, stopped, epochs_run = run_fit_loop(
        training_cfg, logger, train_epoch, evaluate,
        checkpointer if mesh.rank == 0 else None,
        lambda: snapshot_state(model, opt, gen), start_epoch, best_loss)
    return FitResult(model=model, best_val_loss=best, history=history,
                     stopped_early=stopped, epochs_run=epochs_run,
                     num_train_steps=counts["train"],
                     num_eval_batches=counts["eval"],
                     step_seconds=step_seconds,
                     partition={k: s.info for k, s in splits.items()})
