"""Edge-partitioned full-batch training of GCN, GIN and GAT (and the
route of GatedGCN, parallel/sharded_gatedgcn.py, and the ring-attention
GPS, parallel/sharded_gps.py): the counterpart of
``graph_hscn_tpu/parallel/sharded_gcn.py``.

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
from graph_hscn_tpu_torch.utils.profiling import check_nans, training_state

# Below this many columns (H*C for GAT) the local aggregation stays a
# plain gather and index_add_, as JAX's width gate (sharded_gcn.py:91-93).
WIDTH_GATE = 64
KERNEL_CONVS = ("gcn", "gat", "gatedgcn")


class Block:
    """One split's block on this rank, on its device.

    x [Nb, F], y [Nb, C], ok [Nb] (real rows); the halo plan's rank rows:
    send_idx [D*H], snd/rcv/m_loc [El] (local senders), snd/rcv/m_hal [Eh]
    (senders in the halo table); ``csr``: the local edges' ``CsrPlan``, or
    None where the kernels do not run; ``real_rows``: the split's real
    rows over every rank (the loss's divisor); ``group``: the ranks the
    halo exchange (and GPS's ring) spans; ``split_group``: the ranks whose
    blocks make up the split, over which the loss and gradients are summed
    and the logits gathered (``group`` on a 1-D mesh, every rank on the
    hybrid 2-D one, parallel/hybrid.py).  Where the model needs
    them (``extra``, host arrays already in this rank's layout):
    ``e_loc`` [El, Fe] / ``e_hal`` [Eh, Fe] edge features (GatedGCN, GPS's
    GatedGCN local), ``gid`` [Nb] graph ids (GPS), ``outdeg`` [Nb] the
    raw out-degree (the SCN's MinCUT); None otherwise."""

    EXTRA = ("e_loc", "e_hal", "gid", "outdeg")

    def __init__(self, plan: dict, x, y, ok, rank: int, real_rows: int,
                 device, group, csr: CsrPlan | None, split_group=None,
                 **extra):
        def idx(key):
            return torch.from_numpy(plan[key][rank].astype(np.int64)).to(
                device)

        def tensor(a):
            return (None if a is None
                    else torch.from_numpy(np.ascontiguousarray(a)).to(device))

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
        self.split_group = group if split_group is None else split_group
        for key in self.EXTRA:
            setattr(self, key, tensor(extra.get(key)))
        self._gcn_norm = {}

    def halo(self, h: torch.Tensor) -> Halo:
        """Issue the exchange of ``h`` [Nb, F]'s boundary rows."""
        return start_halo(h, self.send_idx, self.group)

    def gcn_norm(self, self_loops: bool = True):
        """(w_loc [El], w_hal [Eh], diag [Nb]) float32: the GCN weights
        ``dinv[send] * dinv[recv]`` (0 on padding edges) and the self
        loop's ``dinv**2``, with ``deg`` the global in-degree, plus one
        with ``self_loops`` (all of a row's edges are on its owner; a row
        of degree 0 gets dinv 0).  The sender's ``dinv`` of a halo edge
        comes from its owner in one exchange, the first time a forward
        asks (every rank asks at the same forward)."""
        if self_loops not in self._gcn_norm:
            with torch.no_grad():
                ones_l = self.m_loc.float()
                ones_h = self.m_hal.float()
                deg = (segment_sum(ones_l, self.rcv_loc, self.nb)
                       + segment_sum(ones_h, self.rcv_hal, self.nb)
                       + float(self_loops))
                dinv = torch.where(deg > 0,
                                   torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
                dinv_halo = self.halo(dinv[:, None]).wait()[:, 0]
                w_loc = torch.where(self.m_loc, dinv[self.snd_loc]
                                    * dinv[self.rcv_loc], 0.0)
                w_hal = torch.where(self.m_hal, dinv_halo[self.snd_hal]
                                    * dinv[self.rcv_hal], 0.0)
                self._gcn_norm[self_loops] = (w_loc, w_hal, dinv * dinv)
        return self._gcn_norm[self_loops]


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


class Affine(nn.Module):
    """JAX's ``{"kernel" [in, out], "bias"}``: weight [out, in]
    (glorot-uniform), bias (zero), applied by its model."""

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
            Affine(dims[i], dims[i + 1], generator)
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
                        generator: torch.Generator | None = None,
                        edge_features: int | None = None,
                        local_conv: str = "gcn",
                        hidden: int | None = None) -> nn.Module:
    """``conv`` "gcn", "gin", "gat", "gatedgcn" or "gps" over ``dims``
    (input, hidden..., classes: one layer a step of ``dims``; GatedGCN and
    GPS run all their layers ``hidden`` wide, by default ``dims[1]``).
    ``edge_features``: the batch's edge-feature width (GatedGCN, GPS's
    GatedGCN local), None without; ``local_conv``: GPS's local module,
    "gcn" or "gatedgcn"."""
    hidden = hidden or dims[1]
    if conv == "gcn":
        return ShardedGCN(dims, dtype, dropout, generator)
    if conv == "gin":
        return ShardedGIN(dims, dtype, dropout, generator)
    if conv == "gat":
        return ShardedGAT(dims, heads, dtype, dropout, generator)
    if conv == "gatedgcn":
        from graph_hscn_tpu_torch.parallel.sharded_gatedgcn import \
            ShardedGatedGCN
        return ShardedGatedGCN(dims[0], edge_features, hidden, dims[-1],
                               len(dims) - 1, dtype, dropout, generator)
    if conv == "gps":
        from graph_hscn_tpu_torch.parallel.sharded_gps import ShardedGPS
        return ShardedGPS(dims[0], hidden, dims[-1], len(dims) - 1, heads,
                          local_conv, edge_features, dtype, dropout,
                          generator=generator)
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


def all_reduce_grads(params: list, group, loss: torch.Tensor | None = None
                     ) -> torch.Tensor | None:
    """Every parameter's gradient (zeros where it has none) summed over
    the ranks, and ``loss`` (0-d) with them where given, in one
    ``all_reduce`` of a flat buffer; the sums are left in ``p.grad``.
    Returns the summed loss, or None."""
    extra = [] if loss is None else [loss.reshape(1)]
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params] + extra)
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return None if loss is None else flat[-1]


def loss_and_grads(model: nn.Module, blk: Block, *args) -> torch.Tensor:
    """The split's loss and the gradient of every parameter, both summed
    over the ranks in one ``all_reduce`` of a flat buffer; the gradients
    are left in ``p.grad``.  ``args`` go to the model after the block
    (a dropout generator; an HSCN's cluster ids).  Returns the loss (0-d,
    on the device)."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss = local_loss(model(blk, *args), blk)
    loss.backward()
    return all_reduce_grads(params, blk.split_group, loss.detach())


@torch.no_grad()
def gather_logits(model: nn.Module, blk: Block, *args) -> torch.Tensor:
    """The split's logits [N, C] float32 on every rank: the model's
    forward on ``blk`` (and ``args``) in eval mode, the blocks
    all-gathered."""
    model.eval()
    return all_gather_rows(model(blk, *args), blk.split_group)


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
                     use_plan: bool = False, edge_feat=None, node_graph=None,
                     outdeg: bool = False) -> Split:
    """A packed batch's arrays (receiver-sorted edges, rows a multiple of
    the mesh size) as a :class:`Split`: its nodes reordered by
    Cuthill-McKee and its edges re-sorted by receiver when ``reorder``,
    the halo exchange planned, and ``mesh.rank``'s block kept on
    ``mesh.device`` (with its local edges' ``CsrPlan`` when
    ``use_plan``).  Where given, the block carries the edge features
    ``edge_feat`` [E, Fe] in its local and halo groups (the plan's edge
    indices composed through the re-sort's order, as JAX's
    ``fit_edge_partitioned`` does) and the graph ids ``node_graph`` [N];
    with ``outdeg`` the raw out-degree of its rows.  Every rank computes
    the same plan."""
    t0 = time.perf_counter()
    D, rank = mesh.size, mesh.rank
    n = node_feat.shape[0]
    snd, rcv, em = senders, receivers, edge_mask
    x, y, ok, gid = node_feat, node_y, node_mask, node_graph
    perm = eo = None
    if reorder:
        perm = locality_reorder(snd, rcv, em, n, node_mask=ok)
        snd, rcv, x, y, ok = apply_node_reorder(perm, snd, rcv, x, y, ok)
        if gid is not None:
            gid = gid[perm]
        # The CSR plans need the receiver sort back.
        snd, rcv, em, eo = sort_edges_by_receiver(snd, rcv, em, n)
    plan = plan_halo_exchange(snd, rcv, em, n, D)
    if eo is not None:
        # The plan's edge indices address the re-sorted edges: back to
        # the batch's own order, where edge_feat's rows are.
        plan["eidx_loc"] = eo[plan["eidx_loc"]]
        plan["eidx_hal"] = eo[plan["eidx_hal"]]
    extra = {}
    if edge_feat is not None:
        from graph_hscn_tpu_torch.parallel.sharded_gatedgcn import \
            gather_edge_groups
        e_loc, e_hal = gather_edge_groups(edge_feat, plan)
        extra.update(e_loc=e_loc[rank], e_hal=e_hal[rank])
    if gid is not None:
        extra["gid"] = rank_block(gid.astype(np.int64), rank, D)
    if outdeg:
        deg = np.bincount(snd[em], minlength=n).astype(np.float32)
        extra["outdeg"] = rank_block(deg, rank, D)
    csr = local_csr_plan(plan, rank) if use_plan else None
    blk = Block(plan, rank_block(x, rank, D), rank_block(y, rank, D),
                rank_block(ok, rank, D), rank, int(ok.sum()), mesh.device,
                mesh.group, csr, **extra)
    info = dict(rows=n, block_rows=plan["block_size"],
                edges=int(em.sum()), halo_width=plan["halo_width"],
                local_edges=int(plan["mask_loc"][rank].sum()),
                halo_edges=int(plan["mask_hal"][rank].sum()),
                seconds=time.perf_counter() - t0)
    return Split(ok, y, blk, perm, info)


def partition_split(graphs, mesh: Mesh, reorder: bool = True,
                    use_plan: bool = False, edges: bool = False,
                    graph_ids: bool = False, outdeg: bool = False) -> Split:
    """Pack ``graphs`` into one batch (rows a multiple of D*8, the JAX
    budget) and :func:`partition_arrays` it, with the batch's edge
    features (``edges``, where it has them) and graph ids
    (``graph_ids``); ``info["seconds"]`` covers the packing too."""
    t0 = time.perf_counter()
    budget = PadBudget.for_dataset(graphs, batch_size=len(graphs),
                                   node_multiple=mesh.size * 8)
    b = pack_batch(graphs, budget)
    split = partition_arrays(b.senders, b.receivers, b.edge_mask,
                             b.node_feat, b.node_y, b.node_mask, mesh,
                             reorder, use_plan,
                             edge_feat=b.edge_feat if edges else None,
                             node_graph=b.node_graph if graph_ids else None,
                             outdeg=outdeg)
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
    if conv not in ("gcn", "gat", "gin", "gatedgcn", "gps"):
        raise ValueError("edge-partitioned path supports conv_type gcn, gat,"
                         f" gin, gatedgcn or gps, got {mpnn_cfg.conv_type!r}")
    local_conv = mpnn_cfg.gps_local_conv.lower()
    drop = float(mpnn_cfg.dropout or 0.0)
    use_plan = (conv in KERNEL_CONVS
                and kernel_enabled(torch.empty(0, device=mesh.device)))
    if dtype is not None:
        logger.info("[edge-partition] mixed precision: bf16 compute + "
                    "halo payloads, f32 params/logits.")
    # GatedGCN and GPS's GatedGCN local keep the edge features; GPS's
    # attention masks by graph id.
    edges = conv == "gatedgcn" or (conv == "gps" and local_conv == "gatedgcn")
    splits = {}
    for name in ("train", "val", "test"):
        splits[name] = partition_split(dm.split(name), mesh, reorder,
                                       use_plan, edges=edges,
                                       graph_ids=conv == "gps")
        i = splits[name].info
        logger.info(f"[edge-partition] {name}: {i['rows']} node rows over "
                    f"{mesh.size} devices, halo width H={i['halo_width']}"
                    f"{' (locality-reordered)' if reorder else ''}; plan "
                    f"{i['seconds']:.2f} s")
    if use_plan:
        logger.info("[edge-partition] local aggregation: csr_spmm / spmm_mh "
                    "/ segment_reduce kernels on the rank's block")
    e_loc = splits["train"].block.e_loc
    dims = ([dm.num_features]
            + [mpnn_cfg.hidden_channels] * (mpnn_cfg.num_layers - 1)
            + [dm.num_classes])
    model = build_sharded_model(
        conv, dims, heads=mpnn_cfg.num_heads, dtype=dtype, dropout=drop,
        generator=torch.Generator().manual_seed(training_cfg.seed),
        edge_features=None if e_loc is None else e_loc.shape[-1],
        local_conv=local_conv, hidden=mpnn_cfg.hidden_channels
    ).to(mesh.device)
    return fit_blocks(model, splits, mesh, optim_cfg, training_cfg, logger,
                      checkpointer, eval_only, predictions_sink, step_timing,
                      dropout=drop)


def fit_blocks(model: nn.Module, splits: dict, mesh: Mesh, optim_cfg,
               training_cfg, logger, checkpointer=None,
               eval_only: str | None = None,
               predictions_sink: dict | None = None,
               step_timing: bool = False, dropout: float = 0.0,
               args: dict | None = None, train_edges: int | None = None):
    """The fit of a sharded model on packed ``splits`` ({name:
    :class:`Split`}), shared by ``fit_edge_partitioned`` and the HSCN
    pipeline's: one full-batch step an epoch with ``run_fit_loop``'s eval
    cadence, early stop and checkpoints (every rank restores, rank 0
    writes), or with ``eval_only`` the restored snapshot's ({split:
    {"loss", metric}}, meta).  ``args``: {split: the model's arguments
    after the block} (an HSCN's cluster ids); without them a train step
    passes the epoch's dropout generator (``dropout`` > 0) or None.
    ``train_edges``: the epoch line's edge count (default: the packed
    train split's real edges, JAX's ``edge_mask`` sum).

    With ``runtime.debug_nans`` every train step's loss, the weights and
    the optimizer state, and every forward's gathered logits, are checked
    for NaN, the flags all-reduced over the mesh so that every rank
    raises together (JAX's ``shard_map`` program fails as one)."""
    metric_fn = METRICS[training_cfg.metric]
    counts = {"train": 0, "eval": 0}

    def scores(split):
        """(logits over the real rows [R, C] on the host, targets [R, C])."""
        s = splits[split]
        counts["eval"] += 1
        logits = gather_logits(model, s.block,
                               *(args or {}).get(split, ()))
        check_nans("forward", [("logits", logits)], group=mesh.group)
        logits = logits.cpu()
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
    if train_edges is None:
        train_edges = splits["train"].info["edges"]
    step_seconds = []

    def train_epoch(epoch):
        t0 = time.perf_counter()
        model.train()
        if args is not None:
            step_args = args["train"]
        else:
            step_args = (dropout_generator(training_cfg.seed, epoch,
                                           mesh.rank, mesh.device)
                         if dropout > 0.0 else None,)
        loss = loss_and_grads(model, blk, *step_args)
        opt.step()
        check_nans("train step", [("loss", loss)],
                   training_state(model, opt), group=mesh.group)
        counts["train"] += 1
        if step_timing:
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            step_seconds.append(time.perf_counter() - t0)
        # The train metric needs its own forward: eval epochs only.
        perf = (evaluate("train")[1]
                if is_eval_epoch(epoch, training_cfg.epochs,
                                 training_cfg.eval_period) else float("nan"))
        return float(loss), perf, train_edges

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
