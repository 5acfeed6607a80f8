"""Edge-partitioned HSCN: the virtual-node hetero convolution of
models/hscn.py over node blocks sharded across the ranks of a process
group; the counterpart of ``graph_hscn_tpu/parallel/sharded_hscn.py``.

Layout:
  local nodes    contiguous blocks a rank (parallel/edge_partition.py),
                 local->local edges owned by the receiver, the halo
                 exchange of boundary features a layer, issued before the
                 local aggregation and waited for after it;
  virtual nodes  the K cluster rows REPLICATED on every rank: the l->v
                 contraction is a local segment sum over the rank's members
                 followed by an ``all_reduce``, and the l->v attention's
                 softmax is a global segment softmax (``all_reduce`` MAX of
                 the detached logits for the shift, SUM for the denominator
                 and the numerator, [K, H] and [K, H, C]);
  v->v           a dense K x K GCN, computed alike on every rank.

A layer: ll, a GCNConv without self loops (``csr_spmm``, B1, on the rank's
local-edge ``CsrPlan`` at ``hidden >= WIDTH_GATE``, forward and transpose;
the halo edges plain); lv, a bipartite multi-head GAT (H heads of
hidden // H channels, concatenated); vv; with ``virtual_feedback`` a
projection of the K virtual states gathered back by cluster id; then
HeteroConv's sum and a ReLU for each node type.  Logits [Nb, C] float32.

The gradient convention (the opposite of parallel/sharded_scn.py's): each
rank's loss is its own rows' share, so the global sums sit INSIDE a
per-rank loss and every rank's cotangent of a sum is a part of the total.
Their backward therefore sums the cotangents over the ranks
(:class:`AllReduceSum`, the transpose of JAX's ``psum``); the parameter
gradients are then all-reduced as for every sharded model
(``sharded_gcn.loss_and_grads``).

``dtype`` (bfloat16): the local and virtual streams and the halo in it;
the lv logits, the softmax statistics and the logits in float32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from graph_hscn_tpu_torch.models.hscn import vv_adjacency
from graph_hscn_tpu_torch.models.layers import glorot_uniform_, leaky_relu
from graph_hscn_tpu_torch.ops.segment import segment_max, segment_sum
from graph_hscn_tpu_torch.parallel.sharded_gcn import (Affine, _cast,
                                                       local_aggregate)


class AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of a per-rank partial that feeds each rank's
    OWN loss: forward ``all_reduce`` SUM, backward ``all_reduce`` SUM of
    the cotangents (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _LVLayer(nn.Module):
    """JAX's ``lv``: ``kernel_src``/``kernel_dst`` [in, H*C] as
    ``weight_src``/``weight_dst``, ``att_src``/``att_dst`` [H, C]
    (U(-a, a), a = sqrt(6 / (1 + C))), ``bias`` [H*C]."""

    def __init__(self, in_features: int, hidden: int, heads: int,
                 generator=None):
        super().__init__()
        c = hidden // heads
        self.weight_src = nn.Parameter(torch.empty(hidden, in_features))
        self.weight_dst = nn.Parameter(torch.empty(hidden, in_features))
        glorot_uniform_(self.weight_src, generator)
        glorot_uniform_(self.weight_dst, generator)
        a = (6.0 / (1 + c)) ** 0.5
        self.att_src = nn.Parameter(torch.empty(heads, c).uniform_(
            -a, a, generator=generator))
        self.att_dst = nn.Parameter(torch.empty(heads, c).uniform_(
            -a, a, generator=generator))
        self.bias = nn.Parameter(torch.zeros(hidden))


class _HSCNLayer(nn.Module):
    def __init__(self, in_features: int, hidden: int, heads: int,
                 virtual_feedback: bool, generator=None):
        super().__init__()
        self.ll = Affine(in_features, hidden, generator)
        self.lv = _LVLayer(in_features, hidden, heads, generator)
        self.vv = Affine(in_features, hidden, generator)
        self.vl = None
        if virtual_feedback:
            # Zero-init: the feedback channel starts as the identity to
            # the model without it (models/hscn.py VLDense).
            self.vl = Affine(in_features, hidden)
            with torch.no_grad():
                self.vl.weight.zero_()


class ShardedHSCN(nn.Module):
    """``make_sharded_hscn``'s per-rank forward (sharded_hscn.py:101-283).
    ``forward(blk, clusters [Nb] int64)``; ``vv_pattern`` "triangular" or
    "clique" (``compat.vv_triangular_pattern``)."""

    def __init__(self, num_features: int, hidden: int, num_classes: int,
                 num_layers: int, num_clusters: int, heads: int = 1,
                 virtual_feedback: bool = False,
                 vv_pattern: str = "triangular", dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if hidden % heads:
            raise ValueError("hidden must be divisible by heads")
        self.K, self.heads = num_clusters, heads
        self.vv_pattern, self.dtype = vv_pattern, dtype
        dims = [num_features] + [hidden] * num_layers
        self.layers = nn.ModuleList(
            _HSCNLayer(dims[i], hidden, heads, virtual_feedback, generator)
            for i in range(num_layers))
        self.h1 = Affine(hidden, hidden, generator)
        self.h2 = Affine(hidden, num_classes, generator)

    def forward(self, blk, clust: torch.Tensor) -> torch.Tensor:
        K, H, nb, group = self.K, self.heads, blk.nb, blk.group
        mask = blk.ok
        w_loc, w_hal, _ = blk.gcn_norm(self_loops=False)
        # Virtual-node init: the global per-cluster mean of the members'
        # features (no gradient reaches the data).
        x = blk.x
        cnt = segment_sum(mask.to(x.dtype), clust, K)
        x_sum = segment_sum(torch.where(mask[:, None], x, 0.0), clust, K)
        both = torch.cat([cnt[:, None], x_sum], 1)
        dist.all_reduce(both, group=group)
        cnt, x_v = both[:, 0], both[:, 1:] / both[:, :1].clamp_min(1.0)
        v_active = cnt > 0
        adj_vv = vv_adjacency(v_active, 1, K, self.vv_pattern, x.dtype)[0]
        deg_vv = adj_vv.sum(-1)
        ivv = torch.where(deg_vv > 0, torch.rsqrt(deg_vv.clamp_min(1e-12)),
                          0.0)
        a_vv = adj_vv * ivv[:, None] * ivv[None, :]
        x_l, x_v, w_loc, w_hal, a_vv = _cast(self.dtype, x, x_v, w_loc, w_hal,
                                             a_vv)
        for layer in self.layers:
            ll, lv, vv, vl = (_cast(self.dtype, *p) for p in (
                (layer.ll.weight, layer.ll.bias),
                (layer.lv.weight_src, layer.lv.weight_dst),
                (layer.vv.weight, layer.vv.bias),
                () if layer.vl is None else (layer.vl.weight, layer.vl.bias)))
            # local <- local: the halo issued, the local edges aggregated.
            h = F.linear(x_l, ll[0])
            pending = blk.halo(h)
            agg = local_aggregate(h, w_loc, blk)
            halo = pending.wait()
            agg = agg + segment_sum(halo.index_select(0, blk.snd_hal)
                                    * w_hal[:, None], blk.rcv_hal, nb)
            x_l_new = agg + ll[1]
            # virtual <- local: the global segment softmax a head.
            hs = F.linear(x_l, lv[0]).reshape(nb, H, -1)
            hd = F.linear(x_v, lv[1]).reshape(K, H, -1)
            a_s = (hs.float() * layer.lv.att_src).sum(-1)         # [Nb, H]
            a_d = (hd.float() * layer.lv.att_dst).sum(-1)         # [K, H]
            e = leaky_relu(a_s + a_d.index_select(0, clust))
            e = torch.where(mask[:, None], e, -torch.inf)
            with torch.no_grad():
                gmax = segment_max(e, clust, K)
                dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
                gmax = torch.where(torch.isfinite(gmax), gmax, 0.0)
            ex = torch.where(mask[:, None],
                             torch.exp(e - gmax.index_select(0, clust)), 0.0)
            denom = AllReduceSum.apply(segment_sum(ex, clust, K), group)
            num = AllReduceSum.apply(segment_sum(
                hs * ex.to(hs.dtype)[..., None], clust, K), group)
            lv_out = ((num.float() / denom.clamp_min(1e-16)[..., None])
                      .reshape(K, -1) + layer.lv.bias)
            (lv_out,) = _cast(self.dtype, lv_out)
            # virtual <- virtual: the dense K x K GCN, on every rank.
            vv_out = a_vv @ F.linear(x_v, vv[0]) + vv[1]
            if vl:
                # virtual -> local: the K virtual states projected, each
                # local node taking its cluster's.
                x_l_new = x_l_new + F.linear(x_v, vl[0], vl[1]).index_select(
                    0, clust)
            x_l = F.relu(x_l_new)
            x_v = torch.where(v_active[:, None], F.relu(lv_out + vv_out),
                              0.0)
        x_l = torch.where(mask[:, None], x_l, 0.0).float()
        h = F.relu(F.linear(x_l, self.h1.weight, self.h1.bias))
        return F.linear(h, self.h2.weight, self.h2.bias)
