"""Graph conv layers (torch.nn) with PyG-parity math: the counterpart of
``graph_hscn_tpu/models/layers.py``.

Layers consume the flat CSR representation of a GraphBatch:
  x [N, F], senders [E], receivers [E] (sorted), edge_mask [E]
and are pure w.r.t. padding: padded rows in, zero rows out.

Parameters follow torch's layout: a flax ``kernel`` [in, out] is a
``weight`` [out, in] here (``models/convert.py`` maps one onto the other).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import (SpmmMhFunction,
                                                            gat_edge_logits)
from graph_hscn_tpu_torch.ops.segment import (gather_planned, segment_max,
                                              segment_softmax, segment_sum,
                                              segment_sum_planned)
from graph_hscn_tpu_torch.ops.spmm import (gather_scatter, gcn_norm_weights,
                                           kernel_enabled)


def resolve_dtype(name: str | None) -> torch.dtype | None:
    """Config string -> compute dtype (None = native float32)."""
    if name in (None, "", "float32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"Unknown compute_dtype {name!r}")


def promote_dtype(*tensors: torch.Tensor, dtype: torch.dtype | None = None):
    """flax ``nn.dtypes.promote_dtype``: cast every tensor to ``dtype``, or
    to their common type when it is None."""
    if dtype is None:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def glorot_uniform_(weight: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``glorot_uniform`` on a torch [out, in] weight: U(-a, a) with
    a = sqrt(6 / (fan_in + fan_out))."""
    fan_out, fan_in = weight.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-a, a, generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``lecun_normal`` (the default kernel init of ``nn.Dense``) on a
    torch [out, in] weight: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate).  The bits come from ``generator``."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class GCNConv(nn.Module):
    """PyG GCNConv:  X' = D^-1/2 (A + I) D^-1/2 X W + b.

    Self-loops are folded in as a diagonal term (weight 1/(deg_i+1)) rather
    than materialized edges, which keeps the edge array static.  Both
    branches of the JAX layer (layers.py:62-127): the sparse one through
    ``gather_scatter``, and for slotted batches the dense one, a batched
    matmul over per-graph ``[G, S, S]`` adjacencies.
    """

    def __init__(self, in_features: int, features: int,
                 add_self_loops: bool = True, normalize: bool = True,
                 use_bias: bool = True, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        self.dtype = dtype     # compute dtype (params stay float32)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    @staticmethod
    def normalize_dense(dense_adj: torch.Tensor, add_self_loops: bool = True,
                        normalize: bool = True):
        """The layer-independent normalized adjacency and self-loop
        diagonal, computed once a forward for the whole stack."""
        adj = dense_adj
        deg = adj.sum(-1)
        if add_self_loops:
            deg = deg + 1.0
        inv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
        if normalize:
            adj = adj * inv[:, :, None] * inv[:, None, :]
        diag = (inv * inv) if (add_self_loops and normalize) else None
        return adj, diag

    def forward(self, x, senders, receivers, edge_mask, edge_weight=None,
                num_nodes=None, plan=None, dense_adj=None, dense_diag=None):
        """``dense_adj``/``dense_diag``: the slotted branch's adjacency and
        self-loop diagonal, normalized once a forward by
        :meth:`normalize_dense` (the JAX layer's dense_pre_normalized)."""
        n = num_nodes or x.shape[0]
        x, w = promote_dtype(x, self.weight, dtype=self.dtype)
        h = F.linear(x, w)
        if dense_adj is not None:
            out = self._dense(h, n, dense_adj.to(h.dtype), dense_diag)
        else:
            out = self._sparse(h, senders, receivers, edge_mask, edge_weight,
                               n, plan)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    def _sparse(self, h, senders, receivers, edge_mask, edge_weight, n, plan):
        if self.normalize:
            # Weighted degree when edge_weight is given (PyG gcn_norm
            # computes deg from the edge weights, not the edge count).
            norm_w, diag = gcn_norm_weights(
                senders, receivers, edge_mask, n,
                add_self_loops=self.add_self_loops, edge_weight=edge_weight)
        else:
            norm_w = torch.where(
                edge_mask,
                edge_weight if edge_weight is not None else 1.0, 0.0)
            diag = None
        out = gather_scatter(h, senders, receivers, num_nodes=n,
                             edge_weight=norm_w.to(h.dtype), plan=plan)
        if diag is not None:
            out = out + diag.to(h.dtype)[:, None] * h
        return out

    def _dense(self, h, n, adj, diag):
        """Slotted dense branch: ``adj @ h`` a graph block, plus the
        self-loop diagonal; rows past the blocks are padding (zeros)."""
        if diag is not None:
            diag = diag.to(h.dtype)
        G, S = adj.shape[0], adj.shape[-1]
        hb = h.reshape(-1, S, h.shape[-1])[:G]
        outb = torch.bmm(adj, hb)
        if diag is not None:
            outb = outb + diag[:, :, None] * hb
        out = outb.reshape(-1, h.shape[-1])
        return F.pad(out, (0, 0, 0, n - out.shape[0]))


class GraphConv(nn.Module):
    """PyG GraphConv (Weisfeiler-Leman), the JAX layer's (layers.py:130-184):
        X'_i = W_root x_i + W_rel (sum_j w_ij x_j) + b
    with add-aggregation and optional per-edge weights; the SCN clustering
    stack's conv.  ``self_weight`` [N] adds ``self_weight_i * x_i`` to the
    aggregate (the gcn_norm self-loop routed through W_rel).  Branches: the
    sparse one through ``gather_scatter`` (the CSR kernel when a plan is
    attached and the backend allows), and for slotted batches the dense
    one, ``dense_adj`` [G, S, S] already carrying the edge weights.

    Parameters: ``weight_rel`` and ``weight_root`` [out, in] (flax
    ``kernel_rel``/``kernel_root`` [in, out]) and ``bias``.  float32 only,
    with a bias: SCN, its one user, sets neither the JAX layer's ``dtype``
    nor its ``use_bias``.
    """

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight_rel = nn.Parameter(torch.empty(features, in_features))
        self.weight_root = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight_rel, generator)
        glorot_uniform_(self.weight_root, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, senders, receivers, edge_mask, edge_weight=None,
                num_nodes=None, self_weight=None, dense_adj=None, plan=None):
        n = num_nodes or x.shape[0]
        if dense_adj is not None:
            G, S = dense_adj.shape[0], dense_adj.shape[-1]
            agg = torch.bmm(dense_adj, x.reshape(-1, S, x.shape[-1])[:G])
            agg = agg.reshape(-1, x.shape[-1])
            agg = F.pad(agg, (0, 0, 0, n - agg.shape[0]))
        else:
            w_eff = (edge_weight if edge_weight is not None
                     else torch.ones(senders.shape, dtype=x.dtype,
                                     device=x.device))
            w_eff = torch.where(edge_mask, w_eff, 0.0)
            agg = gather_scatter(x, senders, receivers, num_nodes=n,
                                 edge_weight=w_eff, plan=plan)
        if self_weight is not None:
            agg = agg + self_weight[:, None] * x
        return (F.linear(agg, self.weight_rel) + F.linear(x, self.weight_root)
                + self.bias)


class GINConv(nn.Module):
    """GIN, the JAX layer's (layers.py:187-228):
        X'_i = MLP((1 + eps) x_i + sum_j w_ij x_j),   eps = 0
    with the MLP ``Dense -> relu -> Dense``, both ``features`` wide
    (``train_eps`` is off in every config, so eps is the constant 0 and
    ``(1 + eps) x`` is ``x``).  Branches: for slotted batches the dense one,
    ``dense_adj`` [G, S, S] the RAW adjacency counts (the MPNN passes GIN
    no normalization, unlike GCN); else the sparse one through
    ``gather_scatter``, the edge mask (times ``edge_weight``) as the
    weights, with the CSR plan when the batch has one (the ``csr_spmm``
    kernel: forward, and the transpose for dx; the weights take no
    gradient, so no SDDMM).

    Parameters: ``mlp`` (flax ``Dense_0``, ``Dense_1``).
    """

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.mlp = MLP(in_features, (features, features), dtype=dtype,
                       generator=generator)

    def forward(self, x, senders, receivers, edge_mask, edge_weight=None,
                num_nodes=None, dense_adj=None, plan=None):
        n = num_nodes or x.shape[0]
        if self.dtype is not None:
            x = x.to(self.dtype)
            if dense_adj is not None:
                dense_adj = dense_adj.to(self.dtype)
            if edge_weight is not None:
                edge_weight = edge_weight.to(self.dtype)
        if dense_adj is not None:
            G, S = dense_adj.shape[0], dense_adj.shape[-1]
            agg = torch.bmm(dense_adj, x.reshape(-1, S, x.shape[-1])[:G])
            agg = F.pad(agg.reshape(-1, x.shape[-1]),
                        (0, 0, 0, n - G * S))
        else:
            w = torch.where(edge_mask, 1.0, 0.0)
            if edge_weight is not None:
                w = w * edge_weight
            agg = gather_scatter(x, senders, receivers, num_nodes=n,
                                 edge_weight=w, plan=plan)
        return self.mlp(x + agg)


GAT_NEGATIVE_SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.leaky_relu`` at GAT's slope: x where x >= 0 (gradient 1
    at 0)."""
    return torch.where(x >= 0, x, GAT_NEGATIVE_SLOPE * x)


class GATConv(nn.Module):
    """PyG GATConv (heads H, concat), the JAX layer's (layers.py:231-415):
        h_i = W x_i                       (per head)
        e_ij = LeakyReLU(a_src . h_j + a_dst . h_i, slope=0.2)
        alpha_ij = softmax_{j in N(i)} e_ij      (over incoming edges)
        X'_i = sum_j alpha_ij h_j  (+ bias)
    With ``add_self_loops`` a self-edge joins each node's softmax.

    Branches: the slotted dense one (masked dense attention a graph block);
    the sparse kernel path when a CSR plan is attached and the backend
    allows (``gat_edge_logits`` and ``spmm_mh``, dividing after
    aggregation, the max shift detached); otherwise the sparse gather path.

    Bipartite (HSCN's local->virtual relation, ``dst_features`` set): the
    receivers are ``num_dst_nodes`` nodes with their own features ``x_dst``
    and projection, no self loops join the softmax, and no kernel runs
    (the receivers need not be sorted, so no CSR plan describes them), as
    in the JAX layer.

    Parameters: ``weight`` [H*C, in] (flax ``kernel_src`` [in, H*C]),
    ``weight_dst`` [H*C, dst_features] when bipartite (flax
    ``kernel_dst``), ``att_src``/``att_dst`` [1, H, C] as in flax,
    ``bias`` [H*C] (concat) or [C] (mean over heads).
    """

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 concat: bool = True, add_self_loops: bool = True,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dst_features: int | None = None):
        super().__init__()
        self.heads, self.features = heads, features
        self.concat = concat
        self.add_self_loops = add_self_loops
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(heads * features, in_features))
        glorot_uniform_(self.weight, generator)
        self.weight_dst = None
        if dst_features is not None:
            self.weight_dst = nn.Parameter(
                torch.empty(heads * features, dst_features))
            glorot_uniform_(self.weight_dst, generator)
        # flax glorot on a (1, H, C) array: fan_in H, fan_out C.
        a = math.sqrt(6.0 / (heads + features))
        self.att_src = nn.Parameter(torch.empty(1, heads, features))
        self.att_dst = nn.Parameter(torch.empty(1, heads, features))
        with torch.no_grad():
            for att in (self.att_src, self.att_dst):
                att.uniform_(-a, a, generator=generator)
        dim = heads * features if concat else features
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, senders, receivers, edge_mask, edge_weight=None,
                num_nodes=None, plan=None, dense_adj=None, x_dst=None,
                num_dst_nodes=None):
        H, C = self.heads, self.features
        x, w = promote_dtype(x, self.weight, dtype=self.dtype)
        h = F.linear(x, w).reshape(-1, H, C)
        att_src = self.att_src.to(h.dtype)
        att_dst = self.att_dst.to(h.dtype)
        n = num_nodes or x.shape[0]
        if x_dst is not None:
            if self.weight_dst is None:
                raise ValueError("x_dst given to a GATConv built without "
                                 "dst_features")
            n = num_dst_nodes or x_dst.shape[0]
            x_dst, w_dst = promote_dtype(x_dst, self.weight_dst,
                                         dtype=self.dtype)
            h_dst = F.linear(x_dst, w_dst).reshape(-1, H, C)
            out = self._bipartite(h, h_dst, senders, receivers, edge_mask, n,
                                  att_src, att_dst)
        elif dense_adj is not None:
            if edge_weight is not None:
                raise ValueError(
                    "GATConv dense-slotted path does not support "
                    "edge_weight; pass dense_adj=None to use the sparse "
                    "path")
            out = self._dense(h, n, dense_adj, att_src, att_dst)
        else:
            out = self._sparse(h, senders, receivers, edge_mask, n, plan,
                               att_src, att_dst)
        out = out.reshape(n, H * C) if self.concat else out.mean(1)
        return out + self.bias.to(out.dtype)

    def _dense(self, h, n, adj, att_src, att_dst):
        """Masked dense attention a graph block: scores[g, i, j, h] for the
        edge j -> i; rows past the blocks are padding (zeros)."""
        G, S = adj.shape[0], adj.shape[-1]
        H, C = self.heads, self.features
        hb = h.reshape(-1, S, H, C)[:G]
        a_s = (hb * att_src[None]).sum(-1)                 # [G, S, H]
        a_d = (hb * att_dst[None]).sum(-1)
        e = leaky_relu(a_s[:, None, :, :] + a_d[:, :, None, :])
        conn = adj > 0                                     # [G, S, S]
        if self.add_self_loops:
            conn = conn | torch.eye(S, dtype=torch.bool, device=adj.device)
        e = torch.where(conn[..., None], e, -torch.inf)
        m = e.amax(dim=2, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        ex = torch.where(conn[..., None], torch.exp(e - m), 0.0)
        alpha = ex / ex.sum(dim=2, keepdim=True).clamp_min(1e-16)
        out = torch.einsum("gijh,gjhc->gihc", alpha, hb).reshape(-1, H, C)
        return F.pad(out, (0, 0, 0, 0, 0, n - out.shape[0]))

    @staticmethod
    def _bipartite(h_src, h_dst, senders, receivers, edge_mask, n_dst,
                   att_src, att_dst):
        """Attention of ``n_dst`` receivers over their incoming edges from
        the source nodes, softmax over each receiver's edges; plain
        gathers and segment sums, whose order of receivers is free."""
        a_src = (h_src * att_src).sum(-1)                   # [N_src, H]
        a_dst = (h_dst * att_dst).sum(-1)                   # [N_dst, H]
        e = leaky_relu(a_src[senders] + a_dst[receivers])
        alpha = segment_softmax(e, receivers, n_dst, mask=edge_mask[:, None])
        return segment_sum(h_src[senders] * alpha[..., None], receivers,
                           n_dst)

    def _sparse(self, h, senders, receivers, edge_mask, n, plan, att_src,
                att_dst):
        H, C = self.heads, self.features
        kernels = plan is not None and kernel_enabled(h)
        mask = edge_mask[:, None]
        a_src = (h * att_src).sum(-1)                       # [N, H]
        a_dst = (h * att_dst).sum(-1)
        if kernels:
            e = gat_edge_logits(a_src, a_dst, plan)
        else:
            e = a_src[senders] + a_dst[receivers]           # [E, H]
        e = leaky_relu(e)

        def aggregate(alpha):
            """sum_j alpha_ij h_j a head: all heads in one spmm_mh launch
            on the kernel path, [E, H, C] messages on the gather path."""
            if kernels:
                out = SpmmMhFunction.apply(h.reshape(-1, H * C), alpha, plan)
                return out.reshape(n, H, C).to(h.dtype)
            return segment_sum(h[senders] * alpha[..., None], receivers, n)

        if not self.add_self_loops and not kernels:
            return aggregate(segment_softmax(e, receivers, n, mask=mask))
        # The max shift, detached: the softmax is invariant to it, so its
        # total gradient is zero (and the shift's SDDMM needs no backward).
        m = segment_max(torch.where(mask, e, -torch.inf), receivers, n)
        if self.add_self_loops:
            self_e = leaky_relu(a_src + a_dst)              # [N, H]
            m = torch.maximum(m, self_e)
        m = torch.where(torch.isfinite(m), m, 0.0).detach()
        m_e = (gat_edge_logits(torch.zeros_like(m), m, plan) if kernels
               else m[receivers])
        exp_e = torch.where(mask, torch.exp(e - m_e), 0.0)
        denom = segment_sum(exp_e, receivers, n)
        exp_self = None
        if self.add_self_loops:
            exp_self = torch.exp(self_e - m)
            denom = denom + exp_self
        if kernels:
            # Divide after aggregation: a node-level scale instead of an
            # [E, H] gather of denom; the self term shares it.
            inv = 1.0 / denom.clamp_min(1e-16)
            out = aggregate(exp_e) * inv[..., None]
            if exp_self is not None:
                out = out + h * (exp_self * inv)[..., None]
            return out
        alpha = exp_e / denom[receivers].clamp_min(1e-16)
        alpha_self = exp_self / denom.clamp_min(1e-16)
        return aggregate(alpha) + h * alpha_self[..., None]


class Dense(nn.Module):
    """flax ``nn.Dense`` (glorot-uniform kernel, zero bias): ``weight``
    [out, in], computed in ``dtype`` when it is given (params stay
    float32)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*promote_dtype(x, self.weight, self.bias,
                                       dtype=self.dtype))


LAYER_NORM_EPS = 1e-6   # flax's default; torch's is 1e-5


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon ``LAYER_NORM_EPS``,
    ``scale`` and ``bias``, statistics in float32; the result in ``dtype``,
    or float32 when it is None."""

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, LAYER_NORM_EPS).to(
                                self.dtype or torch.float32)


class GatedGCNConv(nn.Module):
    """GatedGCN (Bresson & Laurent), the JAX layer's (layers.py:418-479):
        e'_ij = C e_ij + D x_i + E x_j
        eta_ij = sigmoid(e'_ij) / (sum_j' sigmoid(e'_ij') + eps)
        x'_i = A x_i + sum_j eta_ij * (B x_j)
    then (``norm="layer"``) LayerNorm on x' and e', relu, (``residual``)
    the residuals where the input is ``features`` wide, and e' zeroed on
    padding edges (eps = 1e-6).  Returns (x', e').  Node and edge states go
    in ``features`` wide, as in both JAX users: GatedGCNNet (residual,
    LayerNorm) and GPS's local module (``residual=False, norm="none"``).

    With a CSR plan and the backend allowing it, the two segment sums and
    the backwards of the three edge gathers run the ``segment_reduce``
    kernel (``segment_sum_planned``, ``gather_planned``): 2 launches a
    layer forward, 3 backward.  Zeroing e' on padding edges is what keeps
    ``gather_planned``'s contract (zero cotangents there).

    Parameters: ``A`` .. ``E`` (flax ``Dense_0`` .. ``Dense_4``), and with
    ``norm="layer"`` ``norm_x`` and ``norm_e`` (``LayerNorm_0``,
    ``LayerNorm_1``).
    """

    EPS = 1e-6

    def __init__(self, features: int, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 residual: bool = True, norm: str = "layer"):
        super().__init__()
        if norm not in ("layer", "none"):
            raise ValueError(f"GatedGCNConv norm {norm!r}: 'layer' or "
                             "'none'")
        self.features = features
        self.dtype = dtype
        self.residual = residual
        for name in "ABCDE":
            setattr(self, name, Dense(features, features, dtype, generator))
        self.norm_x = self.norm_e = None
        if norm == "layer":
            self.norm_x = LayerNorm(features, dtype=dtype)
            self.norm_e = LayerNorm(features, dtype=dtype)

    def forward(self, x, edge_feat, senders, receivers, edge_mask,
                num_nodes=None, plan=None):
        n = num_nodes or x.shape[0]
        if self.dtype is not None:
            x, edge_feat = x.to(self.dtype), edge_feat.to(self.dtype)
        mask = edge_mask[:, None]
        e_new = (self.C(edge_feat)
                 + gather_planned(self.D(x), receivers, plan)
                 + gather_planned(self.E(x), senders, plan, side="sender"))
        sig = torch.where(mask, torch.sigmoid(e_new), 0.0)
        denom = segment_sum_planned(sig, receivers, n, plan)
        msgs = sig * gather_planned(self.B(x), senders, plan, side="sender")
        agg = segment_sum_planned(msgs, receivers, n, plan)
        x_new = self.A(x) + agg / (denom + self.EPS)
        if self.norm_x is not None:
            x_new, e_new = self.norm_x(x_new), self.norm_e(e_new)
        x_new, e_new = torch.relu(x_new), torch.relu(e_new)
        if self.residual and x.shape[-1] == self.features:
            x_new = x + x_new
        if self.residual and edge_feat.shape[-1] == self.features:
            e_new = edge_feat + e_new
        return x_new, torch.where(mask, e_new, 0.0)


ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    # flax nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


class MLP(nn.Module):
    """flax ``MLP`` (layers.py:491-505) as GIN uses it: a ``Dense`` a
    width of ``features``, relu between them, none after the last.
    Parameters: ``layers.i`` (flax ``Dense_i``)."""

    def __init__(self, in_features: int, features,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(Dense(a, b, dtype, generator)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
