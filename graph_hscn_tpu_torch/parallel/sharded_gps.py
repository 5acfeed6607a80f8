"""Edge-partitioned GPS with ring attention: the counterpart of
``graph_hscn_tpu/parallel/sharded_gps.py``.

The node dimension is sharded as the sharded GCN's (contiguous node blocks,
receiver-owned edges, the halo exchange for the local conv), and the
global attention runs as a RING: each rank keeps the queries of its block,
the K/V blocks (with the keys' graph ids and node mask) travel to rank
``(r + 1) % D`` after each of the D steps, and the softmax is accumulated
online (running max, denominator and numerator in float32, flash-attention
style) over key tiles of ``_pick_tile`` rows, so no rank holds an [N, N]
score matrix.  A query attends only to the keys of its own graph (an
additive ``NEG_INF`` bias elsewhere and on padding keys), which makes the
result the per-graph attention of the single-device GPS.

The tile step is recomputed in the backward (``torch.utils.checkpoint``):
saving every tile's [Nb, heads, tile] probabilities would cost O(N^2)
memory, what the online softmax exists to avoid.  The ring's hop is an
autograd Function over ``batch_isend_irecv``: its backward sends the
gradient the other way round.  The last hop would only bring each block
home, so it is skipped; at D = 1 the ring is the identity.  Plain torch,
as JAX is plain XLA: no kernel runs here.

Layers follow models/gps.py: pre-norm, a local conv (``"gcn"``: the halo
GCN with the self loop folded in; ``"gatedgcn"``: the GatedGCN recipe of
parallel/sharded_gatedgcn.py without residual or norm, on plain ops, as
JAX passes it no plan), the ring attention and a GELU FFN, with residuals
and three dropout sites a layer.  ``dtype`` (bfloat16): the residual
stream and the softmax statistics stay float32; matmul inputs, the halo
and the K/V ring blocks run in ``dtype``.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from graph_hscn_tpu_torch.models.layers import Dense, LayerNorm, dropout
from graph_hscn_tpu_torch.ops.segment import segment_sum
from graph_hscn_tpu_torch.parallel.sharded_gatedgcn import (GatedLinears,
                                                             gated_messages)
from graph_hscn_tpu_torch.parallel.sharded_gcn import Affine

NEG_INF = -1e9   # the additive key-mask bias (models/gps.py's)


class _RingShift(torch.autograd.Function):
    """Send ``x`` to rank (r + 1) % D and receive rank (r - 1) % D's;
    backward: the same hop of the gradient, the other way round."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group, +1)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g.contiguous(), ctx.group, -1), None


def ring_shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` from rank (r - step) % D, this rank's sent to (r + step) % D
    (not differentiable: :class:`_RingShift` is)."""
    D, r = dist.get_world_size(group), dist.get_rank(group)

    def peer(i):
        return dist.get_global_rank(group, i % D)

    out = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), peer(r + step), group),
        dist.P2POp(dist.irecv, out, peer(r - step), group)])
    for w in works:
        w.wait()
    return out


@functools.lru_cache(maxsize=None)
def _pick_tile(nb: int, cap: int = 512) -> int:
    """Key-tile width: the block is padded up to a tile multiple inside
    :func:`ring_attention`, so simply cap at the block size."""
    return min(cap, nb)


def _tile_step(m, l, acc, q, k_t, v_t, gid, g_t, scale):
    """One key tile of the online softmax: (m, l, acc) updated.  ``g_t``
    is the keys' graph ids with -1 at padding keys (never equal to a
    query's)."""
    s = torch.einsum("qhd,khd->qhk", q, k_t).float() * scale
    bias = torch.where(gid[:, None] == g_t[None, :], 0.0, NEG_INF)
    s = s + bias[:, None, :]
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("qhk,khd->qhd", p,
                                               v_t.float())
    return m_new, l, acc


def ring_attention(g, attn, gid, ok, group, tile: int):
    """Online-softmax ring attention over the ranks of ``group``.

    g [Nb, H] pre-normed features, gid [Nb] graph ids, ok [Nb] node mask;
    ``attn`` holds ``q``/``k``/``v``/``o`` (:class:`Dense`).  Returns
    [Nb, H] in g's dtype, zero on padding rows."""
    nb = g.shape[0]
    nh, hd = attn.heads, attn.head_dim

    def proj(lin):
        return lin(g).reshape(nb, nh, hd)

    q, k, v = proj(attn.q), proj(attn.k), proj(attn.v)
    pad = (-nb) % tile
    kv = F.pad(torch.stack([k, v], 1), (0, 0, 0, 0, 0, 0, 0, pad))
    gk = F.pad(torch.where(ok, gid, -1), (0, pad), value=-1)
    scale = 1.0 / float(hd) ** 0.5
    m = torch.full((nb, nh), -torch.inf, device=g.device)
    l = torch.zeros(nb, nh, device=g.device)
    acc = torch.zeros(nb, nh, hd, device=g.device)
    D = dist.get_world_size(group)
    for step in range(D):
        for t0 in range(0, nb + pad, tile):
            kv_t, g_t = kv[t0:t0 + tile], gk[t0:t0 + tile]
            m, l, acc = checkpoint(_tile_step, m, l, acc, q, kv_t[:, 0],
                                   kv_t[:, 1], gid, g_t, scale,
                                   use_reentrant=False)
        if step < D - 1:
            kv = _RingShift.apply(kv, group)
            gk = ring_shift(gk, group, +1)
    out = acc / l.clamp_min(1e-30)[..., None]
    out = attn.o(out.to(g.dtype).reshape(nb, nh * hd))
    return torch.where(ok[:, None], out, 0.0)


class _Attention(nn.Module):
    """JAX's ``attn``: ``wq``/``wk``/``wv`` [H, heads, hd] with biases
    [heads, hd], ``wo`` [heads, hd, H] and ``bo``, as ``Dense`` layers
    ``q``/``k``/``v`` [heads*hd, H] and ``o`` [H, heads*hd]."""

    def __init__(self, hidden: int, heads: int, dtype=None, generator=None):
        super().__init__()
        self.heads, self.head_dim = heads, hidden // heads
        for name in "qkvo":
            setattr(self, name, Dense(hidden, hidden, dtype, generator))


class _GPSLayer(nn.Module):
    """JAX's layer: ``ln1``, ``local``, ``ln2``, ``attn``, ``ln3``,
    ``ffn1``, ``ffn2``.  The GCN ``local``, ``ffn2`` (its bias added in
    float32) and the input projection keep a bare weight and bias."""

    def __init__(self, hidden: int, heads: int, local_conv: str, dtype=None,
                 generator=None):
        super().__init__()
        self.ln1 = LayerNorm(hidden)
        self.local = (GatedLinears(hidden, dtype, generator)
                      if local_conv == "gatedgcn"
                      else Affine(hidden, hidden, generator))
        self.ln2 = LayerNorm(hidden)
        self.attn = _Attention(hidden, heads, dtype, generator)
        self.ln3 = LayerNorm(hidden)
        self.ffn1 = Dense(hidden, 2 * hidden, dtype, generator)
        self.ffn2 = Affine(2 * hidden, hidden, generator)


class ShardedGPS(nn.Module):
    """``make_sharded_gps``'s per-rank forward (sharded_gps.py:201-373):
    the input projection, ``num_layers`` GPS layers at constant width, a
    final LayerNorm and the head; logits [Nb, C] float32, zero on padding
    rows.  With ``local_conv="gatedgcn"`` an edge encoder reads the
    batch's edge features, or a constant 1-column input where it has
    none."""

    def __init__(self, num_features: int, hidden: int, num_classes: int,
                 num_layers: int, heads: int, local_conv: str = "gcn",
                 edge_features: int | None = None, dtype=None,
                 dropout: float = 0.0, tile: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of {heads} "
                             "heads")
        if local_conv not in ("gcn", "gatedgcn"):
            raise ValueError(f"gps local conv {local_conv!r}: 'gcn' or "
                             "'gatedgcn'")
        self.dtype, self.dropout, self.tile = dtype, dropout, tile
        self.local_conv = local_conv
        self.inp = Affine(num_features, hidden, generator)
        self.enc_e = (Dense(edge_features or 1, hidden, dtype, generator)
                      if local_conv == "gatedgcn" else None)
        self.layers = nn.ModuleList(
            _GPSLayer(hidden, heads, local_conv, dtype, generator)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(hidden)
        self.head = Dense(hidden, num_classes, None, generator)

    def _c(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dtype is None else t.to(self.dtype)

    def forward(self, blk, generator=None) -> torch.Tensor:
        nb, c = blk.nb, self._c
        tile = self.tile or _pick_tile(nb)
        gated = self.local_conv == "gatedgcn"
        if gated:
            e0_loc, e0_hal = blk.e_loc, blk.e_hal
            if e0_loc is None:
                e0_loc = blk.x.new_ones(blk.snd_loc.shape[0], 1)
                e0_hal = blk.x.new_ones(blk.snd_hal.shape[0], 1)
            e_loc, e_hal = self.enc_e(c(e0_loc)), self.enc_e(c(e0_hal))
        else:
            w_loc, w_hal, diag = (c(t) for t in blk.gcn_norm())
        x = (F.linear(c(blk.x), c(self.inp.weight))
             + self.inp.bias).float()

        def drop(h):
            return dropout(h, self.dropout, self.training, generator)

        for layer in self.layers:
            h = c(layer.ln1(x))
            lp = layer.local
            if gated:
                e_loc, e_hal, local = _gated_local(lp, h, e_loc, e_hal, blk)
                h_local = x + drop(local)
            else:
                hh = F.linear(h, c(lp.weight))
                pending = blk.halo(hh)
                agg = segment_sum(hh.index_select(0, blk.snd_loc)
                                  * w_loc[:, None], blk.rcv_loc, nb)
                halo = pending.wait()
                agg = agg + segment_sum(halo.index_select(0, blk.snd_hal)
                                        * w_hal[:, None], blk.rcv_hal, nb)
                local = (agg + diag[:, None] * hh).float() + lp.bias
                h_local = x + drop(F.relu(local))
            g = c(layer.ln2(x))
            h_global = x + drop(ring_attention(
                g, layer.attn, blk.gid, blk.ok, blk.group, tile).float())
            h2 = h_local + h_global
            f = c(layer.ln3(h2))
            f = F.gelu(layer.ffn1(f), approximate="tanh")
            f = F.linear(f, c(layer.ffn2.weight)).float() + layer.ffn2.bias
            x = h2 + drop(f)
        out = self.head(self.ln_f(x))
        return torch.where(blk.ok[:, None], out, 0.0)


def _gated_local(lp, h, e_loc, e_hal, blk):
    """GPS's GatedGCN local module (residual=False, norm="none") on plain
    ops.  Returns (e_loc, e_hal, local [Nb, H] float32): the edge state
    is the relu'd pre-activation, zero on padding edges."""
    e_new_loc, e_new_hal, ratio = gated_messages(lp, h, e_loc, e_hal, blk)
    local = F.relu(lp.A(h).float() + ratio)
    return (torch.where(blk.m_loc[:, None], F.relu(e_new_loc), 0.0),
            torch.where(blk.m_hal[:, None], F.relu(e_new_hal), 0.0), local)
