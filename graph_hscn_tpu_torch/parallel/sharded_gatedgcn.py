"""Edge-partitioned GatedGCN: the counterpart of
``graph_hscn_tpu/parallel/sharded_gatedgcn.py``.

The layout is the sharded GCN's (parallel/sharded_gcn.py): contiguous node
blocks, receiver-owned edges, the halo ``all_to_all`` of the node features
once a layer.  The edge STATE never moves: every edge lives on its
receiver's rank for the whole run (gates, edge LayerNorm and the edge
residual are all edge-local), so the gates of a halo edge, E(x_snd) and
B(x_snd), are computed on the receiving rank from the exchanged features.
A layer (models/layers.py:GatedGCNConv, ``norm="layer"``, residual)::

    e'  = C e + D x_rcv + E x_snd
    eta = sigmoid(e') / (sum_rcv sigmoid(e') + 1e-6)
    x'  = A x + sum eta * (B x_snd)
    x  += relu(LN(x')),  e += relu(LN(e'))

then node-stream dropout after the residual add.  The halo is issued first
and waited for after the local edges' work, so on NCCL it runs meanwhile;
the gate normalisation is summed in float32 (upcast before the sum).

At ``hidden >= WIDTH_GATE`` with the rank's local-edge ``CsrPlan``, the
local group's two segment sums (``segment_sum_planned``) and the backwards
of its three edge gathers (``gather_planned``, receiver and sender side)
run the ``segment_reduce`` kernel (B5): 2 launches a layer forward, 3
backward.  JAX also gates this route on the block's TPU-resident buffer
fitting its VMEM budget and takes XLA's scatter above it; the kernel here
keeps no such buffer, so no budget applies: the function is the same.  The
halo edges stay plain ``index_select`` / ``index_add_``, as in JAX.  Every
padding edge's sigmoid is masked to 0, so its rows carry zero cotangents
into the gathers' backwards (``gather_planned``'s contract).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graph_hscn_tpu_torch.models.layers import Dense, LayerNorm, dropout
from graph_hscn_tpu_torch.ops.segment import (gather_planned, segment_sum,
                                              segment_sum_planned)
from graph_hscn_tpu_torch.parallel.sharded_gcn import WIDTH_GATE

_EPS = 1e-6


class GatedLinears(nn.Module):
    """JAX's ``{"A".."E": {"kernel", "bias"}}``: ``Dense`` layers A..E."""

    def __init__(self, hidden: int, dtype=None, generator=None):
        super().__init__()
        for name in "ABCDE":
            setattr(self, name, Dense(hidden, hidden, dtype, generator))


class _GatedLayer(GatedLinears):
    """JAX's layer: A..E and the LayerNorms ``ln_x``, ``ln_e``."""

    def __init__(self, hidden: int, dtype=None, generator=None):
        super().__init__(hidden, dtype, generator)
        self.ln_x = LayerNorm(hidden, dtype)
        self.ln_e = LayerNorm(hidden, dtype)


class ShardedGatedGCN(nn.Module):
    """``make_sharded_gatedgcn``'s per-rank forward (sharded_gatedgcn.py:
    82-260): node encoder, the edge encoder when the batch has edge
    features (else a zero edge state), ``num_layers`` gated layers and a
    node-level head; logits [Nb, C] float32.  ``dtype`` (bfloat16): the
    node and edge streams and the halo payloads in it, LayerNorm
    statistics and the gate normalisation in float32, params float32."""

    def __init__(self, num_features: int, edge_features: int | None,
                 hidden: int, num_classes: int, num_layers: int, dtype=None,
                 dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.enc_x = Dense(num_features, hidden, dtype, generator)
        self.enc_e = (Dense(edge_features, hidden, dtype, generator)
                      if edge_features else None)
        self.layers = nn.ModuleList(_GatedLayer(hidden, dtype, generator)
                                    for _ in range(num_layers))
        self.head = Dense(hidden, num_classes, dtype, generator)

    def forward(self, blk, generator=None) -> torch.Tensor:
        x0 = blk.x if self.dtype is None else blk.x.to(self.dtype)
        x = self.enc_x(x0)
        hidden = x.shape[-1]
        if self.enc_e is not None:
            e_loc, e_hal = self.enc_e(blk.e_loc), self.enc_e(blk.e_hal)
        else:
            e_loc = x.new_zeros(blk.snd_loc.shape[0], hidden)
            e_hal = x.new_zeros(blk.snd_hal.shape[0], hidden)
        plan = blk.csr if hidden >= WIDTH_GATE else None
        for layer in self.layers:
            e_new_loc, e_new_hal, ratio = gated_messages(layer, x, e_loc,
                                                         e_hal, blk, plan)
            x_new = layer.A(x) + ratio.to(x.dtype)
            x = x + F.relu(layer.ln_x(x_new))
            e_loc = e_loc + F.relu(layer.ln_e(e_new_loc))
            e_hal = e_hal + F.relu(layer.ln_e(e_new_hal))
            # Node-stream dropout after the residual add.
            x = dropout(x, self.dropout, self.training, generator)
        x = torch.where(blk.ok[:, None], x, 0.0)
        return self.head(x).float()


def gated_messages(layer, x, e_loc, e_hal, blk, plan=None):
    """One gated layer's messages on a rank's block: the halo of ``x``
    issued first, the local edges' work while it flies, then the halo
    edges'.  ``layer`` holds the ``Dense`` layers B..E.  Returns (e' of
    the local edges, e' of the halo edges, the gated sum over each
    receiver's edges [Nb, H] float32); with ``plan`` the local group's
    sums and gather-backwards run ``segment_reduce``."""
    nb = blk.nb
    m_loc, m_hal = blk.m_loc[:, None], blk.m_hal[:, None]
    pending = blk.halo(x)
    dx, ex, bx = layer.D(x), layer.E(x), layer.B(x)
    e_new_loc = (layer.C(e_loc) + gather_planned(dx, blk.rcv_loc, plan)
                 + gather_planned(ex, blk.snd_loc, plan, "sender"))
    sig_loc = torch.where(m_loc, torch.sigmoid(e_new_loc), 0.0)
    # The gate normalisation in float32: upcast BEFORE the sum.
    denom = segment_sum_planned(sig_loc.float(), blk.rcv_loc, nb, plan)
    agg = segment_sum_planned(
        sig_loc * gather_planned(bx, blk.snd_loc, plan, "sender"),
        blk.rcv_loc, nb, plan)
    halo = pending.wait()
    e_hal_src, b_hal_src = layer.E(halo), layer.B(halo)
    e_new_hal = (layer.C(e_hal) + dx.index_select(0, blk.rcv_hal)
                 + e_hal_src.index_select(0, blk.snd_hal))
    sig_hal = torch.where(m_hal, torch.sigmoid(e_new_hal), 0.0)
    denom = denom + segment_sum(sig_hal.float(), blk.rcv_hal, nb)
    agg = agg + segment_sum(sig_hal * b_hal_src.index_select(0, blk.snd_hal),
                            blk.rcv_hal, nb)
    return e_new_loc, e_new_hal, agg.float() / (denom + _EPS)


def gather_edge_groups(edge_feat, plan_np):
    """Host-side: per-device edge-feature groups aligned with the plan's
    local/halo edge layout ([D, El, Fe], [D, Eh, Fe]); None passthrough."""
    if edge_feat is None:
        return None, None
    ef = np.asarray(edge_feat)
    e_loc = ef[plan_np["eidx_loc"]] * plan_np["mask_loc"][..., None]
    e_hal = ef[plan_np["eidx_hal"]] * plan_np["mask_hal"][..., None]
    return e_loc.astype(np.float32), e_hal.astype(np.float32)
