"""SignNet positional-encoding encoder: the counterpart of
``graph_hscn_tpu/models/signnet.py`` (the reference's encoder/signnet.py).

  eigvecs [N, K]  ->  [K, N, 1]  (each frequency is a scalar node signal)
  phi     = a GIN stack, applied to +v and -v with SHARED weights:
            h_k = phi(v_k) + phi(-v_k)          (sign invariance)
  DeepSet: zero the frequencies k >= n_nodes(graph), sum over k -> [N, out]
  MLP:     concatenate the K frequencies          -> [N, K * out]
  rho     = an MLP -> [N, dim_pe]
  output  x_new = [Linear(x) | pe], ``dim_emb`` wide

The K frequencies are folded into the feature axis, so each GIN layer
aggregates all of them with one ``gather_scatter`` [N, K * C].  It gets no
CSR plan, as in the JAX package (signnet.py:70-72): the aggregation is
plain index ops and reaches no kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.layers import Dense
from graph_hscn_tpu_torch.ops.spmm import gather_scatter


def _dense(in_features: int, features: int, torch_init: bool,
           generator: torch.Generator | None) -> Dense:
    """A ``Dense`` with flax's init (glorot kernel, zero bias), or with
    torch ``nn.Linear``'s (U(+-1/sqrt(fan_in)) for weight AND bias): the
    family the frozen-random SignNet of quirk #6 draws from."""
    layer = Dense(in_features, features, generator=generator)
    if torch_init:
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class GINLayer(nn.Module):
    """GINConv (eps = 0) with an MLP update over the K channels: the JAX
    ``_GINLayer``.  ``mlp_layers`` 1 is one Dense to ``features``; more
    stack Dense(hidden) + relu before it.  Parameters ``layers.j`` (flax
    ``Dense_j``)."""

    def __init__(self, in_features: int, features: int, mlp_layers: int = 1,
                 hidden: int | None = None, torch_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = ([in_features] + [hidden or features] * (mlp_layers - 1)
                + [features])
        self.layers = nn.ModuleList(
            _dense(a, b, torch_init, generator)
            for a, b in zip(dims, dims[1:]))

    def forward(self, x, senders, receivers, edge_mask, num_nodes):
        # x [K, N, C] -> [N, K * C]: one aggregation for every channel.
        K, N, C = x.shape
        flat = x.transpose(0, 1).reshape(N, K * C)
        w = torch.where(edge_mask, 1.0, 0.0)
        agg = gather_scatter(flat, senders, receivers, num_nodes=num_nodes,
                             edge_weight=w)
        h = x + agg.reshape(N, K, C).transpose(0, 1)
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)


class SignNetNodeEncoder(nn.Module):
    """phi(+/-v) GIN, the K aggregation, rho, and the concatenation with
    the projected features.

    ``model_type`` picks the reference's two sign-invariant nets
    (signnet.py:290-340): "DeepSet" (MaskedGINDeepSigns, the default) or
    "MLP" (GINDeepSigns, rho taking K * phi_out_dim inputs).  phi is an
    input GIN layer at ``phi_hidden_dim``, ``sign_inv_layers`` - 2 hidden
    ones, and an output layer whose 2-layer MLP goes to ``phi_out_dim``
    (the reference's ``n_layers=1`` still builds two GINConvs).

    Parameters: ``phi.i`` (flax ``_GINLayer_i``), ``rho.j`` (flax
    ``Dense_j``, its hidden layers then the PE layer) and ``expand`` (the
    next ``Dense``, with ``expand_x``).  ``torch_init``: torch's init
    family (:func:`_dense`); all drawn in that order from ``generator``.
    """

    def __init__(self, dim_in: int, dim_emb: int, dim_pe: int = 4,
                 phi_hidden_dim: int = 32, phi_out_dim: int = 4,
                 sign_inv_layers: int = 1, rho_layers: int = 1,
                 max_freqs: int = 10, expand_x: bool = True,
                 model_type: str = "DeepSet", torch_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim_emb = dim_emb
        self.max_freqs = max_freqs
        self.model_type = model_type
        hid = phi_hidden_dim

        def gin(i, o, **kw):
            return GINLayer(i, o, torch_init=torch_init,
                            generator=generator, **kw)

        self.phi = nn.ModuleList(
            [gin(1, hid)]
            + [gin(hid, hid) for _ in range(max(sign_inv_layers - 2, 0))]
            + [gin(hid, phi_out_dim, mlp_layers=2, hidden=hid)])
        rho_in = (max_freqs * phi_out_dim if model_type == "MLP"
                  else phi_out_dim)
        dims = [rho_in] + [hid] * (rho_layers - 1) + [dim_pe]
        self.rho = nn.ModuleList(_dense(a, b, torch_init, generator)
                                 for a, b in zip(dims, dims[1:]))
        self.expand = (_dense(dim_in, dim_emb - dim_pe, torch_init,
                              generator) if expand_x else None)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        if batch.eigvecs is None:
            raise ValueError("SignNetNodeEncoder needs the batch's "
                             "precomputed eigenvectors")
        N, K = batch.num_nodes_padded, self.max_freqs
        ev = batch.eigvecs[:, :K]
        ev = torch.where(torch.isnan(ev), 0.0, ev)
        x = ev.T[:, :, None]                               # [K, N, 1]

        def phi(v):
            for layer in self.phi:
                v = layer(v, batch.senders, batch.receivers,
                          batch.edge_mask, N)
            return v

        h = (phi(x) + phi(-x)).transpose(0, 1)             # [N, K, out]
        if self.model_type == "MLP":
            h = h.reshape(N, -1)
        else:
            # Frequencies past each graph's node count are padding
            # (MaskedGINDeepSigns.batched_n_nodes, signnet.py:243-259).
            n_per_node = batch.n_node[batch.node_graph]
            mask = (torch.arange(K, device=h.device)[None, :]
                    < n_per_node[:, None])
            h = torch.where(mask[:, :, None], h, 0.0).sum(1)
        for layer in self.rho[:-1]:
            h = torch.relu(layer(h))
        pe = self.rho[-1](h)
        base = (self.expand(batch.node_feat) if self.expand is not None
                else batch.node_feat)
        out = torch.cat([base, pe], dim=-1)
        return torch.where(batch.node_mask[:, None], out, 0.0)
