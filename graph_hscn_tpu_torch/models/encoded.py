"""A positional-encoding module trained end to end with the core model:
the counterpart of ``graph_hscn_tpu/models/encoded.py``.

The reference applies SignNet once as a frozen random transform (quirk #6,
train.py:29-51); ``compat.frozen_random_signnet: false`` selects this
wrapper instead, whose encoder's parameters get gradients from the task
loss.
"""

from __future__ import annotations

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.signnet import SignNetNodeEncoder


class EncodedModel(nn.Module):
    """core(encoder(batch)), the encoder's output replacing the node
    features.  Parameters ``encoder.*`` and ``core.*``."""

    def __init__(self, encoder: SignNetNodeEncoder, core: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.core = core

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x_new = self.encoder(batch)
        return self.core(batch.replace(node_feat=x_new), generator=generator)


def wrap_with_signnet(core: nn.Module, pe_cfg, num_features: int,
                      generator: torch.Generator | None = None
                      ) -> EncodedModel:
    """``core`` (built ``pe_cfg.dim_emb`` wide at its input) behind a
    trainable SignNet on ``num_features`` raw features, its weights drawn
    from ``generator`` with flax's init."""
    enc = SignNetNodeEncoder(
        dim_in=num_features, dim_emb=pe_cfg.dim_emb, dim_pe=pe_cfg.dim_pe,
        phi_hidden_dim=pe_cfg.phi_hidden_dim,
        phi_out_dim=pe_cfg.phi_out_dim, sign_inv_layers=pe_cfg.layers,
        rho_layers=pe_cfg.post_layers, max_freqs=pe_cfg.eigen_max_freqs,
        model_type=pe_cfg.model, generator=generator)
    return EncodedModel(enc, core)
