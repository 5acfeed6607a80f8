"""The input encoders and the head of LRGB's GraphGPS (port-only: the JAX
package has none of them), as ``models/gps.py:GraphGPSModel`` uses them.

- :class:`CategoryEmbedding`: OGB's ``AtomEncoder`` / ``BondEncoder``, a
  table a categorical feature, their rows summed (``ATOM_FEATURE_DIMS``,
  ``BOND_FEATURE_DIMS``: OGB's ``get_atom_feature_dims()`` /
  ``get_bond_feature_dims()``, the Peptides features' schema).
- :class:`LapPENodeEncoder`: GraphGPS's LapPE with a DeepSet
  (``encoder/laplace_pos_encoder.py``) over each node's K smallest
  Laplacian eigenpairs, a random sign a frequency in training.
- :class:`SANGraphHead`: GraphGPS's ``san_graph`` head.
"""

from __future__ import annotations

import torch
from torch import nn

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.models.layers import Dense, glorot_uniform_
from graph_hscn_tpu_torch.ops.segment import graph_readout_mean

ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)


class CategoryEmbedding(nn.Module):
    """The sum over the columns of ``x`` [R, len(dims)] (category ids, the
    dataset's float columns cast) of each column's row of its table
    ``tables.i.weight`` [dims[i], width], glorot-uniform as OGB's."""

    def __init__(self, dims, width: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.tables = nn.ModuleList(nn.Embedding(d, width) for d in dims)
        for t in self.tables:
            glorot_uniform_(t.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ids = x.long()
        out = self.tables[0](ids[:, 0])
        for i, table in enumerate(self.tables[1:], 1):
            out = out + table(ids[:, i])
        return out


class LapPENodeEncoder(nn.Module):
    """GraphGPS's LapPE DeepSet (``layers`` deep, no post MLP): for each
    node and each of its ``max_freqs`` smallest eigenpairs the pair
    p_k = (v_k, lambda_k), in training each v_k times a random sign drawn
    once a batch a frequency (bits from ``generator``: -1 below 0.5);
    pairs of missing frequencies (NaN: a graph of fewer nodes) set to 0;
    then relu(Dense(...relu(Dense(p_k)))) (2 -> 2·dim_pe -> ... -> dim_pe;
    2 -> dim_pe at one layer), the rows of missing frequencies zeroed,
    summed over k.  Parameters ``layers.i``."""

    def __init__(self, dim_pe: int, layers: int, max_freqs: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_freqs = max_freqs
        dims = [2] + [2 * dim_pe] * (layers - 1) + [dim_pe]
        self.layers = nn.ModuleList(Dense(a, b, generator=generator)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, batch: GraphBatch,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if batch.eigvecs is None or batch.eigvals is None:
            raise ValueError("the LapPE encoder needs the batch's eigen "
                             "stats (pe.use with pe.encoder: lappe)")
        K = self.max_freqs
        vecs = batch.eigvecs[:, :K].float()
        if self.training:
            bits = torch.rand((K,), device=vecs.device, generator=generator)
            vecs = vecs * torch.where(bits >= 0.5, 1.0, -1.0)
        p = torch.stack([vecs, batch.eigvals[:, :K].float()], -1)
        empty = torch.isnan(p)                             # [N, K, 2]
        h = torch.where(empty, 0.0, p)
        for layer in self.layers:
            h = torch.relu(layer(h))
        h = torch.where(empty[..., :1], 0.0, h).sum(1)
        return torch.where(batch.node_mask[:, None], h, 0.0)


class SANGraphHead(nn.Module):
    """GraphGPS's ``san_graph`` head: the mean over each graph's real
    nodes, then ``L`` dense layers halving the width with relu after each,
    then one to the classes.  Parameters ``layers.i``."""

    def __init__(self, hidden: int, num_classes: int, L: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [hidden // 2 ** i for i in range(L + 1)] + [num_classes]
        self.layers = nn.ModuleList(Dense(a, b, generator=generator)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        g = graph_readout_mean(x.float(), batch.node_graph,
                               batch.num_graphs_padded)
        for layer in self.layers[:-1]:
            g = torch.relu(layer(g))
        return self.layers[-1](g)
