"""Plain reference of ``voc_gcn``: the PyG-semantics GCN of the port's
``MPNN`` (conv_type gcn) on node-level PascalVOC-SP, and its FLOP count.

  layer i < 3:  h = relu(relu(Â (h W_i^T) + b_i)); dropout 0.1
  layer 3:      logits = Â (h W_3^T) + b_3
with Â = D^-1/2 (A + I) D^-1/2, D the in-degree + 1 (the self loop), and
the reference's doubled relu (quirk #1, ``compat.double_relu``: relu∘relu
is relu).  Loss: softmax cross-entropy, the mean over real nodes.
"""

from __future__ import annotations

import torch

from hscnbench.reference import gcn_aggregate

observed = "model"


def _dims(config: dict, dims: dict) -> list[tuple[int, int]]:
    mp = config["run"]["mp"]
    out = [mp["hidden_channels"]] * (mp["num_layers"] - 1) + [
        dims["classes"]]
    return list(zip([dims["features"]] + out[:-1], out))


def targets(config: dict, dims: dict) -> dict:
    spec = {}
    for i, (a, b) in enumerate(_dims(config, dims)):
        spec[f"convs.{i}.weight"] = [b, a]
        spec[f"convs.{i}.bias"] = [b]
    return {"model": spec}


def forward(params: dict, batch, drop) -> torch.Tensor:
    h = batch.x
    n = h.shape[0]
    last = sum(1 for k in params if k.endswith(".weight")) - 1
    for i in range(last + 1):
        h = h @ params[f"convs.{i}.weight"].t()
        h = gcn_aggregate(h, batch.src, batch.dst, n, self_loops=True)
        h = h + params[f"convs.{i}.bias"]
        if i < last:
            h = drop(torch.relu(h), batch)
    return h


def loss(logits: torch.Tensor, batch) -> torch.Tensor:
    return -(batch.node_y * torch.log_softmax(logits, -1)).sum(-1).mean()


def train_flops(config: dict, dims: dict, n_nodes, n_edges) -> float:
    """Model FLOPs of one train pass over graphs of ``n_nodes`` and
    ``n_edges`` (arrays): a dense transform 2·n·F_in·F_out, an
    aggregation 2·(e + n)·F_out (the self loops among its edges), the
    backward twice the forward."""
    n, e = float(sum(n_nodes)), float(sum(n_edges))
    fwd = sum(2 * n * a * b + 2 * (e + n) * b for a, b in _dims(config, dims))
    return 3 * fwd


def spmm_launches(config: dict, dims: dict) -> list[int]:
    """Widths of the ``csr_spmm`` launches of one train step with the CSR
    plan: each layer's aggregation of its transformed features, forward
    and its transpose in the backward."""
    widths = [b for _, b in _dims(config, dims)]
    return widths + widths
