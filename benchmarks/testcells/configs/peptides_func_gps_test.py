"""Plain reference of the test cell ``peptides_func_gps_test``: the port's
GPS (``models/gps.py``) with the GatedGCN local module on graph-level
Peptides-func, written out over the batch's real nodes and edges.

  x = encoder(features);  e = edge_encoder(bond features)
  layer (pre-norm):
    (l, e) = GatedGCN(LN_local(x), e)
    h = (x + drop(l)) + (x + drop(MHA(LN_global(x))))
    x = h + drop(ffn1(gelu(ffn0(LN_ffn(h)))))
  logits = the mean over each graph's nodes of head(LN(x))

GatedGCN (no residual, no norm): e' = C e + D h[dst] + E h[src],
s = sigmoid(e'), l = relu(A h + sum_dst s * B h[src] / (sum_dst s +
1e-6)), the next edge state relu(e').  MHA: each graph's nodes attend to
that graph's nodes alone, heads of hidden / heads, softmax over the real
keys.  LayerNorm with epsilon 1e-6, gelu in its tanh form.  ``drop`` is
the node-row dropout at ``mp.dropout``, three draws a layer in that
order.  Loss: sigmoid cross-entropy, the mean over graphs and labels.
Every LayerNorm scale starts at one (``initial``).  No ``train_flops``:
the test cell is never traced.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import torch

from hscnbench.reference import segment_mean

observed = "model"
LN_EPS = 1e-6
GATE_EPS = 1e-6


@functools.cache
def _mp() -> dict:
    with open(Path(__file__).with_suffix(".json")) as f:
        return json.load(f)["run"]["mp"]


def targets(config: dict, dims: dict) -> dict:
    mp = config["run"]["mp"]
    H, L = mp["hidden_channels"], mp["num_layers"]
    spec = {}

    def dense(name, fin, fout):
        spec[f"{name}.weight"] = [fout, fin]
        spec[f"{name}.bias"] = [fout]

    def norm(name):
        spec[f"{name}.scale"] = [H]
        spec[f"{name}.bias"] = [H]

    dense("encoder", dims["features"], H)
    dense("edge_encoder", dims["edge_features"], H)
    for i in range(L):
        p = f"layers.{i}"
        for n in ("norm_local", "norm_global", "norm_ffn"):
            norm(f"{p}.{n}")
        for k in "ABCDE":
            dense(f"{p}.local.{k}", H, H)
        for k in ("query", "key", "value", "out"):
            dense(f"{p}.attn.{k}", H, H)
        dense(f"{p}.ffn0", H, 2 * H)
        dense(f"{p}.ffn1", 2 * H, H)
    norm("norm")
    dense("head", H, dims["classes"])
    return {"model": spec}


def initial(target: str, name: str, shape) -> str | None:
    return "ones" if name.endswith(".scale") else None


def _dense(p, name, x):
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def _norm(p, name, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * p[f"{name}.scale"]
            + p[f"{name}.bias"])


def _gelu(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (x + 0.044715 * x ** 3)))


def _gated_gcn(p, name, h, e, batch):
    n, H = h.shape
    e_new = (_dense(p, f"{name}.C", e) + _dense(p, f"{name}.D", h)[batch.dst]
             + _dense(p, f"{name}.E", h)[batch.src])
    s = torch.sigmoid(e_new)
    den = h.new_zeros(n, H).index_add(0, batch.dst, s)
    msg = h.new_zeros(n, H).index_add(
        0, batch.dst, s * _dense(p, f"{name}.B", h)[batch.src])
    return (torch.relu(_dense(p, f"{name}.A", h) + msg / (den + GATE_EPS)),
            torch.relu(e_new))


def _attention(p, name, x, batch, heads: int):
    """Each graph's real nodes attending to each other: the nodes laid out
    as [G, S, H] by their position in their graph, the keys past a
    graph's node count masked out."""
    n, H = x.shape
    G, hd = batch.num_graphs, H // heads
    count = torch.bincount(batch.graph, minlength=G)
    S = int(count.max())
    pos = (torch.arange(n, device=x.device)
           - (torch.cumsum(count, 0) - count)[batch.graph])

    def grid(k):
        z = x.new_zeros(G, S, H).index_put(
            (batch.graph, pos), _dense(p, f"{name}.{k}", x))
        return z.reshape(G, S, heads, hd)

    q, k, v = grid("query"), grid("key"), grid("value")
    scores = torch.einsum("gqhd,gkhd->ghqk", q, k) / math.sqrt(hd)
    real = torch.arange(S, device=x.device)[None, :] < count[:, None]
    scores = scores.masked_fill(~real[:, None, None, :], -math.inf)
    out = torch.einsum("ghqk,gkhd->gqhd", torch.softmax(scores, -1), v)
    return _dense(p, f"{name}.out", out.reshape(G, S, H)[batch.graph, pos])


def forward(params: dict, batch, drop) -> torch.Tensor:
    heads = _mp()["num_heads"]
    x = _dense(params, "encoder", batch.x)
    e = _dense(params, "edge_encoder", batch.edge_attr)
    i = 0
    while f"layers.{i}.ffn0.weight" in params:
        p = f"layers.{i}"
        local, e = _gated_gcn(params, f"{p}.local",
                              _norm(params, f"{p}.norm_local", x), e, batch)
        h_local = x + drop(local, batch)
        att = _attention(params, f"{p}.attn",
                         _norm(params, f"{p}.norm_global", x), batch, heads)
        h = h_local + (x + drop(att, batch))
        f = _dense(params, f"{p}.ffn1", _gelu(_dense(
            params, f"{p}.ffn0", _norm(params, f"{p}.norm_ffn", h))))
        x = h + drop(f, batch)
        i += 1
    z = _dense(params, "head", _norm(params, "norm", x))
    return segment_mean(z, batch.graph, batch.num_graphs)


def loss(logits: torch.Tensor, batch) -> torch.Tensor:
    z, y = logits, batch.y
    return (z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()
