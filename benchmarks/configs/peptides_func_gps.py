"""Plain reference of ``peptides_func_gps``: LRGB's GraphGPS on graph-level
Peptides-func (GraphGPS's ``gps_layer.py`` with ``CustomGatedGCN`` and
``Transformer``, ``laplace_pos_encoder.py``, ``san_graph.py``), written
out over the batch's real nodes and edges, and its FLOP count.

  x = [Atom(x_cat) | LapPE];  e = Bond(e_cat)      sums of per-column rows
  LapPE: the 10 smallest eigenpairs (v_k, l_k) of L = D - A of each graph,
    numpy's float64 eigh, l_k clamped at 0, v_k L2-normalised in float32,
    pairs past a graph's node count missing; in training v_k times a sign
    a frequency (the next draw of K bits: -1 below 0.5); missing pairs 0;
    relu(W2 relu(W1 p_k)), missing rows 0, summed over k
  layer:
    e^ = C e + D x[dst] + E x[src];  s = sigmoid(e^)
    x_g = A x + sum_dst s * B x[src] / (sum_dst s + 1e-6)
    x_l = BN_l(x + relu(BN_x(x_g)));  e = e + relu(BN_e(e^))
    x_a = BN_a(x + MHA(x))
    h = x_l + x_a;  x = BN_2(h + W_f1 relu(W_f0 h))
  logits = W_2 relu(W_1 relu(W_0 mean_graph(x)))

BN: over the batch's real rows (nodes, or edges), the biased variance,
epsilon 1e-5.  MHA: each graph's nodes attend to that graph's nodes alone,
4 heads of hidden / 4, the scores over sqrt(head width), softmax over the
real keys, then in training dropout at ``mp.attn_dropout`` with the next
draw in the program's shape [batch_size, heads, slot, slot] (graph i of
the batch in slot i, its node j at row and column j), then the value and
output projections.  ``mp.dropout`` is 0 (node and edge dropout draw
nothing, as the port's ``dropout`` at rate 0).  Loss: sigmoid
cross-entropy, the mean over graphs and labels.  Every BN scale starts at
one (``initial``).

The settings ``forward`` reads are those of the configuration that
:func:`targets` was last given (the harness calls it first).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hscnbench.reference import segment_mean

observed = "model"
ATOM_FEATURE_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)
BN_EPS = 1e-5
GATE_EPS = 1e-6
_SETTINGS: dict = {}
# Each graph's eigen stats, by its node count and edges.
_EIGEN: dict = {}


def _settings(config: dict) -> dict:
    run = config["run"]
    mp, pe = run["mp"], run["pe"]
    if float(mp.get("dropout", 0.0)) != 0.0:
        raise ValueError("the reference follows mp.dropout 0 alone")
    return {"hidden": mp["hidden_channels"], "layers": mp["num_layers"],
            "heads": mp["num_heads"],
            "attn_rate": float(mp.get("attn_dropout", 0.0)),
            "dim_pe": pe["dim_pe"], "pe_layers": pe["layers"],
            "freqs": pe["eig_max_freqs"],
            "batch_size": run["data"]["batch_size"]}


def _pe_dims(s: dict) -> list:
    d = s["dim_pe"]
    return [2] + [2 * d] * (s["pe_layers"] - 1) + [d]


def _head_dims(s: dict, classes: int) -> list:
    h = s["hidden"]
    return [h, h // 2, h // 4, classes]


def targets(config: dict, dims: dict) -> dict:
    s = _settings(config)
    _SETTINGS.clear()
    _SETTINGS.update(s)
    H = s["hidden"]
    spec = {}

    def dense(name, fin, fout):
        spec[f"{name}.weight"] = [fout, fin]
        spec[f"{name}.bias"] = [fout]

    def norm(name):
        spec[f"{name}.scale"] = [H]
        spec[f"{name}.bias"] = [H]

    pe = _pe_dims(s)
    for i, (a, b) in enumerate(zip(pe, pe[1:])):
        dense(f"lap_pe.layers.{i}", a, b)
    for i, d in enumerate(ATOM_FEATURE_DIMS):
        spec[f"atom.tables.{i}.weight"] = [d, H - s["dim_pe"]]
    for i, d in enumerate(BOND_FEATURE_DIMS):
        spec[f"bond.tables.{i}.weight"] = [d, H]
    for i in range(s["layers"]):
        p = f"layers.{i}"
        for k in "ABCDE":
            dense(f"{p}.local.{k}", H, H)
        for n in ("local.norm_x", "local.norm_e", "norm_local", "norm_attn",
                  "norm_ffn"):
            norm(f"{p}.{n}")
        for k in ("query", "key", "value", "out"):
            dense(f"{p}.attn.{k}", H, H)
        dense(f"{p}.ffn0", H, 2 * H)
        dense(f"{p}.ffn1", 2 * H, H)
    hd = _head_dims(s, dims["classes"])
    for i, (a, b) in enumerate(zip(hd, hd[1:])):
        dense(f"head.layers.{i}", a, b)
    return {"model": spec}


def initial(target: str, name: str, shape) -> str | None:
    return "ones" if name.endswith(".scale") else None


def _dense(p, name, x):
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def _embed(p, name, cats, dims):
    ids = cats.long()
    return sum(p[f"{name}.tables.{i}.weight"][ids[:, i]]
               for i in range(len(dims)))


def _bn(p, name, x, stats, train):
    """BatchNorm over the rows of ``x``; ``stats`` (a dict, or None) keeps
    the running estimates, momentum 0.1, updated in training with the
    unbiased variance and read in eval."""
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        if stats is not None:
            n = x.shape[0]
            rm, rv = stats.get(name, (torch.zeros_like(mean),
                                      torch.ones_like(var)))
            stats[name] = (0.9 * rm + 0.1 * mean.detach(),
                           0.9 * rv + 0.1 * var.detach() * n / max(n - 1, 1))
    else:
        mean, var = stats[name]
    return ((x - mean) / torch.sqrt(var + BN_EPS) * p[f"{name}.scale"]
            + p[f"{name}.bias"])


def _laplacian_stats(n: int, src: np.ndarray, dst: np.ndarray, K: int,
                     dtype=np.float64):
    """(eigvecs [n, K], eigvals [K]) of one graph, NaN past its n pairs;
    ``eigh`` in ``dtype``."""
    key = (n, src.tobytes(), dst.tobytes(), np.dtype(dtype).str)
    if key not in _EIGEN:
        a = np.zeros((n, n), dtype=dtype)
        np.add.at(a, (dst, src), 1.0)
        evals, evects = np.linalg.eigh(np.diag(a.sum(axis=1)) - a)
        idx = np.argsort(evals)[:K]
        vecs = torch.from_numpy(np.real(evects[:, idx]).astype(np.float32))
        vecs = vecs / vecs.norm(dim=0, keepdim=True).clamp_min(1e-12)
        vals = torch.from_numpy(np.clip(np.real(evals[idx]), 0.0, None)
                                .astype(np.float32))
        out_v = torch.full((n, K), math.nan)
        out_l = torch.full((K,), math.nan)
        out_v[:, :len(idx)] = vecs
        out_l[:len(idx)] = vals
        _EIGEN[key] = (out_v, out_l)
    return _EIGEN[key]


def eigen(batch, K: int, dtype=np.float64):
    """Each real node's eigenvector entries [n, K] and its graph's
    eigenvalues [n, K], NaN for the missing pairs, on the batch's
    device; ``eigh`` in ``dtype``."""
    graph = batch.graph.cpu().numpy()
    src, dst = batch.src.cpu().numpy(), batch.dst.cpu().numpy()
    starts = np.searchsorted(graph, np.arange(batch.num_graphs))
    counts = np.bincount(graph, minlength=batch.num_graphs)
    vecs, vals = [], []
    for g in range(batch.num_graphs):
        on = graph[dst] == g
        v, lam = _laplacian_stats(int(counts[g]), src[on] - starts[g],
                                  dst[on] - starts[g], K, dtype)
        vecs.append(v)
        vals.append(lam.expand(int(counts[g]), K))
    dev = batch.x.device
    return torch.cat(vecs).to(dev), torch.cat(vals).to(dev)


def _lap_pe(p, batch, drop, s, train):
    vecs, vals = eigen(batch, s["freqs"])
    if train:
        bits = drop.bits((s["freqs"],))
        vecs = vecs * torch.where(bits >= 0.5, 1.0, -1.0).to(vecs.device)
    pe = torch.stack([vecs, vals], -1).to(batch.x.dtype)
    empty = torch.isnan(pe)
    h = torch.where(empty, 0.0, pe)
    for i in range(s["pe_layers"]):
        h = torch.relu(_dense(p, f"lap_pe.layers.{i}", h))
    return torch.where(empty[..., :1], 0.0, h).sum(1)


def _attention(p, name, x, batch, drop, s, train):
    """Each graph's real nodes attending to each other, laid out as [G, S,
    H] by their position in their graph; the dropout bits the program's
    [batch_size, heads, slot, slot] draw holds at (graph, head, query,
    key)."""
    n, H = x.shape
    G, heads = batch.num_graphs, s["heads"]
    hd = H // heads
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
    att = torch.softmax(scores, -1)
    rate = s["attn_rate"]
    if train and rate > 0.0:
        B = s["batch_size"]
        slot = batch.n_pad // B
        bits = drop.bits((B, heads, slot, slot))[:G, :, :S, :S]
        att = torch.where(bits >= rate, att / (1.0 - rate), 0.0)
    out = torch.einsum("ghqk,gkhd->gqhd", att, v)
    return _dense(p, f"{name}.out", out.reshape(G, S, H)[batch.graph, pos])


def forward(params: dict, batch, drop, stats: dict | None = None,
            train: bool = True) -> torch.Tensor:
    """Logits [G, C] of the batch's graphs; in training (``train``) with
    the sign and dropout draws of ``drop`` and batch statistics (kept as
    running estimates in ``stats`` where it is given), in eval with the
    running estimates of ``stats``."""
    s = _SETTINGS
    x = torch.cat([_embed(params, "atom", batch.x, ATOM_FEATURE_DIMS),
                   _lap_pe(params, batch, drop, s, train)], -1)
    e = _embed(params, "bond", batch.edge_attr, BOND_FEATURE_DIMS)
    n = x.shape[0]

    def bn(name, h):
        return _bn(params, name, h, stats, train)

    for i in range(s["layers"]):
        p = f"layers.{i}"
        e_hat = (_dense(params, f"{p}.local.C", e)
                 + _dense(params, f"{p}.local.D", x)[batch.dst]
                 + _dense(params, f"{p}.local.E", x)[batch.src])
        sig = torch.sigmoid(e_hat)
        den = x.new_zeros(n, x.shape[1]).index_add(0, batch.dst, sig)
        msg = x.new_zeros(n, x.shape[1]).index_add(
            0, batch.dst, sig * _dense(params, f"{p}.local.B", x)[batch.src])
        x_g = _dense(params, f"{p}.local.A", x) + msg / (den + GATE_EPS)
        x_l = bn(f"{p}.norm_local",
                 x + torch.relu(bn(f"{p}.local.norm_x", x_g)))
        e = e + torch.relu(bn(f"{p}.local.norm_e", e_hat))
        att = _attention(params, f"{p}.attn", x, batch, drop, s, train)
        h = x_l + bn(f"{p}.norm_attn", x + att)
        f = _dense(params, f"{p}.ffn1",
                   torch.relu(_dense(params, f"{p}.ffn0", h)))
        x = bn(f"{p}.norm_ffn", h + f)
    z = segment_mean(x, batch.graph, batch.num_graphs)
    last = len(_head_dims(s, 0)) - 2
    for i in range(last + 1):
        z = _dense(params, f"head.layers.{i}", z)
        if i < last:
            z = torch.relu(z)
    return z


def loss(logits: torch.Tensor, batch) -> torch.Tensor:
    z, y = logits, batch.y
    return (z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def extra_checks(probe, batch, weights, dtype=np.float64) -> dict:
    """``pe_gap``: the largest difference between the eigenvector entries
    the program's first train batch holds for the batch's real nodes and
    the reference's own (inf where they miss different pairs)."""
    K = _SETTINGS["freqs"]
    mine, _ = eigen(batch, K, dtype)
    theirs = probe.batches[0].eigvecs[batch.rows][:, :K].to(mine.device)
    if not torch.equal(torch.isnan(mine), torch.isnan(theirs)):
        return {"pe_gap": math.inf}
    ok = ~torch.isnan(mine)
    return {"pe_gap": float((mine[ok] - theirs[ok].float()).abs().max())}


def extra_checks_control(probe, batch, weights) -> dict:
    """The control's ``pe_gap``: the reference's eigenpairs from an
    ``eigh`` in float32, the precision below its float64 (the TF32 of the
    control's matmuls does not reach numpy's eigh)."""
    return extra_checks(probe, batch, weights, np.float32)


def train_flops(config: dict, dims: dict, n_nodes, n_edges) -> float:
    """Model FLOPs (the matmuls, 2 a multiply-add) of one train pass over
    graphs of ``n_nodes`` and ``n_edges`` (arrays): on each real node the
    LapPE's dense layers a frequency, and a layer's eight H x H
    projections (A, B, D, E; query, key, value, out) and its FFN; on each
    real edge C; on each graph's real query-key pairs the scores and the
    weighted values (2·n²·H each); the head a graph; the backward twice
    the forward."""
    s = _settings(config)
    H, L = s["hidden"], s["layers"]
    n = np.asarray(n_nodes, dtype=np.float64)
    e = np.asarray(n_edges, dtype=np.float64)
    pe = _pe_dims(s)
    per_node = (s["freqs"] * sum(2 * a * b for a, b in zip(pe, pe[1:]))
                + L * (8 * 2 * H * H + 2 * 2 * H * 2 * H))
    hd = _head_dims(s, dims["classes"])
    fwd = (per_node * n.sum() + L * 2 * H * H * e.sum()
           + L * 4 * H * (n ** 2).sum()
           + len(n) * sum(2 * a * b for a, b in zip(hd, hd[1:])))
    return 3 * float(fwd)
