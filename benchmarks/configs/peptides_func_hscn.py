"""Plain reference of ``peptides_func_hscn``: Graph-HSCN's HSCN on
graph-level Peptides-func, the SCN that clusters for it, and the FLOP
count.

HSCN (the port's ``models/hscn.py``, the reference's hscn.py:67-140): three
layers, each with three relations; "local" receives the local->local
GCN (no self loops: Â = D^-1/2 A D^-1/2, D the in-degree), "virtual" the
local->virtual GAT plus the virtual->virtual GCN; relu after each; then
the mean over each graph's local nodes, a dense layer, relu and the head.
Without ``virtual_feedback`` (the shipped config) nothing of the virtual
nodes reaches the output (quirk #17): the logits, the loss and every
gradient are those of the local->local stack, the readout and the head
alone, so that is what ``forward`` computes; the lv and vv weights get
zero gradients and move by weight decay alone.  The two virtual relations
are held apart (``virtual_outputs``): at the first train step, each
layer's local->virtual GAT and virtual->virtual GCN outputs against the
reference's, computed from the reference's own clusters.

SCN (``models/scn.py``): two GraphConv layers (W_rel on Â x with self
loops, plus W_root x), relu, a dense layer to the 4 clusters, softmax;
the cluster of a node is its argmax.  Its training (MinCUT plus
orthogonality, ``scn_loss``) is followed over its first steps
(``stages``); the clusters of its tenth epoch are the argmax of the
program's trained SCN as the reference computes it.
"""

from __future__ import annotations

import math

import torch

from hscnbench.reference import gcn_aggregate, matmul_precision, segment_mean

observed = "model"
# The observed model's submodules whose outputs are read at its first
# train step: the local->virtual and virtual->virtual relations.
watched = ("lv.", "vv.")
# A node's cluster is compared where the reference's two most likely
# clusters lie at least this far apart in probability: nearer, float32
# rounding decides the argmax.
CLUSTER_MARGIN = 1e-3


def targets(config: dict, dims: dict) -> dict:
    h = config["run"]["hscn"]
    hid, L, K = h["hidden_channels"], h["num_layers"], h["num_clusters"]
    f = dims["features"]
    model, scn = {}, {}
    for layer in range(L):
        fin = f if layer == 0 else hid
        model[f"ll.{layer}.weight"] = [hid, fin]
        model[f"ll.{layer}.bias"] = [hid]
        model[f"lv.{layer}.weight"] = [hid, fin]
        model[f"lv.{layer}.weight_dst"] = [hid, fin]
        model[f"lv.{layer}.att_src"] = [1, 1, hid]
        model[f"lv.{layer}.att_dst"] = [1, 1, hid]
        model[f"lv.{layer}.bias"] = [hid]
        model[f"vv.{layer}.weight"] = [hid, fin]
        model[f"vv.{layer}.bias"] = [hid]
    model["pool_dense.weight"] = [hid, hid]
    model["pool_dense.bias"] = [hid]
    model["head.weight"] = [dims["classes"], hid]
    model["head.bias"] = [dims["classes"]]
    units = [f] + list(h["mp_units"])
    for i, (a, b) in enumerate(zip(units[:-1], units[1:])):
        scn[f"convs.{i}.weight_rel"] = [b, a]
        scn[f"convs.{i}.weight_root"] = [b, a]
        scn[f"convs.{i}.bias"] = [b]
    scn["cluster.weight"] = [K, units[-1]]
    scn["cluster.bias"] = [K]
    return {"model": model, "scn": scn}


def forward(params: dict, batch, drop) -> torch.Tensor:
    h = batch.x
    n = h.shape[0]
    layer = 0
    while f"ll.{layer}.weight" in params:
        h = gcn_aggregate(h @ params[f"ll.{layer}.weight"].t(), batch.src,
                          batch.dst, n, self_loops=False)
        h = torch.relu(h + params[f"ll.{layer}.bias"])
        layer += 1
    g = segment_mean(h, batch.graph, batch.num_graphs)
    g = torch.relu(g @ params["pool_dense.weight"].t()
                   + params["pool_dense.bias"])
    return g @ params["head.weight"].t() + params["head.bias"]


def loss(logits: torch.Tensor, batch) -> torch.Tensor:
    z, y = logits, batch.y
    return (z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def scn_forward(scn: dict, batch, drop=None) -> torch.Tensor:
    """The SCN's cluster logits [n, K] of the batch's real nodes."""
    h = batch.x
    n = h.shape[0]
    i = 0
    while f"convs.{i}.weight_rel" in scn:
        agg = gcn_aggregate(h, batch.src, batch.dst, n, self_loops=True)
        h = torch.relu(agg @ scn[f"convs.{i}.weight_rel"].t()
                       + h @ scn[f"convs.{i}.weight_root"].t()
                       + scn[f"convs.{i}.bias"])
        i += 1
    return h @ scn["cluster.weight"].t() + scn["cluster.bias"]


def scn_loss(logits: torch.Tensor, batch) -> torch.Tensor:
    """MinCUT plus orthogonality, each the mean over the batch's graphs
    (``ops/dense.py:mincut_pool`` on the raw adjacency, A[dst, src] an
    edge): cut -tr(SᵀAS) / tr(SᵀDS), D the in-degree; orthogonality
    ‖SᵀS / ‖SᵀS‖_F - I / √K‖_F; S the softmax of the logits."""
    s = torch.softmax(logits, -1)
    G, K = batch.num_graphs, s.shape[1]
    g_of = batch.graph
    z = s.new_zeros
    num = z(G).index_add_(0, g_of[batch.dst],
                          (s[batch.dst] * s[batch.src]).sum(-1))
    deg = z(s.shape[0]).index_add_(0, batch.dst,
                                   torch.ones_like(batch.dst, dtype=s.dtype))
    den = z(G).index_add_(0, g_of, deg * (s * s).sum(-1))
    cut = (-(num / den.clamp_min(1e-12))).mean()
    ss = z(G, K, K).index_add_(0, g_of, s[:, :, None] * s[:, None, :])
    norm = ss.flatten(1).norm(dim=1).clamp_min(1e-12)
    ident = torch.eye(K, dtype=s.dtype, device=s.device) / math.sqrt(K)
    ortho = (ss / norm[:, None, None] - ident).flatten(1).norm(dim=1)
    return cut + ortho.mean()


# The SCN's clustering steps, followed besides the observed model's.
stages = {"scn": (scn_forward, scn_loss)}


@torch.no_grad()
def clusters(scn: dict, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """(argmax cluster [n], margin [n] between the two most likely)."""
    s = torch.softmax(scn_forward(scn, batch), -1)
    top = s.topk(2, -1).values
    return s.argmax(-1), top[:, 0] - top[:, 1]


def _leaky(x):
    return torch.where(x > 0, x, 0.2 * x)


@torch.no_grad()
def virtual_outputs(params: dict, batch, cluster, K: int) -> dict:
    """Each layer's local->virtual GAT and virtual->virtual GCN outputs
    [G*K, H] (rows g*K + k) at ``params`` on the batch, its nodes in
    clusters ``cluster`` (``models/hscn.py``): a virtual node starts as the
    mean of its members' features and is active with a member; lv is a
    one-head GAT of each virtual node over its members (leaky relu 0.2,
    softmax over the members, its own projection of the receiver), vv a
    GCN (in-degree normalized, no self loops added) over the pairs of
    compacted active positions p_src + p_dst < the active count (quirk
    #9); the local state takes the ll GCN, the virtual one relu(lv + vv)
    where active, after every layer."""
    G, n = batch.num_graphs, batch.x.shape[0]
    vid = batch.graph * K + cluster
    count = batch.x.new_zeros(G * K).index_add_(
        0, vid, torch.ones(n, dtype=batch.x.dtype, device=vid.device))
    active = count > 0
    x_v = (batch.x.new_zeros(G * K, batch.x.shape[1]).index_add_(
        0, vid, batch.x) / count.clamp_min(1.0)[:, None])
    act = active.reshape(G, K).to(batch.x.dtype)
    pos = torch.cumsum(act, 1) - 1.0
    ok = (pos[:, :, None] + pos[:, None, :]) < act.sum(1)[:, None, None]
    adj = ok.to(act.dtype) * act[:, :, None] * act[:, None, :]
    deg = adj.sum(-1)
    inv = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(), 0.0)
    a_norm = adj * inv[:, :, None] * inv[:, None, :]
    x_l, out, layer = batch.x, {}, 0
    while f"ll.{layer}.weight" in params:
        p = {k[len(f"lv.{layer}."):]: v for k, v in params.items()
             if k.startswith(f"lv.{layer}.")}
        hs = x_l @ p["weight"].t()
        hd = x_v @ p["weight_dst"].t()
        e = _leaky((hs * p["att_src"].reshape(-1)).sum(-1)
                   + (hd * p["att_dst"].reshape(-1)).sum(-1)[vid])
        top = e.new_full((G * K,), -math.inf).scatter_reduce(
            0, vid, e, "amax")
        ex = torch.exp(e - top[vid])
        alpha = ex / e.new_zeros(G * K).index_add_(0, vid, ex)[vid]
        lv = (hs.new_zeros(G * K, hs.shape[1]).index_add_(
            0, vid, alpha[:, None] * hs) + p["bias"])
        hv = (x_v @ params[f"vv.{layer}.weight"].t()).reshape(G, K, -1)
        vv = (torch.bmm(a_norm, hv).reshape(G * K, -1)
              + params[f"vv.{layer}.bias"])
        out[f"lv.{layer}"], out[f"vv.{layer}"] = lv, vv
        h = gcn_aggregate(x_l @ params[f"ll.{layer}.weight"].t(), batch.src,
                          batch.dst, n, self_loops=False)
        x_l = torch.relu(h + params[f"ll.{layer}.bias"])
        x_v = torch.where(active[:, None], torch.relu(lv + vv), 0.0)
        layer += 1
    return out, active


def _virtual_gap(got: dict, want: dict, active, sure_graph, K: int) -> float:
    """max over the relations of max|p - r| / max|r| over the active
    virtual nodes of the graphs whose clusters are all sure."""
    rows = active & sure_graph.repeat_interleave(K)
    if not bool(rows.any()):
        return math.inf
    worst = 0.0
    for name, r in want.items():
        p = got.get(name)
        if p is None:
            return math.inf
        p = p.reshape(-1, p.shape[-1])[:r.shape[0]][rows]
        r = r[rows]
        worst = max(worst, float((p - r).abs().max())
                    / max(float(r.abs().max()), 1e-30))
    return worst


def _sure_graphs(margin, batch):
    low = torch.zeros(batch.num_graphs, dtype=torch.long,
                      device=margin.device).index_add_(
        0, batch.graph, (margin < CLUSTER_MARGIN).long())
    return low == 0


def extra_checks(probe, batch, weights) -> dict:
    """cluster_mismatch: nodes of the first train batch whose cluster in
    the program's batch differs from the argmax of the program's trained
    SCN as the reference computes it, among nodes whose two most likely
    clusters lie ``CLUSTER_MARGIN`` apart or more.  Exact, limit 0.
    virtual_gap: the program's lv and vv outputs at the first step against
    :func:`virtual_outputs` from the reference's clusters, over the
    graphs whose nodes are all that sure."""
    want, margin = clusters(probe.at_first_step["scn"], batch)
    got = probe.batches[0].cluster[batch.rows].to(want.dtype)
    sure = margin >= CLUSTER_MARGIN
    K = int(probe.at_first_step["scn"]["cluster.weight"].shape[0])
    ref, active = virtual_outputs(weights["model"], batch, want, K)
    return {"cluster_mismatch": float(((got != want) & sure).sum()),
            "virtual_gap": _virtual_gap(probe.parts, ref, active,
                                        _sure_graphs(margin, batch), K)}


def train_flops(config: dict, dims: dict, n_nodes, n_edges) -> float:
    """Model FLOPs of one train pass over graphs of ``n_nodes`` and
    ``n_edges`` (arrays), counted per graph from its real nodes and edges:
    each layer's ll GCN (2·n·F_in·H + 2·e·H), lv GAT (the source and
    virtual projections, the attention logits, a softmax of 5 operations
    an edge of each node to its cluster, the aggregation) and vv GCN over
    the K x K virtual graph; the virtual nodes' initial mean; the readout,
    dense layer and head.  The backward, twice the forward, is counted on
    what reaches the loss alone (ll, readout, dense, head): autograd does
    no backward work on the virtual relations."""
    h = config["run"]["hscn"]
    H, L, K = h["hidden_channels"], h["num_layers"], h["num_clusters"]
    F, C = dims["features"], dims["classes"]
    n, e = float(sum(n_nodes)), float(sum(n_edges))
    g = float(len(n_nodes))
    loss_path = virt = 0.0
    for layer in range(L):
        fin = F if layer == 0 else H
        loss_path += 2 * n * fin * H + 2 * e * H
        virt += (2 * n * fin * H + 2 * g * K * fin * H      # projections
                 + 2 * n * H + 2 * g * K * H               # logits
                 + 5 * n + 2 * n * H                       # softmax, sum
                 + 2 * g * K * fin * H + 2 * g * K * K * H)  # vv
    virt += n * F
    loss_path += n * H + g * (2 * H * H + 2 * H * C)
    return 3 * loss_path + virt


def extra_checks_control(probe, batch, weights) -> dict:
    """The same numbers of the reference in TF32 against its float32
    self (the control), over the same nodes and graphs."""
    scn = probe.at_first_step["scn"]
    want, margin = clusters(scn, batch)
    K = int(scn["cluster.weight"].shape[0])
    ref, active = virtual_outputs(weights["model"], batch, want, K)
    with matmul_precision(True):
        got, _ = clusters(scn, batch)
        low, _ = virtual_outputs(weights["model"], batch, want, K)
    sure = margin >= CLUSTER_MARGIN
    return {"cluster_mismatch": float(((got != want) & sure).sum()),
            "virtual_gap": _virtual_gap(low, ref, active,
                                        _sure_graphs(margin, batch), K)}
