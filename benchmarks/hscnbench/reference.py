"""The plain half of the yardstick, shared by the configurations' own
references (``configs/<config>.py``): initial weights made from the seed,
batches made from the dataset file, a GCN aggregation by ``index_add``,
AdamW written out, and the training that follows the program's first
steps.  Plain PyTorch in float32 on the device it is given; it imports
nothing of the program and takes nothing the program made.

A configuration's reference module (``configs/<config>.py``) gives:
  targets(config, dims) -> {target: {name: shape}} by the port's names;
  observed -> the target whose training is followed;
  forward(params, batch, drop) -> logits of the batch's real rows;
  loss(logits, batch) -> the scalar loss;
  train_flops(config, dims, n_nodes, n_edges) -> model FLOPs of a train
    pass over graphs of those sizes;
and, where it has them, extra_checks(probe, batch, rows) (further numbers
of ``correct``) and spmm_launches(config, dims) (the widths of a train
step's ``csr_spmm`` launches), and these optional hooks:
  initial(target, name, shape) -> "ones", "zeros", "draw" or None: how
    that tensor starts (:func:`make_weights`); without the hook, or where
    it gives None, a vector starts at zeros and a matrix at the seeded
    glorot draw;
  stages, watched, extra_checks_control: a further trained model, the
    submodules read at the first step, the control's extra numbers (the
    harness's ``stage``, ``Probe``, ``readings``).
What ``forward`` is handed: a :class:`Batch` (with ``edge_attr`` where the
dataset file has edge features, and ``ids``, its dataset graph indices)
and ``drop``, a :class:`Dropout`: ``drop(h, batch)`` the node-row
dropout at ``mp.dropout`` (identity at 0), and ``drop.bits(shape)`` /
``drop.dropout(x, rate)`` the generator's next draw of any shape, for a
draw the program makes at a rate the module reads from its own config.
The optimizer that ``follow`` writes out takes the clipping
(``optim.clip_grad_norm``) and the lr schedule (``optim.schedule``,
``optim.warmup_steps``) that the port parses from the configuration; with
neither named, a constant lr and no clipping, as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch


def make_weights(spec: dict, seed: int, device, initial=None) -> dict:
    """Initial weights for {name: shape}, by flax's rules as the port
    applies them: glorot-uniform for a matrix [out, in] and for the
    attention vectors [1, (1,) H, C] (fan-in H, fan-out C), zero biases.
    One uniform draw from a generator on ``device`` seeded with ``seed``,
    split in name order.  ``initial(name, shape)``: "ones" or "zeros" (the
    tensor starts there, its share of the draw unused), "draw" (the glorot
    draw; a tensor of two or more axes only) or None (the rule above); the
    draw is the same whatever it says."""
    names = sorted(spec)
    sizes = [math.prod(spec[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for n, size in zip(names, sizes):
        shape = tuple(spec[n])
        rule = (initial(n, shape) if initial else None) or (
            "zeros" if len(shape) == 1 else "draw")
        if rule == "ones":
            w = torch.ones(shape, device=device)
        elif rule == "zeros":
            w = torch.zeros(shape, device=device)
        elif rule == "draw" and len(shape) >= 2:
            fan_out, fan_in = ((shape[-2], shape[-1]) if len(shape) == 2
                               else (shape[-1], shape[-2]))
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w = (u[off:off + size] * a).reshape(shape)
        else:
            raise ValueError(f"no initial rule {rule!r} for {n} {shape}")
        out[n] = w.contiguous()
        off += size
    return out


@dataclasses.dataclass
class Batch:
    """Real graphs of one step: x [n, F], src/dst [e] (batch-global,
    receiver-sorted not required), graph [n] (index of the graph in the
    batch), rows [n] (each node's row in the program's padded batch),
    num_graphs, n_pad (the padded batch's rows), the targets y [G, C]
    or node_y [n, C], edge_attr [e, Fe] (the dataset file's edge
    features, float32, in the order of src and dst; None where the file
    has none) and ids (the graphs' indices in the dataset file)."""
    x: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    graph: torch.Tensor
    rows: torch.Tensor
    num_graphs: int
    n_pad: int
    y: torch.Tensor | None = None
    node_y: torch.Tensor | None = None
    edge_attr: torch.Tensor | None = None
    ids: tuple = ()


def make_batch(arrays: dict, ids, rows: np.ndarray, n_pad: int,
               device) -> Batch:
    """The batch of dataset graphs ``ids`` (indices into the file's
    graphs) from the dataset file's arrays."""
    node_ptr, edge_ptr = arrays["node_ptr"], arrays["edge_ptr"]
    xs, srcs, dsts, graph, ys, nys, eas = [], [], [], [], [], [], []
    off = 0
    for gi, g in enumerate(ids):
        n0, n1 = node_ptr[g], node_ptr[g + 1]
        e0, e1 = edge_ptr[g], edge_ptr[g + 1]
        ei = arrays["edge_index"][:, e0:e1] - n0 + off
        xs.append(arrays["node_feat"][n0:n1])
        srcs.append(ei[0])
        dsts.append(ei[1])
        graph.append(np.full(n1 - n0, gi))
        if "edge_feat" in arrays:
            eas.append(arrays["edge_feat"][e0:e1])
        if "y" in arrays:
            ys.append(arrays["y"][g])
        else:
            nys.append(arrays["node_y"][n0:n1])
        off += n1 - n0

    def t(a, dtype=None):
        return torch.as_tensor(np.concatenate(a) if isinstance(a, list)
                               else a, dtype=dtype, device=device)
    y = node_y = None
    if ys:
        y = torch.as_tensor(np.stack(ys), dtype=torch.float32,
                            device=device)
    else:
        k = int(arrays["num_node_classes"])
        node_y = torch.nn.functional.one_hot(
            t(nys, torch.int64), k).float()
    return Batch(x=t(xs, torch.float32), src=t(srcs, torch.int64),
                 dst=t(dsts, torch.int64), graph=t(graph, torch.int64),
                 rows=torch.as_tensor(rows, device=device),
                 num_graphs=len(ids), n_pad=int(n_pad), y=y, node_y=node_y,
                 edge_attr=t(eas, torch.float32) if eas else None,
                 ids=tuple(int(g) for g in ids))


def as_dtype(batch: Batch, dtype) -> Batch:
    """``batch`` with its floating fields (features, targets, edge
    features) in ``dtype``."""
    def cast(t):
        return None if t is None else t.to(dtype)
    return dataclasses.replace(batch, x=cast(batch.x), y=cast(batch.y),
                               node_y=cast(batch.node_y),
                               edge_attr=cast(batch.edge_attr))


def gcn_aggregate(h, src, dst, n, self_loops: bool):
    """D^-1/2 (A [+ I]) D^-1/2 h with D the in-degree [+ 1]: a sum over
    edges by ``index_add``."""
    deg = torch.zeros(n, dtype=h.dtype, device=h.device).index_add_(
        0, dst, torch.ones_like(dst, dtype=h.dtype))
    if self_loops:
        deg = deg + 1
    inv = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(), 0.0)
    w = (inv[src] * inv[dst])[:, None]
    out = torch.zeros_like(h).index_add_(0, dst, w * h[src])
    if self_loops:
        out = out + (inv * inv)[:, None] * h
    return out


def segment_mean(x, graph, num_graphs):
    s = torch.zeros(num_graphs, x.shape[1], dtype=x.dtype,
                    device=x.device).index_add_(0, graph, x)
    c = torch.zeros(num_graphs, dtype=x.dtype, device=x.device).index_add_(
        0, graph, torch.ones_like(graph, dtype=x.dtype))
    return s / c.clamp_min(1)[:, None]


class AdamW:
    """torch's AdamW update written out (decoupled decay lr * wd * p,
    bias-corrected moments, eps outside the root).  ``schedule``: the lr
    as a function of the count of updates already applied
    (:func:`lr_schedule`); None keeps ``lr``."""

    def __init__(self, params: dict, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8, schedule=None):
        self.wd, self.b1, self.b2, self.eps = (
            weight_decay, betas[0], betas[1], eps)
        self.schedule = schedule or (lambda t: lr)
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        lr = self.schedule(self.t)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            p.mul_(1 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[n].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def lr_schedule(lr: float, name: str = "constant", warmup: int = 0,
                horizon: int | None = None):
    """optax's schedules as the port's configuration names them, written
    out: the lr of the update that follows ``t`` applied ones.  A linear
    warmup 0 -> lr over ``warmup`` updates (the first update has lr 0),
    then ``constant`` lr, ``cosine`` decay lr -> 0 at
    max(horizon, warmup + 1) updates, or ``linear`` decay lr -> 0 over
    max(horizon - warmup, 1) updates after the warmup; ``horizon``: the
    fit's updates in all, epochs x train steps an epoch."""
    name = name.lower()

    def warm(t):
        return lr * min(t, warmup) / warmup

    if name == "constant":
        return warm if warmup > 0 else (lambda t: lr)
    if horizon is None:
        raise ValueError(f"schedule {name!r} needs the horizon")
    if name == "cosine":
        span = max(horizon, warmup + 1) - warmup

        def after(k):
            return lr * 0.5 * (1 + math.cos(math.pi * min(k, span) / span))
    elif name == "linear":
        span = max(horizon - warmup, 1)

        def after(k):
            return lr * (1 - min(k, span) / span)
    else:
        raise ValueError(f"unknown lr schedule {name!r}")
    return lambda t: warm(t) if t < warmup else after(t - warmup)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float = 1.0) -> dict:
    """optax.clip_by_global_norm: every gradient times max_norm / norm
    where the global norm of them all exceeds ``max_norm``."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    return {n: g * scale for n, g in grads.items()}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in matmuls and cuDNN on or off for the block, restored after:
    the reference runs with it off (the configuration's float32); the
    control with it on."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Dropout:
    """The program's dropout bits: one generator on ``device`` seeded with
    the training seed, drawn in the order the forward draws.
    ``drop(h, batch)``: the node rows' dropout at ``rate``, one draw of
    the padded batch's [n_pad, width] a call, a node keeping its row's
    bits (identity at rate 0, which draws nothing).  :meth:`bits` and
    :meth:`dropout` give the next draw in any shape the program draws
    (``models/layers.py:dropout``: ``torch.rand(x.shape, generator=...)``)
    and apply the port's rule to it."""

    def __init__(self, rate: float, width: int, seed: int, device):
        self.rate, self.width, self.device = rate, width, device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, h, batch: Batch):
        if self.rate == 0.0:
            return h
        bits = self.bits((batch.n_pad, self.width))[batch.rows]
        return torch.where(bits >= self.rate, h / (1.0 - self.rate), 0.0)

    def bits(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device)

    def dropout(self, x, rate: float):
        """``x`` (in the program's shape) through the port's dropout at
        ``rate``: kept where the bits are >= rate and scaled by
        1 / (1 - rate); at 0 or 1 no bits are drawn."""
        if rate == 0.0:
            return x
        if rate == 1.0:
            return torch.zeros_like(x)
        return torch.where(self.bits(x.shape) >= rate, x / (1.0 - rate), 0.0)


def first_half(logits, batch: Batch) -> tuple:
    """(logits, batch) cut to the first half of the batch's graphs: the
    fault of a step that leaves out half of its batch and takes the mean
    over the rest.  Graph-level logits are rows a graph, node-level ones
    rows a real node."""
    k = max(1, batch.num_graphs // 2)
    keep = batch.graph < k
    index = torch.cumsum(keep.long(), 0) - 1
    edges = keep[batch.dst]
    sub = dataclasses.replace(
        batch, x=batch.x[keep], src=index[batch.src[edges]],
        dst=index[batch.dst[edges]], graph=batch.graph[keep],
        rows=batch.rows[keep], num_graphs=k, ids=batch.ids[:k],
        edge_attr=(None if batch.edge_attr is None
                   else batch.edge_attr[edges]),
        y=None if batch.y is None else batch.y[:k],
        node_y=None if batch.node_y is None else batch.node_y[keep])
    graph_level = logits.shape[0] == batch.num_graphs and batch.y is not None
    return (logits[:k] if graph_level else logits[keep]), sub


def half_batch(loss):
    """``loss`` with :func:`first_half` planted in front of it."""
    def half(logits, batch):
        return loss(*first_half(logits, batch))
    return half


def follow(ref, config: dict, weights: dict, batches: list, drop,
           observe_steps: int, epoch_steps: int | None, loss_fn=None,
           frozen: bool = False, clip: bool = False,
           schedule=None) -> dict:
    """Train the reference from ``weights`` over ``batches`` (epoch 0 and
    on, in the program's order) with AdamW, the gradients first clipped
    to a global norm of 1.0 where ``clip``, the lr by ``schedule``
    (:func:`lr_schedule`; None: ``optim.lr``).  Returns the logits of the
    first ``observe_steps`` steps, the first gradient as the optimizer
    takes it (clipped), the weights after each of those steps and after
    epoch 0 (its first ``epoch_steps`` steps; with None, no epoch), and
    epoch 0's mean loss."""
    optim = config["run"]["optim"]
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    opt = AdamW(params, optim["lr"], float(optim["weight_decay"]),
                schedule=schedule)
    out = {"logits": [], "after_step": [], "losses": []}
    for k, batch in enumerate(batches):
        logits = ref.forward(params, batch, drop)
        loss = (loss_fn or ref.loss)(logits, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(params[n]))
                 for n, g in zip(params, grads)}
        if clip:
            grads = clip_by_global_norm(grads)
        if not frozen:
            opt.step(params, grads)
        out["losses"].append(loss.detach())
        if k < observe_steps:
            out["logits"].append(logits.detach())
            if k == 0:
                out["first_grad"] = grads
            out["after_step"].append({n: p.detach().clone()
                                      for n, p in params.items()})
        if epoch_steps is not None and k == epoch_steps - 1:
            out["after_epoch"] = {n: p.detach().clone()
                                  for n, p in params.items()}
            out["epoch_loss"] = float(torch.stack(out["losses"]).mean())
    return out
