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
step's ``csr_spmm`` launches).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch


def make_weights(spec: dict, seed: int, device) -> dict:
    """Initial weights for {name: shape}, by flax's rules as the port
    applies them: glorot-uniform for a matrix [out, in] and for the
    attention vectors [1, (1,) H, C] (fan-in H, fan-out C), zero biases.
    One uniform draw from a generator on ``device`` seeded with ``seed``,
    split in name order."""
    names = sorted(spec)
    sizes = [math.prod(spec[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for n, size in zip(names, sizes):
        shape = tuple(spec[n])
        if len(shape) == 1:
            w = torch.zeros(shape, device=device)
        else:
            fan_out, fan_in = ((shape[-2], shape[-1]) if len(shape) == 2
                               else (shape[-1], shape[-2]))
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w = (u[off:off + size] * a).reshape(shape)
        out[n] = w.contiguous()
        off += size
    return out


@dataclasses.dataclass
class Batch:
    """Real graphs of one step: x [n, F], src/dst [e] (batch-global,
    receiver-sorted not required), graph [n] (index of the graph in the
    batch), rows [n] (each node's row in the program's padded batch),
    num_graphs, n_pad (the padded batch's rows), and the targets y [G, C]
    or node_y [n, C]."""
    x: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    graph: torch.Tensor
    rows: torch.Tensor
    num_graphs: int
    n_pad: int
    y: torch.Tensor | None = None
    node_y: torch.Tensor | None = None


def make_batch(arrays: dict, ids, rows: np.ndarray, n_pad: int,
               device) -> Batch:
    """The batch of dataset graphs ``ids`` (indices into the file's
    graphs) from the dataset file's arrays."""
    node_ptr, edge_ptr = arrays["node_ptr"], arrays["edge_ptr"]
    xs, srcs, dsts, graph, ys, nys = [], [], [], [], [], []
    off = 0
    for gi, g in enumerate(ids):
        n0, n1 = node_ptr[g], node_ptr[g + 1]
        e0, e1 = edge_ptr[g], edge_ptr[g + 1]
        ei = arrays["edge_index"][:, e0:e1] - n0 + off
        xs.append(arrays["node_feat"][n0:n1])
        srcs.append(ei[0])
        dsts.append(ei[1])
        graph.append(np.full(n1 - n0, gi))
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
                 num_graphs=len(ids), n_pad=int(n_pad), y=y, node_y=node_y)


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
    bias-corrected moments, eps outside the root)."""

    def __init__(self, params: dict, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            lr, weight_decay, betas[0], betas[1], eps)
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            p.mul_(1 - self.lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[n].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)


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


def dropout_fn(rate: float, width: int, seed: int, device):
    """The program's dropout bits: one generator on ``device`` seeded with
    the training seed, one draw of the padded batch's [n_pad, width] a
    dropout, in the order the forward takes them; a node keeps its row's
    bits."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def drop(h, batch: Batch):
        if rate == 0.0:
            return h
        bits = torch.rand((batch.n_pad, width), generator=gen,
                          device=device)[batch.rows]
        return torch.where(bits >= rate, h / (1.0 - rate), 0.0)
    return drop


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
        rows=batch.rows[keep], num_graphs=k,
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
           frozen: bool = False) -> dict:
    """Train the reference from ``weights`` over ``batches`` (epoch 0 and
    on, in the program's order) with AdamW.  Returns the logits of the
    first ``observe_steps`` steps, the first gradient, the weights after
    each of those steps and after epoch 0 (its first ``epoch_steps``
    steps; with None, no epoch), and epoch 0's mean loss."""
    optim = config["run"]["optim"]
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    opt = AdamW(params, optim["lr"], float(optim["weight_decay"]))
    out = {"logits": [], "after_step": [], "losses": []}
    for k, batch in enumerate(batches):
        logits = ref.forward(params, batch, drop)
        loss = (loss_fn or ref.loss)(logits, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(params[n]))
                 for n, g in zip(params, grads)}
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
