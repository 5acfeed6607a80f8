"""Device-resident dataset and on-device batch assembly: the counterpart of
``graph_hscn_tpu/train/device_data.py``.

For molecular-scale datasets the whole dataset lives on the card in
slotted per-graph form, and every step assembles its batch there from a row
of graph indices: a step's host-to-device traffic is none, and the epoch's
permutation is copied once.  The JAX package runs the epoch as one
``lax.scan`` program; here (:func:`make_epoch_fn`, :class:`RowSteps`) one
step, which reads its row from a static buffer by a counter on the device,
is captured once as a CUDA graph and replayed row by row; on the CPU the
same step runs eagerly row by row.

Layout (graph-major):
  nodes      [NG, slot, F]     zero-padded node features
  n_node     [NG]
  edges_src  [NG, e_slot]      graph-local, receiver-sorted, padded
  edges_dst  [NG, e_slot]
  edge_ok    [NG, e_slot]      bool
  y          [NG, C]           (graph tasks)  /  node_y [NG, slot, C]
  cluster    [NG, slot]        optional (HSCN)
  eigvecs/eigvals [NG, slot, K] optional (PE)
  adj        [NG, slot, slot]  int16 adjacency counts (the cache), or None

:func:`assemble` returns a slotted :class:`GraphBatch` so every model runs
unchanged; index entries of -1 are dummy slots (masked).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.train.capture import (CapturedStep,
                                                run_on_side_stream)

# The JAX package's budget for the adjacency cache: NG * slot^2 2-byte
# counts (device_data.py:135-141).  The port keeps its counts in int16
# (torch's uint16 has no index or cast kernels on CUDA), two bytes as
# there; a count above 32767 parallel edges is refused at build time.
ADJ_CACHE_BUDGET_BYTES = 512 * 1024 * 1024

_ARRAY_FIELDS = ("nodes", "n_node", "edges_src", "edges_dst", "edge_ok",
                 "edge_feat", "y", "node_y", "cluster", "eigvecs", "eigvals",
                 "adj")


@dataclasses.dataclass(frozen=True)
class DeviceDataset:
    nodes: Any            # [NG, slot, F]
    n_node: Any           # [NG]
    edges_src: Any        # [NG, e_slot]
    edges_dst: Any        # [NG, e_slot]
    edge_ok: Any          # [NG, e_slot]
    edge_feat: Any = None  # [NG, e_slot, Fe]
    y: Any = None         # [NG, C]
    node_y: Any = None    # [NG, slot, C]
    cluster: Any = None   # [NG, slot]
    eigvecs: Any = None   # [NG, slot, K]
    eigvals: Any = None   # [NG, slot, K]
    adj: Any = None       # [NG, slot, slot] int16 per-graph adjacency
    slot: int = 0
    e_slot: int = 0

    @property
    def num_graphs(self) -> int:
        return self.nodes.shape[0]

    def replace(self, **kw) -> "DeviceDataset":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "DeviceDataset":
        """The arrays as torch tensors on ``device``."""
        return self.replace(**{
            f: torch.as_tensor(getattr(self, f)).to(device)
            for f in _ARRAY_FIELDS if getattr(self, f) is not None})

    @staticmethod
    def build(graphs, slot: int | None = None, device=None,
              with_cluster: bool = False) -> "DeviceDataset":
        """The dataset in slotted form.  With ``device`` None the arrays
        stay numpy on the host (the JAX ``device_put=False``); with a
        device they are moved there and the adjacency cache is built on it
        when NG * slot^2 * 2 bytes fit ``ADJ_CACHE_BUDGET_BYTES``.
        ``with_cluster`` gives the dataset a ``cluster`` field (zeros where
        the graphs carry none) for the HSCN pipeline to write its
        assignments into."""
        NG = len(graphs)
        if any(g.edge_weight is not None for g in graphs):
            # The layout carries no per-edge weights (assemble emits
            # edge_weight=None): refuse instead of dropping them silently.
            raise ValueError(
                "DeviceDataset does not carry edge_weight; use the host "
                "batched path (runtime.device_dataset: off) for "
                "weighted graphs")
        F = graphs[0].x.shape[1]
        slot = slot or ((max(g.num_nodes for g in graphs) + 7) // 8) * 8
        e_slot = ((max(g.num_edges for g in graphs) + 127) // 128) * 128
        nodes = np.zeros((NG, slot, F), np.float32)
        n_node = np.zeros((NG,), np.int32)
        src = np.zeros((NG, e_slot), np.int32)
        dst = np.zeros((NG, e_slot), np.int32)
        ok = np.zeros((NG, e_slot), bool)
        g0 = graphs[0]
        has_y = g0.y is not None
        has_ny = g0.node_y is not None
        has_cl = g0.cluster is not None or with_cluster
        has_ev = g0.eigvecs is not None
        has_ea = g0.edge_attr is not None
        edge_feat = (np.zeros((NG, e_slot, g0.edge_attr.shape[1]),
                              np.float32) if has_ea else None)
        y = (np.zeros((NG, np.asarray(g0.y).reshape(-1).shape[0]),
                      np.float32) if has_y else None)
        node_y = (np.zeros((NG, slot, g0.node_y.shape[1]), np.float32)
                  if has_ny else None)
        cluster = np.zeros((NG, slot), np.int32) if has_cl else None
        eigvecs = (np.zeros((NG, slot, g0.eigvecs.shape[1]), np.float32)
                   if has_ev else None)
        eigvals = (np.zeros((NG, slot, g0.eigvals.shape[1]), np.float32)
                   if has_ev else None)
        for i, g in enumerate(graphs):
            n, e = g.num_nodes, g.num_edges
            if n > slot or e > e_slot:
                raise ValueError(f"graph {i} ({n} nodes, {e} edges) exceeds "
                                 f"slot {slot} / e_slot {e_slot}")
            nodes[i, :n] = g.x
            n_node[i] = n
            order = np.argsort(g.edge_index[1], kind="stable")
            src[i, :e] = g.edge_index[0][order]
            dst[i, :e] = g.edge_index[1][order]
            ok[i, :e] = True
            if has_ea:
                edge_feat[i, :e] = g.edge_attr[order]
            if has_y:
                y[i] = np.asarray(g.y, np.float32).reshape(-1)
            if has_ny:
                node_y[i, :n] = g.node_y
            if has_cl and g.cluster is not None:
                cluster[i, :n] = g.cluster
            if has_ev:
                eigvecs[i, :n] = np.nan_to_num(g.eigvecs)
                eigvals[i, :n] = np.nan_to_num(g.eigvals)
        ds = DeviceDataset(nodes=nodes, n_node=n_node, edges_src=src,
                           edges_dst=dst, edge_ok=ok, edge_feat=edge_feat,
                           y=y, node_y=node_y, cluster=cluster,
                           eigvecs=eigvecs, eigvals=eigvals, slot=slot,
                           e_slot=e_slot)
        if device is None:
            return ds
        ds = ds.to(device)
        # Per-graph dense adjacency cache: built once on the device (no
        # upload of the big array), gathered by every assemble instead of
        # a scatter a step.
        if NG * slot * slot * 2 <= ADJ_CACHE_BUDGET_BYTES:
            ds = ds.replace(adj=build_adj_cache(ds))
        return ds


def build_adj_cache(ds: DeviceDataset) -> torch.Tensor:
    """[NG, slot, slot] int16 adjacency counts (adj[g, dst_local,
    src_local]) from the per-graph edge lists: one ``index_add_`` in int32,
    then narrowed.  Raises if a count would not fit int16."""
    NG, slot = ds.num_graphs, ds.slot
    g = torch.arange(NG, dtype=torch.int64,
                     device=ds.edges_src.device)[:, None]
    flat = (g * (slot * slot) + ds.edges_dst.long() * slot
            + ds.edges_src.long())
    flat = torch.where(ds.edge_ok, flat, NG * slot * slot)
    counts = torch.zeros(NG * slot * slot + 1, dtype=torch.int32,
                         device=flat.device)
    counts.index_add_(0, flat.reshape(-1),
                      ds.edge_ok.reshape(-1).to(torch.int32))
    counts = counts[:-1]
    if NG and int(counts.max()) > torch.iinfo(torch.int16).max:
        raise ValueError("adjacency cache: more than 32767 parallel edges "
                         "between one pair of nodes")
    return counts.to(torch.int16).reshape(NG, slot, slot)


def assemble(ds: DeviceDataset, idx: torch.Tensor) -> GraphBatch:
    """On-device batch assembly: idx [B] int graph indices on ds's device
    (-1 = dummy slot).

    Returns a slotted GraphBatch with B+1 graph slots (last = dummy),
    N = B*slot nodes, E = B*e_slot edges (receiver-sorted globally because
    per-graph lists are receiver-sorted and slots are ascending).  Index
    fields are int64, as ``GraphBatch.to`` makes them."""
    B = idx.shape[0]
    slot, e_slot = ds.slot, ds.e_slot
    dev = ds.nodes.device
    real = idx >= 0
    safe = idx.clamp(0, ds.num_graphs - 1).long()

    def take(a):
        return a.index_select(0, safe)

    nodes = take(ds.nodes)                               # [B, slot, F]
    n_node = torch.where(real, take(ds.n_node), 0).long()
    node_feat = nodes.reshape(B * slot, -1)

    offs = (torch.arange(B, dtype=torch.int64, device=dev) * slot)[:, None]
    senders = (take(ds.edges_src) + offs).reshape(-1)
    receivers = (take(ds.edges_dst) + offs).reshape(-1)
    edge_ok = take(ds.edge_ok)
    edge_mask = (edge_ok & real[:, None]).reshape(-1)
    # Padding edges self-loop on the LAST ROW OF THEIR OWN SLOT, which keeps
    # the concatenated receivers globally non-decreasing.  Every layer masks
    # padded-edge contributions, so it is safe even when a graph fills its
    # slot exactly.
    own_last = (offs + slot - 1).expand(B, e_slot).reshape(-1)
    senders = torch.where(edge_mask, senders, own_last)
    receivers = torch.where(edge_mask, receivers, own_last)

    in_slot = torch.arange(slot, dtype=torch.int64, device=dev)[None, :]
    node_ok = in_slot < n_node[:, None]
    node_graph = torch.where(
        node_ok, torch.arange(B, dtype=torch.int64, device=dev)[:, None],
        B).reshape(-1)
    node_mask = node_ok.reshape(-1)

    def pad_g(x):   # [B, ...] -> [B+1, ...] with a zero dummy row
        return torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=dev)])

    n_edge = torch.where(real, edge_ok.sum(1), 0)
    edge_feat = (take(ds.edge_feat).reshape(B * e_slot, -1)
                 if ds.edge_feat is not None else None)
    y = (pad_g(take(ds.y) * real[:, None].float())
         if ds.y is not None else None)
    node_y = (take(ds.node_y).reshape(B * slot, -1)
              if ds.node_y is not None else None)
    cluster = (take(ds.cluster).reshape(-1).long()
               if ds.cluster is not None else None)
    eigvecs = (take(ds.eigvecs).reshape(B * slot, -1)
               if ds.eigvecs is not None else None)
    eigvals = (take(ds.eigvals).reshape(B * slot, -1)
               if ds.eigvals is not None else None)
    # Cached adjacency: one block gather and cast instead of the per-step
    # scatter (ops/dense.build_dense_adj); dummy slots zeroed so no phantom
    # edges reach the model.
    dense_adj = (take(ds.adj).float() * real[:, None, None].float()
                 if ds.adj is not None else None)

    return GraphBatch(
        node_feat=node_feat, senders=senders, receivers=receivers,
        node_graph=node_graph, n_node=pad_g(n_node), n_edge=pad_g(n_edge),
        node_mask=node_mask, edge_mask=edge_mask, graph_mask=pad_g(real),
        y=y, node_y=node_y, cluster=cluster, eigvecs=eigvecs,
        eigvals=eigvals, edge_feat=edge_feat, slot=slot, dense_adj=dense_adj)


def epoch_permutation(num_graphs: int, batch_size: int, seed: int,
                      shuffle: bool = True) -> np.ndarray:
    """[NB, B] index matrix covering the dataset once; -1 pads the tail."""
    idx = np.arange(num_graphs)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    nb = (num_graphs + batch_size - 1) // batch_size
    out = np.full((nb, batch_size), -1, np.int32)
    out.reshape(-1)[:num_graphs] = idx
    return out


def resolve_capture(capture: bool | None, device) -> bool:
    """Whether the device route captures its steps: by default on a CUDA
    device, never on the CPU (there is nothing to capture)."""
    on_card = torch.device(device).type == "cuda"
    if capture is None:
        return on_card
    if capture and not on_card:
        raise ValueError("capture=True needs a CUDA device")
    return capture


def row_buffers(max_rows: int, batch_size: int, device, capture: bool
                ) -> tuple:
    """What the :class:`RowSteps` of one route share: the static
    permutation buffer [max_rows, B] (-1 = dummy slot), the row counter [1]
    on ``device``, and, captured, the graphs' memory pool (else None)."""
    rows = torch.full((max_rows, batch_size), -1, dtype=torch.int32,
                      device=device)
    counter = torch.zeros(1, dtype=torch.int64, device=device)
    return rows, counter, torch.cuda.graph_pool_handle() if capture else None


class RowSteps:
    """An epoch of one step over the rows of a [NB, B] permutation: the
    counterpart of a ``lax.scan`` over them.

    The step reads its row from ``rows`` [max_rows, B] (the static
    permutation buffer, -1 = dummy slot) at the device counter ``counter``
    [1], assembles the batch, runs ``body(batch)`` -> a tuple of tensors,
    writes them into the epoch's output buffers [max_rows, ...] at the
    counter's row, and adds 1 to the counter.  With ``capture``, the first
    step runs eagerly on a side stream (a real row of the epoch), then the
    step is captured once as a CUDA graph in ``pool`` (``generators``
    registered with it) and every later row is a replay; without, every
    row runs the step eagerly.

    A step that takes one of several forms (an optimizer step that only
    accumulates, or one that applies) has ``body`` a dict {form: body}
    and ``form()`` the host's choice for the next row, called once a row;
    each form is run eagerly and captured the first time it comes, and
    replayed after.

    A graph binds its tensors by address: ``ds`` and ``rows`` must not be
    rebuilt or ``replace``d while this object is in use.
    """

    def __init__(self, body: Callable[[GraphBatch], tuple] | dict,
                 ds: DeviceDataset, rows: torch.Tensor,
                 counter: torch.Tensor, capture: bool, pool=None,
                 generators=(), form: Callable[[], Any] | None = None):
        self.bodies = body if isinstance(body, dict) else {None: body}
        self.form = form or (lambda: None)
        self.ds = ds
        self.rows = rows
        self.counter = counter
        self.capture = capture
        self.pool = pool
        self.generators = tuple(generators)
        self.outs: tuple | None = None
        self.graphs: dict[Any, CapturedStep] = {}

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values())

    def _step(self, form) -> None:
        row = self.rows.index_select(0, self.counter).reshape(-1)
        outs = self.bodies[form](assemble(self.ds, row))
        if self.outs is None:
            self.outs = tuple(
                torch.zeros((self.rows.shape[0],) + tuple(o.shape),
                            dtype=o.dtype, device=o.device) for o in outs)
        for buf, o in zip(self.outs, outs):
            buf.index_copy_(0, self.counter, o.detach().unsqueeze(0))
        self.counter.add_(1)

    def load(self, perm) -> int:
        """Copy the epoch's permutation [NB, B] into the buffer and reset
        the counter; returns NB."""
        nb = len(perm)
        self.rows[:nb].copy_(torch.as_tensor(perm))
        self.counter.zero_()
        return nb

    def step(self) -> None:
        """The next row: eager, or the first of its form eager and
        captured, or a replay."""
        form = self.form()
        if not self.capture:
            self._step(form)
        elif form not in self.graphs:
            step = functools.partial(self._step, form)
            run_on_side_stream(step)
            self.graphs[form] = CapturedStep(step, self.pool,
                                             self.generators)
        else:
            self.graphs[form]()

    def __call__(self, perm, step_seconds: list | None = None) -> tuple:
        """Run the epoch over ``perm``; returns the output buffers' first
        NB rows (views: the next epoch overwrites them).  With
        ``step_seconds``, each step ends in a device sync and its wall
        seconds from launch are appended there."""
        nb = self.load(perm)
        for _ in range(nb):
            t0 = time.perf_counter()
            self.step()
            if step_seconds is not None:
                if self.rows.is_cuda:
                    torch.cuda.synchronize(self.rows.device)
                step_seconds.append(time.perf_counter() - t0)
        return tuple(b[:nb] for b in self.outs)


def make_epoch_fn(model: torch.nn.Module, opt, ds: DeviceDataset,
                  batch_size: int, max_rows: int, loss_fn: str,
                  node_level: bool = False,
                  compat_sigmoid_score: bool = False,
                  generator: torch.Generator | None = None,
                  capture: bool | None = None) -> tuple:
    """The train and eval epochs over ``ds`` (the JAX ``make_epoch_fn``).

    Returns (train_epoch, eval_epoch), two :class:`RowSteps`:
      train_epoch(perm [NB, B]) -> (losses [NB], scores, trues, masks),
        each row a train step (forward, ``criterion``, backward, ``opt``'s
        update; dropout from ``generator``), the model and ``opt`` updated
        in place; with gradient accumulation a row's step accumulates or
        applies as ``opt.next_applies()`` counts it on the host, one form
        captured for each;
      eval_epoch(perm) -> the same outputs of eval steps.
    NB is at most ``max_rows``.  Both share one static permutation buffer
    and one counter, and, captured (``capture``: by default on a CUDA
    device), one memory pool: the train step is captured after the fit's
    first train row, the eval step after its first eval row.  ``opt`` must
    then be built ``capturable``.  The graphs read ``ds`` by address: the
    dataset must not be rebuilt or ``replace``d after the epochs are made
    (the HSCN pipeline makes them after clustering has written the
    clusters).
    """
    from graph_hscn_tpu_torch.train.loop import make_train_step
    dev = ds.nodes.device
    capture = resolve_capture(capture, dev)
    train_step, eval_step = make_train_step(
        model, opt, loss_fn, node_level=node_level,
        compat_sigmoid_score=compat_sigmoid_score, generator=generator)
    rows, counter, pool = row_buffers(max_rows, batch_size, dev, capture)
    gens = () if generator is None else (generator,)
    forms = {applies: functools.partial(train_step, applies=applies)
             for applies in (False, True)}
    return (RowSteps(forms, ds, rows, counter, capture, pool, gens,
                     form=opt.next_applies),
            RowSteps(eval_step, ds, rows, counter, capture, pool, gens))
