"""A step captured once on the card as a CUDA graph and replayed: what
takes the place of the JAX package's one jitted program an epoch
(``lax.scan`` over the rows of the epoch's permutation,
``graph_hscn_tpu/train/device_data.py:make_epoch_fn`` and
``graph_hscn_tpu/train/clustering.py``).

A captured step's host code (Python, autograd, the kernel wrappers) runs
once, at capture; a replay launches the recorded device work alone.  What
the host code does besides must survive that:

- the kernel wrappers count their launches in Python: :class:`ReplayCounts`
  takes back what a capture added and adds it again at every replay;
- a dropout generator is registered with the graph, so that replay k draws
  the bits the eager step k would draw;
- a step that syncs with the host (``.item()``, a boolean mask) cannot be
  captured: the capture raises, and so does the caller.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterable

import torch

from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import sddmm_mh, spmm_mh
from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import edge_sddmm
from graph_hscn_tpu_torch.ops.cuda.segment_reduce_kernel import (
    segment_reduce)
from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import csr_spmm
from graph_hscn_tpu_torch.ops.fused_gcn import fused_gcn_bwd, fused_gcn_fwd


def counted_kernels() -> tuple:
    """Every kernel wrapper of the port; each keeps a ``.launches`` count,
    one a launch of its kernel."""
    return (csr_spmm, edge_sddmm, fused_gcn_fwd, fused_gcn_bwd, spmm_mh,
            sddmm_mh, segment_reduce)


class ReplayCounts:
    """Launch counts of a captured step: what the ``counters`` (objects
    with a ``.launches`` int) gained during the capture is taken back, since
    a capture launches nothing, and added again at every replay."""

    def __init__(self, counters: Iterable):
        self.counters = tuple(counters)
        self.deltas = (0,) * len(self.counters)

    @contextlib.contextmanager
    def capturing(self):
        before = [c.launches for c in self.counters]
        try:
            yield
        finally:
            self.deltas = tuple(c.launches - b
                                for c, b in zip(self.counters, before))
            for c, b in zip(self.counters, before):
                c.launches = b

    def replayed(self) -> None:
        for c, d in zip(self.counters, self.deltas):
            c.launches += d


@functools.cache
def side_stream(device: int) -> torch.cuda.Stream:
    """The one stream of ``device`` on which every step before a capture
    runs and every capture is made.  cuBLAS keeps a workspace for each
    stream it has run on, for the life of the process: a new stream a fit
    would hold another 32 MiB after each."""
    return torch.cuda.Stream(device)


def run_on_side_stream(fn: Callable[[], object]) -> None:
    """``fn()`` eagerly on the side stream, ordered after and before the
    current stream's work: the step before a capture, which builds and
    loads the kernels, caches their launch plans and creates the optimizer
    state and the gradients outside the graph."""
    side = side_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)


class CapturedStep:
    """``step()`` captured once as a CUDA graph in memory ``pool``;
    calling the object replays it.  ``generators``: the CUDA generators
    the step draws from, registered with the graph."""

    def __init__(self, step: Callable[[], object], pool=None,
                 generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        self.counts = ReplayCounts(counted_kernels())
        with self.counts.capturing(), torch.cuda.graph(
                self.graph, pool=pool,
                stream=side_stream(torch.cuda.current_device())):
            step()
        self.replays = 0

    def __call__(self) -> None:
        self.graph.replay()
        self.counts.replayed()
        self.replays += 1
