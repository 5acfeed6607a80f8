"""Tracing, throughput and NaN checks of a run: the counterpart of
``graph_hscn_tpu/utils/profiling.py``.

- :func:`trace`: a ``torch.profiler`` trace of a block (CPU activities,
  and on the card CUDA activities through CUPTI, the kernels inside a
  replayed CUDA graph among them), written on exit into the directory as a
  Chrome trace ``<host>_<pid>.<ns>.pt.trace.json`` (TensorBoard's PyTorch
  profiler plugin, Perfetto or ``chrome://tracing`` open it); a no-op for
  None.  The JAX ``trace`` writes ``jax.profiler``'s.
- :class:`StepTimer`: wall clock and throughput over a window, edges/s,
  nodes/s, steps/s; :meth:`StepTimer.report` synchronises the card first.
- :func:`nan_guard` and :func:`check_nans`: ``runtime.debug_nans``.  JAX's
  ``jax_debug_nans`` checks the outputs of every program it runs and
  raises ``FloatingPointError`` on a NaN; the fit routes call
  :func:`check_nans` on what their programs' counterparts give back (a
  step's loss, scores and targets, the weights and optimizer state it
  leaves), which does nothing while the guard is off.

Left out: ``cost_analysis`` (XLA's cost model of a jitted function: the
step's FLOP count belongs to the benchmark, ROADMAP.md);
``enable_compile_cache`` (XLA's compiled programs: the port's counterpart
is the kernel build cache of ``ops/cuda/build.py``);
``maybe_init_distributed`` (``parallel/mesh.py:launcher_env`` and
``process_group``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterable, Iterator

import torch

_debug_nans = False


def nan_guard(enable: bool = True) -> None:
    """Turn the process-wide NaN check on or off, as
    ``jax.config.update("jax_debug_nans", enable)`` does; the runner turns
    it on for ``runtime.debug_nans`` and, as JAX, never off."""
    global _debug_nans
    _debug_nans = bool(enable)


def check_nans(where: str, *named: Iterable[tuple[str, torch.Tensor]],
               group=None) -> None:
    """With the guard on, raise ``FloatingPointError("invalid value (nan)
    encountered in <where>: <name>")`` naming the first tensor of
    ``named`` (iterables of (name, tensor) pairs, read only with the guard
    on; tensors that are not floating point are skipped) that holds a
    NaN.  One reduction a tensor (its 2-norm, NaN exactly where the
    tensor holds one: an inf is no NaN, as for JAX's ``debug_nans``), one
    readback.  ``group``: every rank of the process
    group calls this with the same names; the flags are all-reduced (MAX)
    first, so that every rank raises together and none is left waiting in
    the next collective.  With the guard off: nothing, no sync."""
    if not _debug_nans:
        return
    named = [(n, t) for pairs in named for n, t in pairs
             if t is not None and t.is_floating_point()]
    if not named:
        return
    norms = torch._foreach_norm([t.detach() for _, t in named])
    device = named[0][1].device
    flags = torch.stack([n.float().to(device) for n in norms]).isnan()
    flags = flags.float()
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=group)
    bad = flags.cpu().nonzero()
    if len(bad):
        raise FloatingPointError(f"invalid value (nan) encountered in "
                                 f"{where}: {named[int(bad[0])][0]}")


def training_state(model: torch.nn.Module, opt=None
                   ) -> Iterator[tuple[str, torch.Tensor]]:
    """The (name, tensor) pairs of what a train step leaves, made as they
    are read: ``model``'s parameters, and with ``opt`` (a
    ``train.optimizers.Optimizer``) the state its
    ``Optimizer.state_tensors`` names: JAX's ``TrainState`` params and
    ``opt_state``."""
    names = {}
    for n, p in model.named_parameters():
        names[p] = n
        yield f"parameter {n}", p
    if opt is not None:
        for p, key, t in opt.state_tensors():
            yield f"optimizer {key} of {names.get(p, '?')}", t


@contextlib.contextmanager
def trace(profile_dir: str | None, device=None):
    """Trace the block with ``torch.profiler`` into ``profile_dir``
    (created if need be): CPU activities, and CUDA ones where ``device``
    is a CUDA device.  Every event stays in host memory until the block
    ends."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     str(profile_dir))):
        yield


class StepTimer:
    """Throughput meter: edges/s, nodes/s, steps/s over a window.  The
    card runs behind the host, so :meth:`report` synchronises the current
    CUDA device (if CUDA is in use) before it reads the clock."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sync()
        self.t0 = time.perf_counter()
        self.steps = 0
        self.edges = 0
        self.nodes = 0

    def update(self, num_edges: int, num_nodes: int = 0):
        self.steps += 1
        self.edges += num_edges
        self.nodes += num_nodes

    @staticmethod
    def _sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def report(self) -> dict:
        self._sync()
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "steps_per_sec": self.steps / dt,
            "edges_per_sec": self.edges / dt,
            "nodes_per_sec": self.nodes / dt,
            "wall_sec": dt,
        }
