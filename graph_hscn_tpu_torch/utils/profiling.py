"""Tracing, spans and NaN checks of a run: the counterpart of
``graph_hscn_tpu/utils/profiling.py``.

- :class:`span`: the port's own instrumentation at its layer boundaries
  (data and plan, the train loop and captured epoch, set-up and
  clustering, the mesh collectives).  Always on, as in-memory totals a
  (name, fit epoch) pair (:func:`span_totals`); while a
  ``torch.profiler`` records, also a ``record_function`` range, so that
  the spans lie on the profiler's clock beside the device operations.
- :func:`count`: the port's counters, totals a (name, fit epoch) beside
  the spans' (:func:`counter_totals`): what the host knows of the work it
  issues (a GPS train epoch's attention pairs, at set-up), counted with
  no device sync and never inside a captured step.
- :func:`trace`: a ``torch.profiler`` trace of a block (CPU activities,
  and on the card CUDA activities through CUPTI, the kernels inside a
  replayed CUDA graph among them), written on exit into the directory as a
  Chrome trace ``<host>_<pid>.<ns>.pt.trace.json`` (TensorBoard's PyTorch
  profiler plugin, Perfetto or ``chrome://tracing`` open it); a no-op for
  None.  The JAX ``trace`` writes ``jax.profiler``'s.
- :func:`nan_guard` and :func:`check_nans`: ``runtime.debug_nans``.  JAX's
  ``jax_debug_nans`` checks the outputs of every program it runs and
  raises ``FloatingPointError`` on a NaN; the fit routes call
  :func:`check_nans` on what their programs' counterparts give back (a
  step's loss, scores and targets, the weights and optimizer state it
  leaves), which does nothing while the guard is off.

Left out: ``StepTimer`` (a throughput meter over a window: the spans and
the fit's ``step_timing`` cover it); ``cost_analysis`` (XLA's cost model
of a jitted function: the step's FLOP count belongs to the benchmark,
ROADMAP.md); ``enable_compile_cache`` (XLA's compiled programs: the
port's counterpart is the kernel build cache of ``ops/cuda/build.py``);
``maybe_init_distributed`` (``parallel/mesh.py:launcher_env`` and
``process_group``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterable, Iterator

import torch

_debug_nans = False

# The span registry: (name, epoch) -> [calls, total_ns, self_ns, bytes].
_totals: dict[tuple[str, int | None], list[int]] = {}
_totals_lock = threading.Lock()
# Each thread's open spans, innermost last.
_open = threading.local()
# The fit epoch that run_fit_loop is in, None outside a fit.
_epoch: int | None = None
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


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


def set_epoch(epoch: int | None) -> None:
    """Tag the spans that start from now on with fit epoch ``epoch`` (None:
    outside a fit).  ``train.loop.run_fit_loop`` sets it at the start of
    each train epoch, the evals after that epoch keep it, and the loop
    sets None again when it leaves."""
    global _epoch
    _epoch = epoch


class span:
    """A span of the port's work at a layer boundary: ``with
    span("data.pack"): ...``.

    Each use adds into the registry, under (``name``, the fit epoch it
    started in), its calls, its wall nanoseconds (``total_ns``), the part
    of them that no child span on the same thread covers (``self_ns``) and
    ``nbytes`` (the bytes the work moved, where a metric reads them).
    The registry is shared by every thread (the prefetch loader packs on
    a worker thread); the nesting is each thread's own.

    While a ``torch.profiler`` records, the span is also a
    ``record_function`` range of the same name; with no profiler none is
    entered, since entering one costs about ten microseconds even
    unprofiled.  The bytes stay in the registry: a range's args do not
    reach the profiler's Chrome trace.

    No span goes inside code that a CUDA-graph capture runs: such host
    code runs once, at capture, and never at replay."""

    __slots__ = ("name", "nbytes", "_t0", "_child_ns", "_epoch", "_range")

    def __init__(self, name: str, nbytes: int = 0):
        self.name = name
        self.nbytes = nbytes

    def __enter__(self) -> "span":
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(self)
        self._epoch = _epoch
        self._child_ns = 0
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        dt = _clock() - self._t0
        stack = _open.stack
        if stack[-1] is self:
            stack.pop()
        else:       # closed out of order (a halo waited for late)
            stack.remove(self)
        if stack:
            stack[-1]._child_ns += dt
        key = (self.name, self._epoch)
        with _totals_lock:
            row = _totals.get(key)
            if row is None:
                row = _totals[key] = [0, 0, 0, 0]
            row[0] += 1
            row[1] += dt
            row[2] += dt - self._child_ns
            row[3] += self.nbytes
        if self._range is not None:
            self._range.__exit__(None, None, None)


def span_totals() -> dict[tuple[str, int | None], dict[str, int]]:
    """A snapshot of the registry: {(name, epoch): {"calls", "total_ns",
    "self_ns", "bytes"}}, ``epoch`` the fit epoch the spans started in
    (None outside a fit: set-up, clustering)."""
    with _totals_lock:
        return {k: dict(zip(("calls", "total_ns", "self_ns", "bytes"), v))
                for k, v in _totals.items()}


def reset_spans() -> None:
    """Empty the registry, the counters' too."""
    with _totals_lock:
        _totals.clear()
        _counters.clear()


# The counters: (name, epoch) -> total.
_counters: dict[tuple[str, int | None], int] = {}


def count(name: str, value: int) -> None:
    """Add ``value`` to counter ``name`` under the fit epoch the call is
    in (:func:`set_epoch`).  Host arithmetic alone: call it with numbers
    the host holds, outside any captured step."""
    key = (name, _epoch)
    with _totals_lock:
        _counters[key] = _counters.get(key, 0) + int(value)


def counter_totals() -> dict[tuple[str, int | None], int]:
    """A snapshot of the counters: {(name, epoch): total}."""
    with _totals_lock:
        return dict(_counters)
