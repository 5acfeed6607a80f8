"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
and the ``breakdown`` read.

The idle share is 1 - (union of device-operation intervals) / slice wall:
the union, not the sum, so that operations overlapping on two streams are
counted once.  (``chip_smoke.py``'s ``report_profile`` sums kernel
durations, which double-counts such overlap.)
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

import torch

# The benchmark's own host spans, labels of the idle gaps.
SPANS = ("batch_next", "epoch_end")


@dataclasses.dataclass
class Trace:
    ops: list            # [(name, start_ns, end_ns)] device operations
    spans: list          # [(name, start_ns, end_ns)] benchmark host spans
    wall_s: float        # the slice's length on the host clock

    @classmethod
    def from_profiler(cls, prof, wall_s: float) -> "Trace":
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        # record_function spans (the optimizer's among them) are mirrored
        # onto the device as annotations under their host names: those are
        # not device work.
        host_names = {e.name() for e in events if e.device_type() != cuda}
        ops, spans = [], []
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            name = e.name()
            if e.device_type() == cuda:
                if name not in host_names:
                    ops.append((name, start, start + dur))
            elif name in SPANS:
                spans.append((name, start, start + dur))
        ops.sort(key=lambda o: o[1])
        return cls(ops, spans, wall_s)

    def busy_s(self) -> float:
        """Length of the union of the device operations' intervals."""
        total, end = 0, None
        for _, s, e in self.ops:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def op_seconds(self, kernel: str) -> tuple[float, int]:
        """Summed device seconds and count of the launches of ``kernel``,
        matched by :func:`kernel_name`."""
        sel = [e - s for n, s, e in self.ops if kernel_name(n) == kernel]
        return sum(sel) * 1e-9, len(sel)

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for n, s, e in self.ops:
            by[n] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v * 1e-9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest gaps between device operations, each labelled
        by what the host was in: ``epoch_end`` if an epoch ended inside it,
        else ``batch_next`` if it lies in the host loop's wait for its next
        batch, else ``train_epoch`` (the fit's own host work)."""
        gaps, end = [], None
        for _, s, e in self.ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, a, b in gaps[:k]:
            mid = (a + b) / 2
            label = "train_epoch"
            if any(n == "epoch_end" and a <= s <= b for n, s, _ in
                   self.spans):
                label = "epoch_end"
            elif any(n == "batch_next" and s <= mid <= e for n, s, e in
                     self.spans):
                label = "batch_next"
            out.append([label, length * 1e-9])
        return out


def kernel_name(name: str) -> str:
    """A device operation's function name without its return type,
    namespaces, template arguments and parameters:
    ``void (anonymous namespace)::csr_spmm_kernel<float, 4, 2, 4>(...)``
    is ``csr_spmm_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name)[0].split("::")[-1].strip()
