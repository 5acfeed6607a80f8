"""The measured window, held by a logger of the benchmark's own.

The fit calls ``log_train`` once an epoch, after the epoch's outputs came
back to the host (each epoch ends in a readback, so the card is done with
it), and ``log_eval`` after each eval pass.  The window opens at the end
of the last warm-up epoch and closes at the first end of an epoch at least
``seconds`` later that lies a whole number of eval periods after the
opening: so the window holds whole periods, each of ``eval_period`` train
epochs and one eval of val and test, and its work does not depend on where
an eval falls.  Then, with a trace asked for, one more epoch runs
untraced and the profiler covers the next ``trace_epochs`` train epochs
from that epoch's end, with the evals that the cadence puts there (at
``eval_period`` 1, each of these epochs' eval but the last, and the
untraced epoch's).  The fit is ended by :class:`StopFit`, raised from
``log_train``.
"""

from __future__ import annotations

import time

import torch

from graph_hscn_tpu_torch.utils.logger import Logger


class StopFit(Exception):
    """Ends the fit at an epoch's end; the fit fences its checkpointer on
    any exception."""


class Window:
    def __init__(self, seconds: float, warmup_epochs: int, period: int,
                 trace_epochs: int = 0, sync=None,
                 stop_after: int | None = None, agree=None):
        """``agree``: on several ranks, rank 0's decision to close the
        window, on every rank (each calls it at the same epochs)."""
        self.seconds = seconds
        self.agree = agree or (lambda flag: flag)
        self.stop_after = stop_after
        self.warmup = warmup_epochs
        self.period = period
        self.trace_epochs = trace_epochs
        self.sync = sync or (lambda: None)
        self.t_open = self.t_close = None
        self.open_epoch = self.close_epoch = None
        self.profiler = None
        self.trace_start_epoch = None
        self.t_trace = None
        self.listeners = []      # called as f(epoch, loss) at every end
        self.on_open = []        # called once, as the window opens
        self.on_trace = []       # called as f("start") and f("stop")

    @property
    def is_open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    @property
    def epochs(self) -> int:
        return self.close_epoch - self.open_epoch

    @property
    def wall_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def tracing(self) -> bool:
        return self.profiler is not None

    def epoch_end(self, epoch: int, loss: float) -> None:
        now = time.perf_counter()
        for f in self.listeners:
            f(epoch, loss)
        if epoch == self.stop_after:
            raise StopFit
        if self.t_open is None:
            if epoch == self.warmup - 1:
                for f in self.on_open:
                    f()
                self.open_epoch, self.t_open = epoch, time.perf_counter()
            return
        if self.t_close is None:
            if ((epoch - self.open_epoch) % self.period == 0
                    and self.agree(now - self.t_open >= self.seconds)):
                self.close_epoch, self.t_close = epoch, now
                if not self.trace_epochs:
                    raise StopFit
            return
        if self.profiler is None:
            if epoch == self.close_epoch + 1:
                self.sync()
                for f in self.on_trace:
                    f("start")
                self.profiler = _start_profiler()
                self.trace_start_epoch = epoch
                self.t_trace = time.perf_counter()
            return
        if epoch == self.trace_start_epoch + self.trace_epochs:
            self.sync()
            self.t_trace = time.perf_counter() - self.t_trace
            self.profiler.stop()
            for f in self.on_trace:
                f("stop")
            raise StopFit

    @staticmethod
    def marker(name: str):
        """A host span of the benchmark's own, in the trace."""
        return torch.profiler.record_function(name)


def _start_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


class BenchLogger(Logger):
    """The port's logger, silent, whose epoch and eval lines drive the
    window."""

    def __init__(self, window: Window, metric_name: str):
        super().__init__(metric_name=metric_name, quiet=True)
        self.window = window

    def log_train(self, epoch, loss, metric_val, start_time,
                  num_edges=None) -> None:
        if self.window.tracing:
            with Window.marker("epoch_end"):
                pass
        self.window.epoch_end(epoch, loss)

    def log_eval(self, loss, metric_val, split) -> None:
        pass
