"""Structured logger: stdout + file, epoch timing, optional wandb.

The counterpart of ``graph_hscn_tpu/utils/logger.py`` (the reference's
CustomLogger, logger.py:7-45).  wandb is imported lazily, as in JAX: with
``use_wandb`` the logger calls ``wandb.init(project=...)`` and logs each
epoch's scalars; where wandb is not installed or cannot start, it warns
once and goes on without it.  A ``quiet`` logger (a rank other than 0 of
a process group) logs nothing, to wandb neither: rank 0 alone inits it.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path


class Logger:
    def __init__(self, log_file: str | Path | None = None,
                 metric_name: str = "metric", use_wandb: bool = False,
                 wandb_project: str | None = None, quiet: bool = False):
        """``quiet``: log nothing (a rank other than 0 of a process
        group)."""
        self.logger = logging.getLogger(f"graph_hscn_tpu_torch.{id(self)}")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        self.logger.disabled = quiet
        fmt = logging.Formatter("%(asctime)s %(levelname)s | %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        if log_file is not None:
            Path(log_file).parent.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)
        self.metric_name = {"ap": "AP", "mae": "MAE", "f1": "F1"}.get(
            metric_name, metric_name)
        self._wandb = None
        if use_wandb and not quiet:
            try:
                import wandb
                wandb.init(project=wandb_project or "graph_hscn_tpu")
                self._wandb = wandb
            except Exception as e:  # no wandb installed / no network
                self.logger.warning(f"wandb unavailable ({e}); continuing "
                                    "without it.")

    def info(self, msg: str) -> None:
        self.logger.info(msg)

    def log_train(self, epoch: int, loss: float, metric_val: float,
                  start_time: float, num_edges: int | None = None) -> None:
        """The epoch line; with ``num_edges`` (the edges the epoch's train
        steps went over) it ends in the epoch's edges a second."""
        dur = time.time() - start_time
        extra = ""
        scalars = {"train_loss": loss, "train_perf": metric_val}
        if num_edges:
            eps = num_edges / max(dur, 1e-9)
            extra = f", {eps / 1e6:.2f} M edges/s"
            scalars["edges_per_sec"] = eps
        self.logger.info(
            f"Epoch: {epoch} -- Loss: {loss:.4f}, "
            f"{self.metric_name}: {metric_val:.4f}, "
            f"Duration: {dur:.4f} seconds{extra}")
        self.wandb_log(scalars)

    def log_eval(self, loss: float, metric_val: float, split: str) -> None:
        self.logger.info(
            f"{split} -- Loss: {loss:.4f}, {self.metric_name}: "
            f"{metric_val:.4f}")
        self.wandb_log({f"{split.lower()}_loss": loss,
                        f"{split.lower()}_perf": metric_val})

    def wandb_log(self, scalars: dict) -> None:
        if self._wandb is not None:
            self._wandb.log(scalars)

    def finish(self) -> None:
        """Finish the wandb run, then detach and close the handlers (the
        log file among them)."""
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
