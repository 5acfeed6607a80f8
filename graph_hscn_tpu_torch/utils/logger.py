"""Structured logger: stdout + file, epoch timing.

The counterpart of ``graph_hscn_tpu/utils/logger.py`` (the reference's
CustomLogger, logger.py:7-45) without wandb: with ``use_wandb`` and no
wandb installed it warns once and goes on, as the JAX logger does; with
wandb installed it raises, since the port does not log to it.
"""

from __future__ import annotations

import importlib.util
import logging
import sys
import time
from pathlib import Path


class Logger:
    def __init__(self, log_file: str | Path | None = None,
                 metric_name: str = "metric", use_wandb: bool = False,
                 quiet: bool = False):
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
        if use_wandb:
            if importlib.util.find_spec("wandb") is not None:
                self.finish()
                raise NotImplementedError(
                    "training.use_wandb with wandb installed "
                    "(utils/logger.py): ROADMAP queue A, item 12")
            self.logger.warning("wandb unavailable (not installed); "
                                "continuing without it.")

    def info(self, msg: str) -> None:
        self.logger.info(msg)

    def log_train(self, epoch: int, loss: float, metric_val: float,
                  start_time: float) -> None:
        dur = time.time() - start_time
        self.logger.info(
            f"Epoch: {epoch} -- Loss: {loss:.4f}, "
            f"{self.metric_name}: {metric_val:.4f}, "
            f"Duration: {dur:.4f} seconds")

    def log_eval(self, loss: float, metric_val: float, split: str) -> None:
        self.logger.info(
            f"{split} -- Loss: {loss:.4f}, {self.metric_name}: "
            f"{metric_val:.4f}")

    def finish(self) -> None:
        """Detach and close the handlers (the log file among them)."""
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
