"""Training + evaluation loops: the counterpart of the host path of
``graph_hscn_tpu/train/loop.py`` (the reference's train/train.py:54-214).

- a train step is ``model.train()``, forward, ``criterion``, ``backward``,
  optimizer step; an eval step runs the forward under ``torch.no_grad()``;
- losses and predictions stay on the device through the epoch and come to
  the host once at its end for the metric (the reference syncs every batch
  via ``loss.item()``, train.py:85);
- eval cadence, early stopping (patience counted in eval periods, quirk #13
  preserved intentionally: it matches the reference's semantics), min_delta
  on val loss — all identical to reference train.py:164-214.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.train.loss import criterion
from graph_hscn_tpu_torch.train.metrics import METRICS
from graph_hscn_tpu_torch.train.optimizers import build_optimizer


def is_eval_epoch(epoch: int, max_epochs: int, eval_period: int) -> bool:
    """Same cadence as reference train/utils.py:1-6."""
    return ((epoch + 1) % eval_period == 0 or epoch == 0
            or (epoch + 1) == max_epochs)


@dataclasses.dataclass
class FitResult:
    model: torch.nn.Module
    best_val_loss: float
    history: list
    stopped_early: bool
    epochs_run: int
    num_train_steps: int = 0
    num_eval_batches: int = 0
    # Wall seconds of each train step, each ending in a device sync; filled
    # only when fit(step_timing=True).
    step_seconds: list = dataclasses.field(default_factory=list)


def run_fit_loop(training_cfg, logger, train_epoch, evaluate,
                 start_epoch: int = 0,
                 best_loss: float = float("inf")) -> tuple:
    """The epoch loop: eval cadence (is_eval_epoch — reference
    train/utils.py:1-6), early stopping on val-loss plateau (reference
    train.py:198-214) and the history record.

    train_epoch(epoch) -> (train_loss, train_perf)
    evaluate(split)    -> (loss, perf) for split in ("val", "test")
    Returns (best_val_loss, history, stopped_early, epochs_run).
    """
    num_improvement = 0
    history = []
    stopped = False
    epochs_run = start_epoch
    for epoch in range(start_epoch, training_cfg.epochs):
        t0 = time.time()
        train_loss, train_perf = train_epoch(epoch)
        logger.log_train(epoch, train_loss, train_perf, t0)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "train_perf": train_perf})
        epochs_run = epoch + 1

        if is_eval_epoch(epoch, training_cfg.epochs,
                         training_cfg.eval_period):
            for split, label in (("val", "Validation"), ("test", "Test")):
                ev_loss, ev_perf = evaluate(split)
                logger.log_eval(ev_loss, ev_perf, label)
                history[-1][f"{label.lower()}_loss"] = ev_loss
                history[-1][f"{label.lower()}_perf"] = ev_perf
                if split == "val":
                    if ev_loss < best_loss - training_cfg.min_delta:
                        best_loss = ev_loss
                        num_improvement = 0
                    else:
                        num_improvement += 1
                    if (num_improvement >= training_cfg.patience
                            and epoch != training_cfg.epochs - 1):
                        logger.info(
                            f"No improvement by {training_cfg.min_delta} "
                            f"for more than {training_cfg.patience} eval "
                            "periods, stopping early.")
                        stopped = True
            if stopped:
                break
    return best_loss, history, stopped, epochs_run


def make_train_step(model: torch.nn.Module, opt, loss_fn: str,
                    node_level: bool = False,
                    compat_sigmoid_score: bool = False,
                    generator: torch.Generator | None = None):
    """The train and eval steps (the counterpart of the JAX
    ``make_train_step``).  Both take a batch on the model's device and
    return (loss, score, true, mask), the loss being the one before the
    update; dropout draws its bits from ``generator``."""

    def loss_and_score(batch: GraphBatch, gen):
        pred = model(batch, generator=gen)
        true, mask = ((batch.node_y, batch.node_mask) if node_level
                      else (batch.y, batch.graph_mask))
        loss, score = criterion(loss_fn, pred, true, mask,
                                compat_sigmoid_score=compat_sigmoid_score)
        return loss, score, true, mask

    def train_step(batch: GraphBatch):
        model.train()
        loss, score, true, mask = loss_and_score(batch, generator)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach(), score.detach(), true, mask

    @torch.no_grad()
    def eval_step(batch: GraphBatch):
        model.eval()
        return loss_and_score(batch, None)

    return train_step, eval_step


def fit(model: torch.nn.Module,
        train_batches_fn: Callable[[int], Iterable[GraphBatch]],
        val_batches: list[GraphBatch], test_batches: list[GraphBatch],
        optim_cfg, training_cfg, logger, device: torch.device | str,
        node_level: bool = False, compat_sigmoid_score: bool = False,
        step_timing: bool = False) -> FitResult:
    """Full training run with eval cadence + early stopping (mirrors
    reference train.py:147-214).  ``model`` lives on ``device``; each numpy
    batch is moved there as it is used.

    ``train_batches_fn(epoch)`` must yield the epoch's training batches, so
    the packer can reshuffle per epoch (the reference's
    DataLoader(shuffle=True), loader.py:48-60).  ``step_timing`` ends every
    train step in a device sync and records its wall time.
    """
    device = torch.device(device)
    opt = build_optimizer(model.parameters(), optim_cfg.optim_type,
                          optim_cfg.lr, optim_cfg.weight_decay,
                          optim_cfg.batch_accumulation,
                          optim_cfg.clip_grad_norm,
                          schedule=optim_cfg.schedule,
                          warmup_steps=optim_cfg.warmup_steps)
    metric_fn = METRICS[training_cfg.metric]
    # Dropout bits: one generator on the device, seeded from the config.
    dropout_gen = torch.Generator(device=device)
    dropout_gen.manual_seed(training_cfg.seed)
    train_step, eval_step = make_train_step(
        model, opt, training_cfg.loss_fn, node_level=node_level,
        compat_sigmoid_score=compat_sigmoid_score, generator=dropout_gen)
    counts = {"train": 0, "eval": 0}
    step_seconds: list[float] = []

    def run(batches, step, kind):
        outs = []
        for batch in batches:
            t0 = time.perf_counter()
            outs.append(step(batch.to(device)))
            counts[kind] += 1
            if step_timing and kind == "train":
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_seconds.append(time.perf_counter() - t0)
        losses, scores, trues, masks = zip(*outs)
        y_pred = torch.cat(scores).cpu().numpy()
        y_true = torch.cat(trues).cpu().numpy()
        m = torch.cat(masks).cpu().numpy()
        loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        return loss, metric_fn(y_true[m], y_pred[m])

    eval_sets = {"val": val_batches, "test": test_batches}
    best, history, stopped, epochs_run = run_fit_loop(
        training_cfg, logger,
        lambda epoch: run(train_batches_fn(epoch), train_step, "train"),
        lambda split: run(eval_sets[split], eval_step, "eval"))
    return FitResult(model=model, best_val_loss=best, history=history,
                     stopped_early=stopped, epochs_run=epochs_run,
                     num_train_steps=counts["train"],
                     num_eval_batches=counts["eval"],
                     step_seconds=step_seconds)
