"""Training + evaluation loops: the counterpart of
``graph_hscn_tpu/train/loop.py`` (the reference's train/train.py:54-214):
the host path ``fit`` and the device-resident path ``fit_device``.

- a train step is ``model.train()``, forward, ``criterion``, ``backward``,
  optimizer step; an eval step runs the forward under ``torch.no_grad()``;
- losses and predictions stay on the device through the epoch and come to
  the host once at its end for the metric (the reference syncs every batch
  via ``loss.item()``, train.py:85);
- eval cadence, early stopping (patience counted in eval periods, quirk #13
  preserved intentionally: it matches the reference's semantics), min_delta
  on val loss — all identical to reference train.py:164-214;
- with a ``Checkpointer`` (train/checkpoint.py) a fit resumes from its
  latest snapshot and saves best and latest ones, as the JAX fit does;
  :func:`evaluate_checkpoint` scores a snapshot without training.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from graph_hscn_tpu_torch.data.structures import GraphBatch
from graph_hscn_tpu_torch.train.device_data import (DeviceDataset,
                                                    epoch_permutation,
                                                    make_epoch_fn,
                                                    resolve_capture)
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
    # The HSCN pipeline's clustering epochs' mean losses.
    cluster_losses: list = dataclasses.field(default_factory=list)
    # Replays of the captured train and eval steps (the device route on
    # the card): each epoch's rows but a fit's first train and eval row.
    replays: dict = dataclasses.field(default_factory=dict)
    # The edge-partitioned fit's plan of each split (parallel/sharded_gcn.py:
    # rows, block rows, edges, halo width, host seconds).
    partition: dict = dataclasses.field(default_factory=dict)


def _maybe_resume(model, opt, generator, checkpointer, device,
                  logger) -> tuple[int, float]:
    """Resume from the latest snapshot if there is one (the JAX
    ``_maybe_resume``): the model, the optimizer wrapper and the dropout
    generator take its state.  Returns (the epoch to start at, the best
    val loss so far), the latter from the best snapshot's sidecar so that a
    resumed run cannot clobber a better 'best' with a worse one.

    It runs after ``_setup`` and before the fit's first step, so before the
    device route captures its steps: the optimizer's state tensors and the
    generator's state are in place when the graphs bind them."""
    if checkpointer is None or not checkpointer.has("latest"):
        return 0, float("inf")
    state, meta = checkpointer.restore("latest", device)
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    generator.set_state(state["generator"].cpu())
    start_epoch = int(meta.get("epoch", -1)) + 1
    best_loss = float("inf")
    if checkpointer.has("best"):
        best_loss = float(checkpointer.meta("best").get("val_loss",
                                                        float("inf")))
    logger.info(f"Resumed from latest checkpoint (epoch {start_epoch}, "
                f"{int(state['step'])} train steps, best val loss "
                f"{best_loss:.4f}).")
    return start_epoch, best_loss


def snapshot_state(model, opt, generator) -> dict:
    """What a checkpoint holds: the model's ``state_dict``, the optimizer
    wrapper's, the dropout generator's state and the count of train steps
    (mini-batches) taken."""
    return {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "generator": generator.get_state(), "step": opt.minibatches}


def run_fit_loop(training_cfg, logger, train_epoch, evaluate,
                 checkpointer=None, get_state=None, start_epoch: int = 0,
                 best_loss: float = float("inf")) -> tuple:
    """The epoch loop: eval cadence (is_eval_epoch — reference
    train/utils.py:1-6), early stopping on val-loss plateau (reference
    train.py:198-214), best/latest checkpoints and the history record.

    train_epoch(epoch) -> (train_loss, train_perf)
    evaluate(split)    -> (loss, perf) for split in ("val", "test")
    get_state()        -> the snapshot a ``checkpointer`` saves.
    Returns (best_val_loss, history, stopped_early, epochs_run).
    """
    try:
        out = _fit_loop_body(training_cfg, logger, train_epoch, evaluate,
                             checkpointer, get_state, start_epoch, best_loss)
    except BaseException:
        # Fence an in-flight write even when an epoch raises, so that no
        # snapshot is left without its sidecar; the epoch's exception
        # propagates, a write error beside it is secondary.
        if checkpointer is not None:
            try:
                checkpointer.wait()
            except Exception:
                pass
        raise
    if checkpointer is not None:
        checkpointer.wait()   # land the last async write
    return out


def _fit_loop_body(training_cfg, logger, train_epoch, evaluate,
                   checkpointer, get_state, start_epoch: int,
                   best_loss: float) -> tuple:
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
                        if checkpointer is not None:
                            checkpointer.save_best(get_state(), epoch,
                                                   ev_loss)
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
            if (checkpointer is not None and training_cfg.checkpoint_every
                    and (epoch // training_cfg.eval_period)
                    % training_cfg.checkpoint_every == 0):
                checkpointer.save_latest(get_state(), epoch)
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

    def train_step(batch: GraphBatch, applies: bool | None = None):
        """``applies``: whether the optimizer updates the weights or only
        accumulates (``batch_accumulation``); None leaves it to the
        optimizer's count of mini-batches."""
        model.train()
        loss, score, true, mask = loss_and_score(batch, generator)
        opt.zero_grad()
        loss.backward()
        opt.step(applies)
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
        step_timing: bool = False, checkpointer=None) -> FitResult:
    """Full training run with eval cadence + early stopping (mirrors
    reference train.py:147-214).  ``model`` lives on ``device``; each numpy
    batch is moved there as it is used.

    ``train_batches_fn(epoch)`` must yield the epoch's training batches, so
    the packer can reshuffle per epoch (the reference's
    DataLoader(shuffle=True), loader.py:48-60).  ``step_timing`` ends every
    train step in a device sync and records its wall time.  With a
    ``checkpointer`` the fit resumes from its latest snapshot, if any, and
    saves best and latest snapshots (:func:`run_fit_loop`).
    """
    device = torch.device(device)
    total_steps = None
    if optim_cfg.schedule.lower() != "constant":
        # The schedule's horizon: one counting pass over the packer (host
        # side, no device work), as the JAX fit does.
        n_batches = sum(1 for _ in train_batches_fn(0))
        total_steps = training_cfg.epochs * max(n_batches, 1)
    opt, dropout_gen, runner = _setup(model, optim_cfg, training_cfg, device,
                                      step_timing, total_steps)
    start_epoch, best_loss = _maybe_resume(model, opt, dropout_gen,
                                           checkpointer, device, logger)
    train_step, eval_step = make_train_step(
        model, opt, training_cfg.loss_fn, node_level=node_level,
        compat_sigmoid_score=compat_sigmoid_score, generator=dropout_gen)
    eval_sets = {"val": val_batches, "test": test_batches}

    def move(batch: GraphBatch) -> GraphBatch:
        return batch.to(device)

    best, history, stopped, epochs_run = run_fit_loop(
        training_cfg, logger,
        lambda epoch: runner.run(train_batches_fn(epoch), move, train_step,
                                 "train"),
        lambda split: runner.run(eval_sets[split], move, eval_step, "eval"),
        checkpointer, lambda: snapshot_state(model, opt, dropout_gen),
        start_epoch, best_loss)
    return runner.result(model, best, history, stopped, epochs_run)


def _setup(model, optim_cfg, training_cfg, device: torch.device,
           step_timing: bool, total_steps: int | None,
           capturable: bool = False):
    """The optimizer, the dropout generator and the epoch runner of a fit.
    ``total_steps``: the LR schedule's horizon in train steps (None for
    the constant schedule).  Dropout draws its bits from one generator on
    the device, seeded with ``training.seed`` and advanced step by step
    (the counterpart of the JAX ``fold_in(state.rng, state.step)``)."""
    opt = build_optimizer(model.parameters(), optim_cfg.optim_type,
                          optim_cfg.lr, optim_cfg.weight_decay,
                          optim_cfg.batch_accumulation,
                          optim_cfg.clip_grad_norm,
                          schedule=optim_cfg.schedule,
                          warmup_steps=optim_cfg.warmup_steps,
                          total_steps=total_steps,
                          capturable=capturable)
    dropout_gen = torch.Generator(device=device)
    dropout_gen.manual_seed(training_cfg.seed)
    runner = _StepRunner(METRICS[training_cfg.metric], device, step_timing)
    return opt, dropout_gen, runner


class _StepRunner:
    """Runs an epoch's steps, counts them, times the train steps when asked
    (each then ends in a device sync; the time covers making the step's
    batch on the device and the step), and turns the epoch's outputs into
    (mean loss, metric) with one readback."""

    def __init__(self, metric_fn, device: torch.device, step_timing: bool):
        self.metric_fn = metric_fn
        self.device = device
        self.step_timing = step_timing
        self.counts = {"train": 0, "eval": 0}
        self.step_seconds: list[float] = []
        self.replays = {"train": 0, "eval": 0}

    def run(self, items: Iterable, prepare: Callable, step, kind: str):
        """``prepare(item)`` makes the step's batch on the device."""
        outs = []
        for item in items:
            t0 = time.perf_counter()
            outs.append(step(prepare(item)))
            self.counts[kind] += 1
            if self.step_timing and kind == "train":
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.step_seconds.append(time.perf_counter() - t0)
        losses, scores, trues, masks = zip(*outs)
        return self.collect(torch.stack(losses), torch.cat(scores),
                            torch.cat(trues), torch.cat(masks))

    def run_rows(self, epoch_fn, perm: np.ndarray, kind: str):
        """An epoch of the device route: ``epoch_fn`` (a
        ``device_data.RowSteps``) over the rows of ``perm``."""
        timed = self.step_timing and kind == "train"
        outs = epoch_fn(perm, self.step_seconds if timed else None)
        self.counts[kind] += len(perm)
        self.replays[kind] = epoch_fn.replays
        return self.collect(*outs)

    def collect(self, losses, scores, trues, masks):
        """(mean loss, metric) of an epoch's outputs: losses [R], scores
        and trues [..., C], masks [...] on the device (the JAX
        ``_collect``)."""
        y_pred = scores.reshape(-1, scores.shape[-1]).cpu().numpy()
        y_true = trues.reshape(-1, trues.shape[-1]).cpu().numpy()
        m = masks.reshape(-1).cpu().numpy()
        loss = float(np.mean(losses.cpu().numpy()))
        return loss, self.metric_fn(y_true[m], y_pred[m])

    def result(self, model, best, history, stopped, epochs_run) -> FitResult:
        return FitResult(model=model, best_val_loss=best, history=history,
                         stopped_early=stopped, epochs_run=epochs_run,
                         num_train_steps=self.counts["train"],
                         num_eval_batches=self.counts["eval"],
                         step_seconds=self.step_seconds,
                         replays=dict(self.replays))


def fit_device(model: torch.nn.Module, graphs_train, graphs_val, graphs_test,
               batch_size: int, optim_cfg, training_cfg, logger,
               device: torch.device | str, node_level: bool = False,
               compat_sigmoid_score: bool = False, slot: int | None = None,
               step_timing: bool = False, checkpointer=None) -> FitResult:
    """Device-resident training (the JAX ``fit_device``): the whole dataset
    lives on ``device``, batches are assembled there from index rows
    (train/device_data.py), and an epoch's host traffic is its [NB, B]
    permutation plus the metric readback.  Same eval cadence and early
    stopping as :func:`fit`."""
    splits = {"train": list(graphs_train), "val": list(graphs_val),
              "test": list(graphs_test)}
    all_graphs = splits["train"] + splits["val"] + splits["test"]
    ds = DeviceDataset.build(all_graphs, slot=slot, device=device)
    n_tr, n_va = len(splits["train"]), len(splits["val"])
    split_ids = {
        "train": np.arange(n_tr),
        "val": np.arange(n_tr, n_tr + n_va),
        "test": np.arange(n_tr + n_va, len(all_graphs)),
    }
    return fit_on_device_dataset(
        model, ds, split_ids, batch_size, optim_cfg, training_cfg, logger,
        device, node_level=node_level,
        compat_sigmoid_score=compat_sigmoid_score, step_timing=step_timing,
        checkpointer=checkpointer)


def fit_on_device_dataset(model: torch.nn.Module, ds, split_ids: dict,
                          batch_size: int, optim_cfg, training_cfg, logger,
                          device: torch.device | str,
                          node_level: bool = False,
                          compat_sigmoid_score: bool = False,
                          step_timing: bool = False,
                          capture: bool | None = None,
                          checkpointer=None) -> FitResult:
    """:func:`fit_device` on a prebuilt DeviceDataset.

    Each epoch runs through :func:`device_data.make_epoch_fn`, as the JAX
    package's through its one ``lax.scan`` program: the epoch's [NB, B]
    permutation is copied to the device once, every row is one step (on
    the card a replay of the step captured once as a CUDA graph), and the
    outputs come back in one readback at the end.  ``capture``: None
    captures on a CUDA device; False runs the same steps (the same
    capturable optimizer) eagerly row by row, the yardstick that the card
    tests and ``chip_smoke.py`` hold the captured fit against (no config
    sets it).  A capture or replay that fails raises.  ``checkpointer``
    as in :func:`fit`; the restore comes before the first row, so before
    the steps are captured.
    """
    device = torch.device(device)
    capture = resolve_capture(capture, device)
    counts = {k: len(v) for k, v in split_ids.items()}
    total_steps = training_cfg.epochs * -(-counts["train"] // batch_size)
    # On the card the optimizer is capturable whether or not the steps are
    # captured, so that the eager yardstick does the same arithmetic.
    opt, dropout_gen, runner = _setup(model, optim_cfg, training_cfg, device,
                                      step_timing, total_steps,
                                      capturable=device.type == "cuda")
    start_epoch, best_loss = _maybe_resume(model, opt, dropout_gen,
                                           checkpointer, device, logger)

    def split_perm(name, seed, shuffle) -> np.ndarray:
        p = epoch_permutation(counts[name], batch_size, seed, shuffle)
        ids = np.asarray(split_ids[name])
        return np.where(p >= 0, ids[np.clip(p, 0, None)], -1).astype(np.int32)

    eval_perms = {"val": split_perm("val", 0, False),
                  "test": split_perm("test", 0, False)}
    max_rows = max(-(-n // batch_size) for n in counts.values())
    train_epoch, eval_epoch = make_epoch_fn(
        model, opt, ds, batch_size, max_rows, training_cfg.loss_fn,
        node_level=node_level, compat_sigmoid_score=compat_sigmoid_score,
        generator=dropout_gen, capture=capture)

    best, history, stopped, epochs_run = run_fit_loop(
        training_cfg, logger,
        lambda epoch: runner.run_rows(
            train_epoch, split_perm("train", training_cfg.seed + epoch, True),
            "train"),
        lambda split: runner.run_rows(eval_epoch, eval_perms[split], "eval"),
        checkpointer, lambda: snapshot_state(model, opt, dropout_gen),
        start_epoch, best_loss)
    return runner.result(model, best, history, stopped, epochs_run)


def evaluate_checkpoint(model: torch.nn.Module, batches_by_split: dict,
                        training_cfg, checkpointer, device,
                        which: str = "best", node_level: bool = False,
                        compat_sigmoid_score: bool = False,
                        predictions_sink: dict | None = None
                        ) -> tuple[dict, dict]:
    """Restore snapshot ``which`` into ``model`` (on ``device``) and score
    it on each split's host batches: eval-only mode, no training (the JAX
    ``evaluate_checkpoint``).  Returns ({split: {"loss", metric}}, the
    snapshot's metadata).  With ``predictions_sink`` (a dict) it also
    collects each split's scores and targets over the real rows, as numpy:
    the export behind ``main.py --eval --predict``.  The model alone is
    restored: eval needs no optimizer state."""
    device = torch.device(device)
    if not checkpointer.has(which):
        raise FileNotFoundError(
            f"no '{which}' snapshot in {checkpointer.dir}")
    state, meta = checkpointer.restore(which, device)
    model.load_state_dict(state["model"])
    _, eval_step = make_train_step(
        model, None, training_cfg.loss_fn, node_level=node_level,
        compat_sigmoid_score=compat_sigmoid_score)
    runner = _StepRunner(METRICS[training_cfg.metric], device, False)
    results = {}
    for split, batches in batches_by_split.items():
        losses, scores, trues, masks = zip(*(eval_step(b.to(device))
                                             for b in batches))
        scores, trues, masks = (torch.cat(t) for t in (scores, trues, masks))
        loss, perf = runner.collect(torch.stack(losses), scores, trues,
                                    masks)
        results[split] = {"loss": loss, training_cfg.metric: perf}
        if predictions_sink is not None:
            m = masks.reshape(-1).cpu().numpy()
            predictions_sink[split] = {
                name: t.reshape(-1, t.shape[-1]).cpu().numpy()[m]
                for name, t in (("scores", scores), ("targets", trues))}
    return results, meta
