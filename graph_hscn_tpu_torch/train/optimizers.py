"""Optimizers: the counterpart of ``graph_hscn_tpu/train/optimizers.py``
(the reference's OPTIM_DICT, config/config.py:24-28; train.py:155-159).

The JAX package builds optax chains with torch's semantics; here they are
torch's own optimizers, with the same rules:
- AdamW decays weights decoupled from the gradient, every parameter
  (biases included), as optax.adamw does: both take ``lr_t * wd * p`` off
  the weights at step t, with the scheduled ``lr_t``.
- Adam's ``weight_decay`` is L2 added to the gradient before the moments.
- Adagrad is optax's ``scale_by_rss(initial_accumulator_value=0,
  eps=1e-10)`` (:class:`RssAdagrad`): L2 decay added to the gradient, then
  ``g * where(acc > 0, rsqrt(acc + eps), 0)``.  torch's own Adagrad takes
  ``g / (sqrt(acc) + eps)``, which steps near-zero gradients differently.
- Clipping is a global norm of 1.0, applied before the update
  (optax.clip_by_global_norm).
- LR schedules (:func:`learning_rate_schedule`) are optax's, evaluated at
  the count of updates already applied: with warmup the first update has
  lr 0.  (torch's ``state["step"]`` counts the update in progress; the
  schedule reads :attr:`Optimizer.updates`, which is that step minus 1.)
- ``batch_accumulation`` k > 1 is ``optax.MultiSteps``: the gradients'
  running mean over k mini-batches, then clip and the core update once;
  the schedule's count advances once an applied update, over a horizon of
  ``ceil(total_steps / k)`` updates.  The accumulator is optimizer state:
  it carries across epochs.

The device-resident route takes ``capturable=True`` on the card, where its
steps are captured as CUDA graphs (``train/capture.py``): Adam and AdamW
then keep their step count on the card, and a schedule's lr is a 0-d
tensor on the card that the step itself writes from the update count on
the card, so a replayed step reads the lr of its own update.
:meth:`Optimizer.state_dict` carries all of it into a checkpoint.
:class:`RssAdagrad`, the zero fill of :meth:`Optimizer.step`, the
accumulation and :func:`clip_grad_norm` are tensor arithmetic with no
branch on a tensor's value, so they capture as they are; whether a step
accumulates or applies is counted on the host
(:meth:`Optimizer.next_applies`), one captured graph for each.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule(init, end, steps)`` on a float32 count."""
    if steps <= 0:
        return lambda count: torch.full_like(count, init)
    return lambda count: ((init - end) * (1 - count.clamp(0, steps) / steps)
                          + end)


def _cosine(peak: float, steps: int) -> Schedule:
    """``optax.cosine_decay_schedule(peak, steps)`` with alpha 0 and
    exponent 1, as the JAX package builds it."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got "
                         f"{steps}")
    steps = float(steps)
    return lambda count: peak * (
        0.5 * (1 + torch.cos(math.pi * torch.clamp(count, max=steps)
                             / steps)))


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules([first, then], [boundary])``."""
    return lambda count: torch.where(count < boundary, first(count),
                                     then(count - boundary))


def learning_rate_schedule(lr: float, schedule: str = "constant",
                           warmup_steps: int = 0,
                           total_steps: int | None = None
                           ) -> float | Schedule:
    """Peak LR + schedule name -> the float ``lr``, or a function of the
    count of applied updates (a float32 tensor) -> the lr, a float32
    tensor on the count's device, computed by tensor arithmetic alone.

    The JAX package's schedules (optimizers.py:18-48): ``constant`` (with
    optional linear warmup 0 -> lr), ``cosine``
    (``optax.warmup_cosine_decay_schedule``: 0 -> lr over the warmup, then
    cosine decay to 0 at ``max(total_steps, warmup_steps + 1)``) and
    ``linear`` (warmup, then linear decay to 0 over the rest).
    ``total_steps``, the horizon in applied updates, is required for the
    last two."""
    s = (schedule or "constant").lower()
    if s == "constant":
        return _linear(0.0, lr, warmup_steps) if warmup_steps > 0 else lr
    if total_steps is None:
        raise ValueError(f"schedule {s!r} needs total_steps "
                         "(epochs x steps-per-epoch)")
    if s == "cosine":
        decay_steps = max(total_steps, warmup_steps + 1)
        return _join(_linear(0.0, lr, warmup_steps),
                     _cosine(lr, decay_steps - warmup_steps), warmup_steps)
    if s == "linear":
        decay = _linear(lr, 0.0, max(total_steps - warmup_steps, 1))
        if warmup_steps > 0:
            return _join(_linear(0.0, lr, warmup_steps), decay,
                         warmup_steps)
        return decay
    raise ValueError(f"Unknown LR schedule {schedule!r}")


def clip_grad_norm(params: Iterable[torch.nn.Parameter],
                   max_norm: float = 1.0) -> torch.Tensor:
    """Scale the gradients in place so their global norm is at most
    ``max_norm`` (optax.clip_by_global_norm: g * max_norm / norm when the
    norm exceeds it).  Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class RssAdagrad(torch.optim.Optimizer):
    """Adagrad with optax's ``scale_by_rss`` rule, chained as the JAX
    package chains it (optimizers.py:74-79): ``g += weight_decay * p``,
    ``acc += g**2``, ``p -= lr * g * where(acc > 0, rsqrt(acc + eps), 0)``.
    The accumulator starts at 0."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.zeros_like(p)
                acc = state["sum_of_squares"]
                acc.add_(g * g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    0.0)
                p.sub_(group["lr"] * (g * scale))


class Optimizer:
    """A torch optimizer, the optional clip, the LR schedule and gradient
    accumulation: what one optax chain of the JAX package (wrapped in
    ``optax.MultiSteps`` when ``accumulate`` > 1) does in one ``update``.

    ``schedule``: None for a constant lr (a float in the param groups, as
    built), else a function of the applied-update count
    (:func:`learning_rate_schedule`).  ``capturable``: the lr and the
    update count live on the parameters' device as tensors, written in
    place by the step (a captured step reads them there); otherwise the
    count is a CPU tensor and the lr a float set before each update.
    """

    def __init__(self, opt: torch.optim.Optimizer, clip: bool,
                 schedule: Schedule | None = None, accumulate: int = 1,
                 capturable: bool = False):
        self.opt = opt
        self.clip = clip
        self.schedule = schedule
        self.accumulate = accumulate
        self.capturable = capturable
        self.params = [p for g in opt.param_groups for p in g["params"]]
        device = self.params[0].device
        # Updates already applied (optax's inner count), a float32 count
        # that only a schedule reads.
        self.updates = (None if schedule is None else torch.zeros(
            (), device=device if capturable else "cpu"))
        # Mini-batches stepped so far, on the host: whether the next step
        # applies is the host's choice (one captured graph each way).
        self.minibatches = 0
        if accumulate > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]
            # The accumulated mini-batches, on the device: the running
            # mean's divisor, read by a replayed step.
            self.mini = torch.zeros((), device=device)

    def next_applies(self) -> bool:
        """Counts one mini-batch on the host and says whether its step
        updates the weights (else it only accumulates its gradients)."""
        applies = self.minibatches % self.accumulate == self.accumulate - 1
        self.minibatches += 1
        return applies

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self, applies: bool | None = None) -> None:
        """One mini-batch's step.  ``applies``: whether it updates the
        weights; None counts the mini-batch here (:meth:`next_applies`).
        A captured step is given the value of its graph, counted on the
        host by the caller, and changes no host state."""
        if applies is None:
            applies = self.next_applies()
        # optax updates every leaf: a parameter the loss does not reach (the
        # last GatedGCN layer's edge LayerNorm) gets a zero gradient, so its
        # weight decay still applies, where torch would skip it.
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accumulate > 1:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1).
            for p, acc in zip(self.params, self.acc):
                acc.add_((p.grad - acc) / (self.mini + 1))
            if not applies:
                self.mini.add_(1)
                return
            for p, acc in zip(self.params, self.acc):
                p.grad.copy_(acc)
        if self.clip:
            clip_grad_norm(self.params, 1.0)
        if self.schedule is not None:
            lr = self.schedule(self.updates)
            for group in self.opt.param_groups:
                if self.capturable:
                    group["lr"].copy_(lr)
                else:
                    group["lr"] = float(lr)
            self.updates.add_(1)
        self.opt.step()
        if self.accumulate > 1:
            for acc in self.acc:
                acc.zero_()
            self.mini.zero_()

    def state_dict(self) -> dict:
        """What JAX's ``opt_state`` holds: the inner optimizer's state
        (capturable Adam's device ``step`` and tensor lr among it), the
        schedule's update count, the host's mini-batch count and the
        accumulator with its divisor."""
        state = {"inner": self.opt.state_dict(), "updates": self.updates,
                 "minibatches": self.minibatches}
        if self.accumulate > 1:
            state["acc"] = list(self.acc)
            state["mini"] = self.mini
        return state

    def state_tensors(self) -> list[tuple[torch.nn.Parameter, str,
                                          torch.Tensor]]:
        """(parameter, key, tensor) of each tensor of the state kept for
        a parameter that ``runtime.debug_nans`` checks: the inner
        optimizer's moments and the accumulator ("acc").  Not the step
        counts: JAX's are integers, which ``debug_nans`` does not check
        (torch keeps a float one, on the host off the captured route)."""
        out = [(p, key, t) for p in self.params
               for key, t in self.opt.state.get(p, {}).items()
               if torch.is_tensor(t) and key != "step"]
        if self.accumulate > 1:
            out += [(p, "acc", a) for p, a in zip(self.params, self.acc)]
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` into an optimizer that has not
        stepped.  The inner optimizer's ``load_state_dict`` installs new
        state tensors, which a step captured before would not read; the
        counts and the accumulator are copied into the tensors in place."""
        if self.opt.state:
            raise RuntimeError("restore an optimizer before its first step "
                               "(a captured step reads its state tensors "
                               "by address)")
        self.opt.load_state_dict(state["inner"])
        if not self.capturable:
            # torch keeps ``step`` where the load put it; off the capturable
            # path it belongs on the host.
            for s in self.opt.state.values():
                if torch.is_tensor(s.get("step")):
                    s["step"] = s["step"].cpu()
        if self.updates is not None:
            self.updates.copy_(state["updates"])
        self.minibatches = int(state["minibatches"])
        if self.accumulate > 1:
            for acc, saved in zip(self.acc, state["acc"]):
                acc.copy_(saved)
            self.mini.copy_(state["mini"])


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_type: str,
                    lr: float, weight_decay: float,
                    batch_accumulation: int = 1,
                    clip_grad_norm: bool = False,
                    schedule: str = "constant",
                    warmup_steps: int = 0,
                    total_steps: int | None = None,
                    capturable: bool = False) -> Optimizer:
    """The JAX ``build_optimizer``.  ``total_steps``: the schedule's
    horizon in mini-batch steps (epochs x batches an epoch), divided by
    ``batch_accumulation`` (rounding up) into applied updates, as JAX
    does.  ``capturable``: build Adam and AdamW, and the schedule's lr, for
    a step captured as a CUDA graph (their state on the card; the
    parameters must be there)."""
    if batch_accumulation < 1:
        raise ValueError(f"batch_accumulation {batch_accumulation} < 1")
    if batch_accumulation > 1 and total_steps is not None:
        total_steps = -(-total_steps // batch_accumulation)
    rate = learning_rate_schedule(lr, schedule, warmup_steps, total_steps)
    sched = rate if callable(rate) else None
    params = list(params)
    if sched is not None and capturable:
        # A tensor lr the captured step rewrites in place (torch's Adam and
        # AdamW take one when capturable; RssAdagrad multiplies by it).
        lr = torch.tensor(float(lr), device=params[0].device)
    t = optim_type.lower()
    if t == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay,
                                capturable=capturable)
    elif t == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay,
                               capturable=capturable)
    elif t == "adagrad":
        opt = RssAdagrad(params, lr=lr, weight_decay=weight_decay,
                         eps=1e-10)
    else:
        raise ValueError(f"Unknown optimizer {optim_type}")
    return Optimizer(opt, clip_grad_norm, sched, batch_accumulation,
                     capturable)
