"""Optimizers: the counterpart of ``graph_hscn_tpu/train/optimizers.py``
(the reference's OPTIM_DICT, config/config.py:24-28; train.py:155-159).

The JAX package builds optax chains with torch's semantics; here they are
torch's own optimizers, with the same rules:
- AdamW decays weights decoupled from the gradient, every parameter
  (biases included), as optax.adamw does.
- Adam's ``weight_decay`` is L2 added to the gradient before the moments.
- Adagrad is optax's ``scale_by_rss(initial_accumulator_value=0,
  eps=1e-10)`` (:class:`RssAdagrad`): L2 decay added to the gradient, then
  ``g * where(acc > 0, rsqrt(acc + eps), 0)``.  torch's own Adagrad takes
  ``g / (sqrt(acc) + eps)``, which steps near-zero gradients differently.
- Clipping is a global norm of 1.0, applied before the update
  (optax.clip_by_global_norm).

The device-resident route takes ``capturable=True`` on the card, where its
steps are captured as CUDA graphs (``train/capture.py``): Adam and AdamW
then keep their step count on the card.
:class:`RssAdagrad`, the zero fill of :meth:`Optimizer.step` and
:func:`clip_grad_norm` are tensor arithmetic with no branch on a tensor's
value, so they capture as they are.
"""

from __future__ import annotations

from typing import Iterable

import torch


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
    """A torch optimizer and the optional clip: what one optax chain of the
    JAX package does in one ``update``."""

    def __init__(self, opt: torch.optim.Optimizer, clip: bool):
        self.opt = opt
        self.clip = clip

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        # optax updates every leaf: a parameter the loss does not reach (the
        # last GatedGCN layer's edge LayerNorm) gets a zero gradient, so its
        # weight decay still applies, where torch would skip it.
        for group in self.opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if self.clip:
            clip_grad_norm((p for g in self.opt.param_groups
                            for p in g["params"]), 1.0)
        self.opt.step()


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_type: str,
                    lr: float, weight_decay: float,
                    batch_accumulation: int = 1,
                    clip_grad_norm: bool = False,
                    schedule: str = "constant",
                    warmup_steps: int = 0,
                    capturable: bool = False) -> Optimizer:
    """``capturable``: build Adam and AdamW for a step captured as a CUDA
    graph (their step count on the card; the parameters must be there)."""
    if batch_accumulation > 1:
        raise NotImplementedError(
            "optim.batch_accumulation > 1: ROADMAP queue A, item 5")
    if (schedule or "constant").lower() != "constant" or warmup_steps > 0:
        raise NotImplementedError(
            "LR schedules and warmup: ROADMAP queue A, item 5")
    params = list(params)
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
    return Optimizer(opt, clip_grad_norm)
