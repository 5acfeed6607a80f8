"""Optimizers: the counterpart of ``graph_hscn_tpu/train/optimizers.py``
(the reference's OPTIM_DICT, config/config.py:24-28; train.py:155-159).

The JAX package builds optax chains with torch's semantics; here they are
torch's own optimizers, with the same rules:
- AdamW decays weights decoupled from the gradient, every parameter
  (biases included), as optax.adamw does.
- Adam's ``weight_decay`` is L2 added to the gradient before the moments.
- Adagrad starts its accumulator at 0 and uses eps 1e-10; L2 decay is added
  to the gradient like Adam's.
- Clipping is a global norm of 1.0, applied before the update
  (optax.clip_by_global_norm).
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


class Optimizer:
    """A torch optimizer and the optional clip: what one optax chain of the
    JAX package does in one ``update``."""

    def __init__(self, opt: torch.optim.Optimizer, clip: bool):
        self.opt = opt
        self.clip = clip

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip:
            clip_grad_norm((p for g in self.opt.param_groups
                            for p in g["params"]), 1.0)
        self.opt.step()


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_type: str,
                    lr: float, weight_decay: float,
                    batch_accumulation: int = 1,
                    clip_grad_norm: bool = False,
                    schedule: str = "constant",
                    warmup_steps: int = 0) -> Optimizer:
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
                                weight_decay=weight_decay)
    elif t == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    elif t == "adagrad":
        opt = torch.optim.Adagrad(params, lr=lr, weight_decay=weight_decay,
                                  initial_accumulator_value=0.0, eps=1e-10)
    else:
        raise ValueError(f"Unknown optimizer {optim_type}")
    return Optimizer(opt, clip_grad_norm)
