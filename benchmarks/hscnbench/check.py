"""The comparison that decides ``correct``: the program's first training
steps and its epoch 0 against the plain reference's, from the same
weights over the same batches in the same order.

The numbers (each against its limit in the workload file's ``limits``):
  batch             the largest difference of the observed steps' inputs
                    (real nodes' features, and a node the program holds
                    that the reference does not, or the other way round,
                    counts as inf); exact, limit 0;
  logits_gap        max|Zp - Zr| / max|Zr| over the real rows of the
                    first step (the forward alone: later steps' logits
                    carry the updates, which the weights' numbers hold);
  grad_gap          the first gradient, by the worst leaf;
  step_change_gap   the weights' change from the start, by the worst leaf,
                    the largest over the observed steps: the eager ones and
                    on a captured route the replays that follow them;
  epoch_loss_gap    |Lp - Lr| / |Lr| of epoch 0's mean train loss;
  epoch_change_gap  the weights' change over epoch 0, by the worst leaf;
and what a configuration adds (``extra_checks`` of its reference).  A
further trained model (the HSCN's SCN) has its own ``grad_gap`` and
``step_change_gap`` under its name (``scn.grad_gap``).

"By the worst leaf": the gap between the program's norm of a leaf and the
reference's, |‖p‖ - ‖r‖|, over the larger of the reference's norm of
that leaf and of the median leaf.  Leaves whose reference gradient is
under a thousandth of the median leaf's (zero to rounding: their weights
move by weight decay alone, or by Adam acting on round-off) are left out
of all three, by that rule and not by name.
"""

from __future__ import annotations

import math

import torch

FROZEN_SHARE = 1e-3


def _median(values):
    vals = sorted(values)
    return vals[len(vals) // 2] if len(vals) % 2 else (
        0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]))


def moving_leaves(ref_grad: dict) -> list:
    norms = {n: float(g.norm()) for n, g in ref_grad.items()}
    med = _median(norms.values())
    return sorted(n for n, v in norms.items() if v >= FROZEN_SHARE * med)


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    rn = {n: float(ref[n].double().norm()) for n in leaves}
    med = _median(rn.values())
    return max(abs(float(prog[n].double().norm()) - rn[n])
               / max(rn[n], med, 1e-30) for n in leaves)


def change(after: dict, before: dict) -> dict:
    return {n: after[n] - before[n] for n in after}


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return math.inf
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def compare_steps(prog: dict, ref: dict, init: dict) -> dict:
    """``prog`` and ``ref``: {first_grad, after_step: [per step]};
    ``init``: the initial weights.  The reference has followed at least
    as many steps as the program's were read."""
    leaves = moving_leaves(ref["first_grad"])
    return {
        "grad_gap": leaf_gap(prog["first_grad"], ref["first_grad"], leaves),
        "step_change_gap": max(
            leaf_gap(change(p, init), change(r, init), leaves)
            for p, r in zip(prog["after_step"], ref["after_step"])),
    }


def compare(prog: dict, ref: dict, init: dict) -> dict:
    """``prog`` and ``ref``: {logits: [per step], first_grad, after_step:
    [per step], after_epoch, epoch_loss}, the program's read by the probe
    (logits of the real rows, in the reference's order); ``init``: the
    initial weights."""
    leaves = moving_leaves(ref["first_grad"])
    nums = compare_steps(prog, ref, init)
    nums["epoch_loss_gap"] = (abs(prog["epoch_loss"] - ref["epoch_loss"])
                              / max(abs(ref["epoch_loss"]), 1e-30))
    nums["epoch_change_gap"] = leaf_gap(change(prog["after_epoch"], init),
                                        change(ref["after_epoch"], init),
                                        leaves)
    if prog["logits"]:
        nums["logits_gap"] = rel_max(prog["logits"][0], ref["logits"][0])
    return finite(nums)


def finite(nums: dict) -> dict:
    return {n: (v if math.isfinite(v) else math.inf) for n, v in
            nums.items()}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a NaN or a missing number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and (v <= limit)      # NaN compares false
    return ok, checks
