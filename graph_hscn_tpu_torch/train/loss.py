"""Loss functions: the counterpart of ``graph_hscn_tpu/train/loss.py`` (the
reference's criterion, loss.py:6-19).

Reference semantics:
  loss_fn == "cross_entropy": BCE-with-logits (mean), score = sigmoid(pred)
  "l1"/"mae": L1 loss, and — reference quirk #10 — the returned score is
  sigmoid(pred).  ``compat_sigmoid_score`` reproduces that; default False
  returns raw predictions for regression metrics.
  "softmax_cross_entropy": multiclass with one-hot targets.

All losses are masked over the padded rows so dummy graphs/nodes contribute
nothing, and the mean is over real elements only.
"""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """values [G, C], mask [G] -> mean over real rows x all C columns."""
    m = mask[:, None].to(values.dtype)
    denom = (m.sum() * values.shape[-1]).clamp_min(1.0)
    return (values * m).sum() / denom


def criterion(loss_fn: str, pred: torch.Tensor, true: torch.Tensor,
              mask: torch.Tensor, compat_sigmoid_score: bool = False):
    """Returns (loss, score) like the reference criterion (loss.py:6).

    pred/true: [G, C]; mask: [G] bool (real rows).
    """
    if loss_fn == "cross_entropy":
        per = (pred.clamp_min(0) - pred * true
               + torch.log1p(torch.exp(-pred.abs())))
        return _masked_mean(per, mask), torch.sigmoid(pred)
    if loss_fn in ("l1", "mae"):
        loss = _masked_mean((pred - true).abs(), mask)
        score = torch.sigmoid(pred) if compat_sigmoid_score else pred
        return loss, score
    if loss_fn == "softmax_cross_entropy":
        logp = torch.log_softmax(pred, dim=-1)
        per = -(true * logp).sum(-1)
        m = mask.to(pred.dtype)
        loss = (per * m).sum() / m.sum().clamp_min(1.0)
        return loss, torch.softmax(pred, dim=-1)
    raise ValueError(f"Unknown loss_fn {loss_fn}")
