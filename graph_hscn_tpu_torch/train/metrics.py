"""Evaluation metrics — numpy implementations matching the reference's
sklearn-based eval_ap / eval_mae (reference metrics.py:6-36), plus macro-F1
for node classification (PascalVOC-SP).

These run on host after device->host transfer of the epoch's accumulated
predictions (one transfer per epoch, not per batch — the reference syncs
every batch via loss.item(), train.py:85).

A metric that is a function of integer counts (:data:`COUNT_METRICS`:
macro-F1 of the confusion counts) is reduced on the device instead: each
step computes its counts (:func:`confusion_counts`), the epoch end sums
them there (:func:`sum_step_counts`) and reads back the one count vector,
and the host finishes the metric from it (:func:`macro_f1_from_counts`),
equal to :func:`eval_macro_f1` on the same outputs bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary AP, identical to sklearn.average_precision_score:
    AP = sum_n (R_n - R_{n-1}) * P_n over descending DISTINCT-score
    thresholds.  Tied scores form ONE threshold (sklearn's
    precision_recall_curve groups them); evaluating per-sample instead
    diverges under ties — measured +0.05 AP on a rounded-score column —
    so parity with the reference's sklearn call requires the grouping."""
    order = np.argsort(-y_score, kind="stable")
    ys = y_score[order]
    yt = y_true[order].astype(np.float64)
    if len(yt) == 0:
        return 0.0
    tp = np.cumsum(yt)
    fp = np.cumsum(1 - yt)
    n_pos = tp[-1]
    if n_pos == 0:
        return 0.0
    # Last index of each run of equal scores = the distinct thresholds.
    boundary = np.r_[np.nonzero(np.diff(ys))[0], len(ys) - 1]
    tp_g, fp_g = tp[boundary], fp[boundary]
    precision = tp_g / np.maximum(tp_g + fp_g, 1)
    recall = tp_g / n_pos
    prev_recall = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_recall) * precision))


def eval_ap(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro-average AP over label columns having both classes
    (reference metrics.py:6-27)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    ap_list = []
    for i in range(y_true.shape[1]):
        col = y_true[:, i]
        if (col == 1).sum() > 0 and (col == 0).sum() > 0:
            is_labeled = col == col  # NaN guard like the reference
            ap_list.append(average_precision(col[is_labeled],
                                             y_pred[is_labeled, i]))
    if not ap_list:
        raise RuntimeError("No positively labeled data available; cannot "
                           "compute Average Precision.")
    return float(np.mean(ap_list))


def eval_mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """MAE with NaN guard (reference metrics.py:30-36)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if np.any(np.isnan(y_pred)):
        raise ValueError("Model is predicting NaN.")
    return float(np.mean(np.abs(y_true - y_pred)))


def eval_macro_f1(y_true_onehot: np.ndarray, y_pred_scores: np.ndarray
                  ) -> float:
    """Macro F1 for node classification (PascalVOC-SP convention)."""
    true_lab = np.argmax(y_true_onehot, axis=1)
    pred_lab = np.argmax(y_pred_scores, axis=1)
    classes = np.unique(true_lab)
    f1s = []
    for c in classes:
        tp = np.sum((pred_lab == c) & (true_lab == c))
        fp = np.sum((pred_lab == c) & (true_lab != c))
        fn = np.sum((pred_lab != c) & (true_lab == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
    return float(np.mean(f1s))


def confusion_counts(score: torch.Tensor, true: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """A step's confusion counts on its device: score and one-hot true
    [N, C], mask [N] -> [C*C] int64, entry true*C + pred counting the
    unmasked rows of that (true, predicted) pair.  Only operations a CUDA
    graph captures: no boolean indexing, ``bincount`` or readback, whose
    shapes or values the host would have to wait for."""
    C = score.shape[-1]
    idx = torch.where(mask, true.argmax(-1) * C + score.argmax(-1), C * C)
    counts = torch.zeros(C * C + 1, dtype=torch.int64, device=score.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[:-1]


def sum_step_counts(rows: torch.Tensor) -> torch.Tensor:
    """A pass's counts: its steps' count rows [R, K] summed on their
    device to the [K] vector the pass reads back.
    ``sum_step_counts.passes`` counts the passes so reduced."""
    sum_step_counts.passes += 1
    return rows.sum(0)


sum_step_counts.passes = 0


def macro_f1_from_counts(counts: np.ndarray) -> float:
    """:func:`eval_macro_f1` from the [C*C] confusion counts of
    :func:`confusion_counts`: the classes present among the true labels in
    ascending order (``np.unique``'s), each one's F1 from its tp, fp and
    fn in the same integer and float64 arithmetic, and their mean."""
    C = int(round(np.sqrt(counts.size)))
    cm = np.asarray(counts, np.int64).reshape(C, C)
    true_n, pred_n = cm.sum(1), cm.sum(0)
    classes = np.nonzero(true_n)[0]
    tp = cm[classes, classes]
    fp = pred_n[classes] - tp
    fn = true_n[classes] - tp
    # A present class has tp + fn > 0, so no denominator is 0.
    return float(np.mean(2 * tp / (2 * tp + fp + fn)))


@dataclasses.dataclass(frozen=True)
class CountMetric:
    """A metric reduced on the device: ``step(score, true, mask)`` a
    step's integer counts, ``finish(counts)`` the metric from a pass's
    summed counts (numpy) on the host."""
    step: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    finish: Callable[[np.ndarray], float]


METRICS = {"ap": eval_ap, "mae": eval_mae, "f1": eval_macro_f1}
COUNT_METRICS = {"f1": CountMetric(confusion_counts, macro_f1_from_counts)}
