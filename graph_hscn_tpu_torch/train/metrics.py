"""Evaluation metrics — numpy implementations matching the reference's
sklearn-based eval_ap / eval_mae (reference metrics.py:6-36), plus macro-F1
for node classification (PascalVOC-SP).

These run on host after device->host transfer of the epoch's accumulated
predictions (one transfer per epoch, not per batch — the reference syncs
every batch via loss.item(), train.py:85).
"""

from __future__ import annotations

import numpy as np


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


METRICS = {"ap": eval_ap, "mae": eval_mae, "f1": eval_macro_f1}
