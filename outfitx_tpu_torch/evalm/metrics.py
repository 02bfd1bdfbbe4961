"""Evaluation metrics (this package's copy of ``outfitx_tpu/evalm/
metrics.py``), numpy only.

- CP: AUC + Acc/P/R/F1 at threshold 0.5 on sigmoid scores;
- CIR: Recall@k from top-k retrieval against candidate pools;
- FITB: accuracy of argmin-L2 over the candidates.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

_EPS = 1e-7


def roc_auc(scores, labels) -> float:
    """Tie-aware Mann-Whitney AUC."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(np.int64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    n = scores.size
    while i < n:  # average ranks for ties
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos_rank_sum = ranks[labels == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def binary_classification_metrics(
    scores, labels, *, threshold: float = 0.5, from_logits: bool = False
) -> Dict[str, float]:
    """Acc/P/R/F1 at a probability threshold + AUC, eps-safe divides."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(np.int64)
    probs = 1.0 / (1.0 + np.exp(-scores)) if from_logits else scores
    preds = (probs >= threshold).astype(np.int64)
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    tn = float(np.sum((preds == 0) & (labels == 0)))
    precision = tp / (tp + fp + _EPS)
    recall = tp / (tp + fn + _EPS)
    f1 = 2 * precision * recall / (precision + recall + _EPS)
    acc = (tp + tn) / max(labels.size, 1)
    return {
        "auc": roc_auc(probs, labels),
        "acc": acc,
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def recall_at_k(
    retrieved_ids: np.ndarray,  # (Q, K_max) ranked retrieved item ids
    positive_ids: np.ndarray,  # (Q,)
    ks: Sequence[int] = (1, 5, 10, 15, 30, 50),
    valid: np.ndarray | None = None,  # (Q,) bool, False = padded query row
) -> Dict[str, float]:
    retrieved_ids = np.asarray(retrieved_ids)
    positive_ids = np.asarray(positive_ids).reshape(-1, 1)
    if valid is None:
        valid = np.ones(retrieved_ids.shape[0], dtype=bool)
    n = max(int(valid.sum()), 1)
    hits = retrieved_ids == positive_ids
    return {
        f"recall@{k}": float((hits[:, :k].any(axis=1) & valid).sum()) / n
        for k in ks
    }


def fitb_accuracy(pred_idx, answer_idx) -> float:
    pred_idx = np.asarray(pred_idx).ravel()
    answer_idx = np.asarray(answer_idx).ravel()
    if pred_idx.size == 0:
        return float("nan")
    return float(np.mean(pred_idx == answer_idx))
