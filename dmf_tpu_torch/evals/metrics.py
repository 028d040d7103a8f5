"""Classification metrics in numpy (host side, once per epoch), the port's
copy of ``dmf_tpu/evals/metrics.py`` (held equal by
``tests/test_torch_train.py``).

Macro AUROC / F1 / precision / recall and per-class accuracy from the
confusion matrix, with the reference's logged names (train.py:112-148,
792-798), and a streaming mean.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels.astype(np.int64), preds.astype(np.int64)), 1)
    return cm


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float((preds == labels).mean()) if len(labels) else 0.0


def per_class_accuracy(cm: np.ndarray) -> np.ndarray:
    return cm.diagonal() / np.maximum(cm.sum(axis=1), 1)


def _binary_auroc(scores: np.ndarray, positives: np.ndarray) -> float:
    """Rank-based (Mann-Whitney) AUROC with tie handling."""
    n_pos = int(positives.sum())
    n_neg = len(positives) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    # average ranks for ties
    i = 0
    r = np.arange(1, len(scores) + 1, dtype=np.float64)
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i : j + 1] = (i + j + 2) / 2.0
        i = j + 1
    ranks[order] = r
    rank_sum = ranks[positives.astype(bool)].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def multiclass_auroc(probs: np.ndarray, labels: np.ndarray, num_classes: int) -> float:
    """Macro one-vs-rest AUROC (torchmetrics MulticlassAUROC default)."""
    aucs = []
    for c in range(num_classes):
        auc = _binary_auroc(probs[:, c], (labels == c).astype(np.float64))
        if not np.isnan(auc):
            aucs.append(auc)
    return float(np.mean(aucs)) if aucs else 0.0


def _prf(cm: np.ndarray):
    tp = cm.diagonal().astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
    rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
    return prec, rec, f1


def multiclass_f1(preds, labels, num_classes) -> float:
    cm = confusion_matrix(preds, labels, num_classes)
    return float(_prf(cm)[2].mean())


def multiclass_precision(preds, labels, num_classes) -> float:
    cm = confusion_matrix(preds, labels, num_classes)
    return float(_prf(cm)[0].mean())


def multiclass_recall(preds, labels, num_classes) -> float:
    cm = confusion_matrix(preds, labels, num_classes)
    return float(_prf(cm)[1].mean())


def classification_report(
    probs: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    prefix: str = "",
) -> Dict[str, float]:
    """Full epoch-level metric dict matching the reference's logged names."""
    preds = probs.argmax(axis=1)
    cm = confusion_matrix(preds, labels, num_classes)
    prec, rec, f1 = _prf(cm)
    out = {
        f"{prefix}acc": accuracy(preds, labels),
        f"{prefix}roc_auc": multiclass_auroc(probs, labels, num_classes),
        f"{prefix}f1": float(f1.mean()),
        f"{prefix}precision": float(prec.mean()),
        f"{prefix}recall": float(rec.mean()),
    }
    pca = per_class_accuracy(cm)
    for i, a in enumerate(pca):
        out[f"{prefix}acc_class_{i}"] = float(a)
    return out


class MeanMetric:
    """Streaming mean (torchmetrics MeanMetric equivalent)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, weight: float = 1.0) -> None:
        self.total += float(value) * weight
        self.count += weight

    def compute(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        self.total, self.count = 0.0, 0
