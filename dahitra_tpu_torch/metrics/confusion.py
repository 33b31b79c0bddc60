"""Confusion-matrix metrics, accumulated on the device.

Counterpart of dahitra_tpu/metrics/confusion.py (the reference's
misc/metric_tool.py:48-158). Rows are ground truth, columns prediction;
pixels whose ground truth lies outside [0, n_class) (the 255 ignore label)
are dropped. The matrices count ``n*gt + pred`` into ``n*n + 1`` bins of
fixed size with ``scatter_add_`` (exact integer counts); the dropped pixels
land in the extra bin, which is cut off. ``torch.bincount`` would read the
input's extremes back to the host to size its output on a CUDA tensor, so
a CUDA graph could not capture it; this form syncs nothing until
``cm2score``.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def _flat_index(pred: torch.Tensor, gt: torch.Tensor, n: int) -> torch.Tensor:
    gt = gt.long()
    valid = (gt >= 0) & (gt < n)
    return torch.where(valid, gt * n + pred.long(), n * n)


def _counts(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Occurrences of each of ``bins`` values in the flat int64 ``idx``."""
    return torch.zeros(bins, dtype=torch.long, device=idx.device) \
        .scatter_add_(0, idx, torch.ones_like(idx))


def batch_confusion_matrix(pred: torch.Tensor, gt: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """(n_class, n_class) int64 matrix of one batch of class indices."""
    n = num_classes
    idx = _flat_index(pred.reshape(-1), gt.reshape(-1), n)
    return _counts(idx, n * n + 1)[:n * n].view(n, n)


def per_sample_confusion_matrix(pred: torch.Tensor, gt: torch.Tensor,
                                num_classes: int) -> torch.Tensor:
    """(B, n_class, n_class) int64 matrices, one per sample, so samples can
    be regrouped after the pass (eval_cd's per-patch score blocks)."""
    n, b = num_classes, pred.shape[0]
    idx = _flat_index(pred.reshape(b, -1), gt.reshape(b, -1), n)
    idx = idx + torch.arange(b, device=idx.device)[:, None] * (n * n + 1)
    cm = _counts(idx.reshape(-1), b * (n * n + 1))
    return cm.view(b, n * n + 1)[:, :n * n].reshape(b, n, n)


def cm2f1(cm) -> float:
    """Mean F1 of a confusion matrix (misc/metric_tool.py:72-93)."""
    hist = np.asarray(cm, np.float64)
    tp = np.diag(hist)
    recall = tp / (hist.sum(axis=1) + _EPS)
    precision = tp / (hist.sum(axis=0) + _EPS)
    f1 = 2 * recall * precision / (recall + precision + _EPS)
    return float(np.nanmean(f1))


def cm2score(cm) -> dict:
    """Score dict of a confusion matrix (misc/metric_tool.py:96-138).

    Keys: acc, miou, mf1, iou_i, F1_i, precision_i, recall_i."""
    hist = np.asarray(cm, np.float64)
    n_class = hist.shape[0]
    tp = np.diag(hist)
    sum_rows = hist.sum(axis=1)
    sum_cols = hist.sum(axis=0)
    acc = tp.sum() / (hist.sum() + _EPS)
    recall = tp / (sum_rows + _EPS)
    precision = tp / (sum_cols + _EPS)
    f1 = 2 * recall * precision / (recall + precision + _EPS)
    iu = tp / (sum_rows + sum_cols - tp + _EPS)
    score = {"acc": float(acc), "miou": float(np.nanmean(iu)),
             "mf1": float(np.nanmean(f1))}
    score.update({f"iou_{i}": float(iu[i]) for i in range(n_class)})
    score.update({f"F1_{i}": float(f1[i]) for i in range(n_class)})
    score.update({f"precision_{i}": float(precision[i]) for i in range(n_class)})
    score.update({f"recall_{i}": float(recall[i]) for i in range(n_class)})
    return score


class ConfusionAccumulator:
    """Running confusion matrix on the device (ConfuseMatrixMeter); the
    host reads it only in ``matrix``, ``f1`` and ``scores``."""

    def __init__(self, n_class: int, device="cpu"):
        self.n_class = n_class
        self.device = torch.device(device)
        self.clear()

    def clear(self) -> None:
        self._cm = torch.zeros((self.n_class, self.n_class), dtype=torch.long,
                               device=self.device)

    def update(self, pred: torch.Tensor, gt: torch.Tensor) -> None:
        self._cm += batch_confusion_matrix(pred, gt, self.n_class)

    def update_cm(self, cm: torch.Tensor) -> None:
        self._cm += cm.long()

    @property
    def matrix(self) -> np.ndarray:
        return self._cm.cpu().numpy()

    def f1(self) -> float:
        return cm2f1(self.matrix)

    def scores(self) -> dict:
        return cm2score(self.matrix)
