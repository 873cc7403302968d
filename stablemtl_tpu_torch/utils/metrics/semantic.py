"""Confusion-matrix semantic segmentation metrics.

Parity with reference src/util/metric_semantic.py:28-80 (mIoU, overall Acc,
per-class IoU over an accumulated confusion matrix).

Copy of `stablemtl_tpu/utils/metrics/semantic.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


class SemanticMetrics:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))

    def _fast_hist(self, label_true, label_pred):
        n = self.n_classes
        mask = (label_true >= 0) & (label_true < n)
        hist = np.bincount(
            n * label_true[mask].astype(int) + label_pred[mask], minlength=n ** 2
        ).reshape(n, n)
        return hist

    def update(self, label_trues, label_preds, valid_masks):
        assert label_trues.ndim == 3 and label_preds.ndim == 3 and valid_masks.ndim == 3
        for lt, lp, m in zip(label_trues, label_preds, valid_masks):
            m = m.astype(bool)
            self.confusion_matrix += self._fast_hist(lt[m], lp[m])

    def result(self) -> dict:
        hist = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        mean_iu = np.nanmean(iu)
        out = {"Acc": float(acc), "mIoU": float(mean_iu)}
        out.update({f"cls_{k:02d}": float(v) for k, v in enumerate(iu)})
        return out
