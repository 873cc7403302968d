"""Optical-flow and scene-flow metrics (parity with reference
src/util/metric_optical_flow.py).

Copy of `stablemtl_tpu/utils/metrics/flow.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .normal import _l2_normalize


class OpticalFlowMetrics:
    """EPE2d, Fl (KITTI outlier rate), mean angular error — pixel-accumulated."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.m = {"counts": 0.0, "EPE2d": 0.0, "Fl": 0.0, "angular_error": 0.0}

    def update(self, optical_flow_preds, optical_flow_gts, valid_masks):
        preds = np.asarray(optical_flow_preds, np.float64)
        gts = np.asarray(optical_flow_gts, np.float64)
        masks = np.asarray(valid_masks)
        assert preds.ndim == 4 and gts.ndim == 4 and masks.ndim == 4

        for output, target, mask in zip(preds, gts, masks):
            mask = mask.astype(np.float64)  # [1,H,W]
            on = _l2_normalize(output, axis=0)
            tn = _l2_normalize(target, axis=0)
            ang = np.arccos(np.clip((on * tn).sum(0, keepdims=True), -1, 1))
            ang = ang * 180.0 / np.pi * mask

            epe = np.sqrt(((output - target) ** 2).sum(0, keepdims=True)) * mask
            mag = np.sqrt((target ** 2).sum(0, keepdims=True))
            with np.errstate(divide="ignore", invalid="ignore"):
                fl = ((epe > 3.0) & (epe / mag > 0.05)).astype(np.float64) * mask

            self.m["angular_error"] += ang.sum()
            self.m["EPE2d"] += epe.sum()
            self.m["Fl"] += fl.sum()
            self.m["counts"] += mask.sum()

    def result(self):
        c = self.m["counts"]
        return {
            "EPE2d": self.m["EPE2d"] / c,
            "Fl": self.m["Fl"] / c,
            "optical_flow_MAE": self.m["angular_error"] / c,
        }


class SceneFlowMetrics:
    """EPE3d, acc_strict (<5cm/5%), acc_relax (<10cm/10%), outliers (>30cm/10%)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.m = {"counts": 0.0, "EPE3d": 0.0, "acc_strict": 0.0,
                  "acc_relax": 0.0, "outliers": 0.0}

    def update(self, scene_flow_preds, scene_flow_gts, valid_masks):
        preds = np.asarray(scene_flow_preds, np.float64)
        gts = np.asarray(scene_flow_gts, np.float64)
        masks = np.asarray(valid_masks)
        assert preds.ndim == 4 and gts.ndim == 4 and masks.ndim == 4

        for pred, target, mask in zip(preds, gts, masks):
            maskf = mask.astype(np.float64)  # [1,H,W]
            epe = np.sqrt(((pred - target) ** 2).sum(0, keepdims=True)) * maskf
            mag = np.sqrt((target ** 2).sum(0, keepdims=True)) + 1e-4

            acc_s = ((epe < 0.05) & (epe < mag * 0.05)).astype(np.float64) * maskf
            acc_r = ((epe < 0.1) & (epe < mag * 0.1)).astype(np.float64) * maskf
            outl = ((epe > 0.3) & (epe > mag * 0.1)).astype(np.float64) * maskf

            self.m["EPE3d"] += epe.sum()
            self.m["acc_strict"] += acc_s.sum()
            self.m["acc_relax"] += acc_r.sum()
            self.m["outliers"] += outl.sum()
            self.m["counts"] += maskf.sum()

    def result(self):
        c = self.m["counts"]
        return {
            "EPE3d": self.m["EPE3d"] / c,
            "acc_strict": self.m["acc_strict"] / c,
            "acc_relax": self.m["acc_relax"] / c,
            "outliers": self.m["outliers"] / c,
        }
