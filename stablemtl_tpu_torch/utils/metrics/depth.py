"""Depth metrics (host-side numpy; parity with reference src/util/metric.py).

All functions take (pred, gt, valid_mask) with trailing [-2,-1] spatial dims
and reduce with masked sums exactly as the reference does (zeroing invalid
entries, dividing by the per-image valid count, then averaging over batch).

Copy of `stablemtl_tpu/utils/metrics/depth.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _masked_per_image_mean(err: np.ndarray, valid_mask) -> float:
    if valid_mask is not None:
        err = np.where(valid_mask, err, 0.0)
        n = valid_mask.sum((-1, -2))
    else:
        n = err.shape[-1] * err.shape[-2]
    return float((err.sum((-1, -2)) / n).mean())


def abs_relative_difference(output, target, valid_mask=None):
    return _masked_per_image_mean(np.abs(output - target) / target, valid_mask)


def squared_relative_difference(output, target, valid_mask=None):
    return _masked_per_image_mean((output - target) ** 2 / target, valid_mask)


def rmse_linear(output, target, valid_mask=None):
    diff = output - target
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0.0)
        n = valid_mask.sum((-1, -2))
    else:
        n = output.shape[-1] * output.shape[-2]
    mse = (diff ** 2).sum((-1, -2)) / n
    return float(np.sqrt(mse).mean())


def rmse_log(output, target, valid_mask=None):
    diff = np.log(output) - np.log(target)
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0.0)
        n = valid_mask.sum((-1, -2))
    else:
        n = output.shape[-1] * output.shape[-2]
    mse = (diff ** 2).sum((-1, -2)) / n
    return float(np.sqrt(mse).mean())


def log10(output, target, valid_mask=None):
    if valid_mask is not None:
        diff = np.abs(np.log10(output[valid_mask]) - np.log10(target[valid_mask]))
    else:
        diff = np.abs(np.log10(output) - np.log10(target))
    return float(diff.mean())


def threshold_percentage(output, target, threshold_val, valid_mask=None):
    ratio = np.maximum(output / target, target / output)
    bit = (ratio < threshold_val).astype(np.float64)
    if valid_mask is not None:
        bit = np.where(valid_mask, bit, 0.0)
        n = valid_mask.sum((-1, -2))
    else:
        n = output.shape[-1] * output.shape[-2]
    return float((bit.sum((-1, -2)) / n).mean())


def delta1_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25, valid_mask)


def delta2_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25 ** 2, valid_mask)


def delta3_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25 ** 3, valid_mask)


def i_rmse(output, target, valid_mask=None):
    diff = 1.0 / output - 1.0 / target
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0.0)
        n = valid_mask.sum((-1, -2))
    else:
        n = output.shape[-1] * output.shape[-2]
    mse = (diff ** 2).sum((-1, -2)) / n
    return float(np.sqrt(mse).mean())


def silog_rmse(depth_pred, depth_gt, valid_mask=None):
    diff = np.log(depth_pred) - np.log(depth_gt)
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0.0)
        n = valid_mask.sum((-1, -2))
    else:
        n = depth_gt.shape[-2] * depth_gt.shape[-1]
    first = (diff ** 2).sum((-1, -2)) / n
    second = diff.sum((-1, -2)) ** 2 / (n ** 2)
    return float(np.sqrt(np.mean(first - second)) * 100)
