"""Albedo/shading metrics: scale-matched RMSE, SSIM, windowed LMSE.

Parity with reference src/util/metric_albedo_and_shading.py:13-245. The
reference uses skimage's `structural_similarity`; that package is not a
dependency here, so `ssim` below reimplements skimage's default algorithm
(uniform 7x7 window, sample covariance, K1=0.01/K2=0.03, border crop of
(win-1)//2) and is validated against its published formula in tests.

Copy of `stablemtl_tpu/utils/metrics/albedo_shading.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def match_scale(pred: np.ndarray, grnd: np.ndarray, mask: np.ndarray | None = None):
    """Least-squares scalar aligning pred to gt over the mask (H,W[,C] inputs)."""
    if mask is None:
        mask = np.ones(pred.shape[:2], dtype=bool)
    if mask.ndim == 3:
        mask = mask.squeeze(-1)
    flat_pred = pred[mask].reshape(-1)
    flat_grnd = grnd[mask].reshape(-1)
    scale, *_ = np.linalg.lstsq(flat_pred.reshape(-1, 1), flat_grnd, rcond=None)
    return scale


def _ssim_single(x: np.ndarray, y: np.ndarray, data_range: float,
                 win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """SSIM for one 2-D channel, matching skimage defaults."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)  # sample covariance

    filt = lambda a: uniform_filter(a, size=win_size)
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = data_range
    C1 = (K1 * R) ** 2
    C2 = (K2 * R) ** 2

    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def ssim(x: np.ndarray, y: np.ndarray, data_range: float = 1.0,
         channel_axis: int | None = None, win_size: int = 7) -> float:
    if channel_axis is None:
        return _ssim_single(x, y, data_range, win_size)
    x = np.moveaxis(x, channel_axis, -1)
    y = np.moveaxis(y, channel_axis, -1)
    vals = [
        _ssim_single(x[..., c], y[..., c], data_range, win_size)
        for c in range(x.shape[-1])
    ]
    return float(np.mean(vals))


def _ssq_error(correct: np.ndarray, estimate: np.ndarray, mask: np.ndarray) -> float:
    """Sum-squared error with per-window optimal positive rescaling."""
    assert correct.ndim == 2
    denom = np.sum(estimate ** 2 * mask)
    alpha = np.sum(correct * estimate * mask) / denom if denom > 1e-5 else 0.0
    return float(np.sum(mask * (correct - alpha * estimate) ** 2))


def _lmse_gray(correct, estimate, mask, window_size: int, window_shift: int) -> float:
    M, N = correct.shape[:2]
    ssq = total = 0.0
    for i in range(0, M - window_size + 1, window_shift):
        for j in range(0, N - window_size + 1, window_shift):
            cc = correct[i:i + window_size, j:j + window_size]
            ec = estimate[i:i + window_size, j:j + window_size]
            mc = mask[i:i + window_size, j:j + window_size]
            ssq += _ssq_error(cc, ec, mc)
            total += np.sum(mc * cc ** 2)
    assert not np.isnan(ssq / total)
    return ssq / total


def _lmse_rgb(correct, estimate, mask, window_size: int, window_shift: int) -> float:
    M, N = correct.shape[:2]
    ssq = total = 0.0
    for i in range(0, M - window_size + 1, window_shift):
        for j in range(0, N - window_size + 1, window_shift):
            cc = correct[i:i + window_size, j:j + window_size, :]
            ec = estimate[i:i + window_size, j:j + window_size, :]
            mc = mask[i:i + window_size, j:j + window_size]
            # stack channels vertically so one alpha covers all 3 channels
            rep_mask = np.concatenate([mc] * 3, 0)
            rep_cor = np.concatenate([cc[:, :, 0], cc[:, :, 1], cc[:, :, 2]], 0)
            rep_est = np.concatenate([ec[:, :, 0], ec[:, :, 1], ec[:, :, 2]], 0)
            ssq += _ssq_error(rep_cor, rep_est, rep_mask)
            total += np.sum(rep_mask * rep_cor ** 2)
    assert not np.isnan(ssq / total)
    return ssq / total


def lmse(correct, estimate, mask, window_size: int = 16, window_shift: int = 8):
    if correct.ndim == 2 or correct.shape[-1] == 1:
        return _lmse_gray(correct, estimate, mask, window_size, window_shift)
    return _lmse_rgb(correct, estimate, mask, window_size, window_shift)


class AlbedoAndShadingMetrics:
    def __init__(self):
        self.reset()

    def reset(self):
        self.m = {"rmse": 0.0, "ssim": 0.0, "lmse": 0.0, "count": 0}

    def update(self, preds, gts, valid_masks):
        preds = np.asarray(preds, np.float64)
        gts = np.asarray(gts, np.float64)
        masks = np.asarray(valid_masks)
        assert preds.ndim == 4 and gts.ndim == 4 and masks.ndim == 4

        for pred, gt, mask in zip(preds, gts, masks):
            pred = pred.transpose(1, 2, 0)           # (H,W,C)
            gt = gt.transpose(1, 2, 0)
            mask = mask.transpose(1, 2, 0).astype(bool)  # (H,W,1)

            scale = match_scale(pred, gt, mask)
            scaled = (pred * scale).clip(0, 1)

            sq = (scaled - gt) ** 2
            rmse = np.sqrt(np.sum(sq * mask) / np.sum(mask))
            lm = lmse(gt.squeeze(), scaled.squeeze(), mask.squeeze())
            sv = ssim(scaled, gt, data_range=1.0, channel_axis=2)

            self.m["rmse"] += rmse
            self.m["lmse"] += lm
            self.m["ssim"] += sv
            self.m["count"] += 1

    def result(self):
        c = self.m["count"]
        return {"rmse": self.m["rmse"] / c, "ssim": self.m["ssim"] / c,
                "lmse": self.m["lmse"] / c}
