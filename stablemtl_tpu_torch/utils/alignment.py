"""Eval-time scale/shift alignment between predictions and GT (host-side).

Parity targets:
- depth: closed-form least-squares scale+shift with optional downsampling
  (reference src/util/alignment.py:122-169)
- flow/scene flow: per-channel non-negative least-squares positive scale
  (reference src/util/alignment.py:82-119). For the 1-parameter case NNLS has
  the closed form  s* = max(0, <p,g>/<p,p>)  — proven equivalent to
  scipy.optimize.nnls in tests/test_alignment.py.
- flow norm variant (reference alignment.py:48-79).

Copy of `stablemtl_tpu/utils/alignment.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _nnls_scale_1d(pred: np.ndarray, gt: np.ndarray) -> float:
    """argmin_{s>=0} ||s*pred - gt||^2 = max(0, <p,g>/<p,p>)."""
    denom = float(np.dot(pred, pred))
    if denom <= 0.0:
        return 0.0
    return max(0.0, float(np.dot(pred, gt)) / denom)


def align_depth_least_square(
    gt_arr: np.ndarray,
    pred_arr: np.ndarray,
    valid_mask_arr: np.ndarray,
    return_scale_shift: bool = True,
    max_resolution: int | None = None,
):
    """Closed-form scale+shift aligning `pred` to `gt` over the valid mask."""
    ori_shape = pred_arr.shape

    gt = np.asarray(gt_arr).squeeze()
    pred = np.asarray(pred_arr).squeeze()
    valid_mask = np.asarray(valid_mask_arr).squeeze().astype(bool)

    if max_resolution is not None:
        scale_factor = float(np.min(max_resolution / np.array(gt.shape[-2:])))
        if scale_factor < 1:
            # nearest-neighbor downsample (reference uses nn Upsample)
            H, W = gt.shape[-2:]
            nh, nw = int(H * scale_factor), int(W * scale_factor)
            ys = (np.arange(nh) / scale_factor).astype(int).clip(0, H - 1)
            xs = (np.arange(nw) / scale_factor).astype(int).clip(0, W - 1)
            gt = gt[..., ys[:, None], xs[None, :]]
            pred = pred[..., ys[:, None], xs[None, :]]
            valid_mask = valid_mask[..., ys[:, None], xs[None, :]]

    assert gt.shape == pred.shape == valid_mask.shape, (
        gt.shape, pred.shape, valid_mask.shape)

    g = gt[valid_mask].reshape(-1).astype(np.float64)
    p = pred[valid_mask].reshape(-1).astype(np.float64)
    A = np.stack([p, np.ones_like(p)], axis=-1)
    (scale, shift), *_ = np.linalg.lstsq(A, g, rcond=None)

    aligned = (np.asarray(pred_arr) * scale + shift).reshape(ori_shape)
    if return_scale_shift:
        return aligned, scale, shift
    return aligned


def align_flow_least_square(
    gt_arr: np.ndarray,
    pred_arr: np.ndarray,
    valid_mask_arr: np.ndarray,
    return_scale_shift: bool = True,
):
    """Per-channel positive scale (NNLS) aligning flow channels independently."""
    gt = np.asarray(gt_arr).squeeze()
    pred = np.asarray(pred_arr).squeeze()
    valid_mask = np.asarray(valid_mask_arr).squeeze().astype(bool)

    C = pred.shape[0]
    aligned = np.zeros_like(pred)
    scale = np.zeros((C,))
    shift = np.zeros((C,))
    for c in range(C):
        assert gt[c].shape == pred[c].shape == valid_mask.shape
        g = gt[c][valid_mask].reshape(-1).astype(np.float64)
        p = pred[c][valid_mask].reshape(-1).astype(np.float64)
        scale[c] = _nnls_scale_1d(p, g)
        aligned[c] = pred[c] * scale[c]

    if return_scale_shift:
        return aligned, scale, shift
    return aligned


def align_flow_norm_least_square(
    gt_arr: np.ndarray,
    pred_arr: np.ndarray,
    valid_mask_arr: np.ndarray,
    return_scale_shift: bool = True,
):
    """Single positive scale matching the flow-magnitude fields."""
    gt = np.asarray(gt_arr).squeeze()
    pred = np.asarray(pred_arr).squeeze()
    valid_mask = np.asarray(valid_mask_arr).squeeze().astype(bool)

    gt_norm = np.linalg.norm(gt, axis=0)
    pred_norm = np.linalg.norm(pred, axis=0)
    g = gt_norm[valid_mask].reshape(-1).astype(np.float64)
    p = pred_norm[valid_mask].reshape(-1).astype(np.float64)
    scale = _nnls_scale_1d(p, g)
    aligned = pred * scale
    if return_scale_shift:
        return aligned, scale, 0.0
    return aligned


# ---- disparity space (reference alignment.py:173-190) -----------------------

def depth2disparity(depth: np.ndarray, return_mask: bool = False):
    disparity = np.zeros_like(depth)
    mask = depth > 0
    disparity[mask] = 1.0 / depth[mask]
    if return_mask:
        return disparity, mask
    return disparity


def disparity2depth(disparity: np.ndarray, **kwargs):
    return depth2disparity(disparity, **kwargs)
