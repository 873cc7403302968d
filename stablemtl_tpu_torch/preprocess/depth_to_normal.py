"""d2nt: synthesize surface normals from depth (vKITTI GT normals).

Port of reference depth-to-normal-translator/python/{process_vkitti2.py,
utils/myApis.py} (d2nt_v3): discrete-anisotropic-gradient (DAG) depth
gradients, depth-to-normal translation with camera intrinsics, and the
MRF local-argmin refinement. vKITTI intrinsics: fx=fy=725.0087,
u0=620.5, v0=187 (process_vkitti2.py:76).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve

VKITTI_FX = VKITTI_FY = 725.0087
VKITTI_U0, VKITTI_V0 = 620.5, 187.0

_GRAD_L = np.array([[-1.0, 1.0, 0.0]])
_GRAD_R = np.array([[0.0, -1.0, 1.0]])
_GRAD_U = np.array([[-1.0], [1.0], [0.0]])
_GRAD_D = np.array([[0.0], [-1.0], [1.0]])
_LAP_ALPHA = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)


def _filt(z, k):
    # cv2.filter2D (the reference, myApis.py) correlates with
    # BORDER_REFLECT_101 — scipy's mode="mirror", NOT mode="reflect"
    # (verified numerically: "reflect" deviates in a 2-3 px border band)
    return convolve(z, np.flip(k), mode="mirror")


def _soft_min(lap, base, direction):
    """Exponentially-weighted left/right (or up/down) gradient weights
    (myApis.py:49-66)."""
    h, w = lap.shape
    eps = 1e-8
    p = np.power(base, -lap)
    if direction == 0:
        pl = np.hstack([np.zeros((h, 1)), p[:, :-1]])
        pr = np.hstack([p[:, 1:], np.zeros((h, 1))])
        return ((pl + eps / 2) / (eps + pl + pr),
                (pr + eps / 2) / (eps + pl + pr))
    pu = np.vstack([np.zeros((1, w)), p[:-1, :]])
    pd = np.vstack([p[1:, :], np.zeros((1, w))])
    return ((pu + eps / 2) / (eps + pu + pd),
            (pd + eps / 2) / (eps + pu + pd))


def dag_gradients(z: np.ndarray, base: float = np.e):
    """Direction-aware gradients Gu, Gv (myApis.py:84-126, '1D-DLF')."""
    gl, gr = _filt(z, _GRAD_L), _filt(z, _GRAD_R)
    gu, gd = _filt(z, _GRAD_U), _filt(z, _GRAD_D)
    lap_h = np.abs(gl - gr)
    lap_v = np.abs(gu - gd)
    l1, l2 = _soft_min(lap_h, base, 0)
    l3, l4 = _soft_min(lap_v, base, 1)

    eps, thresh = 1e-8, base
    hard_r = l1 / (l2 + eps) > thresh
    l1[hard_r], l2[hard_r] = 1, 0
    hard_l = l2 / (l1 + eps) > thresh
    l1[hard_l], l2[hard_l] = 0, 1
    hard_d = l3 / (l4 + eps) > thresh
    l3[hard_d], l4[hard_d] = 1, 0
    hard_u = l4 / (l3 + eps) > thresh
    l3[hard_u], l4[hard_u] = 0, 1

    return l1 * gl + l2 * gr, l3 * gu + l4 * gd


def mrf_refine(depth: np.ndarray, n_est: np.ndarray) -> np.ndarray:
    """Pick each pixel's normal from the neighbor with the smallest depth
    laplacian (myApis.py:128-179, 'DLF-alpha')."""
    h, w = depth.shape
    lap = np.abs(_filt(depth, _LAP_ALPHA))
    inf_col = np.full((h, 1), np.inf)
    inf_row = np.full((1, w), np.inf)
    stack = np.stack([
        np.hstack([inf_col, lap[:, :-1]]),
        np.hstack([lap[:, 1:], inf_col]),
        np.vstack([inf_row, lap[:-1, :]]),
        np.vstack([lap[1:, :], inf_row]),
        lap,
    ])
    best = np.argmin(stack, axis=0).reshape(-1)

    out = np.empty_like(n_est)
    for c in range(3):
        nc = n_est[..., c]
        zeros_col = np.zeros((h, 1))
        zeros_row = np.zeros((1, w))
        cand = np.stack([
            np.hstack([zeros_col, nc[:, :-1]]),
            np.hstack([nc[:, 1:], zeros_col]),
            np.vstack([zeros_row, nc[:-1, :]]),
            np.vstack([nc[1:, :], zeros_row]),
            nc,
        ]).reshape(5, -1)
        out[..., c] = cand[best, np.arange(h * w)].reshape(h, w)
    return out


def depth_to_normal(depth: np.ndarray, fx: float = VKITTI_FX,
                    fy: float = VKITTI_FY, u0: float = VKITTI_U0,
                    v0: float = VKITTI_V0, version: str = "d2nt_v3"
                    ) -> np.ndarray:
    """Depth [H,W] meters -> unit normals [H,W,3]
    (process_vkitti2.py:14-52)."""
    depth = depth.astype(np.float64)
    h, w = depth.shape
    u_map = np.ones((h, 1)) * np.arange(1, w + 1) - u0
    v_map = np.arange(1, h + 1).reshape(h, 1) * np.ones((1, w)) - v0

    if version == "d2nt_basic":
        gu = _filt(depth, np.array([[0, 0, 0], [-1, 0, 1], [0, 0, 0]],
                                   np.float64)) / 2
        gv = _filt(depth, np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]],
                                   np.float64)) / 2
    else:
        gu, gv = dag_gradients(depth)

    nx = gu * fx
    ny = gv * fy
    nz = -(depth + v_map * gv + u_map * gu)
    normal = -np.stack([nx, ny, nz], axis=-1)
    norm = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / np.maximum(norm, 1e-12)

    if version == "d2nt_v3":
        normal = mrf_refine(depth, normal)
    return normal.astype(np.float32)
