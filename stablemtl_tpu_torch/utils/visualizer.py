"""Visualization: depth colormap, optical-flow colorwheel, scene-flow HSV,
semantic palette, normals, tone mapping. Counterpart of
`stablemtl_tpu/utils/visualizer.py`; everything returns uint8 HWC arrays
from numpy, and `save_image` writes PNG with the standard library
(utils/png.py), not PIL.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from .png import write_png


def save_image(arr_u8: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, arr_u8.squeeze())


# ---------------------------------------------------------------------------
# Tone mapping (Hypersim, visualizer.py:10-49)
# ---------------------------------------------------------------------------

def tone_map(brightness: np.ndarray, gamma: float = 1.0 / 2.2,
             percentile: float = 90, brightness_nth_percentile_desired=0.8):
    """Scaled gamma tone map: choose k so the `percentile`-th brightness
    maps to the desired value (reference visualizer.py:10-49 /
    hypersim_util.py:44-83)."""
    b = np.clip(brightness, 0, None).astype(np.float64)
    bp = np.percentile(b, percentile)
    # reference blacks out when the percentile brightness is below eps
    # (hypersim_util.py:64-78) — a near-zero bp would otherwise amplify
    # noise by ~1/bp instead
    if bp < 1e-4:
        scale = 0.0
    else:
        scale = np.power(brightness_nth_percentile_desired,
                         1.0 / gamma) / bp
    return np.clip(np.power(scale * b, gamma), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Depth (Spectral colormap, image_util.py:29-67 / visualizer.py:642)
# ---------------------------------------------------------------------------

_SPECTRAL_ANCHORS = np.array([
    [158, 1, 66], [213, 62, 79], [244, 109, 67], [253, 174, 97],
    [254, 224, 139], [255, 255, 191], [230, 245, 152], [171, 221, 164],
    [102, 194, 165], [50, 136, 189], [94, 79, 162]], np.float32)


def _spectral(x: np.ndarray) -> np.ndarray:
    """Matplotlib 'Spectral' approximation via its 11 anchor colors."""
    x = np.clip(x, 0.0, 1.0) * (len(_SPECTRAL_ANCHORS) - 1)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, len(_SPECTRAL_ANCHORS) - 1)
    t = (x - lo)[..., None]
    return _SPECTRAL_ANCHORS[lo] * (1 - t) + _SPECTRAL_ANCHORS[hi] * t


def colorize_depth(depth: np.ndarray, min_depth: Optional[float] = None,
                   max_depth: Optional[float] = None,
                   valid_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Depth map -> Spectral-colormapped uint8 HWC image."""
    d = np.asarray(depth, np.float32).squeeze()
    if valid_mask is not None:
        vm = valid_mask.squeeze().astype(bool)
    else:
        vm = np.isfinite(d)
    lo = float(d[vm].min()) if min_depth is None else min_depth
    hi = float(d[vm].max()) if max_depth is None else max_depth
    # non-finite pixels must be neutralized BEFORE the colormap index
    # math: floor(NaN).astype(int) is INT64_MIN and would raise an
    # IndexError inside _spectral (they are blacked out below anyway)
    d = np.where(np.isfinite(d), d, lo)
    x = (d - lo) / max(hi - lo, 1e-8)
    img = _spectral(x).astype(np.uint8)
    img[~vm] = 0
    return img


# ---------------------------------------------------------------------------
# Optical-flow colorwheel (visualizer.py:483-595; Baker et al. wheel)
# ---------------------------------------------------------------------------

def make_colorwheel() -> np.ndarray:
    """55-color Middlebury flow wheel (visualizer.py:483-531)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col: col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col: col + YG, 1] = 255
    col += YG
    wheel[col: col + GC, 1] = 255
    wheel[col: col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col: col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col: col + CB, 2] = 255
    col += CB
    wheel[col: col + BM, 2] = 255
    wheel[col: col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col: col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col: col + MR, 0] = 255
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(u, v) -> uint8 colors (visualizer.py:533-570)."""
    flow_image = np.zeros((u.shape[0], u.shape[1], 3), np.uint8)
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(np.square(u) + np.square(v))
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for i in range(3):
        tmp = wheel[:, i]
        col0 = tmp[k0] / 255.0
        col1 = tmp[k1] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        flow_image[:, :, i] = np.floor(255 * col)
    return flow_image


def flow_to_image(flow_uv: np.ndarray, clip_flow: Optional[float] = None,
                  rad_max: Optional[float] = None) -> np.ndarray:
    """Flow [H,W,2] -> colorwheel uint8 image (visualizer.py:572-595)."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    if rad_max is None:
        rad_max = np.sqrt(np.square(u) + np.square(v)).max()
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps))


def visualize_optical_flow(flow: np.ndarray, max_flow: float = 512
                           ) -> np.ndarray:
    """[H,W,2] (or CHW) -> colorwheel image (visualizer.py:251-271)."""
    if flow.shape[0] == 2 and flow.ndim == 3 and flow.shape[-1] != 2:
        flow = flow.transpose(1, 2, 0)
    return flow_to_image(flow.astype(np.float32))


# ---------------------------------------------------------------------------
# Scene flow (XY angle/mag -> hue/sat, -Z -> value; visualizer.py:210-248)
# ---------------------------------------------------------------------------

def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(int) % 6
    out = np.zeros(hsv.shape, np.float32)
    for idx, (rr, gg, bb) in enumerate(
            [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]):
        m = i == idx
        out[..., 0][m] = rr[m]
        out[..., 1][m] = gg[m]
        out[..., 2][m] = bb[m]
    return out


def visualize_scene_flow(flow3: np.ndarray) -> np.ndarray:
    """[H,W,3] scene flow -> HSV-encoded uint8 image."""
    if flow3.shape[0] == 3 and flow3.ndim == 3 and flow3.shape[-1] != 3:
        flow3 = flow3.transpose(1, 2, 0)
    xy = flow3[..., :2]
    mag = np.linalg.norm(xy, axis=2)
    ang = np.arctan2(-xy[..., 1], -xy[..., 0])
    hsv = np.zeros((*xy.shape[:2], 3), np.float32)
    hsv[..., 0] = (ang + np.pi) / (2 * np.pi)
    hsv[..., 1] = np.clip((mag - mag.min())
                          / (mag.max() - mag.min() + 1e-6), 0, 1)
    z = -flow3[..., 2]
    hsv[..., 2] = np.clip((z - z.min()) / (z.max() - z.min() + 1e-6), 0, 1)
    return (_hsv_to_rgb(hsv) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Semantic (visualizer.py:52-107)
# ---------------------------------------------------------------------------

def map_class_to_color(class_id: np.ndarray,
                       class_colors: np.ndarray) -> np.ndarray:
    """[H,W] class ids -> uint8 color image via the palette; ids outside the
    palette (ignore_index) render black."""
    cid = class_id.squeeze().astype(np.int64)
    out = np.zeros((*cid.shape, 3), np.uint8)
    ok = (cid >= 0) & (cid < len(class_colors))
    out[ok] = class_colors[cid[ok]].astype(np.uint8)
    return out


def visualize_normal(normal: np.ndarray) -> np.ndarray:
    """[-1,1] normals -> uint8 ((1+n)/2, pipeline convention)."""
    if normal.shape[0] == 3 and normal.ndim == 3 and normal.shape[-1] != 3:
        normal = normal.transpose(1, 2, 0)
    return ((1 + np.clip(normal, -1, 1)) / 2 * 255).astype(np.uint8)
