"""Host-side image resizing, counterpart of
`stablemtl_tpu/utils/image_util.py::resize_max_res`. OpenCV is imported
only when a resize is asked for: the serving path runs without it at the
pipeline's own resolution."""

from __future__ import annotations

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("resizing images needs OpenCV (cv2); serve at "
                          "the images' own resolution without it") from e
    return cv2


def resize(img: np.ndarray, hw, interpolation: str = "area") -> np.ndarray:
    """HWC image -> (H, W) with OpenCV's 'area' or 'linear'
    interpolation."""
    cv2 = _cv2()
    flag = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR}[interpolation]
    out = cv2.resize(img, (int(hw[1]), int(hw[0])), interpolation=flag)
    return out[..., None] if out.ndim == 2 and img.ndim == 3 else out


def resize_max_res(img: np.ndarray, max_edge_resolution: int,
                   interpolation: str | None = None) -> np.ndarray:
    """Resize an HWC image so its longer edge is max_edge_resolution,
    keeping the aspect: 'area' (antialiased) when shrinking, 'linear' when
    enlarging, unless `interpolation` says otherwise."""
    h, w = img.shape[:2]
    scale = min(max_edge_resolution / w, max_edge_resolution / h)
    if interpolation is None:
        interpolation = "area" if scale < 1.0 else "linear"
    return resize(img, (int(h * scale), int(w * scale)), interpolation)
