"""Image helpers, counterpart of `stablemtl_tpu/utils/image_util.py`:
host-side resizing (OpenCV is imported only when a resize is asked for:
the serving path runs without it at the pipeline's own resolution),
`chw2hwc` and the multi-resolution noise."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


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


def chw2hwc(img: np.ndarray) -> np.ndarray:
    """[C, H, W] -> [H, W, C]."""
    return np.transpose(img, (1, 2, 0))


def _octaves(h: int, w: int, strength: float, strategy: str, host):
    """(rows, cols, weight) of each octave, with the reference's cumulative
    shrinking of (h, w) across octaves (multi_res_noise.py:24-33)."""
    out = []
    if strategy == "every_layer":
        for i in range(int(math.log2(min(h, w)))):
            h, w = max(1, h // 2), max(1, w // 2)
            out.append((h, w, strength ** i))
        return out
    if strategy not in ("original", "power_of_two", "random_step"):
        raise ValueError(f"unknown downscale strategy: {strategy}")
    for i in range(10):
        if strategy == "power_of_two":
            r = 2.0 ** i
        else:
            r = host.uniform() * 2 + 2  # a random divisor in [2, 4)
            r = r if strategy == "random_step" else r ** i
        h, w = max(1, int(h / r)), max(1, int(w / r))
        out.append((h, w, strength ** i))
        if h == 1 or w == 1:
            break
    return out


def multi_res_noise_like(generator: torch.Generator, x,
                         strength: float = 0.9,
                         downscale_strategy: str = "original"):
    """Pyramid noise with per-octave downscaling (the reference's
    multi_res_noise.py:9-75), x [B, H, W, C] (NHWC) -> unit-variance f32
    noise of x's shape on x's device. Every draw comes from `generator`
    (on x's device): the base noise, a seed for the host RNG that picks the
    octaves' sizes (data-dependent shapes, as in the reference), then each
    octave's noise, upsampled bilinearly. The draws agree with the JAX
    package's in distribution, not draw for draw."""
    b, h, w, c = x.shape
    kw = dict(generator=generator, device=x.device, dtype=torch.float32)
    noise = torch.randn(x.shape, **kw)
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=x.device))
    octaves = _octaves(h, w, strength, downscale_strategy,
                       np.random.default_rng(seed))
    for nh, nw, weight in octaves:
        small = torch.randn((b, c, nh, nw), **kw)
        up = F.interpolate(small, size=(h, w), mode="bilinear",
                           align_corners=False)
        noise = noise + up.permute(0, 2, 3, 1) * weight
    return noise / noise.std(correction=0)
