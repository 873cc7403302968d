"""Per-sample GT normalizers (host-side, numpy).

These run inside the data pipeline on the host — per-image quantiles and
max-abs statistics are data-dependent, so they stay out of the device
graph by design.

Behavioral parity:
- depth: 2%/98%-quantile scale-shift to [norm_min, norm_max] with clipping
  (reference src/util/depth_transform.py:50-105)
- optical flow: per-channel max-abs divide with quantile guard
  (reference src/util/optical_flow_transform.py:47-111)
- scene/optical flow "hw" and "norm" modes
  (reference src/util/alignment.py:6-44)

Copy of `stablemtl_tpu/utils/normalizers.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


class ScaleShiftDepthNormalizer:
    """Linearly map per-image [q, 1-q] depth quantiles to [norm_min, norm_max]."""

    is_absolute = False
    far_plane_at_max = True

    def __init__(self, norm_min=-1.0, norm_max=1.0, min_max_quantile=0.02, clip=True):
        self.norm_min = float(norm_min)
        self.norm_max = float(norm_max)
        self.norm_range = self.norm_max - self.norm_min
        self.min_quantile = float(min_max_quantile)
        self.max_quantile = 1.0 - self.min_quantile
        self.clip = clip

    def __call__(self, depth: np.ndarray, valid_mask: np.ndarray | None = None,
                 clip: bool | None = None) -> np.ndarray:
        clip = self.clip if clip is None else clip
        if valid_mask is None:
            valid_mask = np.ones_like(depth, dtype=bool)
        valid_mask = valid_mask & (depth > 0)
        # torch.quantile uses linear interpolation on float32 — numpy's
        # default interpolation matches; stay in f32 like the reference.
        lo, hi = np.quantile(
            depth[valid_mask].astype(np.float32, copy=False),
            [self.min_quantile, self.max_quantile],
        )
        out = (depth - lo) / (hi - lo) * self.norm_range + self.norm_min
        if clip:
            out = np.clip(out, self.norm_min, self.norm_max)
        return out.astype(depth.dtype, copy=False)

    def scale_back(self, depth_norm: np.ndarray) -> np.ndarray:
        return (depth_norm - self.norm_min) / self.norm_range

    def denormalize(self, depth_norm: np.ndarray, **_) -> np.ndarray:
        return self.scale_back(depth_norm)


class ScaleShiftOpticalFlowNormalizer:
    """Per-channel max-abs normalization of a [2,H,W] flow to [-1,1]."""

    def __init__(self, norm_min=-1.0, norm_max=1.0, min_max_quantile=0.0, clip=True):
        self.norm_min = float(norm_min)
        self.norm_max = float(norm_max)
        self.norm_range = self.norm_max - self.norm_min
        self.min_quantile = float(min_max_quantile)
        self.max_quantile = 1.0 - self.min_quantile
        self.clip = clip

    def __call__(self, flow: np.ndarray, valid_mask: np.ndarray | None = None,
                 clip: bool | None = None) -> np.ndarray:
        assert flow.ndim == 3 and flow.shape[0] == 2, flow.shape
        clip = self.clip if clip is None else clip
        _, H, W = flow.shape
        if valid_mask is None:
            mask = np.ones((H, W), dtype=bool)
        else:
            mask = np.asarray(valid_mask).reshape(H, W).astype(bool)

        out = np.zeros_like(flow)
        for c in range(2):
            vals = flow[c][mask].astype(np.float64)
            lo, hi = np.quantile(vals, [self.min_quantile, self.max_quantile])
            max_abs = max(abs(lo), abs(hi))
            # sign-preserving divide (keeps h/v-flip sign flips consistent,
            # see reference optical_flow_transform.py:96-99)
            out[c] = flow[c] / max_abs
        if clip:
            out = np.clip(out, self.norm_min, self.norm_max)
        return out

    def scale_back(self, flow_norm: np.ndarray) -> np.ndarray:
        return (flow_norm - self.norm_min) / self.norm_range


def _normalize_flow_channels(flow: np.ndarray, n_ch: int, mode: str,
                             channel_axis: int) -> np.ndarray:
    assert mode in ("hw", "norm")
    out = np.array(flow, copy=True)
    mov = np.moveaxis(out, channel_axis, 0)
    src = np.moveaxis(flow, channel_axis, 0)
    if mode == "hw":
        for c in range(n_ch):
            m = max(abs(float(src[c].max())), abs(float(src[c].min())))
            if m > 0:
                mov[c] = src[c] / m
    else:
        m = float(np.linalg.norm(src, axis=0).max())
        if m > 0:
            mov[:] = src / m
    return out


def normalize_optical_flow(flow: np.ndarray, mode: str = "hw",
                           channel_axis: int = 0) -> np.ndarray:
    """Max-abs per-channel ('hw') or global-norm ('norm') flow normalization.

    Parity with reference alignment.py:28-44. Channels with all-zero flow are
    left unscaled. channel_axis=0 matches the reference CHW layout; the data
    pipeline passes channel_axis=-1 (HWC).
    """
    return _normalize_flow_channels(flow, 2, mode, channel_axis)


def normalize_scene_flow(scene_flow: np.ndarray, mode: str = "hw",
                         channel_axis: int = 0) -> np.ndarray:
    """Same as optical flow but over 3 channels (reference alignment.py:6-26)."""
    return _normalize_flow_channels(scene_flow, 3, mode, channel_axis)


def get_depth_normalizer(cfg) -> ScaleShiftDepthNormalizer:
    if cfg is None:
        return lambda x, **k: x
    assert cfg["type"] == "scale_shift_depth", cfg
    return ScaleShiftDepthNormalizer(
        norm_min=cfg["norm_min"], norm_max=cfg["norm_max"],
        min_max_quantile=cfg["min_max_quantile"], clip=cfg["clip"],
    )


def get_optical_flow_normalizer(cfg) -> ScaleShiftOpticalFlowNormalizer:
    if cfg is None:
        return lambda x, **k: x
    assert cfg["type"] == "scale_shift_optical_flow", cfg
    return ScaleShiftOpticalFlowNormalizer(
        norm_min=cfg["norm_min"], norm_max=cfg["norm_max"],
        min_max_quantile=cfg["min_max_quantile"], clip=cfg["clip"],
    )
