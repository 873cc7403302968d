"""Host-side joint augmentations (numpy, channels-last HWC).

Behavioral parity with reference src/dataset/augmentation.py
and flow_augmentation.py, redesigned for a host-side data pipeline:

- All randomness flows through an explicit np.random.Generator (derived from
  the step-indexed seed), not global np.random — augmentation is replayable
  from (base_seed, step) alone, like the training step's randomness.
- Everything stays HWC numpy (the NHWC device layout) — no CHW transposes.
- Sign rules under flips: normal.x *= -1 on lr / normal.y *= -1 on ud
  (augmentation.py:8-20); flow.u *= -1 on lr / flow.v *= -1 on ud
  (flow_augmentation.py:52-65, 435-443). Depth/semantic/albedo/shading flip
  plainly.
- Color jitter reimplements torchvision.transforms.ColorJitter semantics
  (random op order, uniform factor ranges, paired-frame consistency for
  two-frame tasks, flow_augmentation.py:7-17).
- Sparse-flow-aware rescale: crop + nearest scatter resize that preserves
  flow sparsity (resize_sparse_flow_map, flow_augmentation.py:168-196).

Copy of `stablemtl_tpu/data/augmentation.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import cv2
import numpy as np


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColorJitterConfig:
    enabled: bool = False
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0


@dataclasses.dataclass(frozen=True)
class AugmentationConfig:
    enabled: bool = False
    color_jitter: ColorJitterConfig = ColorJitterConfig()
    lr_flip: bool = False
    ud_flip: bool = False
    random_crop: Optional[Tuple[int, int]] = None      # (w, h)
    random_scale: Optional[Tuple[float, float]] = None  # (lo, hi), lo >= 1

    @staticmethod
    def from_dict(d) -> "AugmentationConfig":
        """Build from a reference-style nested config mapping."""
        if d is None:
            return AugmentationConfig()
        get = lambda k, default=None: d.get(k, default) if hasattr(d, "get") \
            else getattr(d, k, default)
        cj = get("color_jitter")
        cjc = ColorJitterConfig()
        if cj is not None and (cj.get("enabled", False) if hasattr(cj, "get")
                               else getattr(cj, "enabled", False)):
            g = lambda k: cj.get(k, 0.0) if hasattr(cj, "get") else \
                getattr(cj, k, 0.0)
            cjc = ColorJitterConfig(True, g("brightness"), g("contrast"),
                                    g("saturation"), g("hue"))

        def flag(key):
            v = get(key)
            if v is None:
                return False
            return v.get("enabled", False) if hasattr(v, "get") else \
                getattr(v, "enabled", False)

        def sub(node, key, default=None):
            if node is None:
                return default
            return node.get(key, default) if hasattr(node, "get") else \
                getattr(node, key, default)

        crop = get("random_crop")
        crop_size = tuple(sub(crop, "crop_size")) \
            if sub(crop, "enabled", False) else None
        scale = get("random_scale")
        scale_range = tuple(sub(scale, "scale_range")) \
            if sub(scale, "enabled", False) else None
        return AugmentationConfig(
            enabled=bool(get("enabled", False)), color_jitter=cjc,
            lr_flip=flag("random_horizontal_flip"),
            ud_flip=flag("random_vertical_flip"),
            random_crop=crop_size, random_scale=scale_range)


# ---------------------------------------------------------------------------
# Flips
# ---------------------------------------------------------------------------

def flip_image(img: np.ndarray, mode: str) -> np.ndarray:
    return np.fliplr(img).copy() if mode == "lr" else np.flipud(img).copy()


def flip_normal(normal, valid_mask, mode):
    """Flip + sign rule: x *= -1 (lr) / y *= -1 (ud) (augmentation.py:8-20)."""
    normal = flip_image(normal, mode)
    normal[..., 0 if mode == "lr" else 1] *= -1
    if valid_mask is not None:
        valid_mask = flip_image(valid_mask, mode)
    return normal, valid_mask


def flip_flow(flow, mode, valid_mask=None):
    """Flip + sign rule: u *= -1 (lr) / v *= -1 (ud); z untouched for scene
    flow (flow_augmentation.py:52-65,435-443)."""
    flow = flip_image(flow, mode)
    flow[..., 0 if mode == "lr" else 1] *= -1
    if valid_mask is not None:
        valid_mask = flip_image(valid_mask, mode)
    return flow, valid_mask


# ---------------------------------------------------------------------------
# Color jitter (torchvision-equivalent, numpy)
# ---------------------------------------------------------------------------

def _blend(a, b, alpha):
    """alpha*a + (1-alpha)*b via SIMD when shapes match."""
    if isinstance(b, np.ndarray) and b.shape == a.shape:
        return cv2.addWeighted(a, alpha, b, 1.0 - alpha, 0.0)
    return alpha * a + (1.0 - alpha) * b


def _rgb_to_gray(img):
    # torchvision rgb_to_grayscale weights (ITU-R 601)
    g = cv2.transform(img, np.array([[0.2989, 0.587, 0.114]], np.float32))
    return g[..., None] if g.ndim == 2 else g


def _adjust_hue(img01, factor):
    """Shift hue by `factor` (in turns, [-0.5, 0.5]) via HSV round trip."""
    hsv = cv2.cvtColor(img01.astype(np.float32), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0] + factor * 360.0) % 360.0
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def color_jitter(images_u8, cfg: ColorJitterConfig, rng: np.random.Generator):
    """Jitter one or more uint8 HWC images with ONE sampled transform.

    `images_u8`: array [H, W, 3] or list of arrays — all receive identical
    factors (paired-frame consistency, flow_augmentation.py:7-17 /
    base_mtl_dataset.py:318-335).
    """
    single = isinstance(images_u8, np.ndarray)
    imgs = [images_u8] if single else list(images_u8)

    ops = []
    if cfg.brightness > 0:
        lo, hi = max(0.0, 1 - cfg.brightness), 1 + cfg.brightness
        b = rng.uniform(lo, hi)
        ops.append(("b", b))
    if cfg.contrast > 0:
        lo, hi = max(0.0, 1 - cfg.contrast), 1 + cfg.contrast
        ops.append(("c", rng.uniform(lo, hi)))
    if cfg.saturation > 0:
        lo, hi = max(0.0, 1 - cfg.saturation), 1 + cfg.saturation
        ops.append(("s", rng.uniform(lo, hi)))
    if cfg.hue > 0:
        ops.append(("h", rng.uniform(-cfg.hue, cfg.hue)))
    order = rng.permutation(len(ops))

    # The reference concatenates a frame pair and applies ONE ColorJitter
    # to the stacked image (flow_augmentation.py:7-17): the contrast op's
    # grayscale mean is computed over BOTH frames together. Per-frame
    # means would blend the two frames toward different anchors — a
    # constant intensity offset between images the model matches pixels
    # across.
    joint = len(imgs) > 1 and all(i.shape == imgs[0].shape for i in imgs)
    work = [np.concatenate(imgs, axis=0)] if joint else imgs

    out = []
    for img in work:
        x = img.astype(np.float32) / 255.0
        for i in order:
            kind, f = ops[i]
            if kind == "b":
                x = np.clip(f * x, 0, 1)
            elif kind == "c":
                mean = float(_rgb_to_gray(x).mean())
                x = np.clip(_blend(x, mean, f), 0, 1)
            elif kind == "s":
                gray = np.repeat(_rgb_to_gray(x), 3, axis=-1)
                x = np.clip(_blend(x, gray, f), 0, 1)
            else:
                x = np.clip(_adjust_hue(x, f), 0, 1)
        out.append((x * 255.0).astype(np.uint8))
    if joint:
        h = imgs[0].shape[0]
        out = [out[0][i * h:(i + 1) * h] for i in range(len(imgs))]
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Sparse-flow resize / crop / scale
# ---------------------------------------------------------------------------

def resize_sparse_flow_map(flow, valid_mask, target_w, target_h):
    """Sparsity-preserving flow resize by nearest scatter
    (flow_augmentation.py:168-196). flow [H,W,2], valid_mask [H,W,1]."""
    curr_h, curr_w = flow.shape[:2]
    coords = np.stack(np.meshgrid(np.arange(curr_w), np.arange(curr_h)),
                      axis=-1).astype(np.float32)
    mask = valid_mask.squeeze(-1).astype(bool)
    coords0, flow0 = coords[mask], flow[mask][:, :2]

    srw = (target_w - 1) / (curr_w - 1)
    srh = (target_h - 1) / (curr_h - 1)
    coords1 = coords0 * [srw, srh]
    flow1 = flow0 * [srw, srh]

    xx = np.round(coords1[:, 0]).astype(np.int32)
    yy = np.round(coords1[:, 1]).astype(np.int32)
    ok = (xx >= 0) & (xx < target_w) & (yy >= 0) & (yy < target_h)
    xx, yy, flow1 = xx[ok], yy[ok], flow1[ok]

    flow_resized = np.zeros([target_h, target_w, 2], np.float32)
    flow_resized[yy, xx] = flow1
    mask_resized = np.zeros([target_h, target_w], bool)
    mask_resized[yy, xx] = True
    return flow_resized, mask_resized[..., None]


def _random_crop_window(rng, image_hw, crop_wh):
    crop_w, crop_h = crop_wh
    h, w = image_hw
    assert crop_w <= w and crop_h <= h, (crop_wh, image_hw)
    x1 = rng.integers(0, w - crop_w + 1)
    y1 = rng.integers(0, h - crop_h + 1)
    return x1, y1, x1 + crop_w, y1 + crop_h


def crop_all(arrays, window):
    x1, y1, x2, y2 = window
    return [None if a is None else a[y1:y2, x1:x2].copy() for a in arrays]


# ---------------------------------------------------------------------------
# Joint task augmentations (reference entry points)
# ---------------------------------------------------------------------------

def _maybe(rng):
    return rng.random() < 0.5


def joint_single_frame_augmentation(img, gt, valid_mask,
                                    cfg: AugmentationConfig,
                                    rng: np.random.Generator,
                                    gt_kind: str):
    """Shared path for depth/normal/semseg/albedo/shading
    (augmentation.py: joint_{depth,normal,semseg,albedo_or_shading}_*).

    gt_kind: 'normal' applies the normal sign rule on flips; 'plain'
    flips GT like an image. Color jitter applies to the RGB only.
    """
    if not cfg.enabled:
        return img, gt, valid_mask
    if cfg.color_jitter.enabled:
        img = color_jitter(img, cfg.color_jitter, rng)
    for mode, on in (("ud", cfg.ud_flip), ("lr", cfg.lr_flip)):
        if on and _maybe(rng):
            img = flip_image(img, mode)
            if gt_kind == "normal":
                gt, valid_mask = flip_normal(gt, valid_mask, mode)
            else:
                gt = flip_image(gt, mode)
                valid_mask = flip_image(valid_mask, mode)
    return img, gt, valid_mask


def joint_depth_augmentation(img, depth, mask, cfg, rng):
    return joint_single_frame_augmentation(img, depth, mask, cfg, rng, "plain")


def joint_normal_augmentation(img, normal, mask, cfg, rng):
    return joint_single_frame_augmentation(img, normal, mask, cfg, rng,
                                           "normal")


def joint_semseg_augmentation(img, semseg, mask, cfg, rng):
    return joint_single_frame_augmentation(img, semseg, mask, cfg, rng,
                                           "plain")


def joint_albedo_or_shading_augmentation(img, x, mask, cfg, rng):
    # reference applies no color jitter here (augmentation.py:249-263)
    cfg2 = dataclasses.replace(cfg, color_jitter=ColorJitterConfig())
    return joint_single_frame_augmentation(img, x, mask, cfg2, rng, "plain")


def joint_optical_flow_augmentation(img1, img2, flow, mask, cfg, rng):
    """Parity: flow_augmentation.py:397-433 (jitter, flips, crop, scale)."""
    if not cfg.enabled:
        return img1, img2, flow, mask
    if cfg.color_jitter.enabled:
        img1, img2 = color_jitter([img1, img2], cfg.color_jitter, rng)
    for mode, on in (("lr", cfg.lr_flip), ("ud", cfg.ud_flip)):
        if on and _maybe(rng):
            img1, img2 = flip_image(img1, mode), flip_image(img2, mode)
            flow, mask = flip_flow(flow, mode, mask)
    if cfg.random_crop is not None:
        win = _random_crop_window(rng, img1.shape[:2], cfg.random_crop)
        img1, img2, flow, mask = crop_all([img1, img2, flow, mask], win)
    if cfg.random_scale is not None and _maybe(rng):
        lo, hi = cfg.random_scale
        ratio = rng.uniform(lo, hi)
        h, w = img1.shape[:2]
        ch, cw = int(h / ratio), int(w / ratio)
        win = _random_crop_window(rng, (h, w), (cw, ch))
        img1, img2, flow, mask = crop_all([img1, img2, flow, mask], win)
        img1 = cv2.resize(img1, (w, h), interpolation=cv2.INTER_LINEAR)
        img2 = cv2.resize(img2, (w, h), interpolation=cv2.INTER_LINEAR)
        flow, mask = resize_sparse_flow_map(flow, mask, w, h)
    return img1, img2, flow, mask


def joint_scene_flow_augmentation(img1, img2, flow3d, mask, cfg, rng):
    """Parity: flow_augmentation.py:461-485 (jitter + flips; z preserved)."""
    if not cfg.enabled:
        return img1, img2, flow3d, mask
    if cfg.color_jitter.enabled:
        img1, img2 = color_jitter([img1, img2], cfg.color_jitter, rng)
    for mode, on in (("lr", cfg.lr_flip), ("ud", cfg.ud_flip)):
        if on and _maybe(rng):
            img1, img2 = flip_image(img1, mode), flip_image(img2, mode)
            flow3d, mask = flip_flow(flow3d, mode, mask)
    return img1, img2, flow3d, mask
