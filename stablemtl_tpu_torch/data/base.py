"""Dataset protocol and base class (host-side, numpy, channels-last).

Rebuild of reference src/dataset/base_mtl_dataset.py with a
channels-last sample contract:

- Every TRAIN sample is a dict of HWC numpy arrays with the canonical keys
  `rgb_norm`, `rgb_next_norm` (always present; equals rgb_norm for
  single-frame tasks — implements the pipeline's 'duplicate' second-frame
  mode as data), `output` (normalized task GT), `valid_mask` [H,W,1] bool,
  and `output_type` (reference keys: base_mtl_dataset.py:26-29).
- EVAL samples additionally carry the raw GT fields each metric family needs
  (depth_raw_linear, optical_flow_raw, scene_flow, semantic_class_id,
  albedo, shading ...).
- All randomness is an explicit np.random.Generator argument to
  `get(index, rng)` — replayable from (seed, step), never global np.random.

Copy of `stablemtl_tpu/data/base.py`: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import os
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

from .augmentation import AugmentationConfig
from .io import RasterSource, read_rgb, rgb_to_norm


class DatasetMode(enum.Enum):
    RGB_ONLY = "rgb_only"
    EVAL = "evaluate"
    TRAIN = "train"


OUTPUT_FIELD = "output"
VALID_MASK_FIELD = "valid_mask"
OUTPUT_TYPE_FIELD = "output_type"

KB_CROP_HEIGHT = 352
KB_CROP_WIDTH = 1216


def kitti_benchmark_crop(img: np.ndarray) -> np.ndarray:
    """Bottom-center 352x1216 crop, HWC (reference dataset/utils.py:27-53)."""
    h, w = img.shape[:2]
    top = int(h - KB_CROP_HEIGHT)
    left = int((w - KB_CROP_WIDTH) / 2)
    return img[top: top + KB_CROP_HEIGHT, left: left + KB_CROP_WIDTH]


def eval_crop_mask(shape_hw: Tuple[int, int], kind: Optional[str]) -> np.ndarray:
    """garg/eigen evaluation crop mask (kitti_dataset.py:62-83)."""
    mask = np.zeros(shape_hw, bool)
    h, w = shape_hw
    if kind is None:
        mask[:] = True
    elif kind == "garg":
        mask[int(0.40810811 * h): int(0.99189189 * h),
             int(0.03594771 * w): int(0.96405229 * w)] = True
    elif kind == "eigen":
        mask[int(0.3324324 * h): int(0.91351351 * h),
             int(0.0359477 * w): int(0.96405229 * w)] = True
    else:
        raise ValueError(f"Unknown crop type: {kind}")
    return mask


def resize_nearest(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """NEAREST_EXACT-style resize of an HWC array (base_mtl_dataset.py:282-287)."""
    h, w = hw
    was_bool = arr.dtype == bool
    x = arr.astype(np.uint8) if was_bool else arr
    squeeze = x.ndim == 2
    out = cv2.resize(x, (w, h), interpolation=cv2.INTER_NEAREST_EXACT)
    if not squeeze and out.ndim == 2:
        out = out[..., None]
    return out.astype(bool) if was_bool else out


class DepthFileNameMode(enum.Enum):
    """Prediction file naming modes (base_mtl_dataset.py:32-38)."""

    id = 1        # id.png -> pred_id.png
    rgb_id = 2    # rgb_id.png -> pred_id.png
    i_d_rgb = 3   # i_d_1_rgb.png -> i_d_1_pred.png
    rgb_i_d = 4   # rgb_i_d.png -> pred_i_d.png


def get_pred_name(rgb_basename: str, name_mode: DepthFileNameMode,
                  suffix: str = ".png") -> str:
    """Prediction filename from the rgb filename
    (base_mtl_dataset.py:348-362)."""
    if name_mode == DepthFileNameMode.rgb_id:
        pred_basename = "pred_" + rgb_basename.split("_")[1]
    elif name_mode == DepthFileNameMode.i_d_rgb:
        pred_basename = rgb_basename.replace("_rgb.", "_pred.")
    elif name_mode == DepthFileNameMode.id:
        pred_basename = "pred_" + rgb_basename
    elif name_mode == DepthFileNameMode.rgb_i_d:
        pred_basename = "pred_" + "_".join(rgb_basename.split("_")[1:])
    else:
        raise NotImplementedError(name_mode)
    return os.path.splitext(pred_basename)[0] + suffix


class MTLDataset:
    """Base class: filename-list loading, raster source, shared helpers."""

    output_type: str = ""

    def __init__(
        self,
        mode: DatasetMode,
        filename_ls_path: str,
        dataset_dir: str,
        disp_name: str = "",
        min_depth: Optional[float] = None,
        max_depth: Optional[float] = None,
        resize_to_hw: Optional[Sequence[int]] = None,
        augmentation: Optional[AugmentationConfig] = None,
        depth_normalizer=None,
        output_type=None,
        **_unused,
    ):
        self.mode = mode
        # Config entries may request several eval tasks per dataset, e.g.
        # [depth, normal] for DIODE or [optical_flow, scene_flow] for
        # kitti_flow (reference dataset_test.yaml; eval loops over
        # dataset.output_type, stablemtl_trainer.py:650-660). Honor the
        # kwarg; fall back to the class default.
        if output_type is not None:
            self.output_type = list(output_type) \
                if isinstance(output_type, (list, tuple)) else output_type
        self.filename_ls_path = filename_ls_path
        self.dataset_dir = dataset_dir
        self.disp_name = disp_name or os.path.basename(dataset_dir)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.resize_to_hw = tuple(resize_to_hw) if resize_to_hw else None
        self.augmentation = augmentation or AugmentationConfig()
        self.depth_normalizer = depth_normalizer
        self.src = RasterSource(dataset_dir)
        with open(filename_ls_path) as f:
            self.filenames: List[List[str]] = [
                line.split() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.filenames)

    # -- helpers ---------------------------------------------------------

    def _rgb(self, rel_path: str) -> np.ndarray:
        return read_rgb(self.src, rel_path)

    def _depth_valid_mask(self, depth: np.ndarray) -> np.ndarray:
        """(min_depth, max_depth) range mask (base_mtl_dataset.py:214-222)."""
        return np.logical_and(depth > self.min_depth, depth < self.max_depth)

    @staticmethod
    def albedo_valid_mask(albedo: np.ndarray) -> np.ndarray:
        """Valid where all RGB >= 0.004 (base_mtl_dataset.py:224-247).
        albedo: HWC in [0,255] or [0,1]."""
        a = albedo / 255.0 if albedo.max() > 1.0 else albedo
        invalid = np.any(a < 0.004, axis=2)
        return (~invalid)[..., None]

    def _finalize(self, sample: dict) -> dict:
        """Resize, duplicate-frame fill, dtype hygiene.

        resize_to_hw applies in EVERY mode (reference
        base_mtl_dataset.py:280-287 resizes the whole raster dict
        mode-independently with NEAREST_EXACT)."""
        if self.resize_to_hw is not None:
            for k, v in list(sample.items()):
                if isinstance(v, np.ndarray) and v.ndim >= 2:
                    sample[k] = resize_nearest(v, self.resize_to_hw)
        # duplicate-frame fill AFTER the resize: the evaluator detects
        # single-frame datasets by `rgb_next_norm is rgb_norm` (one-encode
        # fast path) and a per-key resize would break the alias.
        if "rgb_next_norm" not in sample and "rgb_norm" in sample:
            sample["rgb_next_norm"] = sample["rgb_norm"]
        return sample

    # -- protocol --------------------------------------------------------

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng(index)
        sample = self._get_data_item(index, rng)
        sample.setdefault(OUTPUT_TYPE_FIELD, self.output_type)
        sample.setdefault("index", index)
        return self._finalize(sample)

    def __getitem__(self, index: int) -> dict:
        return self.get(index)

    def _get_data_item(self, index: int, rng) -> dict:
        raise NotImplementedError
