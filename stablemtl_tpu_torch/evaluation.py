"""Per-task evaluation: postprocessing of a decoded prediction, alignment,
metrics and the dataset `Evaluator`. Counterpart of
`stablemtl_tpu/evaluation.py`; everything here is host-side numpy, fed by
an inference function that returns numpy arrays.

- depth, shading: the decoded channels' mean mapped [-1, 1] -> [0, 1]
- albedo: the 3 channels mapped [-1, 1] -> [0, 1]
- normal: per-pixel L2 normalization of the decoded 3-vector
- optical / scene flow: the decoded channels, in [-1, 1]
- semantic: the nearest palette color's class id

Evaluation: depth is aligned by least-squares scale and shift, clipped to
the dataset's [min_depth, max_depth]; flow is resized bilinearly to the GT
and aligned by a per-channel non-negative scale; albedo and shading
metrics match scale themselves. OpenCV is imported only to resize a flow
or albedo prediction, the data layer only by `evaluate_sample`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from .pipeline import TASK_INDEX
from .utils.alignment import align_depth_least_square, align_flow_least_square
from .utils.metrics import MetricTracker
from .utils.metrics.albedo_shading import AlbedoAndShadingMetrics
from .utils.metrics.depth import (
    abs_relative_difference,
    delta1_acc,
    delta2_acc,
    delta3_acc,
    i_rmse,
    log10,
    rmse_linear,
    rmse_log,
    silog_rmse,
    squared_relative_difference,
)
from .utils.metrics.flow import OpticalFlowMetrics, SceneFlowMetrics
from .utils.metrics.normal import mean_angular_error
from .utils.metrics.semantic import SemanticMetrics

DEPTH_METRIC_FUNCS = (
    abs_relative_difference, squared_relative_difference, rmse_linear,
    rmse_log, log10, delta1_acc, delta2_acc, delta3_acc, i_rmse, silog_rmse,
)


def make_task_metrics(n_semantic_classes: int = 8) -> Dict[str, object]:
    """One metric aggregator per task (reference trainer:594-602)."""
    return {
        "depth": MetricTracker(*[f.__name__ for f in DEPTH_METRIC_FUNCS]),
        "normal": MetricTracker("mean_angular_error"),
        "semantic": SemanticMetrics(n_semantic_classes),
        "optical_flow": OpticalFlowMetrics(),
        "scene_flow": SceneFlowMetrics(),
        "albedo": AlbedoAndShadingMetrics(),
        "shading": AlbedoAndShadingMetrics(),
    }


def decode_3ch_to_task(img3: np.ndarray, task: str) -> np.ndarray:
    """Decoded 3-channel map [..., H, W, 3] -> the task's channels (numpy;
    `pipeline.decode_3ch_to_task` is the torch form)."""
    if task in ("depth", "shading"):
        return img3.mean(axis=-1, keepdims=True)
    if task == "optical_flow":
        return img3[..., :2]
    if task in ("normal", "semantic", "rgb", "scene_flow", "albedo"):
        return img3
    raise ValueError(f"Unknown output type: {task}")


def postprocess_prediction(task: str, pred3: np.ndarray,
                           class_colors: Optional[np.ndarray] = None):
    """Decoded, clipped [-1, 1] 3-channel map [H, W, 3] -> the task-space
    prediction."""
    out = decode_3ch_to_task(pred3, task)
    if task in ("depth", "shading", "albedo"):
        return (out + 1.0) / 2.0
    if task == "normal":
        norm = np.linalg.norm(out, axis=-1, keepdims=True)
        norm[norm == 0] = 1.0
        return out / norm
    if task in ("optical_flow", "scene_flow"):
        return out
    if task == "semantic":
        if class_colors is None:
            raise ValueError("semantic postprocessing needs class_colors")
        colors = class_colors.astype(np.float32) / 255.0 * 2.0 - 1.0
        d2 = ((out[..., None, :] - colors) ** 2).sum(-1)
        return np.argmin(d2, axis=-1)
    raise ValueError(task)


GT_FIELD = {"depth": "depth_raw_linear", "normal": "normal",
            "semantic": "semantic_class_id",
            "optical_flow": "optical_flow_raw", "scene_flow": "scene_flow",
            "albedo": "albedo", "shading": "shading"}


def visualize_gt(task: str, sample: dict,
                 class_colors: Optional[np.ndarray] = None):
    """GT raster -> uint8 [H, W, 3] visualization in the prediction's
    colormap family (for side-by-side panels), or None without GT."""
    from .predict import _visualize

    gt = sample.get(GT_FIELD[task])
    if gt is None:
        return None
    gt = np.asarray(gt)
    if task == "semantic":
        gt = gt[..., 0] if gt.ndim == 3 else gt
    elif task == "depth":
        gt = gt[..., 0] if gt.ndim == 3 else gt
        lo, hi = np.percentile(gt[gt > 0], [2, 98]) if (gt > 0).any() \
            else (0.0, 1.0)
        gt = np.clip((gt - lo) / max(hi - lo, 1e-6), 0, 1)
    return _visualize(task, gt, class_colors)


def _resize_bilinear(arr: np.ndarray, hw) -> np.ndarray:
    if arr.shape[:2] == tuple(hw):
        return arr
    import cv2

    out = cv2.resize(arr, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    return out[..., None] if out.ndim == 2 and arr.ndim == 3 else out


def evaluate_sample(task: str, pred, sample: dict, metrics,
                    min_depth: float = 1e-5, max_depth: float = 80.0,
                    align_max_res: Optional[int] = None) -> None:
    """Align and update `metrics` for ONE sample (batch dims added
    here)."""
    from .data.base import VALID_MASK_FIELD

    if task == "depth":
        gt = sample["depth_raw_linear"].squeeze(-1)
        mask = sample[VALID_MASK_FIELD].squeeze(-1).astype(bool)
        dp = pred.squeeze(-1)
        dp, _, _ = align_depth_least_square(
            gt_arr=gt, pred_arr=dp, valid_mask_arr=mask,
            return_scale_shift=True, max_resolution=align_max_res)
        dp = np.clip(dp, min_depth, max_depth)
        dp = np.clip(dp, 1e-6, None)
        for fn in DEPTH_METRIC_FUNCS:
            metrics.update(fn.__name__, float(fn(dp, gt, mask)))
    elif task == "normal":
        # the metric takes channel-first [B, 3, H, W]; samples are HWC
        gt = sample["normal"]
        mask = sample.get("normal_valid_mask", sample.get(VALID_MASK_FIELD))
        metrics.update("mean_angular_error", float(mean_angular_error(
            _chw(pred)[None], _chw(gt)[None], _chw(mask)[None])))
    elif task == "semantic":
        gt = sample["semantic_class_id"].squeeze(-1)
        mask = sample[VALID_MASK_FIELD].squeeze(-1)
        metrics.update(gt[None], pred[None], mask[None])
    elif task in ("optical_flow", "scene_flow"):
        key = "optical_flow_raw" if task == "optical_flow" else "scene_flow"
        gt = sample[key]
        mask = sample[VALID_MASK_FIELD] if task == "optical_flow" else \
            sample.get("scene_flow_valid_mask", sample[VALID_MASK_FIELD])
        fp = _resize_bilinear(pred, gt.shape[:2])
        aligned = align_flow_least_square(
            gt_arr=_chw(gt), pred_arr=_chw(fp),
            valid_mask_arr=mask.squeeze(-1), return_scale_shift=False)
        metrics.update(aligned[None], _chw(gt)[None], _chw(mask)[None])
    elif task in ("albedo", "shading"):
        gt = sample[task]
        mask = sample.get(f"{task}_valid_mask", sample[VALID_MASK_FIELD])
        fp = _resize_bilinear(pred, gt.shape[:2])
        if fp.ndim == 2:
            fp = fp[..., None]
        metrics.update(_chw(fp)[None], _chw(gt)[None], _chw(mask)[None])
    else:
        raise ValueError(task)


def _chw(x: np.ndarray) -> np.ndarray:
    """HWC -> CHW (the metric and alignment functions' layout)."""
    if x.ndim != 3:
        raise ValueError(f"expected an HWC array, got shape {x.shape}")
    return np.transpose(x, (2, 0, 1))


@dataclasses.dataclass
class Evaluator:
    """Runs a dataset through an inference function and aggregates the
    per-task metrics.

    infer_fn(rgb_norm [B, H, W, 3], rgb_next_norm or None, task_idx) ->
    numpy [B, H, W, 3], the decoded clipped prediction.
    infer_tasks_fn(rgb, rgb_next or None, task_indices [K]) -> numpy
    [K, B, H, W, 3]: with it, a multi-task dataset shares one VAE encode
    and the child taps across its tasks.

    Samples of equal geometry are batched `batch_size` at a time, and the
    last batch is padded with copies of its last sample to the same shape.
    A batch of single-frame samples (rgb_next_norm IS rgb_norm, as the data
    layer sets it) is passed with rgb_next None: one encode.
    """

    infer_fn: Callable
    class_colors: Optional[np.ndarray] = None
    align_max_res: Optional[int] = None
    batch_size: int = 1
    infer_tasks_fn: Optional[Callable] = None

    def evaluate(self, dataset, tasks=None, max_samples: Optional[int] = None,
                 metrics: Optional[dict] = None) -> Dict[str, dict]:
        tasks = tasks or dataset.output_type
        if isinstance(tasks, str):
            tasks = [tasks]
        tasks = list(tasks)
        metrics = metrics or make_task_metrics()
        for t in tasks:
            metrics[t].reset()
        n = len(dataset) if max_samples is None else min(len(dataset),
                                                         max_samples)
        for samples in self._chunks(dataset, n):
            pad = max(self.batch_size - len(samples), 0)
            rgb = np.stack([s["rgb_norm"] for s in samples]
                           + [samples[-1]["rgb_norm"]] * pad)
            if all(s["rgb_next_norm"] is s["rgb_norm"] for s in samples):
                rgb_next = None
            else:
                rgb_next = np.stack([s["rgb_next_norm"] for s in samples]
                                    + [samples[-1]["rgb_next_norm"]] * pad)
            per_task = self._infer(rgb, rgb_next, tasks)
            for j, sample in enumerate(samples):
                for task in tasks:
                    pred = postprocess_prediction(
                        task, per_task[task][j], self.class_colors)
                    evaluate_sample(
                        task, pred, sample, metrics[task],
                        min_depth=dataset.min_depth or 1e-5,
                        max_depth=dataset.max_depth or 80.0,
                        align_max_res=self.align_max_res)
        return {t: metrics[t].result() for t in tasks}

    def _infer(self, rgb, rgb_next, tasks) -> Dict[str, np.ndarray]:
        if self.infer_tasks_fn is not None and len(tasks) > 1:
            idx = np.asarray([TASK_INDEX[t] for t in tasks], np.int32)
            preds = np.asarray(self.infer_tasks_fn(rgb, rgb_next, idx))
            return {t: preds[k] for k, t in enumerate(tasks)}
        return {t: np.asarray(self.infer_fn(
            rgb, rgb_next, np.asarray(TASK_INDEX[t], np.int32)))
            for t in tasks}

    def _chunks(self, dataset, n: int):
        """Greedy batches of consecutive same-geometry samples."""
        buf = []
        for i in range(n):
            s = dataset.get(i, np.random.default_rng(i))
            if buf and (s["rgb_norm"].shape != buf[-1]["rgb_norm"].shape
                        or len(buf) >= self.batch_size):
                yield buf
                buf = []
            buf.append(s)
        if buf:
            yield buf
