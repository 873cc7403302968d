"""User-facing prediction API, counterpart of `stablemtl_tpu/predict.py`:
a uint8 (or [-1, 1] float) HWC image in, optionally resized so its longer
edge is `processing_res`, one task (or all 7 from one fused step) out, as
a task-space numpy map and a uint8 visualization, resized back to the
input's size. Inference runs on the pipeline's device; the maps come back
to the host as float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import TASKS
from .evaluation import postprocess_prediction
from .utils.image_util import resize, resize_max_res
from .utils.visualizer import (colorize_depth, map_class_to_color,
                               visualize_normal, visualize_optical_flow,
                               visualize_scene_flow)


@dataclasses.dataclass
class Prediction:
    task: str
    output: np.ndarray          # task-space map (postprocess_prediction)
    visualization: np.ndarray   # uint8 HWC image


class Predictor:
    """Single-image prediction over a pipeline (`pipeline.infer` for one
    task, `pipeline.infer_all_tasks` for all of them)."""

    def __init__(self, pipeline, class_colors: Optional[np.ndarray] = None,
                 processing_res: int = 0):
        self.pipeline = pipeline
        self.class_colors = class_colors
        self.processing_res = processing_res

    def _inputs(self, image, next_image):
        rgb = _to_norm(image)
        nxt = _to_norm(next_image) if next_image is not None else None
        in_hw = rgb.shape[:2]
        if self.processing_res > 0:
            rgb = resize_max_res(rgb, self.processing_res)
            if nxt is not None:
                nxt = resize_max_res(nxt, self.processing_res)
        dev = self.pipeline.device

        def put(x):
            return None if x is None else torch.from_numpy(x[None]).to(dev)

        # rgb_next None takes the pipeline's single-frame path (one encode)
        return put(rgb), put(nxt), in_hw

    def _finish(self, task, pred3, in_hw, match_input_res) -> Prediction:
        if match_input_res and pred3.shape[:2] != in_hw:
            pred3 = resize(pred3, in_hw, "linear")
        out = postprocess_prediction(task, pred3, self.class_colors)
        return Prediction(task=task, output=out,
                          visualization=_visualize(task, out,
                                                   self.class_colors))

    def __call__(self, image: np.ndarray, task: str,
                 next_image: Optional[np.ndarray] = None,
                 match_input_res: bool = True) -> Prediction:
        rgb, nxt, in_hw = self._inputs(image, next_image)
        pred = self.pipeline.infer(rgb, nxt, TASKS.index(task))
        pred3 = pred[0].float().cpu().numpy()
        return self._finish(task, pred3, in_hw, match_input_res)

    def all_tasks(self, image: np.ndarray,
                  next_image: Optional[np.ndarray] = None,
                  match_input_res: bool = True) -> dict:
        """All 7 tasks from one fused step (one VAE encode, one child pass,
        the 7 main streams folded into one batch). Returns {task:
        Prediction}."""
        rgb, nxt, in_hw = self._inputs(image, next_image)
        preds = self.pipeline.infer_all_tasks(rgb, nxt)
        preds = preds[:, 0].float().cpu().numpy()
        return {task: self._finish(task, preds[ti], in_hw, match_input_res)
                for ti, task in enumerate(TASKS)}


def _to_norm(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]; a float image must already be there."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0 * 2.0 - 1.0
    if img.min() < -1.0 - 1e-6 or img.max() > 1.0 + 1e-6:
        raise ValueError("float input must be in [-1, 1]")
    return img.astype(np.float32)


def _visualize(task: str, out: np.ndarray, class_colors) -> np.ndarray:
    if task in ("depth", "shading"):
        return colorize_depth(out)
    if task == "albedo":
        return (np.clip(out, 0, 1) * 255).astype(np.uint8)
    if task == "normal":
        return visualize_normal(out)
    if task == "optical_flow":
        return visualize_optical_flow(out)
    if task == "scene_flow":
        return visualize_scene_flow(out)
    if task == "semantic":
        return map_class_to_color(out, class_colors)
    raise ValueError(task)
