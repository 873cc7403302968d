"""Per-task postprocessing of a decoded prediction, counterpart of
`stablemtl_tpu/evaluation.py::postprocess_prediction` (the metrics and the
evaluator are not ported yet).

- depth, shading: the decoded channels' mean mapped [-1, 1] -> [0, 1]
- albedo: the 3 channels mapped [-1, 1] -> [0, 1]
- normal: per-pixel L2 normalization of the decoded 3-vector
- optical / scene flow: the decoded channels, in [-1, 1]
- semantic: the nearest palette color's class id
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
