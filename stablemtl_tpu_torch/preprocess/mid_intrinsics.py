"""MID-Intrinsics offline preprocessing: EXR HDR -> tone-mapped rasters.

Port of reference dataset_preprocess/mid_intrinsics/preprocess.py:34-283:
tone-mapped jpg from the HDR render, albedo passthrough, and
shading = rgb / albedo, plus test/lite/vis split-file writing.

EXR reading: OpenEXR is not in this environment; imageio (with an EXR
plugin) or cv2 (if built with OpenEXR) are tried at call time, and a clear
error is raised otherwise — the math below is IO-agnostic.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .hypersim import GAMMA, tone_map_hdr, tonemap_scale


def read_exr(path: str) -> np.ndarray:
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if img is not None:
            return img[..., ::-1].astype(np.float32)
    except Exception:
        pass
    try:
        import imageio.v3 as iio

        return np.asarray(iio.imread(path)).astype(np.float32)
    except Exception as e:
        raise RuntimeError(
            f"No EXR reader available for {path}; install OpenEXR or an "
            "imageio EXR plugin") from e


# CGIntrinsics-style tone map — the exact same scale+gamma rule as
# Hypersim, so it IS that helper (one implementation to maintain)
tone_map_mid = tone_map_hdr


def shading_from_albedo(rgb: np.ndarray, albedo: np.ndarray,
                        eps: float = 1e-6) -> np.ndarray:
    return rgb / np.maximum(albedo, eps)


def process_scene(render_exr: str, albedo_exr: str, out_prefix: str) -> dict:
    """One render: writes <prefix>.jpg (gamma tone map),
    <prefix>_scaled_only.jpg (scale, no gamma), <prefix>_albedo.jpg and
    <prefix>_shading.jpg (the layout mid_intrinsic_dataset.py:21-25 reads).

    Reference math (preprocess.py:196-233): albedo is saved LINEAR
    (clipped, no gamma) and shading = (tm_scale * rgb_hdr).clip(0,1) /
    linear albedo — gamma is applied only to the display rgb jpg."""
    import cv2

    rgb = read_exr(render_exr)
    albedo = np.clip(read_exr(albedo_exr), 0, 1)       # LINEAR, no gamma
    scale = tonemap_scale(rgb)
    rgb_scaled = np.clip(scale * rgb, 0, 1)
    rgb_tm = tone_map_mid(rgb)
    shading = np.clip(shading_from_albedo(rgb_scaled, albedo), 0, 1)

    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    for suffix, img in (("", rgb_tm), ("_scaled_only", rgb_scaled),
                        ("_albedo", albedo), ("_shading", shading)):
        cv2.imwrite(f"{out_prefix}{suffix}.jpg",
                    cv2.cvtColor((img * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
    return {"rgb": f"{out_prefix}.jpg"}


def write_split_files(out_dir: str, names: List[str],
                      split: str = "test", n_lite: int = 300,
                      n_vis: int = 20, seed: int = 0) -> None:
    """Reference split lists (preprocess.py:250-283): ALL names go to
    {split}.txt, plus randomly sampled {split}_lite_300.txt and
    {split}_vis_20.txt subsets (the reference samples with the global
    `random` module; a seed keeps this reproducible)."""
    import random

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{split}.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    rng = random.Random(seed)
    lite = rng.sample(names, min(n_lite, len(names)))
    with open(os.path.join(out_dir, f"{split}_lite_{n_lite}.txt"),
              "w") as f:
        f.write("\n".join(lite) + "\n")
    vis = rng.sample(names, min(n_vis, len(names)))
    with open(os.path.join(out_dir, f"{split}_vis_{n_vis}.txt"), "w") as f:
        f.write("\n".join(vis) + "\n")
