"""Offline dataset-preparation jobs (host-side, one-shot).

Ports of the reference's dataset_preprocess/ + depth-to-normal-translator/
(SURVEY.md §2 items 27-30): hypersim HDF5 pipeline, FlyingThings3D
flow/scene-flow packing, MID-Intrinsics EXR tone mapping, and the d2nt
depth->normal synthesizer for vKITTI.

Copy of `stablemtl_tpu/preprocess/` (numpy, scipy, cv2; h5py and the EXR
readers imported inside the functions that need them): the port keeps its
own so that a machine without JAX can prepare a dataset, e.g.
`python -m stablemtl_tpu_torch.preprocess.flyingthings3d ...`.
"""

from .depth_to_normal import depth_to_normal
from .flyingthings3d import preprocess_ft3d_sample
from .hypersim import (
    dist_to_depth,
    orient_normals_toward_camera,
    tone_map_hdr,
)

__all__ = [
    "depth_to_normal",
    "dist_to_depth",
    "orient_normals_toward_camera",
    "preprocess_ft3d_sample",
    "tone_map_hdr",
]
