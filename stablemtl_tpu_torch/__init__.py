"""stablemtl_tpu_torch — the StableMTL multi-task dense-prediction system in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors the module layout of the JAX package `stablemtl_tpu`, which stays
the reference: each module here has a counterpart of the same path there.
The port imports neither JAX nor `stablemtl_tpu`; the constants below are its
own copy.
"""

__version__ = "0.1.0"

# Order is load-bearing: the task-attention banks are stacked in it.
TASKS = (
    "normal",
    "depth",
    "semantic",
    "optical_flow",
    "scene_flow",
    "albedo",
    "shading",
)

# Tasks that consume a second (next) frame.
TWO_FRAME_TASKS = ("optical_flow", "scene_flow")

LATENT_SCALE_FACTOR = 0.18215
FIXED_TIMESTEP = 999  # single-step inference
