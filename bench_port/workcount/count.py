"""The work of a cell's step, counted on the plain reference at the
cell's shapes on the meta device (no memory, no arithmetic): FLOPs from
`torch.utils.flop_counter.FlopCounterMode`, and the shape of every
attention call. Nothing of the program is read, so the count is the same
whatever implements the step."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..harness import cells
from ..reference.precision import recording


def meta_reference(config: dict):
    """The configuration's plain reference on the meta device."""
    plain = cells.reference_of(config)
    weights = {key: dict(m.named_parameters())
               for key, m in plain.build(config, "meta").items()}
    conditioning = {name: torch.empty(shape, device="meta") for name, shape
                    in plain.conditioning_shapes(config).items()}
    return plain.Reference.from_weights(config, weights, conditioning,
                                        "meta")


def infer_work(config: dict, batch: int, hw, pair: bool = False) -> dict:
    """{"flops": of one all-task step at `batch` images of `hw`,
    "attention": [(bh, sq, sk, d), ...] its attention calls}."""
    ref = meta_reference(config)
    rgb = torch.empty((batch, *hw, 3), device="meta")
    calls = []
    with FlopCounterMode(display=False) as counter, recording(calls):
        ref.infer_all_tasks(rgb, rgb if pair else None, block=batch)
    return {"flops": int(counter.get_total_flops()), "attention": calls}


def train_work(config: dict, batch: int, hw, task: int = 0) -> dict:
    """{"flops", "attention"} of one training micro-step at `batch`
    images of `hw` and the main task `task`, all at once: the
    reference's `train_inputs` without gradients (for SD2: the VAE encode
    of rgb, rgb_next and target and the child's taps of the 6 other
    tasks), its `train_pred` and the backward to the main UNet's
    parameters (no recompute). The banks' masking adds no product and is
    left out."""
    ref = meta_reference(config)
    ref.unet.requires_grad_(True)
    images = torch.empty((3 * batch, *hw, 3), device="meta")
    calls = []
    with FlopCounterMode(display=False) as counter, recording(calls):
        inputs = ref.train_inputs(*images.chunk(3), task)
        pred = ref.train_pred(inputs, task)
        ((pred - inputs.target) ** 2).sum().backward()
    return {"flops": int(counter.get_total_flops()), "attention": calls}
