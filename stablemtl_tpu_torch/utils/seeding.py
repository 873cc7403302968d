"""Deterministic, resumable randomness. Counterpart of
`stablemtl_tpu/utils/seeding.py::step_key`: each training step draws from a
generator derived from (base seed, step) alone, so a resumed run needs only
the step counter. The numbers differ from the JAX package's (a torch
Generator is not a JAX key), so the two packages agree in distribution, not
draw for draw."""

from __future__ import annotations

import numpy as np
import torch


def step_generator(base_seed: int, step: int, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` seeded from (base_seed, step), the two
    mixed by numpy's SeedSequence."""
    seq = np.random.SeedSequence([base_seed & 0xFFFF_FFFF, int(step)])
    seed = int(seq.generate_state(1, dtype=np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)
