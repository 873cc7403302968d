"""Deterministic, resumable randomness. Counterpart of
`stablemtl_tpu/utils/seeding.py`: each training step draws from a
generator derived from (base seed, step) alone (`step_generator`, the
counterpart of `step_key`), so a resumed run needs only the step counter.
Its numbers differ from the JAX package's (a torch Generator is not a JAX
key), so the two packages agree in distribution, not draw for draw;
`seed_all`, `generate_seed_sequence` and `step_rng` use Python's and
numpy's generators alone and equal the JAX package's exactly."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_all(seed: int = 0) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def generate_seed_sequence(
    initial_seed: int | None,
    length: int,
    min_val: int = -0x8000_0000_0000_0000,
    max_val: int = 0xFFFF_FFFF_FFFF_FFFF,
) -> list:
    """Pre-generated seed list, with the reference's semantics."""
    rng = random.Random(initial_seed)
    return [rng.randint(min_val, max_val) for _ in range(length)]


def step_rng(base_seed: int, step: int, salt: int = 0) -> np.random.Generator:
    """A host-side numpy Generator derived from (seed, step, salt)."""
    ss = np.random.SeedSequence([base_seed & 0xFFFF_FFFF, step, salt])
    return np.random.default_rng(ss)


def step_generator(base_seed: int, step: int, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` seeded from (base_seed, step), the two
    mixed by numpy's SeedSequence."""
    seq = np.random.SeedSequence([base_seed & 0xFFFF_FFFF, int(step)])
    seed = int(seq.generate_state(1, dtype=np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)
