"""Environment-flag parsing for the port's switches.

Flags read by the port:
- STABLEMTL_FAST_MATH: default tier of the fast-softmax flash mode;
- STABLEMTL_FLASH_FAST_SOFTMAX: overrides that tier either way;
- STABLEMTL_DISABLE_FLASH: plain attention everywhere;
- STABLEMTL_DISABLE_PREFIX_SHARE: recompute the shared UNet prefix per stream;
- STABLEMTL_FUSED_GEGLU: the feed-forward's GEGLU projection through the
  fused kernel K6 where no gradient is needed (ops/geglu.py). Off by
  default, as in the JAX package: on the H100, K6 is faster than the plain
  GEGLU at all four SD2 feed-forward shapes, but the serving step with it
  is not faster by more than its own spread (PERF.md).

Flags the JAX package reads to select variants of its TPU kernels have no
counterpart here yet; setting one of them makes the CUDA path raise, so an
A/B run never compares the same code twice (`reject_tpu_only_flags`).
"""

from __future__ import annotations

import os

TPU_ONLY_FLAGS = (
    "STABLEMTL_FLASH_POLY_EXP",
    "STABLEMTL_FLASH_MXU_LSUM",
    "STABLEMTL_FLASH_BLOCK_Q",
    "STABLEMTL_FLASH_BLOCK_K",
    "STABLEMTL_FLASH_BLOCK_K_BWD",
)


def env_flag(name: str, default: bool = False) -> bool:
    """Parse a boolean env var ("0"/"false" mean False). Read at call time."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def reject_tpu_only_flags() -> None:
    """Raise if a flag of a TPU-only kernel variant is set to anything but
    empty or "0"."""
    bad = [n for n in TPU_ONLY_FLAGS
           if os.environ.get(n, "").strip() not in ("", "0")]
    if bad:
        raise RuntimeError(
            f"{', '.join(bad)}: TPU-only kernel variant(s) not ported to the "
            "CUDA path; unset them")
