"""Environment-flag parsing for the port's switches.

Flags read by the port, each at call time:
- STABLEMTL_FAST_MATH: default tier of the fast-softmax flash mode;
- STABLEMTL_FLASH_FAST_SOFTMAX: overrides that tier either way;
- STABLEMTL_FLASH_POLY_EXP (`poly_exp`): "3" or "4" replaces the flash
  forward kernels' exp2 by a degree-3 or degree-4 polynomial with the
  exponent built in the float's bits, as the JAX package's `_exp2_fast`;
  anything else keeps exp2. Off by default, as in the JAX package;
- STABLEMTL_FLASH_MXU_LSUM (`mxu_lsum`): the resident flash forward's row
  sum comes out of the tensor cores, the counterpart of the JAX package's
  ones column appended to V (head dims below 128). Off by default;
- STABLEMTL_NO_FUSED_QKV (`no_fused_qkv`): self-attention projects q, k and
  v with three products instead of one over the concatenated weight. Any
  non-empty value sets it, as in the JAX package;
- STABLEMTL_DISABLE_FLASH: plain attention everywhere;
- STABLEMTL_DISABLE_PREFIX_SHARE: recompute the shared UNet prefix per stream;
- STABLEMTL_FUSED_GEGLU: the feed-forward's GEGLU projection through the
  fused kernel K6 where no gradient is needed (ops/geglu.py). Off by
  default, as in the JAX package: on the H100, K6 is faster than the plain
  GEGLU at all four SD2 feed-forward shapes, but the serving step with it
  is not faster by more than its own spread (PERF.md);
- STABLEMTL_TORCH_CACHE: where the kernel libraries are built
  (utils/compilation_cache.py).

The JAX package's tile flags STABLEMTL_FLASH_BLOCK_Q, _BLOCK_K and
_BLOCK_K_BWD size the Pallas grid's VMEM blocks; the port's kernels pick
their own Hopper tiles, so these have no counterpart, and setting one makes
the CUDA path raise, so an A/B run never compares the same code twice
(`reject_tpu_only_flags`).
"""

from __future__ import annotations

import os

TPU_ONLY_FLAGS = (
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


def poly_exp() -> int:
    """The polynomial degree of STABLEMTL_FLASH_POLY_EXP: 3 or 4, else 0
    (exp2), parsed as the JAX package's `_poly_exp`."""
    val = os.environ.get("STABLEMTL_FLASH_POLY_EXP", "0").strip()
    return int(val) if val in ("3", "4") else 0


def mxu_lsum() -> bool:
    """STABLEMTL_FLASH_MXU_LSUM, parsed as the JAX package's `_mxu_lsum`."""
    return env_flag("STABLEMTL_FLASH_MXU_LSUM")


def no_fused_qkv() -> bool:
    """STABLEMTL_NO_FUSED_QKV: set by any non-empty value, as the JAX
    package's self-attention reads it."""
    return bool(os.environ.get("STABLEMTL_NO_FUSED_QKV"))


def reject_tpu_only_flags() -> None:
    """Raise if a tile flag of the TPU kernels is set to anything but empty
    or "0"."""
    bad = [n for n in TPU_ONLY_FLAGS
           if os.environ.get(n, "").strip() not in ("", "0")]
    if bad:
        raise RuntimeError(
            f"{', '.join(bad)}: TPU-only kernel tile flag(s) with no "
            "counterpart on the CUDA path; unset them")
