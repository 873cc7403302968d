"""Carry a Flax parameter tree of the JAX package over to the port.

The port's parameter names are the Flax paths joined with '.', so the map
is total and mechanical: `kernel` becomes `weight` ([in, out] -> [out, in]
for a Dense, HWIO -> OIHW for a conv), `scale` becomes `weight`, and every
other leaf (biases, the stacked task banks such as `task_to_k_fc1_kernel`
[T, C, C/2]) keeps its name and layout. `load_state_dict(strict=True)` on
the result proves every leaf is covered.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if hasattr(val, "items"):  # dict or flax FrozenDict
            yield from _flatten(val, path)
        else:
            yield path, val


def flax_leaf_to_port(path, leaf):
    """One Flax leaf at `path` (a tuple of names) -> (port parameter name,
    torch tensor)."""
    arr = np.asarray(leaf)
    name = path[-1]
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'.'.join(path)}: kernel of rank {arr.ndim}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    key = ".".join(tuple(path[:-1]) + (name,))
    if arr.dtype.name == "bfloat16":  # numpy has no bf16 torch maps
        return key, torch.from_numpy(np.ascontiguousarray(
            arr.astype(np.float32))).to(torch.bfloat16)
    return key, torch.from_numpy(np.ascontiguousarray(arr))


def state_dict_from_flax(params) -> dict:
    """Flax params (nested dicts of arrays, with or without the top-level
    'params' collection) -> the port's state dict of torch tensors."""
    if "params" in params:
        params = params["params"]
    return dict(flax_leaf_to_port(path, leaf)
                for path, leaf in _flatten(params))
