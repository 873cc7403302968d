"""Shared helpers of the tests/test_torch_port_*.py files: random Flax
parameter trees made with numpy, their carry-over into the port, and the
`one_torch_thread` fixture each of those files imports.

Parameters are drawn at scales that keep activations near unit variance
(kernels N(0, 1/fan_in), norm scales 1 + 0.1 N, biases 0.1 N), and every
leaf is random, including the zero-initialized task-attention output
projection, so that no path of a block multiplies out to zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu_torch.models.convert import state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a port test module on one torch thread. The suite runs in
    several worker processes on a shared host; torch's default of one
    OpenMP thread per core in every worker oversubscribes it, and spinning
    threads then starve each other (an infer_all_tasks call of the tiny
    pipeline measured 0.2 s alone and 10 s beside three other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(init_fn, *args, seed: int = 0):
    """Flax params with the structure of init_fn(rng, *args), values from
    numpy (no init compile)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    r = np.random.RandomState(seed)

    def fill(path, sd):
        name = str(path[-1])
        shape = sd.shape
        if "scale" in name:
            return (1.0 + 0.1 * r.standard_normal(shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * r.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
        return (r.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_port(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load a Flax tree into a port module; strict, so every leaf maps."""
    module.load_state_dict(state_dict_from_flax(flax_params), strict=True)
    return module.eval()


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)
