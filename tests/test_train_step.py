"""Train-step tests: mask downsample parity, optimization progress, and
data-parallel execution on the virtual 8-device CPU mesh."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stablemtl_tpu.models import AutoencoderKL, UNet2DConditionModel
from stablemtl_tpu.models.unet import tiny_unet_config
from stablemtl_tpu.models.vae import tiny_vae_config
from stablemtl_tpu.parallel import make_mesh, shard_batch
from stablemtl_tpu.pipeline import N_TASKS, StableMTLPipeline
from stablemtl_tpu.train_state import (
    OptimizerConfig,
    create_train_state,
    downsample_valid_mask,
    make_eval_step,
    make_train_step,
)


def test_downsample_valid_mask_invalid_dominant():
    # one invalid pixel anywhere in an 8x8 cell invalidates the cell
    # (stablemtl_trainer.py:199-213)
    mask = np.ones((1, 16, 16, 1), bool)
    mask[0, 3, 5, 0] = False
    down = np.asarray(downsample_valid_mask(jnp.asarray(mask)))
    assert down.shape == (1, 2, 2, 1)
    assert not down[0, 0, 0, 0]
    assert down[0, 0, 1, 0] and down[0, 1, 0, 0] and down[0, 1, 1, 0]

    all_valid = np.asarray(downsample_valid_mask(jnp.ones((1, 8, 8, 1), bool)))
    assert all_valid.all()


# One build per argument tuple: Flax's init runs eagerly, and no test
# writes to a pipeline.
@functools.cache
def _make_pipeline(key=0):
    rng = jax.random.PRNGKey(key)
    k1, k2, k3 = jax.random.split(rng, 3)
    vae = AutoencoderKL(tiny_vae_config())
    H = W = 16
    vae_params = vae.init(k1, jnp.zeros((1, H, W, 3)))
    ucfg = tiny_unet_config(cross_attention_dim=32)
    unet = UNet2DConditionModel(ucfg)
    text = jnp.zeros((1, 4, 32))
    unet_params = unet.init(k2, jnp.zeros((1, H // 8, W // 8, 12)),
                            jnp.zeros((1,), jnp.int32), text)
    table = jax.random.normal(k3, (N_TASKS, 4, 32)) * 0.02
    return StableMTLPipeline(vae=vae, unet=unet, vae_params=vae_params,
                             unet_params=unet_params, text_embed_table=table)


def _batch(B=2, H=16, W=16, task=1, seed=0):
    r = np.random.RandomState(seed)
    rgb = r.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    return {
        "rgb_norm": rgb,
        "rgb_next_norm": rgb,
        "target_3ch": r.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        "valid_mask": np.ones((B, H, W, 1), bool),
        "task_idx": np.asarray(task, np.int32),
    }


def test_train_step_descends():
    pipe = _make_pipeline()
    state = create_train_state(
        pipe.unet_params,
        OptimizerConfig(lr=1e-3, use_schedule=False))
    step = make_train_step(pipe, base_seed=0, donate=False,
                           compute_grad_stats=True)
    batch = _batch()
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert float(metrics["nan_pred"]) == 0.0
        assert np.isfinite(float(metrics["grad_norm_mean"]))
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 5


def test_train_step_accumulation():
    pipe = _make_pipeline()
    cfg = OptimizerConfig(lr=1e-3, use_schedule=False, accumulation_steps=2)
    state = create_train_state(pipe.unet_params, cfg)
    step = make_train_step(pipe, donate=False)
    p0 = jax.tree_util.tree_leaves(state.params)[0]
    state, _ = step(state, _batch(seed=0))
    # first micro-step: params unchanged (accumulating)
    p1 = jax.tree_util.tree_leaves(state.params)[0]
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
    state, _ = step(state, _batch(seed=1))
    p2 = jax.tree_util.tree_leaves(state.params)[0]
    assert np.abs(np.asarray(p2) - np.asarray(p0)).max() > 0


def test_train_step_data_parallel_mesh():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    pipe = _make_pipeline()
    state = create_train_state(pipe.unet_params,
                               OptimizerConfig(use_schedule=False))
    step = make_train_step(pipe, donate=False)
    batch = shard_batch(_batch(B=8), mesh)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    # per-device batch result must match single-device math
    pipe2 = _make_pipeline()
    state2 = create_train_state(pipe2.unet_params,
                                OptimizerConfig(use_schedule=False))
    step2 = make_train_step(pipe2, donate=False)
    _, m2 = step2(state2, _batch(B=8))
    np.testing.assert_allclose(float(metrics["loss"]), float(m2["loss"]),
                               rtol=1e-3)


def test_eval_step_shapes():
    pipe = _make_pipeline()
    step = make_eval_step(pipe)
    out = step(pipe.unet_params, _batch(B=1))
    assert out.shape == (1, 16, 16, 3)
    assert np.abs(np.asarray(out)).max() <= 1.0
