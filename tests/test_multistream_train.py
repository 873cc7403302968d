"""Multi-stream (cross-task attention) training-path tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stablemtl_tpu.models import AutoencoderKL, UNet2DConditionModel
from stablemtl_tpu.models.unet import tiny_unet_config
from stablemtl_tpu.models.vae import tiny_vae_config
from stablemtl_tpu.pipeline import N_TASKS, StableMTLPipeline
from stablemtl_tpu.train_state import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)


# One build per argument tuple: Flax's init runs eagerly, and no test
# writes to a pipeline.
@functools.cache
def _multi_pipeline(attn_mask_ratio=0.4, key=0):
    k = jax.random.split(jax.random.PRNGKey(key), 4)
    H = 16
    vae = AutoencoderKL(tiny_vae_config())
    vae_params = vae.init(k[0], jnp.zeros((1, H, H, 3)))
    ccfg = tiny_unet_config(cross_attention_dim=32)
    child = UNet2DConditionModel(ccfg)
    text = jnp.zeros((1, 4, 32))
    x12 = jnp.zeros((1, H // 8, H // 8, 12))
    t0 = jnp.zeros((1,), jnp.int32)
    child_params = child.init(k[1], x12, t0, text,
                              tap="afterSelfAttn_residual")
    _, taps = child.apply(child_params, x12, t0, text,
                          tap="afterSelfAttn_residual")
    ucfg = tiny_unet_config(cross_attention_dim=32, use_task_attention=True,
                            attn_mask_ratio=attn_mask_ratio)
    unet = UNet2DConditionModel(ucfg)
    feats = [jnp.zeros((N_TASKS - 1,) + t.shape) for t in taps]
    unet_params = unet.init(k[2], x12, t0, text, task_feats=feats,
                            main_idx=jnp.asarray(0),
                            aux_idx=jnp.arange(1, N_TASKS))
    return StableMTLPipeline(
        vae=vae, unet=unet, vae_params=vae_params, unet_params=unet_params,
        text_embed_table=jax.random.normal(k[3], (N_TASKS, 4, 32)) * 0.02,
        unet_child=child, unet_child_params=child_params)


def _batch(task=2, B=2, H=16, seed=0):
    r = np.random.RandomState(seed)
    rgb = r.uniform(-1, 1, (B, H, H, 3)).astype(np.float32)
    return {"rgb_norm": rgb, "rgb_next_norm": rgb,
            "target_3ch": r.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
            "valid_mask": np.ones((B, H, H, 1), bool),
            "task_idx": np.asarray(task, np.int32)}


def test_multistream_train_descends_and_task_is_data():
    pipe = _multi_pipeline()
    state = create_train_state(pipe.unet_params,
                               OptimizerConfig(lr=1e-3, use_schedule=False))
    step = make_train_step(pipe, donate=False)
    losses = []
    for i in range(4):
        state, m = step(state, _batch(task=i % N_TASKS, seed=i))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert int(state.step) == 4


def test_zero_init_task_attention_is_identity():
    """to_out_task starts at zero (util/model.py:140-146): a fresh
    multi-stream UNet must produce the same output with and without child
    features."""
    pipe = _multi_pipeline(attn_mask_ratio=0.0)
    rgb = jnp.asarray(np.random.RandomState(0).uniform(-1, 1, (1, 16, 16, 3)),
                      jnp.float32)
    lat, lat_next = pipe.encode_rgb_pair(rgb, rgb)
    with_feats = pipe.unet_forward(lat, lat_next, jnp.asarray(1))

    # single-stream twin: same params, no task attention path
    import dataclasses

    solo = dataclasses.replace(pipe, unet_child=None,
                               unet_child_params=None)
    # strip task_attn params so structures match the no-task-feats call
    without = solo.unet_forward(lat, lat_next, jnp.asarray(1))
    np.testing.assert_allclose(np.asarray(with_feats), np.asarray(without),
                               atol=1e-5)


def test_child_frozen_gets_no_gradient():
    pipe = _multi_pipeline()

    def loss_fn(unet_params, child_params):
        import dataclasses

        p = dataclasses.replace(pipe, unet_params=unet_params,
                                unet_child_params=child_params)
        rgb = jnp.ones((1, 16, 16, 3)) * 0.1
        lat, lat_next = p.encode_rgb_pair(rgb, rgb)
        pred = p.unet_forward(lat, lat_next, jnp.asarray(0),
                              params=unet_params)
        return (pred ** 2).mean()

    g_child = jax.grad(loss_fn, argnums=1)(pipe.unet_params,
                                           pipe.unet_child_params)
    total = sum(float(jnp.abs(g).sum())
                for g in jax.tree_util.tree_leaves(g_child))
    assert total == 0.0  # stop_gradient on the child (pipeline parity)


def test_taskmask_strategies_compile():
    for strat in ("attn_prob", "random", "highest", "attn_prob_random_k"):
        k = jax.random.PRNGKey(0)
        from stablemtl_tpu.models.transformer import TaskAttentionBank

        bank = TaskAttentionBank(dim=32, n_tasks=N_TASKS, n_attns=4,
                                 attn_mask_ratio=0.5, attn_mask_type=strat)
        hidden = jnp.ones((1, 8, 32))
        feats = jnp.ones((N_TASKS - 1, 1, 8, 32))
        params = bank.init({"params": k, "taskmask": k}, hidden, feats,
                           jnp.asarray(0), jnp.arange(1, N_TASKS),
                           train=True)
        out = bank.apply(params, hidden, feats, jnp.asarray(0),
                         jnp.arange(1, N_TASKS), train=True,
                         rngs={"taskmask": jax.random.PRNGKey(1)})
        assert out.shape == (1, 8, 32)
        assert bool(jnp.all(jnp.isfinite(out)))
