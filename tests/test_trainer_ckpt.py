"""Trainer orchestration + checkpoint/resume + evaluator tests."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stablemtl_tpu.checkpoint import CheckpointManager
from stablemtl_tpu.data import MixedTaskLoader
from stablemtl_tpu.evaluation import (
    Evaluator,
    make_task_metrics,
    postprocess_prediction,
)
from stablemtl_tpu.models import AutoencoderKL, UNet2DConditionModel
from stablemtl_tpu.models.unet import tiny_unet_config
from stablemtl_tpu.models.vae import tiny_vae_config
from stablemtl_tpu.pipeline import N_TASKS, StableMTLPipeline
from stablemtl_tpu.train_state import OptimizerConfig, create_train_state
from stablemtl_tpu.trainer import StableMTLTrainer, TrainerConfig


class _FakeDS:
    disp_name = "fake_depth"
    output_type = "depth"
    min_depth, max_depth = 1e-5, 80.0

    def __init__(self, n=8, h=16, w=16):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def get(self, idx, rng=None):
        r = np.random.RandomState(idx)
        img = r.uniform(-1, 1, (self.h, self.w, 3)).astype(np.float32)
        depth = r.uniform(1, 10, (self.h, self.w, 1)).astype(np.float32)
        return {
            "rgb_norm": img, "rgb_next_norm": img,
            "output": (depth / 10 * 2 - 1).astype(np.float32),
            "depth_raw_linear": depth,
            "valid_mask": np.ones((self.h, self.w, 1), bool),
            "output_type": "depth",
        }


@functools.cache
def _built_pipeline(key):
    k = jax.random.split(jax.random.PRNGKey(key), 3)
    vae = AutoencoderKL(tiny_vae_config())
    vae_params = vae.init(k[0], jnp.zeros((1, 16, 16, 3)))
    unet = UNet2DConditionModel(tiny_unet_config(cross_attention_dim=32))
    text = jnp.zeros((1, 4, 32))
    unet_params = unet.init(k[1], jnp.zeros((1, 2, 2, 12)),
                            jnp.zeros((1,), jnp.int32), text)
    return StableMTLPipeline(
        vae=vae, unet=unet, vae_params=vae_params, unet_params=unet_params,
        text_embed_table=jax.random.normal(k[2], (N_TASKS, 4, 32)) * 0.02)


def _pipeline(key=0):
    """The pipeline for `key`, built once per module (Flax's init runs
    eagerly). The trainer's step donates its state, whose params start as
    the pipeline's, so each caller gets its own copy of unet_params."""
    pipe = _built_pipeline(key)
    return dataclasses.replace(
        pipe, unet_params=jax.tree_util.tree_map(jnp.copy, pipe.unet_params))


def test_checkpoint_roundtrip(tmp_path):
    pipe = _pipeline()
    state = create_train_state(pipe.unet_params,
                               OptimizerConfig(use_schedule=False))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, meta={"effective_iter": 0})
    assert mgr.exists()

    state2 = create_train_state(_pipeline(1).unet_params,
                                OptimizerConfig(use_schedule=False))
    restored = mgr.restore(state2)
    a = jax.tree_util.tree_leaves(state.params)
    b = jax.tree_util.tree_leaves(restored.params)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # overwrite path
    mgr.save(restored.replace(step=jnp.asarray(5, jnp.int32)))
    again = mgr.restore(state2)
    assert int(again.step) == 5


def test_trainer_runs_resumes_deterministically(tmp_path):
    def build(ckpt_dir):
        pipe = _pipeline()
        state = create_train_state(
            pipe.unet_params,
            OptimizerConfig(lr=1e-3, use_schedule=False))
        loader = MixedTaskLoader([_FakeDS()], batch_size=2, seed=0,
                                 prefetch=0)
        cfg = TrainerConfig(max_iter=6, save_period=2, backup_period=1000,
                            validation_period=10_000, log_period=1)
        mgr = CheckpointManager(ckpt_dir)
        return StableMTLTrainer(pipe, state, loader, cfg, ckpt=mgr)

    t1 = build(str(tmp_path / "a"))
    s1 = t1.train()
    assert int(s1.step) == 6

    # fresh run to step 3, checkpoint, resume, continue to 6 -> same params
    t2 = build(str(tmp_path / "b"))
    t2.cfg.max_iter = 3
    s2 = t2.train()
    t2.ckpt.save(s2)
    t3 = build(str(tmp_path / "b"))
    t3.cfg.max_iter = 6
    t3.maybe_resume()
    assert int(t3.state.step) == 3
    s3 = t3.train()
    for x, y in zip(jax.tree_util.tree_leaves(s1.params),
                    jax.tree_util.tree_leaves(s3.params)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)


def test_postprocess_prediction_rules():
    pred3 = np.random.uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    d = postprocess_prediction("depth", pred3)
    assert d.shape == (8, 8, 1) and d.min() >= 0 and d.max() <= 1
    n = postprocess_prediction("normal", pred3)
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, rtol=1e-5)
    f = postprocess_prediction("optical_flow", pred3)
    assert f.shape == (8, 8, 2)
    colors = np.array([[0, 0, 0], [255, 255, 255]], np.float32)
    s = postprocess_prediction("semantic", pred3, colors)
    assert s.shape == (8, 8) and set(np.unique(s)) <= {0, 1}


def test_evaluator_on_fake_depth():
    ds = _FakeDS(n=2)

    def perfect_infer(rgb, rgb_next, task_idx):
        # return the GT packed as depth 3ch in [-1,1]: eval must give ~0 error
        idx = perfect_infer.calls
        perfect_infer.calls += 1
        s = ds.get(idx % len(ds))
        out = np.repeat(s["output"], 3, axis=-1)
        return out[None]

    perfect_infer.calls = 0
    ev = Evaluator(infer_fn=perfect_infer)
    res = ev.evaluate(ds, tasks=["depth"], metrics=make_task_metrics())
    assert res["depth"]["abs_relative_difference"] < 1e-3
    assert res["depth"]["delta1_acc"] > 0.999


def test_trainer_visualize_writes_pngs(tmp_path):
    import os

    pipe = _pipeline()
    state = create_train_state(pipe.unet_params,
                               OptimizerConfig(use_schedule=False))
    trainer = StableMTLTrainer(pipe, state, loader=None,
                               config=TrainerConfig(),
                               val_datasets=[_FakeDS(n=2)])
    trainer.visualize(str(tmp_path / "vis"), max_samples=1)
    files = os.listdir(tmp_path / "vis")
    assert any(f.endswith("_depth.png") for f in files), files
    # side-by-side panel: [input | GT | pred] -> width is 3x the sample's
    from PIL import Image

    img = Image.open(tmp_path / "vis" / sorted(files)[0])
    ds = _FakeDS(n=2)
    assert img.size == (3 * ds.w, ds.h)


def test_best_metric_tracking_and_best_checkpoint(tmp_path):
    from stablemtl_tpu.trainer import _lookup_metric

    results = {"dsA": {"depth": {"abs_relative_difference": 0.5,
                                 "delta1_acc": 0.9}},
               "dsB": {"normal": {"mean_angular_error": 20.0}}}
    assert _lookup_metric(results, "") == 0.5
    assert _lookup_metric(results, "delta1_acc") == 0.9
    assert _lookup_metric(results, "normal/mean_angular_error") == 20.0
    assert _lookup_metric(results, "dsB/normal/mean_angular_error") == 20.0
    assert _lookup_metric(results, "nope") is None

    pipe = _pipeline()
    state = create_train_state(pipe.unet_params,
                               OptimizerConfig(use_schedule=False))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    trainer = StableMTLTrainer(
        pipe, state, loader=None,
        config=TrainerConfig(main_val_metric="abs_relative_difference"),
        ckpt=ckpt, val_datasets=[_FakeDS(n=2)])

    trainer._update_best({"d": {"depth": {"abs_relative_difference": 0.4}}},
                         eff=10)
    assert trainer.best_metric == 0.4
    assert ckpt.exists("best")
    assert ckpt.load_meta("best")["best_metric"] == 0.4

    # worse value does not overwrite
    trainer._update_best({"d": {"depth": {"abs_relative_difference": 0.6}}},
                         eff=20)
    assert trainer.best_metric == 0.4
    assert ckpt.load_meta("best")["effective_iter"] == 10

    # better value does; best_metric survives save/resume via meta
    trainer._update_best({"d": {"depth": {"abs_relative_difference": 0.3}}},
                         eff=30)
    assert ckpt.load_meta("best")["best_metric"] == 0.3
    ckpt.save(trainer.state, meta={"best_metric": trainer.best_metric})
    fresh = StableMTLTrainer(
        pipe, create_train_state(pipe.unet_params,
                                 OptimizerConfig(use_schedule=False)),
        loader=None, config=TrainerConfig(), ckpt=ckpt)
    fresh.maybe_resume()
    assert fresh.best_metric == 0.3

    # maximize goal flips the comparison
    tmax = StableMTLTrainer(
        pipe, state, loader=None,
        config=TrainerConfig(main_val_metric="delta1_acc",
                             main_val_metric_goal="maximize"))
    tmax._update_best({"d": {"depth": {"delta1_acc": 0.5}}}, eff=1)
    tmax._update_best({"d": {"depth": {"delta1_acc": 0.4}}}, eff=2)
    assert tmax.best_metric == 0.5
    tmax._update_best({"d": {"depth": {"delta1_acc": 0.7}}}, eff=3)
    assert tmax.best_metric == 0.7


def test_restore_params_only_ignores_optimizer_tree(tmp_path):
    # a run trained WITH gradient accumulation has a MultiStepsState
    # opt_state; eval builds accumulation_steps=1 — params-only restore must
    # still work (advisor finding: cli/eval.py restore mismatch)
    pipe = _pipeline()
    train_state = create_train_state(
        pipe.unet_params,
        OptimizerConfig(lr=1e-3, use_schedule=False, accumulation_steps=4))
    loader = MixedTaskLoader([_FakeDS()], batch_size=2, seed=0, prefetch=0)
    cfg = TrainerConfig(max_iter=1, gradient_accumulation_steps=4,
                        save_period=10_000, validation_period=10_000,
                        log_period=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    tr = StableMTLTrainer(pipe, train_state, loader, cfg, ckpt=mgr)
    s = tr.train()
    mgr.save(s)

    eval_state = create_train_state(
        _pipeline(1).unet_params,
        OptimizerConfig(use_schedule=False, accumulation_steps=1))
    restored = mgr.restore_params_only(eval_state)
    assert int(restored.step) == int(s.step)
    for x, y in zip(jax.tree_util.tree_leaves(s.params),
                    jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_per_step_loss_ema_updates_every_step(tmp_path):
    pipe = _pipeline()
    state = create_train_state(pipe.unet_params,
                               OptimizerConfig(lr=1e-3, use_schedule=False))
    loader = MixedTaskLoader([_FakeDS()], batch_size=2, seed=0, prefetch=0)
    # log_period larger than max_iter: EMA must still be updated per step
    cfg = TrainerConfig(max_iter=4, save_period=10_000,
                        validation_period=10_000, log_period=1000)
    tr = StableMTLTrainer(pipe, state, loader, cfg)
    tr.train()
    assert "depth" in tr.loss_ema and np.isfinite(tr.loss_ema["depth"])
