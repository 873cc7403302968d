"""Eval-throughput paths (VERDICT round-1 item 9): batched same-geometry
eval and shared-encode multi-task inference must be value-equivalent to the
batch-1 per-task protocol."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stablemtl_tpu.evaluation import Evaluator, make_task_metrics
from stablemtl_tpu.models import AutoencoderKL, UNet2DConditionModel
from stablemtl_tpu.models.unet import tiny_unet_config
from stablemtl_tpu.models.vae import tiny_vae_config
from stablemtl_tpu.pipeline import (
    N_TASKS,
    TASK_INDEX,
    StableMTLPipeline,
    jit_infer,
    jit_infer_tasks,
)


# One build per argument tuple: Flax's init runs eagerly, and no test
# writes to a pipeline.
@functools.cache
def _pipeline(multi_stream=False, key=0):
    k = jax.random.split(jax.random.PRNGKey(key), 4)
    vae = AutoencoderKL(tiny_vae_config())
    vae_params = vae.init(k[0], jnp.zeros((1, 16, 16, 3)))
    text = jnp.zeros((1, 4, 32))
    child = child_params = None
    ucfg = tiny_unet_config(cross_attention_dim=32,
                            use_task_attention=multi_stream)
    unet = UNet2DConditionModel(ucfg)
    x12 = jnp.zeros((1, 2, 2, 12))
    t0 = jnp.zeros((1,), jnp.int32)
    if multi_stream:
        child = UNet2DConditionModel(tiny_unet_config(
            cross_attention_dim=32))
        child_params = child.init(k[3], x12, t0, text)
        _, taps = child.apply(child_params, x12, t0, text,
                              tap="afterSelfAttn_residual")
        feats = [jnp.zeros((N_TASKS - 1,) + tp.shape) for tp in taps]
        unet_params = unet.init(k[1], x12, t0, text, task_feats=feats,
                                main_idx=jnp.asarray(0),
                                aux_idx=jnp.arange(1, N_TASKS))
    else:
        unet_params = unet.init(k[1], x12, t0, text)
    return StableMTLPipeline(
        vae=vae, unet=unet, vae_params=vae_params, unet_params=unet_params,
        text_embed_table=jax.random.normal(k[2], (N_TASKS, 4, 32)) * 0.02,
        unet_child=child, unet_child_params=child_params)


class _TwoTaskDS:
    """depth+normal synthetic dataset (DIODE-shaped protocol)."""

    disp_name = "fake2"
    output_type = ["depth", "normal"]
    min_depth, max_depth = 1e-5, 80.0

    def __init__(self, n=5, h=16, w=16):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def get(self, idx, rng=None):
        r = np.random.RandomState(idx + 3)
        img = r.uniform(-1, 1, (self.h, self.w, 3)).astype(np.float32)
        n = r.standard_normal((self.h, self.w, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        return {"rgb_norm": img, "rgb_next_norm": img,
                "depth_raw_linear": r.uniform(1, 10, (self.h, self.w, 1))
                .astype(np.float32),
                "normal": n,
                "normal_valid_mask": np.ones((self.h, self.w, 1), bool),
                "valid_mask": np.ones((self.h, self.w, 1), bool),
                "output_type": self.output_type}


def test_infer_tasks_matches_all_tasks_rows():
    """Same computation as infer_all_tasks up to batch-shape float
    reassociation: exact permutation equivariance within one executable
    (K fixed), loose row agreement across different K (decode batch 3B vs
    7B reassociates conv reductions; random GroupNorm chains amplify ~1e-7
    to ~1e-2 — same effect documented in test_sharded_train.py)."""
    for ms in (False, True):
        pipe = _pipeline(multi_stream=ms)
        rgb = jnp.asarray(np.random.RandomState(0)
                          .uniform(-1, 1, (2, 16, 16, 3)), jnp.float32)
        sub = np.asarray(pipe.infer_tasks(rgb, rgb, jnp.asarray([0, 4, 6])))
        rev = np.asarray(pipe.infer_tasks(rgb, rgb, jnp.asarray([6, 4, 0])))
        np.testing.assert_array_equal(sub, rev[::-1])  # exact, same shape
        all7 = np.asarray(pipe.infer_all_tasks(rgb, rgb))
        np.testing.assert_allclose(sub, all7[[0, 4, 6]], atol=2e-2)


def test_fused_infer_matches_single_task_path():
    """infer_all_tasks (precomputed all-task K/V tables shared across the
    vmapped streams, models/unet.task_kv_tables) must agree with the
    per-task single_infer path (create_task_feats + per-stream K/V MLPs)
    — proves K/V-table sharing is a pure re-association of the same math.
    Loose tolerance only for the decode batch shape (7B vs B) reassociating
    conv reductions through GroupNorm chains."""
    pipe = _pipeline(multi_stream=True)
    rgb = jnp.asarray(np.random.RandomState(1)
                      .uniform(-1, 1, (2, 16, 16, 3)), jnp.float32)
    fused = np.asarray(pipe.infer_all_tasks(rgb, rgb))
    for ti in (0, 3, 6):
        single = np.asarray(pipe.infer(rgb, rgb, jnp.asarray(ti)))
        np.testing.assert_allclose(fused[ti], single, atol=2e-2)
        assert np.mean(np.abs(fused[ti] - single)) < 2e-3


def test_batched_multitask_eval_value_equivalent():
    """Evaluator batching/padding/dispatch is EXACTLY value-preserving —
    proven with a deterministic elementwise infer fn (device-side batching
    of the real pipeline reassociates floats; that's covered loosely
    above)."""
    ds = _TwoTaskDS(n=5)

    def fake_single(rgb, rgb_next, task_idx):
        return np.tanh(rgb * (1.0 + float(task_idx)))

    calls = {"tasks": 0, "single": 0}

    def fake_tasks(rgb, rgb_next, idx):
        calls["tasks"] += 1
        return np.stack([np.tanh(rgb * (1.0 + float(i))) for i in idx])

    def counting_single(rgb, rgb_next, task_idx):
        calls["single"] += 1
        return fake_single(rgb, rgb_next, task_idx)

    base = Evaluator(infer_fn=fake_single, batch_size=1)
    want = base.evaluate(ds, metrics=make_task_metrics())

    fast = Evaluator(infer_fn=counting_single, infer_tasks_fn=fake_tasks,
                     batch_size=4)
    got = fast.evaluate(ds, metrics=make_task_metrics())

    # multi-task path used exclusively: ceil(5/4)=2 chunks, one call each
    assert calls["tasks"] == 2 and calls["single"] == 0
    for task in ("depth", "normal"):
        for k, v in want[task].items():
            np.testing.assert_allclose(got[task][k], v, rtol=1e-12,
                                       err_msg=f"{task}.{k}")


def test_batched_real_pipeline_multitask_smoke():
    """Real jitted infer_tasks through the Evaluator: finite metrics, one
    device call per chunk."""
    pipe = _pipeline(multi_stream=True)
    ds = _TwoTaskDS(n=3)
    ev = Evaluator(infer_fn=jit_infer(pipe),
                   infer_tasks_fn=jit_infer_tasks(pipe), batch_size=4)
    res = ev.evaluate(ds, metrics=make_task_metrics())
    assert np.isfinite(res["depth"]["abs_relative_difference"])
    assert 0 <= res["normal"]["mean_angular_error"] <= 180


def test_batched_eval_mixed_geometry():
    """Shape changes mid-dataset split chunks instead of crashing."""
    pipe = _pipeline()

    class _VarDS(_TwoTaskDS):
        output_type = "depth"

        def get(self, idx, rng=None):
            s = _TwoTaskDS.get(self, idx, rng)
            if idx >= 3:  # geometry flips for the tail
                for k in ("rgb_norm", "rgb_next_norm"):
                    s[k] = np.transpose(s[k], (1, 0, 2)).copy()
                for k in ("depth_raw_linear", "valid_mask"):
                    s[k] = np.transpose(s[k], (1, 0, 2)).copy()
            return s

    ds = _VarDS(n=5, h=16, w=24)
    ev = Evaluator(infer_fn=jit_infer(pipe), batch_size=4)
    res = ev.evaluate(ds, metrics=make_task_metrics())
    assert np.isfinite(res["depth"]["abs_relative_difference"])
