"""Explicitly-sharded / ZeRO-1 training step on the 8-device CPU mesh."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stablemtl_tpu.models import AutoencoderKL, UNet2DConditionModel
from stablemtl_tpu.models.unet import tiny_unet_config
from stablemtl_tpu.models.vae import tiny_vae_config
from stablemtl_tpu.parallel import make_mesh, shard_batch
from stablemtl_tpu.parallel.sharded_train import (
    _zero1_sharding_for,
    make_sharded_train_step,
    shard_train_state,
)
from stablemtl_tpu.pipeline import N_TASKS, StableMTLPipeline
from stablemtl_tpu.train_state import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)


# One build per argument tuple: Flax's init runs eagerly, and no test
# writes to a pipeline.
@functools.cache
def _pipeline(key=0):
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


def _batch(B=8, seed=0):
    r = np.random.RandomState(seed)
    rgb = r.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    return {"rgb_norm": rgb, "rgb_next_norm": rgb,
            "target_3ch": r.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
            "valid_mask": np.ones((B, 16, 16, 1), bool),
            "task_idx": np.asarray(1, np.int32)}


def test_zero1_sharding_picks_divisible_axis():
    mesh = make_mesh()
    s = _zero1_sharding_for(jnp.zeros((3, 16)), mesh)
    assert s.spec == jax.sharding.PartitionSpec(None, "data")
    s = _zero1_sharding_for(jnp.zeros((5, 3)), mesh)  # nothing divisible
    assert s.spec in (jax.sharding.PartitionSpec(),
                      jax.sharding.PartitionSpec(None, None))


def test_sharded_step_matches_unsharded():
    """First-step loss parity (up to cross-device float reassociation) +
    ZeRO-1 moments actually sharded + training progresses.

    Post-update parameter equality across different device partitionings is
    NOT asserted: reduction-order diffs (~1e-4) get amplified by Adam's
    eps-normalization into sign flips on near-zero grads."""
    mesh = make_mesh()
    pipe = _pipeline()
    cfg = OptimizerConfig(lr=1e-3, use_schedule=False)

    state_ref = create_train_state(pipe.unet_params, cfg)
    step_ref = make_train_step(pipe, donate=False)

    state_sh = create_train_state(pipe.unet_params, cfg)
    state_sh = shard_train_state(state_sh, mesh, zero1=True, zero1_min_size=0)
    step_sh = make_sharded_train_step(pipe, mesh, zero1=True, donate=False,
                                   zero1_min_size=0)

    b = _batch(seed=0)
    state_ref, m_ref = step_ref(state_ref, b)
    state_sh, m_sh = step_sh(state_sh, shard_batch(b, mesh))
    np.testing.assert_allclose(float(m_ref["loss"]), float(m_sh["loss"]),
                               rtol=1e-3)

    losses = [float(m_sh["loss"])]
    for i in range(1, 4):
        state_sh, m_sh = step_sh(state_sh, shard_batch(_batch(seed=0), mesh))
        losses.append(float(m_sh["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state_sh.step) == 4

    # a large-enough Adam moment leaf must actually be sharded 8-ways
    leaves = [x for x in jax.tree_util.tree_leaves(state_sh.opt_state)
              if hasattr(x, "sharding") and x.ndim >= 2
              and any(d % 8 == 0 for d in x.shape)]
    assert leaves, "no shardable moment leaves found"
    assert any(not l.sharding.is_fully_replicated for l in leaves), \
        "ZeRO-1: expected at least one sharded optimizer moment"


def test_infer_all_tasks_data_parallel():
    """Fused multi-task inference under the 8-device mesh: no cross-sample
    leakage (exact permutation equivariance) and deterministic.

    Direct sharded-vs-unsharded value comparison is meaningless on an
    untrained net: per-shard conv tiling changes float reassociation at
    ~1e-7 and the random GroupNorm chains amplify it chaotically (measured:
    latents agree to 2.6e-7, decoded outputs diverge to ~1e-2)."""
    from stablemtl_tpu.pipeline import jit_infer_all_tasks
    from stablemtl_tpu.parallel import batch_sharding

    mesh = make_mesh()
    pipe = _pipeline()
    fn = jit_infer_all_tasks(pipe)
    rgb = np.random.RandomState(0).uniform(-1, 1, (8, 16, 16, 3)) \
        .astype(np.float32)
    sh = batch_sharding(mesh)

    with mesh:
        out = np.asarray(fn(jax.device_put(jnp.asarray(rgb), sh),
                            jax.device_put(jnp.asarray(rgb), sh)))
        out2 = np.asarray(fn(jax.device_put(jnp.asarray(rgb), sh),
                             jax.device_put(jnp.asarray(rgb), sh)))
        rev = rgb[::-1].copy()
        out_rev = np.asarray(fn(jax.device_put(jnp.asarray(rev), sh),
                                jax.device_put(jnp.asarray(rev), sh)))
    assert out.shape == (7, 8, 16, 16, 3)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, out2)            # deterministic
    np.testing.assert_array_equal(out_rev, out[:, ::-1])  # equivariant


def test_sharded_checkpoint_resume_equivalence(tmp_path):
    """Replayable-resume contract under the mesh (reference
    stablemtl_trainer.py:1095-1205): train 4 micro-steps (crossing the
    accumulation_steps=2 boundary), checkpoint at step 2, resume into a
    freshly sharded state, and bit-match params/opt_state vs the
    uninterrupted run."""
    from stablemtl_tpu.checkpoint import CheckpointManager
    from stablemtl_tpu.train_state import frozen_params_of

    mesh = make_mesh()
    pipe = _pipeline()
    cfg = OptimizerConfig(lr=1e-3, accumulation_steps=2, use_schedule=True)

    def fresh_state():
        s = create_train_state(pipe.unet_params, cfg)
        return shard_train_state(s, mesh, zero1=True, zero1_min_size=0)

    step = make_sharded_train_step(pipe, mesh, base_seed=0, zero1=True,
                                   zero1_min_size=0,
                                   donate=False)

    # uninterrupted run: batches are a pure function of the step index
    state = fresh_state()
    for i in range(4):
        state, _ = step(state, shard_batch(_batch(seed=i), mesh))
        if i == 1:
            ckpt = CheckpointManager(str(tmp_path / "ckpt"))
            ckpt.save(state, meta={"step": int(state.step)})
    want = jax.device_get(state.params)
    want_opt = jax.device_get(state.opt_state)

    # resume: restore into a new sharded template, replay steps 2..3
    resumed = ckpt.restore(fresh_state())
    assert int(resumed.step) == 2
    for i in range(2, 4):
        resumed, _ = step(resumed, shard_batch(_batch(seed=i), mesh))
    assert int(resumed.step) == 4

    got = jax.device_get(resumed.params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        jax.device_get(resumed.opt_state), want_opt)

    # restored moments keep their ZeRO-1 sharding (restore target = template)
    leaves = [x for x in jax.tree_util.tree_leaves(resumed.opt_state)
              if hasattr(x, "sharding") and x.ndim >= 2
              and any(d % 8 == 0 for d in x.shape)]
    assert any(not l.sharding.is_fully_replicated for l in leaves)


def test_tensor_parallel_step_matches_unsharded():
    """dp x tp (4x2) mesh: transformer projection weights sharded over
    `model` (tensor_parallel.py policy), GSPMD inserting the collectives.
    First-step loss must match the unsharded step (up to reassociation),
    the to_q kernels and their Adam moments must actually be sharded, and
    training must progress."""
    from jax.sharding import PartitionSpec as P
    from stablemtl_tpu.parallel import MeshConfig, tp_param_specs

    mesh = make_mesh(MeshConfig(model=2))
    assert mesh.shape == {"data": 4, "model": 2}
    pipe = _pipeline()
    cfg = OptimizerConfig(lr=1e-3, use_schedule=False)

    specs = tp_param_specs(pipe.unet_params, mesh)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, P))
    n_sharded = sum(1 for s in spec_leaves if s != P())
    assert n_sharded >= 32, f"TP policy sharded only {n_sharded} params"

    state_ref = create_train_state(pipe.unet_params, cfg)
    step_ref = make_train_step(pipe, donate=False)

    state_tp = create_train_state(pipe.unet_params, cfg)
    state_tp = shard_train_state(state_tp, mesh, zero1=True, tp=True,
                                 zero1_min_size=0)
    step_tp = make_sharded_train_step(pipe, mesh, zero1=True, tp=True,
                                      zero1_min_size=0,
                                      donate=False)

    # a to_q kernel is physically sharded over `model`
    qk = state_tp.params["params"]["down_blocks_0_attentions_0"][
        "transformer_blocks_0"]["attn1"]["to_q"]["kernel"]
    assert qk.sharding.spec == P(None, "model"), qk.sharding.spec
    b = _batch(seed=3)
    state_ref, m_ref = step_ref(state_ref, b)
    state_tp, m_tp = step_tp(state_tp, shard_batch(b, mesh))
    # looser than the pure-DP test: TP resharding (row-parallel partial
    # sums, GEGLU half-splits) changes reduction order through the random
    # untrained GroupNorm chains, which amplify ~1e-7 to ~1e-2 (same
    # effect documented at test_infer_all_tasks_data_parallel); measured
    # delta here is ~5e-3 relative
    np.testing.assert_allclose(float(m_ref["loss"]), float(m_tp["loss"]),
                               rtol=2e-2)

    losses = [float(m_tp["loss"])]
    for i in range(1, 4):
        state_tp, m_tp = step_tp(state_tp, shard_batch(_batch(seed=3), mesh))
        losses.append(float(m_tp["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state_tp.step) == 4

    # optimizer moments mirror the TP layout somewhere in the tree
    mom = [x for x in jax.tree_util.tree_leaves(state_tp.opt_state)
           if hasattr(x, "sharding")
           and x.sharding.spec == P(None, "model")]
    assert mom, "expected TP-sharded optimizer moments"


def test_tp_spec_policy_unit():
    """The path->PartitionSpec policy itself (no compiles): col/row
    mapping, divisibility guards, bank specs, moment-path mirroring."""
    from jax.sharding import PartitionSpec as P
    from stablemtl_tpu.parallel import MeshConfig, tp_spec
    from stablemtl_tpu.parallel.tensor_parallel import opt_leaf_param_names

    mesh2 = make_mesh(MeshConfig(model=2))
    mesh1 = make_mesh(MeshConfig(model=1))

    # column-parallel: attention inputs shard the OUTPUT features
    assert tp_spec(("attn1", "to_q", "kernel"), (32, 32), mesh2) \
        == P(None, "model")
    assert tp_spec(("ff", "net_0", "proj", "kernel"), (32, 256), mesh2) \
        == P(None, "model")
    # row-parallel: output projections shard the INPUT features
    assert tp_spec(("attn1", "to_out_0", "kernel"), (32, 32), mesh2) \
        == P("model", None)
    # column-parallel bias shards; row-parallel bias must NOT
    assert tp_spec(("attn2", "to_k", "bias"), (32,), mesh2) == P("model")
    assert tp_spec(("attn1", "to_out_0", "bias"), (32,), mesh2) == P()
    # non-divisible feature dims stay replicated
    assert tp_spec(("attn1", "to_q", "kernel"), (32, 33), mesh2) == P()
    # unknown modules (convs, norms) stay replicated
    assert tp_spec(("conv1", "kernel"), (3, 3, 32, 32), mesh2) == P()
    assert tp_spec(("norm1", "scale"), (32,), mesh2) == P()
    # cross-task banks [T, din, dout]: fc1 col / fc2 row
    assert tp_spec(("task_attn", "task_to_k_fc1_kernel"), (7, 32, 16),
                   mesh2) == P(None, None, "model")
    assert tp_spec(("task_attn", "task_to_v_fc2_kernel"), (7, 16, 32),
                   mesh2) == P(None, "model", None)
    # model=1 mesh: everything replicated
    assert tp_spec(("attn1", "to_q", "kernel"), (32, 32), mesh1) == P()

    # moment-path mirroring: the param path is the suffix after 'params'
    class K:  # DictKey lookalike
        def __init__(self, key):
            self.key = key

    path = (K("0"), K("mu"), K("params"), K("attn1"), K("to_q"), K("kernel"))
    assert opt_leaf_param_names(path) == ("attn1", "to_q", "kernel")
    assert opt_leaf_param_names((K("count"),)) is None


def test_shard_batch_rejects_indivisible_leading_dim():
    import pytest

    mesh = make_mesh()  # 8 data devices
    bad = _batch(B=5)  # 5 % 8 != 0 — must fail loudly, not replicate
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(bad, mesh)
    # scalars (task_idx) and divisible batches still place fine
    out = shard_batch(_batch(B=8), mesh)
    assert out["task_idx"].sharding.is_fully_replicated
    assert not out["rgb_norm"].sharding.is_fully_replicated


def test_zero1_min_size_replicates_small_leaves():
    """Production ZeRO-1 policy: tiny moments replicate (an all-gather per
    step would cost more than the memory saved); big ones shard."""
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh()
    small = _zero1_sharding_for(jnp.zeros((16, 16)), mesh, min_size=65536)
    assert small.spec in (P(), P(None, None))
    big = _zero1_sharding_for(jnp.zeros((512, 512)), mesh, min_size=65536)
    assert big.spec == P("data", None)
