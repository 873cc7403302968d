"""PyTorch port, the training slice: the multi-stream training step (loss,
every trainable gradient, the updated parameters) against
`stablemtl_tpu`'s loss assembled as its `make_train_step` assembles it, the
task-masking strategies, the valid-mask pooling, the masked loss, the
schedule, and the optimizer against optax; f32 on the CPU.

The JAX side jits no train step (optimizer included, it costs minutes of
compile on a CPU): it jits `value_and_grad` of the loss, with the frozen
parameters, the batch and the task index as arguments, so both tasks share
one compile (measured 46 s against 60 s + 11 s for two eager calls), and
`infer` the same way (35 s for both tasks against 75 s eager). The optax
update runs eagerly on the parameters raveled into one vector: Adam and the
global-norm clip act elementwise and on the whole vector alike, and the
jitted update of the tree measured 32 s of compile.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stablemtl_tpu.models import AutoencoderKL as JVAE
from stablemtl_tpu.models import UNet2DConditionModel as JUNet
from stablemtl_tpu.models.transformer import \
    TaskAttentionBank as JTaskAttentionBank
from stablemtl_tpu.models.unet import tiny_unet_config as j_tiny_unet
from stablemtl_tpu.models.vae import tiny_vae_config as j_tiny_vae
from stablemtl_tpu.pipeline import StableMTLPipeline as JPipeline
from stablemtl_tpu.train_state import OptimizerConfig as JOptimizerConfig
from stablemtl_tpu.train_state import \
    downsample_valid_mask as j_downsample_valid_mask
from stablemtl_tpu.train_state import make_optimizer as j_make_optimizer
from stablemtl_tpu.utils.loss import masked_mean as j_masked_mean
from stablemtl_tpu.utils.loss import mse_loss as j_mse_loss
from stablemtl_tpu.utils.schedules import \
    iter_exponential_ratio as j_iter_exponential_ratio
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.factory import model_configs
from stablemtl_tpu_torch.models.convert import state_dict_from_flax
from stablemtl_tpu_torch.models.transformer import TaskAttentionBank
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             task_feat_shapes,
                                             tiny_unet_config)
from stablemtl_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
from stablemtl_tpu_torch.pipeline import StableMTLPipeline
from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                             create_train_state,
                                             downsample_valid_mask,
                                             make_eval_step, make_optimizer,
                                             make_train_step)
from stablemtl_tpu_torch.utils.loss import masked_mean, mse_loss
from stablemtl_tpu_torch.utils.schedules import (IterExponential,
                                                 iter_exponential_ratio)
from stablemtl_tpu_torch.utils.seeding import step_generator
from torch_port_helpers import load_port, random_params
from torch_port_helpers import one_torch_thread  # noqa: F401

T = len(TASKS)
HW = (16, 16)
# the masked path compared across packages: every layer masks (ratio 1) the
# key of highest mean probability, which draws no random number that
# decides anything
TRAINER = dict(attn_mask_ratio=1.0, attn_mask_type="highest")
# one single-frame and one two-frame task
STEP_TASKS = (TASKS.index("depth"), TASKS.index("optical_flow"))


@pytest.fixture(scope="module")
def pipes():
    """The tiny multi-stream pipeline of tests/test_multistream_train.py
    (tiny VAE, frozen tiny child, tiny main UNet with task attention) on one
    set of random weights in both packages. Every leaf is random (also the
    zero-initialized task output projection), so every bank parameter gets
    a gradient."""
    lat = np.zeros((1, HW[0] // 8, HW[1] // 8, 12), np.float32)
    t0 = np.zeros((1,), np.int32)
    ctx = np.zeros((1, 4, 32), np.float32)
    vae = JVAE(j_tiny_vae())
    vae_p = random_params(vae.init, np.zeros((1, *HW, 3), np.float32),
                          seed=31)
    child = JUNet(j_tiny_unet())
    child_p = random_params(child.init, lat, t0, ctx, seed=32)
    unet = JUNet(j_tiny_unet(use_task_attention=True, **TRAINER))
    feats = [jnp.zeros((T - 1, 1, n, c))
             for n, c in task_feat_shapes(tiny_unet_config(), *lat.shape[1:3])]
    unet_p = random_params(
        lambda k, x, t, c: unet.init(k, x, t, c, task_feats=feats,
                                     main_idx=jnp.asarray(0),
                                     aux_idx=jnp.arange(1, T)),
        lat, t0, ctx, seed=33)
    table = (np.random.RandomState(34).standard_normal((T, 4, 32)) * 0.5
             ).astype(np.float32)
    jpipe = JPipeline(vae=vae, unet=unet, vae_params=vae_p,
                      unet_params=unet_p, text_embed_table=jnp.asarray(table),
                      unet_child=child, unet_child_params=child_p)
    tunet = load_port(UNet2DConditionModel(
        tiny_unet_config(use_task_attention=True, **TRAINER)), unet_p)
    tpipe = StableMTLPipeline(
        vae=load_port(AutoencoderKL(tiny_vae_config()), vae_p).requires_grad_(
            False),
        unet=tunet.train(),
        unet_child=load_port(UNet2DConditionModel(tiny_unet_config()),
                             child_p).requires_grad_(False),
        text_embed_table=torch.from_numpy(table), image_hw=HW)
    return jpipe, tpipe


def _batch(task, seed, batch=2):
    r = np.random.RandomState(seed)
    rgb, nxt, gt = (r.uniform(-1, 1, (batch, *HW, 3)).astype(np.float32)
                    for _ in range(3))
    valid = r.uniform(size=(batch, *HW, 1)) > 0.01  # a few invalid pixels
    return {"rgb_norm": rgb, "rgb_next_norm": nxt, "target_3ch": gt,
            "valid_mask": valid, "task_idx": np.int32(task)}


def _jax_value_and_grad(jpipe):
    """value_and_grad of the JAX package's training loss
    (train_state.py:211-235, through its own encode_rgb / unet_forward /
    downsample_valid_mask / masked_mean): (params, frozen, batch) -> (loss,
    grads). The frozen VAE, child and text table are arguments, as in the
    JAX package's own step: closed over, XLA would bake them into the
    program as constants."""

    def loss_fn(params, frozen, batch):
        pipe = dataclasses.replace(
            jpipe, unet_params=params, vae_params=frozen["vae"],
            unet_child_params=frozen["child"],
            text_embed_table=frozen["text"])
        stacked = jnp.concatenate([batch["rgb_norm"], batch["rgb_next_norm"],
                                   batch["target_3ch"]])
        lat_all = jax.lax.stop_gradient(pipe.encode_rgb(stacked))
        lat, lat_next, gt_latent = jnp.split(lat_all, 3)
        pred = pipe.unet_forward(lat, lat_next, batch["task_idx"],
                                 params=params, train=True,
                                 rngs={"taskmask": jax.random.PRNGKey(0)})
        mask = j_downsample_valid_mask(batch["valid_mask"])
        return j_masked_mean((pred.astype(jnp.float32) - gt_latent) ** 2,
                             jnp.broadcast_to(mask, pred.shape))

    return jax.jit(jax.value_and_grad(loss_fn))


# The port's step at these settings (a step's own updates are checked
# against the updates optax makes from the JAX grads). eps=1 keeps Adam's
# first update proportional to the grad: with eps ~1e-8 it is lr*sign(g),
# which turns the rounding of near-zero grads into whole-lr flips.
STEP_CFG = dict(lr=1e-3, use_schedule=False, eps=1.0)


@pytest.fixture(scope="module")
def value_and_grad(pipes):
    """The jitted JAX loss and gradient, compiled once for this file's
    batch shapes and dtypes, and its frozen arguments."""
    jpipe, _ = pipes
    frozen = {"vae": jpipe.vae_params, "child": jpipe.unet_child_params,
              "text": jpipe.text_embed_table}
    return _jax_value_and_grad(jpipe), frozen


@pytest.fixture(scope="module")
def reference_steps(pipes, value_and_grad):
    """{task: (batch, JAX loss, JAX grads by port name, JAX updates by port
    name, JAX params after the update by port name)}: the JAX side computed
    once per task, the update by the JAX package's own make_optimizer."""
    jpipe, _ = pipes
    value_and_grad, frozen = value_and_grad
    tx = j_make_optimizer(JOptimizerConfig(**STEP_CFG))
    leaves, treedef = jax.tree_util.tree_flatten(jpipe.unet_params)
    sizes = np.cumsum([leaf.size for leaf in leaves])[:-1]

    def ravel(tree):
        return jnp.asarray(np.concatenate(
            [np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(tree)]))

    def unravel(vec):
        parts = np.split(np.asarray(vec), sizes)
        return jax.tree_util.tree_unflatten(
            treedef, [p.reshape(leaf.shape) for p, leaf in zip(parts, leaves)])

    def optax_step(grads, params):
        """optax's update of the tree, on the raveled vector (on the tree,
        eager optax dispatches ~10 ops a leaf: 36 s)."""
        flat = ravel(params)
        updates, _ = tx.update(ravel(grads), tx.init(flat), flat)
        return unravel(updates), unravel(optax.apply_updates(flat, updates))

    out = {}
    for i, task in enumerate(STEP_TASKS):
        batch = _batch(task, seed=40 + i)
        loss, grads = value_and_grad(
            jpipe.unet_params, frozen,
            {k: jnp.asarray(v) for k, v in batch.items()})
        updates, new = optax_step(grads, jpipe.unet_params)
        out[task] = (batch, float(loss), state_dict_from_flax(grads),
                     state_dict_from_flax(updates), state_dict_from_flax(new))
    return out


@pytest.mark.parametrize("task", STEP_TASKS, ids=["depth", "optical_flow"])
def test_train_step_matches_jax(pipes, reference_steps, task):
    """Loss within 1e-5 and every trainable leaf's grad within 1e-4 of that
    leaf's max |grad| (the composed-model bar); then the port's
    make_train_step leaves each parameter where optax's update from the JAX
    grads does, within 1e-4 of that leaf's max |update| plus one f32 ulp of
    the parameter (both sides round p + u)."""
    _, tpipe = pipes
    batch, j_loss, j_grads, j_updates, j_new = reference_steps[task]
    state = create_train_state(tpipe.unet, OptimizerConfig(**STEP_CFG))
    step = make_train_step(tpipe)
    loss, _, grads = step.loss_and_grads(state, batch)
    assert abs(float(loss) - j_loss) <= 1e-5, (float(loss), j_loss)
    assert set(state.params) == set(j_grads)
    for (name, p), g in zip(state.params.items(), grads):
        want = j_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = step(state, batch)
    assert state.step == 1 and float(metrics["nan_pred"]) == 0.0
    try:
        for name, p in state.params.items():
            want = j_new[name].numpy()
            bar = (1e-4 * float(np.abs(j_updates[name].numpy()).max())
                   + np.spacing(np.abs(want)))
            err = np.abs(p.detach().numpy() - want)
            assert (err <= bar).all(), (name, float((err - bar).max()))
    finally:
        with torch.no_grad():
            for name, p in state.params.items():
                p.copy_(before[name])


def test_loader_batch_loss_matches_jax(pipes, value_and_grad,
                                       tmp_path_factory):
    """The slice end to end: the first batch of both packages'
    build_train_loader over a synthetic vkitti depth tree at HW (bit-equal
    batches), through the port's step and the JAX loss (already compiled
    for these shapes and dtypes): the losses agree to 1e-5."""
    from stablemtl_tpu.config import Config as JConfig
    from stablemtl_tpu.factory import build_train_loader as j_build_loader
    from stablemtl_tpu_torch.config import Config
    from stablemtl_tpu_torch.factory import build_train_loader
    from torch_port_helpers import write_vkitti_tree

    root = tmp_path_factory.mktemp("port_train_vkitti")
    write_vkitti_tree(str(root / "vkitti"))
    cfg = {"dataset": {"train": {"dataset_list": [{
        "name": "vkitti_depth", "dir": "vkitti",
        "filenames": str(root / "vkitti/depth.txt"),
        "resize_to_hw": list(HW)}]}},
        "dataloader": {"prefetch": 0},
        "depth_normalization": {"type": "scale_shift_depth", "clip": True,
                                "norm_min": -1.0, "norm_max": 1.0,
                                "min_max_quantile": 0.02},
        "augmentation": {"default": {"enabled": True,
                                     "random_horizontal_flip":
                                         {"enabled": True}}}}
    keys = ("rgb_norm", "rgb_next_norm", "target_3ch", "valid_mask",
            "task_idx")
    batches = [next(build(cfg_cls(cfg), str(root), 1, 2, seed=3).batches())
               for build, cfg_cls in ((j_build_loader, JConfig),
                                      (build_train_loader, Config))]
    for k in keys:
        np.testing.assert_array_equal(batches[0][k], batches[1][k], k)
    batch = {k: batches[1][k] for k in keys}
    assert batch["rgb_norm"].shape == (2, *HW, 3)
    assert int(batch["task_idx"]) == TASKS.index("depth")

    jpipe, tpipe = pipes
    fn, frozen = value_and_grad
    j_loss, _ = fn(jpipe.unet_params, frozen,
                   {k: jnp.asarray(v) for k, v in batch.items()})
    state = create_train_state(tpipe.unet, OptimizerConfig(**STEP_CFG))
    loss, _, _ = make_train_step(tpipe).loss_and_grads(state, batch)
    assert abs(float(loss) - float(j_loss)) <= 1e-5, (float(loss),
                                                      float(j_loss))


def test_train_steps_finite_and_child_frozen(pipes):
    """Four steps at lr 1e-3 (as test_multistream_train does for JAX) give
    finite losses under the flagship masking (attn_prob at 0.4), with
    gradient accumulation 2; the frozen child is not in the graph."""
    _, pipe = pipes
    banks = _banks(pipe.unet)
    for bank in banks:
        bank.attn_mask_ratio, bank.attn_mask_type = 0.4, "attn_prob"
    before = {n: p.detach().clone() for n, p in pipe.unet.named_parameters()}
    try:
        state = create_train_state(pipe.unet, OptimizerConfig(
            lr=1e-3, use_schedule=False, accumulation_steps=2))
        step = make_train_step(pipe, base_seed=5)
        losses = []
        for i in range(4):
            state, m = step(state, _batch(i % T, seed=50 + i))
            losses.append(float(m["loss"]))
        assert np.all(np.isfinite(losses)), losses
        assert state.step == 4 and state.opt.count == 2
        changed = [n for n, p in state.params.items()
                   if not torch.equal(p, before[n])]
        # all but attn1's to_q/to_k at the 1x1 stages of a 16x16 input,
        # where self-attention over one token has no q/k gradient
        unchanged = set(state.params) - set(changed)
        assert all(".attn1.to_q." in n or ".attn1.to_k." in n
                   for n in unchanged), sorted(unchanged)
        assert len(unchanged) < len(state.params) // 20
        # the child is frozen and runs under no_grad: it gets no gradient
        # even when its parameters ask for one
        pipe.unet_child.requires_grad_(True)
        batch = _batch(1, seed=60)
        lat = pipe.encode_rgb(torch.from_numpy(batch["rgb_norm"]))
        pred = pipe.unet_forward(lat, lat, 1, step_generator(0, 0),
                                 train=True)
        child = list(pipe.unet_child.parameters())
        assert all(g is None for g in torch.autograd.grad(
            pred.square().mean(), child, allow_unused=True))
    finally:
        pipe.unet_child.requires_grad_(False)
        for bank in banks:
            bank.attn_mask_ratio = TRAINER["attn_mask_ratio"]
            bank.attn_mask_type = TRAINER["attn_mask_type"]
        with torch.no_grad():
            for n, p in pipe.unet.named_parameters():
                p.copy_(before[n])


def test_infer_and_eval_step_match_fused_path(pipes):
    """Single-task inference (`infer`: child features of the auxiliary
    tasks, K/V projected per call) equals the JAX package's `infer` on the
    same weights and images (1e-4, the composed-model bar; jitted) and
    that task's slice of the port's fused path (all-task K/V tables, the
    main task's key biased to -1e9); make_eval_step runs `infer` on a
    batch."""
    jpipe, tpipe = pipes
    r = np.random.RandomState(70)
    rgb_np, nxt_np = (r.uniform(-1, 1, (2, *HW, 3)).astype(np.float32)
                      for _ in range(2))
    rgb, nxt = torch.from_numpy(rgb_np), torch.from_numpy(nxt_np)
    fused = tpipe.infer_tasks(rgb, nxt, list(STEP_TASKS))
    eval_step = make_eval_step(tpipe)
    # the JAX package's `infer`, its parameters and the task as arguments
    # (one compile for both tasks)
    params = {"vae": jpipe.vae_params, "unet": jpipe.unet_params,
              "child": jpipe.unet_child_params,
              "text": jpipe.text_embed_table}
    j_infer = jax.jit(lambda p, x, y, t: dataclasses.replace(
        jpipe, vae_params=p["vae"], unet_params=p["unet"],
        unet_child_params=p["child"], text_embed_table=p["text"]
    ).infer(x, y, t))
    for i, task in enumerate(STEP_TASKS):
        got = tpipe.infer(rgb, nxt, task)
        assert got.shape == (2, *HW, 3)
        want = np.asarray(j_infer(params, jnp.asarray(rgb_np),
                                  jnp.asarray(nxt_np), jnp.int32(task)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"task {task} against JAX")
        np.testing.assert_allclose(got.numpy(), fused[i].numpy(), atol=1e-5)
        batch = {"rgb_norm": rgb, "rgb_next_norm": nxt, "task_idx": task}
        assert torch.equal(eval_step(batch), got)


def _banks(unet):
    return [m for m in unet.modules() if isinstance(m, TaskAttentionBank)]


# ---------------------------------------------------------------------------
# Masking, loss, schedule
# ---------------------------------------------------------------------------

def test_downsample_valid_mask_and_masked_mean_match_jax():
    r = np.random.RandomState(3)
    for shape in ((2, 16, 24, 1), (1, 40, 8, 1)):
        valid = r.uniform(size=shape) > 0.05
        want = np.asarray(j_downsample_valid_mask(jnp.asarray(valid)))
        got = downsample_valid_mask(torch.from_numpy(valid))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        x = r.standard_normal(want.shape[:3] + (4,)).astype(np.float32)
        m = np.broadcast_to(want, x.shape)
        np.testing.assert_allclose(
            float(masked_mean(torch.from_numpy(x), torch.from_numpy(m))),
            float(j_masked_mean(jnp.asarray(x), jnp.asarray(m))), rtol=1e-6)
        y = r.standard_normal(x.shape).astype(np.float32)
        for mask in (None, m):
            np.testing.assert_allclose(
                float(mse_loss(torch.from_numpy(x), torch.from_numpy(y),
                               None if mask is None
                               else torch.from_numpy(mask))),
                float(j_mse_loss(jnp.asarray(x), jnp.asarray(y), mask)),
                rtol=1e-6)
    # an all-invalid mask divides by max(0, 1)
    zero = torch.zeros(2, 3)
    assert float(masked_mean(torch.ones(2, 3), zero)) == 0.0


def test_iter_exponential_ratio_matches_jax():
    total, final, warm = 25_000, 0.01, 100
    sched = IterExponential(total, final, warm)
    for n in (0, 1, 99, 100, 101, 5000, total, total + 1):
        want = float(j_iter_exponential_ratio(n, total, final, warm))
        assert iter_exponential_ratio(n, total, final, warm) == \
            pytest.approx(want, rel=1e-6, abs=1e-9), n
        assert sched(n) == pytest.approx(want, rel=1e-6, abs=1e-9), n
    assert iter_exponential_ratio(7, 10, 0.5) == pytest.approx(0.5 ** 0.7)


def _bank(kind, ratio=1.0):
    return TaskAttentionBank(dim=8, n_tasks=T, attn_mask_ratio=ratio,
                             attn_mask_type=kind)


def _scores(seed, k=1, t=T - 1):
    """Scores [K, B, N, h, T] (the port's layout), the same for every
    stream."""
    r = np.random.RandomState(seed)
    s = (r.standard_normal((1, 2, 5, 4, t)) * 1.5).astype(np.float32)
    return np.repeat(s, k, axis=0)


def test_mask_mean_probs_and_highest_match_jax():
    """The mean attention distribution the picks draw from equals the JAX
    bank's (1e-6), and 'highest' masks the same key as JAX's `_mask_bias`
    at ratio 1."""
    scores = _scores(seed=7)
    want_probs = np.asarray(jax.nn.softmax(jnp.asarray(scores[0]), axis=-1)
                            .mean(axis=(0, 1, 2)))
    got_probs = torch.softmax(torch.from_numpy(scores), -1).mean((1, 2, 3))
    np.testing.assert_allclose(got_probs[0].numpy(), want_probs, atol=1e-6)
    jbank = JTaskAttentionBank(dim=8, n_tasks=T, attn_mask_ratio=1.0,
                               attn_mask_type="highest")
    want = jbank.apply({}, jnp.asarray(scores[0]), T - 1, True,
                       method=JTaskAttentionBank._mask_bias,
                       rngs={"taskmask": jax.random.PRNGKey(0)})
    got = _bank("highest")._mask_bias(torch.from_numpy(scores), True,
                                      torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert int(np.argmin(np.asarray(want))) == int(want_probs.argmax())
    # no masking at inference or with ratio 0, and no generator needed
    assert _bank("highest")._mask_bias(torch.from_numpy(scores), False) \
        is None
    assert _bank("highest", 0.0)._mask_bias(torch.from_numpy(scores),
                                            True) is None


def test_mask_attn_prob_frequencies():
    """2000 streams of one score tensor: 'attn_prob' picks each key with
    its mean probability, within 4 sigma."""
    n = 2000
    scores = torch.from_numpy(_scores(seed=8, k=n))
    probs = torch.softmax(scores[0], -1).mean((0, 1, 2)).numpy()
    bias = _bank("attn_prob")._mask_bias(scores, True,
                                         torch.Generator().manual_seed(1))
    picks = (bias < 0).numpy()
    assert (picks.sum(1) == 1).all()
    freq = picks.mean(0)
    sigma = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(freq - probs) <= 4 * sigma + 1e-9).all(), (freq, probs)


def test_mask_strategies_respect_key_valid_and_gate():
    n, excluded = 2000, 3
    scores = torch.from_numpy(_scores(seed=9, k=n, t=T))
    valid = torch.ones(n, T, dtype=torch.bool)
    valid[:, excluded] = False
    scores[..., excluded] = -1e9  # the task_kv layout's excluded key
    gen = torch.Generator().manual_seed(2)
    for kind in ("random", "attn_prob_random_k"):
        picks = _bank(kind)._mask_bias(scores, True, gen, valid) < 0
        assert not picks[:, excluded].any(), kind
        counts = picks.sum(1)
        if kind == "random":
            assert (counts == 1).all()
            assert (picks.float().mean(0)[valid[0]] > 0.1).all()
        else:  # 1..n_real-1 keys, both ends reached
            assert counts.min() == 1 and counts.max() == T - 2
    # the gate fires with probability attn_mask_ratio
    fired = (_bank("random", 0.4)._mask_bias(scores, True, gen, valid) < 0
             ).any(1).float().mean().item()
    assert abs(fired - 0.4) <= 4 * np.sqrt(0.4 * 0.6 / n), fired
    with pytest.raises(ValueError, match="generator"):
        _bank("random")._mask_bias(scores, True)
    with pytest.raises(ValueError, match="attn_mask_type"):
        _bank("nope")._mask_bias(scores, True, gen)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

_OPT_CASES = {
    "adam": dict(),
    "adamw": dict(optimizer="adamw"),
    "clip_active": dict(max_grad_norm=0.5),
    "warmup_schedule": dict(use_schedule=True, warmup_steps=2,
                            total_iters=10, final_ratio=0.1),
    "multisteps_k2": dict(accumulation_steps=2, max_grad_norm=0.5),
}


@pytest.mark.parametrize("case", list(_OPT_CASES))
def test_optimizer_matches_optax(case):
    """Three updates on the same grads: each parameter change within 1e-6
    of optax's largest. Parameters are small beside lr 0.5, so the f32
    rounding of p + u stays far below that bar. Leaf 'c' has no grad in the
    port (None) and zeros in optax: it is still updated."""
    kw = dict(lr=0.5, use_schedule=False, max_grad_norm=100.0)
    kw.update(_OPT_CASES[case])
    r = np.random.RandomState(len(case))
    shapes = {"a": (5, 4), "b": (7,), "c": (3, 2)}
    params = {k: (r.standard_normal(s) * 0.01).astype(np.float32)
              for k, s in shapes.items()}
    tx = j_make_optimizer(JOptimizerConfig(**kw))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = make_optimizer(t_params, OptimizerConfig(**kw))
    k_micro = kw.get("accumulation_steps", 1)
    for i in range(3 * k_micro):
        grads = {k: (r.standard_normal(s) * 2).astype(np.float32)
                 for k, s in shapes.items()}
        grads["c"] = np.zeros(shapes["c"], np.float32)
        j_before = {k: np.asarray(v) for k, v in j_params.items()}
        t_before = [t.clone() for t in t_params]
        upd, j_state = tx.update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        changed = opt.update([torch.from_numpy(grads["a"]),
                              torch.from_numpy(grads["b"]), None])
        assert changed == ((i + 1) % k_micro == 0)
        for t, t0, key in zip(t_params, t_before, shapes):
            want = np.asarray(j_params[key]) - j_before[key]
            got = (t - t0).numpy()
            if not changed:
                assert not want.any() and not got.any()
                continue
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()),
                err_msg=f"{case} update {i} {key}")
    if case == "warmup_schedule":  # lr(0) = 0: the first update is a no-op
        assert opt.learning_rate(0) == 0.0


def test_optimizer_rejects_unported_options():
    """The single-chip options build (adafactor, mu_dtype, apply_if_finite;
    tests/test_torch_port_train_options.py holds them against optax), an
    unknown optimizer name raises, and the training config's remat keys
    reach the main UNet, never the child."""
    p = [torch.zeros(2), torch.zeros(256, 128)]
    for kw in (dict(optimizer="adafactor"), dict(mu_dtype="bfloat16"),
               dict(skip_nonfinite_updates=3),
               dict(optimizer="adafactor", skip_nonfinite_updates=3,
                    accumulation_steps=2)):
        opt = make_optimizer(p, OptimizerConfig(**kw))
        steps = [opt.update([torch.ones(2), torch.ones(256, 128)])
                 for _ in range(kw.get("accumulation_steps", 1))]
        assert steps[-1] and opt.count == 1
    assert make_optimizer(p, OptimizerConfig(mu_dtype="bfloat16")).mu[
        0].dtype == torch.bfloat16
    factored = make_optimizer(p, OptimizerConfig(optimizer="adafactor"))
    assert factored.v[0].shape == (2,) and factored.v[1] is None
    # optax's v_row drops the largest dimension, v_col the second largest
    assert factored.v_row[1].shape == (128,)
    assert factored.v_col[1].shape == (256,)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(p, OptimizerConfig(optimizer="sgd"))
    for kw in (dict(remat=True), dict(remat_transformer="dots"),
               dict(remat=True, remat_transformer="full")):
        ucfg, ccfg, _, _ = model_configs("tiny", True, TRAINER, **kw)
        assert not (ccfg.remat or ccfg.remat_transformer != "none")
        assert (ucfg.remat, ucfg.remat_transformer) == (
            kw.get("remat", False), kw.get("remat_transformer", "none"))
        UNet2DConditionModel(ucfg)
