"""PyTorch port, the single-chip training options: Adafactor, Adam's
first moment in bf16 (`mu_dtype`) and `apply_if_finite`
(`skip_nonfinite_updates`) against optax as the JAX package chains them,
and activation recompute (`remat`, `remat_transformer` full and dots) in
the tiny multi-stream training step with task masking on: bit-equal to no
recompute on the CPU, the masking generator left where it would be.

optax's update is jitted, as the JAX package's step always is (compiled,
XLA keeps Adam's bf16 b1 * mu in f32 and fuses the sum; optax's MultiSteps
runs its inner update compiled anyway, under lax.cond), on small inputs:
the parameter vector raveled where the math is elementwise (Adam,
apply_if_finite), a few leaves of the tiny model (and three at SD2's
widths, where conv kernels factor) for Adafactor, whose factoring needs
each leaf's shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import _factored_dims

from stablemtl_tpu.train_state import OptimizerConfig as JOptimizerConfig
from stablemtl_tpu.train_state import make_optimizer as j_make_optimizer
from stablemtl_tpu_torch.factory import build_pipeline
from stablemtl_tpu_torch.models.transformer import TaskAttentionBank
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             tiny_unet_config)
from stablemtl_tpu_torch.train_state import (OptimizerConfig, eval_state,
                                             factored_dims, flax_axes,
                                             make_optimizer, make_train_step)
from torch_port_helpers import one_torch_thread  # noqa: F401

BANK = "down_blocks_0_attentions_0.transformer_blocks_0.task_attn."
# leaves of the tiny multi-stream UNet, one of each kind: factored (a tie
# of 128 x 128, a bank [7, 640, 640]) and not (dims below 128, 1-D)
TINY_LEAVES = ("time_embedding.linear_2.weight",
               "time_embedding.linear_1.weight",
               "down_blocks_0_resnets_0.conv1.weight",
               BANK + "task_to_q_net_2_kernel",
               BANK + "task_to_q_net_0_kernel",
               BANK + "task_norm_q_scale",
               "down_blocks_0_attentions_0.transformer_blocks_0.attn1."
               "to_q.weight",
               "conv_in.bias")
# at SD2's widths: conv kernels that factor (O != I, and a tie) and a Dense
SD2_LEAVES = {"sd2.conv.weight": (160, 128, 3, 3),
              "sd2.tie.weight": (128, 128, 3, 3),
              "sd2.dense.weight": (256, 128)}


def _leaf_shapes():
    with torch.device("meta"):
        unet = UNet2DConditionModel(tiny_unet_config(use_task_attention=True))
    shapes = dict(unet.named_parameters())
    out = {n: tuple(shapes[n].shape) for n in TINY_LEAVES}
    out.update(SD2_LEAVES)
    return out


def _to_flax(name, x):
    return np.ascontiguousarray(np.transpose(x, flax_axes(name, x.ndim)))


def test_factored_dims_follow_the_flax_layout():
    """The port factors the dimensions optax picks on the Flax leaf, also
    where two dimensions tie (which of the two optax takes then depends on
    numpy's argsort of the Flax shape, so the port sorts that shape)."""
    for name, shape in _leaf_shapes().items():
        axes = flax_axes(name, len(shape))
        fshape = tuple(shape[a] for a in axes)
        want = _factored_dims(fshape, True, 128)
        got = factored_dims(shape, axes)
        if want is None:
            assert got is None, name
        else:
            assert got == (axes[want[0]], axes[want[1]]), name
    assert factored_dims((128, 128, 3, 3), (2, 3, 1, 0)) == (1, 0)


def _grads(r, shapes, scale=2.0):
    return {k: (r.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _check_update(got, want, what):
    """got == want where want is NaN, else within 1e-6 of want's largest
    finite magnitude."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    if fin.any():
        bar = 1e-6 * float(np.abs(want[fin]).max())
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=bar,
                                   err_msg=what)


ADAFACTOR_CASES = {
    "adafactor": dict(),
    "adafactor_schedule_multisteps": dict(
        use_schedule=True, warmup_steps=1, total_iters=10, final_ratio=0.1,
        accumulation_steps=2),
    "adafactor_apply_if_finite": dict(skip_nonfinite_updates=2),
}


@pytest.mark.parametrize("case", list(ADAFACTOR_CASES))
def test_adafactor_matches_optax(case):
    """Four updates of the port's Adafactor and the JAX package's
    optax.adafactor chain on the same leaves, each leaf held in its own
    layout (the port's [out, in] and OIHW, Flax's [in, out] and HWIO):
    every parameter change within 1e-6 of optax's largest. The
    apply_if_finite case plants a NaN in the gradient of update 2 (skipped,
    nothing moves) and goes on with finite ones; its counters read as
    optax's."""
    kw = dict(lr=0.5, use_schedule=False, max_grad_norm=1e9,
              optimizer="adafactor")
    kw.update(ADAFACTOR_CASES[case])
    r = np.random.RandomState(len(case))
    shapes = _leaf_shapes()
    params = {k: (r.standard_normal(s) * 0.01).astype(np.float32)
              for k, s in shapes.items()}
    tx = j_make_optimizer(JOptimizerConfig(**kw))
    j_params = {k: jnp.asarray(_to_flax(k, v)) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = [torch.from_numpy(v.copy()) for v in params.values()]
    opt = make_optimizer(t_params, OptimizerConfig(**kw),
                         [flax_axes(k, len(s)) for k, s in shapes.items()])
    k_micro = kw.get("accumulation_steps", 1)
    update = jax.jit(tx.update)
    for i in range(4 * k_micro):
        grads = _grads(r, shapes)
        if "apply_if_finite" in case and i == 1:
            grads[BANK + "task_to_q_net_2_kernel"][3, 5, 7] = np.nan
        j_before = {k: np.asarray(v) for k, v in j_params.items()}
        t_before = [t.clone() for t in t_params]
        upd, j_state = update({k: jnp.asarray(_to_flax(k, v))
                               for k, v in grads.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        changed = opt.update([torch.from_numpy(g) for g in grads.values()])
        for t, t0, key in zip(t_params, t_before, shapes):
            want = np.asarray(j_params[key]) - j_before[key]
            got = _to_flax(key, (t - t0).numpy())
            if not changed:
                assert not want.any() and not got.any(), (i, key)
                continue
            _check_update(got, want, f"{case} micro-step {i} {key}")
    if "apply_if_finite" in case:
        st = j_state
        assert (opt.notfinite_count, opt.last_finite, opt.total_notfinite) \
            == (int(st.notfinite_count), bool(st.last_finite),
                int(st.total_notfinite)) == (0, True, 1)
        assert opt.count == 3


def _optax_states(state):
    """(apply_if_finite's state or None, ScaleByAdamState) of the JAX
    package's MultiSteps(apply_if_finite(chain(clip, adam)))."""
    state = getattr(state, "inner_opt_state", state)
    finite = state if hasattr(state, "notfinite_count") else None
    chain = state if finite is None else finite.inner_state
    return finite, chain[1][0]


ADAM_CASES = {
    "adam_mu_bf16": dict(mu_dtype="bfloat16"),
    "adamw_mu_bf16": dict(optimizer="adamw", mu_dtype="bfloat16"),
    "adam_mu_bf16_multisteps": dict(mu_dtype="bfloat16",
                                    accumulation_steps=2),
    # a NaN in micro-step 3 of 10 (the second accumulation): MultiSteps'
    # mean keeps it (its reset multiplies by 0), so every later update is
    # non-finite: updates 2 and 3 are skipped, update 4 (more than 2 in a
    # row) goes through and turns the parameters to NaN, as in optax
    "apply_if_finite_nan_mid_accumulation": dict(
        skip_nonfinite_updates=2, accumulation_steps=2),
    # a NaN in update 2, then finite ones: one skip
    "apply_if_finite_once": dict(skip_nonfinite_updates=3),
}


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_options_match_optax(case):
    """Adam with its first moment in bf16 at optax's cast points as the
    JAX package runs them, compiled (b1 rounded to bf16, b1 * mu + (1 -
    b1) * g rounded once to f32, mu stored rounded to bf16), and
    apply_if_finite around it, on the tiny model's leaves raveled: each
    update within 1e-6 of optax's largest, mu bit-equal to optax's, and
    apply_if_finite's counters as optax's."""
    kw = dict(lr=0.5, use_schedule=False, max_grad_norm=1e9)
    kw.update(ADAM_CASES[case])
    r = np.random.RandomState(len(case))
    n = int(sum(np.prod(s) for s in _leaf_shapes().values()))
    params = (r.standard_normal(n) * 0.01).astype(np.float32)
    tx = j_make_optimizer(JOptimizerConfig(**kw))
    j_params = jnp.asarray(params)
    j_state = tx.init(j_params)
    t_param = torch.from_numpy(params.copy())
    opt = make_optimizer([t_param], OptimizerConfig(**kw))
    k_micro = kw.get("accumulation_steps", 1)
    nan_at = {"apply_if_finite_nan_mid_accumulation": 2,
              "apply_if_finite_once": 1}.get(case)
    update = jax.jit(tx.update)
    skipped = []
    j_mark, t_mark = params, t_param.clone()
    for i in range(5 * k_micro):
        g = (r.standard_normal(n) * 2).astype(np.float32)
        if i == nan_at:
            g[12345] = np.nan
        t_before = t_param.clone()
        upd, j_state = update(jnp.asarray(g), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        changed = opt.update([torch.from_numpy(g)])
        if (i + 1) % k_micro:
            # inside an accumulation the port waits; optax adds 0 times
            # its inner update, which is NaN once that update is (so it
            # turns NaN one micro-step before the update that does)
            assert not changed and np.array_equal(
                t_param.numpy(), t_before.numpy(), equal_nan=True)
            continue
        if not changed:
            skipped.append(i // k_micro)
        _check_update((t_param - t_mark).numpy(),
                      np.asarray(j_params) - j_mark,
                      f"{case} micro-step {i}")
        j_mark, t_mark = np.asarray(j_params), t_param.clone()
    finite, adam = _optax_states(j_state)
    if finite is not None:
        assert (opt.notfinite_count, opt.last_finite, opt.total_notfinite) \
            == (int(finite.notfinite_count), bool(finite.last_finite),
                int(finite.total_notfinite))
    if case == "apply_if_finite_nan_mid_accumulation":
        assert skipped == [1, 2] and opt.total_notfinite == 4
        assert np.isnan(t_param.numpy()).all()
    if case == "apply_if_finite_once":
        assert skipped == [1] and opt.notfinite_count == 0
        assert opt.count == 4
    if "mu_bf16" in case:
        assert opt.mu[0].dtype == torch.bfloat16
        assert adam.mu.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            opt.mu[0].float().numpy(),
            np.asarray(adam.mu.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Activation recompute
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_step():
    """The tiny multi-stream pipeline (f32, trainable main UNet) with the
    flagship's task masking, attn_prob at 0.4, its training step and a
    two-frame batch, and the loss, grads, generator state and mask draws
    without recompute."""
    pipe = build_pipeline(
        {"model": {"size_preset": "tiny"},
         "trainer": {"multi_stream": True, "attn_mask_ratio": 0.4,
                     "attn_mask_type": "attn_prob"}},
        device="cpu", trainable=True, seed=3)
    state = eval_state(pipe.unet)
    state.params = {n: p for n, p in state.params.items()
                    if p.requires_grad}
    step = make_train_step(pipe, base_seed=5)
    r = np.random.RandomState(0)
    batch = {k: r.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
             for k in ("rgb_norm", "rgb_next_norm", "target_3ch")}
    batch["valid_mask"] = r.uniform(size=(2, 16, 16, 1)) > 0.01
    batch["task_idx"] = np.int32(3)
    return pipe, state, step, batch, _run(pipe, state, step, batch)


def _run(pipe, state, step, batch, monkeypatch=None):
    draws = []
    mask_bias = TaskAttentionBank._mask_bias

    def counted(self, *a, **kw):
        out = mask_bias(self, *a, **kw)
        draws.append(None if out is None else out.clone())
        return out

    TaskAttentionBank._mask_bias = counted
    try:
        gen = torch.Generator().manual_seed(11)
        loss, _, grads = step.loss_and_grads(state, batch, generator=gen)
    finally:
        TaskAttentionBank._mask_bias = mask_bias
    return loss, grads, gen.get_state(), draws


@pytest.mark.parametrize("remat,policy", [(True, "none"), (True, "full"),
                                          (True, "dots"), (False, "full")],
                         ids=["remat", "remat_full", "remat_dots",
                              "full_only"])
def test_remat_matches_no_remat(tiny_step, remat, policy):
    """Loss and every trainable gradient bit-equal to the step without
    recompute, and the generator's state after the step equal. A
    recomputed attention layer draws its masks again (twice the draws),
    and draws the same masks: without the replay of the generator's state
    the recompute would draw others and the gradients would be wrong."""
    pipe, state, step, batch, (loss0, grads0, gen0, draws0) = tiny_step
    base = pipe.unet.config
    pipe.unet.config = dataclasses.replace(base, remat=remat,
                                           remat_transformer=policy)
    try:
        loss, grads, gen, draws = _run(pipe, state, step, batch)
    finally:
        pipe.unet.config = base
    assert sum(d is not None and bool((d < 0).any()) for d in draws0) > 0
    assert torch.equal(loss, loss0)
    for name, g, g0 in zip(state.params, grads, grads0):
        assert torch.equal(g, g0), name
    assert torch.equal(gen, gen0)
    n = len(draws0)
    assert len(draws) == (2 * n if policy != "none" else n)
    if policy != "none":  # the backward recomputes the layers in reverse
        assert [d.tolist() for d in draws[n:]] == \
            [d.tolist() for d in draws[:n][::-1]]

@pytest.mark.parametrize("policy", ["full", "dots"])
def test_flash_function_under_recompute(policy):
    """The flash autograd Function (on the CPU, its plain versions) inside
    a recomputed region: output and q, k, v gradients bit-equal to
    without recompute."""
    from stablemtl_tpu_torch.models.unet import remat_call
    from stablemtl_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 2, 16, generator=gen).requires_grad_()
               for _ in range(3))
    do = torch.randn(2, 64, 2, 16, generator=gen)

    def layer(q, k, v):
        return flash_attention(q * 1.5, k, v).square()

    out = layer(q, k, v)
    want = torch.autograd.grad(out, (q, k, v), do)
    got_out = remat_call(layer, policy, None, q, k, v)
    got = torch.autograd.grad(got_out, (q, k, v), do)
    assert torch.equal(got_out, out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_transformer"):
        UNet2DConditionModel(tiny_unet_config(remat_transformer="some"))
