"""PyTorch port, block level: each module of the port against its Flax
counterpart on the same numpy inputs and weights (carried over by
state_dict_from_flax with strict loading), f32 on the CPU, at 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu.models import layers as jl
from stablemtl_tpu.models import transformer as jt
from stablemtl_tpu.models.vae import VAEAttention as JVAEAttention
from stablemtl_tpu_torch.models import layers as tl
from stablemtl_tpu_torch.models import transformer as tt
from stablemtl_tpu_torch.models.vae import VAEAttention
from torch_port_helpers import (assert_close, load_port, nhwc_to_nchw,
                                random_params)
from torch_port_helpers import one_torch_thread  # noqa: F401

ATOL = 2e-5
T = 7  # tasks


def _rand(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def test_timestep_embedding():
    t = np.array([0, 1, 500, 999], np.int32)
    want = jl.timestep_embedding(jnp.asarray(t), 32)
    got = tl.timestep_embedding(torch.from_numpy(t), 32)
    assert_close(got, want, atol=ATOL)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
def test_resnet_block(cin, cout):
    r = np.random.RandomState(cin + cout)
    x, temb = _rand(r, 2, 6, 5, cin), _rand(r, 2, 64)
    jm = jl.ResnetBlock(out_channels=cout, groups=8, eps=1e-5)
    params = random_params(jm.init, x, temb, seed=1)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(temb))
    tm = load_port(tl.ResnetBlock(cin, cout, 64, groups=8, eps=1e-5), params)
    got = tm(nhwc_to_nchw(x), torch.from_numpy(temb))
    assert_close(got.permute(0, 2, 3, 1), want, atol=ATOL)


@pytest.mark.parametrize("hw,out_size", [((4, 5), None), ((3, 5), (7, 9))],
                         ids=["2x", "odd"])
def test_upsample_conv(hw, out_size):
    r = np.random.RandomState(7)
    x = _rand(r, 2, *hw, 8)
    jm = jl.UpsampleConv(6)
    params = random_params(lambda k, x: jm.init(k, x, out_size), x, seed=2)
    want = jm.apply(params, jnp.asarray(x), out_size)
    tm = load_port(tl.UpsampleConv(8, 6), params)
    got = tm(nhwc_to_nchw(x), out_size)
    assert_close(got.permute(0, 2, 3, 1), want, atol=ATOL)


@pytest.mark.parametrize("tap", jt.TAP_POINTS)
def test_transformer2d_with_taps(tap):
    r = np.random.RandomState(3)
    x, ctx = _rand(r, 2, 4, 3, 32), _rand(r, 2, 5, 24)
    jm = jt.Transformer2D(heads=2, dim_head=16, norm_groups=8)
    params = random_params(lambda k, x, c: jm.init(k, x, c, tap=tap), x, ctx,
                           seed=3)
    want, want_tap = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx),
                              tap=tap)
    tm = load_port(tt.Transformer2D(32, 2, 16, 24, norm_groups=8), params)
    got, got_tap = tm(nhwc_to_nchw(x), torch.from_numpy(ctx), tap=tap)
    assert_close(got.permute(0, 2, 3, 1), want, atol=ATOL)
    assert_close(got_tap, want_tap, atol=ATOL)


def test_transformer2d_front_split():
    """front_only + front_state resumes to the same output as one call."""
    r = np.random.RandomState(4)
    x, ctx = _rand(r, 2, 4, 4, 32), _rand(r, 2, 5, 24)
    jm = jt.Transformer2D(heads=2, dim_head=16, norm_groups=8)
    params = random_params(jm.init, x, ctx, seed=4)
    tm = load_port(tt.Transformer2D(32, 2, 16, 24, norm_groups=8), params)
    xt, ct = nhwc_to_nchw(x), torch.from_numpy(ctx)
    whole, _ = tm(xt, ct)
    resumed, _ = tm(xt, ct, front_state=tm(xt, ct, front_only=True))
    assert_close(resumed, whole, atol=1e-6)
    want, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    assert_close(resumed.permute(0, 2, 3, 1), want, atol=ATOL)


def _bank(dim=32, seed=5):
    r = np.random.RandomState(seed)
    B, N = 2, 6
    hidden = _rand(r, B, N, dim)
    feats = _rand(r, T - 1, B, N, dim)
    jm = jt.TaskAttentionBank(dim=dim, n_tasks=T)
    aux = jnp.arange(1, T)
    params = random_params(
        lambda k, h, f: jm.init(k, h, f, jnp.asarray(0), aux), hidden, feats,
        seed=seed)
    tm = load_port(tt.TaskAttentionBank(dim, T), params)
    return r, jm, params, tm, hidden


def test_attention_split_qkv_matches_jax(monkeypatch):
    """Self-attention under STABLEMTL_NO_FUSED_QKV: q, k and v from three
    products (the port's to_q runs), against the JAX module under the same
    flag."""
    monkeypatch.setenv("STABLEMTL_NO_FUSED_QKV", "1")
    r = np.random.RandomState(9)
    x = _rand(r, 2, 12, 32)
    jm = jt.Attention(heads=2, dim_head=16, out_dim=32)
    params = random_params(jm.init, x, seed=9)
    want = jm.apply(params, jnp.asarray(x))
    tm = load_port(tt.Attention(32, 2, 16, 32), params)
    calls = []
    tm.to_q.register_forward_hook(lambda *args: calls.append(1))
    got = tm(torch.from_numpy(x))
    assert calls == [1]
    assert_close(got, want, atol=ATOL)
    monkeypatch.delenv("STABLEMTL_NO_FUSED_QKV")
    assert_close(tm(torch.from_numpy(x)), want, atol=ATOL)
    assert calls == [1]  # the fused product does not call to_q


@pytest.mark.parametrize("bmr", ["0", "1"], ids=["einsum", "bmr"])
def test_task_attention_bank_feats_form(monkeypatch, bmr):
    monkeypatch.setenv("STABLEMTL_TASKATTN_BMR", bmr)
    r, jm, params, tm, hidden = _bank()
    feats = _rand(r, T - 1, *hidden.shape)
    for main in (0, 3):
        aux = np.array([i for i in range(T) if i != main])
        want = jm.apply(params, jnp.asarray(hidden), jnp.asarray(feats),
                        jnp.asarray(main), jnp.asarray(aux))
        got = tm(torch.from_numpy(hidden), torch.from_numpy(feats),
                 torch.tensor(main), torch.from_numpy(aux))
        assert_close(got, want, atol=ATOL)


def test_task_attention_bank_shared_kv_form():
    """All-task K/V tables + -1e9 key bias, with 3 main streams folded into
    the batch (task-major), against one JAX call per stream."""
    r, jm, params, tm, hidden = _bank(seed=6)
    B, N, C = hidden.shape
    kv = (_rand(r, T, B, N, C), _rand(r, T, B, N, C))
    mains = [0, 3, 6]
    hid3 = _rand(r, len(mains), B, N, C)
    bias = np.where(np.arange(T)[None] == np.array(mains)[:, None], -1e9,
                    0.0).astype(np.float32)
    got = tm(torch.from_numpy(hid3.reshape(-1, N, C)), None,
             torch.tensor(mains), task_kv=tuple(map(torch.from_numpy, kv)),
             task_key_bias=torch.from_numpy(bias))
    got = got.reshape(len(mains), B, N, C)
    for s, main in enumerate(mains):
        want = jm.apply(params, jnp.asarray(hid3[s]), None,
                        jnp.asarray(main), None,
                        task_kv=tuple(map(jnp.asarray, kv)),
                        task_key_bias=jnp.asarray(bias[s]))
        assert_close(got[s], want, atol=ATOL)


def test_task_attention_bank_training_mask_not_ported():
    """Training-time task masking. The name dates from before masking was
    ported and is kept so the test's history stays in one place; it now
    holds the ported masking against JAX: the bank in train mode masking
    the key of highest mean probability at ratio 1 (no random draw decides
    it) matches the JAX bank at 2e-5, and differs from the unmasked output;
    masking without a generator raises."""
    r, _, params, _, hidden = _bank(seed=7)
    feats = _rand(r, T - 1, *hidden.shape)
    mask_kw = dict(attn_mask_ratio=1.0, attn_mask_type="highest")
    jm = jt.TaskAttentionBank(dim=32, n_tasks=T, **mask_kw)
    tm = load_port(tt.TaskAttentionBank(32, T, **mask_kw), params)
    main, aux = 2, np.array([0, 1, 3, 4, 5, 6])
    args = (torch.from_numpy(hidden), torch.from_numpy(feats),
            torch.tensor(main), torch.from_numpy(aux))
    want = jm.apply(params, jnp.asarray(hidden), jnp.asarray(feats),
                    jnp.asarray(main), jnp.asarray(aux), train=True,
                    rngs={"taskmask": jax.random.PRNGKey(0)})
    got = tm(*args, train=True, generator=torch.Generator().manual_seed(0))
    assert_close(got, want, atol=ATOL)
    assert (got - tm(*args)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="generator"):
        tm(*args, train=True)


def test_vae_attention():
    r = np.random.RandomState(8)
    x = _rand(r, 2, 4, 5, 32)
    jm = JVAEAttention(32, norm_groups=8)
    params = random_params(jm.init, x, seed=8)
    want = jm.apply(params, jnp.asarray(x))
    tm = load_port(VAEAttention(32, norm_groups=8), params)
    got = tm(nhwc_to_nchw(x))
    assert_close(got.permute(0, 2, 3, 1), want, atol=ATOL)


@pytest.mark.parametrize("fast", [False, True])
def test_feedforward_geglu(fast):
    r = np.random.RandomState(9)
    x = _rand(r, 2, 5, 16)
    jm = jl.FeedForward(16, fast_gelu=fast)
    params = random_params(jm.init, x, seed=9)
    want = jm.apply(params, jnp.asarray(x))
    got = load_port(tl.FeedForward(16, fast_gelu=fast), params)(
        torch.from_numpy(x))
    assert_close(got, want, atol=ATOL)


def test_convert_covers_every_leaf():
    """Every Flax leaf of a multi-stream block has a port parameter of the
    same path, and vice versa (load_port is strict)."""
    r = np.random.RandomState(10)
    x, ctx = _rand(r, 1, 2, 2, 32), _rand(r, 1, 3, 24)
    feats = _rand(r, T - 1, 1, 4, 32)
    jm = jt.Transformer2D(heads=2, dim_head=16, n_tasks=T,
                          use_task_attention=True, norm_groups=8)
    params = random_params(
        lambda k, x, c, f: jm.init(k, x, c, f, jnp.asarray(0),
                                   jnp.arange(1, T)), x, ctx, feats, seed=10)
    tm = load_port(tt.Transformer2D(32, 2, 16, 24, n_tasks=T,
                                    use_task_attention=True, norm_groups=8),
                   params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(tm.state_dict())
