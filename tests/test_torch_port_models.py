"""PyTorch port, composed models: the tiny UNet (output and all 16 taps,
single- and multi-stream) and the tiny VAE against the Flax models, f32 on
the CPU, at 1e-4. The Flax side runs jitted: one compile per geometry costs
less than eager op-by-op dispatch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu.models.unet import UNet2DConditionModel as JUNet
from stablemtl_tpu.models.unet import task_kv_tables as j_task_kv_tables
from stablemtl_tpu.models.unet import tiny_unet_config as j_tiny_unet
from stablemtl_tpu.models.vae import AutoencoderKL as JVAE
from stablemtl_tpu.models.vae import tiny_vae_config as j_tiny_vae
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             task_feat_shapes, task_kv_tables,
                                             tiny_unet_config)
from stablemtl_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
from torch_port_helpers import assert_close, load_port, random_params
from torch_port_helpers import one_torch_thread  # noqa: F401

TOL = 1e-4
T = 7
B = 2


def _rand(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jit(module, tap=None, method=None):
    kw = {"method": method} if method else {"tap": tap}
    return jax.jit(functools.partial(module.apply, **kw))


def _unet_pair(multi_stream: bool, seed: int):
    jcfg = j_tiny_unet(use_task_attention=multi_stream)
    jm = JUNet(jcfg)
    x = np.zeros((1, 4, 4, 12), np.float32)
    t = np.zeros((1,), np.int32)
    ctx = np.zeros((1, 3, 32), np.float32)
    if multi_stream:
        feats = [jnp.zeros((T - 1, 1, n, c)) for n, c in
                 task_feat_shapes(jcfg, 4, 4)]
        params = random_params(
            lambda k, x, t, c: jm.init(k, x, t, c, task_feats=feats,
                                       main_idx=jnp.asarray(0),
                                       aux_idx=jnp.arange(1, T)),
            x, t, ctx, seed=seed)
    else:
        params = random_params(jm.init, x, t, ctx, seed=seed)
    tm = load_port(UNet2DConditionModel(
        tiny_unet_config(use_task_attention=multi_stream)), params)
    return jm, params, tm


@pytest.fixture(scope="module")
def child_pair():
    return _unet_pair(False, seed=11)


@pytest.fixture(scope="module")
def main_pair():
    return _unet_pair(True, seed=12)


def _inputs(r, hw):
    return (_rand(r, B, *hw, 12), np.full((B,), 999, np.int32),
            _rand(r, B, 3, 32))


@pytest.mark.parametrize("hw", [(4, 4), (5, 3)], ids=["even", "odd"])
def test_unet_output_and_taps(child_pair, hw):
    jm, params, tm = child_pair
    x, t, ctx = _inputs(np.random.RandomState(hw[0]), hw)
    tap = "afterSelfAttn_residual"
    want, want_taps = _jit(jm, tap)(params, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx))
    got, got_taps = tm(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(ctx), tap=tap)
    assert_close(got, want, atol=TOL, rtol=TOL)
    assert len(got_taps) == len(want_taps) == 16
    for g, w in zip(got_taps, want_taps):
        assert_close(g, w, atol=TOL, rtol=TOL)


def test_unet_prefix_split(child_pair):
    jm, params, tm = child_pair
    x, t, ctx = _inputs(np.random.RandomState(1), (4, 4))
    xt, tt, ct = map(torch.from_numpy, (x, t, ctx))
    state = tm(xt, tt, ct, prefix_only=True)
    got, _ = tm(None, tt, ct, prefix_state=state)
    want, _ = _jit(jm, "afterSelfAttn_residual")(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    assert_close(got, want, atol=TOL, rtol=TOL)
    assert_close(got, tm(xt, tt, ct)[0], atol=1e-6)


def test_multi_stream_unet_task_feats(main_pair):
    jm, params, tm = main_pair
    r = np.random.RandomState(2)
    x, t, ctx = _inputs(r, (4, 4))
    feats = [_rand(r, T - 1, B, n, c) for n, c in
             task_feat_shapes(tm.config, 4, 4)]
    main, aux = 2, np.array([0, 1, 3, 4, 5, 6])
    tap = "afterXAttn_main"
    want, want_taps = _jit(jm, tap)(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        task_feats=[jnp.asarray(f) for f in feats], main_idx=jnp.asarray(main),
        aux_idx=jnp.asarray(aux))
    got, got_taps = tm(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
        task_feats=[torch.from_numpy(f) for f in feats],
        main_idx=torch.tensor(main), aux_idx=torch.from_numpy(aux), tap=tap)
    assert_close(got, want, atol=TOL, rtol=TOL)
    for g, w in zip(got_taps, want_taps):
        assert_close(g, w, atol=TOL, rtol=TOL)


def test_multi_stream_unet_shared_kv_streams_folded(main_pair):
    """task_kv_tables + 3 main streams folded into one forward, against the
    JAX tables and one JAX forward per stream."""
    jm, params, tm = main_pair
    r = np.random.RandomState(3)
    x, t, ctx = _inputs(r, (4, 4))
    taps_all = [_rand(r, T, B, n, c) for n, c in
                task_feat_shapes(tm.config, 4, 4)]
    j_tables = jax.jit(functools.partial(j_task_kv_tables, jm.config))(
        params, [jnp.asarray(a) for a in taps_all])
    tables = task_kv_tables(tm, [torch.from_numpy(a) for a in taps_all])
    for (gk, gv), (wk, wv) in zip(tables, j_tables):
        assert_close(gk, wk, atol=TOL, rtol=TOL)
        assert_close(gv, wv, atol=TOL, rtol=TOL)
    mains = [1, 4, 6]
    xs = _rand(r, len(mains), B, 4, 4, 12)
    ctxs = _rand(r, len(mains), B, 3, 32)
    bias = np.where(np.arange(T)[None] == np.array(mains)[:, None], -1e9,
                    0.0).astype(np.float32)
    got, _ = tm(torch.from_numpy(xs.reshape(-1, 4, 4, 12)),
                torch.full((len(mains) * B,), 999),
                torch.from_numpy(ctxs.reshape(-1, 3, 32)), task_kv=tables,
                main_idx=torch.tensor(mains),
                task_key_bias=torch.from_numpy(bias))
    got = got.reshape(len(mains), B, 4, 4, 4)
    for s, main in enumerate(mains):
        want, _ = _jit(jm)(params, jnp.asarray(xs[s]), jnp.asarray(t),
                           jnp.asarray(ctxs[s]), task_kv=j_tables,
                           main_idx=jnp.asarray(main),
                           task_key_bias=jnp.asarray(bias[s]))
        assert_close(got[s], want, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def vae_pair():
    jm = JVAE(j_tiny_vae())
    params = random_params(jm.init, np.zeros((1, 16, 16, 3), np.float32),
                           seed=13)
    return jm, params, load_port(AutoencoderKL(tiny_vae_config()), params)


@pytest.mark.parametrize("hw", [(16, 16), (24, 8)])
def test_vae_encode(vae_pair, hw):
    jm, params, tm = vae_pair
    x = np.random.RandomState(hw[0]).uniform(
        -1, 1, (B, *hw, 3)).astype(np.float32)
    want = _jit(jm, method=JVAE.encode)(params, jnp.asarray(x))
    got = tm.encode(torch.from_numpy(x))
    assert got.shape == want.shape
    assert_close(got, want, atol=TOL, rtol=TOL)


def test_vae_decode(vae_pair):
    jm, params, tm = vae_pair
    z = _rand(np.random.RandomState(5), B, 2, 3, 4)
    want = _jit(jm, method=JVAE.decode)(params, jnp.asarray(z))
    got = tm.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (B, 16, 24, 3)
    assert_close(got, want, atol=TOL, rtol=TOL)
