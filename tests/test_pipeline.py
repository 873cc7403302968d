"""Pipeline-layer tests: packing rules, task conditioning, end-to-end infer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stablemtl_tpu import TASKS
from stablemtl_tpu.models import AutoencoderKL, UNet2DConditionModel
from stablemtl_tpu.models.unet import tiny_unet_config
from stablemtl_tpu.models.vae import tiny_vae_config
from stablemtl_tpu.pipeline import (
    N_TASKS,
    StableMTLPipeline,
    decode_3ch_to_task,
    pack_gt_to_3ch,
    semantic_rgb_to_class,
    task_index,
)


def test_pack_gt_rules():
    depth = np.random.rand(2, 8, 8, 1).astype(np.float32)
    out = pack_gt_to_3ch(depth, "depth")
    assert out.shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(out[..., 0], out[..., 2])

    flow = np.random.rand(2, 8, 8, 2).astype(np.float32)
    out = pack_gt_to_3ch(flow, "optical_flow")
    # [u, v, u] (stablemtl_trainer.py:452-454)
    np.testing.assert_array_equal(out[..., 2], flow[..., 0])
    np.testing.assert_array_equal(out[..., :2], flow)

    nrm = np.random.rand(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(pack_gt_to_3ch(nrm, "normal"), nrm)

    with pytest.raises(ValueError):
        pack_gt_to_3ch(nrm, "depth")


def test_decode_rules():
    img = np.random.rand(2, 8, 8, 3).astype(np.float32)
    d = decode_3ch_to_task(img, "depth")
    assert d.shape == (2, 8, 8, 1)
    np.testing.assert_allclose(d[..., 0], img.mean(-1), rtol=1e-6)
    f = decode_3ch_to_task(img, "optical_flow")
    np.testing.assert_array_equal(f, img[..., :2])
    np.testing.assert_array_equal(decode_3ch_to_task(img, "albedo"), img)


def test_semantic_rgb_to_class_roundtrip():
    colors = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]],
                      np.float32)
    # build an image of exact class colors (in [-1,1]) plus small noise
    ids = np.random.randint(0, 4, size=(1, 6, 6))
    img = colors[ids] / 255.0 * 2 - 1 + np.random.uniform(-0.05, 0.05,
                                                          (1, 6, 6, 3))
    got = semantic_rgb_to_class(jnp.asarray(img, jnp.float32), colors)
    np.testing.assert_array_equal(np.asarray(got), ids)


# One build per argument tuple: Flax's init runs eagerly, and no test
# writes to a pipeline.
@functools.cache
def _tiny_pipeline(multi_stream=False, key=0):
    rng = jax.random.PRNGKey(key)
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    vae = AutoencoderKL(tiny_vae_config())
    B, H, W = 1, 16, 16
    vae_params = vae.init(k1, jnp.zeros((1, H, W, 3)))

    ucfg = tiny_unet_config(use_task_attention=multi_stream)
    unet = UNet2DConditionModel(ucfg)
    lat_hw = H // 8
    text = jnp.zeros((1, 4, ucfg.cross_attention_dim))
    unet_params = unet.init(k2, jnp.zeros((1, lat_hw, lat_hw, 12)),
                            jnp.zeros((1,), jnp.int32), text)
    child = child_params = None
    if multi_stream:
        ccfg = tiny_unet_config()
        child = UNet2DConditionModel(ccfg)
        child_params = child.init(
            k3, jnp.zeros((1, lat_hw, lat_hw, 12)),
            jnp.zeros((1,), jnp.int32), text, tap="afterSelfAttn_residual")
        # re-init main unet with task feats so task-attn params exist
        aux_idx = jnp.arange(1, N_TASKS)
        _, taps = child.apply(child_params, jnp.zeros((1, lat_hw, lat_hw, 12)),
                              jnp.zeros((1,), jnp.int32), text,
                              tap="afterSelfAttn_residual")
        feats = [jnp.broadcast_to(t[None], (N_TASKS - 1,) + t.shape)
                 for t in taps]
        unet_params = unet.init(
            k2, jnp.zeros((1, lat_hw, lat_hw, 12)), jnp.zeros((1,), jnp.int32),
            text, task_feats=feats, main_idx=jnp.asarray(0), aux_idx=aux_idx)

    table = jax.random.normal(k4, (N_TASKS, 4, ucfg.cross_attention_dim)) * 0.02
    return StableMTLPipeline(
        vae=vae, unet=unet, vae_params=vae_params, unet_params=unet_params,
        text_embed_table=table, unet_child=child,
        unet_child_params=child_params)


def test_aux_task_indices():
    pipe = _tiny_pipeline()
    for main in range(N_TASKS):
        aux = np.asarray(pipe.aux_task_indices(jnp.asarray(main)))
        expected = [i for i in range(N_TASKS) if i != main]
        np.testing.assert_array_equal(aux, expected)


def test_rgb_latent_for_task_two_frame_rule():
    pipe = _tiny_pipeline()
    lat = jnp.ones((1, 2, 2, 4))
    lat_next = jnp.full((1, 2, 2, 4), 2.0)
    # single-frame task (depth): duplicate -> second half equals lat
    out = pipe.rgb_latent_for_task(lat, lat_next, jnp.asarray(task_index("depth")))
    np.testing.assert_array_equal(np.asarray(out[..., 4:]), np.asarray(lat))
    # two-frame task: second half equals lat_next
    out = pipe.rgb_latent_for_task(
        lat, lat_next, jnp.asarray(task_index("optical_flow")))
    np.testing.assert_array_equal(np.asarray(out[..., 4:]), np.asarray(lat_next))
    # vector form
    out = pipe.rgb_latent_for_task(lat, lat_next, jnp.arange(N_TASKS))
    assert out.shape == (N_TASKS, 1, 2, 2, 8)


def test_single_stream_infer_shapes():
    pipe = _tiny_pipeline()
    rgb = jnp.zeros((1, 16, 16, 3))
    img = pipe.infer(rgb, rgb, jnp.asarray(task_index("depth")))
    assert img.shape == (1, 16, 16, 3)
    assert bool(jnp.all(jnp.isfinite(img)))


def test_multi_stream_infer_and_taskfeats():
    pipe = _tiny_pipeline(multi_stream=True)
    rgb = jnp.zeros((1, 16, 16, 3))
    lat, lat_next = pipe.encode_rgb_pair(rgb, rgb)
    aux_idx, feats = pipe.create_task_feats(lat, lat_next, jnp.asarray(1))
    assert aux_idx.shape == (N_TASKS - 1,)
    assert len(feats) == 16
    assert feats[0].shape[0] == N_TASKS - 1 and feats[0].shape[1] == 1

    pred = pipe.unet_forward(lat, lat_next, jnp.asarray(1))
    assert pred.shape == lat.shape

    # jit with task as data: two different tasks, one compile
    fn = jax.jit(lambda t: pipe.unet_forward(lat, lat_next, t))
    p0 = fn(jnp.asarray(0))
    p1 = fn(jnp.asarray(2))
    assert p0.shape == p1.shape == lat.shape


def test_avg_encode_mode():
    import dataclasses

    pipe = dataclasses.replace(_tiny_pipeline(), encode_rgb_mode="avg")
    lat = jnp.ones((1, 2, 2, 4))
    lat_next = jnp.full((1, 2, 2, 4), 3.0)
    # single-frame task: just lat (4ch)
    out = pipe.rgb_latent_for_task(lat, lat_next,
                                   jnp.asarray(task_index("depth")))
    assert out.shape == (1, 2, 2, 4)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(lat))
    # two-frame: mean of the two latents
    out = pipe.rgb_latent_for_task(
        lat, lat_next, jnp.asarray(task_index("optical_flow")))
    np.testing.assert_allclose(np.asarray(out), 2.0)
    assert pipe.rgb_latent_channels == 4


def test_decode_chunk_equivalent():
    """Chunked VAE decode (pipeline.decode_chunk) is numerically identical
    to the single batched decode — only the HBM working set changes."""
    import dataclasses

    pipe = _tiny_pipeline(multi_stream=True)
    rgb = jnp.asarray(np.random.RandomState(0)
                      .uniform(-1, 1, (2, 16, 16, 3)), jnp.float32)
    base = pipe.infer_all_tasks(rgb, rgb)          # one decode of 14
    chunked = dataclasses.replace(pipe, decode_chunk=7)
    got = chunked.infer_all_tasks(rgb, rgb)        # 2 chunks of 7
    assert base.shape == got.shape == (N_TASKS, 2, 16, 16, 3)
    # batch-7 vs batch-14 decoder convs reduce in a different order;
    # measured max diff ~4e-6 f32
    np.testing.assert_allclose(np.asarray(got), np.asarray(base),
                               atol=1e-5)
    # non-divisible chunk falls back to the batched decode
    odd = dataclasses.replace(pipe, decode_chunk=5)
    np.testing.assert_allclose(np.asarray(odd.infer_all_tasks(rgb, rgb)),
                               np.asarray(base), atol=0)


def test_single_frame_encode_path_equivalent():
    """rgb_next=None (or the identical array object) encodes once and
    must give bit-identical predictions to the duplicated-frame path."""
    pipe = _tiny_pipeline(multi_stream=True)
    rgb = jnp.asarray(np.random.RandomState(1)
                      .uniform(-1, 1, (1, 16, 16, 3)), jnp.float32)
    dup = pipe.infer_all_tasks(rgb, jnp.array(rgb))   # distinct array
    one = pipe.infer_all_tasks(rgb, None)
    # batch-2 vs batch-1 VAE encode may reduce in a different order
    np.testing.assert_allclose(np.asarray(one), np.asarray(dup),
                               atol=1e-5)
    # jitted wrapper boundary: None is a static (pytree) argument. Compare
    # jit-vs-jit (bit-equal measured); jit-vs-eager legitimately differs
    # by fusion order, amplified by the random-init model.
    from stablemtl_tpu.pipeline import jit_infer_all_tasks
    fn = jit_infer_all_tasks(pipe)
    np.testing.assert_allclose(
        np.asarray(fn(rgb, None)),
        np.asarray(fn(rgb, jnp.array(rgb))), atol=1e-5)


def test_factory_plumbs_decode_chunk():
    from stablemtl_tpu.config import Config
    from stablemtl_tpu.factory import build_pipeline

    cfg = Config({"model": {"size_preset": "tiny",
                            "pretrained_path": "scratch"},
                  "pipeline": {"decode_chunk": 3}})
    assert build_pipeline(cfg).decode_chunk == 3


def test_shared_prefix_path_equivalent(monkeypatch):
    """The shared conv_in->first-self-attn prefix (computed once per
    distinct input and tiled across task streams) must be bit-equal to
    the plain per-stream forward — paired and single-frame inputs, fused
    inference AND the traced-aux child path (create_task_feats)."""
    pipe = _tiny_pipeline(multi_stream=True)
    key = jax.random.PRNGKey(3)
    rgb = jax.random.uniform(key, (1, 16, 16, 3), jnp.float32, -1, 1)
    rgb_next = jax.random.uniform(jax.random.fold_in(key, 1),
                                  (1, 16, 16, 3), jnp.float32, -1, 1)

    for nxt in (rgb_next, None):
        monkeypatch.setenv("STABLEMTL_DISABLE_PREFIX_SHARE", "1")
        base = np.asarray(pipe.infer_all_tasks(rgb, nxt))
        lat, lat_next = pipe.encode_rgb_pair(rgb, nxt)
        _, feats_base = pipe.create_task_feats(lat, lat_next, jnp.asarray(2))
        monkeypatch.setenv("STABLEMTL_DISABLE_PREFIX_SHARE", "0")
        shared = np.asarray(pipe.infer_all_tasks(rgb, nxt))
        _, feats_shared = pipe.create_task_feats(lat, lat_next,
                                                 jnp.asarray(2))
        np.testing.assert_allclose(shared, base, atol=1e-6)
        for a, b in zip(feats_shared, feats_base):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-6)


def test_shared_prefix_disabled_for_random_noise():
    """input_noise='random' draws per-stream noise, so the prefix is NOT
    task-independent; sharing must switch itself off."""
    import dataclasses
    pipe = dataclasses.replace(_tiny_pipeline(multi_stream=True),
                               input_noise="random")
    assert not pipe._prefix_share_ok()


def test_shared_prefix_disabled_for_thin_topology():
    """A UNet without an attention layer in down block 0 can't split at
    the first self-attn; sharing must fall back, not crash."""
    import dataclasses as _dc
    pipe = _tiny_pipeline(multi_stream=True)
    thin_cfg = _dc.replace(pipe.unet.config, block_out_channels=(32,),
                           attention_heads=(2,))
    thin = UNet2DConditionModel(thin_cfg)
    assert not _dc.replace(pipe, unet=thin)._prefix_share_ok()
    assert pipe._prefix_share_ok()  # the real topology still shares
