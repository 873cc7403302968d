"""PyTorch port, the slice as a whole: tiny multi-stream fused all-task
inference (`infer_all_tasks`) against `stablemtl_tpu.pipeline` on the same
weights and inputs, f32 on the CPU, at 1e-4, with the shared UNet prefix on
and off; plus the pipeline's packing helpers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu import TASKS as J_TASKS
from stablemtl_tpu.pipeline import (decode_3ch_to_task as j_decode,
                                    pack_gt_to_3ch as j_pack,
                                    semantic_rgb_to_class as j_semantic)
from stablemtl_tpu.parallel.mesh import host_local_mesh as j_host_local_mesh
from stablemtl_tpu.serving import ServingSession as JServingSession
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.parallel import host_local_mesh
from stablemtl_tpu_torch.pipeline import (decode_3ch_to_task, pack_gt_to_3ch,
                                          semantic_rgb_to_class)
from stablemtl_tpu_torch.serving import ServingSession
from torch_port_helpers import assert_close, tiny_pipelines
from torch_port_helpers import one_torch_thread  # noqa: F401

TOL = 1e-4
T = len(TASKS)
HW = (16, 16)


@pytest.fixture(scope="module")
def pipes():
    """(jax pipeline, port pipeline) on one set of random weights."""
    return tiny_pipelines(HW)


def _images(seed, batch=2):
    r = np.random.RandomState(seed)
    return [r.uniform(-1, 1, (batch, *HW, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def paired_reference(pipes):
    """Paired frames at batch 2 and the JAX pipeline's answer (shared prefix
    at its default; the JAX package's own tests hold it equal to the
    unshared path)."""
    jpipe, _ = pipes
    rgb, nxt = _images(seed=1)
    # parameters as arguments: closed over, XLA folds them into the program
    # as constants (55 s of compile against 36 s)
    params = {"vae": jpipe.vae_params, "unet": jpipe.unet_params,
              "child": jpipe.unet_child_params,
              "text": jpipe.text_embed_table}
    infer = jax.jit(lambda p, x, y: dataclasses.replace(
        jpipe, vae_params=p["vae"], unet_params=p["unet"],
        unet_child_params=p["child"], text_embed_table=p["text"]
    ).infer_all_tasks(x, y))
    want = infer(params, jnp.asarray(rgb), jnp.asarray(nxt))
    return rgb, nxt, np.asarray(want)


@pytest.mark.parametrize("disable_share", ["0", "1"])
def test_infer_all_tasks_matches_jax(monkeypatch, pipes, paired_reference,
                                     disable_share):
    """Both prefix variants, the B-major child fold and the task-major
    stream fold are exercised."""
    monkeypatch.setenv("STABLEMTL_DISABLE_PREFIX_SHARE", disable_share)
    _, tpipe = pipes
    rgb, nxt, want = paired_reference
    got = tpipe.infer_all_tasks(torch.from_numpy(rgb), torch.from_numpy(nxt))
    assert got.shape == (T, 2, *HW, 3)
    unclipped = (np.abs(want) < 0.99).mean()
    assert unclipped > 0.2, unclipped  # the clip must not hide the check
    assert_close(got, want, atol=TOL, rtol=TOL)


def test_single_frame_path_and_prefix_share_agree(monkeypatch, pipes):
    """rgb_next=None encodes once; with the prefix shared or not, the port
    gives the same predictions (no JAX compile needed here)."""
    _, tpipe = pipes
    rgb = torch.from_numpy(_images(seed=5, batch=1)[0])
    monkeypatch.setenv("STABLEMTL_DISABLE_PREFIX_SHARE", "1")
    base = tpipe.infer_all_tasks(rgb, None)
    monkeypatch.setenv("STABLEMTL_DISABLE_PREFIX_SHARE", "0")
    shared = tpipe.infer_all_tasks(rgb, None)
    assert_close(shared, base, atol=1e-5)
    assert_close(tpipe.infer_all_tasks(rgb, rgb.clone()), base, atol=1e-5)


def test_decode_chunk_and_task_subset(pipes):
    _, tpipe = pipes
    rgb = torch.from_numpy(_images(seed=6)[0])
    base = tpipe.infer_all_tasks(rgb, None)
    chunked = dataclasses.replace(tpipe, decode_chunk=7)
    assert_close(chunked.infer_all_tasks(rgb, None), base, atol=1e-5)
    sub = tpipe.infer_tasks(rgb, None, [4, 1])
    assert_close(sub, base[[4, 1]], atol=1e-5)
    with pytest.raises(ValueError, match="built for"):
        tpipe.infer_all_tasks(rgb[:, :8], None)


@pytest.mark.parametrize("mode", ["duplicate", "zero", "avg"])
def test_rgb_latent_for_task_modes(pipes, mode):
    jpipe, tpipe = pipes
    r = np.random.RandomState(7)
    lat, nxt = (r.standard_normal((2, 2, 2, 4)).astype(np.float32)
                for _ in range(2))
    jp = dataclasses.replace(jpipe, encode_rgb_mode=mode)
    tp = dataclasses.replace(tpipe, encode_rgb_mode=mode)
    for idx in (1, 3, list(range(T))):
        want = jp.rgb_latent_for_task(jnp.asarray(lat), jnp.asarray(nxt),
                                      jnp.asarray(idx))
        got = tp.rgb_latent_for_task(torch.from_numpy(lat),
                                     torch.from_numpy(nxt), idx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_task_order_and_packing_helpers():
    assert TASKS == J_TASKS
    r = np.random.RandomState(8)
    for task, c in (("depth", 1), ("shading", 1), ("optical_flow", 2),
                    ("normal", 3), ("scene_flow", 3)):
        gt = r.standard_normal((2, 4, 4, c)).astype(np.float32)
        np.testing.assert_array_equal(
            pack_gt_to_3ch(torch.from_numpy(gt), task).numpy(),
            j_pack(gt, task))
        img = r.standard_normal((2, 4, 4, 3)).astype(np.float32)
        np.testing.assert_allclose(
            decode_3ch_to_task(torch.from_numpy(img), task).numpy(),
            j_decode(img, task), rtol=1e-6)
    with pytest.raises(ValueError):
        pack_gt_to_3ch(torch.zeros(1, 2, 2, 3), "depth")
    colors = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.float32)
    img = r.uniform(-1, 1, (1, 5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        semantic_rgb_to_class(torch.from_numpy(img), colors).numpy(),
        np.asarray(j_semantic(jnp.asarray(img), colors)))


def test_flash_path_not_taken_on_cpu(pipes):
    """The CPU run never reaches a kernel wrapper's launch."""
    from stablemtl_tpu_torch.ops.flash_attention import (flash_fwd_resident,
                                                         flash_fwd_stream)

    _, tpipe = pipes
    before = (flash_fwd_resident.launches, flash_fwd_stream.launches)
    tpipe.infer_all_tasks(torch.from_numpy(_images(seed=9)[0]), None)
    assert (flash_fwd_resident.launches, flash_fwd_stream.launches) == before
    assert jax.default_backend() == "cpu"


def test_session_on_two_replicas_matches_jax_mesh_session(pipes):
    """The port's ServingSession over 2 replicas (1 row each) against the
    JAX package's ServingSession over a 2-device mesh (the batch sharded
    over its data axis), same weights and requests, at the composed
    pipeline's bar. JAX's 2-device result is within 6.9e-6 of its
    unsharded step here (ROADMAP §C), so the bar holds the port to JAX's
    mesh form itself."""
    jpipe, tpipe = pipes
    imgs = list(_images(seed=5)[0])

    def serve(session):
        with session as sess:
            futs = [sess.submit(im) for im in imgs]
            return np.stack([f.result(timeout=600) for f in futs], 1)

    want = serve(JServingSession(jpipe, batch=2, max_delay_s=1.0,
                                 mesh=j_host_local_mesh(2)))
    got = serve(ServingSession(tpipe, batch=2, max_delay_s=1.0,
                               mesh=host_local_mesh(devices=["cpu", "cpu"])))
    assert got.shape == (T, 2, *HW, 3)
    assert (np.abs(want) < 0.99).mean() > 0.2  # the clip hides little
    assert_close(got, want, atol=TOL, rtol=TOL)
