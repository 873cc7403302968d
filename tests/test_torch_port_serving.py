"""PyTorch port, the serving path: configs, the converted-weight loader,
postprocessing and visualizers, the PNG codec, ServingSession and the serve
CLI, against the JAX package (or OpenCV and PIL for the codec) at tiny
sizes in f32 on the CPU. No JAX pipeline is built and nothing is jitted."""

import dataclasses
import glob
import io
import json
import logging
import os
import struct
import threading
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from stablemtl_tpu.config import recursive_load_config as jax_load_config
from stablemtl_tpu.evaluation import \
    postprocess_prediction as jax_postprocess
from stablemtl_tpu.factory import class_colors as jax_class_colors
from stablemtl_tpu.factory import model_configs as jax_model_configs
from stablemtl_tpu.models.unet import inflate_conv_in as jax_inflate
from stablemtl_tpu.models.vae import AutoencoderKL as JaxVAE
from stablemtl_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablemtl_tpu.predict import _visualize as jax_visualize
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.cli import serve
from stablemtl_tpu_torch.config import (recursive_load_config,
                                        resolve_config_arg)
from stablemtl_tpu_torch.evaluation import postprocess_prediction
from stablemtl_tpu_torch.factory import (build_pipeline, class_colors,
                                         load_pretrained, model_configs_from)
from stablemtl_tpu_torch.models.convert import (flax_leaf_to_port,
                                                state_dict_from_flax)
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             tiny_unet_config)
from stablemtl_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config
from stablemtl_tpu_torch.parallel import host_local_mesh
from stablemtl_tpu_torch.predict import Predictor, _to_norm, _visualize
from stablemtl_tpu_torch.serving import (ServingSession,
                                         cast_params_for_inference,
                                         export_pipeline, load_exported,
                                         params_bundle, pipeline_on,
                                         replicated_bundles)
from stablemtl_tpu_torch.utils import png
from torch_port_helpers import random_params
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# two serving replicas sharing the CPU
MESH2 = host_local_mesh(devices=["cpu", "cpu"])
HW = (16, 16)
TINY = {"model": {"size_preset": "tiny", "pretrained_path": "scratch"},
        "trainer": {"multi_stream": True}}


@pytest.fixture(scope="module")
def pipe():
    return build_pipeline(TINY, seed=0, device="cpu", image_hw=HW)


def _images(n, seed):
    r = np.random.RandomState(seed)
    return [r.uniform(-1, 1, HW + (3,)).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "config", "*.yaml"))), ids=os.path.basename)
def test_configs_and_model_configs_match_jax(path):
    cfg = recursive_load_config(path)
    want = jax_load_config(path)
    assert cfg.to_dict() == want.to_dict()
    trainer, model = want.get("trainer", {}), want.get("model", {})
    jax_cfgs = jax_model_configs(
        model.get("size_preset", "full"),
        bool(trainer.get("multi_stream", False)), trainer,
        dtype=model.get("compute_dtype", "float32"),
        remat=bool(model.get("remat", False)),
        fast_math=bool(model.get("fast_math", False)),
        remat_transformer=str(model.get("remat_transformer", "none")))
    got = model_configs_from(cfg)
    for ours, theirs in zip(got[:3], jax_cfgs[:3]):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert got[3] == jax_cfgs[3]


def test_flagship_literal_and_run_dir(tmp_path):
    """chip_smoke's serving config is the flagship YAML as merged, and its
    run directory resolves through config_resolved.json alone."""
    want = recursive_load_config(os.path.join(
        REPO, "config", "train_stablemtl.yaml")).to_dict()
    assert chip_smoke.FLAGSHIP_CONFIG == want
    chip_smoke.write_run_dir(str(tmp_path / "run"))
    cfg, ckpt = resolve_config_arg(str(tmp_path / "run"))
    assert cfg.to_dict() == want and ckpt is None
    ucfg, ccfg, _, _ = model_configs_from(cfg)
    assert ucfg.use_task_attention and ucfg.dtype == "bfloat16"
    assert not ucfg.fast_math and ccfg.block_out_channels[0] == 320


# ---------------------------------------------------------------------------
# Converted weights
# ---------------------------------------------------------------------------

def _flax_tree_of(module, seed):
    """A random Flax-layout tree ('/'-joined paths -> arrays) of a port
    module: the inverse of state_dict_from_flax's naming rules."""
    r = np.random.RandomState(seed)
    norms = {n for n, m in module.named_modules()
             if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
    flat = {}
    for name, p in module.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        shape = tuple(p.shape)
        if leaf == "weight" and path in norms:
            key = f"{path}/scale"
        elif leaf == "weight" and len(shape) in (2, 4):
            key = f"{path}/kernel"
            shape = shape[::-1] if len(shape) == 2 else \
                (shape[2], shape[3], shape[1], shape[0])
        else:
            key = f"{path}/{leaf}"
        flat[key.replace(".", "/")] = r.standard_normal(shape).astype(
            np.float32)
    return flat


def _nest(flat):
    tree = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def test_load_pretrained_matches_state_dict_from_flax(tmp_path, caplog):
    """vae.npz from a JAX-initialized tree, unet.npz with SD2's 4-channel
    conv_in (inflated x3, against JAX's inflate_conv_in), the child falling
    back to unet.npz, and text_table.npy: every leaf equals
    state_dict_from_flax of the stored tree."""
    vcfg, ucfg = tiny_vae_config(), tiny_unet_config()
    vae_tree = jax.tree_util.tree_map(
        np.asarray, random_params(JaxVAE(jax_tiny_vae()).init,
                                  np.zeros((1, 16, 16, 3), np.float32),
                                  seed=5))
    vae_flat = {"/".join(str(k.key) for k in path): leaf
                for path, leaf in jax.tree_util.tree_leaves_with_path(
                    vae_tree["params"])}
    np.savez(tmp_path / "vae.npz", **vae_flat)
    unet_flat = _flax_tree_of(UNet2DConditionModel(ucfg), seed=6)
    k12 = unet_flat["conv_in/kernel"]
    k4 = np.ascontiguousarray(k12[:, :, :4])
    np.savez(tmp_path / "unet.npz", **dict(unet_flat, **{"conv_in/kernel":
                                                         k4}))
    table = np.random.RandomState(7).standard_normal((7, 4, 32)).astype(
        np.float32)
    np.save(tmp_path / "text_table.npy", table)

    vae, unet, child = (AutoencoderKL(vcfg), UNet2DConditionModel(ucfg),
                        UNet2DConditionModel(ucfg))
    got_table = load_pretrained(str(tmp_path), vae, unet, child, 32,
                                strict=True)
    assert np.array_equal(got_table, table)
    want_vae = state_dict_from_flax(vae_tree)
    inflated = jax_inflate({"kernel": jnp.asarray(k4), "bias": None},
                           repeat=3)["kernel"]
    want_unet = state_dict_from_flax(_nest(dict(unet_flat, **{
        "conv_in/kernel": np.asarray(inflated)})))
    for module, want in ((vae, want_vae), (unet, want_unet),
                         (child, want_unet)):
        state = module.state_dict()
        assert set(state) == set(want)
        for name, t in want.items():
            assert torch.equal(state[name], t), name

    # a missing and a mismatched leaf: raised with strict, else reported
    # loudly and left at init
    del unet_flat["mid_block_resnets_0/conv1/bias"]
    unet_flat["conv_out/kernel"] = unet_flat["conv_out/kernel"][..., :2]
    np.savez(tmp_path / "unet.npz", **unet_flat)
    with pytest.raises(ValueError, match="2 parameter") as e:
        load_pretrained(str(tmp_path), vae, UNet2DConditionModel(ucfg),
                        None, 32, strict=True)
    assert "mid_block_resnets_0.conv1.bias: missing" in str(e.value)
    assert "conv_out.weight: shape" in str(e.value)
    os.remove(tmp_path / "text_table.npy")
    fresh = UNet2DConditionModel(ucfg)
    before = fresh.conv_out.weight.clone()
    with caplog.at_level(logging.WARNING):
        zeros = load_pretrained(str(tmp_path), vae, fresh, None, 32)
    assert torch.equal(fresh.conv_out.weight, before)
    assert "NOT loaded" in caplog.text and "ALL-ZERO" in caplog.text
    assert zeros.shape == (7, 5, 32) and not zeros.any()


def test_flax_leaf_rules():
    k = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    name, t = flax_leaf_to_port(("a", "conv", "kernel"), k)
    assert name == "a.conv.weight" and t.shape == (2, 2, 2, 3)
    name, t = flax_leaf_to_port(("n", "scale"), k[0, 0, 0])
    assert name == "n.weight"


# ---------------------------------------------------------------------------
# Postprocessing, visualizers, PNG
# ---------------------------------------------------------------------------

def test_postprocess_and_visualize_match_jax():
    colors = class_colors()
    assert np.array_equal(colors, jax_class_colors())
    pred3 = np.random.RandomState(8).uniform(-1, 1, (12, 10, 3)).astype(
        np.float32)
    pred3[0, 0] = 0.0  # a zero normal
    for task in TASKS:
        got = postprocess_prediction(task, pred3, colors)
        want = jax_postprocess(task, pred3, colors)
        assert got.dtype == want.dtype and np.array_equal(got, want), task
        vis = _visualize(task, got, colors)
        assert vis.dtype == np.uint8
        assert np.array_equal(vis, jax_visualize(task, want, colors)), task


def _filtered_png(img, kinds):
    """An 8-bit RGB PNG whose row y uses filter kinds[y % len(kinds)]."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = (np.abs(p - v) for v in (left, up, up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


def test_png_codec_against_cv2_and_pil(tmp_path):
    r = np.random.RandomState(9)
    img = (r.rand(13, 11, 3) * 60 + np.arange(11)[None, :, None] * 15)
    img = img.astype(np.uint8)
    for arr in (img, img[..., 0], np.concatenate([img, img[..., :1]], -1)):
        data = png.encode_png(arr)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)
        decoded = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_UNCHANGED)
        if arr.ndim == 3:
            decoded = decoded[..., [2, 1, 0, 3][:arr.shape[-1]]]
        assert np.array_equal(decoded, arr)
    assert np.array_equal(png.decode_png(_filtered_png(img, [0, 1, 2, 3, 4])),
                          img)
    ok, enc = cv2.imencode(".png", img[..., ::-1])
    assert ok and np.array_equal(png.decode_png(enc.tobytes()), img)
    for mode, arr in (("RGB", img), ("RGBA", np.concatenate(
            [img, img[..., :1]], -1))):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG", optimize=True)
        assert np.array_equal(png.decode_png(buf.getvalue()), img)
    # a palette PNG is another variant: not read here, OpenCV reads it
    path = str(tmp_path / "palette.png")
    Image.fromarray(img).convert("P").save(path)
    with pytest.raises(png.UnsupportedPNG):
        png.read_png(path)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    assert np.array_equal(serve.read_image(path), want)


# ---------------------------------------------------------------------------
# ServingSession
# ---------------------------------------------------------------------------

def test_session_batches_and_unpads(pipe):
    """3 requests at batch 2 (one full group and one padded): each result is
    bit-equal to infer_all_tasks of its own image on a batch of copies
    (outputs do not depend on batch mates)."""
    imgs = _images(3, seed=10)
    with torch.inference_mode():
        want = [pipe.infer_all_tasks(torch.from_numpy(np.stack([im] * 2)),
                                     None)[:, 0].numpy() for im in imgs]
    with ServingSession(pipe, batch=2, max_delay_s=0.05) as sess:
        futs = [sess.submit(im) for im in imgs]
        got = [f.result(timeout=300) for f in futs]
    for g, w in zip(got, want):
        assert g.shape == (7,) + HW + (3,) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_session_rejects_bad_requests(pipe):
    with ServingSession(pipe, batch=2, max_delay_s=0.0) as sess:
        sess.warmup(HW)
        with pytest.raises(ValueError, match="geometry"):
            sess.submit(np.zeros((8, 8, 3), np.float32))
        with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
            sess.submit(np.zeros(HW, np.float32))
        with pytest.raises(ValueError, match="rgb_next"):
            sess.submit(np.zeros(HW + (3,), np.float32),
                        np.zeros(HW + (3,), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit(np.zeros(HW + (3,), np.float32))
    # a batch that does not divide over the replicas, in the session and
    # the artifact; and a program traced on the CPU serves no other device
    with pytest.raises(ValueError, match="divisible"):
        ServingSession(pipe, batch=3, mesh=MESH2)
    with pytest.raises(ValueError, match="divisible"):
        export_pipeline(pipe, batch=3, res_hw=HW, mesh=MESH2)
    with pytest.raises(ValueError, match="cuda"):
        export_pipeline(pipe, batch=2, res_hw=HW, platforms=["cuda"])


def test_session_on_mesh(pipe):
    """Counterpart of tests/test_serving.py::test_session_on_mesh: two
    replicas, each running one row of a batch-2 step, give every result
    bit-equal to the one-device step at the replica's batch (1 row), in
    both frame modes (pair splits both frames alike); a padded group's
    padding row runs too. A batch that does not divide raises."""
    imgs = _images(3, seed=15)
    with pytest.raises(ValueError, match="divisible"):
        ServingSession(pipe, batch=3, mesh=MESH2)
    for pair in (False, True):
        nxt = (lambda i: imgs[(i + 1) % 3]) if pair else (lambda i: None)
        # one-row batches stacked, as the replicas slice them: `im[None]`
        # has a batch axis of stride 0, which takes other CPU kernels
        def row(x):
            return None if x is None else torch.from_numpy(np.stack([x]))

        with torch.inference_mode():
            want = [pipe.infer_all_tasks(row(im), row(nxt(i)))[:, 0].numpy()
                    for i, im in enumerate(imgs)]
        with ServingSession(pipe, batch=2, max_delay_s=0.05, pair=pair,
                            mesh=MESH2) as sess:
            got = [f.result(timeout=300) for f in
                   [sess.submit(im, nxt(i)) for i, im in enumerate(imgs)]]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_infer_all_tasks_on_replicas_is_deterministic_and_equivariant(pipe):
    """Counterpart of tests/test_sharded_train.py::
    test_infer_all_tasks_data_parallel: batch 4 over 2 replicas (2 rows
    each), both frames the same images; run twice it is bit-equal, and the
    batch reversed gives the outputs reversed, exactly (no replica or row
    leaks into another)."""
    imgs = _images(4, seed=16)

    def run(images):
        with ServingSession(pipe, batch=4, max_delay_s=5.0, pair=True,
                            mesh=MESH2) as sess:
            futs = [sess.submit(im, im) for im in images]
            return np.stack([f.result(timeout=300) for f in futs], 1)

    out = run(imgs)
    assert out.shape == (7, 4) + HW + (3,) and np.isfinite(out).all()
    np.testing.assert_array_equal(run(imgs), out)
    np.testing.assert_array_equal(run(imgs[::-1]), out[:, ::-1])


class _FlakyPipeline:
    """Fails its first step, then returns each image's mean as all outputs;
    records the batches it was given."""
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def infer_all_tasks(self, rgb, rgb_next):
        self.calls.append((rgb.clone(), rgb_next))
        if len(self.calls) == 1:
            raise RuntimeError("device fault")
        return rgb.mean(dim=(1, 2, 3))[None, :, None, None, None].expand(
            7, rgb.shape[0], *rgb.shape[1:3], 3)


def test_session_failures_reach_futures_and_thread_serves_on():
    fake = _FlakyPipeline()
    a, b, c = _images(3, seed=11)
    with ServingSession(fake, batch=2, max_delay_s=0.0, pair=True) as sess:
        with pytest.raises(RuntimeError, match="device fault"):
            sess.infer(a, b)
        out = sess.infer(c, a)  # padded: the batch repeats c
        with pytest.raises(ValueError, match="needs rgb_next"):
            sess.submit(a)
        barrier = threading.Barrier(2)
        results = []

        def client(img):
            barrier.wait()
            results.append(sess.infer(img, img))
        threads = [threading.Thread(target=client, args=(im,))
                   for im in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert out.shape == (7,) + HW + (3,)
    np.testing.assert_allclose(out, c.mean(), rtol=1e-6)
    rgb, nxt = fake.calls[1]
    assert torch.equal(rgb[0], rgb[1]) and torch.equal(nxt[1],
                                                      torch.from_numpy(a))
    assert len(results) == 2 and not sess._thread.is_alive()


def test_replica_on_another_device_holds_its_own_copy(pipe):
    """A replica on another device than the pipeline's ("meta" here) gets
    one copy of every parameter, buffer and tensor attribute of the
    modules and the task table there, in their dtypes; the pipeline is
    untouched, and a replica on its own device shares it. The bundles of
    a mesh: the pipeline's own on its device, a copy on another."""
    moved = pipeline_on(pipe, "meta")
    assert pipeline_on(pipe, "cpu") is pipe
    for attr in ("vae", "unet", "unet_child"):
        src, dst = getattr(pipe, attr), getattr(moved, attr)
        want = src.state_dict(keep_vars=True)
        got = dst.state_dict(keep_vars=True)
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert t.device.type == "meta" and t.dtype == want[name].dtype
            assert t.requires_grad == want[name].requires_grad
            assert want[name].device.type == "cpu"
        for sub in dst.modules():
            assert all(v.device.type == "meta" for v in vars(sub).values()
                       if isinstance(v, torch.Tensor))
    assert moved.text_embed_table.device.type == "meta"
    home, other = replicated_bundles(
        pipe, host_local_mesh(devices=["cpu", "meta"]))
    assert home["text"] is pipe.text_embed_table
    assert other["unet"].keys() == home["unet"].keys()
    assert all(t.device.type == "meta" for t in other["unet"].values())


class _FailsOnImage:
    """Fails a step whose first row is `bad`, else returns each image's
    mean as all outputs; records the row counts it was given."""
    device = torch.device("cpu")

    def __init__(self, bad):
        self.bad = torch.from_numpy(bad)
        self.rows = []

    def infer_all_tasks(self, rgb, rgb_next):
        self.rows.append(rgb.shape[0])
        if torch.equal(rgb[0], self.bad):
            raise RuntimeError("device fault")
        return rgb.mean(dim=(1, 2, 3))[None, :, None, None, None].expand(
            7, rgb.shape[0], *rgb.shape[1:3], 3)


def test_replica_failure_fails_the_group_and_session_serves_on():
    """A failure on one replica fails every future of its group, the other
    replica's row too; the collector serves the next group on both."""
    a, b, c = _images(3, seed=17)
    fake = _FailsOnImage(a)
    with ServingSession(fake, batch=2, max_delay_s=0.5, mesh=MESH2) as sess:
        for f in [sess.submit(a), sess.submit(b)]:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=60)
        out = sess.infer(c)
    np.testing.assert_allclose(out, c.mean(), atol=1e-6)
    assert fake.rows == [1, 1, 1, 1]


def test_cast_params_for_inference_and_predictor(pipe):
    """The ndim >= 2 cast rule, and Predictor.all_tasks against the
    pipeline's own output."""
    p2 = build_pipeline(TINY, seed=1, device="cpu", image_hw=HW)
    cast_params_for_inference(p2)
    for m in (p2.vae, p2.unet, p2.unet_child):
        for name, t in m.named_parameters():
            assert t.dtype == (torch.bfloat16 if t.dim() >= 2
                               else torch.float32), name
    img = np.random.RandomState(12).randint(0, 256, HW + (3,), np.uint8)
    preds = Predictor(pipe, class_colors=class_colors()).all_tasks(img)
    # the batch axis added in numpy, as Predictor adds it: a size-1 axis of
    # stride 0 takes other CPU kernels than one of stride H*W*3
    x = torch.from_numpy((img.astype(np.float32) / 255.0 * 2.0 - 1.0)[None])
    want = pipe.infer_all_tasks(x, None)[:, 0].numpy()
    for ti, task in enumerate(TASKS):
        np.testing.assert_array_equal(
            preds[task].output,
            postprocess_prediction(task, want[ti], class_colors()))
        assert preds[task].visualization.dtype == np.uint8


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_on_cpu(tmp_path, capsys):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / "config_resolved.json").write_text(json.dumps(TINY))
    imgs = []
    r = np.random.RandomState(13)
    for i in range(3):
        imgs.append(str(tmp_path / f"img{i}.png"))
        cv2.imwrite(imgs[-1], r.randint(0, 255, HW + (3,), np.uint8))
    out = tmp_path / "served"
    serve.main(["--config", str(run_dir), "--images", *imgs, "--output_dir",
                str(out), "--res", "16", "--batch", "2", "--max_delay_ms",
                "50", "--save_npz", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"served": 3, "tasks": 7, "output_dir": str(out)}
    for i in range(3):
        for task in TASKS:
            vis = png.read_png(str(out / f"img{i}_{task}.png"))
            assert vis.shape == HW + (3,), (i, task)
        raw = np.load(out / f"img{i}.npz")
        assert set(raw.files) == set(TASKS)
        assert raw["depth"].shape == HW + (1,)
    # --export: the artifact of the nano preset's step (a smaller graph to
    # trace than the tiny preset's), its JSON line, and the file called on
    # the bundle of the same seeded pipeline against its eager step;
    # --pair alone serves nothing, as in the JAX package's CLI
    nano = {"model": {"size_preset": "nano", "pretrained_path": "scratch"},
            "trainer": {"multi_stream": True}}
    (run_dir / "config_resolved.json").write_text(json.dumps(nano))
    art = tmp_path / "a.pt2"
    serve.main(["--config", str(run_dir), "--device", "cpu", "--export",
                str(art), "--res", "16", "--batch", "2", "--seed", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"artifact": str(art), "bytes": art.stat().st_size,
                    "batch": 2, "res": 16, "pair": False}
    nano_pipe = build_pipeline(nano, seed=3, device="cpu", image_hw=HW)
    x = torch.from_numpy(np.stack(_images(2, seed=14)))
    got = load_exported(str(art)).call(params_bundle(nano_pipe), x)
    want = nano_pipe.infer_all_tasks(x, None)
    assert got.shape == (7, 2) + HW + (3,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    with pytest.raises(SystemExit, match="no --images"):
        serve.main(["--config", str(run_dir), "--device", "cpu", "--pair"])

    # --checkpoint: a training run of the nano preset (one effective
    # iteration at a constant lr, so the weights moved) served from its run
    # directory, which implies its checkpoint
    from stablemtl_tpu_torch.checkpoint import restore_params
    from stablemtl_tpu_torch.cli import train
    from torch_port_helpers import write_vkitti_tree

    write_vkitti_tree(str(tmp_path / "vkitti"))
    cfg = tmp_path / "nano.yaml"
    cfg.write_text(json.dumps({
        "base_config": [f"{REPO}/config/train_debug_tiny.yaml"],
        "model": {"size_preset": "nano"}, "max_iter": 1,
        "dataset": {"train": {"name": "mixed", "dataset_list": [{
            "name": "vkitti_depth", "dir": "vkitti",
            "filenames": str(tmp_path / "vkitti/depth.txt"),
            "resize_to_hw": list(HW)}]}, "val": [], "vis": []}}))
    trained = train.main(["--config", str(cfg), "--base_data_dir",
                          str(tmp_path), "--output_dir", str(tmp_path / "t"),
                          "--no_lr_scheduler", "--device", "cpu"])
    capsys.readouterr()
    serve.main(["--config", str(tmp_path / "t"), "--images", imgs[0],
                "--output_dir", str(tmp_path / "ck"), "--res", "16",
                "--batch", "1", "--save_npz", "--device", "cpu"])
    assert "# restored checkpoint params at step 1" in capsys.readouterr().out
    cfg_run, ckpt = resolve_config_arg(str(tmp_path / "t"))
    pipe = build_pipeline(cfg_run, seed=2024, device="cpu")

    def served():  # as the CLI runs it: on the session's thread
        with ServingSession(pipe, batch=1, max_delay_s=0.05) as sess:
            return sess.submit(_to_norm(png.read_png(imgs[0]))).result(
                timeout=300)

    untrained = served()
    step, params = restore_params(ckpt, dict(pipe.unet.named_parameters()))
    assert step == 1
    for n, p in trained.state.params.items():
        assert torch.equal(params[n], p.detach()), n
    want = served()
    assert not np.array_equal(want, untrained)
    raw = np.load(tmp_path / "ck/img0.npz")
    for ti, task in enumerate(TASKS):
        np.testing.assert_array_equal(raw[task], postprocess_prediction(
            task, want[ti], class_colors()))
