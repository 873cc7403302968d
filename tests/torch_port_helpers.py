"""Shared helpers of the tests/test_torch_port_*.py files: random Flax
parameter trees made with numpy, their carry-over into the port, and the
`one_torch_thread` fixture each of those files imports.

Parameters are drawn at scales that keep activations near unit variance
(kernels N(0, 1/fan_in), norm scales 1 + 0.1 N, biases 0.1 N), and every
leaf is random, including the zero-initialized task-attention output
projection, so that no path of a block multiplies out to zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu_torch.models.convert import state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a port test module on one torch thread. The suite runs in
    several worker processes on a shared host; torch's default of one
    OpenMP thread per core in every worker oversubscribes it, and spinning
    threads then starve each other (an infer_all_tasks call of the tiny
    pipeline measured 0.2 s alone and 10 s beside three other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(init_fn, *args, seed: int = 0):
    """Flax params with the structure of init_fn(rng, *args), values from
    numpy (no init compile)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    r = np.random.RandomState(seed)

    def fill(path, sd):
        name = str(path[-1])
        shape = sd.shape
        if "scale" in name:
            return (1.0 + 0.1 * r.standard_normal(shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * r.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
        return (r.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_port(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load a Flax tree into a port module; strict, so every leaf maps."""
    module.load_state_dict(state_dict_from_flax(flax_params), strict=True)
    return module.eval()


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# Synthetic dataset trees (numpy, cv2, PIL), the JAX tests' own shapes:
# tests/test_data_layer.py (vkitti, hypersim), tests/test_eval_datasets.py
# (kitti_flow, FlyingThings3D, Cityscapes, MID) and
# tests/test_eval_integration.py (DIODE, KITTI).
# ---------------------------------------------------------------------------

def _lines(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _u16_flow_png(path, flow, valid, kind):
    """vkitti: g, r = flow normalized by (h-1), (w-1) to [0, 2^16-1];
    kitti/FT3D: (flow * 64 + 32768). b = valid."""
    import cv2

    h, w = flow.shape[:2]
    enc = np.zeros((h, w, 3), np.uint16)
    if kind == "vkitti":
        enc[..., 2] = np.round((flow[..., 0] / (w - 1) + 1) / 2 * 65535)
        enc[..., 1] = np.round((flow[..., 1] / (h - 1) + 1) / 2 * 65535)
    else:
        enc[..., 2] = np.round(flow[..., 0] * 64 + 32768)
        enc[..., 1] = np.round(flow[..., 1] * 64 + 32768)
    enc[..., 0] = valid.astype(np.uint16)
    assert cv2.imwrite(str(path), enc)


def write_vkitti_tree(root, h=32, w=48, n=4, seed=0):
    """Virtual KITTI 2 frames 0..n (rgb jpg), depth / flow / scene-flow /
    class-segmentation PNGs and normal npys for frames 0..n-1, and one
    filename list per task under root."""
    import os

    import cv2
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = "Scene01/clone/frames"
    subs = ("rgb", "depth", "forwardFlow", "forwardSceneFlow",
            "classSegmentation", "normal")
    for sub in subs:
        os.makedirs(os.path.join(root, base, sub, "Camera_0"), exist_ok=True)
    lists = {k: [] for k in ("depth", "flow", "scene_flow", "sem", "normal")}
    road = (100, 60, 100)  # vkitti Road, train id 0
    for i in range(n):
        rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        for fid in (i, i + 1):
            Image.fromarray(rgb).save(
                os.path.join(root, base, f"rgb/Camera_0/rgb_{fid:05d}.jpg"))
        rel = f"{base}/depth/Camera_0/depth_{i:05d}.png"
        cv2.imwrite(os.path.join(root, rel),
                    rng.uniform(100, 2000, (h, w)).astype(np.uint16))
        lists["depth"].append(rel)
        flow = rng.uniform(-3, 3, (h, w, 2)).astype(np.float32)
        rel = f"{base}/forwardFlow/Camera_0/flow_{i:05d}.png"
        _u16_flow_png(os.path.join(root, rel), flow, rng.random((h, w)) > .2,
                      "vkitti")
        lists["flow"].append(rel)
        rel = f"{base}/forwardSceneFlow/Camera_0/sceneFlow_{i:05d}.png"
        cv2.imwrite(os.path.join(root, rel),
                    rng.integers(0, 65535, (h, w, 3)).astype(np.uint16))
        lists["scene_flow"].append(rel)
        sem = np.zeros((h, w, 3), np.uint8)
        sem[:] = road
        sem[: h // 4] = (90, 200, 255)  # sky
        rel = f"{base}/classSegmentation/Camera_0/classgt_{i:05d}.png"
        Image.fromarray(sem).save(os.path.join(root, rel))
        lists["sem"].append(rel)
        nrm = rng.standard_normal((h, w, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        rel = f"{base}/normal/Camera_0/normal_{i:05d}.npy"
        np.save(os.path.join(root, rel), nrm)
        lists["normal"].append(rel)
    for k, lines in lists.items():
        _lines(os.path.join(root, f"{k}.txt"), lines)
    return root


def write_hypersim_tree(root, h=24, w=32, n=6, seed=0):
    """Hypersim rgb / depth / reflectance / shading PNGs and normal npys;
    root/train.txt lists them."""
    import os

    import cv2
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("rgb", "depth", "normal", "reflectance", "shading"):
        os.makedirs(os.path.join(root, "scene", sub), exist_ok=True)
    lines = []
    for i in range(n):
        for sub in ("rgb", "reflectance", "shading"):
            Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)) \
                .save(os.path.join(root, f"scene/{sub}/frame_{i}.png"))
        cv2.imwrite(os.path.join(root, f"scene/depth/frame_{i}.png"),
                    rng.uniform(500, 30000, (h, w)).astype(np.uint16))
        nrm = rng.standard_normal((h, w, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        np.save(os.path.join(root, f"scene/normal/frame_{i}.npy"), nrm)
        np.save(os.path.join(root, f"scene/normal/mask_{i}.npy"),
                rng.random((h, w)) > 0.1)
        lines.append(f"scene/rgb/frame_{i}.png scene/depth/frame_{i}.png "
                     f"scene/normal/frame_{i}.npy _ "
                     f"scene/normal/mask_{i}.npy")
    _lines(os.path.join(root, "train.txt"), lines)
    return root


def write_eval_trees(root):
    """The eval datasets' trees under root/<name>: kitti_flow (375x1242),
    ft3d (540x960), cityscapes, mid, diode, kitti. Returns {name: dir}."""
    import os

    import cv2
    from PIL import Image

    out = {}
    # KITTI flow 2015: constant flow, disparities 64 -> 32 px
    d = out["kitti_flow"] = os.path.join(root, "kitti_flow")
    h, w = 375, 1242
    rng = np.random.default_rng(3)
    for sub in ("flow_occ", "image_2", "disp_occ_0", "disp_occ_1",
                "calib_cam_to_cam"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for fid in ("10", "11"):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)) \
            .save(os.path.join(d, f"image_2/000000_{fid}.png"))
    flow = np.zeros((h, w, 2), np.float32)
    flow[..., 0] = 1.5
    valid = np.ones((h, w), bool)
    valid[-5:] = False
    _u16_flow_png(os.path.join(d, "flow_occ/000000_10.png"), flow, valid,
                  "kitti")
    disp2 = np.full((h, w), 32 * 256, np.uint16)
    disp2[:, :3] = 0
    cv2.imwrite(os.path.join(d, "disp_occ_0/000000_10.png"),
                np.full((h, w), 64 * 256, np.uint16))
    cv2.imwrite(os.path.join(d, "disp_occ_1/000000_10.png"), disp2)
    fx, cx, cy = 721.5377, 609.5593, 172.854
    _lines(os.path.join(d, "calib_cam_to_cam/000000.txt"), [
        f"P_rect_02: {fx} 0.0 {cx} 44.857 0.0 {fx} {cy} 0.216 0.0 0.0 1.0 "
        f"0.0027"])
    _lines(os.path.join(d, "split.txt"), ["flow_occ/000000_10.png"])

    # FlyingThings3D: a point cloud on the pixel grid
    d = out["ft3d"] = os.path.join(root, "ft3d")
    h, w = 540, 960
    rng = np.random.default_rng(5)
    for sub in ("image_clean", "flow_2d", "pc", "flow_3d"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for fid in (0, 1):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)) \
            .save(os.path.join(d, f"image_clean/{fid:07d}.png"))
    _u16_flow_png(os.path.join(d, "flow_2d/0000000.png"),
                  rng.uniform(-20, 20, (h, w, 2)).astype(np.float32),
                  rng.random((h, w)) > 0.1, "kitti")
    f = 1050.0
    z = rng.uniform(5.0, 30.0, (h, w)).astype(np.float32)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    pc1 = np.stack([(uu - 479.5) * z / f, (vv - 269.5) * z / f, z], -1)
    np.savez(os.path.join(d, "pc/0000000.npz"), pc1=pc1.reshape(-1, 3))
    np.save(os.path.join(d, "flow_3d/0000000.npy"),
            rng.uniform(-1, 1, (h * w, 3)).astype(np.float32))
    _lines(os.path.join(d, "split.txt"), ["flow_2d/0000000.png"])

    # Cityscapes: road, sky and unlabeled label ids
    d = out["cityscapes"] = os.path.join(root, "cityscapes")
    h, w = 64, 128
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(d, "leftImg8bit/val/foo"), exist_ok=True)
    os.makedirs(os.path.join(d, "gtFine/val/foo"), exist_ok=True)
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
        os.path.join(d, "leftImg8bit/val/foo/foo_000000_leftImg8bit.png"))
    labels = np.zeros((h, w), np.uint8)
    labels[: h // 2] = 7
    labels[h // 2:, : w // 2] = 23
    Image.fromarray(labels).save(
        os.path.join(d, "gtFine/val/foo/foo_000000_gtFine_labelIds.png"))
    _lines(os.path.join(d, "split.txt"),
           ["leftImg8bit/val/foo/foo_000000_leftImg8bit.png"])

    # MID-Intrinsics
    d = out["mid"] = os.path.join(root, "mid")
    os.makedirs(d, exist_ok=True)
    h, w = 48, 64
    rng = np.random.default_rng(9)
    albedo = np.full((h, w, 3), 140, np.uint8)
    albedo[:8, :8] = 0
    for name, img in (("a.jpg", (rng.random((h, w, 3)) * 200 + 30)
                       .astype(np.uint8)),
                      ("a_albedo.jpg", albedo),
                      ("a_shading.jpg", np.full((h, w, 3), 90, np.uint8))):
        Image.fromarray(img).save(os.path.join(d, name), quality=98)
    _lines(os.path.join(d, "split.txt"), ["a.jpg"])

    # DIODE: rgb + depth / mask / normal npys
    d = out["diode"] = os.path.join(root, "diode")
    os.makedirs(os.path.join(d, "scans"), exist_ok=True)
    h, w = 32, 32
    rng = np.random.default_rng(0)
    lines = []
    for i in range(2):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)) \
            .save(os.path.join(d, f"scans/{i:05d}.png"))
        np.save(os.path.join(d, f"scans/{i:05d}_depth.npy"),
                rng.uniform(1, 20, (h, w, 1)).astype(np.float32))
        np.save(os.path.join(d, f"scans/{i:05d}_depth_mask.npy"),
                np.ones((h, w), bool))
        nrm = rng.standard_normal((h, w, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        np.save(os.path.join(d, f"scans/{i:05d}_normal.npy"), nrm)
        lines.append(f"scans/{i:05d}.png scans/{i:05d}_depth.npy "
                     f"scans/{i:05d}_depth_mask.npy")
    _lines(os.path.join(d, "split.txt"), lines)

    # KITTI eigen: sparse uint16 depth
    d = out["kitti"] = os.path.join(root, "kitti")
    for sub in ("img", "gt"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    h, w = 370, 1230
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)) \
        .save(os.path.join(d, "img/0.png"))
    depth = np.zeros((h, w), np.uint16)
    depth[200:300, 300:900] = (rng.uniform(5, 60, (100, 600)) * 256) \
        .astype(np.uint16)
    cv2.imwrite(os.path.join(d, "gt/0.png"), depth)
    _lines(os.path.join(d, "split.txt"), ["img/0.png gt/0.png",
                                          "img/0.png None"])
    return out
