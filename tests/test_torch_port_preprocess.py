"""PyTorch port, the preprocessing jobs (`stablemtl_tpu_torch.preprocess`)
against the JAX package's: the 14 preprocessing cases of
tests/test_preprocess_drivers.py and tests/test_preprocess_viz.py, each
run through both packages on the same synthetic inputs. The jobs' files
must be byte-equal, the arrays and lists equal."""

import importlib
import os

import numpy as np
import pytest

import chip_smoke

# the modules (the packages' `depth_to_normal` is also a function's name)
JAX, PORT = ({key: importlib.import_module(f"{pkg}.preprocess.{name}")
              for key, name in (("ft", "flyingthings3d"), ("hp", "hypersim"),
                                ("mid", "mid_intrinsics"), ("vk", "vkitti"),
                                ("d2n", "depth_to_normal"))}
             for pkg in ("stablemtl_tpu", "stablemtl_tpu_torch"))


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_equal(got, want):
    """Arrays, lists, tuples, dicts and scalars, recursively."""
    assert type(got) is type(want)
    if isinstance(got, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    elif isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _assert_equal(got[k], want[k])
    else:
        assert got == want


# ---------------------------------------------------------------------------
# Functions on arrays and lists (tests/test_preprocess_viz.py and the
# jobs' pure helpers)
# ---------------------------------------------------------------------------

def _tone_map(m):
    rgb = np.random.default_rng(0).uniform(0, 4.0, (32, 32, 3))
    return (m["hp"].tone_map_hdr(rgb),
            m["hp"].tonemap_scale(np.zeros((8, 8, 3))))


def _dist_to_depth(m):
    return m["hp"].dist_to_depth(
        np.random.default_rng(2).uniform(5, 15, (768, 1024)))


def _shading(m):
    rng = np.random.default_rng(1)
    albedo = rng.uniform(0.2, 1.0, (8, 8, 3))
    return m["hp"].shading_from(albedo * rng.uniform(0.1, 1.0, (8, 8, 3)),
                                albedo)


def _disp2pc(m):
    rng = np.random.default_rng(3)
    flow = rng.uniform(-4, 4, (8, 8, 2))
    return (m["ft"].disp2pc(np.full((8, 8), 2.0)),
            m["ft"].disp2pc(rng.uniform(20, 60, (8, 8)), flow=flow))


def _ft3d_sample(m):
    rng = np.random.default_rng(4)
    flow = rng.uniform(-8, 8, (16, 16, 2)).astype(np.float32)
    flow[0, 0] = [600.0, 0.0]  # beyond the 500 px clamp
    return m["ft"].preprocess_ft3d_sample(
        rng.uniform(40, 60, (16, 16)), rng.uniform(-1, 1, (16, 16)), flow)


def _depth_to_normal(m):
    yy, xx = np.mgrid[:32, :64]
    tilted = 5.0 + 0.02 * xx + 0.05 * yy
    return [m["d2n"].depth_to_normal(d, fx=700, fy=700, u0=32, v0=16,
                                     version=v)
            for d in (np.full((32, 64), 5.0), tilted)
            for v in ("d2nt_basic", "d2nt_v3")]


def _mid_tonemap_and_shading(m):
    r = np.random.default_rng(0)
    hdr = r.uniform(0.0, 4.0, (16, 20, 3)).astype(np.float32)
    tm = m["mid"].tone_map_mid(hdr)
    albedo = r.uniform(0.1, 1.0, (16, 20, 3)).astype(np.float32)
    return tm, m["mid"].shading_from_albedo(tm, albedo)


def _regenerate_no_nan_split(m):
    filenames = ["ai_055_010/rgb_cam_01_fr0089.png "
                 "ai_055_010/depth_plane_cam_01_fr0089.png",
                 "ai_030_005/rgb_cam_00_fr0072.png "
                 "ai_030_005/depth_plane_cam_00_fr0072.png"]
    nans = ["data/hypersim/raw/ai_030_005/images/"
            "scene_cam_00_geometry_hdf5/frame.0072.depth_meters.hdf5"]
    return m["hp"].regenerate_no_nan_split(filenames, nans)


def _vkitti_derive_task_paths(m):
    return m["vk"].derive_task_paths(
        "Scene01/clone/frames/rgb/Camera_0/rgb_00001.jpg",
        "Scene01/clone/frames/depth/Camera_0/depth_00001.png")


@pytest.mark.parametrize("case", [
    _tone_map, _dist_to_depth, _shading, _disp2pc, _ft3d_sample,
    _depth_to_normal, _mid_tonemap_and_shading, _regenerate_no_nan_split,
    _vkitti_derive_task_paths], ids=lambda f: f.__name__.strip("_"))
def test_arrays_match_jax(case):
    _assert_equal(case(PORT), case(JAX))


# ---------------------------------------------------------------------------
# Jobs writing files (tests/test_preprocess_drivers.py)
# ---------------------------------------------------------------------------

def _hypersim_job(m, out, tmp_path):
    raw = tmp_path / "hypersim_raw"
    if not raw.exists():
        chip_smoke.write_hypersim_raw(str(raw), seed=0)
    m["hp"].main(["frames", "--dataset_dir", str(raw), "--output_dir",
                  str(out)])


def _ft3d_job(m, out, tmp_path):
    raw = tmp_path / "ft3d_raw"
    if not raw.exists():
        chip_smoke.write_ft3d_raw(str(raw), (10, 14), seed=1)
    m["ft"].main(["--input_dir", str(raw), "--output_dir", str(out),
                  "--split", "train"])


def _mid_split_files(m, out, tmp_path):
    names = [f"scene_{i:03d}" for i in range(20)]
    m["mid"].write_split_files(str(out), names, split="test", n_lite=5,
                               n_vis=2, seed=0)


def _mid_process_scene(m, out, tmp_path, monkeypatch):
    """The EXR reader replaced by arrays (this OpenCV may lack OpenEXR):
    the tone mapping, the shading and the four JPEGs."""
    r = np.random.default_rng(1)
    images = {"render.exr": r.uniform(0.0, 2.0, (8, 10, 3)),
              "albedo.exr": r.uniform(0.1, 1.0, (8, 10, 3))}
    monkeypatch.setattr(m["mid"], "read_exr",
                        lambda p: images[os.path.basename(p)]
                        .astype(np.float32))
    res = m["mid"].process_scene("render.exr", "albedo.exr",
                                 str(out / "scene_000"))
    assert res == {"rgb": str(out / "scene_000.jpg")}


def _vkitti_lists(m, out, tmp_path):
    split, ds, want = chip_smoke.write_vkitti_split(str(tmp_path / "vk"))
    counts = m["vk"].list_filenames(split, ds, str(out), "val")
    assert counts == {t: len(rows) for t, rows in want.items()}
    bad = tmp_path / "vkitti_val2.txt"
    bad.write_text("no/such/rgb_0.jpg no/such/depth_0.png\n")
    with pytest.raises(ValueError, match="Not found"):
        m["vk"].list_filenames(str(bad), ds, str(out / "bad"), "val2")


@pytest.mark.parametrize("case", [
    _hypersim_job, _ft3d_job, _mid_split_files, _mid_process_scene,
    _vkitti_lists], ids=lambda f: f.__name__.strip("_"))
def test_job_files_match_jax(case, tmp_path, monkeypatch):
    """The port's job and the JAX package's, on the same inputs into two
    directories: the same files, byte for byte."""
    trees = []
    for name, m in (("port", PORT), ("jax", JAX)):
        out = tmp_path / name
        out.mkdir()
        args = (m, out, tmp_path) + ((monkeypatch,) if case is
                                     _mid_process_scene else ())
        case(*args)
        trees.append(_tree(out))
    assert trees[0] and trees[0].keys() == trees[1].keys()
    for rel in trees[0]:
        assert trees[0][rel] == trees[1][rel], rel
