"""PyTorch port, the data layer: every dataset of the registry that a
synthetic tree covers gives bit-equal samples in both packages, and the
port's `build_train_loader` gives bit-equal batches to the JAX package's
over a fixed (seed, step) range: in-process, with two spawned worker
processes, and as two shards reassembled. The JAX twins are
tests/test_data_layer.py's test_loader_shard_bit_identical and
test_loader_worker_pool_bit_identical. numpy only: no model is built.
"""

import numpy as np
import pytest

from stablemtl_tpu.config import Config as JConfig
from stablemtl_tpu.data import DatasetMode as JDatasetMode
from stablemtl_tpu.data.augmentation import \
    AugmentationConfig as JAugmentationConfig
from stablemtl_tpu.data.datasets import get_dataset as j_get_dataset
from stablemtl_tpu.factory import build_train_loader as j_build_train_loader
from stablemtl_tpu.utils.normalizers import \
    get_depth_normalizer as j_get_depth_normalizer
from stablemtl_tpu_torch.config import Config
from stablemtl_tpu_torch.data.augmentation import AugmentationConfig
from stablemtl_tpu_torch.data.base import DatasetMode
from stablemtl_tpu_torch.data.datasets import DATASET_REGISTRY, get_dataset
from stablemtl_tpu_torch.factory import build_train_loader
from stablemtl_tpu_torch.utils.normalizers import get_depth_normalizer
from torch_port_helpers import (write_eval_trees, write_hypersim_tree,
                                write_vkitti_tree)

# the training recipe's augmentation (config/train_base_config.yaml)
AUG = {"enabled": True,
       "color_jitter": {"enabled": True, "brightness": 0.4, "contrast": 0.4,
                        "saturation": 0.4, "hue": 0.159},
       "random_horizontal_flip": {"enabled": True},
       "random_vertical_flip": {"enabled": True}}
DEPTH_NORM = {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
              "norm_max": 1.0, "min_max_quantile": 0.02}

# (registry name, tree, filename list, mode, extra config keys)
CASES = [
    ("vkitti_depth", "vkitti", "depth.txt", "train", {}),
    ("vkitti_depth", "vkitti", "depth.txt", "eval",
     {"valid_mask_crop": "garg", "resize_to_hw": [16, 24]}),
    ("vkitti_normal", "vkitti", "normal.txt", "train", {}),
    ("vkitti_semantic", "vkitti", "sem.txt", "train", {}),
    ("vkitti_optical_flow", "vkitti", "flow.txt", "train",
     {"resize_to_hw": [16, 24]}),
    ("vkitti_scene_flow", "vkitti", "scene_flow.txt", "train", {}),
    ("hypersim_depth", "hypersim", "train.txt", "train", {}),
    ("hypersim_normal", "hypersim", "train.txt", "train", {}),
    ("hypersim_albedo", "hypersim", "train.txt", "train", {}),
    ("hypersim_shading", "hypersim", "train.txt", "eval", {}),
    ("kitti", "kitti", "split.txt", "eval", {"resize_to_hw": [176, 608]}),
    ("diode", "diode", "split.txt", "eval",
     {"output_type": ["normal", "depth"]}),
    ("cityscapes", "cityscapes", "split.txt", "eval", {}),
    ("kitti_flow", "kitti_flow", "split.txt", "eval",
     {"output_type": ["optical_flow", "scene_flow"]}),
    ("flying_things_3D_optical_flow", "ft3d", "split.txt", "train",
     {"resize_to_hw": [268, 480]}),
    ("flying_things_3D_scene_flow", "ft3d", "split.txt", "train", {}),
    ("mid_intrinsic", "mid", "split.txt", "eval",
     {"output_type": ["albedo", "shading"]}),
]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    out = write_eval_trees(str(root))
    out["vkitti"] = write_vkitti_tree(str(root / "vkitti"))
    out["hypersim"] = write_hypersim_tree(str(root / "hypersim"))
    return out


def _entry(name, tree, lst, trees, extra):
    return {"name": name, "dir": tree, "filenames": f"{trees[tree]}/{lst}",
            **extra}


def assert_samples_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    # the single-frame alias the evaluator's one-encode path keys on
    assert (got["rgb_next_norm"] is got["rgb_norm"]) == \
        (want["rgb_next_norm"] is want["rgb_norm"])


def test_every_registry_entry_is_covered():
    """Every registry entry but the abstract `vkitti` base has a case."""
    assert {c[0] for c in CASES} == set(DATASET_REGISTRY) - {"vkitti"}


@pytest.mark.parametrize("name,tree,lst,mode,extra", CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_dataset_samples_bit_equal(trees, name, tree, lst, mode, extra):
    """get(i, rng) of the port's dataset equals the JAX package's, bit for
    bit, with the training augmentation on in train mode (the rng draws
    the jitter, flips, crops and scale)."""
    base = str(trees[tree]).rsplit("/", 1)[0]
    entry = _entry(name, tree, lst, trees, extra)
    jkw, kw = {}, {}
    if mode == "train":
        jkw = {"augmentation": JAugmentationConfig.from_dict(AUG),
               "depth_normalizer": j_get_depth_normalizer(DEPTH_NORM)}
        kw = {"augmentation": AugmentationConfig.from_dict(AUG),
              "depth_normalizer": get_depth_normalizer(DEPTH_NORM)}
    jds = j_get_dataset(entry, base, JDatasetMode(mode if mode == "train"
                                                 else "evaluate"), **jkw)
    ds = get_dataset(entry, base, DatasetMode(mode if mode == "train"
                                              else "evaluate"), **kw)
    assert len(ds) == len(jds) > 0
    for i in range(min(len(ds), 2)):
        for seed in (i, 100 + i):
            assert_samples_equal(ds.get(i, np.random.default_rng(seed)),
                                 jds.get(i, np.random.default_rng(seed)))


def _loader_cfg(trees):
    """A three-task mixture at 16x24 (vkitti depth, hypersim normal, vkitti
    optical flow), micro-batch 2, accumulation 2."""
    return {
        "dataset": {"train": {"name": "mixed", "prob_ls": [1.0, 0.5, 1.0],
                              "dataset_list": [
                                  _entry("vkitti_depth", "vkitti",
                                         "depth.txt", trees,
                                         {"resize_to_hw": [16, 24]}),
                                  _entry("hypersim_normal", "hypersim",
                                         "train.txt", trees,
                                         {"resize_to_hw": [16, 24]}),
                                  _entry("vkitti_optical_flow", "vkitti",
                                         "flow.txt", trees,
                                         {"resize_to_hw": [16, 24]})]}},
        "dataloader": {"seed": 5, "prefetch": 2, "num_workers": 0},
        "depth_normalization": DEPTH_NORM,
        "augmentation": {"default": AUG},
    }


def _batches(build, cfg_cls, trees, start=1, n=6, **kw):
    cfg = cfg_cls(_loader_cfg(trees))
    base = str(trees["vkitti"]).rsplit("/", 1)[0]
    loader = build(cfg, base, accumulation_steps=2, batch_size=2, seed=5,
                   **kw)
    return list(loader.batches(start_step=start, max_steps=n))


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["step"] == b["step"] and a["dataset_idx"] == \
            b["dataset_idx"]
        for k in ("rgb_norm", "rgb_next_norm", "target_3ch", "valid_mask",
                  "task_idx"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_batches(trees):
    return _batches(j_build_train_loader, JConfig, trees)


@pytest.mark.parametrize("how", ["in_process", "workers2", "shards2"])
def test_loader_batches_bit_equal(trees, jax_batches, how):
    """Micro-steps 1-6 from a resume offset: the port's batches equal the
    JAX package's in-process batches, whether built in-process (with the
    prefetch thread), by 2 spawned worker processes, or as the two halves
    of shard=(i, 2) concatenated. The schedule covers three datasets and
    three tasks (one per effective batch of two micro-steps)."""
    if how == "shards2":
        halves = [_batches(build_train_loader, Config, trees,
                           shard=(i, 2)) for i in range(2)]
        got = []
        for a, b in zip(*halves):
            assert a["rgb_norm"].shape[0] == b["rgb_norm"].shape[0] == 1
            got.append({k: np.concatenate([a[k], b[k]])
                        if k in ("rgb_norm", "rgb_next_norm", "target_3ch",
                                 "valid_mask") else a[k] for k in a})
            np.testing.assert_array_equal(a["task_idx"], b["task_idx"])
    else:
        got = _batches(build_train_loader, Config, trees,
                       num_workers=2 if how == "workers2" else None)
    assert {int(b["task_idx"]) for b in jax_batches} == {0, 1, 3}
    assert_batches_equal(got, jax_batches)
