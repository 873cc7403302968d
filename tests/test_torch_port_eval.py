"""PyTorch port, evaluation: the port's `Evaluator` and the JAX package's
take the same deterministic numpy inference functions over the same
datasets and give the same metric rows (1e-6 relative; the numpy code is
the same, so they come out bit-equal). The datasets are those of
tests/test_eval_datasets.py::test_evaluator_runs_all_seven_rows (real
dataset classes over synthetic trees) and
tests/test_evaluator_all_tasks.py (one in-memory set per task, perfect
predictions). No model is built.
"""

import numpy as np
import pytest

from stablemtl_tpu.data import DatasetMode as JDatasetMode
from stablemtl_tpu.data.datasets import get_dataset as j_get_dataset
from stablemtl_tpu.evaluation import Evaluator as JEvaluator
from stablemtl_tpu.evaluation import make_task_metrics as j_make_task_metrics
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.data.base import DatasetMode
from stablemtl_tpu_torch.data.datasets import get_dataset
from stablemtl_tpu_torch.evaluation import Evaluator, make_task_metrics
from stablemtl_tpu_torch.factory import class_colors
from torch_port_helpers import write_eval_trees, write_vkitti_tree

REL = 1e-6

# (registry name, tree, extra config keys): every eval row of
# config/dataset/dataset_test.yaml, and a multi-frame vkitti set
ROWS = [
    ("diode", "diode", {"output_type": ["depth", "normal"]}),
    ("kitti", "kitti", {}),
    ("cityscapes", "cityscapes", {}),
    ("kitti_flow", "kitti_flow",
     {"output_type": ["optical_flow", "scene_flow"]}),
    ("mid_intrinsic", "mid", {"output_type": ["albedo", "shading"]}),
    ("vkitti_optical_flow", "vkitti", {"resize_to_hw": [16, 24]}),
]


def smooth_infer(rgb, rgb_next, task_idx):
    """A deterministic stand-in for the model: [B, H, W, 3] in [-1, 1],
    a function of both frames and the task."""
    x = np.tanh(0.8 * rgb + 0.3 * (rgb if rgb_next is None else rgb_next)
                + 0.1 * float(task_idx))
    return x.astype(np.float32)


def smooth_infer_tasks(rgb, rgb_next, task_indices):
    return np.stack([smooth_infer(rgb, rgb_next, t) for t in task_indices])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_eval")
    out = write_eval_trees(str(root))
    out["vkitti"] = write_vkitti_tree(str(root / "vkitti"))
    return out


def assert_rows_close(got, want):
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys(), task
        for k, v in want[task].items():
            assert np.isfinite(v), (task, k)
            np.testing.assert_allclose(got[task][k], v, rtol=REL, atol=0,
                                       err_msg=f"{task}/{k}")


@pytest.mark.parametrize("name,tree,extra", ROWS, ids=[r[0] for r in ROWS])
def test_evaluator_rows_match_jax(trees, name, tree, extra):
    """Batch 2 (the last batch padded), the multi-task sets through
    infer_tasks_fn, the single-frame ones with rgb_next None."""
    lst = {"vkitti": "flow.txt"}.get(tree, "split.txt")
    entry = {"name": name, "dir": tree,
             "filenames": f"{trees[tree]}/{lst}", **extra}
    base = str(trees[tree]).rsplit("/", 1)[0]
    colors = class_colors()
    rows = []
    for ev_cls, metrics, get, mode in (
            (JEvaluator, j_make_task_metrics, j_get_dataset, JDatasetMode),
            (Evaluator, make_task_metrics, get_dataset, DatasetMode)):
        calls = []

        def infer_tasks(rgb, rgb_next, idx):
            calls.append((rgb.shape, rgb_next is None, tuple(idx)))
            return smooth_infer_tasks(rgb, rgb_next, idx)

        ds = get(entry, base, mode.EVAL)
        ev = ev_cls(infer_fn=smooth_infer, infer_tasks_fn=infer_tasks,
                    batch_size=2, class_colors=colors)
        rows.append((ev.evaluate(ds, metrics=metrics()), calls))
    (want, want_calls), (got, got_calls) = rows
    assert got_calls == want_calls
    assert_rows_close(got, want)


class _DS:
    """tests/test_evaluator_all_tasks.py's in-memory set of one task."""

    min_depth, max_depth = 1e-5, 80.0

    def __init__(self, task, n=3, h=16, w=16):
        self.output_type = task
        self.disp_name = f"fake_{task}"
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def get(self, idx, rng=None):
        r = np.random.RandomState(idx + 7)
        h, w = self.h, self.w
        img = r.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        s = {"rgb_norm": img, "rgb_next_norm": img,
             "valid_mask": np.ones((h, w, 1), bool),
             "output_type": self.output_type}
        t = self.output_type
        if t == "depth":
            s["depth_raw_linear"] = r.uniform(1, 10, (h, w, 1)) \
                .astype(np.float32)
        elif t == "normal":
            n = r.standard_normal((h, w, 3)).astype(np.float32)
            s["normal"] = n / np.linalg.norm(n, axis=-1, keepdims=True)
            s["normal_valid_mask"] = np.ones((h, w, 1), bool)
        elif t == "semantic":
            s["semantic_class_id"] = r.randint(0, 8, (h, w, 1))
        elif t == "optical_flow":
            s["optical_flow_raw"] = r.uniform(-5, 5, (h, w, 2)) \
                .astype(np.float32)
        elif t == "scene_flow":
            s["scene_flow"] = r.uniform(-2, 2, (h, w, 3)).astype(np.float32)
            s["scene_flow_valid_mask"] = np.ones((h, w, 1), bool)
        else:
            c = 3 if t == "albedo" else 1
            s[t] = r.uniform(0.2, 0.8, (h, w, c)).astype(np.float32)
            s[f"{t}_valid_mask"] = np.ones((h, w, 1), bool)
        return s


def _perfect(ds, idx, colors):
    """The 3-channel prediction that postprocesses to sample idx's GT."""
    s = ds.get(idx)
    t = ds.output_type
    if t == "depth":
        d = s["depth_raw_linear"]
        return np.repeat((d - d.min()) / (d.max() - d.min()) * 2 - 1, 3, -1)
    if t == "normal":
        return s["normal"]
    if t == "semantic":
        return colors[s["semantic_class_id"][..., 0]] / 255.0 * 2 - 1
    if t == "optical_flow":
        x = s["optical_flow_raw"] / np.abs(s["optical_flow_raw"]).max((0, 1))
        return np.concatenate([x, x[..., :1]], -1)
    if t == "scene_flow":
        return s["scene_flow"] / np.abs(s["scene_flow"]).max((0, 1))
    if t == "albedo":
        return s["albedo"] - 1
    return np.repeat(s["shading"] * 2 - 1, 3, -1)


@pytest.mark.parametrize("task", TASKS)
def test_evaluator_all_tasks_match_jax(task):
    """Perfect predictions of every task family through both Evaluators at
    batch 2 (3 samples: one padded batch): equal rows, near-perfect
    scores."""
    colors = class_colors()
    ds = _DS(task)

    def perfect_infer(rgb, rgb_next, task_idx):
        # each batch is consecutive samples: find them by their rgb
        idx = [next(i for i in range(len(ds))
                    if np.array_equal(ds.get(i)["rgb_norm"], x)) for x in rgb]
        return np.stack([_perfect(ds, i, colors) for i in idx]) \
            .astype(np.float32)

    want = JEvaluator(infer_fn=perfect_infer, batch_size=2,
                      class_colors=colors).evaluate(
        ds, metrics=j_make_task_metrics())
    got = Evaluator(infer_fn=perfect_infer, batch_size=2,
                    class_colors=colors).evaluate(ds, metrics=make_task_metrics())
    assert_rows_close(got, want)
    res = got[task]
    key, good = {"depth": ("abs_relative_difference", lambda v: v < 1e-4),
                 "normal": ("mean_angular_error", lambda v: v < 0.1),
                 "semantic": ("mIoU", lambda v: v > 0.999),
                 "optical_flow": ("EPE2d", lambda v: v < 1e-3),
                 "scene_flow": ("EPE3d", lambda v: v < 1e-3)}.get(
        task, ("rmse", lambda v: v < 1e-6))
    assert good(res[key]), res
