"""End-to-end CLI drive on a synthetic vkitti depth tree (tiny scratch
model): train 3 effective iters straight and auto-checkpoint, run the eval
CLI on that checkpoint (reference workflow train_stablemtl.py ->
eval_mtl.py), and train 1 iter then resume the same output dir to 3.

Each `train_main` call pays its own Flax init and JAX tracing, so the two
runs are module fixtures that the three tests share: three `train_main`
calls per module run."""

import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    h, w = 32, 48
    rng = np.random.default_rng(0)
    base = root / "vkitti/Scene01/clone/frames"
    os.makedirs(base / "depth/Camera_0", exist_ok=True)
    os.makedirs(base / "rgb/Camera_0", exist_ok=True)
    lines = []
    # >= 8 samples: with 8 virtual devices the per-step batch is at least 8
    for i in range(8):
        rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        for fid in (i, i + 1):
            Image.fromarray(rgb).save(
                base / f"rgb/Camera_0/rgb_{fid:05d}.jpg")
        cv2.imwrite(str(base / f"depth/Camera_0/depth_{i:05d}.png"),
                    rng.uniform(100, 2000, (h, w)).astype(np.uint16))
        lines.append(
            f"Scene01/clone/frames/depth/Camera_0/depth_{i:05d}.png")
    with open(root / "depth_list.txt", "w") as f:
        f.write("\n".join(lines))
    return root


@pytest.fixture(scope="module")
def cli_config(data_root, tmp_path_factory):
    cfg_dir = tmp_path_factory.mktemp("cfg")
    cfg = cfg_dir / "tiny_e2e.yaml"
    cfg.write_text(f"""
base_config:
- {REPO}/config/train_debug_tiny.yaml

max_iter: 3

dataset:
  train:
    name: mixed
    prob_ls: [1.0]
    dataset_list:
    - name: vkitti_depth
      disp_name: vkitti_depth_train
      dir: vkitti
      filenames: {data_root}/depth_list.txt
      resize_to_hw: [32, 48]
  val: []
  vis: []
  test:
  - name: vkitti_depth
    disp_name: vkitti_depth_test
    dir: vkitti
    filenames: {data_root}/depth_list.txt
    resize_to_hw: [32, 48]
    output_type: [depth]
""")
    return cfg


def _train(cli_config, data_root, out, *extra):
    from stablemtl_tpu.cli.train import main as train_main

    train_main(["--config", str(cli_config), *extra,
                "--base_data_dir", str(data_root),
                "--output_dir", str(out)])
    return out


@pytest.fixture(scope="module")
def straight_run(data_root, cli_config, tmp_path_factory):
    """3 effective iters (the config's max_iter) uninterrupted."""
    return _train(cli_config, data_root, tmp_path_factory.mktemp("straight"))


@pytest.fixture(scope="module")
def resumed_run(data_root, cli_config, tmp_path_factory):
    """Interrupt after 1 iter (exit_after path is time-based; use
    max_iter), then resume the same dir to 3. Returns (run dir, the 1-iter
    run's checkpoint meta)."""
    out = _train(cli_config, data_root,
                 tmp_path_factory.mktemp("interrupted"), "--max_iter", "1")
    meta1 = json.loads((out / "checkpoint/latest.meta.json").read_text())
    _train(cli_config, data_root, out, "--max_iter", "3")
    return out, meta1


@pytest.fixture(scope="module")
def restore(cli_config):
    """(step, host params) of a run dir's latest checkpoint, restored into
    one template state built once."""
    import jax

    from stablemtl_tpu.checkpoint import CheckpointManager
    from stablemtl_tpu.config import recursive_load_config
    from stablemtl_tpu.factory import build_pipeline
    from stablemtl_tpu.train_state import (OptimizerConfig,
                                           create_train_state)

    cfg = recursive_load_config(str(cli_config), root=REPO)
    template = create_train_state(build_pipeline(cfg).unet_params,
                                  OptimizerConfig(use_schedule=False))

    def params_of(run_dir):
        st = CheckpointManager(str(run_dir / "checkpoint")) \
            .restore_params_only(template)
        return int(st.step), jax.device_get(st.params)

    return params_of


def test_train_then_eval_cli(data_root, cli_config, straight_run, tmp_path):
    from stablemtl_tpu.cli.eval import main as eval_main

    out = straight_run
    assert (out / "checkpoint/latest").is_dir()
    meta = json.loads((out / "checkpoint/latest.meta.json").read_text())
    assert meta.get("finished") is True

    eval_out = tmp_path / "eval"
    eval_main(["--config", str(cli_config),
               "--checkpoint", str(out / "checkpoint"),
               "--base_data_dir", str(data_root),
               "--split", "test", "--output_dir", str(eval_out),
               "--max_samples", "2", "--eval_batch_size", "2"])
    results = json.loads((eval_out / "eval_results.json").read_text())
    depth = results["vkitti_depth_test"]["depth"]
    assert np.isfinite(depth["abs_relative_difference"])
    assert (eval_out / "eval_results.csv").exists()
    assert (eval_out / "eval_results.txt").exists()


def test_train_cli_resume(resumed_run, restore):
    """The 1-iter run finishes and checkpoints; resuming its dir to 3
    continues the step counter from that checkpoint."""
    out, meta1 = resumed_run
    step, _ = restore(out)
    assert step == 3  # 1 micro-step per effective iter here
    assert meta1.get("finished") is True


def test_train_cli_interrupted_resume_bit_equal(straight_run, resumed_run,
                                                restore):
    """Replayable-resume contract on the 8-device virtual mesh (reference
    stablemtl_trainer.py:1095-1205 checkpointed seed lists; here the data
    schedule and all RNG replay from the step counter): 3 effective iters
    straight vs 1 iter + interrupt + resume to 3 must give BIT-EQUAL
    params. Exercises the ZeRO-1 sharded CLI step end-to-end (VERDICT
    round-2 item 7)."""
    import jax

    step_a, pa = restore(straight_run)
    step_b, pb = restore(resumed_run[0])
    assert step_a == step_b == 3
    flat_a = jax.tree_util.tree_leaves_with_path(pa)
    flat_b = jax.tree_util.tree_leaves_with_path(pb)
    assert len(flat_a) == len(flat_b)
    for (ka, va), (kb, vb) in zip(flat_a, flat_b):
        assert ka == kb
        np.testing.assert_array_equal(
            va, vb, err_msg=f"params diverge at {jax.tree_util.keystr(ka)}")
