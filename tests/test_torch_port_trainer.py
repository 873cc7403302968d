"""PyTorch port, the training and evaluation entry points on the CPU:
`cli.train` for 3 effective iterations on a synthetic vkitti tree (nano
preset, micro-batch 2, accumulation 2), then `cli.eval` on the run; a run
stopped after 1 iteration by --max_iter, and one stopped in the middle of
an accumulation by --exit_after, each resumed to the end, hold parameters,
Adam moments and loss EMA bit-equal to the uninterrupted run (the contract
of tests/test_cli_e2e.py::test_train_cli_interrupted_resume_bit_equal);
the `best` slot, the iter_XXXXXX backups and the re-validation of a
checkpoint saved mid-validation, as tests/test_trainer_ckpt.py holds them
for the JAX package, a slot swap interrupted between its renames, the
visualization panels, and the factory's training builders against the
JAX package's. No JAX model is built.
"""

import json
import os

import numpy as np
import pytest
import torch

from stablemtl_tpu_torch.checkpoint import CheckpointManager
from stablemtl_tpu_torch.cli import eval as eval_cli
from stablemtl_tpu_torch.cli import train as train_cli
from torch_port_helpers import write_eval_trees, write_vkitti_tree
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_trainer_data")
    write_vkitti_tree(str(root / "vkitti"))
    write_eval_trees(str(root))
    return root


@pytest.fixture(scope="module")
def config(data_root, tmp_path_factory):
    path = tmp_path_factory.mktemp("port_trainer_cfg") / "nano.yaml"
    path.write_text(f"""
base_config:
- {REPO}/config/train_debug_tiny.yaml
model:
  size_preset: nano
max_iter: 3
trainer:
  save_period: 1
  backup_period: 2
dataloader:
  effective_batch_size: 4
  max_train_batch_size: 2
dataset:
  train:
    name: mixed
    prob_ls: [1.0]
    dataset_list:
    - name: vkitti_depth
      dir: vkitti
      filenames: {data_root}/vkitti/depth.txt
      resize_to_hw: [16, 16]
  val: []
  vis: []
  test:
  - name: vkitti_depth
    disp_name: vkitti_depth_test
    dir: vkitti
    filenames: {data_root}/vkitti/depth.txt
    resize_to_hw: [16, 16]
  - name: diode
    disp_name: diode_test
    dir: diode
    filenames: {data_root}/diode/split.txt
    resize_to_hw: [16, 16]
    output_type: [depth, normal]
""")
    return str(path)


def train(config, data_root, out, *extra):
    return train_cli.main(["--config", config, "--base_data_dir",
                           str(data_root), "--output_dir", str(out),
                           "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def straight(config, data_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("straight")
    return out, train(config, data_root, out)


# the optimizer sections of the resume cases beside the base config's Adam
OPTIMIZERS = {
    "adafactor": {"name": "adafactor", "skip_nonfinite_updates": 3},
    "adam_mu_bf16": {"name": "adam", "mu_dtype": "bfloat16",
                     "skip_nonfinite_updates": 3},
}


@pytest.fixture(scope="module")
def runs(straight, config, data_root, tmp_path_factory):
    """{optimizer: (config path, uninterrupted run directory)}, each run
    made once."""
    made = {"adam": (config, straight[0])}

    def get(optim):
        if optim not in made:
            root = tmp_path_factory.mktemp(f"straight_{optim}")
            path = root / "config.yaml"
            path.write_text(json.dumps({"base_config": [config],
                                        "optimizer": OPTIMIZERS[optim]}))
            train(str(path), data_root, root / "run")
            made[optim] = (str(path), root / "run")
        return made[optim]

    return get


def checkpoint_of(run):
    path = os.path.join(run, "checkpoint", "latest")
    params = torch.load(os.path.join(path, "params.pt"), weights_only=True)
    opt = torch.load(os.path.join(path, "opt_state.pt"), weights_only=True)
    with open(os.path.join(path, "state.json")) as f:
        step = json.load(f)["step"]
    with open(os.path.join(run, "checkpoint", "latest.meta.json")) as f:
        meta = json.load(f)
    return step, params, opt, meta


def test_train_cli_then_eval_cli(straight, data_root, tmp_path):
    out, trainer = straight
    step, params, opt, meta = checkpoint_of(out)
    assert step == trainer.state.step == 6
    assert meta["finished"] is True and meta["effective_iter"] == 3
    assert opt["count"] == 3 and opt["mini_step"] == 0
    # one save per effective iteration; the final save wrote only the meta
    assert [name for name, _, _ in trainer.ckpt.saves] == \
        ["latest", "latest", "iter_000002", "latest"]
    assert sorted(os.listdir(out / "checkpoint")) == [
        "iter_000002", "latest", "latest.meta.json"]
    for n, p in trainer.state.params.items():
        assert torch.equal(params[n], p.detach()), n
    assert (out / "config_resolved.json").exists()
    assert (out / "code_snapshot.tar.gz").exists()
    assert np.isfinite(trainer.loss_ema["depth"])

    results, ev = eval_cli.main([
        "--config", str(out), "--base_data_dir", str(data_root),
        "--split", "test", "--output_dir", str(tmp_path / "eval"),
        "--eval_batch_size", "2", "--max_samples", "2",
        "--save_predictions", "--device", "cpu"])
    # the params-only restore is bit-equal to the trained parameters
    assert ev.state.step == 6 and ev.state.opt is None
    for n, p in trainer.state.params.items():
        assert torch.equal(ev.state.params[n], p.detach()), n
    assert set(results) == {"vkitti_depth_test", "diode_test"}
    assert set(results["diode_test"]) == {"depth", "normal"}
    for per_task in results.values():
        for row in per_task.values():
            assert all(np.isfinite(v) for v in row.values()), row
    for ext in ("json", "txt", "csv"):
        assert (tmp_path / "eval" / f"eval_results.{ext}").exists()
    assert len(os.listdir(tmp_path / "eval" / "predictions")) == 6


@pytest.mark.parametrize("stop,optim", [
    pytest.param("max_iter", "adam", id="max_iter"),
    pytest.param("exit_after", "adam", id="exit_after"),
    pytest.param("max_iter", "adafactor", id="max_iter-adafactor"),
    pytest.param("exit_after", "adafactor", id="exit_after-adafactor"),
    pytest.param("max_iter", "adam_mu_bf16", id="max_iter-adam_mu_bf16"),
    pytest.param("exit_after", "adam_mu_bf16",
                 id="exit_after-adam_mu_bf16")])
def test_interrupted_resume_is_bit_equal(runs, data_root, tmp_path, stop,
                                         optim):
    """Stopped after effective iteration 1 (--max_iter 1), or after
    micro-step 1 of 2 of the first accumulation (--exit_after of a
    microsecond: the accumulated gradient and the mini-step are saved),
    then resumed to iteration 3: with Adam, Adafactor (factored v_row,
    v_col and v) and Adam with its first moment in bf16 (saved in bf16),
    the last two under apply_if_finite (its counters saved), every piece
    of the optimizer's state is bit-equal to the uninterrupted run's."""
    config, straight = runs(optim)
    out = tmp_path / "run"
    first = train(config, data_root, out,
                  *(["--max_iter", "1"] if stop == "max_iter"
                    else ["--exit_after", "1e-8"]))
    step, _, opt, meta = checkpoint_of(out)
    if stop == "max_iter":
        assert step == 2 and meta["finished"] is True
    else:
        assert step == 1 and meta["interrupted"] is True
        assert opt["mini_step"] == 1 and opt["count"] == 0
        assert any(a.abs().max() > 0 for a in opt["acc"].values())
    assert meta["loss_ema"] == first.loss_ema
    resumed = train(config, data_root, out)
    assert resumed.step_times[0][0] == step + 1

    want = checkpoint_of(straight)
    got = checkpoint_of(out)
    assert got[0] == want[0] == 6
    for n in want[1]:
        assert torch.equal(got[1][n], want[1][n]), n
    assert set(got[2]) == set(want[2])
    moments = {"adam": ("mu", "nu"), "adafactor": ("v_row", "v_col", "v"),
               "adam_mu_bf16": ("mu", "nu")}[optim]
    for key in moments + ("acc",):
        assert want[2][key] and set(got[2][key]) == set(want[2][key])
        for n in want[2][key]:
            assert got[2][key][n].dtype == want[2][key][n].dtype
            assert torch.equal(got[2][key][n], want[2][key][n]), (key, n)
    if optim == "adam_mu_bf16":
        assert all(t.dtype == torch.bfloat16 for t in got[2]["mu"].values())
    if optim == "adafactor":  # the nano banks' [7, 640, 640] q nets factor
        assert got[2]["v_row"] and len(got[2]["v"]) > len(got[2]["v_row"])
    for key in ("count", "optimizer", "notfinite_count", "last_finite",
                "total_notfinite"):
        assert got[2][key] == want[2][key], key
    assert got[2]["count"] == 3
    assert got[3]["loss_ema"] == want[3]["loss_ema"]


def test_best_slot_and_mid_validation_resume(straight, data_root, tmp_path):
    """Best-metric tracking keeps a `best` slot (tests/test_trainer_ckpt.py
    ::test_best_metric_tracking_and_best_checkpoint); a checkpoint saved
    with in_evaluation re-runs the validation on resume, uses its result
    and clears the flag."""
    from stablemtl_tpu_torch.data.base import DatasetMode
    from stablemtl_tpu_torch.data.datasets import get_dataset
    from stablemtl_tpu_torch.trainer import (StableMTLTrainer,
                                             TrainerConfig, _lookup_metric)

    results = {"dsA": {"depth": {"abs_relative_difference": 0.5,
                                 "delta1_acc": 0.9}},
               "dsB": {"normal": {"mean_angular_error": 20.0}}}
    assert _lookup_metric(results, "") == 0.5
    assert _lookup_metric(results, "delta1_acc") == 0.9
    assert _lookup_metric(results, "normal/mean_angular_error") == 20.0
    assert _lookup_metric(results, "dsB/normal/mean_angular_error") == 20.0
    assert _lookup_metric(results, "nope") is None

    _, done = straight
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    trainer = StableMTLTrainer(
        done.pipeline, done.state, loader=None,
        config=TrainerConfig(main_val_metric="abs_relative_difference"),
        ckpt=ckpt)
    trainer._update_best({"d": {"depth": {"abs_relative_difference": 0.4}}},
                         eff=10)
    assert ckpt.exists("best") and ckpt.load_meta("best")["best_metric"] == .4
    trainer._update_best({"d": {"depth": {"abs_relative_difference": 0.6}}},
                         eff=20)
    assert trainer.best_metric == 0.4
    assert ckpt.load_meta("best")["effective_iter"] == 10
    trainer._update_best({"d": {"depth": {"abs_relative_difference": 0.3}}},
                         eff=30)
    assert ckpt.load_meta("best")["best_metric"] == 0.3
    tmax = StableMTLTrainer(
        done.pipeline, done.state, loader=None,
        config=TrainerConfig(main_val_metric="delta1_acc",
                             main_val_metric_goal="maximize"))
    for v in (0.5, 0.4):
        tmax._update_best({"d": {"depth": {"delta1_acc": v}}}, eff=1)
    assert tmax.best_metric == 0.5

    # `latest` saved mid-validation (as the trainer saves it before
    # validate), with a better metric still to come
    ckpt.save(trainer.state, meta={"effective_iter": 3,
                                   "in_evaluation": True,
                                   "best_metric": 10.0})
    val = get_dataset({"name": "vkitti_depth", "dir": "vkitti",
                       "filenames": f"{data_root}/vkitti/depth.txt",
                       "resize_to_hw": [16, 16], "disp_name": "vk"},
                      str(data_root), DatasetMode.EVAL)
    written = []
    fresh = StableMTLTrainer(
        done.pipeline, done.state, loader=None,
        config=TrainerConfig(gradient_accumulation_steps=2,
                             main_val_metric="abs_relative_difference",
                             eval_batch_size=2),
        ckpt=ckpt, val_datasets=[val],
        metric_writer=lambda step, scalars: written.append((step, scalars)))
    assert fresh.maybe_resume() == 6
    meta = ckpt.load_meta()
    assert meta["in_evaluation"] is False
    assert written and all(k.startswith("val/vk/depth/")
                           for k in written[0][1])
    assert fresh.best_metric == meta["best_metric"] < 10.0
    assert ckpt.load_meta("best")["best_metric"] == fresh.best_metric

    # a crash between the two renames of a swap leaves only latest.old:
    # the next access renames it back
    os.replace(tmp_path / "ckpt/latest", tmp_path / "ckpt/latest.old")
    assert ckpt.exists() and not (tmp_path / "ckpt/latest.old").exists()


def test_visualize_writes_panels(straight, data_root, tmp_path):
    """[input | GT | prediction] panels of the vis sets, 3x the sample's
    width (tests/test_trainer_ckpt.py::test_trainer_visualize_writes_pngs);
    images go to a metric writer that takes them."""
    from stablemtl_tpu_torch.data.base import DatasetMode
    from stablemtl_tpu_torch.data.datasets import get_dataset
    from stablemtl_tpu_torch.trainer import StableMTLTrainer, TrainerConfig
    from stablemtl_tpu_torch.utils.png import read_png

    class Writer:
        images = None

        def __call__(self, step, scalars):
            pass

        def write_images(self, step, images):
            Writer.images = (step, images)

    vis = get_dataset({"name": "diode", "dir": "diode", "disp_name": "dio",
                       "filenames": f"{data_root}/diode/split.txt",
                       "resize_to_hw": [16, 16],
                       "output_type": ["depth", "normal"]},
                      str(data_root), DatasetMode.EVAL)
    _, done = straight
    trainer = StableMTLTrainer(done.pipeline, done.state, loader=None,
                               config=TrainerConfig(), vis_datasets=[vis],
                               metric_writer=Writer())
    trainer.visualize(str(tmp_path / "vis"), max_samples=1)
    files = sorted(os.listdir(tmp_path / "vis"))
    assert files == ["dio_000_depth.png", "dio_000_normal.png"]
    for f in files:
        assert read_png(str(tmp_path / "vis" / f)).shape == (16, 48, 3)
    step, images = Writer.images
    assert step == 6 and sorted(images) == ["vis/dio/depth/0",
                                            "vis/dio/normal/0"]


def test_training_builders_match_jax(tmp_path):
    """factory.build_optimizer_config and accumulation_steps_of give the
    JAX package's values for every shipped training config;
    parallel.model 2 in one process is refused (the mesh does not cover
    it) before anything is built."""
    import dataclasses
    import glob

    from stablemtl_tpu.config import recursive_load_config as j_load
    from stablemtl_tpu.factory import \
        accumulation_steps_of as j_accumulation_steps_of
    from stablemtl_tpu.factory import \
        build_optimizer_config as j_build_optimizer_config
    from stablemtl_tpu_torch.config import recursive_load_config
    from stablemtl_tpu_torch.factory import (accumulation_steps_of,
                                             build_optimizer_config)

    paths = sorted(glob.glob(f"{REPO}/config/train_*.yaml"))
    assert len(paths) >= 4
    for path in paths:
        cfg, jcfg = recursive_load_config(path), j_load(path)
        for n in (1, 2, 8):
            assert accumulation_steps_of(cfg, n) == \
                j_accumulation_steps_of(jcfg, n), (path, n)
        for accum in (1, 4):
            assert dataclasses.asdict(build_optimizer_config(cfg, accum)) \
                == dataclasses.asdict(j_build_optimizer_config(jcfg, accum))

    cfg = tmp_path / "tp.yaml"
    cfg.write_text(f"base_config:\n- {REPO}/config/train_debug_tiny.yaml\n"
                   f"parallel:\n  model: 2\n")
    with pytest.raises(ValueError, match="does not cover 1 process"):
        train_cli.main(["--config", str(cfg), "--device", "cpu",
                        "--output_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_checkpoint_slots_of_each_optimizer(tmp_path):
    """An Adam slot written before the slot named its optimizer and held
    apply_if_finite's counters (the earlier layout) restores, with the counters
    at their start; a slot restores only into an optimizer of its kind and
    with its moments' dtype."""
    from stablemtl_tpu_torch.checkpoint import OPT_FILE
    from stablemtl_tpu_torch.train_state import (OptimizerConfig,
                                                 TrainState, make_optimizer)

    def state(**kw):
        params = {"w": torch.nn.Parameter(torch.arange(6.0).reshape(2, 3)),
                  "b": torch.nn.Parameter(torch.ones(3))}
        opt = make_optimizer(params.values(), OptimizerConfig(
            use_schedule=False, accumulation_steps=2, **kw))
        return TrainState(step=0, params=params, opt=opt)

    saved = state()
    for _ in range(3):
        saved.opt.update([torch.full((2, 3), 0.5), torch.full((3,), -1.0)])
        saved.step += 1
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(saved)
    path = tmp_path / "ck" / "latest" / OPT_FILE
    raw = torch.load(path, weights_only=True)
    assert raw["optimizer"] == "adam" and raw["last_finite"] is True
    for key in ("optimizer", "notfinite_count", "last_finite",
                "total_notfinite"):
        del raw[key]
    torch.save(raw, path)
    fresh = ckpt.restore(state())
    assert (fresh.step, fresh.opt.count, fresh.opt.mini_step) == (3, 1, 1)
    assert (fresh.opt.notfinite_count, fresh.opt.last_finite,
            fresh.opt.total_notfinite) == (0, True, 0)
    for got, want in zip(fresh.opt.mu + fresh.opt.nu + fresh.opt.acc,
                         saved.opt.mu + saved.opt.nu + saved.opt.acc):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="adam state"):
        ckpt.restore(state(optimizer="adafactor"))
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(state(mu_dtype="bfloat16"))
