"""PyTorch port, data parallelism (`stablemtl_tpu_torch/parallel/`): the
ZeRO-1 shard-axis rule against the JAX package's own, and two gloo ranks on
the CPU (processes of tests/torch_port_parallel_worker.py, which imports no
jax) held against JAX on the global batch, against the port's one-process
step, ZeRO-1 against replicated data parallelism, resume across world
sizes, and `cli.train` over two processes through the env contract.

The nano preset in f32, built from one Flax tree carried over by
`state_dict_from_flax`, 16x16 inputs. The ranks start once, at the first
test that needs them, and run while this process compiles the JAX
reference; the tests read what they wrote.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablemtl_tpu.models import AutoencoderKL as JVAE
from stablemtl_tpu.models import UNet2DConditionModel as JUNet
from stablemtl_tpu.models.unet import tiny_unet_config as j_tiny_unet
from stablemtl_tpu.models.vae import tiny_vae_config as j_tiny_vae
from stablemtl_tpu.parallel.mesh import MeshConfig as JMeshConfig
from stablemtl_tpu.parallel.mesh import make_mesh as j_make_mesh
from stablemtl_tpu.parallel.sharded_train import _zero1_sharding_for
from stablemtl_tpu.pipeline import StableMTLPipeline as JPipeline
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.models.convert import state_dict_from_flax
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             tiny_unet_config)
from stablemtl_tpu_torch.parallel import MeshConfig, make_mesh, shard_batch
from stablemtl_tpu_torch.parallel.mesh import Mesh
from stablemtl_tpu_torch.parallel.sharded_train import (
    ShardedOptimizer, make_sharded_train_step, zero1_axis)
from stablemtl_tpu_torch.train_state import (Optimizer, OptimizerConfig,
                                             TrainState)
from test_torch_port_train import _jax_value_and_grad
from torch_port_helpers import random_params, write_vkitti_tree
from torch_port_helpers import one_torch_thread  # noqa: F401

import torch_port_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = len(TASKS)
HW = worker.HW
WORLD = 2
# bank kernels scaled up so the task attention is peaked and depends on
# the image: with near-uniform attention every row picks the same key and
# a statistic left local would go unnoticed
BANK_SCALE = 5.0
# glibc hands large freed blocks back to the OS and the next allocation
# faults them in again; the ranks keep theirs (a third of their time)
MALLOC_ENV = {"MALLOC_TRIM_THRESHOLD_": "4000000000",
              "MALLOC_MMAP_THRESHOLD_": "4000000000",
              "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, rank: int, port: int, log_path, **env):
    full = dict(os.environ, PYTHONPATH=REPO, **MALLOC_ENV,
                STABLEMTL_COORDINATOR=f"127.0.0.1:{port}",
                STABLEMTL_NUM_PROCESSES=str(WORLD),
                STABLEMTL_PROCESS_ID=str(rank), **env)
    log = open(log_path, "w")
    return subprocess.Popen(argv, env=full, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT), log


def _wait(procs):
    try:
        for proc, log in procs:
            rc = proc.wait(timeout=TIMEOUT_S)
            log.close()
            with open(log.name) as f:
                text = f.read()
            assert rc == 0, text[-4000:]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _scaled(tree):
    """The bank's last q and k projections times BANK_SCALE."""
    def scale(path, x):
        name = str(path[-1])
        if "task_to_q_net_6_kernel" in name or "task_to_k_fc2_kernel" in name:
            return x * np.float32(BANK_SCALE)
        return x

    return jax.tree_util.tree_map_with_path(scale, tree)


def _batch(r, n, task, dim_rows=0):
    """n rows at HW; the first `dim_rows` are flat and bright (they attend
    differently from the noise rows) and keep only their left half valid,
    so the ranks' mask counts differ."""
    rgb, nxt, gt = (r.uniform(-1, 1, (n, *HW, 3)).astype(np.float32)
                    for _ in range(3))
    rgb[:dim_rows] = rgb[:dim_rows] * 0.1 + 0.8
    valid = np.ones((n, *HW, 1), bool)
    valid[:dim_rows, :, HW[1] // 2:] = False
    return {"rgb_norm": rgb, "rgb_next_norm": nxt[:, :, ::-1].copy(),
            "target_3ch": gt, "valid_mask": valid,
            "task_idx": np.int32(task)}


@pytest.fixture(scope="module")
def flax_pipeline():
    """The JAX nano multi-stream pipeline (the port's `nano` preset: UNets
    (32, 64) wide with 2 heads, the tiny VAE) with `highest` masking at
    ratio 1, on random weights."""
    nano = dict(worker.NANO)
    lat = np.zeros((1, HW[0] // 8, HW[1] // 8, 12), np.float32)
    t0 = np.zeros((1,), np.int32)
    ctx = np.zeros((1, 4, 32), np.float32)
    vae = JVAE(j_tiny_vae())
    vae_p = random_params(vae.init, np.zeros((1, *HW, 3), np.float32),
                          seed=61)
    child = JUNet(j_tiny_unet(**nano))
    child_p = random_params(child.init, lat, t0, ctx, seed=62)
    unet = JUNet(j_tiny_unet(use_task_attention=True, **nano,
                             **worker.TRAINER))
    _, taps = jax.eval_shape(lambda p: child.apply(
        p, lat, t0, ctx, tap="afterSelfAttn_residual"), child_p)
    feats = [jnp.zeros((T - 1,) + tp.shape) for tp in taps]
    unet_p = _scaled(random_params(
        lambda k, x, t, c: unet.init(k, x, t, c, task_feats=feats,
                                     main_idx=jnp.asarray(0),
                                     aux_idx=jnp.arange(1, T)),
        lat, t0, ctx, seed=63))
    table = (np.random.RandomState(64).standard_normal((T, 4, 32)) * 0.5
             ).astype(np.float32)
    return JPipeline(vae=vae, unet=unet, vae_params=vae_p,
                     unet_params=unet_p, text_embed_table=jnp.asarray(table),
                     unet_child=child, unet_child_params=child_p)


@pytest.fixture(scope="module")
def batches():
    r = np.random.RandomState(65)
    return {"grad": _batch(r, 4, TASKS.index("optical_flow"), dim_rows=2),
            "steps": [_batch(r, WORLD, t) for t in (1, 1, 3, 3)]}


CLI_CONFIG = """
base_config:
- {repo}/config/train_debug_tiny.yaml
model:
  size_preset: nano
max_iter: 1
trainer:
  save_period: 1
  validation_period: 1
dataloader:
  effective_batch_size: 4
  max_train_batch_size: {max_bs}
dataset:
  train:
    name: mixed
    prob_ls: [1.0]
    dataset_list:
    - name: vkitti_depth
      dir: vkitti
      filenames: {root}/vkitti/depth.txt
      resize_to_hw: [16, 16]
  val:
  - name: vkitti_depth
    disp_name: vkitti_depth_val
    dir: vkitti
    filenames: {root}/vkitti/depth.txt
    resize_to_hw: [16, 16]
  vis: []
  test: []
"""


@pytest.fixture(scope="module")
def spawned(flax_pipeline, batches, tmp_path_factory):
    """Starts the two worker ranks on the pipeline and batches, two ranks
    of `python -m stablemtl_tpu_torch.cli.train` on a synthetic vkitti
    tree (1 row a rank), and the same CLI as one process on the same
    global micro-batch (2 rows); returns (worker dir, cli run dirs (2
    ranks, 1 process), process handles)."""
    d = tmp_path_factory.mktemp("ranks")

    def tensors(b):
        return {k: torch.from_numpy(np.asarray(v)) if k != "task_idx"
                else int(v) for k, v in b.items()}

    jp = flax_pipeline
    torch.save({"unet": state_dict_from_flax(jp.unet_params),
                "child": state_dict_from_flax(jp.unet_child_params),
                "vae": state_dict_from_flax(jp.vae_params),
                "table": torch.tensor(np.asarray(jp.text_embed_table)),
                "grad_batch": tensors(batches["grad"]),
                "batches": [tensors(b) for b in batches["steps"]]},
               d / "inputs.pt")
    script = os.path.join(REPO, "tests", "torch_port_parallel_worker.py")
    port = _free_port()
    procs = [_spawn([sys.executable, script, str(d)], r, port,
                    d / f"worker{r}.log") for r in range(WORLD)]

    root = tmp_path_factory.mktemp("cli_ranks")
    write_vkitti_tree(str(root / "vkitti"))
    for max_bs in (1, 2):
        (root / f"nano_mb{max_bs}.yaml").write_text(
            CLI_CONFIG.format(repo=REPO, root=root, max_bs=max_bs))
    runs = root / "run", root / "run1"

    def argv(max_bs, run):
        return [sys.executable, "-m", "stablemtl_tpu_torch.cli.train",
                "--config", str(root / f"nano_mb{max_bs}.yaml"),
                "--base_data_dir", str(root), "--device", "cpu",
                "--exit_after", "100000", "--output_dir", str(run)]

    port = _free_port()
    procs += [_spawn(argv(1, runs[0]), r, port, root / f"cli{r}.log")
              for r in range(WORLD)]
    log = open(root / "cli1.log", "w")
    procs.append((subprocess.Popen(
        argv(2, runs[1]), cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=REPO, **MALLOC_ENV)), log))
    yield d, runs, procs
    for proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    # the inputs and the ranks' results hold the nano UNet several times
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def ranks(spawned):
    """[rank 0's results, rank 1's] (tests/torch_port_parallel_worker.py),
    and the directory they were written to."""
    d, _, procs = spawned
    _wait(procs[:WORLD])
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)], d


@pytest.fixture(scope="module")
def cli_runs(spawned):
    _, runs, procs = spawned
    _wait(procs[WORLD:])
    return runs


@pytest.fixture(scope="module")
def jax_reference(flax_pipeline, batches):
    """The JAX package's loss and gradients (by port name) of the global
    batch."""
    jp = flax_pipeline
    fn = _jax_value_and_grad(jp)
    frozen = {"vae": jp.vae_params, "child": jp.unet_child_params,
              "text": jp.text_embed_table}
    loss, grads = fn(jp.unet_params, frozen,
                     {k: jnp.asarray(v) for k, v in batches["grad"].items()})
    return float(loss), state_dict_from_flax(grads)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_size", [0, 65536])
@pytest.mark.parametrize("shape", [(3, 16), (5, 3), (320,), (1280, 5120),
                                   (3, 3, 1280, 1280)])
def test_zero1_axis_matches_jax(shape, min_size):
    """The port's shard axis is the one the JAX package's
    `_zero1_sharding_for` picks on an 8-device CPU mesh."""
    mesh = j_make_mesh(JMeshConfig(data=8, model=1), jax.devices()[:8])
    spec = _zero1_sharding_for(np.zeros(shape, np.float32), mesh,
                               min_size=min_size).spec
    want = next((i for i, s in enumerate(spec) if s == "data"), None)
    assert zero1_axis(shape, 8, min_size) == want


def test_shard_batch_rows_and_rejects_indivisible():
    """A rank's contiguous rows; scalars pass through; a leading dim the
    data axis does not divide raises, as `mesh.py:98-104` does."""
    mesh = Mesh(None, 2, 1)
    batch = {"x": np.arange(6).reshape(6, 1), "task_idx": np.int32(3)}
    out = shard_batch(batch, mesh)
    np.testing.assert_array_equal(out["x"], [[3], [4], [5]])
    assert out["task_idx"] == 3
    with pytest.raises(ValueError, match="not divisible by the mesh data"):
        shard_batch({"x": np.zeros((3, 2))}, mesh)


def test_tensor_parallel_not_ported(tmp_path):
    """`parallel.model > 1` raises, naming ROADMAP A13 (b): in make_mesh and
    in cli.train before anything is built."""
    from stablemtl_tpu_torch.cli import train as train_cli

    with pytest.raises(NotImplementedError, match=r"A13 \(b\)"):
        make_mesh(MeshConfig(model=2))
    cfg = tmp_path / "tp.yaml"
    cfg.write_text(f"base_config:\n- {REPO}/config/train_debug_tiny.yaml\n"
                   f"parallel:\n  model: 2\n")
    with pytest.raises(NotImplementedError, match=r"A13 \(b\)"):
        train_cli.main(["--config", str(cfg), "--output_dir",
                        str(tmp_path / "run"), "--device", "cpu"])
    assert not (tmp_path / "run").exists()


def test_two_ranks_match_jax(spawned, jax_reference, ranks):
    """Global batch 4 over 2 ranks, unequal valid masks, `highest` masking
    at ratio 1: the loss and the all-reduced gradients against the JAX
    package's value_and_grad of the global batch, at
    test_torch_port_train's bars (loss 1e-5, each leaf 1e-4 of its max);
    the ranks hold equal gradients. A step that averaged the ranks' own
    means, or whose banks read a local statistic, would be off by far more
    than the bar."""
    (r0, r1), _ = ranks
    j_loss, j_grads = jax_reference
    assert r0["loss"] == r1["loss"]
    assert r0["grads_digest"] == r1["grads_digest"]
    assert abs(r0["loss"] - j_loss) <= 1e-5, (r0["loss"], j_loss)
    assert set(r0["grads"]) == set(j_grads)
    for name, g in r0["grads"].items():
        want = j_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    # what each rank's rows alone give: their mean, and their count-weighted
    # sum (equal to the global loss only when the masks picked are the
    # global batch's)
    losses, counts = r0["rows_losses"], r0["rows_counts"]
    assert counts[0] != counts[1], counts
    mean_of_means = sum(losses) / len(losses)
    weighted = sum(x * c for x, c in zip(losses, counts)) / sum(counts)
    assert abs(mean_of_means - j_loss) > 1e-3 * j_loss, (losses, j_loss)
    assert abs(weighted - j_loss) > 1e-3 * j_loss, (losses, counts, j_loss)


def test_two_ranks_match_one_rank(ranks):
    """The 2-rank step against the port's one-process step on the same
    global batch: the loss within 1e-6 relative, the gradients within 1e-5
    relative L2 over every leaf (phase 9's bar on the card). The one
    process runs each convolution's weight gradient over 4 rows, the ranks
    over 2 each and then add: the sums round in another order (1.7e-6
    here)."""
    (r0, _), _ = ranks
    assert abs(r0["loss"] - r0["loss_1rank"]) <= 1e-6 * abs(
        r0["loss_1rank"])
    assert r0["grads_rel_l2_vs_1rank"] <= 1e-5, (
        r0["grads_rel_l2_vs_1rank"], r0["grads_max_abs_vs_1rank"])


def test_zero1_norm_and_finiteness_count_replicated_leaves_once(ranks):
    """On ZeRO-1 slices, the clip's global norm is the whole gradient's:
    within 1e-5 of its float64 value, as the one-process norm is (both sum
    f32 squares, in other orders), while counting the replicated leaves
    twice would move it by at least 5e-4. apply_if_finite sees a NaN that
    only the last rank's slice holds, on every rank."""
    (r0, r1), _ = ranks
    for r in (r0, r1):
        exact = r["norm_f64"]
        assert r["norm_whole"] == pytest.approx(exact, rel=1e-5)
        assert r["norm_sharded"] == pytest.approx(exact, rel=1e-5)
        assert r["replicated_sq"] > 1e-3 * exact ** 2
        assert r["finite_clean"] is True
        assert r["finite_planted"] is False


def test_zero1_matches_replicated(ranks):
    """Adam with clip 5.0 over 4 micro-steps, an update every 2: ZeRO-1
    (leaves of at least 64 elements sliced, smaller ones replicated) and
    replicated data parallelism give bit-equal losses, parameters and
    moments (each rank's slices against the same slices of the whole
    state); each sliced moment is half its leaf, along the rule's axis."""
    (r0, r1), _ = ranks
    with torch.device("meta"):
        pipe_shapes = [tuple(p.shape) for p in UNet2DConditionModel(
            tiny_unet_config(use_task_attention=True, **worker.NANO,
                             **worker.TRAINER)).parameters()]
    axes = r0["shard_axes"]
    assert axes == [zero1_axis(s, WORLD, worker.ZERO1_MIN)
                    for s in pipe_shapes]
    assert any(a is None for a in axes) and any(a is not None for a in axes)
    for r in (r0, r1):
        assert r["zero1_losses"] == r["replicated_losses"]
        assert r["zero1_params_diff"] == 0.0
        assert r["zero1_state_diff"] == 0.0
        for shape, local, a in zip(pipe_shapes, r["local_shapes"], axes):
            want = list(shape)
            if a is not None:
                want[a] //= WORLD
            assert list(local) == want
    assert r0["params_digest"] == r1["params_digest"]


def test_zero1_adafactor_matches_whole(ranks):
    """Adafactor under ZeRO-1 (each factored leaf's slice gathered at the
    update, its row and column statistics whole) leaves the parameters
    bit-equal to the whole optimizer's through an update and a half, and
    its checkpoint holds the whole optimizer's state."""
    (r0, r1), _ = ranks
    assert r0["adafactor_params_diff"] == 0.0
    assert r1["adafactor_params_diff"] == 0.0
    assert r0["adafactor_saved_diff"] == 0.0


def test_resume_across_world_sizes(ranks):
    """Saved at micro-step 3 (mid-accumulation) by 2 ranks: the ZeRO-1
    run's checkpoint (slices gathered to rank 0) holds the replicated
    run's state bit for bit; resumed by 2 ZeRO-1 ranks from the replicated
    one, micro-step 4 ends bit-equal to the straight run; and one process
    restores the 2-rank checkpoint with parameters and moments bit-equal
    (rank 0 compared the files, then deleted them)."""
    (r0, _), _ = ranks
    assert r0["resumed_step"] == 3 and r0["resumed_params_diff"] == 0.0
    assert r0["ckpt_params_equal"] and r0["ckpt_state_equal"]
    assert r0["ckpt_counters"] == {"count": 1, "mini_step": 1}
    assert r0["one_process_step"] == 3
    assert r0["one_process_params_equal"] and r0["one_process_state_equal"]


def test_cli_train_two_processes(cli_runs):
    """`python -m stablemtl_tpu_torch.cli.train --device cpu` as two ranks
    through STABLEMTL_COORDINATOR / NUM_PROCESSES / PROCESS_ID: nano,
    effective batch 4 as 2 micro-steps of 1 row a rank, rank 0 deciding
    `--exit_after` every micro-step (far off), a validation at effective
    iteration 1. Rank 0 alone writes the run files and the checkpoint
    slots; the ranks end on equal parameters (the CLI checks, and both log
    the same digest). Held against the same CLI as one process on the same
    global micro-batch (2 micro-steps of 2 rows): both record that
    schedule; Adam's moments after the update (the accumulated, clipped
    gradient of the loader's rows and its square) agree within 1e-5
    relative L2, the 2-rank step's bar against one process (the ranks'
    convolutions sum their rows' weight gradients in another order); the
    first update has lr 0 (warmup), so the parameters and the validation
    rank 0 ran for both ranks are bit-equal."""
    run, run1 = cli_runs
    files = sorted(os.listdir(run))
    assert {"config_resolved.json", "code_snapshot.tar.gz", "tensorboard",
            "checkpoint", "logging.log", "logging.log.rank1"} <= set(files)
    assert len(os.listdir(run / "tensorboard")) >= 1
    digests = []
    for name in ("logging.log", "logging.log.rank1"):
        text = (run / name).read_text()
        assert "data parallel over 2 ranks, zero1=True" in text, text
        assert "main val metric improved none ->" in text, text
        line = next(x for x in text.splitlines()
                    if "parameters equal on all 2 ranks" in x)
        digests.append(line.rsplit(" ", 1)[-1])
    assert digests[0] == digests[1]
    assert "val vkitti_depth_val" in (run / "logging.log").read_text()
    assert "val vkitti_depth_val" not in (run / "logging.log.rank1"
                                          ).read_text()
    assert sorted(os.listdir(run / "checkpoint")) == [
        "best", "best.meta.json", "latest", "latest.meta.json"]
    metas = []
    for r in (run, run1):
        with open(r / "checkpoint" / "latest" / "state.json") as f:
            assert json.load(f) == {"step": 2, "micro_batch": 2,
                                    "accumulation_steps": 2}
        with open(r / "checkpoint" / "latest.meta.json") as f:
            metas.append(json.load(f))
    assert metas[0]["finished"] is True
    assert metas[0]["best_metric"] == metas[1]["best_metric"]
    params, opts = zip(*[[torch.load(r / "checkpoint" / "latest" / f,
                                     weights_only=True)
                          for f in ("params.pt", "opt_state.pt")]
                         for r in (run, run1)])
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[1])
    assert opts[0]["count"] == opts[1]["count"] == 1
    for key in ("mu", "nu"):
        a, b = opts[0][key], opts[1][key]
        assert set(a) == set(b) == set(params[1])
        diff = sum(float((a[k].double() - b[k].double()).square().sum())
                   for k in b)
        norm = sum(float(b[k].double().square().sum()) for k in b)
        assert norm > 0 and (diff / norm) ** 0.5 <= 1e-5, (key, diff, norm)


def test_cli_resume_on_another_schedule_raises(cli_runs, tmp_path):
    """The 2-rank run's checkpoint (global micro-batch 2, accumulation 2)
    resumed by one process capped at 1 row a micro-step (so accumulating
    4): its step 2 would be half an update there while the optimizer has
    made one, so the restore raises before touching the state."""
    from stablemtl_tpu_torch.cli import train as train_cli

    run, _ = cli_runs
    out = tmp_path / "resume"
    out.mkdir()
    (out / "checkpoint").symlink_to(run / "checkpoint")
    with pytest.raises(ValueError, match="another schedule") as err:
        train_cli.main(["--config", str(run.parent / "nano_mb1.yaml"),
                        "--base_data_dir", str(run.parent), "--device",
                        "cpu", "--output_dir", str(out)])
    assert "'micro_batch': (2, 1)" in str(err.value)
    assert "'accumulation_steps': (2, 4)" in str(err.value)


def test_cli_train_refuses_one_process_on_several_cards(monkeypatch,
                                                        tmp_path):
    """One process with 8 visible cards and no process group raises
    (naming torchrun and CUDA_VISIBLE_DEVICES) before it builds anything,
    instead of training on one card of the eight."""
    from stablemtl_tpu_torch.cli import train as train_cli

    for name in ("STABLEMTL_COORDINATOR", "STABLEMTL_NUM_PROCESSES",
                 "STABLEMTL_PROCESS_ID", "STABLEMTL_DIST", "RANK",
                 "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError, match="8 CUDA devices.*torchrun.*"
                       "CUDA_VISIBLE_DEVICES"):
        train_cli.main(["--config", f"{REPO}/config/train_debug_tiny.yaml",
                        "--output_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_sharded_step_checks_the_state_layout():
    """make_sharded_train_step(zero1, zero1_min_size) refuses a state laid
    out otherwise (the update follows the state's layout, so a mismatch
    would pass unseen)."""
    mesh = Mesh(None, 2, 0)
    pipe = SimpleNamespace(device=torch.device("cpu"))
    params = [torch.nn.Parameter(torch.zeros(4, 8)),
              torch.nn.Parameter(torch.zeros(3))]
    cfg = OptimizerConfig(lr=1e-3, use_schedule=False)
    sliced = TrainState(step=0, params=dict(zip("ab", params)),
                        opt=ShardedOptimizer(params, cfg, mesh, 16))
    assert sliced.opt.shard_axes == [1, None]
    whole = TrainState(step=0, params=dict(zip("ab", params)),
                       opt=Optimizer(params, cfg))
    for state, kw in ((sliced, dict(zero1=True, zero1_min_size=0)),
                      (sliced, dict(zero1=False)),
                      (whole, dict(zero1=True, zero1_min_size=16))):
        step = make_sharded_train_step(pipe, mesh, **kw)
        with pytest.raises(ValueError, match="not laid out for this step"):
            step(state, {})


def test_noise_latent_draws_the_global_batch():
    """Under data_parallel, input_noise 'random' draws the global shape and
    keeps this rank's rows along the batch axis it is given."""
    from stablemtl_tpu_torch.pipeline import StableMTLPipeline

    pipe = StableMTLPipeline(vae=None, unet=torch.nn.Module(),
                             text_embed_table=torch.zeros(T, 1, 1),
                             input_noise="random")
    for batch_dim, local in ((0, (2, 3, 4)), (1, (3, 2, 4))):
        shape = list(local)
        shape[batch_dim] *= 2
        want = torch.randn(shape, generator=torch.Generator().manual_seed(1))
        for rank in range(2):
            with pipe.data_parallel(Mesh(None, 2, rank)):
                got = pipe.noise_latent(torch.zeros(local),
                                        torch.Generator().manual_seed(1),
                                        batch_dim=batch_dim)
            assert torch.equal(got, want.narrow(batch_dim, 2 * rank, 2))
    assert pipe.data_group is None
