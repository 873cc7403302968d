"""PyTorch port, data and tensor parallelism
(`stablemtl_tpu_torch/parallel/`): the ZeRO-1 shard-axis rule and the
tensor-parallel policy against the JAX package's own; two gloo ranks on
the CPU (processes of tests/torch_port_parallel_worker.py, which imports no
jax) held against JAX on the global batch, against the port's one-process
step, ZeRO-1 against replicated data parallelism, resume across world
sizes, and `cli.train` over two processes through the env contract; four
gloo ranks as a 2 x 2 (data x model) mesh held against JAX, their
optimizer layout, norm, checkpoints, rows and a bf16 first moment's
ZeRO-1 slices gathered over gloo, and, with heads the model axis does not
divide, against one process and JAX; `cli.train` with `parallel: {model:
2}` over two processes.

The nano preset in f32, built from one Flax tree carried over by
`state_dict_from_flax`, 16x16 inputs. The ranks start once, at the first
test that needs them, and run while this process compiles the JAX
reference; the tests read what they wrote.
"""

import dataclasses
import json
import math
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
from stablemtl_tpu.parallel.tensor_parallel import tp_spec
from stablemtl_tpu.pipeline import StableMTLPipeline as JPipeline
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.models.convert import (flax_leaf_to_port,
                                                state_dict_from_flax)
from stablemtl_tpu_torch.models.unet import (UNet2DConditionModel,
                                             tiny_unet_config)
from stablemtl_tpu_torch.parallel import (MeshConfig, make_mesh, shard_batch,
                                          tp_axis)
from stablemtl_tpu_torch.parallel.mesh import Mesh
from stablemtl_tpu_torch.parallel.sharded_train import (
    ShardedOptimizer, make_sharded_train_step, zero1_axis)
from stablemtl_tpu_torch.train_state import (Optimizer, OptimizerConfig,
                                             TrainState, flax_axes)
from test_torch_port_train import _jax_value_and_grad
from torch_port_helpers import random_params, write_vkitti_tree
from torch_port_helpers import one_torch_thread  # noqa: F401

import torch_port_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = len(TASKS)
HW = worker.HW
WORLD = 2
# the tensor-parallel ranks: a 2 x 2 (data x model) mesh
TP_WORLD = 4
# the full preset's main UNet under the policy at model 2 (chip_smoke
# phase 11a prints the same count): split leaves and their parameters
FULL_TP_LEAVES = 416
FULL_TP_PARAMS = 650_746_880
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


def _spawn(argv, rank: int, port: int, log_path, world=WORLD, **env):
    full = dict(os.environ, PYTHONPATH=REPO, **MALLOC_ENV,
                STABLEMTL_COORDINATOR=f"127.0.0.1:{port}",
                STABLEMTL_NUM_PROCESSES=str(world),
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
parallel:
  model: {model}
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
    """Starts the two worker ranks on the pipeline and batches, the four
    tensor-parallel worker ranks, two ranks of `python -m
    stablemtl_tpu_torch.cli.train` on a synthetic vkitti tree (1 row a
    rank), two more with `parallel: {model: 2}` (2 rows each, the same on
    both) and the same CLI as one process on the same global micro-batch
    (2 rows); returns (worker dir, cli run dirs (2 ranks, 1 process, 2
    tensor-parallel ranks), process handles: the data-parallel workers,
    the tensor-parallel workers, the CLI processes)."""
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
    port = _free_port()
    procs += [_spawn([sys.executable, script, str(d), "tp"], r, port,
                     d / f"tp_worker{r}.log", world=TP_WORLD)
              for r in range(TP_WORLD)]

    root = tmp_path_factory.mktemp("cli_ranks")
    write_vkitti_tree(str(root / "vkitti"))
    for max_bs in (1, 2):
        (root / f"nano_mb{max_bs}.yaml").write_text(
            CLI_CONFIG.format(repo=REPO, root=root, max_bs=max_bs, model=1))
    (root / "nano_tp.yaml").write_text(
        CLI_CONFIG.format(repo=REPO, root=root, max_bs=2, model=2))
    runs = root / "run", root / "run1", root / "run_tp"

    def argv(config, run):
        return [sys.executable, "-m", "stablemtl_tpu_torch.cli.train",
                "--config", str(root / config),
                "--base_data_dir", str(root), "--device", "cpu",
                "--exit_after", "100000", "--output_dir", str(run)]

    port = _free_port()
    procs += [_spawn(argv("nano_mb1.yaml", runs[0]), r, port,
                     root / f"cli{r}.log") for r in range(WORLD)]
    port = _free_port()
    procs += [_spawn(argv("nano_tp.yaml", runs[2]), r, port,
                     root / f"cli_tp{r}.log") for r in range(WORLD)]
    log = open(root / "cli1.log", "w")
    procs.append((subprocess.Popen(
        argv("nano_mb2.yaml", runs[1]), cwd=REPO, stdout=log,
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
def tp_ranks(spawned):
    """The four tensor-parallel ranks' results, by process rank."""
    d, _, procs = spawned
    _wait(procs[WORLD:WORLD + TP_WORLD])
    return [torch.load(d / f"tp_rank{r}.pt", weights_only=False)
            for r in range(TP_WORLD)]


@pytest.fixture(scope="module")
def cli_runs(spawned):
    _, runs, procs = spawned
    _wait(procs[WORLD + TP_WORLD:])
    return runs


@pytest.fixture(scope="module")
def jax_references(flax_pipeline, batches):
    """The JAX package's loss and gradients (by port name) of the global
    batch, by the main UNet's attention_heads: the nano preset's (2, 2),
    and (1, 2) on the same Flax tree (the heads change no parameter's
    shape). Both compile while the ranks run: the first test that waits
    for them asks for these first."""
    refs = {}
    for heads in ((2, 2), (1, 2)):
        jp = dataclasses.replace(flax_pipeline, unet=JUNet(j_tiny_unet(
            use_task_attention=True, **dict(worker.NANO,
                                            attention_heads=heads),
            **worker.TRAINER)))
        fn = _jax_value_and_grad(jp)
        frozen = {"vae": jp.vae_params, "child": jp.unet_child_params,
                  "text": jp.text_embed_table}
        loss, grads = fn(jp.unet_params, frozen, {
            k: jnp.asarray(v) for k, v in batches["grad"].items()})
        refs[heads] = float(loss), state_dict_from_flax(grads)
    return refs


@pytest.fixture(scope="module")
def jax_reference(jax_references):
    """The JAX package's loss and gradients of the global batch."""
    return jax_references[(2, 2)]


@pytest.fixture(scope="module")
def jax_heads_reference(jax_references):
    """As `jax_reference`, with attention_heads (1, 2)."""
    return jax_references[(1, 2)]


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


def test_tensor_parallel_not_ported(tmp_path, monkeypatch):
    """What of tensor parallelism is still refused: `parallel.model` 2 in
    one process (make_mesh names the process count), a world size the
    mesh does not cover (3 processes at model 2, before any group is
    made), and `cli.train` of `parallel: {model: 2}` in one process,
    before anything is built."""
    import torch.distributed as dist

    from stablemtl_tpu_torch.cli import train as train_cli

    with pytest.raises(ValueError, match="does not cover 1 process: "
                       "parallel.model 2 needs a multiple of 2"):
        make_mesh(MeshConfig(model=2))
    cfg = tmp_path / "tp.yaml"
    cfg.write_text(f"base_config:\n- {REPO}/config/train_debug_tiny.yaml\n"
                   f"parallel:\n  model: 2\n")
    with pytest.raises(ValueError, match="does not cover 1 process"):
        train_cli.main(["--config", str(cfg), "--output_dir",
                        str(tmp_path / "run"), "--device", "cpu"])
    assert not (tmp_path / "run").exists()
    made = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 3)
    monkeypatch.setattr(dist, "new_group", lambda *a, **k: made.append(a))
    with pytest.raises(ValueError, match="mesh 1x2 does not cover 3 "
                       "processes"):
        make_mesh(MeshConfig(model=2))
    assert made == []


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
    run, run1, _ = cli_runs
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
                                    "accumulation_steps": 2, "model": 1}
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

    run = cli_runs[0]
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


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _flax_shapes(preset: str):
    """{Flax path: shape} of the JAX package's multi-stream main UNet at
    `preset`, from `jax.eval_shape` of its init (nothing compiled)."""
    from stablemtl_tpu.factory import model_configs as j_model_configs
    from stablemtl_tpu.models.unet import task_feat_shapes

    cfg = j_model_configs(preset, True, {})[0]
    unet = JUNet(cfg)
    lat = jnp.zeros((1, 8, 8, cfg.in_channels))
    ctx = jnp.zeros((1, 4, cfg.cross_attention_dim))
    feats = [jnp.zeros((T - 1, 1) + tuple(s))
             for s in task_feat_shapes(cfg, 8, 8)]
    tree = jax.eval_shape(lambda k: unet.init(
        k, lat, jnp.zeros((1,), jnp.int32), ctx, task_feats=feats,
        main_idx=jnp.asarray(0), aux_idx=jnp.arange(1, T)),
        jax.random.PRNGKey(0))["params"]
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("preset", ["tiny", "full"])
def test_tp_policy_matches_jax(preset):
    """For every main-UNet parameter, the port's split axis (`tp_axis` on
    the port's name and shape) is the axis JAX's `tp_spec` gives the Flax
    path and shape on a (4 x 2) mesh of the 8 CPU devices, carried through
    the convert map's name and axis order. The tiny preset's port UNet is
    built for real, the full preset's on `meta`."""
    from stablemtl_tpu_torch.factory import model_configs

    mesh = j_make_mesh(JMeshConfig(model=2), jax.devices()[:8])
    cfg = model_configs(preset, True)[0]
    if preset == "full":
        with torch.device("meta"):
            unet = UNet2DConditionModel(cfg)
    else:
        unet = UNet2DConditionModel(cfg)
    port = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    flax = _flax_shapes(preset)
    assert len(flax) == len(port)
    split, n_params = 0, 0
    for path, shape in flax.items():
        name, _ = flax_leaf_to_port(path, np.zeros((0,) * len(shape),
                                                   np.float32))
        want_spec = tp_spec(path, shape, mesh)
        want = next((flax_axes(name, len(shape))[i]
                     for i, a in enumerate(want_spec) if a == "model"), None)
        got = tp_axis(name, port[name], 2)
        assert got == want, (name, port[name], want_spec)
        if got is not None:
            split += 1
            n_params += math.prod(shape)
    if preset == "full":
        assert (split, n_params) == (FULL_TP_LEAVES, FULL_TP_PARAMS)
    else:
        assert split >= 32, split


# the cases of the JAX package's test_tp_spec_policy_unit
# (tests/test_sharded_train.py), on the port's names and layouts: (port
# name, port shape, model size, axis)
TP_POLICY_CASES = [
    # column-parallel: attention inputs split the OUTPUT features
    ("attn1.to_q.weight", (32, 32), 2, 0),
    ("ff.net_0.proj.weight", (256, 32), 2, 0),
    # row-parallel: output projections split the INPUT features
    ("attn1.to_out_0.weight", (32, 32), 2, 1),
    # a column-parallel bias splits; a row-parallel one must not
    ("attn2.to_k.bias", (32,), 2, 0),
    ("attn1.to_out_0.bias", (32,), 2, None),
    # a feature count the model size does not divide stays whole
    ("attn1.to_q.weight", (33, 32), 2, None),
    # unknown modules (convs, norms) stay whole
    ("conv1.weight", (32, 32, 3, 3), 2, None),
    ("norm1.weight", (32,), 2, None),
    # cross-task banks [T, din, dout]: fc1 column, fc2 row
    ("task_attn.task_to_k_fc1_kernel", (7, 32, 16), 2, 2),
    ("task_attn.task_to_v_fc2_kernel", (7, 16, 32), 2, 1),
    # a model axis of 1: everything whole
    ("attn1.to_q.weight", (32, 32), 1, None),
]


@pytest.mark.parametrize("name,shape,model,axis", TP_POLICY_CASES)
def test_tp_axis_policy_cases(name, shape, model, axis):
    """The JAX policy test's cases on the port's `tp_axis`, each also held
    against JAX's `tp_spec` of the Flax path and shape."""
    assert tp_axis(name, shape, model) == axis
    mesh = j_make_mesh(JMeshConfig(model=model), jax.devices()[:8])
    order = flax_axes(name, len(shape))
    path = tuple(name.split(".")[:-1]) + (
        {"weight": "kernel" if len(shape) > 1 else "scale"}.get(
            name.split(".")[-1], name.split(".")[-1]),)
    spec = tp_spec(path, tuple(shape[a] for a in order), mesh)
    want = next((order[i] for i, a in enumerate(spec) if a == "model"),
                None)
    assert want == axis


def test_tp_ranks_match_jax(tp_ranks, jax_reference):
    """Four gloo ranks as a 2 x 2 (data x model) mesh, ZeRO-1 over the data
    axis, the global batch of 4 (2 rows a data rank, equal on model peers):
    the loss and the gradients (each split leaf gathered whole over the
    model group) against the JAX package's value_and_grad of the global
    batch, at test_two_ranks_match_jax's bars (loss 1e-5, each leaf 1e-4
    of its max). Every rank has the same loss; some 150 leaves are split;
    the model axis moved bytes."""
    j_loss, j_grads = jax_reference
    r0 = tp_ranks[0]
    assert [r["loss"] for r in tp_ranks] == [r0["loss"]] * TP_WORLD
    assert sum(r0["split"]) >= 32
    assert all(r["model_bytes"] > 0 for r in tp_ranks)
    assert abs(r0["loss"] - j_loss) <= 1e-5, (r0["loss"], j_loss)
    assert set(r0["grads"]) == set(j_grads)
    for name, g in r0["grads"].items():
        want = j_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_tp_layout_norm_and_rows(tp_ranks):
    """The mesh puts process r at data r // 2, model r % 2. Model peers
    read the same rows (the loader's shard is the data rank's). A split
    parameter's Adam moments and accumulated gradient mirror its shard;
    every other leaf of at least 64 elements takes its ZeRO-1 slice over
    the data axis. The clip's norm on that layout is the whole gradient's
    within 1e-5 of float64. The loss falls over 4 micro-steps (an update
    every 2)."""
    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in UNet2DConditionModel(
            tiny_unet_config(use_task_attention=True, **worker.NANO,
                             **worker.TRAINER)).parameters()]
    for p, r in enumerate(tp_ranks):
        assert (r["data"], r["model"]) == (2, 2)
        assert (r["rank"], r["model_rank"]) == (p // 2, p % 2)
        assert r["loader_shard"] == (p // 2, 2)
        assert r["norm_tp"] == pytest.approx(r["norm_f64"], rel=1e-5)
        assert r["losses"][3] < r["losses"][0], r["losses"]
        for shape, local, (mu, acc), split, a in zip(
                shapes, r["param_shapes"], r["state_shapes"], r["split"],
                r["shard_axes"]):
            if split:
                assert a is None and mu == acc == local != shape
            else:
                assert local == shape
                assert a == zero1_axis(shape, 2, worker.ZERO1_MIN)
                want = list(shape)
                if a is not None:
                    want[a] //= 2
                assert list(mu) == list(acc) == want
    assert tp_ranks[0]["rows_digest"] == tp_ranks[1]["rows_digest"]
    assert tp_ranks[2]["rows_digest"] == tp_ranks[3]["rows_digest"]
    assert tp_ranks[0]["rows_digest"] != tp_ranks[2]["rows_digest"]
    assert tp_ranks[0]["losses"] == tp_ranks[3]["losses"]


def test_tp_adafactor_matches_whole(tp_ranks):
    """Adafactor on the 2 x 2 layout (a split factored leaf's gradient
    gathered whole over the model group for its row and column statistics,
    which stay whole) leaves every rank's parameters, gathered whole,
    bit-equal to the whole optimizer's through an update and a half."""
    assert [r["adafactor_params_diff"] for r in tp_ranks] == [0.0] * 4


def test_tp_checkpoint_roundtrip(tp_ranks):
    """Saved by the 2 x 2 mesh after micro-step 4 (shards and ZeRO-1 slices
    gathered into whole leaves, `model` 2 recorded): one process restores
    it with parameters and moments bit-equal to the files and saves it
    again; the four ranks restore that one-process checkpoint into fresh
    tensor-parallel states, bit-equal to the states they saved, counters
    included."""
    r0 = tp_ranks[0]
    assert r0["one_process_step"] == 4 and r0["saved_model"] == 2
    assert r0["one_process_params_equal"] and r0["one_process_state_equal"]
    for r in tp_ranks:
        assert r["roundtrip_step"] == 4
        assert r["roundtrip_counters"] == (2, 0)
        assert r["roundtrip_params_diff"] == 0.0
        assert r["roundtrip_state_diff"] == 0.0


def test_tp_gathered_heads_match_one_process(tp_ranks):
    """The nano preset rebuilt with attention_heads (1, 2): stage 0's one
    head does not split over 2 model ranks, so q, k and v are gathered and
    every rank runs it. Against the port's one-process step on the global
    batch: the loss within 1e-5 relative and each gradient leaf within
    1e-4 of its max (measured 4.1e-7 and 1.0e-5)."""
    r0 = tp_ranks[0]
    assert abs(r0["gathered_loss"] - r0["gathered_loss_1proc"]) <= 1e-5 * (
        abs(r0["gathered_loss_1proc"])), (r0["gathered_loss"],
                                          r0["gathered_loss_1proc"])
    assert r0["gathered_grad_rel"] <= 1e-4, r0["gathered_grad_rel"]


def test_tp_gathered_heads_match_jax(tp_ranks, jax_heads_reference):
    """The gathered-heads path of the 2 x 2 mesh (attention_heads (1, 2))
    against the JAX package's value_and_grad of the global batch on the
    same Flax tree, at test_tp_ranks_match_jax's bars (loss 1e-5, each
    leaf 1e-4 of its max)."""
    j_loss, j_grads = jax_heads_reference
    r0 = tp_ranks[0]
    assert abs(r0["gathered_loss"] - j_loss) <= 1e-5, (r0["gathered_loss"],
                                                       j_loss)
    assert set(r0["gathered_grads"]) == set(j_grads)
    for name, g in r0["gathered_grads"].items():
        want = j_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_tp_zero1_bf16_moments_match_whole(tp_ranks):
    """Adam with mu_dtype bfloat16 on the 2 x 2 layout: the bf16 first
    moment's ZeRO-1 slices, gathered over gloo as a checkpoint save
    gathers them (2-byte floats travel as bytes: gloo takes neither
    bfloat16 nor int16), and the parameters are bit-equal to the whole
    optimizer's through an update and a half."""
    for r in tp_ranks:
        assert r["bf16_mu_sliced"] > 0
        assert r["bf16_mu_dtypes"] == ["torch.bfloat16"]
        assert r["bf16_mu_diff"] == 0.0
        assert r["bf16_params_diff"] == 0.0


def test_cli_train_tensor_parallel(cli_runs):
    """`cli.train` with `parallel: {model: 2}` as two processes through the
    env contract: a 1 x 2 mesh, both ranks reading the same 2 rows a
    micro-step. It logs the mesh, both ranks end on parameters equal
    across the data axis, process 0 alone writes the run files and the
    checkpoint slots, and the validation ran on the model group. Against
    the one-process run on the same schedule: the saved parameters (whole)
    bit-equal (the first update has lr 0), Adam's moments within 1e-5
    relative L2, the validation metric within 1e-4 relative."""
    _, run1, run = cli_runs
    files = set(os.listdir(run))
    assert {"config_resolved.json", "checkpoint", "logging.log",
            "logging.log.rank1"} <= files
    for name in ("logging.log", "logging.log.rank1"):
        text = (run / name).read_text()
        assert "mesh 1x2 (data x model) tp=True zero1=True" in text, text
        assert "parameters equal on all 2 ranks" in text, text
    assert "val vkitti_depth_val" in (run / "logging.log.rank1").read_text()
    with open(run / "checkpoint" / "latest" / "state.json") as f:
        assert json.load(f) == {"step": 2, "micro_batch": 2,
                                "accumulation_steps": 2, "model": 2}
    metas = []
    for r in (run, run1):
        with open(r / "checkpoint" / "latest.meta.json") as f:
            metas.append(json.load(f))
    assert metas[0]["best_metric"] == pytest.approx(metas[1]["best_metric"],
                                                    rel=1e-4)
    params, opts = zip(*[[torch.load(r / "checkpoint" / "latest" / f,
                                     weights_only=True)
                          for f in ("params.pt", "opt_state.pt")]
                         for r in (run, run1)])
    assert set(params[0]) == set(params[1])
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[1])
    for key in ("mu", "nu"):
        a, b = opts[0][key], opts[1][key]
        diff = sum(float((a[k].double() - b[k].double()).square().sum())
                   for k in b)
        norm = sum(float(b[k].double().square().sum()) for k in b)
        assert norm > 0 and (diff / norm) ** 0.5 <= 1e-5, (key, diff, norm)
