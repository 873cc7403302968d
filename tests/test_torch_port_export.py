"""PyTorch port, the serving artifact: the six kernels as `torch.library`
custom ops (`torch.library.opcheck`), a trace of flash attention that keeps
its op, and `export_pipeline` / `load_exported` against the JAX package's
own exported artifact and the port's eager `infer_all_tasks`, in f32 on the
CPU. The pipelines are the tiny configs at the nano preset's depth (two
UNet blocks): a `torch.export` trace and load cost time by graph node."""

import threading

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import jax.numpy as jnp
from stablemtl_tpu.ops.flash_attention import _flash, _flash_stream
from stablemtl_tpu.pipeline import _params_bundle as jax_params_bundle
from stablemtl_tpu.serving import export_pipeline as jax_export_pipeline
from stablemtl_tpu.serving import load_exported as jax_load_exported
from stablemtl_tpu_torch import TASKS
from stablemtl_tpu_torch.ops import flash_attention as port_flash
from stablemtl_tpu_torch.ops import geglu as port_geglu
from stablemtl_tpu_torch.parallel import host_local_mesh
from stablemtl_tpu_torch.serving import (export_pipeline, load_exported,
                                         params_bundle,
                                         program_tensors_and_devices,
                                         replicated_bundles)
from stablemtl_tpu_torch.utils import profiling
from torch_port_helpers import assert_close, tiny_pipelines
from torch_port_helpers import one_torch_thread  # noqa: F401

HW = (16, 16)
# the nano preset's UNet widths (factory.model_configs("nano"))
NANO = dict(block_out_channels=(32, 64), attention_heads=(2, 2))


@pytest.fixture(scope="module")
def pipes():
    """(jax pipeline, port pipeline) on one set of random weights, the
    port's frozen as `build_pipeline` freezes an inference pipeline: a
    weight that requires grad takes another CPU matmul path in eager
    (torch's matmul folds its operands by requires_grad), a few 1e-6 from
    the artifact's, whose weights are plain inputs."""
    jpipe, tpipe = tiny_pipelines(HW, **NANO)
    for module in (tpipe.vae, tpipe.unet, tpipe.unet_child):
        module.requires_grad_(False)
    return jpipe, tpipe


def _op_args(name):
    r = np.random.RandomState(len(name))
    if name == "geglu":
        x, w, b = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                   for s in ((3, 5, 32), (256, 32), (256,)))
        return port_geglu.OP, (x, w, b, False)
    q, k, v, do = (torch.from_numpy(r.standard_normal((2, 40, 16))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = port_flash.flash_forward_lse_reference(q, k, v, False)
    delta = port_flash.row_delta(do, o)
    op = port_flash.OPS[name]
    if name.startswith("flash_bwd"):
        return op, (q, k, v, do, lse, delta)
    return op, (q, k, v, name == "flash_fwd_lse")


@pytest.mark.parametrize("name", ["flash_fwd_a", "flash_fwd_lse",
                                  "flash_fwd_b", "flash_bwd_dq",
                                  "flash_bwd_dkv", "geglu"])
def test_custom_op_opcheck(name):
    """Each op's schema, its shape-only implementation against its CPU one
    (shapes, dtypes, strides), and its use under a dynamic-shape trace."""
    op, args = _op_args(name)
    assert op._schema.name == f"stablemtl::{name}"
    torch.library.opcheck(op, args)


class _Attention(torch.nn.Module):
    def forward(self, q, k, v):
        return port_flash.flash_attention(q, k, v)


@pytest.mark.parametrize("shape,jax_fn,op", [
    ((1, 256, 2, 64), _flash, "flash_fwd_a"),
    ((1, 256, 1, 512), _flash_stream, "flash_fwd_b"),
], ids=["resident", "stream_d512"])
def test_flash_attention_trace_keeps_op(shape, jax_fn, op):
    """A trace of flash_attention on CPU tensors records the forward op as
    one node (not its plain math), and the traced program matches the JAX
    kernel in interpret mode at the per-block bar 2e-5."""
    r = np.random.RandomState(shape[-1])
    q, k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(3))
    program = torch.export.export(
        _Attention(), tuple(map(torch.from_numpy, (q, k, v))), strict=False)
    targets = {str(n.target) for n in program.graph.nodes}
    assert f"stablemtl.{op}.default" in targets, targets
    assert "aten.softmax.int" not in targets and "aten.exp2.default" \
        not in targets
    got = program.module()(*map(torch.from_numpy, (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*map(jnp.asarray, (q, k, v)))
    assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pair", [False, True], ids=["single_b2", "pair_b1"])
def test_artifact_matches_jax_artifact_and_eager(pipes, tmp_path, pair):
    """The port's artifact, loaded from its bytes and called on the port's
    bundle, against the JAX package's artifact called on its own bundle
    (1e-4, the composed-model bar) and against the port's eager
    infer_all_tasks (1e-6); single frame at batch 2, the pair at batch 1.
    `path` receives the returned bytes; the artifact holds no weight and
    stays under 2 MB, as the JAX package's own test holds its artifact."""
    jpipe, tpipe = pipes
    batch = 1 if pair else 2
    r = np.random.RandomState(31 + pair)
    images = [r.uniform(-1, 1, (batch, *HW, 3)).astype(np.float32)
              for _ in range(1 + pair)]
    path = tmp_path / "all_tasks.pt2"
    blob = export_pipeline(tpipe, batch=batch, res_hw=HW, pair=pair,
                           path=str(path))
    assert path.read_bytes() == blob
    assert len(blob) < 2_000_000
    exported = load_exported(str(path) if pair else blob)
    assert not exported.program.state_dict  # weights are inputs
    constants = sum(t.numel() for t in exported.program.constants.values())
    assert constants < 100, constants
    bundle = params_bundle(tpipe)
    got = exported.call(bundle, *map(torch.from_numpy, images))
    assert got.shape == (len(TASKS), batch, *HW, 3)

    jax_blob = jax_export_pipeline(jpipe, batch=batch, res_hw=HW, pair=pair)
    want = np.asarray(jax_load_exported(jax_blob).call(
        jax_params_bundle(jpipe), *map(jnp.asarray, images)))
    unclipped = (np.abs(want) < 0.99).mean()
    assert unclipped > 0.2, unclipped  # the clip must not hide the check
    assert_close(got, want, atol=1e-4, rtol=1e-4)
    eager = tpipe.infer_all_tasks(torch.from_numpy(images[0]),
                                  torch.from_numpy(images[1]) if pair
                                  else None)
    assert_close(got, eager, atol=1e-6, rtol=1e-6)


def test_export_on_mesh_roundtrip(pipes):
    """Counterpart of tests/test_serving.py::test_export_on_mesh_roundtrip:
    exported for 2 replicas at batch 2 (the program of one replica, 1
    row), loaded (`nr_devices` 2) and called on the global batch with one
    bundle per replica: bit-equal to the same program run at 1 row on one
    device, row by row, and within 1e-6 of eager; a second call runs on
    the replica threads of the first, which `close()` stops. Each replica's module
    holds every tensor on its replica's device; placed on another device
    (meta), every tensor and every device the graph names move there.
    Exported with the recorder on: its spans are inert under the trace
    (the recorder keeps none, the graph holds no profiler op)."""
    _, tpipe = pipes
    mesh = host_local_mesh(devices=["cpu", "cpu"])
    with profiling.recording() as rec:
        blob = export_pipeline(tpipe, batch=2, res_hw=HW, mesh=mesh)
    exported = load_exported(blob)
    assert rec.spans == []
    assert not [n for n in exported.program.graph.nodes
                if "profiler" in str(n.target)]
    assert exported.nr_devices == 2
    bundles = replicated_bundles(tpipe, mesh)
    assert bundles[0] is bundles[1]  # replicas on one device share it
    x = torch.from_numpy(np.random.RandomState(33).uniform(
        -1, 1, (2, *HW, 3)).astype(np.float32))
    others = set(threading.enumerate())

    def replica_threads():
        return [t for t in threading.enumerate() if t not in others
                and t.name.startswith("replica-cpu")]

    got = exported.call(bundles, x)
    assert got.shape == (len(TASKS), 2, *HW, 3)
    one = exported.module_on("cpu")
    with torch.inference_mode():
        want = torch.cat([one(bundles[0], x[i:i + 1]) for i in range(2)], 1)
    assert torch.equal(got, want)
    eager = torch.cat([tpipe.infer_all_tasks(x[i:i + 1], None)
                       for i in range(2)], 1)
    assert_close(got, eager, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="2 replicas"):
        exported.call(bundles[:1], x)

    threads = replica_threads()  # made by the first call, kept
    assert len(threads) == 2
    assert torch.equal(exported.call(bundles, x), got)
    assert replica_threads() == threads
    exported.close()
    assert not replica_threads()

    tensors, devices = program_tensors_and_devices(one)
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    assert all(d.type == "cpu" for d in devices)
    tensors, devices = program_tensors_and_devices(
        exported.module_on("meta"))
    assert tensors and all(t.device.type == "meta" for t in tensors)
    assert devices and all(d.type == "meta" for d in devices)


def test_export_rejects_mesh_and_foreign_platforms(pipes):
    _, tpipe = pipes
    mesh = host_local_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="divisible"):
        export_pipeline(tpipe, batch=1, res_hw=HW, mesh=mesh)
    with pytest.raises(ValueError, match="cuda"):
        export_pipeline(tpipe, batch=1, res_hw=HW, platforms=["cuda"])
    with pytest.raises(ValueError, match="tpu"):
        export_pipeline(tpipe, batch=1, res_hw=HW, platforms=["cpu", "tpu"])
