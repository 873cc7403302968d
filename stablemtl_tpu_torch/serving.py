"""Serving: the portable artifact of the fused all-task step, and a
micro-batching session around the step, counterpart of
`stablemtl_tpu/serving.py`.

`export_pipeline` traces the step `(bundle, rgb[, rgb_next]) -> [7, B, H,
W, 3]` at one batch and geometry with `torch.export` and serializes the
program (`torch.export.save`). The weights are inputs of the program, not
constants in it (`params_bundle`), so the artifact holds the graph alone,
as the JAX package's StableHLO artifact does; and the hand-written kernels
are the custom ops `stablemtl::flash_fwd_a`, `flash_fwd_b` and `geglu`
(`ops/cuda_build.define_op`), as the Pallas kernels are custom calls
there. `load_exported(path).call(bundle, rgb)` runs it in a process that
builds no model.

`ServingSession` runs a collector thread that groups up to `batch`
same-geometry requests (waiting at most `max_delay_s` after the first),
pads the tail by repeating the last image, runs ONE fused all-task step
(`pipeline.infer_all_tasks`) under `torch.inference_mode()` on the
pipeline's device, and resolves per-request futures with their own
unpadded [n_tasks, H, W, 3] float32 host arrays. The step keeps a fixed
batch, so every group costs the same device time, as with the JAX
package's compiled executable.

With `mesh=` (`parallel.host_local_mesh`), both serve over the devices of
one process, as the JAX package's `mesh=` forms do with the batch sharded
over the data axis and the weights replicated: the padded batch splits
into `mesh.data` contiguous row slices, each run by a replica on its
device, in a thread of its own under that device and on a stream of its
own, and the results are gathered in row order. Replicas on the
pipeline's own device share its weights; a replica on another device
holds one copy of the modules (`pipeline_on`). A `torch.export` program
runs on one device, so the artifact of a mesh is the per-replica step at
`batch / data` rows with `data` recorded beside it (`nr_devices`), and a
loaded artifact places the program on each replica's device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import queue
import threading
import time
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import List, Optional, Sequence

import numpy as np
import torch

from .factory import cast_params_for_inference  # noqa: F401 (its API)
from .pipeline import N_TASKS

# the bundle's key of each module of the pipeline, and its attribute
_MODULES = {"vae": "vae", "unet": "unet", "child": "unet_child"}
# the artifact's entry that records what the program was traced for
_META = "stablemtl_meta.json"


def params_bundle(pipe) -> dict:
    """The weights the exported step takes, counterpart of the JAX
    package's `_params_bundle`: {"vae", "unet", "text"[, "child"]}, each
    module's parameters and persistent buffers by name (its `state_dict`,
    in the dtypes the pipeline holds: the inference dtype), "text" the
    task-embedding table, "child" only for a multi-stream pipeline. The
    tensors share storage with the pipeline."""
    out = {"vae": pipe.vae.state_dict(), "unet": pipe.unet.state_dict(),
           "text": pipe.text_embed_table}
    if pipe.is_multi_stream:
        out["child"] = pipe.unet_child.state_dict()
    return out


def _module_on(module: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of `module` whose parameters and buffers are made directly on
    `device` in their own dtypes (never a second copy on the source
    device)."""
    memo = {}
    for t in module.parameters():
        memo[id(t)] = torch.nn.Parameter(t.detach().to(device),
                                         requires_grad=t.requires_grad)
    for t in module.buffers():
        memo[id(t)] = t.to(device)
    return copy.deepcopy(module, memo)


def pipeline_on(pipe, device):
    """`pipe` on `device`: `pipe` itself when it is there already (a
    replica shares its weights), else a pipeline holding one copy of its
    modules and task table there, cast as `pipe` is."""
    device = torch.device(device)
    if device == pipe.device:
        return pipe
    moved = {attr: _module_on(getattr(pipe, attr), device)
             for attr in _MODULES.values() if getattr(pipe, attr) is not None}
    return dataclasses.replace(
        pipe, text_embed_table=pipe.text_embed_table.to(device), **moved)


def replicated_bundles(source, mesh) -> List[dict]:
    """One weight bundle per replica of `mesh`, for a loaded mesh artifact:
    counterpart of `jax.device_put(bundle, replicated_sharding(mesh))`.
    `source` is a pipeline or a bundle (`params_bundle`); a replica on the
    bundle's own device gets the bundle itself, one on another device a
    copy there."""
    bundle = source if isinstance(source, dict) else params_bundle(source)
    home = bundle["text"].device

    def to(device):
        if device == home:
            return bundle
        return {k: ({n: t.to(device) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(device))
                for k, v in bundle.items()}

    copies = {}
    return [copies.setdefault(d, to(d)) for d in mesh.devices]


class _Replica:
    """The thread one replica's work runs in: under `device` and, on CUDA,
    on a stream of its own. `run(fn, *args)` returns a Future of fn's
    result, ready once the replica's stream has finished its work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._thread = ThreadPoolExecutor(
            1, thread_name_prefix=f"replica-{self.device}")

    def _call(self, fn, args):
        with contextlib.ExitStack() as ctx:
            if self.stream is not None:
                ctx.enter_context(torch.cuda.device(self.device))
                ctx.enter_context(torch.cuda.stream(self.stream))
            ctx.enter_context(torch.inference_mode())
            out = fn(*args)
            if self.stream is not None:
                self.stream.synchronize()
            return out

    def run(self, fn, *args) -> Future:
        return self._thread.submit(self._call, fn, args)

    def close(self):
        self._thread.shutdown(wait=True)


def _close_all(replicas) -> None:
    for replica in replicas:
        replica.close()


def _row_slices(batch: int, data: int) -> list:
    """The `data` contiguous row slices of a batch of `batch` rows; a batch
    that does not divide raises."""
    if batch % data:
        raise ValueError(f"batch {batch} not divisible by the mesh data "
                         f"axis ({data})")
    k = batch // data
    return [slice(i * k, (i + 1) * k) for i in range(data)]


def _on_replicas(replicas, fn, args) -> list:
    """fn(*args[i]) on every replica i at once; waits for all of them,
    then returns their results in replica order or raises the first
    replica's failure (the whole step fails, as a failed sharded step
    does)."""
    futures = [rep.run(fn, *a) for rep, a in zip(replicas, args)]
    wait(futures)
    return [f.result() for f in futures]


class _Modules(torch.nn.Module):
    """The pipeline's modules under their bundle keys; its forward is the
    all-task step on the task table `text`."""

    def __init__(self, pipe):
        super().__init__()
        for key, attr in _MODULES.items():
            if getattr(pipe, attr) is not None:
                setattr(self, key, getattr(pipe, attr))
        self.pipe = pipe

    def forward(self, text, rgb, rgb_next):
        step = dataclasses.replace(self.pipe, text_embed_table=text)
        return step.infer_tasks_body(rgb, rgb_next, range(N_TASKS))


class _Step(torch.nn.Module):
    """(bundle, rgb[, rgb_next]) -> [n_tasks, B, H, W, 3]. It holds no
    weight: `torch.func.functional_call` puts every tensor of the bundle
    in place of the modules' own for the call (strict: a weight missing
    from the bundle raises), so a trace takes them as inputs."""

    def __init__(self, pipe):
        super().__init__()
        # not registered as a submodule: the program keeps no parameter
        object.__setattr__(self, "modules_", _Modules(pipe))

    def forward(self, bundle, rgb, rgb_next=None):
        weights = {f"{key}.{name}": t for key in _MODULES if key in bundle
                   for name, t in bundle[key].items()}
        return torch.func.functional_call(
            self.modules_, weights, (bundle["text"], rgb, rgb_next),
            strict=True)


def _drop_noop_casts(graph_module):
    """Remove the casts of the traced graph that keep their input's dtype
    (`aten.to.dtype`; the models cast every weight to the activation dtype,
    which at the inference dtype is mostly the same) and the metadata
    asserts the trace emits beside each cast: at fixed shapes they check
    nothing the trace did not fix. They were half the graph's nodes."""
    graph = graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten.to.dtype and \
                node.args[0].meta["val"].dtype == node.meta["val"].dtype:
            node.replace_all_uses_with(node.args[0])
        elif node.target is not torch.ops.aten._assert_tensor_metadata.default:
            continue
        graph.erase_node(node)
    graph_module.recompile()


def _deflate(archive: bytes) -> bytes:
    """The zip archive `torch.export.save` wrote (entries stored), with
    every entry deflated: the graph's JSON shrinks ~30x, and
    `torch.export.load` reads it as it is."""
    out = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(archive)) as src, \
            zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as dst:
        for info in src.infolist():
            dst.writestr(info, src.read(info), zipfile.ZIP_DEFLATED)
    return out.getvalue()


def export_pipeline(pipe, batch: int, res_hw, pair: bool = False,
                    platforms: Optional[Sequence[str]] = None,
                    path: Optional[str] = None, mesh=None) -> bytes:
    """Export the fused all-task step as a serialized `torch.export`
    program; returns its bytes (written to `path` too, if given).

    The program takes (params_bundle(pipe), rgb[, rgb_next]) with rgb
    [batch, H, W, 3] float32 in [-1, 1] on the pipeline's device (single
    frame: rgb_next absent, one VAE encode) and returns [n_tasks, batch,
    H, W, 3]. The bundle's shapes and dtypes are fixed by `pipe`.

    What is read while tracing is fixed in the artifact, as under the JAX
    package's jit: the env flags STABLEMTL_FLASH_FAST_SOFTMAX (and the
    STABLEMTL_FAST_MATH tier), STABLEMTL_FLASH_POLY_EXP and
    STABLEMTL_FLASH_MXU_LSUM (arguments of the flash ops' nodes),
    STABLEMTL_NO_FUSED_QKV, STABLEMTL_FUSED_GEGLU, STABLEMTL_DISABLE_FLASH
    and STABLEMTL_DISABLE_PREFIX_SHARE, and the check of TPU-only flags
    (`reject_tpu_only_flags`). Exporting launches no kernel: the ops trace
    by their shape-only implementations.

    platforms: None or the pipeline's own device type ("cuda", "cpu"); a
    traced program holds device-placed constants, so another raises. mesh
    (`parallel.host_local_mesh`): the program is the step of one replica,
    at `batch / mesh.data` rows (a batch that does not divide raises), and
    the artifact records `mesh.data`: `load_exported` gives an
    `ExportedStep` whose `nr_devices` it is and whose `call` takes the
    global batch and one bundle per replica (`replicated_bundles`).
    """
    nr_devices = 1
    if mesh is not None:
        nr_devices = mesh.data
        batch = _row_slices(batch, nr_devices)[0].stop
    device = pipe.device
    if platforms is not None and set(platforms) != {device.type}:
        raise ValueError(f"export_pipeline: the pipeline is on {device}; "
                         f"a program for {list(platforms)} cannot be traced "
                         f"from it")
    H, W = res_hw
    rgb = torch.zeros((batch, H, W, 3), device=device)
    # the pair's second frame another tensor: the same one would take the
    # single-frame fast path (`encode_rgb_pair`)
    args = (params_bundle(pipe), rgb) + ((rgb.clone(),) if pair else ())
    with torch.no_grad():
        program = torch.export.export(_Step(pipe), args, strict=False)
    program.example_inputs = None  # the bundle: weights stay out of it
    _drop_noop_casts(program.graph_module)
    buf = io.BytesIO()
    meta = {"nr_devices": nr_devices, "device": str(device)}
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    blob = _deflate(buf.getvalue())
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _placed(module, device):
    """A copy of a loaded program's module (a GraphModule) for `device`:
    its parameters, buffers and tensor constants moved there, and every
    device an op of its graph names (`torch.full(..., device=)` and the
    like) rewritten to it."""
    device = torch.device(device)
    placed = copy.deepcopy(module).to(device)
    for sub in placed.modules():
        for name, value in list(vars(sub).items()):
            if isinstance(value, torch.Tensor) and \
                    not isinstance(value, torch.nn.Parameter):
                setattr(sub, name, value.to(device))
    for sub in placed.modules():
        if not isinstance(sub, torch.fx.GraphModule):
            continue
        for node in sub.graph.nodes:
            node.args = torch.fx.node.map_aggregate(
                node.args, lambda a: device if isinstance(a, torch.device)
                else a)
            node.kwargs = torch.fx.node.map_aggregate(
                node.kwargs, lambda a: device if isinstance(a, torch.device)
                else a)
        sub.recompile()
    return placed


def program_tensors_and_devices(module):
    """Every tensor a loaded program's module holds (parameters, buffers,
    tensor constants) and every device an op of its graphs names: what
    `_placed` must have moved."""
    tensors = list(module.state_dict(keep_vars=True).values())
    devices = []
    for sub in module.modules():
        tensors += [v for v in vars(sub).values()
                    if isinstance(v, torch.Tensor)]
        if isinstance(sub, torch.fx.GraphModule):
            for node in sub.graph.nodes:
                torch.fx.node.map_aggregate(
                    (node.args, node.kwargs), lambda a: devices.append(a)
                    if isinstance(a, torch.device) else a)
    return tensors, devices


class ExportedStep:
    """A loaded artifact: `call(bundle, rgb[, rgb_next])` runs the step, as
    `jax.export.Exported.call` does, under inference mode. `program` is the
    `torch.export.ExportedProgram`; `nr_devices` the replicas it was
    exported for (1 without a mesh).

    With nr_devices > 1, `call(bundles, rgb[, rgb_next])` takes the global
    batch and one bundle per replica (`replicated_bundles`): each
    replica's contiguous rows run on its bundle's device, with the program
    placed there (`_placed`, once per device), in a thread of its own
    under that device and on a stream of its own (made on the first call
    for the bundles' devices and kept until `close()`); the result is the
    replicas' outputs gathered in row order on the first bundle's
    device."""

    def __init__(self, program, nr_devices: int = 1, device=None):
        self.program = program
        self.nr_devices = int(nr_devices)
        self._module = program.module()
        self._device = None if device is None else torch.device(device)
        self._modules = {}  # device -> the program placed there
        self._replicas = {}  # the bundles' devices -> their replicas
        self._lock = threading.Lock()

    def module_on(self, device):
        """The program's module placed on `device` (the loaded one on the
        device it was traced on)."""
        device = torch.device(device)
        with self._lock:
            if device not in self._modules:
                self._modules[device] = (
                    self._module if device == self._device
                    else _placed(self._module, device))
            return self._modules[device]

    def call(self, bundle, rgb, rgb_next=None):
        images = (rgb,) if rgb_next is None else (rgb, rgb_next)
        if self.nr_devices == 1:
            with torch.inference_mode():
                return self._module(bundle, *images)
        if len(bundle) != self.nr_devices:
            raise ValueError(f"the program runs on {self.nr_devices} "
                             f"replicas; got {len(bundle)} bundles")
        devices = [b["text"].device for b in bundle]
        rows = _row_slices(rgb.shape[0], self.nr_devices)

        def step(module, weights, device, images):
            return module(weights, *(x.to(device) for x in images))

        with self._lock:
            if tuple(devices) not in self._replicas:
                self._replicas[tuple(devices)] = [_Replica(d)
                                                  for d in devices]
            replicas = self._replicas[tuple(devices)]
        outs = _on_replicas(replicas, step, [
            (self.module_on(d), b, d, [x[r] for x in images])
            for d, b, r in zip(devices, bundle, rows)])
        out = torch.cat([o.to(devices[0]) for o in outs], dim=1)
        for o in outs:
            if o.is_cuda:  # freed after the gather, not before
                o.record_stream(torch.cuda.current_stream(o.device))
        return out

    def close(self):
        """Stop the replicas' threads (a later call makes them anew)."""
        with self._lock:
            replicas, self._replicas = self._replicas, {}
        _close_all(r for group in replicas.values() for r in group)


def load_exported(path_or_bytes) -> ExportedStep:
    """Deserialize an artifact of `export_pipeline` (a path, or its bytes).
    Needs no pipeline or model object: importing the ops registers the
    custom ops the program calls."""
    from .ops import flash_attention, geglu  # noqa: F401 (the ops)

    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    extra = {_META: ""}
    program = torch.export.load(path_or_bytes, extra_files=extra)
    meta = json.loads(extra[_META]) if extra[_META] else {}
    return ExportedStep(program, meta.get("nr_devices", 1),
                        meta.get("device"))


def _infer_on_host(pipe, frames) -> np.ndarray:
    """infer_all_tasks of host frames [rgb(, rgb_next)] on the pipeline's
    device -> [T, B, H, W, 3] f32 on the host."""
    x = [torch.from_numpy(f).to(pipe.device) for f in frames]
    out = pipe.infer_all_tasks(x[0], x[1] if len(x) > 1 else None)
    return out.float().cpu().numpy()


class ServingSession:
    """Thread-safe micro-batching wrapper around the fused all-task step.

    Requests are single images [H, W, 3] normalized to [-1, 1], submitted
    from any thread; the first request pins the session's geometry. A
    collector thread packs up to `batch` requests per step, waiting at most
    `max_delay_s` after the first request of a group (0: each group is what
    is already queued), and pads partial groups by repeating the last image
    (the padding rows are computed and dropped: a fixed batch costs the
    same device time whatever its fill, so the delay trades latency for
    goodput under load). Any failure of a step (stacking, transfer, out of
    memory, a kernel error) is set on that group's futures; the thread
    serves on.

    With `mesh` (`parallel.host_local_mesh`), each step's padded batch
    splits into `mesh.data` contiguous slices of `batch / mesh.data` rows
    (a batch that does not divide raises), each run by a replica of the
    pipeline on its device (`pipeline_on`) in a thread of its own, under
    that device and on a stream of its own, its output copied to the host
    on that stream; the results are gathered in row order. A failure of
    any replica fails the whole group.
    """

    def __init__(self, pipe, batch: int = 8, max_delay_s: float = 0.005,
                 pair: bool = False, mesh=None):
        self.batch = int(batch)
        self.pair = bool(pair)
        self.max_delay_s = float(max_delay_s)
        self._pipe = pipe
        self._replicas = None
        if mesh is not None:
            self._rows = _row_slices(self.batch, mesh.data)
            pipes = {d: pipeline_on(pipe, d) for d in set(mesh.devices)}
            self._replica_pipes = [pipes[d] for d in mesh.devices]
            self._replicas = [_Replica(d) for d in mesh.devices]
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._geometry = None  # (H, W), pinned by the first request
        # one lock serializes the closed-check/enqueue and the geometry
        # pinning: a submit racing close() could otherwise land behind the
        # shutdown sentinel (its future never resolves), and two concurrent
        # first submits of different shapes could both pass validation
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, rgb_norm: np.ndarray,
               rgb_next_norm: Optional[np.ndarray] = None) -> Future:
        """Enqueue one image; resolves to np.ndarray [n_tasks, H, W, 3]."""
        rgb_norm = np.asarray(rgb_norm, np.float32)
        if rgb_norm.ndim != 3 or rgb_norm.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] image, got "
                             f"{rgb_norm.shape}")
        if self.pair:
            if rgb_next_norm is None:
                raise ValueError("pair=True session needs rgb_next_norm")
            rgb_next_norm = np.asarray(rgb_next_norm, np.float32)
            if rgb_next_norm.shape != rgb_norm.shape:
                raise ValueError("rgb and rgb_next shapes differ")
        elif rgb_next_norm is not None:
            raise ValueError("pair=False session got rgb_next_norm")
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("ServingSession is closed")
            if self._geometry is None:
                self._geometry = rgb_norm.shape[:2]
            if rgb_norm.shape[:2] != self._geometry:
                raise ValueError(
                    f"geometry {rgb_norm.shape[:2]} != session geometry "
                    f"{self._geometry}; a session serves one shape: resize "
                    f"upstream (predict.Predictor does) or open a second "
                    f"session")
            fut: Future = Future()
            self._queue.put((rgb_norm, rgb_next_norm, fut))
        return fut

    def infer(self, rgb_norm: np.ndarray,
              rgb_next_norm: Optional[np.ndarray] = None) -> np.ndarray:
        """Synchronous convenience: submit and wait."""
        return self.submit(rgb_norm, rgb_next_norm).result()

    def warmup(self, res_hw) -> None:
        """Run one step before traffic arrives (builds the kernels on first
        use)."""
        z = np.zeros((*res_hw, 3), np.float32)
        self.infer(z, z if self.pair else None)

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # wake the collector (after all submits)
        self._thread.join(timeout=60)
        _close_all(self._replicas or ())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- device side --------------------------------------------------------
    def _collect(self):
        """Block for the first request, then drain up to `batch` within
        max_delay_s. Returns a list of (rgb, rgb_next, future), or None on
        shutdown."""
        first = self._queue.get()
        if first is None:
            return None
        group = [first]
        t_end = time.monotonic() + max(0.0, self.max_delay_s)
        while len(group) < self.batch:
            try:
                item = self._queue.get(
                    timeout=max(0.0, t_end - time.monotonic()))
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # keep the shutdown for the next loop
                break
            group.append(item)
        return group

    def _step(self, group) -> np.ndarray:
        """One padded all-task step of `group` -> [T, batch, H, W, 3] f32
        on the host."""
        def stack(images):
            return np.stack(images + [images[-1]] * (self.batch - len(images)))

        frames = [stack([g[0] for g in group])]
        if self.pair:
            frames.append(stack([g[1] for g in group]))
        if self._replicas is None:
            with torch.inference_mode():
                return _infer_on_host(self._pipe, frames)
        return np.concatenate(_on_replicas(
            self._replicas, _infer_on_host,
            [(pipe, [f[rows] for f in frames])
             for pipe, rows in zip(self._replica_pipes, self._rows)]),
            axis=1)

    def _worker(self):
        while True:
            group = self._collect()
            if group is None:
                return
            # batch assembly, the transfer and the step stay inside the try:
            # an escaped exception would end this thread and leave every
            # future, this group's and all later ones, unresolved
            try:
                out = self._step(group)
            except Exception as e:
                for _, _, fut in group:
                    if not fut.cancelled():
                        fut.set_exception(e)
                continue
            for i, (_, _, fut) in enumerate(group):
                if not fut.cancelled():
                    # a copy, not a view: a view would pin the whole
                    # [T, batch, H, W, 3] buffer while any client holds it
                    fut.set_result(out[:, i].copy())
