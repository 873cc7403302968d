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

Multi-chip serving (`mesh=`) is not ported (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import io
import queue
import threading
import time
import zipfile
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from .factory import cast_params_for_inference  # noqa: F401 (its API)
from .pipeline import N_TASKS

# the bundle's key of each module of the pipeline, and its attribute
_MODULES = {"vae": "vae", "unet": "unet", "child": "unet_child"}


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
    STABLEMTL_FAST_MATH tier), STABLEMTL_FUSED_GEGLU,
    STABLEMTL_DISABLE_FLASH and STABLEMTL_DISABLE_PREFIX_SHARE, and the
    check of TPU-only flags (`reject_tpu_only_flags`). Exporting launches
    no kernel: the ops trace by their shape-only implementations.

    platforms: None or the pipeline's own device type ("cuda", "cpu"); a
    traced program holds device-placed constants, so another raises. mesh:
    multi-chip serving is not ported (ROADMAP A13).
    """
    if mesh is not None:
        raise NotImplementedError(
            "export_pipeline(mesh=): multi-chip serving is not ported "
            "(ROADMAP A13)")
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
    torch.export.save(program, buf)
    blob = _deflate(buf.getvalue())
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class ExportedStep:
    """A loaded artifact: `call(bundle, rgb[, rgb_next])` runs the step, as
    `jax.export.Exported.call` does, under inference mode. `program` is the
    `torch.export.ExportedProgram`."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, bundle, rgb, rgb_next=None):
        images = (rgb,) if rgb_next is None else (rgb, rgb_next)
        with torch.inference_mode():
            return self._module(bundle, *images)


def load_exported(path_or_bytes) -> ExportedStep:
    """Deserialize an artifact of `export_pipeline` (a path, or its bytes).
    Needs no pipeline or model object: importing the ops registers the
    custom ops the program calls."""
    from .ops import flash_attention, geglu  # noqa: F401 (the ops)

    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    return ExportedStep(torch.export.load(path_or_bytes))


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
    """

    def __init__(self, pipe, batch: int = 8, max_delay_s: float = 0.005,
                 pair: bool = False, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-chip serving (mesh=) is not ported (ROADMAP A13)")
        self.batch = int(batch)
        self.pair = bool(pair)
        self.max_delay_s = float(max_delay_s)
        self._pipe = pipe
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
        dev = self._pipe.device

        def put(images):
            images = images + [images[-1]] * (self.batch - len(images))
            return torch.from_numpy(np.stack(images)).to(dev)

        with torch.inference_mode():
            rgb = put([g[0] for g in group])
            nxt = put([g[1] for g in group]) if self.pair else None
            out = self._pipe.infer_all_tasks(rgb, nxt)
            return out.float().cpu().numpy()

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
