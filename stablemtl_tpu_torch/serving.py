"""Serving: a micro-batching session around the fused all-task step,
counterpart of `stablemtl_tpu/serving.py`.

`ServingSession` runs a collector thread that groups up to `batch`
same-geometry requests (waiting at most `max_delay_s` after the first),
pads the tail by repeating the last image, runs ONE fused all-task step
(`pipeline.infer_all_tasks`) under `torch.inference_mode()` on the
pipeline's device, and resolves per-request futures with their own
unpadded [n_tasks, H, W, 3] float32 host arrays. The step keeps a fixed
batch, so every group costs the same device time, as with the JAX
package's compiled executable.

The JAX package's portable artifact (`export_pipeline`, `load_exported`)
and multi-chip serving (`mesh=`) are not ported: an artifact of this port
needs its kernels registered as `torch.library` custom ops.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .factory import cast_params_for_inference  # noqa: F401 (its API)


def export_pipeline(*args, **kwargs):
    raise NotImplementedError(
        "export_pipeline is not ported (ROADMAP A14): an artifact of the "
        "PyTorch port needs its CUDA kernels registered as torch.library "
        "custom ops")


def load_exported(*args, **kwargs):
    raise NotImplementedError(
        "load_exported is not ported (ROADMAP A14): see export_pipeline")


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
