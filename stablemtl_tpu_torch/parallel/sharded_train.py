"""The data-parallel training step with ZeRO-1 optimizer-state sharding.
Counterpart of `stablemtl_tpu/parallel/sharded_train.py`.

The JAX package's mesh step is, by construction, the single-device step on
the global batch. So is this one, up to the order of reductions: every rank
runs the step on its rows of the batch (`train_state.make_train_step` with
a mesh), the loss is the masked sum over its rows divided by the mask
count of the global batch, the gradients are all-reduced as a sum, the task
masking reads a statistic averaged over the ranks, and the input noise is
drawn at the global shape.

ZeRO-1 (`zero1=True`): each optimizer-state leaf of at least
`zero1_min_size` elements (Adam's mu and nu, Adafactor's unfactored v, and
the accumulated gradient of MultiSteps) holds only this rank's slice, along
the largest axis the data size divides, as the JAX package shards its
optax state (`_zero1_sharding_for`). The update runs on the owned slices;
the updated parameter slices are then all-gathered, so every rank holds
the full parameters for the next forward. The axis is picked on the port's
own layout (a Linear weight is [out, in], a Flax kernel [in, out]); the
update is elementwise, so the numbers do not depend on the axis, except
for Adafactor's factored leaves, whose row and column statistics need the
whole gradient: their slice is all-gathered at the update and their
statistics (below 65536 elements at SD2 widths) stay replicated, as in
JAX. The global-norm clip and apply_if_finite's test reduce partial
results over the ranks, counting each replicated leaf once.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, List, Optional, Sequence

import torch

from ..pipeline import StableMTLPipeline
from ..train_state import (Optimizer, TrainState, create_train_state,
                           make_train_step)
from .mesh import BUCKET_BYTES, Mesh

# Leaves below this many elements are replicated instead of ZeRO-1 sharded:
# sharding a (320,)-bias moment over 8 cards saves a KB but costs a
# gather at every update (the JAX package measured per-leaf collectives
# dominating its step). 64k elements = 256 KB f32.
ZERO1_MIN_SIZE = 65536


def zero1_axis(shape: Sequence[int], n: int,
               min_size: int = 0) -> Optional[int]:
    """The axis a ZeRO-1 leaf of `shape` is split along over `n` ranks: the
    largest axis divisible by n (the first of equal ones); None
    (replicated) below `min_size` elements, when no axis divides, or when
    n == 1."""
    if math.prod(shape) < min_size:
        return None
    best_axis, best_size = None, 0
    for i, d in enumerate(shape):
        if d % n == 0 and d > best_size:
            best_axis, best_size = i, d
    if best_axis is None or n == 1:
        return None
    return best_axis


class ShardedOptimizer(Optimizer):
    """`Optimizer` whose per-leaf state holds this rank's slice of every
    leaf `zero1_axis` gives an axis (`shard_axes`; None: replicated). The
    parameters stay whole on every rank."""

    def __init__(self, params, cfg, mesh: Mesh, zero1_min_size: int,
                 axes=None):
        self.mesh = mesh
        self.zero1_min_size = zero1_min_size
        params = list(params)
        self.shard_axes = [zero1_axis(p.shape, mesh.data, zero1_min_size)
                           for p in params]
        super().__init__(params, cfg, axes)

    # -- the layout hooks of Optimizer -----------------------------------

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        a = self.shard_axes[i]
        if a is None:
            return t
        k = t.shape[a] // self.mesh.data
        return t.narrow(a, self.mesh.rank * k, k).contiguous()

    def _local_shape(self, i: int, shape) -> tuple:
        a = self.shard_axes[i]
        shape = tuple(shape)
        if a is None:
            return shape
        return shape[:a] + (shape[a] // self.mesh.data,) + shape[a + 1:]

    def full(self, i: int, t: torch.Tensor) -> torch.Tensor:
        a = self.shard_axes[i]
        if a is None:
            return t
        parts = _gather(self.mesh, t)
        return torch.cat(list(parts.unbind(0)), dim=a)

    def gathered(self, tensors):
        rep = [i for i, a in enumerate(self.shard_axes)
               if a is None and tensors[i] is not None]
        for i in rep:
            yield i, tensors[i]
        owned = [i for i, a in enumerate(self.shard_axes)
                 if a is not None and tensors[i] is not None]
        for idx, parts in _gather_buckets(self.mesh,
                                          [tensors[i] for i in owned],
                                          owned):
            for i, part in zip(idx, parts):
                yield i, torch.cat(list(part.unbind(0)),
                                   dim=self.shard_axes[i])

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.shard_axes)

    def _global_norm(self, grads) -> torch.Tensor:
        if not self.sharded:
            return super()._global_norm(grads)
        norms = torch.stack(torch._foreach_norm(grads))
        is_sharded = torch.tensor([a is not None for a in self.shard_axes],
                                  device=norms.device)
        # each sharded leaf's squared norm is the sum of its slices'; a
        # replicated leaf's is its own, counted once
        sq = torch.where(is_sharded, norms.square(), 0.0)
        self.mesh.all_reduce_([sq])
        return torch.linalg.vector_norm(
            torch.where(is_sharded, sq.sqrt(), norms))

    def _all_finite(self, grads) -> bool:
        if not self.sharded:
            return super()._all_finite(grads)
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]).any()
        bad = bad.float().reshape(1)
        self.mesh.all_reduce_([bad])
        return not bool(bad.item())

    def _add_update(self, u) -> None:
        """Parameters += u: replicated leaves whole; sharded leaves on their
        slice, then all-gathered into the whole parameter, in flat buckets
        per dtype."""
        rep = [i for i, a in enumerate(self.shard_axes) if a is None]
        if rep:
            torch._foreach_add_([self.params[i] for i in rep],
                                [u[i] for i in rep])
        owned = [i for i, a in enumerate(self.shard_axes) if a is not None]
        if not owned:
            return
        mine = [self.local(i, self.params[i]) for i in owned]
        torch._foreach_add_(mine, [u[i] for i in owned])
        for idx, parts in _gather_buckets(self.mesh, mine, owned):
            for i, part in zip(idx, parts):
                p, a = self.params[i], self.shard_axes[i]
                # [data, *slice] into the slices side by side along axis a
                p.unflatten(a, (self.mesh.data, -1)).copy_(
                    part.movedim(0, a))


def _gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """mesh.all_gather, bitwise: 2-byte floats travel as int16 (gloo has
    no bfloat16)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return mesh.all_gather(t.view(torch.int16)).view(t.dtype)
    return mesh.all_gather(t)


def _gather_buckets(mesh: Mesh, tensors: List[torch.Tensor],
                    idx: List[int]):
    """All-gather `tensors` (contiguous slices) packed into flat buckets of
    one dtype, each gathered bucket at most BUCKET_BYTES; yields (leaf
    indices, [data, *slice] per leaf)."""
    limit = BUCKET_BYTES // mesh.data
    start = 0
    while start < len(tensors):
        end, size = start, 0
        for t in tensors[start:]:
            nbytes = t.numel() * t.element_size()
            if end > start and (t.dtype != tensors[start].dtype
                                or size + nbytes > limit):
                break
            size += nbytes
            end += 1
        chunk = tensors[start:end]
        out = _gather(mesh, torch.cat([t.reshape(-1) for t in chunk]))
        parts = [p.reshape((mesh.data,) + tuple(t.shape)) for p, t in zip(
            out.split([t.numel() for t in chunk], dim=1), chunk)]
        yield idx[start:end], parts
        start = end


def create_sharded_train_state(unet, cfg, mesh: Mesh, zero1: bool = False,
                               zero1_min_size: int = ZERO1_MIN_SIZE
                               ) -> TrainState:
    """`create_train_state` laid out on the mesh: the parameters whole on
    every rank (checked equal across the ranks), the optimizer state whole
    (zero1=False) or sliced per ZeRO-1, never held whole (which is what
    ZeRO-1 saves). The counterpart of the JAX package's
    `shard_train_state`, which places a state built whole; restore a
    checkpoint into the state this returns."""
    def optimizer(params, cfg, axes):
        if zero1:
            return ShardedOptimizer(params, cfg, mesh, zero1_min_size, axes)
        return Optimizer(params, cfg, axes)

    state = create_train_state(unet, cfg, optimizer)
    check_replicated(mesh, list(state.params.values()))
    return state


def _signature(tensors) -> torch.Tensor:
    """[n, 2] float64: each tensor's sum and sum of squares, on the host."""
    with torch.no_grad():
        return torch.stack([torch.stack([t.double().sum(),
                                         t.double().square().sum()])
                            for t in tensors]).cpu()


def param_digest(tensors) -> str:
    """A short digest of `tensors`' values (of their sums and sums of
    squares): equal tensors give equal digests."""
    return hashlib.sha256(_signature(tensors).numpy().tobytes()).hexdigest(
    )[:16]


def check_replicated(mesh: Mesh, tensors) -> str:
    """Raise unless every rank holds the same `tensors` (compared by a
    float64 sum and sum of squares per tensor, against rank 0's). Returns
    their digest (`param_digest`), equal on every rank."""
    tensors = list(tensors)
    sig = _signature(tensors)
    ref = mesh.broadcast_object(sig)
    if not torch.equal(sig, ref):
        bad = int((sig != ref).any(dim=1).nonzero()[0])
        raise ValueError(f"rank {mesh.rank}'s parameter {bad} differs from "
                         f"rank 0's: build every rank from the same seed or "
                         f"checkpoint")
    return param_digest(tensors)


def make_sharded_train_step(pipeline: StableMTLPipeline, mesh: Mesh,
                            base_seed: int = 0, zero1: bool = False,
                            zero1_min_size: int = ZERO1_MIN_SIZE,
                            compute_grad_stats: bool = False) -> Callable:
    """The data-parallel step: fn(state, batch) -> (state, metrics) like
    `train_state.make_train_step`, with `.loss_and_grads`; `batch` holds
    this rank's rows (the loader's shard, or `shard_batch` of a global
    batch) and `state` comes from `create_sharded_train_state(mesh, zero1,
    zero1_min_size)` with the same settings (checked at every call: the
    update follows the state's layout). The metrics are global: the loss
    of the global batch."""
    inner = make_train_step(pipeline, base_seed=base_seed,
                            compute_grad_stats=compute_grad_stats, mesh=mesh)

    def check(state: TrainState):
        opt = state.opt
        sharded = isinstance(opt, ShardedOptimizer)
        if sharded != bool(zero1) or (sharded and (
                opt.mesh is not mesh
                or opt.zero1_min_size != zero1_min_size)):
            raise ValueError(
                f"the state was not laid out for this step (zero1={zero1}, "
                f"zero1_min_size={zero1_min_size}): build it with "
                f"create_sharded_train_state(unet, cfg, mesh, zero1={zero1}, "
                f"zero1_min_size={zero1_min_size})")

    def step(state: TrainState, batch):
        check(state)
        return inner(state, batch)

    def loss_and_grads(state: TrainState, batch, generator=None):
        return inner.loss_and_grads(state, batch, generator)

    step.loss_and_grads = loss_and_grads
    step.mesh = mesh
    return step
