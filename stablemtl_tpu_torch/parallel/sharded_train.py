"""The (data x model) training step: data parallelism with ZeRO-1
optimizer-state sharding, and tensor parallelism over the model axis.
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

Tensor parallelism (a mesh with model > 1): the UNet's
parameters are sliced to this rank's shards (`tensor_parallel.shard_unet`)
and the model modules compute on them. A split parameter's optimizer
state (moments, MultiSteps' accumulated gradient) mirrors its shard, as
JAX's `_opt_sharding` lays it out; every other leaf takes ZeRO-1 over the
data axis when `zero1`, else stays whole. The gradients, the loss and the
mask count are all-reduced over the data group only (model peers hold
the same rows). The clip's norm sums each split leaf over the model group,
each ZeRO-1 leaf over the data group, and counts each whole leaf once;
apply_if_finite's test looks at every rank. Adafactor's factored
statistics need the whole gradient of a split leaf: it is all-gathered
over the model group at the update, and the statistics stay whole.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Callable, List, Optional, Sequence

import torch

from ..pipeline import StableMTLPipeline
from ..train_state import (Optimizer, TrainState, create_train_state,
                           make_train_step)
from .mesh import BUCKET_BYTES, Mesh
from .tensor_parallel import shard_unet

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
    parameters stay whole on every rank of the data axis.

    Under tensor parallelism (`layout`, a `tensor_parallel.TPLayout`, and
    `names`, the parameters' names) a split parameter is this rank's shard
    and its state mirrors it (`tp_split[i]`; never ZeRO-1 sliced); `full`
    and `gathered` give such a leaf whole (gathered over the model group),
    and `local` takes a whole one or one shaped like its parameter.
    `zero1=False` keeps every other leaf whole."""

    def __init__(self, params, cfg, mesh: Mesh, zero1_min_size: int,
                 axes=None, layout=None, names=None, zero1: bool = True):
        self.mesh = mesh
        self.zero1_min_size = zero1_min_size
        self.zero1 = zero1
        self.layout = layout
        params = list(params)
        self.tp_split = [layout is not None and layout.sharded(n)
                         for n in (names or [None] * len(params))]
        self.names = names
        self.shard_axes = [
            zero1_axis(p.shape, mesh.data, zero1_min_size)
            if zero1 and not split else None
            for p, split in zip(params, self.tp_split)]
        super().__init__(params, cfg, axes)

    # -- the layout hooks of Optimizer -----------------------------------

    def _whole_shape(self, i: int, p) -> tuple:
        if self.tp_split[i]:
            return self.layout.shapes[self.names[i]]
        return tuple(p.shape)

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        if self.tp_split[i]:
            # a whole leaf is cut to this rank's shard; one shaped like the
            # parameter (a gradient, the parameter) is the shard already
            name = self.names[i]
            if tuple(t.shape) == self.layout.shapes[name]:
                return self.layout.local(name, t).contiguous()
            return t
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
        if self.tp_split[i]:
            return self.layout.whole(self.names[i], t)
        a = self.shard_axes[i]
        if a is None:
            return t
        parts = _gather(self.mesh, t)
        return torch.cat(list(parts.unbind(0)), dim=a)

    def gathered(self, tensors):
        rep = [i for i, a in enumerate(self.shard_axes)
               if a is None and tensors[i] is not None]
        for i in rep:
            yield i, self.full(i, tensors[i])
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
        if not self.sharded and not any(self.tp_split):
            return super()._global_norm(grads)
        norms = torch.stack(torch._foreach_norm(grads))
        # each sliced leaf's squared norm is the sum of its slices' (over
        # the data group for ZeRO-1, the model group for a shard); a whole
        # leaf's is its own, counted once
        if self.sharded:
            is_sharded = torch.tensor(
                [a is not None for a in self.shard_axes], device=norms.device)
            sq = torch.where(is_sharded, norms.square(), 0.0)
            self.mesh.all_reduce_([sq])
            norms = torch.where(is_sharded, sq.sqrt(), norms)
        if any(self.tp_split):
            is_split = torch.tensor(self.tp_split, device=norms.device)
            sq = self.mesh.model_all_reduce(
                torch.where(is_split, norms.square(), 0.0))
            norms = torch.where(is_split, sq.sqrt(), norms)
        return torch.linalg.vector_norm(norms)

    def _all_finite(self, grads) -> bool:
        if not self.sharded and not any(self.tp_split):
            return super()._all_finite(grads)
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]).any()
        bad = bad.float().reshape(1)
        self.mesh.all_reduce_([bad])
        if any(self.tp_split):
            bad = self.mesh.model_all_reduce(bad)
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
    """mesh.all_gather, bitwise: 2-byte floats travel as bytes (gloo has
    no bfloat16, nor int16)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return mesh.all_gather(t.view(torch.uint8)).view(t.dtype)
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
    checkpoint into the state this returns.

    With mesh.model > 1 (tensor parallelism), `unet` is first sliced to
    this rank's shards (`tensor_parallel.shard_unet`, unless it was
    already), split parameters are checked equal across the data group
    only, and their optimizer state mirrors their shards; `state.layout`
    is the layout (None at model 1)."""
    tp = mesh.model > 1
    layout = None
    if tp:
        layout = getattr(unet, "tp_layout", None) or shard_unet(unet, mesh)
    names = [n for n, p in unet.named_parameters() if p.requires_grad]

    def optimizer(params, cfg, axes):
        if zero1 or tp:
            return ShardedOptimizer(params, cfg, mesh, zero1_min_size, axes,
                                    layout=layout, names=names, zero1=zero1)
        return Optimizer(params, cfg, axes)

    state = create_train_state(unet, cfg, optimizer)
    state.layout = layout
    check_replicated(mesh, list(state.params.values()), state.split())
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


def check_replicated(mesh: Mesh, tensors, split=None) -> str:
    """Raise unless every rank holds the same `tensors` (compared by a
    float64 sum and sum of squares per tensor, against process 0's).
    `split` (per tensor, whether it is a tensor-parallel shard): a shard
    is compared across the data group only, against the rank of data
    index 0 with this rank's model index. Returns the digest
    (`param_digest`) of this rank's tensors: equal on every rank, or on
    every rank of one model index when some are shards."""
    tensors = list(tensors)
    sig = _signature(tensors)
    if split is None or not any(split):
        ref = mesh.broadcast_object(sig)
    else:
        sigs = mesh.all_gather_object(sig)
        is_split = torch.tensor(split)[:, None]
        ref = torch.where(is_split, sigs[mesh.model_rank], sigs[0])
    if not torch.equal(sig, ref):
        bad = int((sig != ref).any(dim=1).nonzero()[0])
        raise ValueError(f"process {mesh.process_rank}'s parameter {bad} "
                         f"differs from its peer's: build every rank from "
                         f"the same seed or checkpoint")
    return param_digest(tensors)


def make_sharded_train_step(pipeline: StableMTLPipeline, mesh: Mesh,
                            base_seed: int = 0, zero1: bool = False,
                            zero1_min_size: int = ZERO1_MIN_SIZE,
                            compute_grad_stats: bool = False) -> Callable:
    """The (data x model) step: fn(state, batch) -> (state, metrics) like
    `train_state.make_train_step`, with `.loss_and_grads`; `batch` holds
    this rank's rows (the loader's shard, or `shard_batch` of a global
    batch; model peers pass the same rows) and `state` comes from
    `create_sharded_train_state(mesh, zero1, zero1_min_size)` with the
    same settings (checked at every call: the update follows the state's
    layout). The metrics are global: the loss of the global batch. On the
    card, with mesh.model > 1, cuDNN runs its deterministic algorithms
    during the step: model peers compute the whole (replicated)
    parameters' gradients each on their own, and must find them
    bit-equal."""
    tp = mesh.model > 1
    inner = make_train_step(pipeline, base_seed=base_seed,
                            compute_grad_stats=compute_grad_stats, mesh=mesh)

    def check(state: TrainState):
        opt = state.opt
        sharded = isinstance(opt, ShardedOptimizer)
        if sharded != bool(zero1 or tp) or (sharded and (
                opt.mesh is not mesh or opt.zero1 != bool(zero1)
                or opt.zero1_min_size != zero1_min_size)):
            raise ValueError(
                f"the state was not laid out for this step (zero1={zero1}, "
                f"zero1_min_size={zero1_min_size}): build it with "
                f"create_sharded_train_state(unet, cfg, mesh, zero1={zero1}, "
                f"zero1_min_size={zero1_min_size})")

    def deterministic():
        if tp and pipeline.device.type == "cuda":
            return torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=False, deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32)
        return contextlib.nullcontext()

    def step(state: TrainState, batch):
        check(state)
        with deterministic():
            return inner(state, batch)

    def loss_and_grads(state: TrainState, batch, generator=None):
        with deterministic():
            return inner.loss_and_grads(state, batch, generator)

    step.loss_and_grads = loss_and_grads
    step.mesh = mesh
    return step
