"""The (data, model) layout and its collectives. Counterpart of
`stablemtl_tpu/parallel/mesh.py`.

The JAX package declares a `(data, model)` device mesh and lets GSPMD
insert the collectives. The port has one process per rank and writes the
collectives itself: `make_mesh` returns a `Mesh` over `data x model`
processes, rank r at data index r // model and model index r % model (the
row-major order of JAX's `devices.reshape(data, model)`). It holds two
kinds of subgroup: the data group (the ranks of one model index: the
batch is split over it and the gradients are all-reduced over it) and the
model group (the ranks of one data index: they hold one replica's
tensor-parallel shards, parallel/tensor_parallel.py). Its collectives:
all-reduce in flat buckets and all-gather over the data axis, all-reduce
and all-gather over the model axis, and an object broadcast, an
all-gather of objects and a barrier over every process, on the host.

Serving has a second form: one process driving replicas on several
devices. `host_local_mesh` returns a `DeviceMesh` of those devices, which
`serving.ServingSession(mesh=)` and `serving.export_pipeline(mesh=)` split
the batch over, one replica a device.

`batch_sharding` and `replicated_sharding` have no counterpart: they are
GSPMD placement objects over the devices of one program. Here every rank
or replica holds its own tensors; a replicated tensor is one every rank
computes alike, and the batch is split by `shard_batch`, by the loader's
shard, or by the serving replicas' row slices.

"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import TIMEOUT, rendezvous

# gradients are all-reduced in flat buckets of at most this many bytes:
# one collective per leaf (~1070 in the main UNet) would set the pace
BUCKET_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1    # -1 = all processes
    model: int = 1


class Mesh:
    """The data axis: `group` (None for one process without a process
    group, and for a data axis of one under model > 1), `data` ranks, this
    process's `rank` on it. The model axis: `model_group` (None when
    model == 1), `model` ranks, this process's `model_rank` on it.
    `process_rank` = rank * model + model_rank, the process's rank in the
    whole group. Counts what its collectives move: `reduced_bytes`
    all-reduced and `gathered_bytes` all-gathered (this rank's output)
    over the data axis, `model_bytes` all-reduced or all-gathered over the
    model axis, and `staged_bytes` copied to the host because gloo takes
    CUDA tensors through the host (the NCCL path stages nothing)."""

    def __init__(self, group, data: int, rank: int, model: int = 1,
                 model_rank: int = 0, model_group=None, world_group=None):
        self.group = group
        self.data = data
        self.rank = rank
        self.model = model
        self.model_rank = model_rank
        self.model_group = model_group
        self.process_rank = rank * model + model_rank
        world = group if world_group is None else world_group
        self.backend = None if world is None else dist.get_backend(world)
        # host-side messages (decisions, results, barriers) go over gloo
        # and every process, so they never wait on the card
        self.cpu_group = (world if self.backend in (None, "gloo")
                          else dist.new_group(backend="gloo",
                                              timeout=TIMEOUT))
        self.reduced_bytes = 0
        self.gathered_bytes = 0
        self.model_bytes = 0
        self.staged_bytes = 0
        self._pinned = {}

    @property
    def is_main(self) -> bool:
        return self.process_rank == 0

    @property
    def world(self) -> int:
        return self.data * self.model

    # -- collectives -------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """t's bytes on the host: a reused pinned buffer for large ones."""
        self.staged_bytes += t.numel() * t.element_size()
        if t.numel() * t.element_size() < (1 << 20):
            return t.cpu()
        buf = self._pinned.get(t.dtype)
        if buf is None or buf.numel() < t.numel():
            buf = torch.empty(max(t.numel(), BUCKET_BYTES // t.element_size()),
                              dtype=t.dtype, pin_memory=True)
            self._pinned[t.dtype] = buf
        host = buf[:t.numel()].view(t.shape)
        host.copy_(t)
        return host

    def _all_reduce_one(self, t: torch.Tensor) -> None:
        self.reduced_bytes += t.numel() * t.element_size()
        if self._staged(t):
            host = self._host(t)
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum `tensors` over the ranks, in place: contiguous tensors of one
        dtype packed into flat buckets of at most BUCKET_BYTES, one
        collective a bucket. A no-op without a process group."""
        if self.group is None:
            return
        bucket: List[torch.Tensor] = []
        size = 0

        def flush():
            nonlocal bucket, size
            if len(bucket) == 1:
                self._all_reduce_one(bucket[0])
            elif bucket:
                flat = torch.cat([t.reshape(-1) for t in bucket])
                self._all_reduce_one(flat)
                for t, part in zip(bucket, flat.split(
                        [t.numel() for t in bucket])):
                    t.copy_(part.view(t.shape))
                del flat
            bucket, size = [], 0

        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("all_reduce_ takes contiguous tensors")
            nbytes = t.numel() * t.element_size()
            if bucket and (t.dtype != bucket[0].dtype
                           or size + nbytes > BUCKET_BYTES):
                flush()
            bucket.append(t)
            size += nbytes
        flush()

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """t replaced by its mean over the ranks, in place."""
        self.all_reduce_([t])
        return t.div_(self.data)

    def all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """[data, *local.shape]: every rank's `local`, in rank order."""
        local = local.contiguous()
        if self.group is None:
            return local[None].clone()
        self.gathered_bytes += self.data * local.numel() * local.element_size()
        if self._staged(local):
            host = self._host(local)
            out = torch.empty((self.data,) + tuple(local.shape),
                              dtype=local.dtype)
            dist.all_gather(list(out.unbind(0)), host, group=self.group)
            return out.to(local.device)
        out = local.new_empty((self.data,) + tuple(local.shape))
        if self.backend == "gloo":
            dist.all_gather(list(out.unbind(0)), local, group=self.group)
        else:
            dist.all_gather_into_tensor(out, local, group=self.group)
        return out

    # -- the model axis -----------------------------------------------------

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the model group, a new tensor. 2-byte floats
        are summed in f32 and rounded once (gloo has no bfloat16, and the
        one-process product rounds its whole sum once)."""
        out = t.float() if t.element_size() == 2 else t.clone()
        out = out.contiguous()
        self.model_bytes += out.numel() * out.element_size()
        if self._staged(out):
            host = self._host(out)
            dist.all_reduce(host, group=self.model_group)
            out.copy_(host)
        else:
            dist.all_reduce(out, group=self.model_group)
        return out.to(t.dtype)

    def model_all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """[model, *local.shape]: every model rank's `local`, in model-rank
        order, bit for bit (2-byte floats travel as bytes: gloo has no
        bfloat16)."""
        local = local.contiguous()
        if local.dtype in (torch.bfloat16, torch.float16):
            return self.model_all_gather(local.view(torch.uint8)).view(
                local.dtype)
        self.model_bytes += self.model * local.numel() * local.element_size()
        if self._staged(local):
            host = self._host(local)
            out = torch.empty((self.model,) + tuple(local.shape),
                              dtype=local.dtype)
            dist.all_gather(list(out.unbind(0)), host,
                            group=self.model_group)
            return out.to(local.device)
        out = local.new_empty((self.model,) + tuple(local.shape))
        if self.backend == "gloo":
            dist.all_gather(list(out.unbind(0)), local,
                            group=self.model_group)
        else:
            dist.all_gather_into_tensor(out, local, group=self.model_group)
        return out

    # -- every process, on the host ------------------------------------------

    def broadcast_object(self, obj, src: int = 0):
        """Process `src`'s picklable `obj` on every process (over the
        host)."""
        if self.cpu_group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.cpu_group)
        return box[0]

    def all_gather_object(self, obj) -> list:
        """Every process's picklable `obj`, by process rank (over the
        host)."""
        if self.cpu_group is None:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def barrier(self) -> None:
        """Every process waits for the others, on the host."""
        if self.cpu_group is not None and self.world > 1:
            dist.barrier(group=self.cpu_group)


def make_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """The (data, model) mesh over every process of the open process group
    (one process and no group when none is open). Every process calls it,
    in the same order as its other group creations: it makes the data
    groups, then the model groups, with `dist.new_group` on every rank."""
    model = max(1, config.model)
    if not dist.is_initialized():
        if rendezvous() is not None:
            raise RuntimeError("the environment asks for several processes "
                               "but no process group is open: call "
                               "parallel.distributed.maybe_initialize() "
                               "first")
        n = 1
    else:
        n = dist.get_world_size()
    data = config.data if config.data > 0 else n // model
    if data * model != n or data < 1:
        raise ValueError(
            f"mesh {data}x{model} does not cover {n} process"
            f"{'es' if n != 1 else ''}: parallel.model {model} needs a "
            f"multiple of {model} processes, one a card (e.g. torchrun "
            f"--nproc_per_node {max(data, 1) * model})")
    if n == 1 and not dist.is_initialized():
        return Mesh(None, 1, 0)
    if model == 1:
        return Mesh(dist.group.WORLD, data, dist.get_rank())
    rank = dist.get_rank()
    data_group = model_group = None
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)],
                               timeout=TIMEOUT)
            if m == rank % model:
                data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)],
                           timeout=TIMEOUT)
        if d == rank // model:
            model_group = g
    return Mesh(data_group, data, rank // model, model=model,
                model_rank=rank % model, model_group=model_group,
                world_group=dist.group.WORLD)

class DeviceMesh:
    """The devices of one process that each run a replica of a serving
    step: `devices` (torch.device each, in row order) and `data`, their
    number. A device may appear more than once: its replicas share it."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_resolved(d) for d in devices)
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")

    @property
    def data(self) -> int:
        return len(self.devices)


def _resolved(device) -> torch.device:
    """`device` with its index; a CUDA device this process cannot reach
    raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = device.index
    if index is None and visible:
        index = torch.cuda.current_device()
    if index is None or index >= visible:
        raise RuntimeError(f"{device}: this process sees {visible} CUDA "
                           f"device(s)")
    return torch.device("cuda", index)


def host_local_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> DeviceMesh:
    """A DeviceMesh over the first `n_devices` CUDA devices (default: all
    visible), counterpart of the JAX package's `host_local_mesh`; fewer
    visible raises (no fewer replicas, no CPU). `devices` names them
    instead, e.g. ["cuda:0", "cuda:0"] for two replicas sharing one card or
    ["cpu", "cpu"] on the CPU."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices {n_devices} but {len(devices)} "
                             f"devices named")
        return DeviceMesh(devices)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise RuntimeError(f"host_local_mesh({n_devices}): this process "
                           f"sees {visible} CUDA device(s); name the "
                           f"devices (devices=[...]) to share one or to "
                           f"run on the CPU")
    return DeviceMesh([f"cuda:{i}" for i in range(n)])


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous rows of a GLOBAL batch dict: arrays with a
    leading batch axis are split over the data axis; scalars (e.g.
    task_idx) pass through.

    A non-scalar whose leading dim is not divisible by the data-axis size is
    an error (it would silently replicate and lose data parallelism — an 8x
    slowdown that looks like working code)."""
    n, r = mesh.data, mesh.rank
    out = {}
    for key, x in batch.items():
        shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
        if len(shape) == 0:
            out[key] = x
            continue
        if shape[0] == 0 or shape[0] % n != 0:
            raise ValueError(
                f"shard_batch: leaf ['{key}'] has leading "
                f"dim {shape[0]}, not divisible by the "
                f"mesh data axis "
                f"({n}); this would silently replicate instead of "
                f"sharding. Fix the batch size (or pass a 0-d scalar for "
                f"per-batch values like task_idx).")
        k = shape[0] // n
        out[key] = x[r * k:(r + 1) * k]
    return out
