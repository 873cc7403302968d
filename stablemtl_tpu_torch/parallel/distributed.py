"""Multi-process distribution. Counterpart of
`stablemtl_tpu/parallel/distributed.py`.

The reference trains on many GPUs through HF Accelerate's DDP over NCCL.
The port does the same with `torch.distributed`: one process per card, one
process group, the batch split over the ranks and the gradients all-reduced
by the data-parallel step (parallel/sharded_train.py). Each data rank
feeds only its contiguous slice of each global batch (`loader_shard`;
tensor-parallel peers feed the same slice); the
loader's schedule is (seed, step)-pure, so every rank agrees on the task of
every micro-step. Host artifacts (TensorBoard, vis PNGs, the config and
code snapshots, checkpoint files) are rank 0's; every rank takes part in
the collectives behind them.

Env contract (nothing set = one process and no process group):
  STABLEMTL_COORDINATOR=host:port  the rendezvous address
  STABLEMTL_NUM_PROCESSES=N        the number of processes
  STABLEMTL_PROCESS_ID=i           this process's rank
  STABLEMTL_DIST=1                 take all of it from torchrun's RANK,
                                   WORLD_SIZE, MASTER_ADDR, MASTER_PORT
torchrun's variables are read whenever its WORLD_SIZE is set, so
`torchrun --nproc_per_node 8 -m stablemtl_tpu_torch.cli.train ...` works.
LOCAL_RANK picks the card (`cuda:LOCAL_RANK`); without it the rank modulo
the number of visible cards. The backend is NCCL on CUDA and gloo on the
CPU; STABLEMTL_DIST_BACKEND=gloo (or `backend="gloo"`) takes gloo on CUDA
too, which lets two ranks share one card (NCCL refuses that).

Nothing falls back: a failed init raises, and so does a world size above 1
that no process group backs.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# long enough for a validation pass that rank 0 runs while the others wait
# at a barrier
TIMEOUT = datetime.timedelta(hours=2)
BACKENDS = ("nccl", "gloo")


def _env_int(*names) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def rendezvous():
    """(address, world size, rank) from the env contract, or None when
    nothing asks for more than one process."""
    coord = os.environ.get("STABLEMTL_COORDINATOR")
    nproc = _env_int("STABLEMTL_NUM_PROCESSES")
    auto = os.environ.get("STABLEMTL_DIST", "").strip() in ("1", "auto")
    torchrun = _env_int("WORLD_SIZE")
    if not (coord or nproc or auto or torchrun):
        return None
    if nproc is not None:
        rank = _env_int("STABLEMTL_PROCESS_ID")
        if rank is None:
            raise ValueError("STABLEMTL_NUM_PROCESSES is set but "
                             "STABLEMTL_PROCESS_ID is not; each process "
                             "must know its id")
    else:
        nproc, rank = torchrun, _env_int("RANK")
        if nproc is None or rank is None:
            raise ValueError("distributed training asked for, but neither "
                             "STABLEMTL_NUM_PROCESSES/STABLEMTL_PROCESS_ID "
                             "nor torchrun's WORLD_SIZE/RANK are set")
    if not coord:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not (addr and port):
            raise ValueError("no rendezvous address: set "
                             "STABLEMTL_COORDINATOR=host:port or "
                             "MASTER_ADDR and MASTER_PORT")
        coord = f"{addr}:{port}"
    if not 0 <= rank < nproc:
        raise ValueError(f"process id {rank} is not in [0, {nproc})")
    return coord, nproc, rank


def local_rank(rank: Optional[int] = None) -> int:
    """The card index of this process: LOCAL_RANK, else its rank (by
    default the group's) modulo the visible cards, else 0."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rank = process_index() if rank is None else rank
    return rank % n if n else 0


def maybe_initialize(device="cuda", backend: Optional[str] = None) -> bool:
    """Open the process group the env contract asks for; call before any
    heavy build. Returns whether a group is open (also when it was opened
    earlier). `device`: the device type the run computes on (NCCL for
    "cuda", gloo for "cpu"); `backend` or STABLEMTL_DIST_BACKEND overrides.
    On CUDA the process is bound to `cuda:local_rank()` first. The group
    is opened with one small all-reduce, so a rendezvous that fails does
    so here and not inside the first training step."""
    if dist.is_initialized():
        return True
    rdv = rendezvous()
    if rdv is None:
        return False
    coord, world, rank = rdv
    device_type = torch.device(device).type
    backend = (backend or os.environ.get("STABLEMTL_DIST_BACKEND")
               or ("nccl" if device_type == "cuda" else "gloo"))
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the NCCL backend needs device cuda")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    probe = torch.ones(1, device=torch.device(
        "cuda", torch.cuda.current_device()) if backend == "nccl"
        else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"the process group's first all-reduce gave "
                           f"{probe.item()}, not {world}")
    log.info("process group open: rank %d of %d, backend %s, %s", rank,
             world, backend, coord)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def loader_shard(mesh) -> Optional[tuple]:
    """(index, count) of this process's rows for the data loader: `mesh`'s
    data rank and size, or None when it reads whole batches (keeps the
    loader's single-process path untouched). Model-axis peers read the
    same rows, as the JAX package divides the batch by the data axis
    (`stablemtl_tpu/parallel/mesh.py:78-85`)."""
    return (mesh.rank, mesh.data) if mesh.data > 1 else None


def barrier() -> None:
    """Every rank waits for the others; a no-op without a group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Close the process group, when one is open."""
    if dist.is_initialized():
        dist.destroy_process_group()
