"""Data parallelism across processes. Counterpart of
`stablemtl_tpu/parallel/`: `distributed` (the process group), `mesh` (the
data axis and its collectives) and `sharded_train` (the data-parallel step
with ZeRO-1). The JAX package's GSPMD placement objects (`batch_sharding`,
`replicated_sharding`, `host_local_mesh`) have no counterpart (mesh.py
says why); tensor parallelism (`tensor_parallel.py`) is not ported
(ROADMAP A13 (b))."""

from .mesh import Mesh, MeshConfig, make_mesh, shard_batch

__all__ = [
    "Mesh",
    "MeshConfig",
    "make_mesh",
    "shard_batch",
]
