"""Data parallelism. Counterpart of `stablemtl_tpu/parallel/`:
`distributed` (the process group), `mesh` (the data axis across processes
and its collectives; `host_local_mesh`, the devices of one process that
serving replicas run on) and `sharded_train` (the data-parallel step with
ZeRO-1). The JAX package's GSPMD placement objects (`batch_sharding`,
`replicated_sharding`) have no counterpart (mesh.py says why); tensor
parallelism (`tensor_parallel.py`) is not ported (ROADMAP A13 (b))."""

from .mesh import (DeviceMesh, Mesh, MeshConfig, host_local_mesh, make_mesh,
                   shard_batch)

__all__ = [
    "DeviceMesh",
    "Mesh",
    "MeshConfig",
    "host_local_mesh",
    "make_mesh",
    "shard_batch",
]
