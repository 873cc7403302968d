"""Data and tensor parallelism. Counterpart of `stablemtl_tpu/parallel/`:
`distributed` (the process group), `mesh` (the data and model axes across
processes and their collectives; `host_local_mesh`, the devices of one
process that serving replicas run on), `tensor_parallel` (the model
axis's policy, `shard_unet` and its differentiable collectives) and
`sharded_train` (the (data x model) step with ZeRO-1). The JAX package's
GSPMD placement objects (`batch_sharding`, `replicated_sharding`,
`tp_param_shardings`) have no counterpart (mesh.py says why);
`tp_axis` and `tp_specs` take the place of `tp_spec` and
`tp_param_specs`, on the port's names and layouts."""

from .mesh import (DeviceMesh, Mesh, MeshConfig, host_local_mesh, make_mesh,
                   shard_batch)
from .tensor_parallel import TPLayout, shard_unet, tp_axis, tp_specs

__all__ = [
    "DeviceMesh",
    "Mesh",
    "MeshConfig",
    "TPLayout",
    "host_local_mesh",
    "make_mesh",
    "shard_batch",
    "shard_unet",
    "tp_axis",
    "tp_specs",
]
