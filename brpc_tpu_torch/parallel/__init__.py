"""Mesh collectives, sequence and pipeline parallelism for the port.

Counterpart of ``brpc_tpu/parallel/``.  Where the JAX package writes one
``shard_map`` program over a ``jax.sharding.Mesh`` and lets XLA insert the
interconnect transfers, the port runs one process per rank over a
``torch.distributed`` device mesh and calls the collectives itself:

- fan-out (ParallelChannel)    -> all_gather / psum over a mesh axis
- sharding (PartitionChannel)  -> a rank's block + all_to_all
- streaming windows            -> ring shifts (batched isend/irecv)

:mod:`.spmd` sets up the process group (NCCL on cuda, gloo on cpu) and
runs a function on every rank.
"""

from .mesh_transport import (Axis, MeshTransport, default_mesh,
                             global_mesh_transport, make_mesh, mesh_axis)

__all__ = ["Axis", "MeshTransport", "default_mesh", "global_mesh_transport",
           "make_mesh", "mesh_axis"]
