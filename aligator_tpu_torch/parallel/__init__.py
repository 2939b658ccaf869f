"""parallel — device-mesh scaling helpers over ``torch.distributed`` (one
process a device; SPMD over scenarios and time)."""

from .mesh import (COLLECTIVES, HOST_COPIES, Mesh, all_gather, batched_solve,
                   make_hybrid_mesh, make_mesh, shard_batch)

__all__ = ["COLLECTIVES", "HOST_COPIES", "Mesh", "all_gather", "batched_solve",
           "make_hybrid_mesh", "make_mesh", "shard_batch"]
