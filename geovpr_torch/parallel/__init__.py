"""Multi-process execution of the port over `torch.distributed` (the
counterpart of `geovpr.parallel`): the process mesh, batch sharding and the
tensor-parallel rules. `batch_sharding` and `replicated_sharding` have no
counterpart (`geovpr_torch.parallel.mesh`)."""

from geovpr_torch.parallel.mesh import (
    Mesh,
    create_hybrid_mesh,
    create_mesh,
    initialize_distributed,
    pad_batch_to_multiple,
    shard_batch,
)

__all__ = ["Mesh", "create_hybrid_mesh", "create_mesh",
           "initialize_distributed", "pad_batch_to_multiple", "shard_batch"]
