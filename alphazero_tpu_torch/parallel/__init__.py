from alphazero_tpu_torch.parallel.distributed import (
    initialize,
    is_primary,
    primary_only,
    replicate_host_value,
)
from alphazero_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "param_shardings",
    "replicated",
    "shard_batch",
    "initialize",
    "is_primary",
    "primary_only",
    "replicate_host_value",
]
