"""Multi-device execution: the 1-D ``data`` mesh (counterpart of
``protoclip_tpu/parallel``).

Data parallelism, as in the JAX package: the N*K support images, the eval
batches, the Q^T train batches, feature extraction and the serving encode
shard their batches over the devices of a mesh, weights replicated, and
the features are gathered back.  Across processes the group is
``torch.distributed`` (NCCL on the cards, gloo on the CPU); the only
collective is the features' ``all_gather``.
"""

from protoclip_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    local_device_count,
    make_mesh,
    process_device,
)
from protoclip_tpu_torch.parallel.sharding import (
    Replicas,
    ShardedBatch,
    batch_sharding,
    fetch_to_host,
    make_sharded_encode,
    mesh_batch,
    replicated,
    shard_batch,
    shard_qt_step,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "init_distributed",
    "local_device_count",
    "process_device",
    "Replicas",
    "ShardedBatch",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "fetch_to_host",
    "make_sharded_encode",
    "mesh_batch",
    "shard_qt_step",
]
