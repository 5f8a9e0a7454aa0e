"""Distribution layer: ranks, the mesh record, batch sharding, the
collectives of the data axis and the exchanges of a sharded cost volume.
Counterpart of `satmvs_tpu/dist/` on `torch.distributed`, one process per
GPU."""

from .collectives import all_reduce_grads, all_reduce_sum, host_gather  # noqa: F401
from .halo import Shard, exchange_stats, group_max, halo_exchange, slab_gather  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    batch_spec,
    init_multihost,
    make_mesh,
    replicate,
    shard_batch,
    slab_bounds,
    stage_volume_specs,
    volume_spec,
)
