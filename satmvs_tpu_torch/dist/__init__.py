"""Distribution layer: ranks, the mesh record, batch sharding and the
collectives the data axis needs.  Counterpart of `satmvs_tpu/dist/` on
`torch.distributed`, one process per GPU."""

from .collectives import all_reduce_grads, all_reduce_sum, host_gather  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    batch_spec,
    init_multihost,
    make_mesh,
    replicate,
    shard_batch,
    stage_volume_specs,
    volume_spec,
)
