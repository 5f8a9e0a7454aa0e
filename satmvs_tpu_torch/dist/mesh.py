"""Ranks and the mesh: the port's counterpart of `satmvs_tpu/dist/mesh.py`
on `torch.distributed`.

One process drives one GPU, PyTorch's idiom, so where JAX's mesh holds
devices of one process, the port's holds ranks: `python -m
torch.distributed.run --nproc_per_node N` starts them (or a test or
`chip_smoke.py` spawns them), `init_multihost` joins the process group, and
`make_mesh` lays the ranks out on the axes.

Mesh axes, as in JAX:
  data     batch-parallel: each rank runs the single-GPU path on its share
           of the batch (or of a scene chunk's tiles); BatchNorm's batch
           moments, the loss's mask counts, the metrics and the gradients
           are summed over the data group (`nn.blocks.BatchNorm`,
           `models.losses`, `train.metrics`, `train.loop`)
  spatial  height sharding of images and cost volumes
  depth    depth-slab sharding of the CostRegNet's cost volumes
Only the data axis runs here.  The other two need hand-written halo
exchanges through the 3-D convolutions (XLA's GSPMD inserts them in JAX):
ROADMAP A10b.  `make_mesh` refuses them; `volume_spec` and
`stage_volume_specs` are here, with axis-name tuples in place of
PartitionSpecs, so that their extent guards carry over, and JAX's
`constrain` (a sharding constraint) waits for A10b.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


def init_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, backend: Optional[str] = None,
                   device=None) -> int:
    """Join the process group and return the world size.

    With no arguments and no torchrun environment (WORLD_SIZE unset) it
    starts nothing and returns 1, as JAX's returns one host's devices.
    Otherwise: world size `num_processes` (else WORLD_SIZE), rank
    `process_id` (else RANK), rendezvous at `coordinator` ("host:port" or
    an init-method URL such as "tcp://localhost:29500" or "file:///path";
    else torchrun's MASTER_ADDR/MASTER_PORT).  The rank runs on `device`,
    by default "cuda:{LOCAL_RANK}" (a LOCAL_RANK beyond the visible cards
    raises); the backend is nccl for a CUDA device and gloo for the CPU
    unless `backend` is given (two ranks that share one card take gloo:
    NCCL refuses them).  A second call returns the world size of the
    group already joined.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if num_processes is None and "WORLD_SIZE" not in os.environ:
        return 1
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device) if device is not None else torch.device("cuda", local)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device {dev} requested but CUDA is not available")
        index = local if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: cuda:{index} (LOCAL_RANK {local}) but "
                               f"{torch.cuda.device_count()} CUDA devices are visible")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if coordinator is not None and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=coordinator or "env://", world_size=world, rank=rank)
    return world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks laid out on the axes.

    shape: {"data", "spatial", "depth"} extents, as JAX's `Mesh.shape`.
    rank: this process's place on the data axis.
    world_size: the ranks of the world.
    device: this rank's device (None: tensors stay where they are).
    group: the process group of the mesh's ranks (None: one process, no
      collectives, the serial path).
    host_group: a gloo group over the same ranks, for host arrays.
    """
    shape: dict
    rank: int
    world_size: int
    device: Optional[torch.device] = None
    group: object = None
    host_group: object = None

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a no-op without a group)."""
        if self.group is not None:
            dist.barrier(group=self.host_group)


def make_mesh(data: int = 1, spatial: int = 1, depth: int = 1,
              world_size: Optional[int] = None, device=None) -> Mesh:
    """The mesh of data·spatial·depth ranks.  The world is the process
    group's (1 without one) unless `world_size` says otherwise, as in a
    test of the shapes.  Raises ValueError when the mesh needs more ranks
    than the world has, as JAX's does, or, under a process group, fewer
    (every rank holds a share), and NotImplementedError for spatial or
    depth > 1 (ROADMAP A10b).  Every rank calls it.  `device` is the
    rank's: by default the current card under nccl and the CPU under gloo
    (ranks that share a card over gloo pass it); without a process group
    None."""
    initialized = dist.is_available() and dist.is_initialized()
    world = world_size if world_size is not None else (
        dist.get_world_size() if initialized else 1)
    need = data * spatial * depth
    if need > world:
        raise ValueError(f"need {need} devices, have {world}")
    if spatial > 1 or depth > 1:
        raise NotImplementedError(
            f"mesh spatial={spatial}, depth={depth}: the port shards the data axis only; "
            "spatial and depth-slab sharding are ROADMAP A10b")
    shape = {"data": data, "spatial": spatial, "depth": depth}
    if not initialized:
        return Mesh(shape, 0, world, None if device is None else torch.device(device))
    if need < world:
        raise ValueError(f"a mesh of {need} ranks in a world of {world}: launch as many ranks "
                         "as the mesh holds")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else
                  torch.device("cpu"))
    group = dist.group.WORLD
    host_group = group if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(shape, dist.get_rank(), world, torch.device(device), group, host_group)


def batch_spec() -> tuple:
    """Leading-axis (batch) sharding over the data axis."""
    return ("data",)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous share of every leading axis of a batch: the
    images, depth_values, depth_stages, mask_stages, every stage's cameras
    (RPC or QC bundles, pinhole tensors) and the per-sample names, moved to
    the mesh's device.  A batch the data extent does not divide raises, as
    JAX's device_put does."""
    n = mesh.shape["data"]
    b = batch["imgs"].shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not divide over the {n} ranks of the data axis")
    share = slice(mesh.rank * (b // n), (mesh.rank + 1) * (b // n))

    def move(t):
        return t if mesh.device is None else t.to(mesh.device)

    def cut(v):
        if isinstance(v, torch.Tensor):
            return move(v[share])
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
            return v[share]  # per-sample names
        if isinstance(v, (list, tuple)):
            return type(v)(cut(x) for x in v)  # per-stage entries
        return v[share].map(move)  # a camera bundle
    return {k: cut(v) for k, v in batch.items()}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Broadcast rank 0's tensors of a nest of dicts, lists and tensors
    into every rank's, in place (one broadcast a dtype); returns the
    tree."""
    if mesh.group is None:
        return tree
    by_dtype: dict = {}
    for t in _tensors(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
    return tree


def volume_spec(spatial: bool = True, depth: bool = False) -> tuple:
    """Axis names of a (B, D, H, W, C) cost volume: batch over "data", H
    over "spatial", D over "depth"."""
    return ("data", "depth" if depth else None, "spatial" if spatial else None, None, None)


def stage_volume_specs(ndepths, spatial: bool = False, depth_shards: int = 1,
                       levels: int = 3, spatial_shards: int = 0, height: int = 0):
    """Per-cascade-stage volume axis names with JAX's guards on the sharded
    conv dims: a dim is sharded only at stages where every level of the
    `levels`-deep strided conv pyramid keeps extent ≥ the shard count
    (extent ≥ shards·2^levels; below it JAX's GSPMD backward miscomputes the
    gradients, `satmvs_tpu/dist/mesh.py:86-122`).  The depth guard uses
    `ndepths`; the spatial guard needs `spatial_shards` and the image
    `height` (stage H = height/scale, coarsest stage first), and without
    them spatial is applied unguarded."""
    num = len(ndepths)
    scales = {3: (4, 2, 1), 2: (4, 1), 1: (4,)}[num]

    def spatial_ok(i):
        if not spatial:
            return False
        if not (spatial_shards and height):
            return True
        return height // scales[i] >= spatial_shards * 2 ** levels

    return tuple(
        ("data",
         "depth" if depth_shards > 1 and nd >= depth_shards * 2 ** levels else None,
         "spatial" if spatial_ok(i) else None,
         None,
         None)
        for i, nd in enumerate(ndepths))
