"""Ranks and the mesh: the port's counterpart of `satmvs_tpu/dist/mesh.py`
on `torch.distributed`.

One process drives one GPU, PyTorch's idiom, so where JAX's mesh holds
devices of one process, the port's holds ranks: `python -m
torch.distributed.run --nproc_per_node N` starts them (or a test or
`chip_smoke.py` spawns them), `init_multihost` joins the process group, and
`make_mesh` lays the ranks out on the axes.

Mesh axes, as in JAX (rank r sits at (r // (S·P), (r // P) % S, r % P)
of a data × spatial (S) × depth (P) mesh, JAX's
`np.array(devices).reshape(data, spatial, depth)`):
  data     batch-parallel: each rank runs the single-GPU path on its share
           of the batch (or of a scene chunk's tiles); BatchNorm's batch
           moments, the loss's mask counts, the metrics and the gradients
           are summed over the ranks (`nn.blocks.BatchNorm`,
           `models.losses`, `train.metrics`, `train.loop`)
  spatial  height sharding of the cascade's stage cost volumes in training:
           each rank of a spatial group builds and regularizes a band of
           each sharded stage's rows
  depth    depth-slab sharding of the CostRegNet's stage cost volumes in
           training: each rank of a depth group a slab of the hypotheses
Where JAX states a sharding constraint on each stage's volume and GSPMD
inserts the halo exchanges, the port builds a rank's share itself and
exchanges the halos of its 3-D convolutions by hand (`dist.halo`,
`models.cascade`).  A stage shards where `stage_volume_specs` (JAX's
guarded specs, axis-name tuples in place of PartitionSpecs) names an axis;
`slab_bounds` cuts it at multiples of 8 planes or rows.  `Mesh` holds a
process group for each axis and the world, the "volume" group of a
sharded stage.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
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
    rank: this process's rank in the mesh (its place is `coords`).
    world_size: the ranks of the world.
    device: this rank's device (None: tensors stay where they are).
    group: the process group of the mesh's ranks, the "volume" group
      (None: one process, no collectives, the serial path).
    host_group: a gloo group over the same ranks, for host arrays.
    data_group, spatial_group, depth_group: the ranks that differ from this
      one only along that axis (None where the axis has extent 1; the data
      group is `group` on a mesh of the data axis alone).
    """
    shape: dict
    rank: int
    world_size: int
    device: Optional[torch.device] = None
    group: object = None
    host_group: object = None
    data_group: object = None
    spatial_group: object = None
    depth_group: object = None

    @property
    def coords(self) -> tuple[int, int, int]:
        """(data, spatial, depth) index of this rank, JAX's layout."""
        s, p = self.shape["spatial"], self.shape["depth"]
        return self.rank // (s * p), (self.rank // p) % s, self.rank % p

    def axis_group(self, axis: str):
        """The process group of `axis` ("data", "spatial" or "depth")."""
        return {"data": self.data_group, "spatial": self.spatial_group,
                "depth": self.depth_group}[axis]

    def shard(self, axis: str, extent: int):
        """This rank's `dist.halo.Shard` of an axis ("spatial" or "depth")
        of `extent` planes or rows (`slab_bounds`)."""
        from .halo import Shard

        index = self.coords[1 if axis == "spatial" else 2]
        return Shard(axis, self.axis_group(axis), index,
                     slab_bounds(extent, self.shape[axis]), extent)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a no-op without a group)."""
        if self.group is not None:
            dist.barrier(group=self.host_group)


def make_mesh(data: int = 1, spatial: int = 1, depth: int = 1,
              world_size: Optional[int] = None, device=None) -> Mesh:
    """The mesh of data·spatial·depth ranks, laid out as JAX lays out its
    devices.  The world is the process group's (1 without one) unless
    `world_size` says otherwise, as in a test of the shapes.  Raises
    ValueError when the mesh needs more ranks than the world has, as JAX's
    does, or, under a process group, fewer (every rank holds a share).
    Every rank calls it (it creates the axes' process groups, every rank
    all of them in one order: the data groups, the spatial groups, the
    depth groups).  `device` is the rank's: by default the current card
    under nccl and the CPU under gloo (ranks that share a card over gloo
    pass it); without a process group None."""
    initialized = dist.is_available() and dist.is_initialized()
    world = world_size if world_size is not None else (
        dist.get_world_size() if initialized else 1)
    need = data * spatial * depth
    if need > world:
        raise ValueError(f"need {need} devices, have {world}")
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
    rank = dist.get_rank()
    axes = _axis_groups(shape, rank) if need > data else {"data_group": group}
    return Mesh(shape, rank, world, torch.device(device), group, host_group, **axes)


def _axis_groups(shape: dict, rank: int) -> dict:
    """The data, spatial and depth groups of `rank` (None where an axis has
    extent 1): every rank creates every group, in one order."""
    extents = [shape[axis] for axis in ("data", "spatial", "depth")]
    grid = np.arange(int(np.prod(extents))).reshape(extents)  # JAX's layout
    out = {}
    for i, axis in enumerate(("data", "spatial", "depth")):
        mine = None
        if extents[i] > 1:
            for members in np.moveaxis(grid, i, -1).reshape(-1, extents[i]).tolist():
                group = dist.new_group(members)
                if rank in members:
                    mine = group
        out[f"{axis}_group"] = mine
    return out


def batch_spec() -> tuple:
    """Leading-axis (batch) sharding over the data axis."""
    return ("data",)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous share of every leading axis of a batch (the
    share of its place on the data axis: the ranks of a spatial or depth
    group hold the same share): the images, depth_values, depth_stages,
    mask_stages, every stage's cameras (RPC or QC bundles, pinhole tensors)
    and the per-sample names, moved to the mesh's device.  A batch the data
    extent does not divide raises, as JAX's device_put does."""
    n = mesh.shape["data"]
    b = batch["imgs"].shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not divide over the {n} ranks of the data axis")
    d = mesh.coords[0]
    share = slice(d * (b // n), (d + 1) * (b // n))

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


SLAB_UNIT = 8  # 2^levels of the CostRegNet's stride-2 pyramid: each level keeps its parity


def slab_bounds(extent: int, shards: int, unit: int = SLAB_UNIT) -> tuple:
    """Every rank's [lo, hi) of an axis of `extent` cut into `shards` slabs
    at multiples of `unit` planes or rows, as even as those allow (a slab
    may be a unit shorter than another; the last ends at the extent).
    Raises when the extent holds fewer units than shards, which the guard
    of `stage_volume_specs` rules out."""
    units = -(-extent // unit)
    if units < shards:
        raise ValueError(f"an extent of {extent} does not cut into {shards} slabs of "
                         f"multiples of {unit}")
    cuts = [min(unit * (k * units // shards), extent) for k in range(shards + 1)]
    return tuple(zip(cuts[:-1], cuts[1:]))
