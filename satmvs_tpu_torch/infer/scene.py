"""Whole-scene prediction: tile the scene, predict every tile, stitch.

Counterpart of `satmvs_tpu/infer/scene.py`, on one GPU or tile-parallel
over the ranks of a mesh's data axis.  `predict_scene` plans overlapping tiles (`infer/tiling.py`), crops every
view around each reference tile and shifts that view's RPC by its own crop
(`geo.rpc.crop_rpc`), runs the tile forward on `batch_tiles` tiles at once,
and stitches the interiors into scene-sized height and confidence maps.

Tile-parallel (a `dist.Mesh` of N data ranks, JAX's `shard_map` form of
`scripts/predict_scene.py:157-170`): every rank walks the same chunks,
runs its own N-th of each chunk's tiles through the forward, and the
chunk's maps are gathered on the host over the mesh's gloo group, so every
rank returns the whole stitched scene.

Host and device overlap: kernels are queued asynchronously, so the loop
prepares and queues chunk i+1 while the card runs chunk i, and only then
reads chunk i back (on each rank).  Inputs reach the card through pinned memory with
non-blocking copies, so queueing a chunk never waits for the card.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.preprocess import center_image
from ..device import resolve_device
from ..dist import host_gather
from ..geo import rpc as rpclib
from ..ops import warp as warplib
from . import tiling


def source_window(rpcs: np.ndarray, ref_index: int, view: int,
                  row0: int, col0: int, height: int, width: int,
                  h_min: float, h_max: float, scene_h: int, scene_w: int):
    """Source-view crop window (row0, col0) for a reference tile: project the
    tile's footprint (4 corners × the two height extremes) into the view and
    centre a window of the tile's size on it, clamped to the scene.  Views of
    a triplet share the ground, not the pixel grid, so a window shared by all
    views would sample outside the source crop."""
    if view == ref_index:
        return row0, col0
    cx = np.array([col0, col0 + width - 1.0] * 4)
    cy = np.array([row0] * 2 + [row0 + height - 1.0] * 2, np.float64)
    cy = np.concatenate([cy, cy])
    ch = np.array([h_min] * 4 + [h_max] * 4, np.float64)
    lat, lon = rpclib.photo_to_obj(rpcs[ref_index], cx, cy, ch)
    s, l = rpclib.obj_to_photo(rpcs[view], lat, lon, ch)
    c0 = int(round((s.min() + s.max()) / 2 - width / 2))
    r0 = int(round((l.min() + l.max()) / 2 - height / 2))
    c0 = max(0, min(c0, scene_w - width))
    r0 = max(0, min(r0, scene_h - height))
    return r0, c0


def predict_scene(
    forward: Callable,
    images: np.ndarray,
    rpcs: np.ndarray,
    tile: int = 384,
    halo: int = 32,
    ref_index: int = 0,
    depth_range: Optional[tuple[float, float]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    batch_tiles: int = 1,
    stats: Optional[dict] = None,
    norm: str = "tile",
    device=None,
    mesh=None,
):
    """A whole scene's reference-view height map, by tiles.

    forward: (imgs (B, V, th, tw, 3), cams (per-stage batched RpcWarpCams),
      depth_values (B, 2)) → dict with "depth" and "photometric_confidence"
      (B, th, tw); e.g. `functools.partial(infer.predict.streaming_red_forward,
      model, slab=8)` or the model itself.
    images: (V, H, W) or (V, H, W, 3) scene images; view `ref_index` is the
      reference.  rpcs: (V, 170) float64 scene RPCs.
    tile, halo: interior tile size and overlap (multiples of 32).
    depth_range: (h_min, h_max); by default the reference RPC's.
    batch_tiles: tiles per forward; a ragged last chunk is padded with
      repeats of its last tile, whose outputs are dropped.  Under a mesh it
      is rounded up to a multiple of the data extent N, and each rank runs
      batch_tiles/N of them (the mesh's rank r the r-th contiguous share).
    stats: filled with wall, host-prep and readback seconds, the tile and
      chunk counts and each chunk's seconds (the first includes any
      warm-up), all this rank's; under a mesh also the rank, the data
      extent, the tiles a forward on this rank and the seconds spent in the
      host gather.
    norm: "tile" normalizes every crop by its own statistics
      (`center_image`, the reference's per-block behaviour); "scene" by
      per-view statistics of the whole scene, so neighbouring tiles see the
      same radiometry.
    device: where the inputs go; the GPU unless "cpu" is passed (under a
      mesh, by default the mesh's device).
    mesh: a `dist.Mesh` for tile parallelism over its data axis (None or a
      mesh without a group: this process alone).

    Returns (depth (H, W) float32, confidence (H, W) float32).
    """
    group = None if mesh is None else mesh.group
    dev = resolve_device(mesh.device if device is None and group is not None else device)
    if norm not in ("tile", "scene"):
        raise ValueError(f"norm must be 'tile' or 'scene', got {norm!r}")
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = np.repeat(images[..., None], 3, axis=-1)
    v, scene_h, scene_w, _ = images.shape
    rpcs = np.asarray(rpcs, np.float64)
    if depth_range is None:
        h_min, h_max = rpclib.height_range(rpcs[ref_index])
    else:
        h_min, h_max = depth_range

    tiles = tiling.plan_tiles(scene_h, scene_w, tile=tile, halo=halo, multiple=32)
    order = [ref_index] + [i for i in range(v) if i != ref_index]
    if norm == "scene":
        # per-view, per-channel statistics over the whole scene (float64 sums)
        sc_mean = images.mean(axis=(1, 2), dtype=np.float64, keepdims=True).astype(np.float32)
        sc_std = (np.sqrt(images.var(axis=(1, 2), dtype=np.float64, keepdims=True))
                  + 1e-8).astype(np.float32)

    def upload(t: torch.Tensor) -> torch.Tensor:
        # pinned staging and a non-blocking copy: queueing never waits for the card
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    def tile_inputs(t: tiling.Tile):
        # per-view windows; each view's RPC shifts by its own crop
        imgs_t, rpcs_t = [], []
        for view in range(v):
            row0, col0 = source_window(rpcs, ref_index, view, t.row0, t.col0, t.height,
                                       t.width, h_min, h_max, scene_h, scene_w)
            crop = images[view][row0:row0 + t.height, col0:col0 + t.width]
            if norm == "scene":
                imgs_t.append((crop - sc_mean[view]) / sc_std[view])
            else:
                imgs_t.append(center_image(crop))
            rpcs_t.append(rpclib.crop_rpc(rpcs[view], start_w=col0, start_h=row0))
        imgs_t = np.stack(imgs_t)[order]
        return imgs_t, warplib.build_stage_cams(np.stack(rpcs_t)[order], 0, device="cpu")

    ranks, rank = (1, 0) if group is None else (mesh.shape["data"], mesh.rank)
    batch_tiles = -(-batch_tiles // ranks) * ranks  # a multiple of the data extent
    local = batch_tiles // ranks
    # tiles of one shape share a forward shape: run them `batch_tiles` at a time
    groups: dict[tuple[int, int], list[int]] = {}
    for idx, t in enumerate(tiles):
        groups.setdefault((t.height, t.width), []).append(idx)
    chunks = [members[i0:i0 + batch_tiles] for members in groups.values()
              for i0 in range(0, len(members), batch_tiles)]

    depth_outs: list = [None] * len(tiles)
    conf_outs: list = [None] * len(tiles)
    done = 0
    t_wall0 = time.perf_counter()
    t_prep = t_read = t_gather = 0.0

    def dispatch(chunk):
        """Host prep and the queued forward of this rank's share of one
        chunk (outputs not read)."""
        nonlocal t_prep
        t0 = time.perf_counter()
        padded = chunk + [chunk[-1]] * (batch_tiles - len(chunk))  # pad: repeat the last tile
        mine = padded[rank * local:(rank + 1) * local]
        built = {k: tile_inputs(tiles[k]) for k in dict.fromkeys(mine)}
        ins = [built[k] for k in mine]
        imgs_b = upload(torch.from_numpy(np.stack([im for im, _ in ins])))
        cams_b = tuple(warplib.stack_cams([c[s] for _, c in ins]).map(upload)
                       for s in range(len(ins[0][1])))
        dvals_b = upload(torch.tensor([[h_min, h_max]] * len(ins), dtype=torch.float32))
        t_prep += time.perf_counter() - t0
        return forward(imgs_b, cams_b, dvals_b)

    def collect(chunk, out):
        nonlocal done, t_read, t_gather
        t0 = time.perf_counter()
        depth_b = out["depth"].float().cpu().numpy()
        conf_b = out["photometric_confidence"].float().cpu().numpy()
        if group is not None:
            t1 = time.perf_counter()
            both = host_gather(np.stack([depth_b, conf_b]), mesh.host_group)
            depth_b, conf_b = np.concatenate(both, axis=1)
            t_gather += time.perf_counter() - t1
        for j, k in enumerate(chunk):
            depth_outs[k] = depth_b[j]
            conf_outs[k] = conf_b[j]
        t_read += time.perf_counter() - t0
        done += len(chunk)
        if progress:
            progress(done, len(tiles))

    # double-buffered: queue chunk i+1, then read chunk i back
    pending = None
    chunk_marks: list[float] = []
    t_mark = time.perf_counter()
    for chunk in chunks:
        out = dispatch(chunk)
        if pending is not None:
            collect(*pending)
            chunk_marks.append(time.perf_counter() - t_mark)
            t_mark = time.perf_counter()
        pending = (chunk, out)
    if pending is not None:
        collect(*pending)
        chunk_marks.append(time.perf_counter() - t_mark)

    if stats is not None:
        stats.update(wall_s=time.perf_counter() - t_wall0, host_prep_s=t_prep,
                     readback_s=t_read, n_tiles=len(tiles), n_chunks=len(chunks),
                     chunk_s=chunk_marks)
        if group is not None:
            stats.update(rank=rank, ranks=ranks, local_tiles=local, gather_s=t_gather)
    depth = tiling.stitch(tiles, depth_outs, scene_h, scene_w)
    conf = tiling.stitch(tiles, conf_outs, scene_h, scene_w)
    return depth, conf
