"""Spatial tiling for whole-scene inference.

Counterpart of `satmvs_tpu/infer/tiling.py`.  Overlapping tiles are
predicted with a halo of context; each output pixel is taken from the tile
whose interior owns it, so context near tile borders never leaks into the
stitched map.  Every tile of a scene has one extent (tile + 2·halo, capped
at the scene), so one forward shape serves the whole scene.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tile:
    row0: int          # tile origin in the scene (incl. halo)
    col0: int
    height: int        # tile extent (incl. halo)
    width: int
    core_row0: int     # interior region owned by this tile (scene coords)
    core_col0: int
    core_height: int
    core_width: int


def plan_tiles(scene_h: int, scene_w: int, tile: int = 384, halo: int = 32,
               multiple: int = 32) -> list[Tile]:
    """Cover (scene_h, scene_w) with overlapping tiles of size ≤ tile + 2·halo.

    Interiors partition the scene exactly; tile extents are clipped to the
    scene and rounded to `multiple` (the network's stride) when possible.
    """
    if tile % multiple or halo % multiple:
        raise ValueError(f"tile {tile} and halo {halo} must be multiples of {multiple}")

    def extent(origin: int, core: int, scene: int) -> tuple[int, int]:
        # one size for every tile (tile + 2·halo, capped at the scene): edge
        # tiles shift their origin inward and take the slack as extra halo
        want = tile + 2 * halo
        cap = max((scene // multiple) * multiple, -(-core // multiple) * multiple)
        size = min(want, cap, scene if scene < multiple else cap)
        size = min(max(size, core), scene)
        # centred halo, clamped so the tile stays in the scene and holds its core
        lo = max(0, origin + core - size)
        hi = min(origin, scene - size)
        start = min(max(origin - halo, lo), max(hi, lo))
        return start, size

    tiles = []
    for r0 in range(0, scene_h, tile):
        for c0 in range(0, scene_w, tile):
            core_h = min(tile, scene_h - r0)
            core_w = min(tile, scene_w - c0)
            row0, th = extent(r0, core_h, scene_h)
            col0, tw = extent(c0, core_w, scene_w)
            tiles.append(Tile(row0, col0, th, tw, r0, c0, core_h, core_w))
    return tiles


def extract(arr: np.ndarray, t: Tile) -> np.ndarray:
    """A tile (incl. halo) of a scene array (H, W, ...)."""
    return arr[t.row0:t.row0 + t.height, t.col0:t.col0 + t.width]


def stitch(tiles: list[Tile], tile_outputs: list[np.ndarray],
           scene_h: int, scene_w: int) -> np.ndarray:
    """The scene map from per-tile outputs, interiors only."""
    out = np.zeros((scene_h, scene_w) + tile_outputs[0].shape[2:], tile_outputs[0].dtype)
    for t, val in zip(tiles, tile_outputs):
        r = t.core_row0 - t.row0
        c = t.core_col0 - t.col0
        out[t.core_row0:t.core_row0 + t.core_height,
            t.core_col0:t.core_col0 + t.core_width] = val[r:r + t.core_height,
                                                          c:c + t.core_width]
    return out
