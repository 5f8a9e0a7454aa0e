"""Whole-scene prediction CLI: the twin of scripts/predict_scene.py.

    python -m satmvs_tpu_torch.cli.predict_scene \
        --images v0.png v1.png v2.png --rpcs v0.rpc v1.rpc v2.rpc \
        --loadckpt checkpoints/red/rpc --out scene_height.pfm \
        [--ref_index 2] [--tile 384] [--halo 32] [--streaming --slab 8] \
        [--batch_tiles 4] [--dsm scene_dsm.tif]

Reads the scene rasters (`formats.read_scene_image`, tone-mapped when not
8-bit) and RPCs, predicts the reference view tile by tile
(`infer.scene.predict_scene`) over the slab-streaming forward
(--streaming, red model only; the CostRegNet families warn and take the
full-volume forward, as the JAX script does) or the full-volume forward,
writes the height map and its _prob map; --dsm also predicts every other
view as the reference, writes each view's map (<out>_view{v}.pfm) and
fuses them into a DSM.
--batch_tiles is the tiles a forward (0: one a rank).  Flags and defaults
are the JAX script's.  A one-stage cascade (--ndepths 64) raises after the
first chunk: its maps are at 1/4 of the tile, which the stitch cannot
place (JAX's script fails at the stitch).

On N GPUs, tile-parallel (each rank on its own card runs its share of
every chunk's tiles; rank 0 writes the maps and the DSM):

    python -m torch.distributed.run --nproc_per_node N -m satmvs_tpu_torch.cli.predict_scene ...
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from . import cli_device, process_group, restore_model


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="satmvs_tpu_torch whole-scene prediction")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--rpcs", nargs="+", required=True)
    p.add_argument("--loadckpt", required=True)
    p.add_argument("--out", required=True, help="output height PFM path")
    p.add_argument("--model", default="red", choices=["red", "casmvs", "ucs"])
    p.add_argument("--ndepths", default="64,32,8")
    p.add_argument("--min_interval", type=float, default=2.5)
    p.add_argument("--ref_index", type=int, default=0)
    p.add_argument("--tile", type=int, default=384)
    p.add_argument("--halo", type=int, default=32)
    p.add_argument("--dsm", default=None, help="also fuse all views to a DSM raster")
    p.add_argument("--p_ratio", type=float, default=2.0,
                   help="reprojection round-trip px threshold")
    p.add_argument("--d_ratio", type=float, default=7.5, help="height-gap threshold (m)")
    p.add_argument("--geo_consist_num", type=int, default=1)
    p.add_argument("--confidence_ratio", type=float, default=0.0)
    p.add_argument("--norm", default="tile", choices=["tile", "scene"],
                   help="'tile' normalizes each crop, 'scene' by whole-scene per-view statistics")
    p.add_argument("--grid_res", type=float, default=5.0)
    p.add_argument("--batch_tiles", type=int, default=0,
                   help="tiles per forward over all ranks (0 = one a rank)")
    p.add_argument("--streaming", action="store_true",
                   help="slab-streaming tile forward (red model only)")
    p.add_argument("--fused_sweep", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--slab", type=int, default=8,
                   help="planes per streaming step (0 = one plane at a time)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Predict one scene (and fuse).  Returns {"depth", "conf", "stats"
    (`predict_scene`'s, the reference view's run), "n_chunks" (forward
    calls over all views' runs), "dsm" (raster path, valid fraction) or
    None, "fuse_s"}; under torchrun on every rank (the DSM rank 0's)."""
    a = _parser().parse_args(argv)
    device = cli_device(deterministic=True)
    with process_group(device) as world:
        return _run(a, device, world)


def _run(a, device, world: int) -> dict:
    from ..data import formats
    from ..dist import make_mesh
    from ..infer.predict import streaming_red_forward
    from ..infer.scene import predict_scene
    from ..train.config import Config

    if len(a.images) != len(a.rpcs):
        raise ValueError(f"{len(a.images)} images but {len(a.rpcs)} RPCs")
    cfg = Config(model=a.model, geo_model="rpc",
                 ndepths=tuple(int(x) for x in a.ndepths.split(",")),
                 min_interval=a.min_interval, view_num=len(a.images),
                 fused_sweep={"auto": None, "on": True, "off": False}[a.fused_sweep])
    mesh = make_mesh(data=world) if world > 1 else None
    writer = mesh is None or mesh.rank == 0
    images = np.stack([formats.read_scene_image(p) for p in a.images])
    rpcs = np.stack([formats.load_rpc(p)[0] for p in a.rpcs])
    model, _, _ = restore_model(cfg, a.loadckpt, device)
    calls = []
    streaming = a.streaming and a.model == "red"
    if a.streaming and not streaming:
        print("WARNING: --streaming is red-only; using the full-volume forward", file=sys.stderr)

    def forward(imgs, cams, dvals):
        calls.append(imgs.shape[0])  # tiles in this chunk
        if streaming:
            return streaming_red_forward(model, imgs, cams, dvals, slab=a.slab)
        return model(imgs, cams, dvals)

    batch_tiles = a.batch_tiles or world
    run = functools.partial(predict_scene, forward, images, rpcs, tile=a.tile, halo=a.halo,
                            batch_tiles=batch_tiles, norm=a.norm, device=device, mesh=mesh,
                            num_stage=cfg.num_stage)
    t0 = time.time()
    stats: dict = {}
    progress = (lambda i, n: print(f"tile {i}/{n}", end="\r")) if writer else None
    depth, conf = run(ref_index=a.ref_index, stats=stats, progress=progress)
    result = {"depth": depth, "conf": conf, "stats": stats, "dsm": None, "fuse_s": None}
    if writer:
        print(f"\nscene predicted in {time.time() - t0:.1f}s → {a.out}")
        share = stats["host_prep_s"] / max(stats["wall_s"], 1e-9)
        print(f"[scene] {stats['n_tiles']} tiles / {stats['n_chunks']} chunks; "
              f"wall {stats['wall_s']:.3f}s = {1e3 * stats['wall_s'] / stats['n_tiles']:.1f} ms "
              f"per tile, host prep {stats['host_prep_s']:.3f}s ({share:.0%} of wall; "
              f"overlapped with device compute), readback {stats['readback_s']:.3f}s")
        formats.save_pfm(a.out, depth.astype(np.float32))
        formats.save_pfm(os.path.splitext(a.out)[0] + "_prob.pfm", conf.astype(np.float32))

    if a.dsm:
        from ..infer.fuse import fuse_scene_to_dsm

        v = len(a.images)
        others = [i for i in range(v) if i != a.ref_index]
        depths = [depth] + [run(ref_index=i)[0] for i in others]  # every rank takes part
        if writer:
            fuse_order = [a.ref_index] + others
            base = os.path.splitext(a.out)[0]
            for vi, d_i in zip(fuse_order, depths):
                formats.save_pfm(f"{base}_view{vi}.pfm", d_i.astype(np.float32))
            t1 = time.perf_counter()
            path, mask, _ = fuse_scene_to_dsm(
                np.stack(depths), rpcs[fuse_order], a.dsm, grid_res=a.grid_res, prob=conf,
                p_ratio=a.p_ratio, d_ratio=a.d_ratio, geo_consist_num=a.geo_consist_num,
                confidence_ratio=a.confidence_ratio, device=device)
            result["fuse_s"] = time.perf_counter() - t1
            result["dsm"] = (path, float(mask.mean()))
            print(f"DSM written: {path} (valid {mask.mean():.1%}, p_ratio {a.p_ratio}, d_ratio "
                  f"{a.d_ratio}, geo_consist {a.geo_consist_num}, conf {a.confidence_ratio})")
    result["n_chunks"] = len(calls)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
