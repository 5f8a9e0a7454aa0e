"""Prediction CLI: the twin of scripts/predict.py.

    python -m satmvs_tpu_torch.cli.predict --dataset_root=DIR --loadckpt=CKPT_DIR \
        [--streaming --slab 8] [--fuse] [--color]

Every view of every sample in turn is the reference (pred mode, batch 1);
each prediction goes to <dataset_root>/mvs_results/{view}/{init,prob}/{name}.pfm.
--streaming runs `infer.predict.streaming_red_forward` (slabs of --slab
planes) for the red model; the CostRegNet families (--model casmvs, ucs)
have no streaming form and take the full-volume forward with a warning, as
the JAX script does.  --fuse filters each scene's views
(`infer.fuse.fuse_scene_to_dsm`) into mvs_results/{name}_dsm.tif, or its
PFM + TFW fallback without GDAL; it fuses RPC scenes only, as the JAX
script does, and with --geo_model pinhole says so and writes the maps.
--color also writes colour PNGs and needs matplotlib.  --fused_sweep off
builds the cost volumes with the per-view sweep (`sweep_gather`) instead
of the fused `sweep_variance` kernel.  --geo_model pinhole reads the
camera-text layout (camera/{v}/*.txt); --use_qc takes the RPC cameras in
QC form.  --torch_compat samples and draws hypotheses as the reference
does (`models.cascade`'s torch_compat), for a checkpoint converted from it
(`cli.convert_ckpt`); with --streaming too.  Flags and defaults are the
JAX script's.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from . import cli_device, restore_model


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="satmvs_tpu_torch prediction")
    p.add_argument("--model", default="red", choices=["red", "casmvs", "ucs"])
    p.add_argument("--geo_model", default="rpc", choices=["rpc", "pinhole"])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--loadckpt", required=True)
    p.add_argument("--view_num", type=int, default=3)
    p.add_argument("--ndepths", default="64,32,8")
    p.add_argument("--min_interval", type=float, default=2.5)
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--lamb", type=float, default=1.5)
    p.add_argument("--use_qc", action="store_true")
    p.add_argument("--max_h", type=int, default=0)
    p.add_argument("--max_w", type=int, default=0)
    p.add_argument("--streaming", action="store_true",
                   help="slab-streaming forward (red model only)")
    p.add_argument("--slab", type=int, default=0,
                   help="streaming slab size (planes a step; 0 = one plane at a time)")
    p.add_argument("--torch_compat", action="store_true")
    p.add_argument("--fuse", action="store_true", help="fuse views into a DSM")
    p.add_argument("--color", action="store_true",
                   help="also write colour PNGs (init/color, prob/color); needs matplotlib")
    p.add_argument("--p_ratio", type=float, default=2.0)
    p.add_argument("--d_ratio", type=float, default=7.5)
    p.add_argument("--geo_consist_num", type=int, default=1)
    p.add_argument("--confidence_ratio", type=float, default=0.1)
    p.add_argument("--grid_res", type=float, default=5.0)
    p.add_argument("--fused_sweep", default="auto", choices=["auto", "on", "off"])
    return p


def _pyplot():
    """matplotlib's pyplot on the Agg backend; raises naming the package
    where it is not installed."""
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError("--color needs matplotlib, which is not installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Predict (and fuse).  Returns {"epoch", "forward_s" (one per sample,
    host clock to the read-back), "written" ({(view, name): init PFM path}),
    "fused" ({name: (raster path, valid fraction)}), "fuse_s" ({name: s})}."""
    from ..data import formats
    from ..data.dataset import find_dataset
    from ..data.loader import Loader
    from ..infer.predict import streaming_red_forward
    from ..train.config import Config

    a = _parser().parse_args(argv)
    cfg = Config(
        model=a.model, geo_model=a.geo_model,
        ndepths=tuple(int(x) for x in a.ndepths.split(",") if x),
        depth_inter_r=tuple(float(x) for x in a.depth_inter_r.split(",") if x),
        cr_base_chs=tuple(int(x) for x in a.cr_base_chs.split(",") if x),
        min_interval=a.min_interval, lamb=a.lamb, view_num=a.view_num, use_qc=a.use_qc,
        torch_compat=a.torch_compat,
        fused_sweep={"auto": None, "on": True, "off": False}[a.fused_sweep],
    )
    plt = _pyplot() if a.color else None
    device = cli_device(deterministic=True)
    ds = find_dataset(a.geo_model)(a.dataset_root, "pred", a.view_num, geo_model=a.geo_model,
                                   num_stage=cfg.num_stage, use_qc=a.use_qc, max_h=a.max_h,
                                   max_w=a.max_w)
    ld = Loader(ds, batch_size=1, device=device)
    model, _, epoch = restore_model(cfg, a.loadckpt, device)
    if a.streaming and a.model == "red":
        forward = functools.partial(streaming_red_forward, model, slab=a.slab)
    else:
        if a.streaming:
            print("WARNING: --streaming is red-only; using the full-volume forward",
                  file=sys.stderr)
        forward = model

    out_root = os.path.join(a.dataset_root, "mvs_results")
    per_scene: dict[str, dict] = {}
    result = {"epoch": epoch, "forward_s": [], "written": {}, "fused": {}, "fuse_s": {}}
    t0 = time.time()
    for i, batch in enumerate(ld):
        t1 = time.perf_counter()
        out = forward(batch["imgs"], batch["cams"], batch["depth_values"])
        depth = out["depth"][0].cpu().numpy().astype(np.float32)
        prob = out["photometric_confidence"][0].cpu().numpy().astype(np.float32)
        result["forward_s"].append(time.perf_counter() - t1)
        view, name = batch["out_view"][0], batch["out_name"][0]
        for sub, arr in (("init", depth), ("prob", prob)):
            d = os.path.join(out_root, view, sub)
            os.makedirs(d, exist_ok=True)
            formats.save_pfm(os.path.join(d, f"{name}.pfm"), arr)
        result["written"][(view, name)] = os.path.join(out_root, view, "init", f"{name}.pfm")
        if plt is not None:
            cd = os.path.join(out_root, view, "init", "color")
            pd = os.path.join(out_root, view, "prob", "color")
            os.makedirs(cd, exist_ok=True)
            os.makedirs(pd, exist_ok=True)
            plt.imsave(os.path.join(cd, f"{name}.png"), depth)
            plt.imsave(os.path.join(pd, f"{name}_prob.png"), prob)
        print(f"iter {i}/{len(ld)} view={view} {name} time={time.perf_counter() - t1:.3f}s")
        per_scene.setdefault(name, {})[view] = (depth, prob)
    print(f"prediction done in {time.time() - t0:.1f}s")

    if a.fuse and a.geo_model != "rpc":
        print("--fuse: fusion into a DSM covers RPC scenes only; the pinhole maps are written",
              file=sys.stderr)
    elif a.fuse:
        from ..infer.fuse import fuse_scene_to_dsm

        for name, views in per_scene.items():
            order = sorted(views)
            depths = np.stack([views[v][0] for v in order])
            rpcs = np.stack([formats.load_rpc(os.path.join(a.dataset_root, "rpc", v,
                                                           f"{name}.rpc"))[0] for v in order])
            t1 = time.perf_counter()
            path, mask, _ = fuse_scene_to_dsm(
                depths, rpcs, os.path.join(out_root, f"{name}_dsm.tif"), grid_res=a.grid_res,
                prob=views[order[0]][1], p_ratio=a.p_ratio, d_ratio=a.d_ratio,
                geo_consist_num=a.geo_consist_num, confidence_ratio=a.confidence_ratio,
                device=device)
            result["fuse_s"][name] = time.perf_counter() - t1
            result["fused"][name] = (path, float(mask.mean()))
            print(f"fused {name}: {path} (valid {mask.mean():.1%})")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
