"""Fusion operating-point sweep: the twin of scripts/fusion_sweep.py.

    python -m satmvs_tpu_torch.cli.fusion_sweep --views h_view2.pfm h_view0.pfm h_view1.pfm \
        --rpcs v2.rpc v0.rpc v1.rpc [--prob h_prob.pfm] [--gt gt.npy] \
        [--p_ratio 1 2 4] [--d_ratio 2.5 7.5 15] [--geo_consist 1 2] [--confidence 0 0.1]

Sweeps the geometric-consistency filter's four thresholds (p_ratio,
d_ratio, geo_consist_num, confidence_ratio) over already-predicted per-view
height maps (`cli.predict_scene --dsm` writes `<out>_view{i}.pfm`),
reference view first, through `infer.fuse.filter_depth_rpc` on the card
(the CPU under SATMVS_PLATFORM=cpu).  Settings with geo_consist above the
number of source views are skipped.  Prints one JSON line a setting with
the JAX script's keys: the valid share of the reference's pixels in
percent and, with --gt (the reference view's heights, .pfm or .npy), the
MAE and the share under 2.5 m over the fused mask after the 250 m
gross-error cut.  Flags and defaults are the JAX script's.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Optional, Sequence

import numpy as np

from . import cli_device


def load_map(path: str) -> np.ndarray:
    """A height or confidence map from .npy or .pfm, float32."""
    from ..data import formats

    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return formats.load_pfm(path).astype(np.float32)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="satmvs_tpu_torch fusion operating-point sweep")
    p.add_argument("--views", nargs="+", required=True,
                   help="per-view height PFMs, reference view FIRST "
                        "(predict_scene --dsm writes <out>_view{i}.pfm)")
    p.add_argument("--rpcs", nargs="+", required=True, help="RPC files in the order of --views")
    p.add_argument("--prob", default=None,
                   help="reference-view confidence PFM (predict_scene writes <out>_prob.pfm)")
    p.add_argument("--gt", default=None,
                   help="reference-view GT heights (.pfm or .npy) for MAE")
    p.add_argument("--p_ratio", type=float, nargs="+", default=[0.5, 1.0, 2.0, 4.0, 8.0])
    p.add_argument("--d_ratio", type=float, nargs="+", default=[2.5, 5.0, 7.5, 15.0, 30.0])
    p.add_argument("--geo_consist", type=int, nargs="+", default=[1, 2])
    p.add_argument("--confidence", type=float, nargs="+", default=[0.0])
    p.add_argument("--out", default=None, help="also append JSONL here")
    return p


def main(argv: Optional[Sequence[str]] = None) -> list[dict]:
    """Run the sweep; returns the rows it printed."""
    from ..data import formats
    from ..infer.fuse import filter_depth_rpc

    a = _parser().parse_args(argv)
    if len(a.views) != len(a.rpcs):
        raise SystemExit(f"--views has {len(a.views)} maps but --rpcs {len(a.rpcs)} files")
    device = cli_device()
    depths = np.stack([load_map(v) for v in a.views])
    rpcs = np.stack([formats.load_rpc(r)[0] for r in a.rpcs])
    prob = load_map(a.prob) if a.prob else None
    gt = load_map(a.gt) if a.gt else None
    if gt is not None and gt.shape != depths[0].shape:
        raise SystemExit(f"--gt is {gt.shape}, the reference map {depths[0].shape}")

    rows = []
    for pr, dr, gc, cr in itertools.product(a.p_ratio, a.d_ratio, a.geo_consist, a.confidence):
        if gc > len(a.views) - 1:
            continue
        mask, fused = filter_depth_rpc(depths, rpcs, p_ratio=pr, d_ratio=dr,
                                       geo_consist_num=gc, prob=prob, confidence_ratio=cr,
                                       device=device)
        row = {"p_ratio": pr, "d_ratio": dr, "geo_consist": gc, "confidence": cr,
               "valid_pct": round(float(mask.mean()) * 100, 2)}
        if gt is not None and mask.any():
            err = np.abs(fused - gt)[mask]
            err = err[err < 250.0]  # the reference's gross-error cut
            row["mae_m"] = round(float(err.mean()), 3) if err.size else None
            row["lt2.5m_pct"] = round(float((err < 2.5).mean()) * 100, 2) if err.size else None
        rows.append(row)
        print(json.dumps(row))
    if a.out:
        with open(a.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
