"""End-to-end run on synthetic WHU-TLC-geometry scenes: the twin of
scripts/synthetic_e2e.py.

    python -m satmvs_tpu_torch.cli.synthetic_e2e [--scenes 16] [--test_scenes 4] \
        [--epochs 12] [--size 128] [--ndepths 32,16,8] [--compute_dtype float32] [--workdir DIR]

Generates a train and a test tree with the port's writer
(`data.synthetic.write_synthetic_dataset`, seeds 0 and 10 000, ±60 m
terrain over a 150 m height scale, as the JAX script does), trains
CascadeREDNet under RPC geometry with `train.fit` (RMSprop, lr 1e-3, the
LR halved at epochs/2 and 3·epochs/4), evaluates the trained model on the
test split (`make_eval_step`, MAE with the 250 m cut and the 1.0 / 2.5 /
7.5 m and 3-interval accuracies), predicts all three views of the test
split's scene0000, fuses them in the view order 2, 0, 1
(`infer.fuse.filter_depth_rpc`, p_ratio 2.0, d_ratio 7.5, one consistent
view) and scores the fused heights against view 2's ground truth with the
250 m cut.  Prints one JSON line with the JAX script's keys.  Runs on the
card unless SATMVS_PLATFORM=cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import cli_device

FUSED_ORDER = ("2", "0", "1")  # the reference view first, as the JAX script fuses
FUSED_SCENE = "scene0000"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="satmvs_tpu_torch end-to-end synthetic run")
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--test_scenes", type=int, default=4)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--ndepths", default="32,16,8")
    p.add_argument("--workdir", default=None)
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    return p


def e2e_config(a):
    """The JAX script's Config for these arguments."""
    from ..train.config import Config

    return Config(model="red", geo_model="rpc",
                  ndepths=tuple(int(x) for x in a.ndepths.split(",")),
                  min_interval=2.5, epochs=a.epochs, lr=1e-3,
                  lr_milestones=(max(a.epochs // 2, 1), max(3 * a.epochs // 4, 2)),
                  summary_freq=20, save_freq=max(a.epochs, 1), compute_dtype=a.compute_dtype)


def evaluate(model, cfg, loader) -> dict:
    """`make_eval_step`'s scalars averaged over the loader's batches
    (`DictAverageMeter`), as floats."""
    from ..train.loop import make_eval_step
    from ..train.metrics import DictAverageMeter

    eval_step = make_eval_step(model, tuple(cfg.dlossw), cfg.min_interval)
    meter = DictAverageMeter()
    for batch in loader:
        scalars, _, _ = eval_step(None, batch)
        meter.update({k: float(v) for k, v in scalars.items()})
    return meter.mean()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run generate → train → evaluate → predict → fuse.  Returns the printed
    line's keys plus "timing" (`fit`'s per-epoch steps and seconds),
    "gen_seconds", "workdir" and "depths" (the fused scene's predicted
    height maps, (3, H, W), in the fused order)."""
    from ..data import formats, synthetic
    from ..data.dataset import MVSDataset
    from ..data.loader import Loader, collate, to_device
    from ..infer.fuse import filter_depth_rpc
    from ..train import fit

    a = _parser().parse_args(argv)
    device = cli_device()
    workdir = a.workdir or tempfile.mkdtemp(prefix="satmvs_e2e_")
    troot = os.path.join(workdir, "train")
    eroot = os.path.join(workdir, "test")
    # moderate height range so the shallow cascade can bracket stage 1
    # (h_scale 150 m → a 300 m sweep; stage 2's window ±40 m)
    t0 = time.time()
    synthetic.write_synthetic_dataset(troot, a.scenes, a.size, a.size, seed=0, h_amp=60.0,
                                      h_scale=150.0)
    synthetic.write_synthetic_dataset(eroot, a.test_scenes, a.size, a.size, seed=10_000,
                                      h_amp=60.0, h_scale=150.0)
    gen_s = time.time() - t0
    print(f"[e2e] generated {a.scenes}+{a.test_scenes} scenes in {gen_s:.1f}s")

    cfg = e2e_config(a)
    tl = Loader(MVSDataset(troot, "train", 3, 2), 1, shuffle=True, seed=0, device=device)
    el = Loader(MVSDataset(eroot, "test", 3, 2), 1, device=device)
    t0 = time.time()
    model, _, timing = fit(cfg, tl, el, os.path.join(workdir, "ckpt"))
    train_s = time.time() - t0
    final = evaluate(model, cfg, el)
    print(f"[e2e] trained {a.epochs} epochs in {train_s:.1f}s; test: {final}")

    # fusion: all views of one test scene through the trained model, fused
    # to the reference view and compared with its ground truth
    scene_ds = MVSDataset(eroot, "pred", 3, ref_view=-1)
    view_depths = {}
    with torch.no_grad():
        for i in range(len(scene_ds)):
            s = scene_ds[i]
            if s["out_name"] != FUSED_SCENE:
                continue
            b = to_device(collate([s]), device)
            out = model(b["imgs"], b["cams"], b["depth_values"], train=False)
            view_depths[s["out_view"]] = out["depth"][0].cpu().numpy()
    depths = np.stack([view_depths[v] for v in FUSED_ORDER])
    rpcs = np.stack([formats.load_rpc(os.path.join(eroot, "rpc", v, FUSED_SCENE + ".rpc"))[0]
                     for v in FUSED_ORDER])
    gt = formats.load_pfm(os.path.join(eroot, "height", "2", FUSED_SCENE + ".pfm"))
    mask, fused = filter_depth_rpc(depths, rpcs, p_ratio=2.0, d_ratio=7.5, geo_consist_num=1,
                                   device=device)
    err = np.abs(fused - gt)[mask]
    fused_mae = float(np.mean(err[err < 250])) if err.size else float("nan")
    print(f"[e2e] fusion: valid {mask.mean():.1%}, fused MAE {fused_mae:.2f} m")

    line = {
        "test_mae_m": round(final.get("abs_depth_acc", -1), 3),
        "acc_1.0m": round(final.get("1.0m_acc", -1), 4),
        "acc_2.5m": round(final.get("2.5m_acc", -1), 4),
        "acc_7.5m": round(final.get("7.5m_acc", -1), 4),
        "acc_3interval": round(final.get("3interval_acc", -1), 4),
        "fused_mae_m": round(fused_mae, 3),
        "fusion_valid_frac": round(float(mask.mean()), 4),
        "train_seconds": round(train_s, 1),
        "epochs": a.epochs,
        "scenes": a.scenes,
    }
    print(json.dumps(line))
    return {**line, "timing": timing, "gen_seconds": gen_s, "workdir": workdir,
            "depths": depths}


if __name__ == "__main__":
    main(sys.argv[1:])
