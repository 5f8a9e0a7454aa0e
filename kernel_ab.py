#!/usr/bin/env python3
"""Time the port's ConvGRU adjoint and sweep gather of one checkout on one
CUDA device, to compare two trees (parent, change, change, parent) in one
call.

    python3 kernel_ab.py [--root DIR] [--sweep] [--reps N]

Imports `satmvs_tpu_torch` from DIR (default: the directory of this file),
builds its kernels there, and at every shape a 384×768, B = 1 train step
gives them (chip_smoke.py's shapes, seeds and cells) prints one JSON line
per shape:

  red_recur_backward (TPU kernel row 6: the adjoint kernel and its two
  weight reductions): CUDA events, median of --reps calls; and the adjoint
  kernel `red_recur_bwd_kernel` alone, its device time per call under
  torch.profiler, which reads any tree, whatever its Python API;
  sweep_gather (row 2) at both source views of each stage: its error
  against its plain version, and its time and that of grid_sample
  (bilinear, zero padding) on the same data, each over calls launched
  back to back (chip_smoke.loop_ms) and as the device time of the kernels
  under torch.profiler (a call this short is near the host's launch time).

With --sweep (a tree whose `red_recur._adjoint` takes a plan and whose
gather takes planes a thread) it also times the adjoint at each shape with
each conv's plan replaced in turn by every other (px, wr, wc, wk, ck), the
others kept, and prints the best; and the gather at 1, 2, 4 and 8 planes a
thread.  The last line
sums the shapes.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def device_ms(fn, kernel: str, calls: int) -> float:
    """Device time per call of the kernels whose name holds `kernel`, over
    `calls` calls of fn under torch.profiler (after one warm-up call); a
    capture that holds none of them is taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key)
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError(f"kernel_ab: the profiler saw no {kernel} in three captures")


def sweep_plans(rr, cs, x, out, g, cell, reps: int) -> dict:
    """The adjoint's time with its plan, and per conv the best (px, wr, wc,
    wk, ck) with the other convs' plans kept."""
    b, d, h, w, cin = x.shape
    c = cell.features
    h0 = torch.zeros((b, h, w, c), device="cuda")
    base = rr.red_recur_bwd_plan(b, h, w, cin, c, rr.bwd_resident())
    couts = (2 * c, c, c, c + cin)

    def run(plan):
        return cs.time_ms(lambda: rr._adjoint(x, out, g, cell, h0, plan), reps=reps, warmup=1)

    res = {"plan_ms": run(base), "plan": [[p[k] for k in ("px", "wr", "wc", "wk", "ck")]
                                          for p in base["convs"]], "best": []}
    for i, cout in enumerate(couts):
        best = None
        for px, wc, wk, ck in itertools.product((1, 2), (1, 2, 4, 8), (1, 2, 4, 8), (8, 16, 32, 64)):
            wr = 8 // (wc * wk) if wc * wk <= 8 else 0
            if (not wr or 8 * wc > -(-cout // 8) * 8
                    or rr._NRAW[i] * ck * rr._staged_plane(wr * px, ck) > rr._IN_WORDS
                    or 9 * ck * 8 * wc > rr._W_WORDS):
                continue
            conv = {"px": px, "wr": wr, "wc": wc, "wk": wk, "ck": ck}
            plan = {**base, "convs": [conv if j == i else p for j, p in enumerate(base["convs"])]}
            ms = run(plan)
            if best is None or ms < best[0]:
                best = (ms, [px, wr, wc, wk, ck])
        res["best"].append(best)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is timed")
    ap.add_argument("--sweep", action="store_true", help="time other plans of each conv")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import satmvs_tpu_torch

    if not Path(satmvs_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"satmvs_tpu_torch came from {satmvs_tpu_torch.__file__}, not {root}")
    # this checkout's chip_smoke.py for the shapes, seeds and timers, whatever
    # the tree under test holds
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from satmvs_tpu_torch.ops.kernels import build
    from satmvs_tpu_torch.ops.kernels import red_recur as rr
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    for name, log in build.build_all().items():
        for line in log.splitlines():
            if "Function properties for" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", file=sys.stderr, flush=True)
    tag = {"root": str(root), "card": card}

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    totals = {"row6_ms": 0.0, "adjoint_ms": 0.0, "gather_ms": 0.0, "grid_sample_ms": 0.0,
              "gather_device_ms": 0.0, "grid_sample_device_ms": 0.0}
    for stage, d, h, w, cin in cs.red_shapes():
        for s, ci, c in cs.red_scales(cin):
            cell = cs.red_cell(ci, c, s, randn)
            x = randn(1, d, h // s, w // s, ci)
            with torch.no_grad():
                out = rr.red_recur(x, cell)
            g = randn(*out.shape)
            row6 = cs.time_ms(lambda: rr.red_recur_backward(x, out, g, cell), reps=args.reps)
            adj = device_ms(lambda: rr.red_recur_backward(x, out, g, cell),
                            "red_recur_bwd_kernel", args.reps)
            rec = {**tag, "kernel": "red_recur_backward", "shape": f"{stage} scale{s}",
                   "dhwc": [d, h // s, w // s, ci, c], "row6_ms": row6, "adjoint_ms": adj}
            if args.sweep:
                rec.update(sweep_plans(rr, cs, x, out, g, cell, max(3, args.reps // 3)))
            totals["row6_ms"] += row6
            totals["adjoint_ms"] += adj
            print(json.dumps(rec), flush=True)
            del x, out, g, cell

    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.geo import rpc as rpclib
    from satmvs_tpu_torch.ops import warp

    rpcs = synthetic.make_rpc_triplet(cs.WIDTH, cs.HEIGHT, seed=0)
    rpcs = [rpcs[2], rpcs[0], rpcs[1]]
    import numpy as np

    stage_cams = warp.build_stage_cams(np.stack(rpcs), 0, device="cuda")
    h_min, h_max = rpclib.height_range(rpcs[0])
    ggen = torch.Generator(device="cuda").manual_seed(3)
    for i, (cams, scale, nd, c) in enumerate(zip(stage_cams, cs.STAGE_SCALES, cs.NDEPTHS,
                                                cs.FEAT_CH)):
        h, w = cs.HEIGHT // scale, cs.WIDTH // scale
        depths = torch.linspace(h_min, h_max, nd, device="cuda")
        for v in range(2):
            xs, ys = (t.contiguous() for t in warp.rpc_sweep_coords(cams, v, depths, h, w))
            src = torch.randn((h, w, c), generator=ggen, device="cuda")
            g = torch.randn((nd, h, w, c), generator=ggen, device="cuda")
            err = (sg.sweep_gather(src, xs, ys)
                   - sg.sweep_gather_reference(src, xs, ys)).abs().max().item()
            fwd, _ = cs.grid_sample_calls(src, xs, ys, g)
            k_ms = cs.loop_ms(lambda: sg.sweep_gather(src, xs, ys), 2 * args.reps)
            l_ms = cs.loop_ms(fwd, 2 * args.reps)
            k_dev = device_ms(lambda: sg.sweep_gather(src, xs, ys), "sweep_gather_kernel",
                              args.reps)
            l_dev = device_ms(fwd, "", args.reps)  # every kernel the call launches
            totals["gather_ms"] += k_ms
            totals["grid_sample_ms"] += l_ms
            totals["gather_device_ms"] += k_dev
            totals["grid_sample_device_ms"] += l_dev
            rec = {**tag, "kernel": "sweep_gather", "shape": f"stage{i + 1} view{v}",
                   "dhwc": [nd, h, w, c], "ms": k_ms, "grid_sample_ms": l_ms,
                   "device_ms": k_dev, "grid_sample_device_ms": l_dev, "max_abs_err": err}
            if args.sweep:  # planes a thread walks: 1, 2, 4 and 8
                out = torch.empty((nd, h, w, c), device="cuda")
                rec["planes_ms"] = {p: cs.loop_ms(lambda: sg._launch(
                    "sweep_gather", src, xs, ys, out, nd, h, w, c, p), 2 * args.reps)
                    for p in (1, 2, 4, 8)}
            print(json.dumps(rec), flush=True)
            del xs, ys, src, g, fwd
    print(json.dumps({**tag, "totals": totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
