#!/usr/bin/env python3
"""Time the port's ConvGRU forward and adjoint, its sweep gather, its plane
convs, its cost-volume sweep and that sweep's VJP of one checkout on one
CUDA device, to compare two trees (parent, change, change, parent) in one
call.

    python3 kernel_ab.py [--root DIR] [--sweep] [--reps N]
                         [--only {all,red_recur,gather,plane,sweep,sweep_vjp} ...]
                         [--vjp_dir DIR]

Imports `satmvs_tpu_torch` from DIR (default: the directory of this file),
builds its kernels there, and at every shape a 384×768, B = 1 train step
gives them (chip_smoke.py's shapes, seeds and cells) prints one JSON line
per shape:

  red_recur (TPU kernel row 4): CUDA events, median of --reps calls, and
  the forward kernel `red_recur_kernel`'s device time per call under
  torch.profiler; the same for row 5 at the 12 shapes of a 4-tile scene
  chunk (B = 4 tiles of 448², 8-plane slabs, seeded start states), with the
  chunk's calls of each shape;
  red_recur_backward (TPU kernel row 6: the adjoint kernel and its two
  weight reductions): CUDA events, median of --reps calls; and the adjoint
  kernel `red_recur_bwd_kernel` alone, its device time per call under
  torch.profiler, which reads any tree, whatever its Python API;
  both with "digest", the first 16 hex digits of the sha256 of the
  outputs' bytes (the states; dx and every parameter's cotangent), so two
  trees that compute the same bits print the same digests;
  sweep_gather (row 2) at both source views of each stage: its error
  against its plain version, the `digest` of its output, and its time and
  that of grid_sample
  (bilinear, zero padding) on the same data, each over calls launched
  back to back (chip_smoke.loop_ms) and as the device time of the kernels
  under torch.profiler (a call this short is near the host's launch time);
  at the same shapes the fp32 sweep_scatter (row 3), the bf16 gather
  (row "2, bf16", with the `digest` of its output) and the bf16 scatter
  (row "3, bf16", its error against its plain version and its run-to-run
  difference, each beside the summation bound, and where the tree has
  them the blocks outside its shared-memory window): back to back, device
  time of the kernels under torch.profiler by names that read either
  tree's design (chip_smoke.bf16_kernel), and the wrapper's host time a
  call (chip_smoke.launch_host_ms);
  plane_conv (rows 8, 10, 12 and the dx of rows 9, 11, 13) at the 21
  forward and 21 dx calls of `chip_smoke.plane_calls()`: CUDA events
  (median of --reps calls of the wrapper a user calls; a dx through the
  launch its backward makes), back to back, the device time of the kernels
  whose names hold conv3x3 or deconv3x3 (so it reads the parent's tree
  too), cuDNN's call for the same function (a dx: the input gradient alone)
  by events and device time, the kernel's error against cuDNN's result,
  and the bound;
  sweep_variance (row 1) at the three sweeps of a 384×768 forward (B = 1:
  stage 1 uniform, stages 2-3 windows around a seeded previous depth) and
  of a 4-tile scene chunk (B = 4 tiles of 448², one 8-plane slab a stage,
  with the chunk's calls of each) and of the three stages at B = 2 with 6
  and 8 views (where the tree's kernel takes more than four source views),
  through `sweep_variance_batched` where
  the tree has it, else one `sweep_variance` call a tile: CUDA events, back
  to back, the device time of the kernels whose names hold sweep_variance,
  the bound and the error against the plain version;
  sweep_vjp (row "1, backward": the fused sweep's VJP) at the three stage
  shapes of a 384×768 train step (B = 1, S = 2, as chip_smoke.py's phase 11
  (c) draws them; their sums in the totals), at stage 2 with five source
  views (the kernel's form past four) and on the band of stage 3's
  reference rows 192..383 (the source views whole), through the entry every
  tree has,
  torch.autograd.grad of `sweep_variance_batched` (the graph built once):
  CUDA events (median of --reps calls), back to back, the device time of
  the kernels the backward launches (names that start with
  sweep_variance_backward or sweep_scatter, fp32), the `digest` of dref,
  and dsrcs against the first run's, saved under --vjp_dir: the greatest
  difference beside the greatest summation bound (chip_smoke.summation_bound)
  and whether every element is within its bound.  Empty --vjp_dir before
  the first run of a comparison.

With --sweep (a tree whose `red_recur._launch` and `red_recur._adjoint`
take a plan, whose gather takes planes a thread and whose plane convs take
a `plane_conv_plan`) it also times the forward and the adjoint at each
train-step shape with each conv's plan replaced in turn by every other
(px, wr, wc, wk, ck), the others kept, and prints the best; the gather at
1, 2, 4 and 8 planes a thread, the bf16 gather at 2, 4, 8 and 16, and the
bf16 scatter under window plans of 2 to 32 planes a block and budgets of
6144 and SCATTER_WINDOW ints (where the tree has `scatter_window_plan`); each plane conv under every option of
`plane_conv_plan_options` (slab, tile, threads, chunk), back to back; and
the sweep under every option of `sweep_variance_plan_options`.  The
last line sums the shapes.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()[:16]


def sweep_plans(rr, cs, base: dict, run, couts, reps: int) -> dict:
    """The time of run(plan) under `base`, and per conv the best (px, wr, wc,
    wk, ck) with the other convs' plans kept."""
    keys = rr._PLAN_KEYS
    res = {"plan_ms": cs.time_ms(lambda: run(base), reps=reps, warmup=1),
           "plan": [[p[k] for k in keys] for p in base["convs"]], "best": []}
    for i, cout in enumerate(couts):
        best = None
        for conv in rr.conv_plan_options(cout, rr._NRAW[i]):
            plan = {**base, "convs": [conv if j == i else p for j, p in enumerate(base["convs"])]}
            ms = cs.time_ms(lambda: run(plan), reps=reps, warmup=1)
            if best is None or ms < best[0]:
                best = (ms, [conv[k] for k in keys])
        res["best"].append(best)
    return res


def plane_case(cs, pc, randn, call):
    """Seeded operands of one call of `cs.plane_calls()`: returns the call
    through the wrapper a user calls (the public forward; a dx as its
    backward launches it), the same launch under a given plan (None: the
    tree's own), and cuDNN's call for the same function (a dx: the input
    gradient alone, `aten.convolution_backward`)."""
    import torch.nn.functional as F

    _, op, stride, transposed, n, h, w, cin, cout, gated = call
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    x = randn(n, h, w, cin)
    gate = randn(n, h, w, cin) if gated else None  # a random sign: about half masked
    dz = None if gate is None else torch.where(gate > 0, x, torch.zeros_like(x))
    with_plan = lambda f, *a: (lambda plan=None: f(*a) if plan is None else f(*a, plan))  # noqa

    def grad_in(wt, shape, transposed_, op_pad):
        out = x.new_empty(shape)
        return lambda: torch.ops.aten.convolution_backward(
            nchw(dz if dz is not None else x), nchw(out), wt, None, [stride] * 2, [1, 1], [1, 1],
            transposed_, [op_pad] * 2, 1, [True, False, False])

    if op == "conv_dn":
        wt = randn(cout, cin, 3, 3, scale=(2.0 / (9 * cin)) ** 0.5)
        wk = wt.permute(2, 3, 1, 0).contiguous()
        return (lambda: pc.conv_dn(x, wt),
                with_plan(pc._conv3x3, op, x, None, wk, None, 2, True),
                lambda: F.relu(F.conv2d(nchw(x), wt, stride=2, padding=1)))
    if op == "conv_dn dx":  # the forward's weight (Cin_f = cout, Cout_f = cin)
        wt = randn(cin, cout, 3, 3, scale=(2.0 / (9 * cout)) ** 0.5)
        run = with_plan(pc._deconv3x3, op, x, gate, wt.permute(2, 3, 0, 1).contiguous(), None,
                        None, False)
        return run, run, grad_in(wt, (n, 2 * h, 2 * w, cout), False, 0)
    if op == "deconv_up":
        wt = randn(cin, cout, 3, 3, scale=(2.0 / (9 * cin)) ** 0.5)
        skip = randn(n, 2 * h, 2 * w, cout)
        return (lambda: pc.deconv_up(x, wt, skip),
                with_plan(pc._deconv3x3, op, x, None, wt.permute(2, 3, 0, 1).contiguous(), skip,
                          None, True),
                lambda: F.relu(F.conv_transpose2d(nchw(x), wt, stride=2, padding=1,
                                                  output_padding=1)) + nchw(skip))
    if op == "deconv_up dx":  # the forward's weight (Cin_f = cout, Cout_f = cin)
        wt = randn(cout, cin, 3, 3, scale=(2.0 / (9 * cout)) ** 0.5)
        run = with_plan(pc._conv3x3, op, x, gate, wt.permute(2, 3, 1, 0).contiguous(), None, 2,
                        False)
        return run, run, grad_in(wt, (n, h // 2, w // 2, cout), True, 1)
    if op == "conv_head":
        wt, bias = randn(cout, cin, 3, 3, scale=(2.0 / (9 * cin)) ** 0.5), randn(cout)
        return (lambda: pc.conv_head(x, wt, bias),
                with_plan(pc._conv3x3, op, x, None, wt.permute(2, 3, 1, 0).contiguous(), bias, 1,
                          False),
                lambda: F.conv2d(nchw(x), wt, bias, padding=1))
    assert op == "conv_head dx"  # the forward's weight (Cout_f = cin = 1, Cin_f = cout)
    wt = randn(cin, cout, 3, 3, scale=(2.0 / (9 * cout)) ** 0.5)
    run = with_plan(pc._conv3x3, op, x, None, wt.flip(2, 3).permute(2, 3, 0, 1).contiguous(),
                    None, 1, False)
    return run, run, grad_in(wt, (n, h, w, cout), False, 0)


def time_plane(cs, randn, args, tag: dict, totals: dict):
    """The plane convs at every forward and dx call of a 384×768 train step
    (`cs.plane_calls()`): events (median of --reps calls, and back to back),
    the device time of the kernels whose names hold conv3x3 / deconv3x3
    (torch.profiler: it reads any tree), cuDNN's call beside them, and the
    bound; with --sweep every plan of `plane_conv_plan_options`, back to
    back, and the best."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    for key in ("plane_fwd_ms", "plane_fwd_device_ms", "plane_fwd_cudnn_ms", "plane_dx_ms",
                "plane_dx_device_ms", "plane_dx_cudnn_ms", "plane_fwd_bound_ms",
                "plane_dx_bound_ms"):
        totals[key] = 0.0
    for call in cs.plane_calls():
        label, op, stride, transposed, n, h, w, cin, cout, gated = call
        user, planned, library = plane_case(cs, pc, randn, call)
        pick = (lambda k: "deconv3x3" in k) if transposed else cs.conv3x3_kernel_name
        with torch.no_grad():
            lib = library()
            lib = lib[0] if isinstance(lib, tuple) else lib
            err = (planned().permute(0, 3, 1, 2) - lib).abs().max().item()
            del lib
            rec = {**tag, "kernel": "plane_conv", "op": op, "shape": label, "cudnn_err": err,
                   "nhwc": [n, h, w, cin, cout], "ms": cs.time_ms(user, reps=args.reps),
                   "loop_ms": cs.loop_ms(lambda: planned(), 2 * args.reps),
                   "device_ms": cs.device_ms(user, pick, args.reps),
                   "cudnn_ms": cs.time_ms(library, reps=args.reps),
                   "cudnn_device_ms": cs.device_ms(library, "", args.reps)}
            rec["bound_ms"], rec["bound_by"] = cs.bound_ms(*cs.plane_work(*call[1:]))
            if args.sweep:
                plan = pc.plane_conv_plan(stride, transposed, n, h, w, cin, cout, gated)
                keys = ("slab", "tx", "ty", "ck", "threads")
                rec["plan"] = [plan[k] for k in keys]
                rec["plan_ms"] = cs.loop_ms(lambda: planned(plan), args.reps)
                rec["sweep"] = [[cs.loop_ms(lambda: planned(o), args.reps), *(o[k] for k in keys)]
                                for o in pc.plane_conv_plan_options(stride, transposed, cin, cout,
                                                                    gated)]
                rec["best"] = min(rec["sweep"])
        part = "dx" if op.endswith("dx") else "fwd"
        for key, val in (("ms", rec["ms"]), ("device_ms", rec["device_ms"]),
                         ("cudnn_ms", rec["cudnn_ms"]), ("bound_ms", rec["bound_ms"])):
            totals[f"plane_{part}_{key}"] += val
        print(json.dumps(rec), flush=True)
        del user, planned, library


def time_sweep(cs, args, tag: dict, totals: dict):
    """Row 1 (sweep_variance) at the three sweeps of a 384×768 forward, the
    three of a 4-tile scene chunk and the three stages with 6 and 8 views
    (`cs.sweep_cases`, B = 4 and 2 through the batched entry where the tree
    has one, else one call a tile; the 6- and 8-view cases only on a tree
    whose kernel takes more than four source views): CUDA events
    (median of --reps calls), back to back, the device time of the kernels
    whose names hold sweep_variance (so it reads the parent's tree too), the
    bound and the error against the plain version; with --sweep every plan
    of `sweep_variance_plan_options`, back to back."""
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    batched = getattr(sv, "sweep_variance_batched", None)
    many_views = not hasattr(sv, "SWEEP_MAX_VIEWS")  # trees before it took S > 4 had the limit
    for path in ("forward", "chunk", "views"):
        for key in ("ms", "loop_ms", "device_ms", "bound_ms"):
            totals[f"sweep_{path}_{key}"] = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, feats, xs, ys, path, calls in cs.sweep_cases(gen, checks=False):
        b, n_src, d, h, w = xs.shape
        if path == "views" and not many_views:
            continue
        calls = calls or 1  # a views case stands alone

        def run():
            if batched is not None:
                return batched(feats, xs, ys)
            return torch.stack([sv.sweep_variance(feats[i, 0], feats[i, 1:], xs[i], ys[i])
                                for i in range(b)])
        with torch.no_grad():
            want = torch.stack([sv.sweep_variance_reference(feats[i, 0], feats[i, 1:], xs[i],
                                                            ys[i]) for i in range(b)])
            err = (run() - want).abs().max().item()
            del want
            rec = {**tag, "kernel": "sweep_variance", "path": path, "shape": label,
                   "bsdhwc": [b, n_src, d, h, w, feats.shape[-1]], "calls": calls,
                   "entry": "sweep_variance_batched" if batched else f"{b} x sweep_variance",
                   "max_abs_err": err, "ms": cs.time_ms(run, reps=args.reps),
                   "loop_ms": cs.loop_ms(run, 2 * args.reps),
                   "device_ms": cs.device_ms(run, "sweep_variance", args.reps)}
            rec["bound_ms"], rec["bound_by"] = cs.bound_ms(*cs.sweep_work(feats, xs, ys))
            if args.sweep and batched is not None:
                plan = sv.sweep_variance_plan(b, n_src, d, h, w, feats.shape[-1])
                keys = ("tx", "ty", "planes", "threads")
                rec["plan"] = [plan[k] for k in keys]
                rec["sweep"] = sorted(
                    [cs.loop_ms(lambda: sv._batched(feats, xs, ys, o), args.reps),
                     *(o[k] for k in keys)]
                    for o in sv.sweep_variance_plan_options(b, n_src, d, h, w, feats.shape[-1]))
        for key in ("ms", "loop_ms", "device_ms", "bound_ms"):
            totals[f"sweep_{path}_{key}"] += calls * rec[key]
        print(json.dumps(rec), flush=True)
        del run


def vjp_kernel(key: str) -> bool:
    """A profiler key of the kernels the fused sweep's backward launches in
    either design: sweep_variance_backward*_kernel, and the fp32
    sweep_scatter_kernel the composed pair launched."""
    return re.search(r"\b(sweep_variance_backward\w*|sweep_scatter)_kernel\b", key) is not None


def time_sweep_vjp(cs, args, tag: dict, totals: dict):
    """Row "1, backward" at the three stage shapes of a 384×768 train step,
    at five source views and on a band of reference rows (module
    docstring): one record a case, the step's sums in totals."""
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    save = Path(args.vjp_dir)
    save.mkdir(parents=True, exist_ok=True)
    for key in ("ms", "loop_ms", "device_ms", "bound_ms"):
        totals[f"sweep_vjp_{key}"] = 0.0
    gen = torch.Generator(device="cuda").manual_seed(11)
    # (label, stage, source views + 1, first reference row of the band)
    cases = [("stage1", 0, 3, 0), ("stage2", 1, 3, 0), ("stage3", 2, 3, 0),
             ("stage2 S=5", 1, 6, 0), ("stage3 band", 2, 3, cs.HEIGHT // 2)]
    for label, i, views, row0 in cases:
        h, w = cs.HEIGHT // cs.STAGE_SCALES[i], cs.WIDTH // cs.STAGE_SCALES[i]
        feats, xs, ys = cs.sweep_inputs(i, 1, h, w, gen, views=views)
        band = slice(row0 * h // cs.HEIGHT, h)  # the band's rows at this stage's scale
        xs, ys = xs[..., band, :].contiguous(), ys[..., band, :].contiguous()
        g = torch.randn((1, cs.NDEPTHS[i], xs.shape[3], w, cs.FEAT_CH[i]), generator=gen,
                        device="cuda")
        f = feats.clone().requires_grad_(True)
        out = sv.sweep_variance_batched(f, xs, ys, band.start)

        def run():
            return torch.autograd.grad(out, f, g, retain_graph=True)[0]
        grad = run()
        dref, dsrcs = grad[:, 0, band], grad[:, 1:]
        rec = {**tag, "kernel": "sweep_vjp", "shape": label, "bsdhwc": list(xs.shape) + [
            feats.shape[-1]], "ms": cs.time_ms(run, reps=args.reps),
            "loop_ms": cs.loop_ms(run, 2 * args.reps),
            "device_ms": cs.device_ms(run, vjp_kernel, args.reps), "digest": digest(dref)}
        if band.start == 0:
            rec["bound_ms"], rec["bound_by"] = cs.bound_ms(*cs.sweep_backward_work(feats, xs, ys))
        first = save / f"{label.replace(' ', '_')}.pt"
        if first.is_file():
            was = torch.load(first, map_location=dsrcs.device)
            bound = cs.summation_bound(sv._backward_reference(
                feats[:, 0, band], feats[:, 1:], xs, ys, g)[0], xs, ys, h)
            diff = (dsrcs - was["dsrcs"]).abs()
            rec.update({"first_root": was["root"], "dsrcs_vs_first": diff.max().item(),
                        "bound": bound.max().item(),
                        "within_bound": bool((diff <= bound + 1e-30).all())})
        else:
            torch.save({"root": tag["root"], "dsrcs": dsrcs.detach().cpu()}, first)
        if label.startswith("stage") and " " not in label:
            for key in ("ms", "loop_ms", "device_ms", "bound_ms"):
                totals[f"sweep_vjp_{key}"] += rec[key]
        print(json.dumps(rec), flush=True)
        del feats, xs, ys, g, f, out, grad, dref, dsrcs, run


def time_sweep_pair(cs, sg, args, src, xs, ys, g) -> list[dict]:
    """The fp32 scatter and the bf16 pair at one shape (module docstring):
    one record each."""
    d, h, w = xs.shape
    c = src.shape[-1]
    gb = g.to(torch.bfloat16)
    tol = 2 * (4 * d - 1) * 2.0 ** -24 * sg.sweep_scatter_reference(
        gb.abs(), xs, ys, h, w).max().item()
    recs = []
    for kernel, fn, pick in (
            ("sweep_scatter", lambda: sg.sweep_scatter(g, xs, ys),
             lambda k: "sweep_scatter_kernel" in k and "unsigned short" not in k),
            ("sweep_gather_bf16", lambda: sg.sweep_gather(src, xs, ys, torch.bfloat16),
             cs.bf16_kernel("sweep_gather")),
            ("sweep_scatter_bf16", lambda: sg.sweep_scatter(gb, xs, ys),
             cs.bf16_kernel("sweep_scatter"))):
        rec = {"kernel": kernel, "ms": cs.loop_ms(fn, 2 * args.reps),
               "device_ms": cs.device_ms(fn, pick, args.reps), "host_ms": cs.launch_host_ms(fn)}
        if kernel == "sweep_gather_bf16":
            rec["digest"] = digest(fn())
            want = sg.sweep_gather_reference(src, xs, ys, torch.bfloat16).float()
            rec["max_abs_err"] = (fn().float() - want).abs().max().item()
            if args.sweep:
                out = torch.empty((d, h, w, c), dtype=torch.bfloat16, device="cuda")
                rec["planes_ms"] = {p: cs.loop_ms(lambda: sg._launch(
                    "sweep_gather", src, xs, ys, out, d, h, w, c, p), 2 * args.reps)
                    for p in (2, 4, 8, 16)}
        elif kernel == "sweep_scatter_bf16":
            rec["bound"] = tol
            rec["max_abs_err"] = (fn() - sg.sweep_scatter_reference(
                gb, xs, ys, h, w)).abs().max().item()
            rec["run_to_run"] = (fn() - fn()).abs().max().item()
            if hasattr(sg, "window_blocks"):
                before = sg.window_blocks("cuda").clone()
                fn()
                rec["blocks"], rec["outside"] = (sg.window_blocks("cuda") - before).tolist()
            if args.sweep and hasattr(sg, "scatter_window_plan"):
                dsrc = torch.zeros((h, w, c), device="cuda")
                rec["plans_ms"] = {
                    f"{p} planes, {b} ints": cs.loop_ms(lambda: sg._launch_window(
                        gb, xs, ys, dsrc, sg.scatter_window_plan(d, h, w, c, planes=p,
                                                                 budget=b), h),
                        2 * args.reps)
                    for p in (2, 4, 8, 16, 32) if p <= d for b in (6144, sg.SCATTER_WINDOW)}
        recs.append(rec)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is timed")
    ap.add_argument("--sweep", action="store_true", help="time other plans of each conv")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", nargs="+", default=["all"],
                    choices=("all", "red_recur", "gather", "plane", "sweep", "sweep_vjp"),
                    help="time only these kernels")
    ap.add_argument("--vjp_dir", default=str(HERE / "build" / "kernel_ab_vjp"),
                    help="where sweep_vjp keeps the first run's dsrcs")
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

    totals = {"row4_ms": 0.0, "forward_device_ms": 0.0, "row5_chunk_ms": 0.0,
              "row5_chunk_device_ms": 0.0, "row6_ms": 0.0, "adjoint_ms": 0.0, "gather_ms": 0.0,
              "grid_sample_ms": 0.0, "gather_device_ms": 0.0, "grid_sample_device_ms": 0.0}
    sweep_reps = max(3, args.reps // 3)
    only = set(args.only)
    if only & {"all", "red_recur"}:
        # the forward: row 4 at the train step's shapes (B = 1), row 5 at a scene
        # chunk's (B tiles, slabs of SLAB planes, seeded), with its calls a chunk
        cases = [(f"{stage} scale{s}", 1, d, h // s, w // s, ci, c, 1)
                 for stage, d, h, w, cin in cs.red_shapes() for s, ci, c in cs.red_scales(cin)]
        cases += [(f"chunk stage{i + 1} scale{s}", cs.BATCH_TILES, cs.SLAB,
                   cs.TILE_HW // scale // s, cs.TILE_HW // scale // s, ci, c, n_slabs)
                  for i, (scale, cin, n_slabs) in enumerate(zip(cs.STAGE_SCALES, cs.FEAT_CH,
                                                                cs.SLABS_PER_TILE))
                  for s, ci, c in cs.red_scales(cin)]
        with torch.no_grad():
            for label, b, d, h, w, ci, c, calls in cases:
                cell = cs.red_cell(ci, c, 20 + c, randn)
                x = randn(b, d, h, w, ci)
                h0 = torch.tanh(randn(b, h, w, c)) if b > 1 else None
                ms = cs.time_ms(lambda: rr.red_recur(x, cell, h0), reps=args.reps)
                dev = cs.device_ms(lambda: rr.red_recur(x, cell, h0), "red_recur_kernel", args.reps)
                row = "row5" if b > 1 else "row4"
                rec = {**tag, "kernel": "red_recur", "row": row, "shape": label,
                       "bdhwc": [b, d, h, w, ci, c], "ms": ms, "device_ms": dev, "calls": calls,
                       "digest": digest(rr.red_recur(x, cell, h0))}
                if b > 1:
                    totals["row5_chunk_ms"] += calls * ms
                    totals["row5_chunk_device_ms"] += calls * dev
                else:
                    totals["row4_ms"] += ms
                    totals["forward_device_ms"] += dev
                    if args.sweep:
                        base = rr.red_recur_plan(b, h, w, ci, c, rr.resident())
                        rec.update(sweep_plans(rr, cs, base,
                                               lambda plan: rr._launch(x, cell, h0, plan),
                                               (2 * c, c), sweep_reps))
                print(json.dumps(rec), flush=True)
                del x, h0, cell

        for stage, d, h, w, cin in cs.red_shapes():
            for s, ci, c in cs.red_scales(cin):
                cell = cs.red_cell(ci, c, s, randn)
                x = randn(1, d, h // s, w // s, ci)
                with torch.no_grad():
                    out = rr.red_recur(x, cell)
                g = randn(*out.shape)
                row6 = cs.time_ms(lambda: rr.red_recur_backward(x, out, g, cell), reps=args.reps)
                adj = cs.device_ms(lambda: rr.red_recur_backward(x, out, g, cell),
                                "red_recur_bwd_kernel", args.reps)
                dx, dps = rr.red_recur_backward(x, out, g, cell)
                rec = {**tag, "kernel": "red_recur_backward", "shape": f"{stage} scale{s}",
                       "dhwc": [d, h // s, w // s, ci, c], "row6_ms": row6, "adjoint_ms": adj,
                       "digest": digest(dx, *dps)}
                if args.sweep:
                    h0 = torch.zeros((1, h // s, w // s, c), device="cuda")
                    base = rr.red_recur_bwd_plan(1, h // s, w // s, ci, c, rr.resident())
                    rec.update(sweep_plans(rr, cs, base,
                                           lambda plan: rr._adjoint(x, out, g, cell, h0, plan),
                                           (2 * c, c, c, c + ci), sweep_reps))
                totals["row6_ms"] += row6
                totals["adjoint_ms"] += adj
                print(json.dumps(rec), flush=True)
                del x, out, g, cell

    if only & {"all", "gather"}:
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
                k_dev = cs.device_ms(lambda: sg.sweep_gather(src, xs, ys), "sweep_gather_kernel",
                                  args.reps)
                l_dev = cs.device_ms(fwd, "", args.reps)  # every kernel the call launches
                totals["gather_ms"] += k_ms
                totals["grid_sample_ms"] += l_ms
                totals["gather_device_ms"] += k_dev
                totals["grid_sample_device_ms"] += l_dev
                shape = f"stage{i + 1} view{v}"
                rec = {**tag, "kernel": "sweep_gather", "shape": shape,
                       "dhwc": [nd, h, w, c], "ms": k_ms, "grid_sample_ms": l_ms,
                       "device_ms": k_dev, "grid_sample_device_ms": l_dev, "max_abs_err": err,
                       "digest": digest(sg.sweep_gather(src, xs, ys))}
                if args.sweep:  # planes a thread walks: 1, 2, 4 and 8
                    out = torch.empty((nd, h, w, c), device="cuda")
                    rec["planes_ms"] = {p: cs.loop_ms(lambda: sg._launch(
                        "sweep_gather", src, xs, ys, out, nd, h, w, c, p), 2 * args.reps)
                        for p in (1, 2, 4, 8)}
                print(json.dumps(rec), flush=True)
                for rec in time_sweep_pair(cs, sg, args, src, xs, ys, g):
                    rec = {**tag, "shape": shape, "dhwc": [nd, h, w, c], **rec}
                    for key in ("ms", "device_ms", "host_ms"):
                        totals[f"{rec['kernel']}_{key}"] = (
                            totals.get(f"{rec['kernel']}_{key}", 0.0) + rec[key])
                    print(json.dumps(rec), flush=True)
                del xs, ys, src, g, fwd
    if only & {"all", "plane"}:
        time_plane(cs, randn, args, tag, totals)
    if only & {"all", "sweep"}:
        time_sweep(cs, args, tag, totals)
    if only & {"all", "sweep_vjp"}:
        time_sweep_vjp(cs, args, tag, totals)
    print(json.dumps({**tag, "totals": totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
