#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one GPU and check it.

    python3 chip_smoke.py        (from the repository root, one CUDA device)

Phases, each reported on its own lines:
  0  setup: TF32 off for matmuls and cuDNN, the card's name and power limit;
  1  build: every CUDA source of satmvs_tpu_torch/csrc with nvcc (sm_90a);
  2  each kernel against its plain PyTorch version on the card, at every
     shape the main path gives it (sweep_variance also with coordinates
     pushed off the image, red_recur also from a non-zero start state);
     kernel, plain and library times (CUDA events, median after warm-up)
     beside the least time the card could take (bound);
  3  the slice: CascadeREDNet (RPC, ndepths 64/32/8, 384×768, seeded
     weights, the fused RED regularizer) predicts three synthetic scenes;
     every kernel of the path must have launched exactly as often as one
     forward launches it, times three; outputs are checked for range and held
     against the same model's plain run on the CPU; forward time, peak
     memory and a profile.

Ends with a JSON line of per-kernel numbers, the nvidia-smi line of the
card, and {"ok": true, "device": ...} as the last line.  Any failed check
raises, and the script exits non-zero without those last lines.  Without a
CUDA device, or without the rest of the repository beside it, it fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM, float32 outside the tensor cores
HEIGHT, WIDTH = 384, 768    # bench.py's flagship patch
NDEPTHS = (64, 32, 8)
STAGE_SCALES = (4, 2, 1)
SEEDS = (0, 1, 2)
FEAT_CH = (32, 16, 8)       # FeatureNet channels per stage, coarsest first
RED_BASE = 8
KERNEL_TOL = 1e-5           # × max(1, max |plain|): a few fp32 ulps of the sums
# red_recur vs its plain version, on states in (-1, 1) over all D planes:
# GroupNorm statistics in float64 (kernel) vs torch's fp32 moments (plain)
RED_RECUR_TOL = 1e-4
# GPU vs CPU plain run per stage, × the stage's hypothesis step.  Quantiles,
# not the maximum: with random weights and heads ×40 the RED recurrence is sensitive
# to summation order (over 64 planes the logit error grows ~20×, as for a
# 1e-6 input perturbation on the CPU), and near-tie pixels of the peaked
# softmax move by a large share of a step.
DEPTH_TOL_MEAN = 0.01
DEPTH_TOL_P99 = 0.1


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the HBM rate or fp32 operations
    over the fp32 rate, whichever is larger, and which one that is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def conv_taps(n_in: int, n_out: int, stride: int) -> int:
    """(output, tap) pairs of a 3-tap, pad-1 conv along one axis that fall
    inside the input: the multiply-adds this axis contributes."""
    return sum(1 for o in range(n_out) for k in range(3) if 0 <= o * stride + k - 1 < n_in)


class KernelReport:
    """Checks one kernel against its plain version at each shape and sums
    its times over the shapes of one forward."""

    def __init__(self, name: str, source: str, replaces: str, card: str):
        self.card = card
        self.rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": None}
        self.by = {"bytes": 0.0, "operations": 0.0}

    def case(self, label: str, kernel, plain, tol, nbytes: float, flops: float,
             library=None, timed: bool = True):
        """tol(plain result): the largest abs error allowed; library: one
        PyTorch call that computes the same function, timed as a yardstick."""
        name = self.rec["name"]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        tol = tol(want)
        err = (got - want).abs().max().item()
        print(f"[kernels] {name} {label} out={tuple(got.shape)} max_abs_err={err:.3e} "
              f"tol={tol:.3e}", flush=True)
        check(got.shape == want.shape, f"{name} {label}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
        check(err <= tol, f"{name} {label}: max abs err {err} > {tol}")
        self.rec["max_abs_err"] = max(self.rec["max_abs_err"], err)
        del got, want
        if not timed:
            return
        k_ms, p_ms = time_ms(kernel, reps=10), time_ms(plain, reps=5, warmup=1)
        l_ms = time_ms(library, reps=10) if library is not None else None
        b_ms, by = bound_ms(nbytes, flops)
        self.rec["ms"] += k_ms
        self.rec["plain_ms"] += p_ms
        self.rec["bound_ms"] += b_ms
        self.by[by] += b_ms
        if l_ms is not None:
            self.rec["library_ms"] = (self.rec["library_ms"] or 0.0) + l_ms
        lib = f"{l_ms:.4f}" if l_ms is not None else "null"
        print(f"[kernels] {name} {label} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({by}, {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP) kernel/bound={k_ms / b_ms:.2f} card={self.card}",
              flush=True)

    def record(self) -> dict:
        self.rec["bound_by"] = max(self.by, key=self.by.get)
        return self.rec


def sweep_work(ref, srcs, xs, ys) -> tuple[float, float]:
    """Bytes (output written once, coords and features read once) and flops
    (valid bilinear taps only) of one sweep_variance on this data."""
    n_src, d, h, w = xs.shape
    c = ref.shape[-1]
    nbytes = 4 * (d * h * w * c + 2 * xs.numel() + ref.numel() + srcs.numel())
    x0, y0 = torch.floor(xs), torch.floor(ys)
    taps = sum(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)).sum().item()
               for dx in (0, 1) for dy in (0, 1))
    return nbytes, c * (2 * taps + d * h * w * (3 * n_src + 7))


def rel_tol(want) -> float:
    """KERNEL_TOL × max(1, max |plain|): fp32 sums in another order."""
    return KERNEL_TOL * max(1.0, want.abs().max().item())


def phase_sweep(card: str) -> dict:
    """Phase 2: sweep_variance against its plain version at the stage shapes."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.geo import rpc as rpclib
    from satmvs_tpu_torch.ops import warp
    from satmvs_tpu_torch.ops.kernels.sweep_variance import (
        sweep_variance, sweep_variance_reference)

    rpcs = synthetic.make_rpc_triplet(WIDTH, HEIGHT, seed=0)
    rpcs = np.stack([rpcs[2], rpcs[0], rpcs[1]])  # nadir reference first
    stage_cams = warp.build_stage_cams(rpcs, 0, device="cuda")
    h_min, h_max = rpclib.height_range(rpcs[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for i, (cams, scale, nd, c) in enumerate(zip(stage_cams, STAGE_SCALES, NDEPTHS, FEAT_CH)):
        h, w = HEIGHT // scale, WIDTH // scale
        depths = torch.linspace(h_min, h_max, nd, device="cuda")
        coords = [warp.rpc_sweep_coords(cams, s, depths, h, w) for s in range(2)]
        xs = torch.stack([q[0] for q in coords]).contiguous()
        ys = torch.stack([q[1] for q in coords]).contiguous()
        ref = torch.randn((h, w, c), generator=gen, device="cuda")
        srcs = torch.randn((2, h, w, c), generator=gen, device="cuda")
        cases.append((f"stage{i + 1}", ref, srcs, xs, ys))
    # stage-1 shapes with coordinates pushed off the image on every side,
    # some far off (exercises zero padding and the pre-cast clamp)
    _, ref, srcs, xs, ys = cases[0]
    h, w = ref.shape[:2]
    xs_off = xs * 1.5 - 0.25 * w
    ys_off = ys * 1.5 - 0.25 * h
    xs_off.view(-1)[::97] = 1e9
    ys_off.view(-1)[::89] = -1e9
    cases.append(("off-image", ref, srcs, xs_off, ys_off))

    rep = KernelReport("sweep_variance", "satmvs_tpu_torch/csrc/sweep_variance.cu",
                       "satmvs_tpu/ops/pallas/sweep_variance.py:130", card)
    for name, ref, srcs, xs, ys in cases:
        # library_ms stays null: no single PyTorch call computes warp +
        # variance (grid_sample per view plus the moments is a composition)
        rep.case(name, lambda: sweep_variance(ref, srcs, xs, ys),
                 lambda: sweep_variance_reference(ref, srcs, xs, ys), rel_tol,
                 *sweep_work(ref, srcs, xs, ys), timed=name != "off-image")
    return rep.record()


def red_shapes():
    """Per stage (name, D, h, w, Cin) of the cost volume the regularizer gets."""
    return [(f"stage{i + 1}", nd, HEIGHT // s, WIDTH // s, c)
            for i, (nd, s, c) in enumerate(zip(NDEPTHS, STAGE_SCALES, FEAT_CH))]


def phase_red_kernels(card: str) -> list[dict]:
    """Phase 2: the four RED kernels against their plain versions at every
    shape one forward gives them (base 8: channels 16/32/64 down the
    encoder), with seeded inputs and weights."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.nn.blocks import ConvGRUCell
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc
    from satmvs_tpu_torch.ops.kernels import red_recur as rr
    from satmvs_tpu_torch.params import init_from_seed

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    b = RED_BASE
    dn = KernelReport("conv_dn", "satmvs_tpu_torch/csrc/plane_conv.cu",
                      "satmvs_tpu/ops/pallas/plane_conv.py:382", card)
    up = KernelReport("deconv_up", "satmvs_tpu_torch/csrc/plane_conv.cu",
                      "satmvs_tpu/ops/pallas/plane_conv.py:569", card)
    head = KernelReport("conv_head", "satmvs_tpu_torch/csrc/plane_conv.cu",
                        "satmvs_tpu/ops/pallas/plane_conv.py:730", card)
    rec = KernelReport("red_recur", "satmvs_tpu_torch/csrc/red_recur.cu",
                       "satmvs_tpu/ops/pallas/red_recur.py:259", card)
    for stage, d, h, w, cin in red_shapes():
        # encoder: (h, w, cin → 2b), (h/2, w/2, 2b → 4b), (h/4, w/4, 4b → 8b)
        for k, (s, ci, co) in enumerate(((1, cin, 2 * b), (2, 2 * b, 4 * b), (4, 4 * b, 8 * b))):
            x = randn(d, h // s, w // s, ci)
            wt = randn(co, ci, 3, 3, scale=(2.0 / (9 * ci)) ** 0.5)
            taps = conv_taps(h // s, h // s // 2, 2) * conv_taps(w // s, w // s // 2, 2)
            out_n = d * (h // s // 2) * (w // s // 2) * co
            dn.case(f"{stage} enc{k + 1} {(d, h // s, w // s, ci)}->{co}",
                    lambda: pc.conv_dn(x, wt), lambda: pc.conv_dn_reference(x, wt), rel_tol,
                    4 * (x.numel() + out_n + wt.numel()), 2 * d * taps * ci * co,
                    lambda: F.relu(F.conv2d(nchw(x), wt, stride=2, padding=1)))
        # recurrences at scales 1, 2, 4, 8: (cin, C) = (cin, b), (2b, 2b), (4b, 4b), (8b, 8b)
        for s, ci, c in ((1, cin, b), (2, 2 * b, 2 * b), (4, 4 * b, 4 * b), (8, 8 * b, 8 * b)):
            cell = init_from_seed(ConvGRUCell(ci, c), s).cuda()
            with torch.no_grad():
                for norm in (cell.gn_r, cell.gn_u, cell.gn_y):
                    norm.weight.copy_(1.0 + randn(c, scale=0.2))
                    norm.bias.copy_(randn(c, scale=0.1))
                cell.conv_h.bias.copy_(randn(2 * c, scale=0.1))
                cell.conv_c.bias.copy_(randn(c, scale=0.1))
            x = randn(d, h // s, w // s, ci)
            taps = conv_taps(h // s, h // s, 1) * conv_taps(w // s, w // s, 1)
            nbytes = 4 * (x.numel() + d * (h // s) * (w // s) * c
                          + sum(p.numel() for p in cell.parameters()))
            flops = 2 * d * taps * (ci + c) * 3 * c
            cases = [("", None)]
            if (stage, s) == ("stage3", 1):
                cases.append((" h0", torch.tanh(randn(h, w, c))))
            for tag, h0 in cases:
                with torch.no_grad():
                    rec.case(f"{stage} scale{s}{tag} {(d, h // s, w // s, ci)}->{c}",
                             lambda: rr.red_recur(x, cell, h0),
                             lambda: rr.red_recur_reference(x, cell, h0),
                             lambda want: RED_RECUR_TOL,
                             nbytes, flops, timed=h0 is None)
        # decoder: (h/8 → h/4, 8b → 4b), (h/4 → h/2, 4b → 2b), (h/2 → h, 2b → b), skips added
        for k, (s, ci, co) in enumerate(((8, 8 * b, 4 * b), (4, 4 * b, 2 * b), (2, 2 * b, b))):
            x = randn(d, h // s, w // s, ci)
            wt = randn(ci, co, 3, 3, scale=(2.0 / (9 * ci)) ** 0.5)
            skip = randn(d, 2 * (h // s), 2 * (w // s), co)
            taps = (3 * (h // s) - 1) * (3 * (w // s) - 1)
            up.case(f"{stage} up{3 - k} {(d, h // s, w // s, ci)}->{co}",
                    lambda: pc.deconv_up(x, wt, skip),
                    lambda: pc.deconv_up_reference(x, wt, skip), rel_tol,
                    4 * (x.numel() + 2 * skip.numel() + wt.numel()), 2 * d * taps * ci * co,
                    lambda: F.relu(F.conv_transpose2d(nchw(x), wt, stride=2, padding=1,
                                                      output_padding=1)) + nchw(skip))
        # logit head: (h, w, b → 1) with bias
        x = randn(d, h, w, b)
        wt, bias = randn(1, b, 3, 3, scale=(2.0 / (9 * b)) ** 0.5), randn(1)
        taps = conv_taps(h, h, 1) * conv_taps(w, w, 1)
        head.case(f"{stage} head {(d, h, w, b)}->1", lambda: pc.conv_head(x, wt, bias),
                  lambda: pc.conv_head_reference(x, wt, bias), rel_tol,
                  4 * (x.numel() + d * h * w + wt.numel() + 1), 2 * d * taps * b,
                  lambda: F.conv2d(nchw(x), wt, bias, padding=1))
    return [dn.record(), rec.record(), up.record(), head.record()]


# launches of each kernel wrapper in one forward of the slice: sweep_variance
# once per stage; per stage's RED pipeline conv_dn ×3, red_recur ×4 (one per
# scale; its input convolutions run inside the same launch), deconv_up ×3 and
# conv_head ×1
LAUNCHES_PER_FORWARD = {"sweep_variance": 3, "conv_dn": 9, "red_recur": 12, "deconv_up": 9,
                        "conv_head": 3}


def kernel_wrappers() -> dict:
    from satmvs_tpu_torch.ops.kernels.plane_conv import conv_dn, conv_head, deconv_up
    from satmvs_tpu_torch.ops.kernels.red_recur import red_recur
    from satmvs_tpu_torch.ops.kernels.sweep_variance import sweep_variance

    return {"sweep_variance": sweep_variance, "conv_dn": conv_dn, "red_recur": red_recur,
            "deconv_up": deconv_up, "conv_head": conv_head}


def phase_slice(card: str) -> dict:
    """Phase 3: the main path, three predictions; returns each kernel's launches."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models import CascadeREDNet

    def build(device):
        model = CascadeREDNet(geo_model="rpc", ndepths=NDEPTHS, device=device, seed=0)
        with torch.no_grad():  # peaked softmax, so depth parity is not trivial
            for reg in model.regs:
                reg.step.head.weight.mul_(40.0)
                reg.step.head.bias.mul_(40.0)
        return model

    model = build("cuda")
    batches = [synthetic.make_batch(1, WIDTH, HEIGHT, seed=s, device="cuda") for s in SEEDS]
    torch.cuda.synchronize()

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    outs = []
    for i, b in enumerate(batches):
        outs.append(model(b["imgs"], b["cams"], b["depth_values"]))
        for name, fn in wrappers.items():
            want = LAUNCHES_PER_FORWARD[name] * (i + 1)
            check(fn.launches == want,
                  f"{name} launches {fn.launches} after {i + 1} forwards, want {want}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"[slice] {len(batches)} forwards at {HEIGHT}x{WIDTH}, ndepths={NDEPTHS}: "
          f"launches {launches}", flush=True)

    intervals = model.stage_intervals()
    for seed, b, out in zip(SEEDS, batches, outs):
        lo, hi = b["depth_values"][0].tolist()
        margin = 0.0
        for i, (scale, nd) in enumerate(zip(STAGE_SCALES, NDEPTHS), start=1):
            if i > 1:  # a window reaches nd/2 intervals past the previous depth
                margin += nd / 2 * intervals[i - 1]
            depth = out[f"stage{i}"]["depth"]
            conf = out[f"stage{i}"]["photometric_confidence"]
            check(tuple(depth.shape) == (1, HEIGHT // scale, WIDTH // scale),
                  f"seed {seed} stage{i} depth shape {tuple(depth.shape)}")
            check(bool(torch.isfinite(depth).all()), f"seed {seed} stage{i}: non-finite depth")
            dmin, dmax = depth.min().item(), depth.max().item()
            check(lo - margin - 1e-3 <= dmin and dmax <= hi + margin + 1e-3,
                  f"seed {seed} stage{i}: depth [{dmin}, {dmax}] outside "
                  f"[{lo - margin}, {hi + margin}]")
            cmin, cmax = conf.min().item(), conf.max().item()
            check(0.0 <= cmin and cmax <= 1.0 + 1e-6,
                  f"seed {seed} stage{i}: confidence [{cmin}, {cmax}]")
            print(f"[slice] seed {seed} stage{i} depth [{dmin:.2f}, {dmax:.2f}] m "
                  f"(range {lo:.0f}..{hi:.0f} ± {margin:g}) conf [{cmin:.4f}, {cmax:.4f}]",
                  flush=True)

    # the same model's plain run on the CPU, full size, seed 0, stage by
    # stage: each CPU stage centres its window on the GPU's previous-stage
    # depth, so a stage is held to its own numerical differences only; the
    # free-running CPU cascade is reported beside it, not gated
    t0 = time.time()
    cpu_model = build("cpu")
    b0 = batches[0]
    cams_cpu = [c.to("cpu") for c in b0["cams"]]
    dv_cpu = b0["depth_values"].cpu()
    feats_cpu = cpu_model.features(b0["imgs"].cpu())
    free = cpu_model(b0["imgs"].cpu(), cams_cpu, dv_cpu)
    lo, hi = dv_cpu[0].tolist()
    steps = [(hi - lo) / (NDEPTHS[0] - 1)] + [
        nd * iv / (nd - 1) for nd, iv in zip(NDEPTHS[1:], intervals[1:])]
    for i, step in enumerate(steps):
        gpu = outs[0][f"stage{i + 1}"]
        prev = None if i == 0 else outs[0][f"stage{i}"]["depth"].cpu()
        cpu = cpu_model.stage(i, feats_cpu[i], cams_cpu[i], dv_cpu[:, 0], dv_cpu[:, -1], prev)
        err = (gpu["depth"].cpu() - cpu["depth"]).abs() / step
        cerr = (gpu["photometric_confidence"].cpu() - cpu["photometric_confidence"]).abs()
        mean, p99 = err.mean().item(), torch.quantile(err.flatten(), 0.99).item()
        free_err = (gpu["depth"].cpu() - free[f"stage{i + 1}"]["depth"]).abs() / step
        print(f"[slice] GPU vs CPU plain, seed 0 stage{i + 1} (step {step:.3f} m), "
              f"same window centres: depth err mean {mean:.3e}, p99 {p99:.3e}, "
              f"max {err.max().item():.3e} of step (tol mean {DEPTH_TOL_MEAN}, "
              f"p99 {DEPTH_TOL_P99}), share > 1 % of step "
              f"{(err > 0.01).float().mean().item():.3e}, conf err max "
              f"{cerr.max().item():.3e}; free-running cascade: mean "
              f"{free_err.mean().item():.3e}, p99 "
              f"{torch.quantile(free_err.flatten(), 0.99).item():.3e}, max "
              f"{free_err.max().item():.3e} of step", flush=True)
        check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
              f"stage{i + 1}: GPU vs CPU depth err mean {mean}, p99 {p99} of step")
    print(f"[slice] CPU plain runs took {time.time() - t0:.1f} s", flush=True)

    imgs, cams, dvals = b0["imgs"], b0["cams"], b0["depth_values"]
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = time_ms(lambda: model(imgs, cams, dvals), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] forward_ms={fwd_ms:.2f} (median of 5, CUDA events, B=1, "
          f"{HEIGHT}x{WIDTH}, 3 views) peak_mem={peak:.2f} GiB card={card}", flush=True)
    profile_forward(lambda: model(imgs, cams, dvals))
    return launches


def profile_forward(fn, top: int = 8):
    """Device time by kernel over one forward (torch.profiler), and the
    share of the forward's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): an operator's own entry
    # repeats the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    print(f"[profile] one forward: wall {wall_us / 1e3:.2f} ms (profiler on), device busy "
          f"{busy_us / 1e3:.2f} ms = {busy_us / wall_us:.3f} of wall, {n_kernels} device "
          f"kernels/copies", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from satmvs_tpu_torch.ops.kernels import build

    # phase 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[setup] card: {smi} (torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)

    # phase 1
    t0 = time.time()
    logs = build.build_all()
    for name in build.sources():
        build.load(name)
    print(f"[build] {len(logs)} of {len(build.sources())} kernel sources compiled "
          f"in {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # phase 2 and 3
    records = [phase_sweep(smi), *phase_red_kernels(smi)]
    launches = phase_slice(smi)
    for record in records:
        record["launches"] = launches[record["name"]]
        check(record["launches"] > 0, f"{record['name']} never launched on the main path")

    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
