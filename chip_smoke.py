#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one GPU and check it.

    python3 chip_smoke.py        (from the repository root, one CUDA device)

Phases, each reported on its own lines:
  0  setup: TF32 off for matmuls and cuDNN, the card's name and power limit;
  1  build: every CUDA source of satmvs_tpu_torch/csrc with nvcc (sm_90a),
     each kernel instance's registers and spills; no instance of the plane
     convs or of the sweep (sweep_variance_kernel, and
     sweep_variance_groups_kernel for more than four source views) may
     spill;
  2  each kernel against its plain PyTorch version on the card, at every
     shape the main path gives it (sweep_variance at the forward's
     coordinates: stage 1 uniform, stages 2-3 windows around a seeded
     previous depth; also with uniform planes at stages 2-3 and with
     coordinates pushed off the image; and batched, B = 4 tiles of a scene
     chunk's 8-plane slabs, against four B = 1 calls; at 6 and 8 views
     (stages 1-3, B = 2) also the same bits under every plan; red_recur also from a
     non-zero start state; sweep_variance, red_recur and the plane convs
     with their launch plans and the same bits in a second run); kernel,
     plain and library times (CUDA events, median after warm-up) beside the
     least time the card could take (bound);
  2c CascadeREDNet inference with 6 and 8 views on a 96×192 patch: a
     forward's launches, held to the same model's plain run on the CPU;
  2b the batched red_recur (B = 4 elements, each from its own start state)
     against its plain version and against B = 1 calls on each element, at
     every shape a 448² tile batch gives it in 8-plane slabs, with its plan
     and the same bits in a second run; times per call and per 4-tile chunk;
  3  the full-volume forward: CascadeREDNet (RPC, ndepths 64/32/8, 384×768,
     seeded weights, the fused RED regularizer) predicts three synthetic
     scenes; every kernel of the path must have launched exactly as often as
     one forward launches it, times three; outputs are checked for range and
     held against the same model's plain run on the CPU; forward time, peak
     memory and a profile;
  5  the scene: `infer.scene.predict_scene` over the slab-streaming tile
     forward (`infer.predict.streaming_red_forward`, slab 8) on a seeded
     synthetic 1152² triplet, tile 384 + halo 32 (nine 448² tiles), at
     batch_tiles 4 (three chunks, the last padded) and 1; exact launches per
     chunk, range checks, the two runs against each other, ms per tile, the
     host-prep record, peak memory and a profile of one chunk;
  4  streaming against full volume, on phase 5's first 4-tile chunk: stage
     by stage against the same model's full-volume forward, peak memory of
     each (run after phase 5, whose chunk it takes);
  6  the training sweep pair, sweep_gather and its adjoint sweep_scatter,
     against their plain versions at the three training stage shapes (both
     source views, RPC coordinates) and with coordinates pushed off the
     image; the scatter's run-to-run difference; kernel, plain, bound and
     grid_sample times (forward, and its input gradient); the gather's and
     grid_sample's times over calls launched back to back (the card's time
     without the host's launch latency); the scatter at one plane a thread
     against its runs over planes;
  8  the backward kernels of the fused RED regularizer (conv_dn, red_recur,
     deconv_up, conv_head) against their plain backwards at every shape of a
     384×768 train step, each cotangent on its own, red_recur on states in
     (−1, 1) over all planes; the same bits in a second run; kernel, plain,
     bound and cuDNN-gradient times; red_recur's adjoint kernel alone (row 6
     without its two weight reductions) beside row 6 and the adjoint's share
     of the operations bound, per shape and over the 12; the plane convs'
     dx kernel alone (device time under torch.profiler, its plan and its
     own bound) per shape and over each row's calls; and their shared
     weight reduction wgrad3x3 alone at each of its 45 call shapes (9
     conv_dn, 24 red_recur, 9 deconv_up, 3 conv_head) against its plain
     version in float64, its time beside cuDNN's weight-only gradient (run
     before phase 3);
  7  training (`train.loop`) at 384×768, B = 1: five train steps with
     Config() defaults, the fused RED pipeline (exact launches per step:
     6 sweep_gather, 6 sweep_scatter, conv_dn 9, red_recur 12, deconv_up 9,
     conv_head 3 and their backward kernels 9, 12, 9, 3, wgrad3x3 45, no
     sweep_variance),
     step time, peak memory and losses (finite, falling); one eval step (a
     forward's kernels) and its time; one step split into forward, backward
     and update, and each stage's RED alone, fused and scan; a profile of
     one step; two steps with fused_red off (the sweep pair only) and a
     profile of one; and one fused step at 96×192, ndepths (16, 8, 4)
     against the same step on the CPU (loss, eval-mode gradients, the update
     and the running statistics);
  9  from disk: a WHU-TLC tree of 3 train and 1 test blocks of 3 384×768
     views, written by the port's writer, through the CLIs' `main` at the
     default Config(): `cli.train` two epochs (six train steps, a test pass
     each, two checkpoints), a `--resume` run of a third epoch, `--mode=test`
     (its metrics recomputed from the maps it writes), `cli.predict --fuse`
     (its maps bit for bit a direct forward of the restored model on the
     same Loader batches, both on cuDNN's deterministic engines as the CLI
     runs; fusion on the card against the CPU: the valid fraction within
     0.5 percentage points, the DSM within a mean |Δ| of 0.05 m), the same
     predict as `python -m satmvs_tpu_torch.cli.predict` (the same bits),
     and `cli.predict_scene --streaming --dsm` on phase 5's triplet written
     as PNG + .rpc; exact launches per run; timing lines (steps/s, the test
     pass, the loader's time and its split against a step, a forward on
     cuDNN's default and deterministic engines, the fusion, ms per scene
     tile).

  10 the CostRegNet families (CascadeMVSNet, UCSNet; the packed CostRegNet on
     the plane convs in their CostRegNet forms): each form (conv_dn and
     deconv_up without ReLU, conv_head with up to 64 output channels and a
     zero bias) against its plain version at each of the 33 call shapes of
     a 384×768 forward, with its plan, the same bits in a second run, a
     call on two elements' planes the bits of the two B = 1 calls, kernel,
     plain, bound and F.conv2d / F.conv_transpose2d times; each 3-D block's
     three taps composed against cuDNN's conv3d / conv_transpose3d on the
     BN-folded kernel, both timed; each family at 384×768, B = 1, 3 views,
     ndepths 64/32/8 with non-trivial BatchNorm statistics: exact launches
     per forward (3 sweep_variance, 27 conv_dn, 27 deconv_up, 45 conv_head,
     no red_recur), ranges, forward time, peak memory, a profile, stage 1's
     CostRegNet at B = 2 against B = 1 bit for bit, and the same model's
     plain run on the CPU at 96×192 stage by stage (depth, the window
     confidence, UCSNet's variance); `cli.predict --model ucs` from a port
     checkpoint on phase 9's test split, its maps a direct forward bit for
     bit.

The 1152² scene and phase 9's tree are rendered on the host in two worker
processes started before phase 1, so they overlap phases 1-3 (phase 9
writes under build/chip_smoke/).  Ends with a JSON line of per-kernel
numbers (each kernel's launches on each path: the full-volume forward, the
streaming forward of phase 4, the two scene runs, the fused train and eval
steps, the fused_red-off train steps, phase 9's train, predict and scene
CLI runs, and phase 10's two family forwards and its predict run), the
nvidia-smi line of the card,
and {"ok": true, "device": ...} as the last line.  Any failed check raises,
and the script exits non-zero without those last lines.  Without a CUDA
device, or without the rest of the repository beside it, it fails.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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
# the CostRegNet families' 4-plane window confidence, GPU vs CPU: a pixel
# whose soft-argmax index sits at an integer within rounding may take the
# next band (a jump of up to 1), so the gate is on the mean and the p99
CONF_TOL_MEAN = 1e-3
CONF_TOL_P99 = 2e-3
# the scene (scripts/predict_scene.py's defaults): tiles of 384 + 2 × 32
SCENE_SIZE, TILE, HALO, SLAB = 1152, 384, 32, 8
TILE_HW = TILE + 2 * HALO
SLABS_PER_TILE = tuple(nd // SLAB for nd in NDEPTHS)  # 8, 4, 1
BATCH_TILES = 4
MANY_VIEWS = (6, 8)          # views beyond the sweep kernel's four unrolled source views
MANY_VIEWS_HW = (96, 192)    # the many-view forwards' patch


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


def loop_ms(fn, calls: int = 20) -> float:
    """CUDA-event time per call of `calls` calls of fn launched back to back,
    after one warm-up call: the host queues them faster than the card runs
    them, so this is the card's time without the host's launch latency,
    which time_ms includes for one short call at a time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, kernel, calls: int) -> float:
    """Device time per call of the kernels that `kernel` picks (a substring
    of the profiler's kernel name, or a predicate on it) over `calls` calls
    of fn under torch.profiler, after one warm-up call; a capture that holds
    none of them is taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pick = kernel if callable(kernel) else (lambda key: kernel in key)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and pick(e.key))
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError(f"the profiler saw no {kernel} kernel in three captures")


def conv3x3_kernel_name(key: str) -> bool:
    """A profiler key of plane_conv.cu's conv kernel (not the transposed one)."""
    return "conv3x3_kernel" in key and "deconv" not in key


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the HBM rate or fp32 operations
    over the fp32 rate, whichever is larger, and which one that is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_name(mangled: str) -> str:
    """A kernel's own name in its mangled symbol, whose names are each
    prefixed by their length ("20wgrad_partial_kernel"; the prefix may
    follow other digits)."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            part = mangled[m.end():m.end() + int(m.group()[i:])]
            if part.endswith("_kernel") and part.isidentifier():
                return part
    return mangled


def kernel_instance(mangled: str) -> str:
    """kernel_name with its integer and bool template arguments
    ("conv3x3_kernel<2,4,0,8>")."""
    name = kernel_name(mangled)
    m = re.search(re.escape(name) + r"I((?:L[ib]\d+E)+)E", mangled)
    return name if m is None else f"{name}<{','.join(re.findall(r'L[ib](\d+)E', m.group(1)))}>"


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
             library=None, timed: bool = True, count: int = 1, exact=None):
        """tol(plain result): the abs error allowed, a number or one per
        element (a tuple of such functions, one per output, for a kernel
        with several outputs); library: one PyTorch call that computes the
        same function, timed as a yardstick; count: calls of this shape on
        the path, which the sums weigh by; exact: what the kernel is held to
        where that is not the plain version's fp32 result (the plain version
        in float64), and then tol's argument."""
        name = self.rec["name"]
        got, want = kernel(), (exact or plain)()
        torch.cuda.synchronize()
        # a backward returns several cotangents: each is held to its own tolerance
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        tols = tol if isinstance(tol, tuple) else (tol,) * len(pairs)
        for i, ((a, b), tol_i) in enumerate(zip(pairs, tols)):
            part = f"[{i}]" if len(pairs) > 1 else ""
            t = tol_i(b)
            diff = (a - b).abs()
            err = diff.max().item()
            t_max = t.max().item() if isinstance(t, torch.Tensor) else t
            print(f"[kernels] {name} {label}{part} out={tuple(a.shape)} max_abs_err={err:.3e} "
                  f"tol={t_max:.3e}", flush=True)
            check(a.shape == b.shape, f"{name} {label}{part}: shape {tuple(a.shape)}")
            check(bool(torch.isfinite(a).all()), f"{name} {label}{part}: non-finite output")
            check(bool((diff <= t).all()), f"{name} {label}{part}: max abs err {err} > tol")
            self.rec["max_abs_err"] = max(self.rec["max_abs_err"], err)
        del got, want, pairs
        if not timed:
            return None
        k_ms, p_ms = time_ms(kernel, reps=10), time_ms(plain, reps=5, warmup=1)
        l_ms = time_ms(library, reps=10) if library is not None else None
        b_ms, by = bound_ms(nbytes, flops)
        self.rec["ms"] += count * k_ms
        self.rec["plain_ms"] += count * p_ms
        self.rec["bound_ms"] += count * b_ms
        self.by[by] += count * b_ms
        if l_ms is not None:
            self.rec["library_ms"] = (self.rec["library_ms"] or 0.0) + count * l_ms
        lib = f"{l_ms:.4f}" if l_ms is not None else "null"
        print(f"[kernels] {name} {label} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({by}, {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP) kernel/bound={k_ms / b_ms:.2f} card={self.card}",
              flush=True)
        return k_ms

    def record(self) -> dict:
        self.rec["bound_by"] = max(self.by, key=self.by.get)
        return self.rec


def sweep_work(feats, xs, ys) -> tuple[float, float]:
    """Bytes (output written once, coords and features read once) and flops
    (valid bilinear taps only) of one sweep_variance_batched on this data:
    feats (B, V, h, w, C), xs/ys (B, S, D, h, w)."""
    b, n_src, d, h, w = xs.shape
    c = feats.shape[-1]
    nbytes = 4 * (b * d * h * w * c + 2 * xs.numel() + feats.numel())
    x0, y0 = torch.floor(xs), torch.floor(ys)
    taps = sum(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)).sum().item()
               for dx in (0, 1) for dy in (0, 1))
    return nbytes, c * (2 * taps + b * d * h * w * (3 * n_src + 7))


def rel_tol(want) -> float:
    """KERNEL_TOL × max(1, max |plain|): fp32 sums in another order."""
    return KERNEL_TOL * max(1.0, want.abs().max().item())


# hypothesis interval of each stage (m): CascadeModel's depth_intervals_ratio
# (4, 2, 1) × its min_interval 2.5
STAGE_INTERVALS = (10.0, 5.0, 2.5)


def sweep_inputs(stage: int, b: int, h: int, w: int, gen, window: bool = True,
                 planes: slice = slice(None), views: int = 3):
    """Features (b, views, h, w, C) and coordinates xs, ys (b, views − 1, D,
    h, w) of cascade stage `stage` (0-based) on b patches of h×w pixels at
    the stage's scale.  Sample i takes the synthetic RPC triplet of seed i
    (its image the patch at full scale, the nadir view the reference; more
    source views from the forward and backward looks of the triplets of
    seeds i + 17, i + 34, ...) and the hypotheses the forward builds
    (`stage_hypotheses`): uniform over the height range at stage 0 or with
    window=False, else a window around a seeded smooth previous depth within
    the range; `planes` cuts a slab."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.geo import rpc as rpclib
    from satmvs_tpu_torch.models.cascade import stage_hypotheses
    from satmvs_tpu_torch.ops import warp

    scale = STAGE_SCALES[stage]
    coords = []
    for i in range(b):
        trips = [synthetic.make_rpc_triplet(w * scale, h * scale, seed=i + 17 * k)
                 for k in range(-(-(views - 1) // 2))]
        rpcs = np.stack([trips[0][2]] + [trips[k // 2][k % 2] for k in range(views - 1)])
        cams = warp.build_rpc_warp_cams(rpcs, 0, 1.0 / scale, device="cuda")
        lo, hi = rpclib.height_range(rpcs[0])
        prev = None
        if stage > 0 and window:  # a 6×12 random grid, bilinearly upsampled
            grid = torch.rand((1, 1, 6, 12), generator=gen, device="cuda")
            up = F.interpolate(grid, size=(h // 2, w // 2), mode="bilinear", align_corners=True)
            prev = lo + (hi - lo) * (0.1 + 0.8 * up[:, 0])
        hyps = stage_hypotheses(NDEPTHS[stage], h, w, torch.tensor([lo], device="cuda"),
                                torch.tensor([hi], device="cuda"), STAGE_INTERVALS[stage],
                                prev)[0, planes]
        coords.append([warp.rpc_sweep_coords(cams, s, hyps, h, w) for s in range(views - 1)])
    d = coords[0][0][0].shape[0]
    xs, ys = torch.stack([q[k] for pair in coords for q in pair for k in (0, 1)]).view(
        b, views - 1, 2, d, h, w).unbind(2)
    feats = torch.randn((b, views, h, w, FEAT_CH[stage]), generator=gen, device="cuda")
    return feats, xs.contiguous(), ys.contiguous()


def sweep_cases(gen, checks: bool = True) -> list[tuple]:
    """(label, feats, xs, ys, path, calls) of sweep_variance: the three
    sweeps of a 384×768 forward (path "forward", B = 1: stage 1 uniform over
    the height range, stages 2-3 windows around a seeded previous depth) and
    of a 4-tile scene chunk (path "chunk": B = 4 tiles of 448², one 8-plane
    slab of each stage, `calls` of them a chunk) and of the three stages at
    B = 2 with 6 and 8 views (path "views": 5 and 7 source views, beyond the
    four the kernel unrolls); with `checks`, also stages 2-3 with uniform planes
    and stage 1 with its coordinates pushed off the image on every side,
    some far off (zero padding and the pre-cast clamp), path "check"."""
    cases = []
    for i in range(3):
        h, w = HEIGHT // STAGE_SCALES[i], WIDTH // STAGE_SCALES[i]
        cases.append((f"stage{i + 1}", *sweep_inputs(i, 1, h, w, gen), "forward", 1))
        if checks and i > 0:
            cases.append((f"stage{i + 1} uniform", *sweep_inputs(i, 1, h, w, gen, window=False),
                          "check", 0))
    for i, n_slabs in enumerate(SLABS_PER_TILE):
        size = TILE_HW // STAGE_SCALES[i]
        slab = slice(SLAB * (n_slabs // 2), SLAB * (n_slabs // 2 + 1))  # a middle slab
        cases.append((f"chunk stage{i + 1} B={BATCH_TILES}",
                      *sweep_inputs(i, BATCH_TILES, size, size, gen, planes=slab), "chunk",
                      n_slabs))
    for views in MANY_VIEWS:
        for i in range(3):
            h, w = HEIGHT // STAGE_SCALES[i], WIDTH // STAGE_SCALES[i]
            cases.append((f"stage{i + 1} V={views} B=2",
                          *sweep_inputs(i, 2, h, w, gen, views=views), "views", 0))
    if checks:
        _, feats, xs, ys, _, _ = cases[0]
        h, w = feats.shape[2:4]
        xs_off, ys_off = xs * 1.5 - 0.25 * w, ys * 1.5 - 0.25 * h
        xs_off.view(-1)[::97] = 1e9
        ys_off.view(-1)[::89] = -1e9
        cases.append(("off-image", feats, xs_off, ys_off, "check", 0))
    return cases


def phase_sweep(card: str) -> list[dict]:
    """Phase 2: sweep_variance (the batched entry the forward calls) against
    its plain version at every case of `sweep_cases`, with its launch plan
    and the same bits in a second run; each B = 1 case also through
    `sweep_variance` (the same bits), the B = 4 chunk cases against four
    B = 1 calls (the same bits), the 6- and 8-view cases also under every
    plan (the same bits).  Returns the forward's record (the three forward
    sweeps) and the chunk's (`sweep_variance_batched`, the 13 calls of a
    4-tile chunk)."""
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    gen = torch.Generator(device="cuda").manual_seed(0)
    source, replaces = ("satmvs_tpu_torch/csrc/sweep_variance.cu",
                        "satmvs_tpu/ops/pallas/sweep_variance.py:130")
    reps = {"forward": KernelReport("sweep_variance", source, replaces, card),
            "chunk": KernelReport("sweep_variance_batched", source, replaces, card)}
    reps["check"] = reps["views"] = reps["forward"]
    for label, feats, xs, ys, path, calls in sweep_cases(gen):
        b, n_src, d, h, w = xs.shape
        c = feats.shape[-1]
        plan = sv.sweep_variance_plan(b, n_src, d, h, w, c)
        run = lambda: sv.sweep_variance_batched(feats, xs, ys)  # noqa: E731
        # library_ms stays null: no single PyTorch call computes warp +
        # variance (grid_sample per view plus the moments is a composition)
        reps[path].case(label, run, lambda: sv.sweep_variance_batched_reference(feats, xs, ys),
                        rel_tol, *sweep_work(feats, xs, ys), count=calls,
                        timed=label != "off-image")
        got = run()
        same = torch.equal(got, run())
        singles = [sv.sweep_variance(feats[i, 0], feats[i, 1:], xs[i], ys[i]) for i in range(b)]
        as_b1 = all(torch.equal(got[i], one) for i, one in enumerate(singles))
        options = sv.sweep_variance_plan_options(b, n_src, d, h, w, c) if path == "views" else []
        every = all(torch.equal(sv._batched(feats, xs, ys, o), got) for o in options)
        print(f"[kernels] sweep_variance {label} (B, S, D, h, w, C) = {(b, n_src, d, h, w, c)} "
              f"plan: {plan['groups']} group(s) of {plan['vec']} channels and {plan['planes']} "
              f"planes a thread, tile {plan['ty']}x{plan['tx']} px x {plan['lanes']} lanes, "
              f"{plan['threads']} threads, grid "
              f"{plan['grid']}; same bits in a second run: {same}; each sample the same bits "
              f"as a B=1 sweep_variance call: {as_b1}"
              + (f"; the same bits under all {len(options)} plans: {every}" if options else ""),
              flush=True)
        check(same, f"sweep_variance {label}: a second run differs")
        check(as_b1, f"sweep_variance {label}: a sample differs from its B=1 call")
        check(every, f"sweep_variance {label}: a plan gives other bits")
        del got, singles
    chunk = reps["chunk"].record()
    print(f"[kernels] sweep_variance per {BATCH_TILES}-tile chunk ({sum(SLABS_PER_TILE)} calls): "
          f"kernel {chunk['ms']:.4f} ms, bound {chunk['bound_ms']:.4f} ms ({chunk['bound_by']}), "
          f"plain {chunk['plain_ms']:.4f} ms card={card}", flush=True)
    return [reps["forward"].record(), chunk]


def red_shapes():
    """Per stage (name, D, h, w, Cin) of the cost volume the regularizer gets."""
    return [(f"stage{i + 1}", nd, HEIGHT // s, WIDTH // s, c)
            for i, (nd, s, c) in enumerate(zip(NDEPTHS, STAGE_SCALES, FEAT_CH))]


def red_scales(cin: int):
    """(scale, Cin, C) of the four recurrences: (cin, b), (2b, 2b), (4b, 4b), (8b, 8b)."""
    b = RED_BASE
    return ((1, cin, b), (2, 2 * b, 2 * b), (4, 4 * b, 4 * b), (8, 8 * b, 8 * b))


def plane_calls():
    """(label, op, stride, transposed, N, H, W, Cin, Cout, gated) of the 21
    plane convs of a 384×768 forward (conv_dn ×9, deconv_up ×9, conv_head
    ×3) and the 21 dx of a train step's backwards, as the kernels see them:
    a dx takes the cotangent as its input (conv_dn's dx is a gated
    transposed conv, deconv_up's a gated stride-2 conv, conv_head's a
    stride-1 conv from one channel)."""
    b = RED_BASE
    calls = []
    for stage, d, h, w, cin in red_shapes():
        for k, (s, ci, co) in enumerate(((1, cin, 2 * b), (2, 2 * b, 4 * b), (4, 4 * b, 8 * b))):
            hh, ww = h // s, w // s
            calls.append((f"{stage} enc{k + 1}", "conv_dn", 2, False, d, hh, ww, ci, co, False))
            calls.append((f"{stage} enc{k + 1}", "conv_dn dx", 2, True, d, hh // 2, ww // 2, co,
                          ci, True))
        for k, (s, ci, co) in enumerate(((8, 8 * b, 4 * b), (4, 4 * b, 2 * b), (2, 2 * b, b))):
            hh, ww = h // s, w // s
            calls.append((f"{stage} up{3 - k}", "deconv_up", 2, True, d, hh, ww, ci, co, False))
            calls.append((f"{stage} up{3 - k}", "deconv_up dx", 2, False, d, 2 * hh, 2 * ww, co,
                          ci, True))
        calls.append((f"{stage} head", "conv_head", 1, False, d, h, w, b, 1, False))
        calls.append((f"{stage} head", "conv_head dx", 1, False, d, h, w, 1, b, False))
    return calls


def plane_work(op: str, stride: int, transposed: bool, n: int, h: int, w: int, cin: int,
               cout: int, gated: bool) -> tuple[float, float]:
    """Bytes (input and gate, weights, output, and deconv_up's skip and
    conv_head's bias each read or written once) and flops (the taps inside
    the plane) of one plane conv as `plane_calls` lists it.  A dx's
    multiply-adds are its forward's."""
    if transposed:
        ho, wo, taps = 2 * h, 2 * w, (3 * h - 1) * (3 * w - 1)
    else:
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        taps = conv_taps(h, ho, stride) * conv_taps(w, wo, stride)
    words = n * h * w * cin * (2 if gated else 1) + 9 * cin * cout + n * ho * wo * cout
    words += n * ho * wo * cout if op == "deconv_up" else cout if op == "conv_head" else 0
    return 4.0 * words, 2.0 * n * taps * cin * cout


COSTREG_BASE = 8  # cr_base_chs (8, 8, 8) of CascadeMVSNet and UCSNet


def costreg_blocks(b: int = 1):
    """(stage, block, op, N, H, W, Cin, Cout) of the 33 3-D blocks of a
    384×768 CostRegNet forward of B = b elements (both families: feature
    channels 32/16/8), each three plane-conv calls, one per depth tap, on
    the N = b·D' planes the block reads: ConvBlock_0..6 (the stride-1 ones
    conv_head with a zero bias, the stride-2 ones conv_dn without ReLU, on
    D/2 even or odd planes), DeconvBlock_0..2 (deconv_up without ReLU or
    skip) and the 1-channel head (conv_head)."""
    c = COSTREG_BASE
    out = []
    for stage, d, h, w, cin in red_shapes():
        chans = (cin, c, 2 * c, 2 * c, 4 * c, 4 * c, 8 * c, 8 * c)
        for k in range(7):  # ConvBlock_k: stride 2 at k = 1, 3, 5
            s = 2 ** ((k + 1) // 2)  # output scale of the block (D, H and W)
            if k % 2:  # reads the even or the odd planes of its input at scale s / 2
                out.append((stage, f"ConvBlock_{k}", "conv_dn", b * d // s, h * 2 // s,
                            w * 2 // s, chans[k], chans[k + 1]))
            else:
                out.append((stage, f"ConvBlock_{k}", "conv_head", b * d // s, h // s, w // s,
                            chans[k], chans[k + 1]))
        for k, (s, ci, co) in enumerate(((8, 8 * c, 4 * c), (4, 4 * c, 2 * c), (2, 2 * c, c))):
            out.append((stage, f"DeconvBlock_{k}", "deconv_up", b * d // s, h // s, w // s, ci, co))
        out.append((stage, "Conv_0", "conv_head", b * d, h, w, c, 1))
    return out


def costreg_calls(b: int = 1):
    """`plane_calls`' tuples for the blocks of `costreg_blocks(b)`, one per
    block (each call shape runs three times a forward, once per tap)."""
    return [(f"{stage} {block}", op, 1 if op == "conv_head" else 2, op == "deconv_up", n, h, w,
             ci, co, False) for stage, block, op, n, h, w, ci, co in costreg_blocks(b)]


def red_cell(ci: int, c: int, seed: int, randn):
    """A ConvGRUCell on the card: seeded convs, perturbed norms and biases."""
    from satmvs_tpu_torch.nn.blocks import ConvGRUCell
    from satmvs_tpu_torch.params import init_from_seed

    cell = init_from_seed(ConvGRUCell(ci, c), seed).cuda()
    with torch.no_grad():
        for norm in (cell.gn_r, cell.gn_u, cell.gn_y):
            norm.weight.copy_(1.0 + randn(c, scale=0.2))
            norm.bias.copy_(randn(c, scale=0.1))
        cell.conv_h.bias.copy_(randn(2 * c, scale=0.1))
        cell.conv_c.bias.copy_(randn(c, scale=0.1))
    return cell


def recur_work(x, c: int, cell) -> tuple[float, float]:
    """Bytes (x, h0 and the weights read once, every state written once) and
    flops (taps inside the plane only) of one red_recur on x ([B,] D, h, w, Cin)."""
    *lead, h, w, ci = x.shape
    n = int(np.prod(lead))  # B·D planes
    taps = conv_taps(h, h, 1) * conv_taps(w, w, 1)
    h0 = n // lead[-1] * h * w * c
    nbytes = 4 * (x.numel() + n * h * w * c + h0 + sum(p.numel() for p in cell.parameters()))
    return nbytes, 2 * n * taps * (ci + c) * 3 * c


def recur_same_bits(rr, label: str, x, cell, h0):
    """red_recur's launch plan at this shape, and the same bits in a second
    run (statistics in a fixed order, no atomics)."""
    b = x.shape[0] if x.ndim == 5 else 1
    h, w, ci = x.shape[-3:]
    plan = rr.red_recur_plan(b, h, w, ci, cell.features, rr.resident())
    convs = [tuple(p[k] for k in rr._PLAN_KEYS) for p in plan["convs"]]
    same = torch.equal(rr.red_recur(x, cell, h0), rr.red_recur(x, cell, h0))
    print(f"[kernels] red_recur {label} plan: {plan['per_element']} blocks an element, gates "
          f"(px, wr, wc, wk, ck) {convs[0]}, candidate {convs[1]}; same bits in a second run: "
          f"{same}", flush=True)
    check(same, f"red_recur {label}: a second run differs")


def plane_same_bits(name: str, label: str, fn, call: tuple):
    """A plane conv's launch plan at this shape (`plane_conv_plan` of call =
    (stride, transposed, N, H, W, Cin, Cout, gated), as the kernel sees it),
    and the same bits in a second run of fn (each output's sum in one fixed
    order, no atomics)."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    plan = pc.plane_conv_plan(*call, sms=torch.cuda.get_device_properties(0).multi_processor_count)
    a, b = fn(), fn()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    print(f"[kernels] {name} {label} plan: slab {plan['slab']}, tile {plan['tile_rows']}×"
          f"{plan['tx']}, {plan['threads']} threads, chunks of {plan['ck']} channels, "
          f"{plan['smem']} B, grid {plan['grid']}; same bits in a second run: {same}", flush=True)
    check(same, f"{name} {label}: a second run differs")


def phase_red_kernels(card: str) -> list[dict]:
    """Phase 2: the four RED kernels against their plain versions at every
    shape one forward gives them (base 8: channels 16/32/64 down the
    encoder), with seeded inputs and weights."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.ops.kernels import plane_conv as pc
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

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
            call = (2, False, d, h // s, w // s, ci, co, False)
            label = f"{stage} enc{k + 1} {(d, h // s, w // s, ci)}->{co}"
            dn.case(label, lambda: pc.conv_dn(x, wt), lambda: pc.conv_dn_reference(x, wt),
                    rel_tol, *plane_work("conv_dn", *call),
                    lambda: F.relu(F.conv2d(nchw(x), wt, stride=2, padding=1)))
            plane_same_bits("conv_dn", label, lambda: pc.conv_dn(x, wt), call)
        # recurrences at scales 1, 2, 4, 8: (cin, C) = (cin, b), (2b, 2b), (4b, 4b), (8b, 8b)
        for s, ci, c in red_scales(cin):
            cell = red_cell(ci, c, s, randn)
            x = randn(d, h // s, w // s, ci)
            cases = [("", None)]
            if (stage, s) == ("stage3", 1):
                cases.append((" h0", torch.tanh(randn(h, w, c))))
            for tag, h0 in cases:
                label = f"{stage} scale{s}{tag} {(d, h // s, w // s, ci)}->{c}"
                with torch.no_grad():
                    rec.case(label, lambda: rr.red_recur(x, cell, h0),
                             lambda: rr.red_recur_reference(x, cell, h0),
                             lambda want: RED_RECUR_TOL,
                             *recur_work(x, c, cell), timed=h0 is None)
                    recur_same_bits(rr, label, x, cell, h0)
        # decoder: (h/8 → h/4, 8b → 4b), (h/4 → h/2, 4b → 2b), (h/2 → h, 2b → b), skips added
        for k, (s, ci, co) in enumerate(((8, 8 * b, 4 * b), (4, 4 * b, 2 * b), (2, 2 * b, b))):
            x = randn(d, h // s, w // s, ci)
            wt = randn(ci, co, 3, 3, scale=(2.0 / (9 * ci)) ** 0.5)
            skip = randn(d, 2 * (h // s), 2 * (w // s), co)
            call = (2, True, d, h // s, w // s, ci, co, False)
            label = f"{stage} up{3 - k} {(d, h // s, w // s, ci)}->{co}"
            up.case(label, lambda: pc.deconv_up(x, wt, skip),
                    lambda: pc.deconv_up_reference(x, wt, skip), rel_tol,
                    *plane_work("deconv_up", *call),
                    lambda: F.relu(F.conv_transpose2d(nchw(x), wt, stride=2, padding=1,
                                                      output_padding=1)) + nchw(skip))
            plane_same_bits("deconv_up", label, lambda: pc.deconv_up(x, wt, skip), call)
        # logit head: (h, w, b → 1) with bias
        x = randn(d, h, w, b)
        wt, bias = randn(1, b, 3, 3, scale=(2.0 / (9 * b)) ** 0.5), randn(1)
        call = (1, False, d, h, w, b, 1, False)
        label = f"{stage} head {(d, h, w, b)}->1"
        head.case(label, lambda: pc.conv_head(x, wt, bias),
                  lambda: pc.conv_head_reference(x, wt, bias), rel_tol,
                  *plane_work("conv_head", *call),
                  lambda: F.conv2d(nchw(x), wt, bias, padding=1))
        plane_same_bits("conv_head", label, lambda: pc.conv_head(x, wt, bias), call)
    return [dn.record(), rec.record(), up.record(), head.record()]


def phase_batched_red(card: str) -> dict:
    """Phase 2b: the batched red_recur (TPU kernel row 5) at every shape a
    448² tile batch gives it: B = 4 tiles, 8-plane slabs, the four scales of
    each stage, a distinct seeded start state per element.  Held against its
    plain version and, element by element, against B = 1 calls; kernel,
    plain and bound times summed over one 4-tile chunk (8 + 4 + 1 slabs)."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    rec = KernelReport("red_recur_batched", "satmvs_tpu_torch/csrc/red_recur.cu",
                       "satmvs_tpu/ops/pallas/red_recur.py:337", card)
    bt = BATCH_TILES
    b1_chunk = 0.0
    for i, (scale, cin, n_slabs) in enumerate(zip(STAGE_SCALES, FEAT_CH, SLABS_PER_TILE)):
        h = w = TILE_HW // scale
        for s, ci, c in red_scales(cin):
            cell = red_cell(ci, c, 10 + s, randn)
            x = randn(bt, SLAB, h // s, w // s, ci)
            h0 = torch.tanh(randn(bt, h // s, w // s, c))
            label = f"stage{i + 1} scale{s} B={bt} {(SLAB, h // s, w // s, ci)}->{c} h0"
            with torch.no_grad():
                k_ms = rec.case(label, lambda: rr.red_recur(x, cell, h0),
                                lambda: rr.red_recur_reference(x, cell, h0),
                                lambda want: RED_RECUR_TOL, *recur_work(x, c, cell),
                                count=n_slabs)
                recur_same_bits(rr, label, x, cell, h0)
                got = rr.red_recur(x, cell, h0)
                err = max((got[e] - rr.red_recur(x[e], cell, h0[e])).abs().max().item()
                          for e in range(bt))
                check(err <= RED_RECUR_TOL,
                      f"red_recur {label}: B={bt} vs B=1 max abs err {err} > {RED_RECUR_TOL}")
                b1_ms = time_ms(lambda: rr.red_recur(x[0], cell, h0[0]), reps=10)
            b1_chunk += n_slabs * bt * b1_ms
            print(f"[batched] {label}: each element vs a B=1 call on it alone, max abs err "
                  f"{err:.3e} (tol {RED_RECUR_TOL}); B=1 {b1_ms:.4f} ms, {bt} x B=1 "
                  f"{bt * b1_ms:.4f} ms vs B={bt} {k_ms:.4f} ms ({bt * b1_ms / k_ms:.2f}x); "
                  f"{n_slabs} calls per chunk card={card}", flush=True)
    r = rec.record()
    print(f"[batched] per {bt}-tile chunk of {TILE_HW}x{TILE_HW} tiles ({sum(SLABS_PER_TILE)} "
          f"slabs x 4 scales): kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, {bt * sum(SLABS_PER_TILE)} B=1 "
          f"calls instead {b1_chunk:.4f} ms card={card}", flush=True)
    return r


# launches of each kernel wrapper in one forward of the slice: sweep_variance
# once per stage; per stage's RED pipeline conv_dn ×3, red_recur ×4 (one per
# scale; its input convolutions run inside the same launch), deconv_up ×3 and
# conv_head ×1
BACKWARD_KERNELS = ("conv_dn_backward", "red_recur_backward", "deconv_up_backward",
                    "conv_head_backward")
LAUNCHES_PER_FORWARD = {"sweep_variance": 3, "conv_dn": 9, "red_recur": 12, "deconv_up": 9,
                        "conv_head": 3, "sweep_gather": 0, "sweep_scatter": 0,
                        **{k: 0 for k in BACKWARD_KERNELS}, "wgrad3x3": 0}
# per train step at B = 1 on the fused RED pipeline (Config() defaults): the
# training sweep pair once per stage and source view instead of
# sweep_variance, the RED kernels as in a forward and each one's backward
# kernel as often, and the shared weight reduction once per conv backward and
# twice per red_recur backward (9 + 9 + 3 + 24); per eval step (no gradient)
# a forward's kernels; per train step with fused_red off the sweep pair only
# (the scan RED is torch built-ins)
LAUNCHES_PER_TRAIN_STEP = {**LAUNCHES_PER_FORWARD, "sweep_variance": 0, "sweep_gather": 6,
                           "sweep_scatter": 6, "conv_dn_backward": 9, "red_recur_backward": 12,
                           "deconv_up_backward": 9, "conv_head_backward": 3, "wgrad3x3": 45}
LAUNCHES_PER_EVAL_STEP = dict(LAUNCHES_PER_FORWARD)
LAUNCHES_PER_SCAN_STEP = {**{k: 0 for k in LAUNCHES_PER_FORWARD}, "sweep_gather": 6,
                          "sweep_scatter": 6}
# the kernels each path must launch
INFERENCE_PATHS = ("forward", f"scene_b{BATCH_TILES}", "scene_b1", "streaming")
CLI_PATHS = ("cli_train", "cli_predict", "cli_scene")  # phase 9: each runs every inference kernel
TRAIN_KERNELS = ("sweep_gather", "sweep_scatter", *BACKWARD_KERNELS, "wgrad3x3")
RED_FORWARD_KERNELS = ("conv_dn", "red_recur", "deconv_up", "conv_head")


def kernel_wrappers() -> dict:
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc
    from satmvs_tpu_torch.ops.kernels import red_recur as rr
    from satmvs_tpu_torch.ops.kernels.sweep_gather import sweep_gather, sweep_scatter
    from satmvs_tpu_torch.ops.kernels.sweep_variance import sweep_variance

    return {"sweep_variance": sweep_variance, "conv_dn": pc.conv_dn, "red_recur": rr.red_recur,
            "deconv_up": pc.deconv_up, "conv_head": pc.conv_head, "sweep_gather": sweep_gather,
            "sweep_scatter": sweep_scatter, "conv_dn_backward": pc.conv_dn_backward,
            "red_recur_backward": rr.red_recur_backward,
            "deconv_up_backward": pc.deconv_up_backward,
            "conv_head_backward": pc.conv_head_backward, "wgrad3x3": pc.wgrad3x3}


def build_model(device):
    """CascadeREDNet (RPC, ndepths 64/32/8) from seed 0, heads ×40 (a peaked
    softmax, so depth parity is not trivial)."""
    from satmvs_tpu_torch.models import CascadeREDNet

    model = CascadeREDNet(geo_model="rpc", ndepths=NDEPTHS, device=device, seed=0)
    with torch.no_grad():
        for reg in model.regs:
            reg.step.head.weight.mul_(40.0)
            reg.step.head.bias.mul_(40.0)
    return model


def counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def stage_steps(lo: float, hi: float, intervals) -> list[float]:
    """Hypothesis step per stage: the range / (D − 1) at stage 1, D·interval
    / (D − 1) in the windows of stages 2-3."""
    return [(hi - lo) / (NDEPTHS[0] - 1)] + [
        nd * iv / (nd - 1) for nd, iv in zip(NDEPTHS[1:], intervals[1:])]


def err_quantiles(err: torch.Tensor) -> tuple[float, float, float]:
    err = err.flatten().float().cpu()
    return err.mean().item(), torch.quantile(err, 0.99).item(), err.max().item()


def gpu_vs_cpu(tag: str, what: str, gpu_out: dict, cpu_model, imgs, cams, dvals):
    """The same model's plain run on the CPU against a GPU forward's output,
    stage by stage: each CPU stage centres its window on the GPU's
    previous-stage depth (and, for UCSNet, takes its spread), so a stage is
    held to its own numerical differences only (DEPTH_TOL_MEAN,
    DEPTH_TOL_P99 of its step; UCSNet's windows: each pixel's own step);
    the free-running CPU cascade is reported beside it, not gated.  For the
    4-plane window confidence of the CostRegNet families also the
    confidence (CONF_TOL_MEAN, CONF_TOL_P99) and UCSNet's variance (the
    depth gates, in steps)."""
    cams_cpu = [c.to("cpu") for c in cams]
    dv_cpu = dvals.cpu()
    feats_cpu = cpu_model.features(imgs.cpu())
    free = cpu_model(imgs.cpu(), cams_cpu, dv_cpu)
    steps = stage_steps(*dv_cpu[0].tolist(), cpu_model.stage_intervals())
    for i, step in enumerate(steps):
        gpu = {k: v.cpu() for k, v in gpu_out[f"stage{i + 1}"].items()}
        prev = None if i == 0 else gpu_out[f"stage{i}"]["depth"].cpu()
        prev_var = None if i == 0 else gpu_out[f"stage{i}"].get("variance")
        prev_var = None if prev_var is None else prev_var.cpu()
        cpu = cpu_model.stage(i, feats_cpu[i], cams_cpu[i], dv_cpu[:, 0], dv_cpu[:, -1], prev,
                              prev_var)
        if cpu_model.sampler == "uncertainty" and i > 0:
            hyps = cpu_model.hypotheses(i, *cpu["depth"].shape[1:], dv_cpu[:, 0], dv_cpu[:, -1],
                                        prev, prev_var)
            step = hyps[:, 1] - hyps[:, 0]
        step_m = float(torch.as_tensor(step).mean())
        err = (gpu["depth"] - cpu["depth"]).abs() / step
        cerr = (gpu["photometric_confidence"] - cpu["photometric_confidence"]).abs()
        mean, p99 = err.mean().item(), torch.quantile(err.flatten(), 0.99).item()
        free_err = (gpu["depth"] - free[f"stage{i + 1}"]["depth"]).abs() / step
        print(f"{tag} GPU vs CPU plain, {what} stage{i + 1} (step {step_m:.3f} m), "
              f"same window centres: depth err mean {mean:.3e}, p99 {p99:.3e}, "
              f"max {err.max().item():.3e} of step (tol mean {DEPTH_TOL_MEAN}, "
              f"p99 {DEPTH_TOL_P99}), share > 1 % of step "
              f"{(err > 0.01).float().mean().item():.3e}, conf err max "
              f"{cerr.max().item():.3e}; free-running cascade: mean "
              f"{free_err.mean().item():.3e}, p99 "
              f"{torch.quantile(free_err.flatten(), 0.99).item():.3e}, max "
              f"{free_err.max().item():.3e} of step", flush=True)
        check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
              f"{what} stage{i + 1}: GPU vs CPU depth err mean {mean}, p99 {p99} of step")
        if cpu_model.confidence == "window4":
            c_mean, c_p99 = cerr.mean().item(), torch.quantile(cerr.flatten(), 0.99).item()
            line = (f"{tag} GPU vs CPU plain, {what} stage{i + 1}: window confidence err mean "
                    f"{c_mean:.3e}, p99 {c_p99:.3e} (tol {CONF_TOL_MEAN}, {CONF_TOL_P99}), share "
                    f"> 1e-3 {(cerr > 1e-3).float().mean().item():.3e}")
            check(c_mean <= CONF_TOL_MEAN and c_p99 <= CONF_TOL_P99,
                  f"{what} stage{i + 1}: GPU vs CPU confidence err mean {c_mean}, p99 {c_p99}")
            if "variance" in cpu:
                verr = (gpu["variance"] - cpu["variance"]).abs() / step
                v_mean, v_p99 = verr.mean().item(), torch.quantile(verr.flatten(), 0.99).item()
                line += (f"; variance err mean {v_mean:.3e}, p99 {v_p99:.3e}, max "
                         f"{verr.max().item():.3e} of step (the depth tolerances)")
                check(v_mean <= DEPTH_TOL_MEAN and v_p99 <= DEPTH_TOL_P99,
                      f"{what} stage{i + 1}: GPU vs CPU variance err mean {v_mean}, p99 {v_p99}")
            print(line, flush=True)


def phase_many_views(card: str):
    """Phase 2c: CascadeREDNet inference with 6 and 8 views (5 and 7 source
    views, beyond the four the sweep kernel unrolls) on a MANY_VIEWS_HW
    patch: a forward's launches, range checks and the same model's plain
    run on the CPU, stage by stage.  The views repeat the synthetic
    triplet's (nadir, forward, backward) looks with their cameras."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.ops import warp

    h, w = MANY_VIEWS_HW
    scene = synthetic.make_scene(w, h, seed=3, h_amp=80.0)
    model, cpu_model = build_model("cuda"), build_model("cpu")
    for v in MANY_VIEWS:
        order = [(2, 0, 1)[k % 3] for k in range(v)]
        views = scene["images"][order]
        views = (views - views.mean(axis=(1, 2), keepdims=True)) / (
            views.std(axis=(1, 2), keepdims=True) + 1e-8)
        imgs = torch.as_tensor(np.repeat(views[None, ..., None], 3, axis=-1).astype(np.float32),
                               device="cuda")
        cams = tuple(warp.stack_cams([c]) for c in
                     warp.build_stage_cams(scene["rpcs"][order], 0, device="cuda"))
        dvals = torch.as_tensor(scene["h_range"][None], device="cuda")
        reset_counts()
        out = model(imgs, cams, dvals)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == LAUNCHES_PER_FORWARD, f"V={v} forward launches {launches}")
        depth = out["depth"]
        check(bool(torch.isfinite(depth).all()), f"V={v}: non-finite depth")
        print(f"[views] V={v} forward at {h}x{w}: launches as one forward's (exact), depth "
              f"[{depth.min().item():.2f}, {depth.max().item():.2f}] m card={card}", flush=True)
        gpu_vs_cpu("[views]", f"V={v}", out, cpu_model, imgs, cams, dvals)


def phase_slice(card: str) -> dict:
    """Phase 3: the main path, three predictions; returns each kernel's launches."""
    from satmvs_tpu_torch.data import synthetic

    model = build_model("cuda")
    batches = [synthetic.make_batch(1, WIDTH, HEIGHT, seed=s, device="cuda") for s in SEEDS]
    torch.cuda.synchronize()

    wrappers = kernel_wrappers()
    reset_counts()
    outs = []
    for i, b in enumerate(batches):
        outs.append(model(b["imgs"], b["cams"], b["depth_values"]))
        for name, fn in wrappers.items():
            want = LAUNCHES_PER_FORWARD[name] * (i + 1)
            check(fn.launches == want,
                  f"{name} launches {fn.launches} after {i + 1} forwards, want {want}")
    torch.cuda.synchronize()
    launches = counts()
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

    t0 = time.time()
    b0 = batches[0]
    gpu_vs_cpu("[slice]", "seed 0", outs[0], build_model("cpu"), b0["imgs"], b0["cams"],
               b0["depth_values"])
    print(f"[slice] CPU plain runs took {time.time() - t0:.1f} s", flush=True)

    imgs, cams, dvals = b0["imgs"], b0["cams"], b0["depth_values"]
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = time_ms(lambda: model(imgs, cams, dvals), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] forward_ms={fwd_ms:.2f} (median of 5, CUDA events, B=1, "
          f"{HEIGHT}x{WIDTH}, 3 views) peak_mem={peak:.2f} GiB card={card}", flush=True)
    profile_forward(lambda: model(imgs, cams, dvals), card)
    return launches


def chunk_launches(bt: int) -> dict:
    """Launches of one streaming forward of bt tiles: per slab one
    sweep_variance and one RED pipeline, each for the whole batch
    (`build_stage_volume` builds all bt tiles' volumes of a slab in one
    launch; conv_dn ×3, red_recur ×4, deconv_up ×3, conv_head), whatever
    bt is."""
    n = sum(SLABS_PER_TILE)
    return {**{k: 0 for k in LAUNCHES_PER_FORWARD}, "sweep_variance": n, "conv_dn": 3 * n,
            "red_recur": 4 * n, "deconv_up": 3 * n, "conv_head": n}


def render_scene() -> dict:
    """The 1152² synthetic triplet (host numpy, seeded); runs in a worker
    process, so it puts the repository on its own import path."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from satmvs_tpu_torch.data import synthetic

    return synthetic.make_scene(SCENE_SIZE, SCENE_SIZE, seed=0, h_amp=80.0)


def phase_scene(card: str, model, scene: dict):
    """Phase 5: predict_scene over the slab-streaming forward at batch_tiles
    4 and 1.  Returns each run's launches and the first 4-tile chunk's
    inputs (phase 4 takes them)."""
    import functools

    from satmvs_tpu_torch.geo import rpc as rpclib
    from satmvs_tpu_torch.infer.predict import streaming_red_forward
    from satmvs_tpu_torch.infer.scene import predict_scene

    order = [2, 0, 1]  # the nadir view is the reference
    images, rpcs = scene["images"][order], scene["rpcs"][order]
    lo, hi = rpclib.height_range(rpcs[0])
    intervals = model.stage_intervals()
    margin = sum(nd / 2 * iv for nd, iv in zip(NDEPTHS[1:], intervals[1:]))
    stream = functools.partial(streaming_red_forward, model, slab=SLAB)
    runs, chunks = {}, []
    for bt in (BATCH_TILES, 1):
        per_call = []

        def forward(imgs, cams, dvals):
            before = counts()
            out = stream(imgs, cams, dvals)
            per_call.append({k: v - before[k] for k, v in counts().items()})
            if not chunks:
                chunks.append((imgs, cams, dvals))
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stats = {}
        depth, conf = predict_scene(forward, images, rpcs, tile=TILE, halo=HALO,
                                    batch_tiles=bt, stats=stats)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = counts()
        want = chunk_launches(bt)
        n_chunks = stats["n_chunks"]
        check(stats["n_tiles"] == 9 and n_chunks == -(-9 // bt),
              f"scene B={bt}: {stats['n_tiles']} tiles in {n_chunks} chunks")
        check(len(per_call) == n_chunks and all(c == want for c in per_call),
              f"scene B={bt}: launches per chunk {per_call}, want {want}")
        check(launches == {k: v * n_chunks for k, v in want.items()},
              f"scene B={bt}: launches {launches}")
        check(depth.shape == conf.shape == (SCENE_SIZE, SCENE_SIZE), f"scene shape {depth.shape}")
        check(bool(np.isfinite(depth).all() and np.isfinite(conf).all()), "scene: non-finite map")
        dmin, dmax = float(depth.min()), float(depth.max())
        check(lo - margin - 1e-3 <= dmin and dmax <= hi + margin + 1e-3,
              f"scene B={bt}: depth [{dmin}, {dmax}] outside [{lo - margin}, {hi + margin}]")
        check(0.0 <= conf.min() and conf.max() <= 1.0 + 1e-6,
              f"scene B={bt}: confidence [{conf.min()}, {conf.max()}]")
        print(f"[scene] B={bt}: {stats['n_tiles']} tiles of {TILE_HW}x{TILE_HW} in {n_chunks} "
              f"chunks; launches per chunk {per_call[0]} (exact), in all {launches}; depth "
              f"[{dmin:.2f}, {dmax:.2f}] m (range {lo:.0f}..{hi:.0f} ± {margin:g}), confidence "
              f"[{conf.min():.4f}, {conf.max():.4f}]", flush=True)
        # a chunk's mark spans queueing the next chunk and reading this one
        # back, so where queueing is slower than the card the marks are host
        # time and the last one is near 0
        print(f"[scene] B={bt}: wall {stats['wall_s']:.3f} s = "
              f"{1e3 * stats['wall_s'] / stats['n_tiles']:.1f} ms per tile, "
              f"{1e3 * stats['wall_s'] / (n_chunks * bt):.1f} ms per tile forward "
              f"({n_chunks * bt} with the pads); host prep "
              f"{stats['host_prep_s']:.3f} s ({stats['host_prep_s'] / stats['wall_s']:.3f} of "
              f"wall), readback {stats['readback_s']:.3f} s, chunks "
              f"{[round(t, 4) for t in stats['chunk_s']]} s; peak_mem={peak:.2f} GiB "
              f"card={card}", flush=True)
        runs[bt] = (depth, conf, launches)
    # the largest part of the host prep: norm="tile" normalizes each view crop
    from satmvs_tpu_torch.data.preprocess import center_image

    crop = np.repeat(images[0][..., None], 3, axis=-1)[:TILE_HW, :TILE_HW]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(len(order)):
            center_image(crop)
        times.append(time.perf_counter() - t0)
    print(f"[scene] host: center_image of one tile's {len(order)} view crops "
          f"{1e3 * float(np.median(times)):.1f} ms (median of 5)", flush=True)
    step = stage_steps(lo, hi, intervals)[-1]
    mean, p99, mx = err_quantiles(
        torch.from_numpy(np.abs(runs[BATCH_TILES][0] - runs[1][0]) / step))
    print(f"[scene] B={BATCH_TILES} vs B=1 stitched depth: err mean {mean:.3e}, p99 {p99:.3e}, "
          f"max {mx:.3e} of the final step ({step:.3f} m; tol mean {DEPTH_TOL_MEAN}, p99 "
          f"{DEPTH_TOL_P99}); confidence err max "
          f"{np.abs(runs[BATCH_TILES][1] - runs[1][1]).max():.3e}", flush=True)
    check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
          f"scene B={BATCH_TILES} vs B=1: depth err mean {mean}, p99 {p99} of step")
    print(f"[scene] profile of one {BATCH_TILES}-tile chunk:", flush=True)
    profile_forward(lambda: stream(*chunks[0]), card)
    return {f"scene_b{bt}": run[2] for bt, run in runs.items()}, chunks[0]


def phase_stream_vs_full(card: str, model, chunk) -> dict:
    """Phase 4: the streaming forward (slab 8) against the same model's
    full-volume forward on one 4-tile chunk, stage by stage (each
    full-volume stage centred on the streaming run's previous-stage depth),
    and the peak memory of each.  Returns the streaming run's launches."""
    from satmvs_tpu_torch.infer.predict import streaming_red_forward

    imgs, cams, dvals = chunk
    bt = imgs.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stream = streaming_red_forward(model, imgs, cams, dvals, slab=SLAB)
    torch.cuda.synchronize()
    launches = counts()
    peak_stream = torch.cuda.max_memory_allocated() / 2**30
    check(launches == chunk_launches(bt), f"streaming launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    full = model(imgs, cams, dvals)
    torch.cuda.synchronize()
    peak_full = torch.cuda.max_memory_allocated() / 2**30
    feats = model.features(imgs)
    d_min, d_max = dvals[:, 0], dvals[:, -1]
    intervals = model.stage_intervals()
    for i, step in enumerate(stage_steps(*dvals[0].tolist(), intervals)):
        prev = None if i == 0 else stream[f"stage{i}"]["depth"]
        ref = model.stage(i, feats[i], cams[i], d_min, d_max, prev)
        got = stream[f"stage{i + 1}"]
        mean, p99, mx = err_quantiles((got["depth"] - ref["depth"]).abs() / step)
        cerr = (got["photometric_confidence"] - ref["photometric_confidence"]).abs().max().item()
        fmean, fp99, fmx = err_quantiles(
            (got["depth"] - full[f"stage{i + 1}"]["depth"]).abs() / step)
        print(f"[stream] B={bt} slab {SLAB} vs full volume, stage{i + 1} (step {step:.3f} m), "
              f"same window centres: depth err mean {mean:.3e}, p99 {p99:.3e}, max {mx:.3e} of "
              f"step (tol mean {DEPTH_TOL_MEAN}, p99 {DEPTH_TOL_P99}), conf err max {cerr:.3e}; "
              f"free-running: mean {fmean:.3e}, p99 {fp99:.3e}, max {fmx:.3e}", flush=True)
        check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
              f"stage{i + 1}: streaming vs full depth err mean {mean}, p99 {p99} of step")
    s_ms = time_ms(lambda: streaming_red_forward(model, imgs, cams, dvals, slab=SLAB), reps=3,
                   warmup=1)
    f_ms = time_ms(lambda: model(imgs, cams, dvals), reps=3, warmup=1)
    print(f"[stream] B={bt} tiles of {TILE_HW}x{TILE_HW}: streaming {s_ms:.2f} ms "
          f"({s_ms / bt:.2f} per tile), peak_mem={peak_stream:.2f} GiB; full volume "
          f"{f_ms:.2f} ms ({f_ms / bt:.2f} per tile), peak_mem={peak_full:.2f} GiB (median of "
          f"3, CUDA events) card={card}", flush=True)
    return launches


def gather_work(src, xs, ys) -> tuple[float, float]:
    """Bytes (output or cotangent once, coordinates once, source or its
    cotangent once) and flops (valid taps only: a multiply and an add per
    channel) of one sweep_gather or sweep_scatter on this data; the same
    for both."""
    d, h, w = xs.shape
    c = src.shape[-1]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    taps = sum(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)).sum().item()
               for dx in (0, 1) for dy in (0, 1))
    return 4 * (d * h * w * c + 2 * d * h * w + h * w * c), 2 * c * taps


def grid_sample_calls(src, xs, ys, g):
    """grid_sample (bilinear, zero padding, align_corners=True: the same
    function up to the rounding of the normalisation) over all D planes in
    one call, and its input gradient: the library yardsticks of the pair."""
    import torch.nn.functional as F

    d, h, w = xs.shape
    inp = src.permute(2, 0, 1)[None].contiguous().requires_grad_(True)  # (1, C, H, W)
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1).reshape(
        1, d * h, w, 2)
    out = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    gout = g.permute(3, 0, 1, 2).reshape(1, -1, d * h, w).contiguous()

    def forward():
        with torch.no_grad():
            return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

    return forward, lambda: torch.autograd.grad(out, inp, gout, retain_graph=True)


def phase_sweep_gather(card: str) -> list[dict]:
    """Phase 6: sweep_gather and sweep_scatter against their plain versions
    at the training shapes (both source views of every stage), and with
    coordinates pushed off the image."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.geo import rpc as rpclib
    from satmvs_tpu_torch.ops import warp
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    rpcs = synthetic.make_rpc_triplet(WIDTH, HEIGHT, seed=0)
    rpcs = np.stack([rpcs[2], rpcs[0], rpcs[1]])  # nadir reference first
    stage_cams = warp.build_stage_cams(rpcs, 0, device="cuda")
    h_min, h_max = rpclib.height_range(rpcs[0])
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for i, (cams, scale, nd, c) in enumerate(zip(stage_cams, STAGE_SCALES, NDEPTHS, FEAT_CH)):
        h, w = HEIGHT // scale, WIDTH // scale
        depths = torch.linspace(h_min, h_max, nd, device="cuda")
        for s in range(2):
            xs, ys = (t.contiguous() for t in warp.rpc_sweep_coords(cams, s, depths, h, w))
            src = torch.randn((h, w, c), generator=gen, device="cuda")
            g = torch.randn((nd, h, w, c), generator=gen, device="cuda")
            cases.append((f"stage{i + 1} view{s} {(nd, h, w, c)}", src, xs, ys, g))
    _, src, xs, ys, g = cases[0]
    h, w = src.shape[:2]
    xs_off, ys_off = xs * 1.5 - 0.25 * w, ys * 1.5 - 0.25 * h
    xs_off.view(-1)[::97] = 1e9
    ys_off.view(-1)[::89] = -1e9
    cases.append(("off-image", src, xs_off, ys_off, g))

    gather = KernelReport("sweep_gather", "satmvs_tpu_torch/csrc/sweep_gather.cu",
                          "satmvs_tpu/ops/pallas/sweep_gather.py:400", card)
    scatter = KernelReport("sweep_scatter", "satmvs_tpu_torch/csrc/sweep_gather.cu",
                           "satmvs_tpu/ops/pallas/sweep_gather.py:558", card)
    dev = [0.0, 0.0]  # the gather's and grid_sample's times back to back over the six views
    for label, src, xs, ys, g in cases:
        timed = label != "off-image"
        fwd, bwd = grid_sample_calls(src, xs, ys, g)
        work = gather_work(src, xs, ys)
        gather.case(label, lambda: sg.sweep_gather(src, xs, ys),
                    lambda: sg.sweep_gather_reference(src, xs, ys), rel_tol, *work,
                    fwd, timed=timed)
        if timed:
            # without the host's launch time, which the event times above
            # include for calls this short
            k_dev = loop_ms(lambda: sg.sweep_gather(src, xs, ys))
            l_dev = loop_ms(fwd)
            dev[0] += k_dev
            dev[1] += l_dev
            print(f"[sweep] sweep_gather {label}: back to back {k_dev:.4f} ms, grid_sample "
                  f"{l_dev:.4f} ms card={card}", flush=True)
        # each dsrc element is a sum of at most 4·D products: two summation
        # orders differ by at most 2·(4·D − 1)·2⁻²⁴ × the sum of its terms'
        # magnitudes (the plain scatter of |g|); its maximum over the elements
        d, h, w = xs.shape
        mag = sg.sweep_scatter_reference(g.abs(), xs, ys, h, w).max().item()
        tol = 2 * (4 * d - 1) * 2.0 ** -24 * mag
        scatter.case(label, lambda: sg.sweep_scatter(g, xs, ys),
                     lambda: sg.sweep_scatter_reference(g, xs, ys, h, w), lambda want: tol,
                     *work, bwd, timed=timed)
        again = (sg.sweep_scatter(g, xs, ys) - sg.sweep_scatter(g, xs, ys)).abs().max().item()
        print(f"[sweep] sweep_scatter {label}: run-to-run max abs difference {again:.3e} "
              f"(atomics; summation bound {tol:.3e}, largest element magnitude sum "
              f"{mag:.3e})", flush=True)
        check(again <= tol, f"sweep_scatter {label}: run-to-run {again} > {tol}")
        if timed:
            scatter_runs(label, g, xs, ys, card)
    print(f"[sweep] sweep_gather over the six views of a train step, back to back: "
          f"{dev[0]:.4f} ms, grid_sample {dev[1]:.4f} ms card={card}", flush=True)
    return [gather.record(), scatter.record()]


def scatter_runs(label: str, g, xs, ys, card: str):
    """What the scatter's runs over planes buy: its time at the wrapper's
    planes per thread against one plane a thread (each sample's four float4
    atomics, nothing summed in registers), and the share of samples whose
    floor corner equals the previous plane's inside a run (what the runs
    save).  Comparison launches: not counted."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    d, h, w, c = g.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planes = sg.scatter_planes(d, h, w, c // 4 if c % 4 == 0 else c, sms)

    def scatter(p):
        dsrc = torch.zeros((h, w, c), dtype=torch.float32, device="cuda")
        sg._launch("sweep_scatter", g, xs, ys, dsrc, d, h, w, c, p)
        return dsrc

    x0, y0 = torch.floor(xs), torch.floor(ys)
    same = (x0[1:] == x0[:-1]) & (y0[1:] == y0[:-1])
    in_run = (torch.arange(1, d, device="cuda") % planes != 0)[:, None, None]
    share = (same & in_run).sum().item() / xs.numel()
    one, runs = time_ms(lambda: scatter(1), reps=10), time_ms(lambda: scatter(planes), reps=10)
    print(f"[sweep] sweep_scatter {label}: {planes} planes a thread {runs:.4f} ms, one plane a "
          f"thread {one:.4f} ms; samples that reuse the previous plane's corner: {share:.3f} "
          f"card={card}", flush=True)


# red_recur's backward against its plain backward, each cotangent, × max(1,
# max |plain|): the kernel recomputes the GroupNorm statistics in float64,
# the plain backward in torch's fp32 moments, and the difference is carried
# back through up to 64 planes of the reverse recurrence and summed over
# every pixel and plane into the weight cotangents
RED_BWD_TOL = 1e-3
# the convs' weight and bias cotangents against their plain versions run in
# float64, per element: REDUCE_TOL × Σ |terms| of that element's sum over up
# to 2.4 M pixels.  The kernel sums in fp32 runs of ~10³ pixels, then in
# float64; the worst case of such sums is ~10³·2⁻²⁴·Σ |terms|, what rounding
# gives is far less.  1e-6 is ~17·2⁻²⁴.  The bound must also be at most
# REDUCE_SHARE of the largest exact value of its tensor, so a reduction that
# was zeroed or had its sign flipped fails
REDUCE_TOL, REDUCE_SHARE = 1e-6, 1e-2


def phase_red_backward(card: str) -> list[dict]:
    """Phase 8: the backward kernels of the fused RED regularizer against
    their plain backwards at every shape of a 384×768, B = 1 train step
    (conv_dn ×9, red_recur ×12, deconv_up ×9, conv_head ×3), each cotangent
    held to its own tolerance; a second run must give the same bits (no
    atomics); kernel, plain, bound and cuDNN-gradient times (red_recur has
    no library call: null)."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.ops.kernels import plane_conv as pc
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def library_grad(fn, inputs, g):
        """torch.autograd.grad through one functional conv call (cuDNN's
        gradient), the graph built once: the yardstick."""
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)

    def same_bits(label, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{label}: two runs differ (the reductions are meant to be fixed-order)")

    def flat(res):
        dx, dps = res
        return (dx, *dps)

    def summed(what, mags):
        """The tolerance of a reduction whose terms' magnitudes sum to mags,
        checked to be far under the exact values it is applied to."""
        bound = REDUCE_TOL * mags

        def tol(want):
            share = bound.max().item() / want.abs().max().item()
            print(f"[backward] {what}: bound {bound.max().item():.3e} is {share:.3e} of the "
                  f"largest value (at most {REDUCE_SHARE})", flush=True)
            check(share <= REDUCE_SHARE, f"{what}: the bound does not hold the reduction")
            return bound
        return tol

    def f64(*ts):
        return [t.double() for t in ts]

    wg = KernelReport("wgrad3x3", "satmvs_tpu_torch/csrc/plane_conv.cu",
                      "satmvs_tpu/ops/pallas/plane_conv.py:424", card)

    def wgrad_case(label, a1, b_, stride, taps, library, a2=None, amask=None, bmask=None,
                   bias=False):
        """The weight reduction alone at one call shape of the step: against
        the plain version in float64 per element (REDUCE_TOL × Σ |terms|),
        its time beside cuDNN's weight-only gradient (`library`, on the
        masked operands), the bound from the multiply-adds of the valid taps
        and the bytes of A, B, their masks and the result."""
        kw = {"a2": a2, "amask": amask, "bmask": bmask, "bias": bias}
        f64 = {k: (v.double() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        mags = pc.wgrad3x3_reference(a1.abs().double(), b_.abs().double(), stride,
                                     **{**f64, "a2": None if a2 is None else a2.abs().double()})
        pick = (lambda r: r) if bias else (lambda r: r[0])  # noqa: E731
        tols = tuple(summed(f"wgrad3x3 {label} {what}", m)
                     for what, m in zip(("dweight", "dbias"), mags) if m is not None)
        ca, cb = a1.shape[-1] + (0 if a2 is None else a2.shape[-1]), b_.shape[-1]
        reads = sum(t.numel() for t in (a1, a2, amask, b_, bmask) if t is not None)
        wg.case(label, lambda: pick(pc.wgrad3x3("wgrad3x3", a1, b_, stride, **kw)),
                lambda: pick(pc.wgrad3x3_reference(a1, b_, stride, **kw)),
                tols if bias else tols[0], 4 * (reads + 9 * ca * cb + (cb if bias else 0)),
                2 * taps * ca * cb + (b_.numel() if bias else 0), library,
                exact=lambda: pick(pc.wgrad3x3_reference(a1.double(), b_.double(), stride,
                                                        **f64)))

    def cudnn_wgrad(grad_out, inp, wt, stride, transposed=False, bias=False):
        """cuDNN's weight (and bias) gradient alone: one aten call."""
        pad, op = [1, 1], [1, 1] if transposed else [0, 0]
        return lambda: torch.ops.aten.convolution_backward(
            grad_out, inp, wt, [wt.shape[0]] if bias else None, [stride] * 2, pad, [1, 1],
            transposed, op, 1, [False, True, bias])

    b = RED_BASE
    dn = KernelReport("conv_dn_backward", "satmvs_tpu_torch/csrc/plane_conv.cu",
                      "satmvs_tpu/ops/pallas/plane_conv.py:424", card)
    rec = KernelReport("red_recur_backward", "satmvs_tpu_torch/csrc/red_recur.cu",
                       "satmvs_tpu/ops/pallas/red_recur.py:755", card)
    up = KernelReport("deconv_up_backward", "satmvs_tpu_torch/csrc/plane_conv.cu",
                      "satmvs_tpu/ops/pallas/plane_conv.py:610", card)
    head = KernelReport("conv_head_backward", "satmvs_tpu_torch/csrc/plane_conv.cu",
                        "satmvs_tpu/ops/pallas/plane_conv.py:768", card)
    adjoint = []  # (adjoint alone ms, row 6 ms, adjoint's bound ms) per red_recur call
    dx_alone = {}  # backward → [(dx kernel's device ms, its bound ms)] per call

    def dx_case(report, label, fn, call):
        """The dx kernel alone in a backward (call as `plane_calls` lists it):
        its device time under torch.profiler, the weight reduction's kernels
        not counted, beside its own bound (it reads g, the gate and w, and
        writes dx; its multiply-adds are the forward's)."""
        pick = (lambda k: "deconv3x3" in k) if call[3] else conv3x3_kernel_name
        ms = device_ms(fn, pick, 5)
        b_ms, by = bound_ms(*plane_work(*call[1:]))
        dx_alone.setdefault(report, []).append((ms, b_ms))
        print(f"[backward] {report} {label}: the dx kernel alone {ms:.4f} ms (device), bound "
              f"{b_ms:.4f} ms ({by}), dx/bound {ms / b_ms:.2f} card={card}", flush=True)
        plane_same_bits(f"{report} dx", label, fn, call[2:])
    for stage, d, h, w, cin in red_shapes():
        for k, (s, ci, co) in enumerate(((1, cin, 2 * b), (2, 2 * b, 4 * b), (4, 4 * b, 8 * b))):
            x = randn(d, h // s, w // s, ci)
            wt = randn(co, ci, 3, 3, scale=(2.0 / (9 * ci)) ** 0.5)
            y = pc.conv_dn_reference(x, wt)
            g = randn(*y.shape)
            taps = conv_taps(h // s, h // s // 2, 2) * conv_taps(w // s, w // s // 2, 2)
            label = f"{stage} enc{k + 1} {(d, h // s, w // s, ci)}->{co}"
            mags = pc.conv_dn_backward_reference(*f64(x.abs(), wt), y, g.abs().double())[1]
            # reads x, y, g and the weight, writes dx and dweight; dx and dweight
            # are each the forward's multiply-adds
            dn.case(label, lambda: pc.conv_dn_backward(x, wt, y, g),
                    lambda: pc.conv_dn_backward_reference(x, wt, y, g),
                    (rel_tol, summed(f"conv_dn_backward {label} dweight", mags)),
                    4 * (2 * x.numel() + 2 * y.numel() + 2 * wt.numel()),
                    2 * 2 * d * taps * ci * co,
                    library_grad(lambda x_, w_: F.relu(F.conv2d(nchw(x_), w_, stride=2,
                                                                padding=1)), (x, wt), nchw(g)),
                    exact=lambda: pc.conv_dn_backward_reference(*f64(x, wt), y, g.double()))
            same_bits(f"conv_dn_backward {label}", lambda: pc.conv_dn_backward(x, wt, y, g))
            dx_case("conv_dn_backward", label, lambda: pc.conv_dn_backward(x, wt, y, g),
                    (label, "conv_dn dx", 2, True, d, h // s // 2, w // s // 2, co, ci, True))
            dz = torch.where(y > 0, g, torch.zeros_like(g))
            wgrad_case(f"{label} conv_dn", x, g, 2, d * taps,
                       cudnn_wgrad(nchw(dz), nchw(x), wt, 2), bmask=y)
        for s, ci, c in red_scales(cin):
            cell = red_cell(ci, c, s, randn)
            x = randn(1, d, h // s, w // s, ci)
            with torch.no_grad():
                out = rr.red_recur(x, cell)  # states in (-1, 1) over all D planes
            g = randn(*out.shape)
            nbytes, flops = recur_work(x, c, cell)
            label = f"{stage} scale{s} {(d, h // s, w // s, ci)}->{c}"
            # recompute, data cotangents and weight cotangents: three times the
            # forward's multiply-adds; reads x, the states and g, writes dx and
            # the parameters' cotangents
            row6 = rec.case(label, lambda: flat(rr.red_recur_backward(x, out, g, cell)),
                            lambda: flat(rr.red_recur_backward_reference(x, out, g, cell)),
                            lambda want: RED_BWD_TOL * max(1.0, want.abs().max().item()),
                            2 * nbytes + 4 * out.numel(), 3 * flops)
            same_bits(f"red_recur_backward {label}",
                      lambda: flat(rr.red_recur_backward(x, out, g, cell)))
            # the adjoint kernel alone (and the weight layouts it is given),
            # without its two weight reductions: the recompute and the data
            # cotangents, twice the forward's multiply-adds
            h0 = torch.zeros_like(out[:, 0])
            adj = loop_ms(lambda: rr._adjoint(x, out, g, cell, h0), 5)
            adj_bound, _ = bound_ms(0.0, 2 * flops)
            adjoint.append((adj, row6, adj_bound))
            print(f"[backward] red_recur_bwd_kernel {label}: adjoint alone {adj:.4f} ms (back "
                  f"to back), row 6 {row6:.4f} ms, adjoint's share of the operations "
                  f"bound {adj_bound:.4f} ms, adjoint/bound {adj / adj_bound:.2f} card={card}",
                  flush=True)
            # its two reductions over all planes, on seeded cotangents of
            # their shapes: the gates over [x | h_prev], the candidate over
            # [x | r·h_prev], each with its bias
            xs, hp = x[0], torch.tanh(randn(d, h // s, w // s, c))
            taps_r = d * conv_taps(h // s, h // s, 1) * conv_taps(w // s, w // s, 1)
            xh = nchw(torch.cat([xs, hp], dim=-1))
            for what, width in (("gates", 2 * c), ("candidate", c)):
                cot = randn(d, h // s, w // s, width)
                wcat = torch.empty((width, ci + c, 3, 3), device="cuda")
                wgrad_case(f"{label} red_recur {what}", xs, cot, 1, taps_r,
                           cudnn_wgrad(nchw(cot), xh, wcat, 1, bias=True), a2=hp, bias=True)
        for k, (s, ci, co) in enumerate(((8, 8 * b, 4 * b), (4, 4 * b, 2 * b), (2, 2 * b, b))):
            x = randn(d, h // s, w // s, ci)
            wt = randn(ci, co, 3, 3, scale=(2.0 / (9 * ci)) ** 0.5)
            act = pc.deconv_up_reference(x, wt)
            skip = randn(*act.shape)
            g = randn(*act.shape)
            taps = (3 * (h // s) - 1) * (3 * (w // s) - 1)
            label = f"{stage} up{3 - k} {(d, h // s, w // s, ci)}->{co}"
            mags = pc.deconv_up_backward_reference(*f64(x.abs(), wt), act, g.abs().double())[1]
            up.case(label, lambda: pc.deconv_up_backward(x, wt, act, g),
                    lambda: pc.deconv_up_backward_reference(x, wt, act, g),
                    (rel_tol, summed(f"deconv_up_backward {label} dweight", mags)),
                    4 * (2 * x.numel() + 2 * act.numel() + 2 * wt.numel()),
                    2 * 2 * d * taps * ci * co,
                    library_grad(lambda x_, w_, s_: F.relu(F.conv_transpose2d(
                        nchw(x_), w_, stride=2, padding=1, output_padding=1)) + nchw(s_),
                        (x, wt, skip), nchw(g)),
                    exact=lambda: pc.deconv_up_backward_reference(*f64(x, wt), act, g.double()))
            same_bits(f"deconv_up_backward {label}", lambda: pc.deconv_up_backward(x, wt, act, g))
            dx_case("deconv_up_backward", label, lambda: pc.deconv_up_backward(x, wt, act, g),
                    (label, "deconv_up dx", 2, False, d, 2 * (h // s), 2 * (w // s), co, ci,
                     True))
            dz = torch.where(act > 0, g, torch.zeros_like(g))
            wgrad_case(f"{label} deconv_up", g, x, 2, d * taps,
                       cudnn_wgrad(nchw(dz), nchw(x), wt, 2, transposed=True), amask=act)
        x = randn(d, h, w, b)
        wt, bias = randn(1, b, 3, 3, scale=(2.0 / (9 * b)) ** 0.5), randn(1)
        # a mean of 1, so the bias cotangent Σ g does not cancel to near 0
        g = randn(d, h, w, 1) + 1.0
        taps = conv_taps(h, h, 1) * conv_taps(w, w, 1)
        label = f"{stage} head {(d, h, w, b)}->1"
        _, mags_w, mags_b = pc.conv_head_backward_reference(*f64(x.abs(), wt, g.abs()))
        head.case(label, lambda: pc.conv_head_backward(x, wt, g),
                  lambda: pc.conv_head_backward_reference(x, wt, g),
                  (rel_tol, summed(f"conv_head_backward {label} dweight", mags_w),
                   summed(f"conv_head_backward {label} dbias", mags_b)),
                  4 * (2 * x.numel() + g.numel() + 2 * wt.numel() + 2),
                  2 * 2 * d * taps * b + g.numel(),
                  library_grad(lambda x_, w_, b_: F.conv2d(nchw(x_), w_, b_, padding=1),
                               (x, wt, bias), nchw(g)),
                  exact=lambda: pc.conv_head_backward_reference(*f64(x, wt, g)))
        same_bits(f"conv_head_backward {label}", lambda: pc.conv_head_backward(x, wt, g))
        dx_case("conv_head_backward", label, lambda: pc.conv_head_backward(x, wt, g),
                (label, "conv_head dx", 1, False, d, h, w, 1, b, False))
        wgrad_case(f"{label} conv_head", x, g, 1, d * taps,
                   cudnn_wgrad(nchw(g), nchw(x), wt, 1, bias=True), bias=True)
    print("[backward] every backward kernel gave the same bits in a second run (fixed-order "
          "reductions, no atomics)", flush=True)
    adj, row6, adj_bound = (sum(t[i] for t in adjoint) for i in range(3))
    print(f"[backward] red_recur_bwd_kernel over the 12 calls of a train step: adjoint alone "
          f"{adj:.4f} ms (back to back), row 6 {row6:.4f} ms, adjoint's share of the operations "
          f"bound {adj_bound:.4f} ms, adjoint/bound {adj / adj_bound:.2f} card={card}",
          flush=True)
    wrec = wg.record()
    print(f"[backward] wgrad3x3 over the 45 weight reductions of a train step: kernel "
          f"{wrec['ms']:.4f} ms, bound {wrec['bound_ms']:.4f} ms ({wrec['bound_by']}), plain "
          f"{wrec['plain_ms']:.4f} ms, cuDNN weight-only gradients {wrec['library_ms']:.4f} ms "
          f"card={card}", flush=True)
    records = [dn.record(), rec.record(), up.record(), head.record(), wrec]
    for r in records:
        if r["name"] in dx_alone:  # the row's dx kernel alone, over its calls of a step
            r["dx_device_ms"], r["dx_bound_ms"] = (sum(t[i] for t in dx_alone[r["name"]])
                                                   for i in (0, 1))
            print(f"[backward] {r['name']} over its {len(dx_alone[r['name']])} calls of a "
                  f"train step: the row {r['ms']:.4f} ms (events), its dx kernel alone "
                  f"{r['dx_device_ms']:.4f} ms (device), the dx's bound {r['dx_bound_ms']:.4f} "
                  f"ms, cuDNN's gradient {r['library_ms']:.4f} ms card={card}", flush=True)
    return records


TRAIN_STEPS = 5
SCAN_STEPS = 2
PARITY_SIZE, PARITY_NDEPTHS = (96, 192), (16, 8, 4)
# GPU vs CPU, one step at PARITY_SIZE, where cuDNN's conv algorithms and
# the scatter's atomics sum in other orders than the CPU.  At this size the
# gradients are ill-conditioned: on the CPU, perturbing the images by 1e-7
# relative (rounding level) moves the eval-mode gradients by up to 1.2e-2
# relative norm per tensor (median 3.1e-3, 2.4e-3 over all) and the update
# by up to 3.5e-2 (5.5e-3 over all).  Gates, a few times those: the loss to
# 1e-4 relative; eval-mode gradients to a relative norm of 5e-2 per
# parameter tensor and 1e-2 over all, the logit-head biases, whose gradient
# is 0 up to rounding (a softmax ignores a shift of all logits), to 1e-6 of
# the largest gradient element; the train-mode update (new − old
# parameters) to 0.25 per tensor and 0.05 over all (train-mode BatchNorm
# amplifies rounding, and RMSprop's first step carries it through
# small-gradient elements); running statistics to 1e-4 of each tensor's
# largest value
PARITY_LOSS, PARITY_GRAD, PARITY_GRAD_ALL, PARITY_HEAD = 1e-4, 5e-2, 1e-2, 1e-6
PARITY_UPDATE, PARITY_UPDATE_ALL, PARITY_STATS = 0.25, 0.05, 1e-4


def lecun_scale(model):
    """Scale the seeded He-normal kernels to flax's LeCun scale (variance
    1/fan_in), as the CPU tests seed them: at He scale the random cascade
    amplifies rounding (PERF.md, ROADMAP C)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Conv3d,
                              torch.nn.ConvTranspose3d)):
                m.weight.mul_(0.5 ** 0.5)
    return model


def batch_to(batch: dict, device) -> dict:
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else
                tuple(c.to(device) for c in v) if k == "cams" else [t.to(device) for t in v])
            for k, v in batch.items()}


def phase_train_parity(card: str):
    """Phase 7, last part: one eval-mode gradient and one train step at
    PARITY_SIZE on the card and on the CPU from the same weights and batch."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models.losses import cascade_loss
    from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step

    t0 = time.time()
    h, w = PARITY_SIZE
    cpu_batch = synthetic.make_batch(1, w, h, seed=1, device="cpu")
    cfg = Config(ndepths=PARITY_NDEPTHS, seed=5)
    runs = {}
    for dev in ("cuda", "cpu"):
        batch = batch_to(cpu_batch, dev)
        model, state, tx = create_model_and_state(cfg, batch, 1)
        lecun_scale(model)
        old = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        out = model.run_cascade(batch["imgs"], batch["cams"], batch["depth_values"], False)
        loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"], cfg.dlossw)[0]
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        state, scalars = make_train_step(model, tx, cfg.dlossw)(state, batch)
        runs[dev] = {"loss": loss.item(), "step_loss": scalars["loss"].item(), "old": old,
                     "grads": {n: g.cpu() for n, g in zip(names, grads)},
                     "params": {k: v.detach().cpu() for k, v in state.params.items()},
                     "stats": {k: v.cpu() for k, v in state.batch_stats.items()}}
    gpu, cpu = runs["cuda"], runs["cpu"]
    for name in ("loss", "step_loss"):
        rel = abs(gpu[name] - cpu[name]) / abs(cpu[name])
        print(f"[train] fused step GPU vs CPU {h}x{w} ndepths {PARITY_NDEPTHS}: {name} "
              f"{gpu[name]:.6f} vs "
              f"{cpu[name]:.6f}, {rel:.3e} relative (tol {PARITY_LOSS})", flush=True)
        check(rel <= PARITY_LOSS, f"train parity: {name} {rel} relative")
    scale = max(g.abs().max().item() for g in cpu["grads"].values())
    worst, head, g_num, g_den = 0.0, 0.0, 0.0, 0.0
    for n, g in gpu["grads"].items():
        diff = (g - cpu["grads"][n]).norm().item()
        if n.endswith("head.bias"):
            head = max(head, diff / scale)
        else:
            worst = max(worst, diff / cpu["grads"][n].norm().item())
            g_num += diff ** 2
            g_den += cpu["grads"][n].norm().item() ** 2
    num = den = upd = 0.0
    for n, p in gpu["params"].items():
        if n.endswith("head.bias"):
            continue
        d_gpu, d_cpu = p - gpu["old"][n], cpu["params"][n] - cpu["old"][n]
        num += (d_gpu - d_cpu).norm().item() ** 2
        den += d_cpu.norm().item() ** 2
        upd = max(upd, (d_gpu - d_cpu).norm().item() / d_cpu.norm().item())
    stats = max((v - cpu["stats"][n]).abs().max().item() / cpu["stats"][n].abs().max().item()
                for n, v in gpu["stats"].items())
    total = (num / den) ** 0.5
    g_total = (g_num / g_den) ** 0.5
    print(f"[train] GPU vs CPU: eval-mode gradients max relative norm {worst:.3e} over "
          f"{len(gpu['grads'])} tensors (tol {PARITY_GRAD}), {g_total:.3e} over all (tol "
          f"{PARITY_GRAD_ALL}), head biases {head:.3e} of the "
          f"largest element (tol {PARITY_HEAD}); update relative norm max {upd:.3e} per tensor "
          f"(tol {PARITY_UPDATE}), {total:.3e} over all (tol {PARITY_UPDATE_ALL}); running "
          f"statistics {stats:.3e} (tol {PARITY_STATS}); {time.time() - t0:.1f} s", flush=True)
    check(worst <= PARITY_GRAD and g_total <= PARITY_GRAD_ALL and head <= PARITY_HEAD,
          "train parity: eval-mode gradients")
    check(upd <= PARITY_UPDATE and total <= PARITY_UPDATE_ALL, "train parity: the update")
    check(stats <= PARITY_STATS, "train parity: running statistics")


def train_step_split(model, state, tx, batch, cfg, card: str):
    """Where a train step's time goes, on the host's clock with the card
    synchronized between parts: the train-mode forward with the loss, the
    backward, the update (one more update of `state`); then each stage's
    RED alone, fused pipeline and scan, forward and backward, on a random
    volume of its shape."""
    from satmvs_tpu_torch.models.losses import cascade_loss

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    names = list(state.params)
    t0 = clock()
    with torch.enable_grad():
        out = model(batch["imgs"], batch["cams"], batch["depth_values"], train=True)
        loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"], cfg.dlossw)[0]
        t1 = clock()
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    t2 = clock()
    tx.update(dict(zip(names, grads)), state.opt_state, state.params)
    t3 = clock()
    print(f"[train] one step by part: forward {1e3 * (t1 - t0):.2f} ms, backward "
          f"{1e3 * (t2 - t1):.2f} ms, update {1e3 * (t3 - t2):.2f} ms (host clock, card "
          f"synchronized) card={card}", flush=True)
    del out, loss, grads
    gen = torch.Generator(device="cuda").manual_seed(4)
    for i, (reg, scale, nd, c) in enumerate(zip(model.regs, STAGE_SCALES, NDEPTHS, FEAT_CH)):
        vol = torch.rand((1, nd, HEIGHT // scale, WIDTH // scale, c), generator=gen,
                         device="cuda").requires_grad_(True)
        parts = []
        for fused in (True, False):
            with torch.enable_grad():
                reg(vol, fused=fused)  # warm-up
                t0 = clock()
                logits = reg(vol, fused=fused)
                t1 = clock()
                torch.autograd.grad(logits.sum(), [vol, *reg.parameters()])
                t2 = clock()
            parts.append(f"{'fused' if fused else 'scan'} forward {1e3 * (t1 - t0):.2f} ms, "
                         f"backward {1e3 * (t2 - t1):.2f} ms")
        print(f"[train] stage{i + 1} RED alone {tuple(vol.shape)}: {'; '.join(parts)} (host "
              f"clock, card synchronized) card={card}", flush=True)


def run_train_steps(cfg, batch, n_steps: int, want: dict, what: str, card: str):
    """n_steps train steps of a fresh model from cfg on batch, each checked
    for exact launches and finite scalars; returns (model, state, tx, step
    function, launches in all, step ms, losses, peak GiB)."""
    from satmvs_tpu_torch.train import create_model_and_state, make_train_step

    model, state, tx = create_model_and_state(cfg, batch, TRAIN_STEPS)
    train_step = make_train_step(model, tx, cfg.dlossw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for k in range(n_steps):
        before = counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, scalars = train_step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append({key: v.item() for key, v in scalars.items()})
        per_step = {key: v - before[key] for key, v in counts().items()}
        check(per_step == want, f"{what} step {k}: launches {per_step}")
        check(all(np.isfinite(v) for v in losses[-1].values()), f"{what} step {k}: {losses[-1]}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] {n_steps} {what} steps at {HEIGHT}x{WIDTH}, B=1, ndepths={NDEPTHS}: "
          f"launches per step {({k: v for k, v in want.items() if v})} (exact), in all "
          f"{({k: v for k, v in launches.items() if v})}", flush=True)
    print(f"[train] {what} step ms {[round(t, 2) for t in times]} (CUDA events): median "
          f"{float(np.median(times)):.2f} ms, first {times[0]:.2f} ms; peak_mem={peak:.2f} GiB "
          f"card={card}", flush=True)
    for k, rec in enumerate(losses):
        print(f"[train] {what} step {k}: " + ", ".join(f"{key} {v:.4f}" for key, v in rec.items()),
              flush=True)
    return model, state, tx, train_step, launches, times, losses, peak


def phase_train(card: str) -> dict:
    """Phase 7: the training path at full width, on the fused RED pipeline
    (Config() defaults) and with fused_red off; returns the launches of the
    fused train steps' run, of the eval step's and of the scan steps'."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config, make_eval_step

    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    cfg = Config(ndepths=NDEPTHS)
    check(cfg.fused_red is None, "Config() must default to fused_red None")
    model, state, tx, train_step, train_launches, _, losses, _ = run_train_steps(
        cfg, batch, TRAIN_STEPS, LAUNCHES_PER_TRAIN_STEP, "fused", card)
    check(losses[-1]["loss"] < losses[0]["loss"],
          f"fused train steps: loss {losses[0]['loss']} -> {losses[-1]['loss']} did not fall")
    eval_step = make_eval_step(model, cfg.dlossw, cfg.min_interval)
    reset_counts()
    scalars, depth, _ = eval_step(state, batch)
    torch.cuda.synchronize()
    eval_launches = counts()
    check(eval_launches == LAUNCHES_PER_EVAL_STEP, f"eval step launches {eval_launches}")
    check(all(bool(torch.isfinite(v)) for v in scalars.values()), f"eval step: {scalars}")
    check(tuple(depth.shape) == (1, HEIGHT, WIDTH), f"eval depth shape {tuple(depth.shape)}")
    print(f"[train] eval step: launches {({k: v for k, v in eval_launches.items() if v})} "
          f"(exact); " + ", ".join(f"{key} {v.item():.4f}" for key, v in scalars.items()),
          flush=True)
    eval_ms = time_ms(lambda: eval_step(state, batch), reps=3, warmup=1)
    print(f"[train] eval step {eval_ms:.2f} ms (median of 3, CUDA events) card={card}",
          flush=True)
    train_step_split(model, state, tx, batch, cfg, card)
    profile_forward(lambda: train_step(state, batch), card, top=12, what="one fused train step")
    del model, state, tx, train_step, eval_step
    # the fused_red=off path stays driven: fewer steps, its own launches
    scan_cfg = Config(ndepths=NDEPTHS, fused_red=False)
    _, scan_state, _, scan_step, scan_launches, _, _, _ = run_train_steps(
        scan_cfg, batch, SCAN_STEPS, LAUNCHES_PER_SCAN_STEP, "scan (fused_red off)", card)
    profile_forward(lambda: scan_step(scan_state, batch), card, top=6,
                    what="one scan (fused_red off) train step")
    del scan_state, scan_step
    phase_train_parity(card)
    return {"train_step": train_launches, "eval_step": eval_launches,
            "scan_train_step": scan_launches}


# phase 9: the on-disk journey through the CLIs (satmvs_tpu_torch/cli/) on a
# WHU-TLC tree at the flagship patch: TREE_TRAIN train and TREE_TEST test
# blocks of 3 views, CLI_EPOCHS epochs at batch 1, the CLIs' defaults
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
TREE_TRAIN, TREE_TEST, CLI_EPOCHS = 3, 1, 2
FUSE_VALID_TOL = 0.005   # GPU vs CPU fusion: valid fraction, 0.5 percentage points
FUSE_DSM_TOL = 0.05      # ... and mean |Δ| (m) of the DSM on cells valid in both


def render_tree(root: str) -> str:
    """Phase 9's WHU-TLC tree at HEIGHT × WIDTH, written by the port's
    writer; runs in a worker process, so it puts the repository on its own
    import path."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from satmvs_tpu_torch.data import synthetic

    return synthetic.write_whu_tlc_tree(root, num_train=TREE_TRAIN, num_test=TREE_TEST,
                                        width=WIDTH, height=HEIGHT, seed=0, h_amp=80.0)


def write_scene_files(scene: dict, folder: Path) -> tuple[list[str], list[str]]:
    """Phase 5's triplet as 8-bit PNGs and .rpc files (the port's writers)."""
    from satmvs_tpu_torch.data import formats, png

    folder.mkdir(parents=True, exist_ok=True)
    images, rpcs = [], []
    for v in range(len(scene["images"])):
        images.append(str(folder / f"view{v}.png"))
        rpcs.append(str(folder / f"view{v}.rpc"))
        png.write_png(images[-1], scene["images"][v].astype(np.uint8))
        formats.save_rpc(rpcs[-1], scene["rpcs"][v])
    return images, rpcs


def dsm_overlap(a, tfw_a, b, tfw_b):
    """The cells of two north-up DSMs of one cell size that cover the same
    ground: (a's part, b's part)."""
    res = tfw_a[0]
    dc = int(round((tfw_b[4] - tfw_a[4]) / res))  # b's column 0 among a's columns
    dr = int(round((tfw_a[5] - tfw_b[5]) / res))  # b's row 0 among a's rows
    r0, c0 = max(0, dr), max(0, dc)
    r1, c1 = min(a.shape[0], dr + b.shape[0]), min(a.shape[1], dc + b.shape[1])
    return a[r0:r1, c0:c1], b[r0 - dr:r1 - dr, c0 - dc:c1 - dc]


def launches_of(train_steps: int, forwards: int) -> dict:
    """Launches of train steps at B = 1 and forwards (eval steps are forwards)."""
    return {k: train_steps * LAUNCHES_PER_TRAIN_STEP[k] + forwards * LAUNCHES_PER_FORWARD[k]
            for k in LAUNCHES_PER_FORWARD}


def phase_from_disk(card: str, root: str, scene_files) -> dict:
    """Phase 9: from files on disk to a DSM through the CLIs' `main`, at the
    default Config() (ndepths 64/32/8, RED base 8, fused RED): train
    CLI_EPOCHS epochs, resume one more, test, predict with --fuse, the same
    predict as a `python -m` subprocess, and the scene CLI on phase 5's
    triplet with --streaming and --dsm.  Exact launches per run; the maps of
    both predict runs bit for bit a direct forward of the restored model on
    the same Loader batches (cuDNN's deterministic engines, as the CLI
    runs); every map finite and in range; the test mode's metrics
    recomputed from its maps; fusion on the card against the CPU.  Returns
    the launches of the train, predict and scene runs."""
    import os
    import shutil

    from satmvs_tpu_torch.cli import predict as cli_predict
    from satmvs_tpu_torch.cli import predict_scene as cli_scene
    from satmvs_tpu_torch.cli import restore_model
    from satmvs_tpu_torch.cli import train as cli_train
    from satmvs_tpu_torch.data import formats
    from satmvs_tpu_torch.data.dataset import MVSDataset
    from satmvs_tpu_torch.data.loader import Loader
    from satmvs_tpu_torch.infer.fuse import INVALID_DEPTH, fuse_scene_to_dsm
    from satmvs_tpu_torch.infer.tiling import plan_tiles
    from satmvs_tpu_torch.train import Config, metrics

    logdir = str(WORK / "logs")
    workdir = os.path.join(logdir, "red", "rpc")
    testpath = os.path.join(root, "open_dataset_rpc", "test")
    common = [f"--dataset_root={root}", f"--logdir={logdir}"]
    launches = {}

    def run(what: str, fn, argv, want: dict):
        reset_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        check(got == want, f"{what}: launches {got}, want {want}")
        print(f"[disk] {what}: {wall:.2f} s wall, launches "
              f"{({k: v for k, v in got.items() if v})} (exact) card={card}", flush=True)
        return out, got

    # train, then resume
    out, launches["cli_train"] = run(
        "cli.train --mode=train", cli_train.main,
        ["--mode=train", *common, "--epochs", str(CLI_EPOCHS)],
        launches_of(TREE_TRAIN * CLI_EPOCHS, TREE_TEST * CLI_EPOCHS))
    timing = out["timing"]
    check(timing["epochs"] == list(range(1, CLI_EPOCHS + 1))
          and timing["steps"] == [TREE_TRAIN] * CLI_EPOCHS, f"train epochs {timing}")
    for e in range(1, CLI_EPOCHS + 1):
        check(os.path.isfile(os.path.join(workdir, str(e), "state.pt")), f"no checkpoint {e}")
    for e, steps, t_s, e_s in zip(timing["epochs"], timing["steps"], timing["train_s"],
                                  timing["test_s"]):
        print(f"[disk] train epoch {e}: {steps} steps in {t_s:.3f} s = {steps / t_s:.2f} steps/s "
              f"({1e3 * t_s / steps:.1f} ms a step); test pass ({TREE_TEST} eval steps) "
              f"{1e3 * e_s:.1f} ms card={card}", flush=True)
    tl, td = out["train_loader"], out["train_data"]
    step_ms = 1e3 * timing["train_s"][-1] / timing["steps"][-1]
    per_batch = {k: 1e3 * tl[k] / tl["batches"] for k in ("read_s", "collate_s", "pin_s")}
    per_sample = {k: 1e3 * td[k] / td["samples"]
                  for k in ("read_s", "color_s", "center_s", "cams_gt_s")}
    print(f"[disk] data, epoch {CLI_EPOCHS}: the loader's worker took "
          f"{sum(per_batch.values()):.1f} ms a batch (samples {per_batch['read_s']:.1f}, collate "
          f"{per_batch['collate_s']:.1f}, pin {per_batch['pin_s']:.1f}), the train loop waited "
          f"{1e3 * tl['wait_s'] / tl['batches']:.1f} ms a batch for it, against {step_ms:.1f} ms "
          f"a step; a train sample of 3 views, over both epochs ({td['samples']} samples): "
          f"read + crop {per_sample['read_s']:.1f} ms, random_color {per_sample['color_s']:.1f}, "
          f"center_image {per_sample['center_s']:.1f}, cameras + ground truth "
          f"{per_sample['cams_gt_s']:.1f} card={card}", flush=True)
    out, _ = run("cli.train --resume", cli_train.main,
                 ["--mode=train", *common, "--epochs", str(CLI_EPOCHS + 1), "--resume"],
                 launches_of(TREE_TRAIN, TREE_TEST))
    check(out["timing"]["epochs"] == [CLI_EPOCHS + 1], f"resume ran epochs {out['timing']}")

    # test mode; its metrics again from the maps it wrote
    out, _ = run("cli.train --mode=test", cli_train.main, ["--mode=test", *common],
                 launches_of(0, TREE_TEST))
    check(out["epoch"] == CLI_EPOCHS + 1, f"test mode restored epoch {out['epoch']}")
    meter = metrics.DictAverageMeter()
    for k in range(TREE_TEST):
        stem = os.path.join(out["out_dir"], f"block{k:04d}_2")
        depth, err = formats.load_pfm(stem + ".pfm"), formats.load_pfm(stem + "_err.pfm")
        prob = formats.load_pfm(stem + "_prob.pfm")
        gt = formats.load_pfm(os.path.join(testpath, "height", "2", f"block{k:04d}.pfm"))
        check(np.isfinite(depth).all() and 0 <= prob.min() and prob.max() <= 1 + 1e-6,
              f"test map {stem}")
        mask = (err != -999.0).astype(np.float32)
        meter.update(metrics.standard_metrics(torch.from_numpy(depth)[None],
                                              torch.from_numpy(gt)[None],
                                              torch.from_numpy(mask)[None]))
    again = meter.mean()
    diff = max(abs(out["metrics"][k] - v) / max(1.0, abs(v)) for k, v in again.items())
    print(f"[disk] test mode final: {out['metrics']}; from its height_result maps: {again} "
          f"(max relative difference {diff:.2e}, tol 1e-5)", flush=True)
    check(diff <= 1e-5, f"test mode metrics {out['metrics']} vs its maps {again}")

    # predict with --fuse; then the same model by hand on the same batches
    out, launches["cli_predict"] = run(
        "cli.predict --fuse", cli_predict.main,
        [f"--dataset_root={testpath}", f"--loadckpt={workdir}", "--fuse"],
        launches_of(0, 3 * TREE_TEST))
    print(f"[disk] predict: {3 * TREE_TEST} forwards "
          f"{[round(1e3 * t, 2) for t in out['forward_s']]} ms (host clock to the read-back; "
          f"the first sets up cuDNN), fuse wall "
          f"{({n: round(1e3 * t, 1) for n, t in out['fuse_s'].items()})} ms card={card}",
          flush=True)
    fused = out["fused"]

    # a direct forward of the restored model on the same Loader batches, on
    # cuDNN's deterministic engines as the predict CLI runs: the same bits as
    # the maps it wrote.  On the default engines FeatureNet's convolutions
    # are not bit-reproducible: two direct forwards differ (printed)
    model, _, _ = restore_model(Config(), workdir, torch.device("cuda"))
    intervals = model.stage_intervals()
    margin = sum(nd / 2 * iv for nd, iv in zip(NDEPTHS[1:], intervals[1:]))
    pred_mode = Loader(MVSDataset(testpath, "pred"), 1, device="cuda")
    first = next(iter(pred_mode))
    forward = lambda: model(first["imgs"], first["cams"], first["depth_values"])  # noqa: E731
    engine_ms = {}
    for deterministic in (False, True, True, False):
        torch.backends.cudnn.deterministic = deterministic
        engine_ms.setdefault(deterministic, []).append(time_ms(forward, reps=10, warmup=2))
    twice = [forward()["depth"] for _ in range(2)]
    print(f"[disk] one 384x768 forward (CUDA events, median of 10; runs default, deterministic, "
          f"deterministic, default): cuDNN's default engines {engine_ms[False]} ms, its "
          f"deterministic engines {engine_ms[True]} ms; two forwards on the default engines "
          f"differ by up to {(twice[0] - twice[1]).abs().max().item():.3e} m card={card}",
          flush=True)
    torch.backends.cudnn.deterministic = True
    direct = {}
    for batch in pred_mode:
        want = model(batch["imgs"], batch["cams"], batch["depth_values"])
        direct[(batch["out_view"][0], f"{batch['out_name'][0]}.pfm")] = (
            want["depth"][0].cpu().numpy(), want["photometric_confidence"][0].cpu().numpy(),
            *batch["depth_values"][0].tolist())
    del model, want, first, twice

    def against_direct(what: str, folder):
        """The maps a predict run wrote under `folder`/mvs_results against
        the direct forward: the same bits, depth in range, prob in [0, 1]."""
        maps = {(v, f): (formats.load_pfm(os.path.join(folder, "mvs_results", v, "init", f)),
                         formats.load_pfm(os.path.join(folder, "mvs_results", v, "prob", f)))
                for v in "012" for f in os.listdir(os.path.join(folder, "mvs_results", v, "init"))}
        check(maps.keys() == direct.keys(), f"{what}: maps {sorted(maps)}")
        for key in sorted(direct):
            (init, prob), (d_init, d_prob, lo, hi) = maps[key], direct[key]
            diff = np.abs(init - d_init).max()
            same = diff == 0 and np.array_equal(prob, d_prob)
            print(f"[disk] {what} view {key[0]} {key[1]}: init [{init.min():.2f}, "
                  f"{init.max():.2f}] m (range {lo:.0f}..{hi:.0f} ± {margin:g}), prob "
                  f"[{prob.min():.4f}, {prob.max():.4f}]; the same bits as a direct forward: "
                  f"{same} (max |dh| {diff:.3e} m)", flush=True)
            check(same, f"{what} {key}: the written maps differ from a direct forward")
            check(np.isfinite(init).all() and lo - margin - 1e-3 <= init.min()
                  and init.max() <= hi + margin + 1e-3, f"{what} {key}: depth range")
            check(0 <= prob.min() and prob.max() <= 1 + 1e-6, f"{what} {key}: prob range")

    against_direct("cli.predict --fuse", testpath)

    # fusion on the card against the CPU, on the maps predict wrote
    for name, (path, valid) in fused.items():
        order = ["0", "1", "2"]
        depths = np.stack([formats.load_pfm(os.path.join(testpath, "mvs_results", v, "init",
                                                         f"{name}.pfm")) for v in order])
        prob = formats.load_pfm(os.path.join(testpath, "mvs_results", "0", "prob", f"{name}.pfm"))
        rpcs = np.stack([formats.load_rpc(os.path.join(testpath, "rpc", v, f"{name}.rpc"))[0]
                         for v in order])
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            dsm_path, mask, _ = fuse_scene_to_dsm(
                depths, rpcs, str(WORK / f"fuse_{dev}_{name}_dsm.tif"), prob=prob, p_ratio=2.0,
                d_ratio=7.5, geo_consist_num=1, confidence_ratio=0.1, device=dev)
            runs[dev] = (time.perf_counter() - t0, mask.mean(), *formats.read_dsm(dsm_path))
        (t_g, v_g, d_g, tfw_g), (t_c, v_c, d_c, tfw_c) = runs["cuda"], runs["cpu"]
        a, b = dsm_overlap(d_g, tfw_g, d_c, tfw_c)
        both = (a != INVALID_DEPTH) & (b != INVALID_DEPTH)
        dsm_err = float(np.abs(a[both] - b[both]).mean())
        print(f"[disk] fusion {name}: valid {v_g:.4f} on the card (the CLI's {valid:.4f}), "
              f"{v_c:.4f} on the CPU (tol {FUSE_VALID_TOL}); DSM {d_g.shape} / {d_c.shape} cells, "
              f"mean |dh| {dsm_err:.3e} m on {int(both.sum())} cells valid in both (tol "
              f"{FUSE_DSM_TOL}); wall {1e3 * t_g:.1f} ms on the card, {1e3 * t_c:.1f} ms on "
              f"the CPU card={card}", flush=True)
        check(abs(v_g - v_c) <= FUSE_VALID_TOL and dsm_err <= FUSE_DSM_TOL and both.any(),
              f"fusion {name}: GPU vs CPU valid {v_g} / {v_c}, DSM mean |dh| {dsm_err}")

    # the module entry, in its own process, on a copy of the test split
    copy = WORK / "test_copy"
    shutil.copytree(testpath, copy, ignore=shutil.ignore_patterns("mvs_results", "height_result"))
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    env.pop("SATMVS_PLATFORM", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "satmvs_tpu_torch.cli.predict",
                           f"--dataset_root={copy}", f"--loadckpt={workdir}"],
                          cwd=str(Path(__file__).resolve().parent), env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"python -m satmvs_tpu_torch.cli.predict: exit "
          f"{proc.returncode}\n{proc.stderr[-3000:]}")
    print(f"[disk] python -m satmvs_tpu_torch.cli.predict: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    against_direct("python -m satmvs_tpu_torch.cli.predict", str(copy))

    # the scene CLI on phase 5's triplet
    images, rpcs = scene_files
    n_tiles = len(plan_tiles(SCENE_SIZE, SCENE_SIZE, TILE, HALO))
    n_chunks = 3 * -(-n_tiles // BATCH_TILES)  # every view as the reference
    out, launches["cli_scene"] = run(
        "cli.predict_scene --streaming --dsm", cli_scene.main,
        ["--images", *images, "--rpcs", *rpcs, f"--loadckpt={workdir}",
         f"--out={WORK / 'scene_height.pfm'}", "--ref_index", "2", "--tile", str(TILE),
         "--halo", str(HALO), "--streaming", "--slab", str(SLAB), "--batch_tiles",
         str(BATCH_TILES), f"--dsm={WORK / 'scene_dsm.tif'}"],
        {k: n_chunks * v for k, v in chunk_launches(BATCH_TILES).items()})
    check(out["n_chunks"] == n_chunks, f"scene CLI ran {out['n_chunks']} chunks")
    depth, conf, stats = out["depth"], out["conf"], out["stats"]
    _, hi, lo = formats.load_rpc(rpcs[2])
    check(np.isfinite(depth).all() and lo - margin - 1e-3 <= depth.min()
          and depth.max() <= hi + margin + 1e-3, "scene CLI: depth range")
    check(0 <= conf.min() and conf.max() <= 1 + 1e-6, "scene CLI: confidence range")
    print(f"[disk] scene CLI: {stats['n_tiles']} tiles in {stats['n_chunks']} chunks of "
          f"{BATCH_TILES}, {1e3 * stats['wall_s'] / stats['n_tiles']:.1f} ms per tile (wall "
          f"{stats['wall_s']:.3f} s, host prep {stats['host_prep_s']:.3f} s); depth "
          f"[{depth.min():.2f}, {depth.max():.2f}] m; DSM {out['dsm'][0]} valid "
          f"{out['dsm'][1]:.4f}, fuse wall {1e3 * out['fuse_s']:.1f} ms card={card}", flush=True)
    return launches



# phase 10: the CostRegNet families (CascadeMVSNet, UCSNet) at inference.
# Per forward at B = 1: sweep_variance once per stage; per stage's packed
# CostRegNet conv_head 15 (four stride-1 blocks and the head, three depth
# taps each), conv_dn 9 and deconv_up 9 (three blocks, three taps); no
# red_recur
COSTREG_FAMILIES = ("casmvs", "ucs")
COSTREG_HEAD_GAIN = 10.0         # the logit heads ×10: a window confidence spread over [0, 1]
COSTREG_PARITY_HW = (96, 192)    # GPU vs CPU at this patch (the CPU's 3-D convs are slow)
LAUNCHES_PER_COSTREG_FORWARD = {**{k: 0 for k in LAUNCHES_PER_FORWARD}, "sweep_variance": 3,
                                "conv_dn": 27, "deconv_up": 27, "conv_head": 45}
COSTREG_PATHS = (*COSTREG_FAMILIES, "cli_predict_ucs")
COSTREG_BLOCK_TOL = 1e-4         # composed taps vs cuDNN's conv3d, × max(1, max |cuDNN|)


def build_costreg_model(name: str, device):
    """CascadeMVSNet or UCSNet (RPC, ndepths 64/32/8) from seed 0 at flax's
    LeCun scale, its norms and BatchNorm statistics drawn from seed 1
    (scale 1 ± 0.2, shift and mean ± 0.1, var in [0.5, 1.5]: the BN fold is
    far from the identity), the CostRegNet heads × COSTREG_HEAD_GAIN; drawn
    on the CPU, so every device gets the same weights."""
    from satmvs_tpu_torch.models import build_model
    from satmvs_tpu_torch.nn.blocks import BatchNorm

    model = lecun_scale(build_model(name, "rpc", ndepths=NDEPTHS, device="cpu", seed=0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.num_features
                m.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
        for reg in model.regs:
            reg.head.weight.mul_(COSTREG_HEAD_GAIN)
    return model.to(device)


def phase_costreg_kernels(card: str) -> list[dict]:
    """Phase 10, kernels: the CostRegNet forms at each of the 33 call shapes
    of a 384×768 forward (each three calls a forward, one per depth tap)
    against their plain versions (KERNEL_TOL), with the plan and the same
    bits in a second run, a call on two elements' planes the bits of the
    two B = 1 calls, kernel, plain, bound and library (F.conv2d /
    F.conv_transpose2d) times; then each 3-D block composed of its three
    taps (with the tap sums, bias, ReLU, skip) against cuDNN's F.conv3d /
    F.conv_transpose3d on the BN-folded kernel, both timed."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.nn import costreg as cr
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    src = "satmvs_tpu_torch/csrc/plane_conv.cu"
    reps = {"conv_dn": KernelReport("conv_dn_costreg", src,
                                    "satmvs_tpu/ops/pallas/plane_conv.py:382", card),
            "deconv_up": KernelReport("deconv_up_costreg", src,
                                      "satmvs_tpu/ops/pallas/plane_conv.py:569", card),
            "conv_head": KernelReport("conv_head_costreg", src,
                                      "satmvs_tpu/ops/pallas/plane_conv.py:730", card)}
    device = {op: [0.0, 0.0] for op in reps}  # kernel, library device ms a forward
    for (stage, block, op, n, h, w, ci, co), call in zip(costreg_blocks(1), costreg_calls(1)):
        label = f"{stage} {block} {(n, h, w, ci)}->{co}"
        x, x2 = randn(n, h, w, ci), randn(n, h, w, ci)
        scale = (1.0 / (9 * ci)) ** 0.5
        if op == "deconv_up":
            wt = randn(ci, co, 3, 3, scale=scale)
            kernel = lambda t=x: pc.deconv_up(t, wt, relu=False)  # noqa: E731
            plain = lambda: pc.deconv_up_reference(x, wt, relu=False)  # noqa: E731
            library = lambda: F.conv_transpose2d(nchw(x), wt, stride=2, padding=1,  # noqa: E731
                                                 output_padding=1)
        elif op == "conv_dn":
            wt = randn(co, ci, 3, 3, scale=scale)
            kernel = lambda t=x: pc.conv_dn(t, wt, relu=False)  # noqa: E731
            plain = lambda: pc.conv_dn_reference(x, wt, relu=False)  # noqa: E731
            library = lambda: F.conv2d(nchw(x), wt, stride=2, padding=1)  # noqa: E731
        else:
            wt, zb = randn(co, ci, 3, 3, scale=scale), torch.zeros(co, device="cuda")
            kernel = lambda t=x: pc.conv_head(t, wt, zb)  # noqa: E731
            plain = lambda: pc.conv_head_reference(x, wt, zb)  # noqa: E731
            library = lambda: F.conv2d(nchw(x), wt, zb, padding=1)  # noqa: E731
        work_op = "deconv_up costreg" if op == "deconv_up" else op  # no skip to read
        pick = (lambda key: "deconv3x3" in key) if op == "deconv_up" else conv3x3_kernel_name
        with torch.no_grad():
            reps[op].case(label, kernel, plain, rel_tol, *plane_work(work_op, *call[2:]),
                          library, count=3)
            plane_same_bits(reps[op].rec["name"], label, kernel, call[2:])
            k_dev, l_dev = device_ms(kernel, pick, 5), device_ms(library, lambda key: True, 5)
            device[op][0] += 3 * k_dev
            device[op][1] += 3 * l_dev
            print(f"[costreg] {reps[op].rec['name']} {label}: device time {k_dev:.4f} ms, "
                  f"the library call's {l_dev:.4f} ms card={card}", flush=True)
            both, one, other = kernel(torch.cat([x, x2])), kernel(x), kernel(x2)
            same = torch.equal(both[:n], one) and torch.equal(both[n:], other)
            print(f"[costreg] {reps[op].rec['name']} {label}: a call on B = 2 elements' "
                  f"{2 * n} planes the bits of the two B = 1 calls: {same}", flush=True)
            check(same, f"{op} {label}: B = 2 differs from B = 1")
        del x, x2, both, one, other
    for op, rep in reps.items():
        r, calls = rep.rec, 3 * sum(1 for block in costreg_blocks(1) if block[2] == op)
        print(f"[costreg] {r['name']} per forward ({calls} calls): events {r['ms']:.4f} ms, "
              f"device time {device[op][0]:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; the library call (F.conv2d "
              f"/ F.conv_transpose2d) events {r['library_ms']:.4f} ms, device time "
              f"{device[op][1]:.4f} ms card={card}", flush=True)

    # each 3-D block: its three taps composed as the packed CostRegNet runs
    # them, against cuDNN's 3-D convolution on the BN-folded kernel
    totals = {op: [0.0, 0.0, 0] for op in reps}
    for stage, block, op, n, h, w, ci, co in costreg_blocks(1):
        d_in = 2 * n if op == "conv_dn" else n  # a stride-2 block reads every plane
        vol = randn(1, d_in, h, w, ci).abs()
        scale = (1.0 / (27 * ci)) ** 0.5
        bias = randn(co, scale=0.1)
        x5 = vol.permute(0, 4, 1, 2, 3)
        if op == "deconv_up":
            wt3 = randn(ci, co, 3, 3, 3, scale=scale)
            skip = randn(1, 2 * n, 2 * h, 2 * w, co)
            composed = lambda: cr.d3dT(vol, wt3, bias, skip)  # noqa: E731
            cudnn = lambda: (F.relu(F.conv_transpose3d(  # noqa: E731
                x5, wt3, bias, stride=2, padding=1, output_padding=1)).permute(0, 2, 3, 4, 1)
                + skip)
        else:
            w3 = randn(co, ci, 3, 3, 3, scale=scale)
            stride = 2 if op == "conv_dn" else 1
            if block == "Conv_0":
                composed = lambda: cr.c3d_s1(vol, w3, None)  # noqa: E731
                cudnn = lambda: F.conv3d(x5, w3, padding=1).permute(0, 2, 3, 4, 1)  # noqa: E731
            else:
                composed = ((lambda: cr.c3d_s2(vol, w3, bias)) if stride == 2
                            else (lambda: cr.c3d_s1(vol, w3, bias)))
                cudnn = lambda: F.relu(F.conv3d(x5, w3, bias, stride=stride,  # noqa: E731
                                                padding=1)).permute(0, 2, 3, 4, 1)
        with torch.no_grad():
            got, want = composed(), cudnn()
            err = (got - want).abs().max().item()
            tol = COSTREG_BLOCK_TOL * max(1.0, want.abs().max().item())
            check(got.shape == want.shape and err <= tol,
                  f"{stage} {block}: composed taps vs conv3d err {err} > {tol}")
            c_ms, l_ms = time_ms(composed, reps=10), time_ms(cudnn, reps=10)
        totals[op][0] += c_ms
        totals[op][1] += l_ms
        totals[op][2] += 1
        print(f"[costreg] 3-D block {stage} {block} {tuple(vol.shape)}->{co}: composed taps "
              f"{c_ms:.4f} ms, cuDNN {'conv_transpose3d' if op == 'deconv_up' else 'conv3d'} "
              f"{l_ms:.4f} ms, max abs err {err:.3e} (tol {tol:.3e}) card={card}", flush=True)
        del vol, x5, got, want
    for op, (c_ms, l_ms, nb) in totals.items():
        print(f"[costreg] {op} blocks of a forward's CostRegNets ({nb}): composed taps "
              f"{c_ms:.4f} ms, cuDNN's 3-D convolution {l_ms:.4f} ms ({c_ms / l_ms:.2f}×) "
              f"card={card}", flush=True)
    return [reps[op].record() for op in ("conv_dn", "deconv_up", "conv_head")]


def costreg_forward(card: str, name: str) -> dict:
    """Phase 10, one family: a 384×768 forward with exact launches, range
    checks, its time and peak memory and a profile; a B = 2 volume through
    stage 1's CostRegNet against its two elements alone (bit for bit); the
    same model's plain run on the CPU at COSTREG_PARITY_HW, stage by stage
    (`gpu_vs_cpu`).  Returns the forward's launches."""
    from satmvs_tpu_torch.data import synthetic

    model = build_costreg_model(name, "cuda")
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    torch.cuda.synchronize()
    reset_counts()
    out = model(imgs, cams, dvals)
    torch.cuda.synchronize()
    launches = counts()
    print(f"[costreg] {name} forward at {HEIGHT}x{WIDTH}, ndepths={NDEPTHS}: launches "
          f"{({k: v for k, v in launches.items() if v})} (want exactly "
          f"{({k: v for k, v in LAUNCHES_PER_COSTREG_FORWARD.items() if v})})", flush=True)
    check(launches == LAUNCHES_PER_COSTREG_FORWARD, f"{name} forward launches {launches}")
    lo, hi = dvals[0].tolist()
    margin = 0.0
    for i, (scale, nd) in enumerate(zip(STAGE_SCALES, NDEPTHS), start=1):
        if i > 1 and model.sampler == "window":  # UCSNet's windows stay inside the range
            margin += nd / 2 * model.stage_intervals()[i - 1]
        stage = out[f"stage{i}"]
        depth, conf = stage["depth"], stage["photometric_confidence"]
        check(tuple(depth.shape) == (1, HEIGHT // scale, WIDTH // scale) and
              bool(torch.isfinite(depth).all()), f"{name} stage{i} depth")
        dmin, dmax = depth.min().item(), depth.max().item()
        check(lo - margin - 1e-3 <= dmin and dmax <= hi + margin + 1e-3,
              f"{name} stage{i}: depth [{dmin}, {dmax}] outside [{lo - margin}, {hi + margin}]")
        cmin, cmax = conf.min().item(), conf.max().item()
        check(0.0 <= cmin and cmax <= 1.0 + 1e-6, f"{name} stage{i}: confidence [{cmin}, {cmax}]")
        extra = ""
        if "variance" in stage:
            var = stage["variance"]
            check(bool(torch.isfinite(var).all() and (var >= 0).all()), f"{name} stage{i} variance")
            extra = f", variance [{var.min().item():.2f}, {var.max().item():.2f}] m"
        print(f"[costreg] {name} stage{i} depth [{dmin:.2f}, {dmax:.2f}] m (range {lo:.0f}.."
              f"{hi:.0f} ± {margin:g}), conf [{cmin:.4f}, {cmax:.4f}]{extra}", flush=True)
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = time_ms(lambda: model(imgs, cams, dvals), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[costreg] {name} forward_ms={fwd_ms:.2f} (median of 5, CUDA events, B=1, "
          f"{HEIGHT}x{WIDTH}, 3 views) peak_mem={peak:.2f} GiB card={card}", flush=True)
    profile_forward(lambda: model(imgs, cams, dvals), card, what=f"one {name} forward")

    # the regularizer folds B·D planes into each call: the same bits as B = 1
    d, h, w, c = NDEPTHS[0], HEIGHT // 4, WIDTH // 4, model.feature.out_channels[0]
    vol = torch.rand((2, d, h, w, c), generator=torch.Generator("cuda").manual_seed(4),
                     device="cuda")
    with torch.no_grad():
        both = model.regs[0](vol)
        same = all(torch.equal(both[b:b + 1], model.regs[0](vol[b:b + 1])) for b in range(2))
    print(f"[costreg] {name} stage-1 CostRegNet on a B = 2 volume {tuple(vol.shape)}: each "
          f"element the bits of its B = 1 forward: {same}", flush=True)
    check(same, f"{name}: the CostRegNet's B = 2 logits differ from B = 1")
    del vol, both

    t0 = time.time()
    ph, pw = COSTREG_PARITY_HW
    small = synthetic.make_batch(1, pw, ph, seed=1, device="cuda")
    gpu_out = model(small["imgs"], small["cams"], small["depth_values"])
    gpu_vs_cpu("[costreg]", f"{name} at {ph}x{pw}", gpu_out, build_costreg_model(name, "cpu"),
               small["imgs"], small["cams"], small["depth_values"])
    print(f"[costreg] {name} CPU plain runs took {time.time() - t0:.1f} s", flush=True)
    return launches


def costreg_cli(card: str, tree: str) -> dict:
    """Phase 10, the predict CLI: `cli.predict --model ucs` from a port
    checkpoint of `build_costreg_model("ucs")` on a copy of phase 9's test
    split: exact launches (a forward's for each of the three views) and its
    maps bit for bit a direct forward of the restored model (cuDNN's
    deterministic engines, as the CLI runs).  Returns its launches."""
    import os
    import shutil

    from satmvs_tpu_torch.cli import predict as cli_predict
    from satmvs_tpu_torch.cli import restore_model
    from satmvs_tpu_torch.data import formats
    from satmvs_tpu_torch.data.dataset import MVSDataset
    from satmvs_tpu_torch.data.loader import Loader
    from satmvs_tpu_torch.train import Config
    from satmvs_tpu_torch.train.checkpoints import save_checkpoint
    from satmvs_tpu_torch.train.loop import make_optimizer, state_of

    cfg = Config(model="ucs")
    ckpt = WORK / "ucs_ckpt"
    save_checkpoint(str(ckpt), 1, state_of(build_costreg_model("ucs", "cuda"),
                                           make_optimizer(cfg, 1)))
    copy = WORK / "test_ucs"
    shutil.copytree(os.path.join(tree, "open_dataset_rpc", "test"), copy,
                    ignore=shutil.ignore_patterns("mvs_results", "height_result"))
    reset_counts()
    t0 = time.perf_counter()
    out = cli_predict.main([f"--dataset_root={copy}", f"--loadckpt={ckpt}", "--model", "ucs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = {k: 3 * TREE_TEST * v for k, v in LAUNCHES_PER_COSTREG_FORWARD.items()}
    print(f"[costreg] cli.predict --model ucs: {wall:.2f} s wall, forwards "
          f"{[round(1e3 * t, 2) for t in out['forward_s']]} ms, launches "
          f"{({k: v for k, v in launches.items() if v})} (want exactly "
          f"{({k: v for k, v in want.items() if v})}) card={card}", flush=True)
    check(launches == want, f"cli.predict --model ucs: launches {launches}")
    model, _, _ = restore_model(cfg, str(ckpt), torch.device("cuda"))
    n_maps = 0
    for batch in Loader(MVSDataset(str(copy), "pred"), 1, device="cuda"):
        ref = model(batch["imgs"], batch["cams"], batch["depth_values"])
        view, block = batch["out_view"][0], batch["out_name"][0]
        for sub, key in (("init", "depth"), ("prob", "photometric_confidence")):
            got = formats.load_pfm(str(copy / "mvs_results" / view / sub / f"{block}.pfm"))
            same = np.array_equal(got, ref[key][0].cpu().numpy())
            check(same, f"cli.predict --model ucs {view} {block} {sub}: not a direct forward")
            n_maps += 1
    print(f"[costreg] cli.predict --model ucs: {n_maps} maps the bits of a direct forward",
          flush=True)
    return launches


def profile_forward(fn, card: str, top: int = 8, what: str = "one forward"):
    """Device time by kernel over one call of fn (torch.profiler), and the
    share of its wall time the device was busy."""
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
    print(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms (profiler on), device busy "
          f"{busy_us / 1e3:.2f} ms = {busy_us / wall_us:.3f} of wall, {n_kernels} device "
          f"kernels/copies card={card}", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import multiprocessing
    import shutil

    shutil.rmtree(WORK, ignore_errors=True)
    # the workers render the scene and phase 9's tree while phases 1-3 run;
    # leaving the block stops them
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        return run(pool.submit(render_scene), pool.submit(render_tree, str(WORK / "whu_tlc")))


def run(scene_job, tree_job) -> int:
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
    spills = {}  # plane-conv and sweep instance → bytes of spill stores
    for name, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = kernel_instance(line.split()[-1])
            if "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.strip()}", flush=True)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and kernel.startswith(("conv3x3_kernel", "deconv3x3_s2_kernel",
                                        "sweep_variance_kernel",
                                        "sweep_variance_groups_kernel")):
                spills[kernel] = int(m.group(1))
    if spills:  # built in this run: these instances must not spill
        print(f"[build] {len(spills)} instances of conv3x3_kernel, deconv3x3_s2_kernel, "
              f"sweep_variance_kernel and sweep_variance_groups_kernel, "
              f"{sum(spills.values())} bytes of spill", flush=True)
        check(not any(spills.values()), f"an instance spills: {spills}")

    # phases 2, 2b, 6, 8 and 3
    sweep, dn, rec, up, head = phase_sweep(smi), *phase_red_kernels(smi)
    phase_many_views(smi)
    records = [*sweep, dn, rec, phase_batched_red(smi), up, head, *phase_sweep_gather(smi),
               *phase_red_backward(smi)]
    launches = {"forward": phase_slice(smi)}

    # phase 5, then phase 4 on phase 5's first chunk
    t0 = time.time()
    scene = scene_job.result()
    print(f"[scene] {SCENE_SIZE}x{SCENE_SIZE} triplet rendered on the host (waited "
          f"{time.time() - t0:.1f} s for it after phase 3)", flush=True)
    model = build_model("cuda")
    scene_launches, chunk = phase_scene(smi, model, scene)
    launches.update(scene_launches)
    launches["streaming"] = phase_stream_vs_full(smi, model, chunk)
    scene_files = write_scene_files(scene, WORK / "scene")
    del model, chunk, scene

    # phase 7
    launches.update(phase_train(smi))

    # phase 9
    t0 = time.time()
    tree = tree_job.result()
    print(f"[disk] {TREE_TRAIN} + {TREE_TEST} blocks of 3 {HEIGHT}x{WIDTH} views written "
          f"(waited {time.time() - t0:.1f} s for them after phase 7)", flush=True)
    launches.update(phase_from_disk(smi, tree, scene_files))

    # phase 10
    t0 = time.time()
    records += phase_costreg_kernels(smi)
    for name in COSTREG_FAMILIES:
        launches[name] = costreg_forward(smi, name)
    launches["cli_predict_ucs"] = costreg_cli(smi, tree)
    print(f"[costreg] phase 10 took {time.time() - t0:.1f} s", flush=True)

    for record in records:
        # a batched record is the same wrapper, read on the path that batches;
        # a costreg record the same wrapper in its CostRegNet form
        batched = record["name"].endswith("_batched")
        costreg = record["name"].endswith("_costreg")
        wrapper = record["name"].removesuffix("_batched").removesuffix("_costreg")
        record["launches_by_path"] = {path: n[wrapper] for path, n in launches.items()}
        train = wrapper in TRAIN_KERNELS
        main = ("casmvs" if costreg else "train_step" if train else
                f"scene_b{BATCH_TILES}" if batched else "forward")
        record["launches"] = launches[main][wrapper]
        paths = COSTREG_PATHS if costreg else ("train_step", "cli_train") if train else (
            INFERENCE_PATHS + CLI_PATHS + (
                ("eval_step",) if wrapper == "sweep_variance" else
                ("train_step", "eval_step") if wrapper in RED_FORWARD_KERNELS else ()))
        check(all(launches[p][wrapper] > 0 for p in paths),
              f"{record['name']} never launched on a path: {record['launches_by_path']}")

    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
