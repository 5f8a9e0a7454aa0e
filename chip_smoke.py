#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one GPU and check it.

    python3 chip_smoke.py        (from the repository root, one CUDA device)

Phases, each reported on its own lines:
  0  setup: TF32 off for matmuls and cuDNN, the card's name and power limit;
  1  build: every CUDA source of satmvs_tpu_torch/csrc with nvcc (sm_90a),
     each kernel instance's registers and spills; no instance of the plane
     convs, of the sweep (sweep_variance_kernel, and
     sweep_variance_groups_kernel for more than four source views), of its
     backward (sweep_variance_backward_kernel,
     sweep_variance_backward_groups_kernel) or of the bf16 sweep pair
     (sweep_gather_bf16_kernel, sweep_scatter_bf16_kernel) may spill;
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
     one step; two steps with fused_red off (the sweep pair only); and one
     fused step at 96×192, ndepths (16, 8, 4)
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

  10 the CostRegNet families (CascadeMVSNet, UCSNet; the packed CostRegNet
     on the whole-block kernels conv3d_block and deconv3d_block): each
     kernel against its plain version at each of the 33 3-D blocks of a
     384×768 forward, the same bits in a second run, a B = 2 call each
     element the bits of its B = 1 call, kernel ms (events), device ms
     (profiler), bound, plain ms and cuDNN's conv3d / conv_transpose3d on
     the BN-folded kernel; beside each, the block composed of the plane
     convs' per-tap CostRegNet forms as the port ran it before (the "was"
     figure), held to the plain block and timed; each family at 384×768, B = 1, 3
     views, ndepths 64/32/8 with non-trivial BatchNorm statistics: exact
     launches per forward (3 sweep_variance, 24 conv3d_block, 9
     deconv3d_block, no plane conv, no red_recur), ranges, forward time,
     peak memory, a profile, stage 1's CostRegNet at B = 2 against B = 1 bit
     for bit, and the same model's plain run on the CPU at 96×192 stage by
     stage (depth, the window confidence, UCSNet's variance);
     `cli.predict --model ucs` from a port checkpoint on phase 9's test
     split, its maps a direct forward bit for bit.
  11 the training sweeps at 384×768, B = 1, Config() (the fused RED
     pipeline): three train steps on the fused sweep (SATMVS_TRAIN_FUSED_SWEEP;
     exact launches per step: 3 sweep_variance, 3 sweep_variance_backward,
     no sweep_gather or sweep_scatter, and phase 7's RED kernels) and three
     with bf16 volumes (the sweep pair's bf16 instances, 6 + 6), each one's
     step ms and peak memory beside phase 7's default step and one step at
     96×192 against its CPU run; each new kernel instance
     (sweep_variance_backward, the fused sweep's whole VJP; the bf16 gather
     and scatter; run beside phase 6) against its plain version at the
     train step's shapes, kernel ms by events, device ms by
     torch.profiler, bound, plain ms, the same bits twice where no atomics
     are involved (the VJP's dref) and the run-to-run spread within the
     summation bound where they are (its dsrcs); the bf16 scatter's blocks
     outside their shared-memory window at each shape, the wrappers' host
     time a call, and the figures before each redesign beside them
     ("was"); three CascadeMVSNet and three UCSNet train steps
     (the sweep pair only: their CostRegNet trains as cuDNN's conv3d), their
     step ms, peak memory and one step at 96×192 against the CPU, and a
     `cli.train --mode=train --model ucs` epoch on phase 9's tree; and the
     per-view inference sweep (fused_sweep off) of CascadeREDNet in fp32 and
     with bf16 volumes: exact launches (6 gathers, no sweep_variance), depth
     against the default forward stage by stage and against the CPU at
     96×192.
  12 the two other camera models, pinhole cameras fitted to phase 3's
     synthetic triplet (`geo.pinhole.fit_pinhole_from_rpc`, composed in the
     local frame as the dataset composes them; depths are camera z) and
     QC-form RPC bundles of it: (a) `homo_sweep_coords` and
     `rpc_sweep_coords_qc` at the forward's three stage shapes against a
     float64 oracle (0.05 px, 0.01 px) and against the CPU, and each
     geometry's ms a forward beside `rpc_sweep_coords`; (b) CascadeREDNet
     forwards at 384×768 on each (exact launches: 3 sweep_variance and the
     RED kernels; ranges, ms, peak memory, a profile) and their plain runs
     on the CPU at 96×192 stage by stage; the QC forward against the
     basis-form forward (seeded weights, heads ×1) stage by stage; a pinhole
     CascadeMVSNet forward at 96×192 against the CPU; a pinhole streaming
     forward (slab 8) against the pinhole full-volume forward; (c) three
     train steps each with Config(geo_model="pinhole") and
     Config(use_qc=True) (exact launches: phase 7's), their ms and peak
     memory beside phase 7's default step, one step at 96×192 against the
     CPU; (d) a pinhole tree of 384×768 blocks (`write_pinhole_tree`)
     through `cli.train --geo_model pinhole` and `cli.predict --geo_model
     pinhole` (its maps a direct forward bit for bit), `filter_depth_pinhole`
     on the predicted and the exact depth maps, card against CPU, and
     `cli.train --use_qc` and `cli.predict --use_qc` (bit for bit) on phase
     9's tree; exact launches for every run.
  13 more than one GPU on the one card (`satmvs_tpu_torch.dist`, the data
     axis): (a) one NCCL rank (`init_multihost` under WORLD_SIZE=1): a
     384×768 train step through the data-parallel path against two serial
     steps from the same weights, on cuDNN's deterministic engines (scalars
     and running statistics the same bits; parameters too where two serial
     steps agree, else the update within 1e-3 of the serial one: the
     scatter sums with float atomics), and `python -m torch.distributed.run --nproc_per_node
     1 -m satmvs_tpu_torch.cli.train --mesh_data 1` for an epoch of phase
     9's tree; (b) two spawned ranks sharing the card over gloo (NCCL
     refuses two ranks on one device), global B = 2 at 384×768, three train
     steps against the serial B = 2 step on the card (loss and
     abs_depth_error 2e-4 relative at steps 1 and 2, and at step 3 the
     fixed gate set from dp_spread.py's runs, 1e-3), the first step's eval-mode gradients at
     5e-4 of max |g| + 5e-3 relative, the replicas the same bits, each
     rank's launches a step a serial B = 1 step's), step and gradient
     all-reduce ms (two processes on one card: not a scaling number); (c)
     the two ranks predict phase 5's scene tile-parallel (two tiles a rank a
     chunk; exact launches per rank per chunk) against phase 5's serial
     batch_tiles-4 maps (the same bits, or phase 5's gates with the cause).
  14 the model's remaining knobs: (a) coarse-grid sweep coordinates
     (`coords="coarse"`) at the forward's three stage shapes against the
     exact chain and a float64 oracle (0.02 px) and against the CPU, their
     ms a forward beside the exact chain's, a coarse-coordinate forward
     (exact launches) stage by stage against the exact forward, within
     what a 0.02 px shift of the source views moves it; (b) `compute_dtype` bf16: CascadeREDNet and
     CascadeMVSNet forwards (exact launches) and three train steps each,
     ms and peak memory beside fp32's, one step at 96×192 against its CPU
     run (gates from `train_sensitivity.py --only compute_bf16`); (c)
     `remat`: three steps each for RED (its forward kernels twice a step)
     and CasMVS, the update against the step without, peak memory beside
     phase 7's; (d) a synthetic reference checkpoint through
     `cli.convert_ckpt`, then `cli.predict --torch_compat`, full volume and
     `--streaming --slab 8`, on phase 9's test split (exact launches, the
     maps the bits of direct forwards), the torch_compat forward on the
     card against the CPU and streaming against its full volume.
  15 host I/O and the tools: (a) the native host library
     (`satmvs_tpu_torch/native`) must build here; on a 5120² image its PFM
     write and read give numpy's bytes and values and its center_image the
     float64 normalization within 1e-5, host ms beside numpy's; (b)
     `cli.synthetic_e2e` at its defaults (16 + 4 scenes of 128², 12 epochs):
     exact launches per train step (phase 7's) and per forward, finite
     losses, the trained test MAE at most a quarter of the untrained
     model's, its JSON line beside the JAX package's recorded run; (c)
     `cli.fusion_sweep` over phase 9's per-view scene maps with the scene's
     ground truth, card against CPU (phase 9's fusion gates); (d)
     `cli.profile_forward` of the forward and of a train step: pools that
     sum to the total, the hand-written pools not empty, the device total
     within 10 % of phases 3 and 7's profiles, exact launches; (e)
     `cli.collectives_report` (`data` and `data_spatial` on 2 ranks, `depth`
     on 4, gloo ranks sharing the card): exact launches of every rank's
     step, the gradient all-reduce 4 bytes a parameter, the counts of each
     kind of collective the model's layers predict.
  16 widths past the defaults, and remat under a mesh: (a) red_recur at
     state widths 2, 6 and 10 (run padded to a multiple of 4) at each
     stage's first cell of a 384×768 forward, zero and seeded start
     states, batched (B = 4, a scene chunk's slab) and its backward,
     against the plain versions at phases 2 and 8's tolerances, the same
     bits twice, kernel / plain / bound ms and the forward at the padded
     width beside it; the default widths' launch plans checked unchanged;
     (b) CascadeREDNet at `cr_base_chs` (6, 6, 6): a 384×768 forward
     (exact launches) and three train steps, their ms and peak memory
     beside the default width's, GPU vs CPU at 96×192 (the forward, a
     streamed chunk of two tiles, one train step at phase 7's gates); (c)
     conv3d_block and deconv3d_block at the blocks past 64 channels of base
     widths 12 and 16 (Cout 96-128, Cin up to 128) against their plain
     versions and cuDNN's conv3d, one launch a block; CascadeMVSNet and
     UCSNet at `cr_base_chs` (16, 16, 16): forwards with exact launches (24
     conv3d_block, 9 deconv3d_block), ms and peak memory beside the default
     width's, GPU vs CPU at 96×192; (d) remat on two gloo ranks sharing the
     card, CasMVS under mesh_depth 2 and RED under mesh_spatial 2: a step
     against the same mesh's step without remat (loss, update, running
     statistics), the regularizers run again in the backward, exact
     launches, step ms and peak memory a rank; (e) past 1024 state
     channels, where a thread of the ConvGRU kernels' own-pixel passes
     walks more than one group of four channels: red_recur and its
     backward at the deepest cell of `cr_base_chs` (129, 8, 8) (D 64,
     12×24, Cin 1032 → C 1032) from a zero and a seeded start state and at
     Cn = 1030 (run at 1032), at C = 2056 on a small plane and batched (B =
     4, a scene chunk's deepest cell), against the plain versions at
     phases 2 and 8's tolerances, the same bits twice, each element against
     its B = 1 call, kernel / plain / bound ms; CascadeREDNet at
     `cr_base_chs` (129, 8, 8) as (b) does at (6, 6, 6).
  17 the one-stage cascade (ndepths (64,), `--ndepths 64`): (a) each family
     at 384×768 on phase 3's triplet: exact launches (RED 1 sweep_variance,
     3 conv_dn, 4 red_recur, 3 deconv_up, 1 conv_head; CasMVS / UCS 1
     sweep_variance, 8 conv3d_block, 3 deconv3d_block), stage 1's maps at
     the top level, ranges, the same model's plain run on the CPU (depth
     mean and p99 of a step, confidence), ms and peak memory beside the
     three-stage forward's; RED's streamed forward at slab 8 (exact
     launches, 8 slabs of stage 1's kernels) against it; (b) one RED
     forward and backward at 96×192 with stage-scale ground truth, card
     against CPU at phase 7's gates, exact launches; (c) `cli.predict
     --ndepths 64` on phase 9's test split (exact launches, 96×192 maps the
     bits of a direct forward); (d) the refusals, raised on the card as on
     the CPU: two stages, the one-stage train and eval steps, the one-stage
     scene.

The 1152² scene and phase 9's tree are rendered on the host in worker
processes started before phase 1, and phase 3's three 384×768 scenes in
workers started after it (its nvcc processes want the cores), so they
overlap phases 1-3 (phase 9 writes under build/chip_smoke/); every later
batch of the same scene reuses its render (`memo_scenes`).  Each
phase, or group of phases, prints the seconds it took.  Ends with a JSON
line of per-kernel numbers (each kernel's launches on each path: the
full-volume forward, the streaming forward of phase 4, the two scene runs,
the fused train and eval steps, the fused_red-off train steps, phase 9's
train, predict and scene CLI runs, phase 10's two family forwards and its
predict run, phase 11's steps, CLI epoch and forwards, phase 12's
forwards, steps and CLI runs, phase 13's data-parallel steps and
tile-parallel scene, phase 14's knob forwards, steps and predict runs,
phase 15's e2e steps and forwards, profiled calls and each collectives
mesh's rank 0, phase 16's forwards, streamed chunks and steps of (b) and
(e) and rank 0's remat steps, and phase 17's forwards, streamed forward,
differentiable check and predict run), the
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
# H100 SXM TF32 tensor cores (495 TFLOP/s dense) over the three TF32
# products of a 3×TF32 split: the fp32 rate of the conv3d_block kernels
TF32X3_FLOPS_PER_S = 495e12 / 3
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
    fewer than `calls` of them (each call launches one at least) is taken
    again, twice at most.  Late in a long run the profiler has recorded no
    kernel on the card in three captures (seen in phases 10 and 11, never in
    phase 8), or only some of a capture's launches (seen in phase 10); then
    the time is CUDA events around `calls` calls
    launched back to back (`loop_ms`: every kernel fn launches, the card's
    time without the host's launch latency), and a line says so."""
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
        picked = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and pick(e.key)]
        if sum(e.count for e in picked) >= calls:
            return sum(e.self_device_time_total for e in picked) / 1e3 / calls
    ms = loop_ms(fn, calls)
    print(f"[profile] the profiler recorded fewer than {calls} "
          f"{getattr(kernel, '__name__', kernel)} kernels in three captures: {ms:.4f} ms a "
          f"call by CUDA events, {calls} calls back to back", flush=True)
    return ms


def conv3x3_kernel_name(key: str) -> bool:
    """A profiler key of plane_conv.cu's conv kernel (not the transposed one)."""
    return "conv3x3_kernel" in key and "deconv" not in key


def bound_ms(nbytes: float, flops: float, rate: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over the HBM rate or operations over
    `rate` (the fp32 rate of the arithmetic the kernel runs), whichever is
    larger, and which one that is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
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
             library=None, timed: bool = True, count: int = 1, exact=None,
             rate: float = FP32_FLOPS_PER_S, reps: int = 10):
        """tol(plain result): the abs error allowed, a number or one per
        element (a tuple of such functions, one per output, for a kernel
        with several outputs); library: one PyTorch call that computes the
        same function, timed as a yardstick; count: calls of this shape on
        the path, which the sums weigh by; exact: what the kernel is held to
        where that is not the plain version's fp32 result (the plain version
        in float64), and then tol's argument; rate: the bound's operations
        rate (`bound_ms`); reps: the kernel's and the library call's timed
        calls (the plain version's half as many), fewer for calls that take
        seconds."""
        name = self.rec["name"]
        got, want = kernel(), (exact or plain)()
        torch.cuda.synchronize()
        # a backward returns several cotangents: each is held to its own tolerance
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        tols = tol if isinstance(tol, tuple) else (tol,) * len(pairs)
        for i, ((a, b), tol_i) in enumerate(zip(pairs, tols)):
            part = f"[{i}]" if len(pairs) > 1 else ""
            t = tol_i(b)
            diff = (a.float() - b.float()).abs()  # a bf16 output compared in fp32
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
        k_ms = time_ms(kernel, reps=reps, warmup=min(3, reps))
        p_ms = time_ms(plain, reps=max(reps // 2, 1), warmup=1)
        l_ms = time_ms(library, reps=reps, warmup=min(3, reps)) if library is not None else None
        b_ms, by = bound_ms(nbytes, flops, rate)
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
                 planes: slice = slice(None), views: int = 3, device="cuda"):
    """Features (b, views, h, w, C) and coordinates xs, ys (b, views − 1, D,
    h, w) of cascade stage `stage` (0-based) on b patches of h×w pixels at
    the stage's scale.  Sample i takes the synthetic RPC triplet of seed i
    (its image the patch at full scale, the nadir view the reference; more
    source views from the forward and backward looks of the triplets of
    seeds i + 17, i + 34, ...) and the hypotheses the forward builds
    (`stage_hypotheses`): uniform over the height range at stage 0 or with
    window=False, else a window around a seeded smooth previous depth within
    the range; `planes` cuts a slab; on `device` (gen's)."""
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
        cams = warp.build_rpc_warp_cams(rpcs, 0, 1.0 / scale, device=device)
        lo, hi = rpclib.height_range(rpcs[0])
        prev = None
        if stage > 0 and window:  # a 6×12 random grid, bilinearly upsampled
            grid = torch.rand((1, 1, 6, 12), generator=gen, device=device)
            up = F.interpolate(grid, size=(h // 2, w // 2), mode="bilinear", align_corners=True)
            prev = lo + (hi - lo) * (0.1 + 0.8 * up[:, 0])
        hyps = stage_hypotheses(NDEPTHS[stage], h, w, torch.tensor([lo], device=device),
                                torch.tensor([hi], device=device), STAGE_INTERVALS[stage],
                                prev)[0, planes]
        coords.append([warp.rpc_sweep_coords(cams, s, hyps, h, w) for s in range(views - 1)])
    d = coords[0][0][0].shape[0]
    xs, ys = torch.stack([q[k] for pair in coords for q in pair for k in (0, 1)]).view(
        b, views - 1, 2, d, h, w).unbind(2)
    feats = torch.randn((b, views, h, w, FEAT_CH[stage]), generator=gen, device=device)
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


def plane_calls(base: int = RED_BASE):
    """(label, op, stride, transposed, N, H, W, Cin, Cout, gated) of the 21
    plane convs of a 384×768 forward (conv_dn ×9, deconv_up ×9, conv_head
    ×3) and the 21 dx of a train step's backwards at RED base width `base`,
    as the kernels see them:
    a dx takes the cotangent as its input (conv_dn's dx is a gated
    transposed conv, deconv_up's a gated stride-2 conv, conv_head's a
    stride-1 conv from one channel)."""
    b = base
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


def costreg_blocks(b: int = 1, base: int = COSTREG_BASE):
    """(stage, block, op, N, H, W, Cin, Cout) of the 33 3-D blocks of a
    384×768 CostRegNet forward of B = b elements at base width `base` (both
    families: feature channels 32/16/8), as the per-tap plane-conv forms composed them
    see each (three calls, one per depth tap, on the N = b·D' planes the
    block reads): ConvBlock_0..6 (the stride-1 ones conv_head with a zero
    bias, the stride-2 ones conv_dn without ReLU, on D/2 even or odd planes
    of H × W), DeconvBlock_0..2 (deconv_up without ReLU or skip) and the
    1-channel head (conv_head).  Phase 10 runs each as one conv3d_block or
    deconv3d_block call (`block_work`)."""
    c = base
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
                        **{k: 0 for k in BACKWARD_KERNELS}, "wgrad3x3": 0,
                        "sweep_variance_backward": 0, "sweep_gather_bf16": 0,
                        "sweep_scatter_bf16": 0, "conv3d_block": 0, "deconv3d_block": 0}
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
# phase 11, per train step at B = 1: on the fused sweep (train_fused_sweep)
# per stage one sweep_variance forward and one sweep_variance_backward (the
# whole VJP), no sweep_gather or sweep_scatter; with bf16 volumes the
# sweep pair's bf16 instances; CasMVS / UCS the fp32 sweep pair only (their
# CostRegNet trains as cuDNN's conv3d, no CostRegNet kernel); per-view
# inference forwards a gather per stage and source view instead of
# sweep_variance
LAUNCHES_PER_FUSED_SWEEP_STEP = {**LAUNCHES_PER_TRAIN_STEP, "sweep_variance": 3,
                                 "sweep_variance_backward": 3, "sweep_gather": 0,
                                 "sweep_scatter": 0}
LAUNCHES_PER_BF16_STEP = {**LAUNCHES_PER_TRAIN_STEP, "sweep_gather": 0, "sweep_scatter": 0,
                          "sweep_gather_bf16": 6, "sweep_scatter_bf16": 6}
LAUNCHES_PER_COSTREG_TRAIN_STEP = LAUNCHES_PER_SCAN_STEP
LAUNCHES_PER_VIEW_FORWARD = {**LAUNCHES_PER_FORWARD, "sweep_variance": 0, "sweep_gather": 6}
LAUNCHES_PER_VIEW_BF16_FORWARD = {**LAUNCHES_PER_FORWARD, "sweep_variance": 0,
                                  "sweep_gather_bf16": 6}
# the kernels each path must launch
INFERENCE_PATHS = ("forward", f"scene_b{BATCH_TILES}", "scene_b1", "streaming")
CLI_PATHS = ("cli_train", "cli_predict", "cli_scene")  # phase 9: each runs every inference kernel
TRAIN_KERNELS = ("sweep_gather", "sweep_scatter", *BACKWARD_KERNELS, "wgrad3x3")
RED_FORWARD_KERNELS = ("conv_dn", "red_recur", "deconv_up", "conv_head")
# phase 11: the new instances' paths, the first the main one, and the fp32
# sweep pair's further paths (the CostRegNet families' training, the
# per-view inference sweep)
SWEEP_TRAIN_PATHS = {"sweep_variance_backward": ("fused_sweep_step",),
                     "sweep_gather_bf16": ("bf16_step", "per_view_bf16_forward"),
                     "sweep_scatter_bf16": ("bf16_step",)}
FP32_SWEEP_PATHS = {"sweep_gather": ("casmvs_train_step", "ucs_train_step", "cli_train_ucs",
                                     "per_view_forward"),
                    "sweep_scatter": ("casmvs_train_step", "ucs_train_step", "cli_train_ucs")}


def build_model(device, geo_model: str = "rpc", ndepths=NDEPTHS, **knobs):
    """CascadeREDNet (RPC or pinhole, ndepths 64/32/8 unless given, further
    `CascadeModel` knobs) from seed 0, heads ×40 (a peaked softmax, so
    depth parity is not trivial)."""
    from satmvs_tpu_torch.models import CascadeREDNet

    model = CascadeREDNet(geo_model=geo_model, ndepths=ndepths, device=device, seed=0, **knobs)
    with torch.no_grad():
        for reg in model.regs:
            reg.step.head.weight.mul_(40.0)
            reg.step.head.bias.mul_(40.0)
    return model


def counts() -> dict:
    """Each kernel wrapper's launches so far (the sweep pair's fp32 and bf16
    instances apart)."""
    from satmvs_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def reset_counts():
    from satmvs_tpu_torch.ops.kernels import wrappers

    for fn, attr in wrappers().values():
        setattr(fn, attr, 0)


def stage_steps(lo: float, hi: float, intervals) -> list[float]:
    """Hypothesis step per stage: the range / (D − 1) at stage 1, D·interval
    / (D − 1) in the windows of stages 2-3."""
    return [(hi - lo) / (NDEPTHS[0] - 1)] + [
        nd * iv / (nd - 1) for nd, iv in zip(NDEPTHS[1:], intervals[1:])]


def err_quantiles(err: torch.Tensor) -> tuple[float, float, float]:
    err = err.flatten().float().cpu()
    return err.mean().item(), torch.quantile(err, 0.99).item(), err.max().item()


def gpu_vs_cpu(tag: str, what: str, gpu_out: dict, cpu_model, imgs, cams, dvals,
               gate_conf: bool = False):
    """The same model's plain run on the CPU against a GPU forward's output,
    stage by stage: each CPU stage centres its window on the GPU's
    previous-stage depth (and, for UCSNet, takes its spread), so a stage is
    held to its own numerical differences only (DEPTH_TOL_MEAN,
    DEPTH_TOL_P99 of its step; UCSNet's windows: each pixel's own step);
    the free-running CPU cascade is reported beside it, not gated.  For the
    4-plane window confidence of the CostRegNet families also the
    confidence (CONF_TOL_MEAN, CONF_TOL_P99) and UCSNet's variance (the
    depth gates, in steps); with gate_conf the max-prob confidence too."""
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
        if cpu_model.confidence == "window4" or gate_conf:
            c_mean, c_p99 = cerr.mean().item(), torch.quantile(cerr.flatten(), 0.99).item()
            kind = "window" if cpu_model.confidence == "window4" else "max-prob"
            line = (f"{tag} GPU vs CPU plain, {what} stage{i + 1}: {kind} confidence err mean "
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

    reset_counts()
    outs = []
    for i, b in enumerate(batches):
        outs.append(model(b["imgs"], b["cams"], b["depth_values"]))
        for name, n in counts().items():
            want = LAUNCHES_PER_FORWARD[name] * (i + 1)
            check(n == want, f"{name} launches {n} after {i + 1} forwards, want {want}")
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


def render_scene(key: tuple = (SCENE_SIZE, SCENE_SIZE, 0, 80.0)) -> dict:
    """The synthetic triplet `synthetic.make_scene(*key)` (host numpy,
    seeded; by default the 1152² scene); runs in a worker process, so it
    puts the repository on its own import path."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from satmvs_tpu_torch.data import synthetic

    return synthetic.make_scene(*key)


# the scenes the workers render ahead (make_scene's width, height, seed,
# h_amp): phase 3's three 384×768 batches, seed 0 the batch of most phases
AHEAD_SCENES = tuple((WIDTH, HEIGHT, s, 80.0) for s in SEEDS)


def memo_scenes(jobs: dict) -> None:
    """`synthetic.make_scene` memoized in this process, each key rendered
    once (taken from `jobs`, key → a worker's Future, where one renders
    it), every call given its own copies of the arrays.  The phases build
    the same seeded scenes again and again (the 384×768 scene of seed 0
    some twenty times, ~15 s of host time each): the batches are the same
    bits, rendered once.  Spawned ranks and CLI subprocesses render their
    own."""
    from satmvs_tpu_torch.data import synthetic

    render, scenes = synthetic.make_scene, {}

    def make_scene(width: int = 128, height: int = 128, seed: int = 0,
                   h_amp: float = 120.0) -> dict:
        key = (width, height, seed, h_amp)
        if key not in scenes:
            scenes[key] = jobs.pop(key).result() if key in jobs else render(*key)
        return {k: v.copy() for k, v in scenes[key].items()}

    synthetic.make_scene = make_scene


def phase_scene(card: str, model, scene: dict):
    """Phase 5: predict_scene over the slab-streaming forward at batch_tiles
    4 and 1.  Returns each run's launches, the first 4-tile chunk's inputs
    (phase 4 takes them) and the scene with the batch_tiles-4 maps and the
    final stage's step (phase 13 takes them)."""
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
    profile_forward(lambda: stream(*chunks[0]), card,
                    what=f"one {BATCH_TILES}-tile streaming chunk")
    ref = {"images": images, "rpcs": rpcs, "depth": runs[BATCH_TILES][0],
           "conf": runs[BATCH_TILES][1], "step": step}
    return {f"scene_b{bt}": run[2] for bt, run in runs.items()}, chunks[0], ref


def phase_stream_vs_full(card: str, model, chunk, what: str = "RPC") -> dict:
    """Phase 4: the streaming forward (slab 8) against the same model's
    full-volume forward on one 4-tile chunk, stage by stage (each
    full-volume stage centred on the streaming run's previous-stage depth),
    and the peak memory of each (phase 12: on a pinhole batch).  Returns
    the streaming run's launches."""
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
        print(f"[stream] {what} B={bt} slab {SLAB} vs full volume, stage{i + 1} (step "
              f"{step:.3f} m), "
              f"same window centres: depth err mean {mean:.3e}, p99 {p99:.3e}, max {mx:.3e} of "
              f"step (tol mean {DEPTH_TOL_MEAN}, p99 {DEPTH_TOL_P99}), conf err max {cerr:.3e}; "
              f"free-running: mean {fmean:.3e}, p99 {fp99:.3e}, max {fmx:.3e}", flush=True)
        check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
              f"stage{i + 1}: streaming vs full depth err mean {mean}, p99 {p99} of step")
    s_ms = time_ms(lambda: streaming_red_forward(model, imgs, cams, dvals, slab=SLAB), reps=3,
                   warmup=1)
    f_ms = time_ms(lambda: model(imgs, cams, dvals), reps=3, warmup=1)
    print(f"[stream] {what} B={bt} tiles of {imgs.shape[2]}x{imgs.shape[3]}: streaming "
          f"{s_ms:.2f} ms "
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


def gather_cases() -> list[tuple]:
    """(label, src, xs, ys, g) of the training sweep pair: both source views
    of every stage of a 384×768 train step (RPC coordinates of uniform
    planes over the height range), then the first case's coordinates pushed
    off the image, some far off ("off-image")."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.geo import rpc as rpclib
    from satmvs_tpu_torch.ops import warp

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
    return cases


def phase_sweep_gather(card: str) -> list[dict]:
    """Phase 6: sweep_gather and sweep_scatter against their plain versions
    at the training shapes (both source views of every stage), and with
    coordinates pushed off the image."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    cases = gather_cases()
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


# phase 11's CasMVS / UCS step, GPU vs CPU: their CostRegNet needs D % 8 == 0,
# and their train-mode forward is ill-conditioned at B = 1 (the CostRegNet's
# coarsest train-mode BatchNorms take their statistics over few values a
# channel, stages 2-3 centre their windows on the previous stage's
# train-mode depth; `train_sensitivity.py --only jax` measures JAX's own step
# moving by up to 6.3e-4 in its depth_loss, 0.42 in its update over all and
# 2.7e-3 in its statistics under a 1e-6 perturbation of the images): the train
# step's loss to 1e-3, its update to 0.5 over all (per tensor not gated), the
# running statistics to 3e-3; the eval-mode loss and gradients keep the gates
# above
COSTREG_PARITY_NDEPTHS = (16, 8, 8)
COSTREG_PARITY = {"step_loss": 1e-3, "update": None, "update_all": 0.5, "stats": 3e-3}
# phase 11's bf16-volume step, GPU vs CPU: a sample whose fp32 value lies
# near a bf16 rounding boundary rounds the other way on the card (the
# kernel's FMA taps against the plain version's products), a 2⁻⁸ change of
# that volume value and of its cotangent; on the CPU a 1e-7 relative
# perturbation of the images moves the bf16 step's eval-mode gradients by up
# to 8.6e-2 relative norm per tensor (7.8e-3 over all) and its update by
# 0.63 per tensor (5.2e-2 over all), against 9.5e-3 / 4.1e-2 in fp32
# (`train_sensitivity.py --only bf16`).  Gates about 2.5× those:
# eval-mode gradients 0.2 per tensor and 2e-2 over all, the update 0.15
# over all (per tensor not gated)
BF16_PARITY = {"grad": 0.2, "grad_all": 2e-2, "update": None, "update_all": 0.15}
# phase 12's pinhole step, GPU vs CPU: its depths are camera z at orbit
# distance (~ −1.5e5 m, an fp32 ulp of 0.016 m against hypothesis steps of
# 3-17 m), so the softmax's backward, p·(d − depth), cancels large values;
# on the CPU a 1e-7 relative perturbation of the images moves the pinhole
# step's eval-mode gradients by up to 0.124 relative norm per tensor
# (1.98e-4 over all) and its update by 0.490 per tensor (7.06e-2 over all),
# against 2.37e-2 / 7.83e-5 / 4.14e-2 / 6.26e-3 for RPC cameras and
# 1.92e-2 / 2.61e-5 / 8.61e-2 / 7.89e-3 for QC (`train_sensitivity.py
# --only cameras`).  Gates about 2.5× the pinhole spread: eval-mode
# gradients 0.3 per tensor, the update 0.2 over all (per tensor not gated);
# the QC step keeps phase 7's gates
PINHOLE_PARITY = {"grad": 0.3, "update": None, "update_all": 0.2}


def phase_train_parity(card: str, what: str = "fused step", fused_sweep: bool = False,
                       gates: dict | None = None, make_batch=None, **fields):
    """One eval-mode gradient and one train step at PARITY_SIZE on the card
    and on the CPU from the same weights and batch (phase 7, last part, and
    phases 11 and 12): Config(ndepths=PARITY_NDEPTHS, seed=5, **fields) on
    make_batch(width, height) (a CPU batch; by default
    `synthetic.make_batch(1, w, h, seed=1, use_qc=...)` with cfg's use_qc),
    with fused_sweep the train step on the fused sweep (SATMVS_TRAIN_FUSED_SWEEP);
    `gates` overrides the eval-mode loss's ("loss") and gradients' ("grad"
    per tensor, None: not gated; "grad_all"), the train step's loss
    ("step_loss"), update ("update" per tensor, None: not gated;
    "update_all") and statistics ("stats") gates."""
    import os

    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models.losses import cascade_loss
    from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step

    t0 = time.time()
    h, w = PARITY_SIZE
    cfg = Config(**{"ndepths": PARITY_NDEPTHS, "seed": 5, **fields})
    cpu_batch = (make_batch(w, h) if make_batch else
                 synthetic.make_batch(1, w, h, seed=1, device="cpu", use_qc=cfg.use_qc))
    gate = {"loss": PARITY_LOSS, "step_loss": PARITY_LOSS, "update": PARITY_UPDATE,
            "update_all": PARITY_UPDATE_ALL,
            "stats": PARITY_STATS, "grad": PARITY_GRAD, "grad_all": PARITY_GRAD_ALL,
            **(gates or {})}
    runs = {}
    for dev in ("cuda", "cpu"):
        batch = batch_to(cpu_batch, dev)
        os.environ["SATMVS_TRAIN_FUSED_SWEEP"] = "1" if fused_sweep else "0"
        try:
            model, state, tx = create_model_and_state(cfg, batch, 1)
        finally:
            del os.environ["SATMVS_TRAIN_FUSED_SWEEP"]
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
        tol = gate[name]
        print(f"[train] {what} GPU vs CPU {h}x{w} ndepths {tuple(cfg.ndepths)}: {name} "
              f"{gpu[name]:.6f} vs "
              f"{cpu[name]:.6f}, {rel:.3e} relative (tol {tol})", flush=True)
        check(rel <= tol, f"{what} parity: {name} {rel} relative")
    scale = max(g.abs().max().item() for g in cpu["grads"].values())
    worst, head, g_num, g_den, worst_name = 0.0, 0.0, 0.0, 0.0, ""
    for n, g in gpu["grads"].items():
        diff = (g - cpu["grads"][n]).norm().item()
        if n.endswith("head.bias"):
            head = max(head, diff / scale)
        else:
            rel = diff / cpu["grads"][n].norm().item()
            worst, worst_name = max((worst, worst_name), (rel, n))
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
    print(f"[train] {what} GPU vs CPU: eval-mode gradients max relative norm {worst:.3e} over "
          f"{len(gpu['grads'])} tensors ({worst_name}; tol {gate['grad']}), {g_total:.3e} over "
          f"all (tol "
          f"{gate['grad_all']}), head biases {head:.3e} of the "
          f"largest element (tol {PARITY_HEAD}); update relative norm max {upd:.3e} per tensor "
          f"(tol {gate['update']}), {total:.3e} over all (tol {gate['update_all']}); running "
          f"statistics {stats:.3e} (tol {gate['stats']}); {time.time() - t0:.1f} s", flush=True)
    check((gate["grad"] is None or worst <= gate["grad"]) and g_total <= gate["grad_all"]
          and head <= PARITY_HEAD,
          f"{what} parity: eval-mode gradients")
    check((gate["update"] is None or upd <= gate["update"]) and total <= gate["update_all"],
          f"{what} parity: the update")
    check(stats <= gate["stats"], f"{what} parity: running statistics")


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


def run_train_steps(cfg, batch, n_steps: int, want: dict, what: str, card: str,
                    fused_sweep: bool = False, remat: bool = False):
    """n_steps train steps of a fresh model from cfg on batch (with
    fused_sweep on the fused sweep: SATMVS_TRAIN_FUSED_SWEEP=1 while the
    model is built; with remat its regularizers checkpointed), each checked
    for exact launches and finite scalars; returns (model, state, tx, step
    function, launches in all, step ms, losses, peak GiB)."""
    import os

    from satmvs_tpu_torch.train import create_model_and_state, make_train_step

    os.environ["SATMVS_TRAIN_FUSED_SWEEP"] = "1" if fused_sweep else "0"
    try:
        model, state, tx = create_model_and_state(cfg, batch, TRAIN_STEPS)
    finally:
        del os.environ["SATMVS_TRAIN_FUSED_SWEEP"]
    check(model.train_fused_sweep == fused_sweep, f"{what}: train_fused_sweep")
    model.remat = remat
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


def phase_train(card: str) -> tuple[dict, dict]:
    """Phase 7: the training path at full width, on the fused RED pipeline
    (Config() defaults) and with fused_red off; returns the launches of the
    fused train steps' run, of the eval step's and of the scan steps', and
    the default step's median ms and peak GiB."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config, make_eval_step

    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    cfg = Config(ndepths=NDEPTHS)
    check(cfg.fused_red is None, "Config() must default to fused_red None")
    model, state, tx, train_step, train_launches, times, losses, peak = run_train_steps(
        cfg, batch, TRAIN_STEPS, LAUNCHES_PER_TRAIN_STEP, "fused", card)
    default_step = {"ms": float(np.median(times)), "peak": peak}
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
    *_, scan_launches, _, _, _ = run_train_steps(
        scan_cfg, batch, SCAN_STEPS, LAUNCHES_PER_SCAN_STEP, "scan (fused_red off)", card)
    phase_train_parity(card)
    return {"train_step": train_launches, "eval_step": eval_launches,
            "scan_train_step": scan_launches}, default_step


# phase 11: the training sweeps, each path's own steps
SWEEP_STEPS = 3


def bf16_tol(want) -> torch.Tensor:
    """The bf16 gather against its plain version: each value within one bf16
    unit in the last place of the plain value (the two round fp32 samples
    that differ by FMA contraction, and one near a rounding boundary may
    round the other way) plus rel_tol (the fp32 samples' own difference,
    which decides where a sample cancels to near 0)."""
    _, e = torch.frexp(want.float().abs())
    return torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8) + rel_tol(want.float())


# the bf16 pair's figures before its redesign (PERF.md rows "2, bf16" and
# "3, bf16", as the port first ran them on an H100 80GB HBM3 at 700 W),
# summed over a train step's six views: CUDA events and profiler device ms
BF16_PAIR_WAS = {"gather": (0.8261, 0.3719), "scatter": (1.4335, 0.9498)}


def bf16_kernel(wrapper: str):
    """A profiler-key filter for the bf16 instance of the sweep pair's
    `wrapper` kernel under either design: `sweep_<x>_bf16_kernel` or the
    earlier fp32 template's `sweep_<x>_kernel<4, unsigned short>`."""
    return lambda k: wrapper in k and ("bf16" in k or "unsigned short" in k)


def launch_host_ms(fn, calls: int = 20) -> float:
    """Median host time of one call of fn (its wrapper and launch), each
    after a synchronize, so the launch finds the queue empty."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * float(np.median(times))


def sweep_backward_work(feats, xs, ys) -> tuple[float, float]:
    """Bytes (the volume's cotangent, the coordinates and the features read
    once, the reference's and the source views' cotangents written once)
    and flops (per valid tap a multiply and an add a channel to gather and
    as many to scatter; per element of the volume the mean, the reference's
    term and each view's cotangent: 4·S + 5) of one sweep_variance_backward
    on this data: feats (B, V, Hs, W, C), xs/ys (B, S, D, H, W)."""
    b, n_src, d, h, w = xs.shape
    hs, c = feats.shape[2], feats.shape[-1]
    vol = b * d * h * w * c
    nbytes = 4 * (vol + b * h * w * c + b * n_src * hs * w * c + 2 * xs.numel() + feats.numel())
    x0, y0 = torch.floor(xs), torch.floor(ys)
    taps = sum(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < hs)).sum().item()
               for dx in (0, 1) for dy in (0, 1))
    return nbytes, 4 * c * taps + vol * (4 * n_src + 5)


def summation_bound(gs, xs, ys, height: int) -> torch.Tensor:
    """How far each element of the scatter of gs (..., D, H', W', C) at the
    samples xs/ys (..., D, H', W') into (..., height, W', C) may move when its
    n = 4·D terms are summed in another order (float atomics): 2·(n − 1)·2⁻²⁴
    times the sum of the magnitudes of its terms.  Reads only
    `sweep_scatter_reference`, so it serves any tree kernel_ab.py times."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg

    d, w = xs.shape[-3], xs.shape[-1]
    flat = zip(gs.reshape(-1, *gs.shape[-4:]), xs.reshape(-1, *xs.shape[-3:]),
               ys.reshape(-1, *ys.shape[-3:]))
    mag = torch.stack([sg.sweep_scatter_reference(g.abs(), x, y, height, w) for g, x, y in flat])
    return 2 * (4 * d - 1) * 2.0 ** -24 * mag.reshape(*xs.shape[:-3], height, w, gs.shape[-1])


# the fused sweep's VJP before it scattered as it went (PERF.md rows "1,
# backward" and 3 on an H100 80GB HBM3 at 700 W): the backward kernel that
# wrote the cotangent volumes, over a train step's 3 launches, and the fp32
# sweep_scatter over its 6 (device time from kernel_ab.py --only gather):
# CUDA events ms, profiler device ms and the bound
FUSED_VJP_WAS = {"backward": (0.8547, 0.6211, 0.3859), "scatter": (1.3075, 1.0131, 0.2634)}


def phase_sweep_train_kernels(card: str) -> list[dict]:
    """Phase 11 (c): each new kernel instance against its plain version at
    the three stage shapes of a 384×768 train step: sweep_variance_backward,
    the fused sweep's whole VJP, on the forward's coordinates (B = 1, S = 2;
    dref and dsrcs against the plain VJP to rel_tol, dref the same bits in
    a second run, dsrcs from run to run within `summation_bound`), the
    bf16 gather (`bf16_tol`, the same bits twice) and the bf16 scatter (the
    summation bound of phase 6; its run-to-run difference; the share of its
    blocks outside their shared-memory window) on phase 6's cases; kernel
    ms by events, device ms by torch.profiler (`bf16_kernel`), the
    wrappers' host ms a call, bound and plain ms, and FUSED_VJP_WAS and
    BF16_PAIR_WAS beside the step's sums.  No single PyTorch call computes
    any of the three (library null)."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    backward = KernelReport("sweep_variance_backward", "satmvs_tpu_torch/csrc/sweep_variance.cu",
                            "satmvs_tpu/ops/pallas/sweep_variance.py:226", card)
    gen = torch.Generator(device="cuda").manual_seed(11)
    dev, spread = 0.0, 0.0
    for i in range(3):
        h, w = HEIGHT // STAGE_SCALES[i], WIDTH // STAGE_SCALES[i]
        feats, xs, ys = sweep_inputs(i, 1, h, w, gen)
        g = torch.randn((1, NDEPTHS[i], h, w, FEAT_CH[i]), generator=gen, device="cuda")
        bound = summation_bound(sv._backward_reference(feats[:, 0], feats[:, 1:], xs, ys, g)[0],
                                xs, ys, h)
        label = f"stage{i + 1} {tuple(g.shape)}"
        backward.case(label, lambda: sv.sweep_variance_backward(feats, xs, ys, g),
                      lambda: sv.sweep_variance_backward_reference(feats, xs, ys, g),
                      (rel_tol, rel_tol), *sweep_backward_work(feats, xs, ys))
        a, b = sv.sweep_variance_backward(feats, xs, ys, g), sv.sweep_variance_backward(
            feats, xs, ys, g)
        same = torch.equal(a[0], b[0])
        diff = (a[1] - b[1]).abs()
        within = bool((diff <= bound + 1e-30).all())
        spread = max(spread, diff.max().item())
        d_ms = device_ms(lambda: sv.sweep_variance_backward(feats, xs, ys, g),
                         "sweep_variance_backward", 5)
        dev += d_ms
        print(f"[sweeps] sweep_variance_backward {label}: dref the same bits in a second run "
              f"{same}, dsrcs run to run {diff.max().item():.3e} (summation bound up to "
              f"{bound.max().item():.3e}, within it {within}), device {d_ms:.4f} ms (profiler) "
              f"card={card}", flush=True)
        check(same, f"sweep_variance_backward {label}: dref bits differ between runs")
        check(within, f"sweep_variance_backward {label}: dsrcs run to run past the bound")
        del feats, xs, ys, g, a, b, bound, diff
    was_b, was_s = FUSED_VJP_WAS["backward"], FUSED_VJP_WAS["scatter"]
    print(f"[sweeps] sweep_variance_backward (the whole VJP) over a train step's 3 launches: "
          f"device {dev:.4f} ms (was {was_b[1]} + {was_s[1]} = {was_b[1] + was_s[1]:.4f}: 3 "
          f"backward + 6 sweep_scatter), events {backward.rec['ms']:.4f} ms (was {was_b[0]} + "
          f"{was_s[0]} = {was_b[0] + was_s[0]:.4f}), bound {backward.rec['bound_ms']:.4f} ms "
          f"(was {was_b[2]} + {was_s[2]}), dsrcs run to run at most {spread:.3e} card={card}",
          flush=True)

    gather = KernelReport("sweep_gather_bf16", "satmvs_tpu_torch/csrc/sweep_gather.cu",
                          "satmvs_tpu/ops/pallas/sweep_gather.py:436", card)
    scatter = KernelReport("sweep_scatter_bf16", "satmvs_tpu_torch/csrc/sweep_gather.cu",
                           "satmvs_tpu/ops/pallas/sweep_gather.py:576", card)

    def bf16_bytes(d, h, w, c):
        return 2 * d * h * w * c + 8 * d * h * w + 4 * h * w * c

    dev, host = [0.0, 0.0], [0.0, 0.0]
    blocks = [0, 0]
    for label, src, xs, ys, g in gather_cases():
        timed = label != "off-image"
        d, h, w = xs.shape
        c = src.shape[-1]
        flops = gather_work(src, xs, ys)[1]
        gather.case(label, lambda: sg.sweep_gather(src, xs, ys, torch.bfloat16),
                    lambda: sg.sweep_gather_reference(src, xs, ys, torch.bfloat16), bf16_tol,
                    bf16_bytes(d, h, w, c), flops, timed=timed)
        same = torch.equal(sg.sweep_gather(src, xs, ys, torch.bfloat16),
                           sg.sweep_gather(src, xs, ys, torch.bfloat16))
        check(same, f"sweep_gather_bf16 {label}: bits differ between runs")
        gb = g.to(torch.bfloat16)
        mag = sg.sweep_scatter_reference(gb.abs(), xs, ys, h, w).max().item()
        tol = 2 * (4 * d - 1) * 2.0 ** -24 * mag
        before = sg.window_blocks("cuda").clone()
        one = sg.sweep_scatter(gb, xs, ys)
        n, out = (sg.window_blocks("cuda") - before).tolist()
        del one
        scatter.case(label, lambda: sg.sweep_scatter(gb, xs, ys),
                     lambda: sg.sweep_scatter_reference(gb, xs, ys, h, w), lambda want: tol,
                     bf16_bytes(d, h, w, c), flops, timed=timed)
        again = (sg.sweep_scatter(gb, xs, ys) - sg.sweep_scatter(gb, xs, ys)).abs().max().item()
        check(again <= tol, f"sweep_scatter_bf16 {label}: run-to-run {again} > {tol}")
        plan = sg.scatter_window_plan(d, h, w, c, sms=torch.cuda.get_device_properties(
            0).multi_processor_count)
        line = (f"[sweeps] bf16 pair {label}: gather same bits twice {same}; scatter run-to-run "
                f"{again:.3e} (bound {tol:.3e}); scatter blocks outside their window {out} of "
                f"{n} ({out / max(n, 1):.4f}; tile {plan['ty']}x{plan['tx']}, "
                f"{plan['planes']} planes, {plan['cg']} channels a block)")
        if timed:
            blocks[0] += n
            blocks[1] += out
            gd = device_ms(lambda: sg.sweep_gather(src, xs, ys, torch.bfloat16),
                           bf16_kernel("sweep_gather"), 5)
            sd = device_ms(lambda: sg.sweep_scatter(gb, xs, ys), bf16_kernel("sweep_scatter"), 5)
            gh = launch_host_ms(lambda: sg.sweep_gather(src, xs, ys, torch.bfloat16))
            sh = launch_host_ms(lambda: sg.sweep_scatter(gb, xs, ys))
            dev[0] += gd
            dev[1] += sd
            host[0] += gh
            host[1] += sh
            line += (f"; device gather {gd:.4f} ms, scatter {sd:.4f} ms (profiler); host a call "
                     f"gather {gh:.4f} ms, scatter {sh:.4f} ms")
        print(f"{line} card={card}", flush=True)
    print(f"[sweeps] bf16 pair over a train step's six views: device gather {dev[0]:.4f} ms "
          f"(was {BF16_PAIR_WAS['gather'][1]}), scatter {dev[1]:.4f} ms (was "
          f"{BF16_PAIR_WAS['scatter'][1]}); events gather {gather.rec['ms']:.4f} (was "
          f"{BF16_PAIR_WAS['gather'][0]}), scatter {scatter.rec['ms']:.4f} ms (was "
          f"{BF16_PAIR_WAS['scatter'][0]}); host gather {host[0]:.4f}, scatter {host[1]:.4f} ms; "
          f"bounds {gather.rec['bound_ms']:.4f}, {scatter.rec['bound_ms']:.4f} ms; scatter "
          f"blocks outside their window {blocks[1]} of {blocks[0]} card={card}", flush=True)
    return [backward.record(), gather.record(), scatter.record()]


def per_view_forward(card: str, volume_dtype, want: dict) -> dict:
    """Phase 11 (e): CascadeREDNet's forward on the per-view sweep
    (fused_sweep=False; volume_dtype None or torch.bfloat16) at 384×768:
    exact launches (a gather per stage and source view, no sweep_variance),
    its ms, each stage against the default forward's, same window centres
    (the per-view stage i from the default's stage i − 1 depth), and the
    same model's plain run on the CPU at PARITY_SIZE (`gpu_vs_cpu`).  In
    fp32 the model is phase 3's (heads ×40) and both comparisons are held to
    DEPTH_TOL_MEAN / DEPTH_TOL_P99 of a step.  With bf16 volumes the
    comparison with the fp32 default is reported, not gated: bf16 storage
    moves every volume value by up to 2⁻⁹ relative, which moves stage 1's
    depth by 0.31 of a step on average at LeCun scale and by 2.4 steps with
    the heads ×40 (`train_sensitivity.py --only forward`).  Against the CPU
    only the values whose fp32 samples round to different bf16 neighbours
    differ (~3e-5 of them, a one-ulp step each); with the heads ×40 those
    flips alone moved stage 1's p99 past DEPTH_TOL_P99 on the card, so the
    bf16 model is phase 3's at LeCun scale without the gain.  Returns the
    launches."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models import CascadeREDNet

    def make(device):
        if volume_dtype is None:
            return build_model(device)
        return lecun_scale(CascadeREDNet(geo_model="rpc", ndepths=NDEPTHS, device=device, seed=0))

    model = make("cuda")
    model.volume_dtype = volume_dtype
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    default = model(imgs, cams, dvals)
    model.fused_sweep = False
    what = "per-view" + (" bf16" if volume_dtype is not None else "")
    torch.cuda.synchronize()
    reset_counts()
    out = model(imgs, cams, dvals)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == want, f"{what} forward launches {launches}")
    check(all(bool(torch.isfinite(v).all()) for v in (out["depth"],
                                                      out["photometric_confidence"])),
          f"{what} forward: non-finite output")
    fwd_ms = time_ms(lambda: model(imgs, cams, dvals), reps=3, warmup=1)
    print(f"[sweeps] {what} forward (fused_sweep off) at {HEIGHT}x{WIDTH}: launches "
          f"{({k: v for k, v in launches.items() if v})} (exact), {fwd_ms:.2f} ms (median of 3, "
          f"CUDA events) card={card}", flush=True)
    feats = model.features(imgs)
    lo, hi = dvals[0].tolist()
    for i, step in enumerate(stage_steps(lo, hi, model.stage_intervals())):
        prev = None if i == 0 else default[f"stage{i}"]["depth"]
        got = model.stage(i, feats[i], cams[i], dvals[:, 0], dvals[:, -1], prev)
        err = (got["depth"] - default[f"stage{i + 1}"]["depth"]).abs() / step
        mean, p99, mx = err_quantiles(err)
        gated = volume_dtype is None
        print(f"[sweeps] {what} forward stage{i + 1} against the default forward, same window "
              f"centres: depth err mean {mean:.3e}, p99 {p99:.3e}, max {mx:.3e} of step "
              + (f"(tol mean {DEPTH_TOL_MEAN}, p99 {DEPTH_TOL_P99})" if gated else
                 "(bf16 volumes: reported)"), flush=True)
        check(not gated or (mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99),
              f"{what} forward stage{i + 1}: depth err mean {mean}, p99 {p99} of step")
    del default, out, feats
    h, w = PARITY_SIZE
    small = synthetic.make_batch(1, w, h, seed=1, device="cuda")
    cpu_model = make("cpu")
    cpu_model.fused_sweep, cpu_model.volume_dtype = False, volume_dtype
    gpu_vs_cpu("[sweeps]", f"{what} forward at {h}x{w}",
               model(small["imgs"], small["cams"], small["depth_values"]), cpu_model,
               small["imgs"], small["cams"], small["depth_values"])
    return launches


def phase_training_sweeps(card: str, tree: str, default_step: dict) -> dict:
    """Phase 11: the training sweeps at 384×768, B = 1, Config() (the fused
    RED pipeline), TF32 off: (a) train steps on the fused sweep and (b) with
    bf16 volumes, each beside the default step run before and after them
    (and phase 7's, `default_step`: its median ms and peak GiB) and against
    its own CPU run at PARITY_SIZE; (d) CascadeMVSNet and UCSNet train
    steps, their CPU runs, and a `cli.train --model ucs` epoch on phase 9's
    tree; (e) the per-view inference sweep in fp32 and bf16.  (c), the new
    kernel instances alone (`phase_sweep_train_kernels`), runs beside phase
    6.  Returns each path's launches."""
    import os
    import shutil

    from satmvs_tpu_torch.cli import train as cli_train
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config

    t0 = time.time()
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    launches = {}
    steps = {}  # median ms and peak GiB of each run, phase 7's default step before and after
    for key, what, fields, fused, want in (
            ("default_before", "default", {}, False, LAUNCHES_PER_TRAIN_STEP),
            ("fused_sweep_step", "fused-sweep", {}, True, LAUNCHES_PER_FUSED_SWEEP_STEP),
            ("bf16_step", "bf16-volume", {"volume_dtype": "bfloat16"}, False,
             LAUNCHES_PER_BF16_STEP),
            ("default_after", "default", {}, False, LAUNCHES_PER_TRAIN_STEP)):
        cfg = Config(ndepths=NDEPTHS, **fields)
        *_, run_launches, times, losses, peak = run_train_steps(
            cfg, batch, SWEEP_STEPS, want, what, card, fused_sweep=fused)
        steps[key] = (float(np.median(times)), peak)
        if key.startswith("default"):
            continue
        launches[key] = run_launches
        check(losses[-1]["loss"] < losses[0]["loss"], f"{what} steps: the loss did not fall")
        phase_train_parity(card, f"{what} step", fused_sweep=fused,
                           gates=BF16_PARITY if fields else None, **fields)
    base_ms = (steps["default_before"][0] + steps["default_after"][0]) / 2
    base_peak = steps["default_before"][1]
    for key, what in (("fused_sweep_step", "fused-sweep"), ("bf16_step", "bf16-volume")):
        ms, peak = steps[key]
        print(f"[sweeps] {what} step {ms:.2f} ms, peak {peak:.3f} GiB against the default step "
              f"run before and after it {steps['default_before'][0]:.2f} / "
              f"{steps['default_after'][0]:.2f} ms, {base_peak:.3f} GiB: {ms / base_ms:.3f}x, "
              f"{peak - base_peak:+.3f} GiB (phase 7's default step {default_step['ms']:.2f} ms, "
              f"{default_step['peak']:.3f} GiB) card={card}", flush=True)
    for name in COSTREG_FAMILIES:
        cfg = Config(model=name, ndepths=NDEPTHS)
        *_, launches[f"{name}_train_step"], times, losses, peak = run_train_steps(
            cfg, batch, SWEEP_STEPS, LAUNCHES_PER_COSTREG_TRAIN_STEP, f"{name}", card)
        print(f"[sweeps] {name} train step {float(np.median(times)):.2f} ms, peak {peak:.3f} GiB "
              f"card={card}", flush=True)
        phase_train_parity(card, f"{name} step", gates=COSTREG_PARITY, model=name,
                           ndepths=COSTREG_PARITY_NDEPTHS)
    logdir = WORK / "ucs_logs"
    shutil.rmtree(logdir, ignore_errors=True)
    reset_counts()
    t1 = time.perf_counter()
    out = cli_train.main(["--mode=train", f"--dataset_root={tree}", f"--logdir={logdir}",
                          "--model", "ucs", "--epochs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches["cli_train_ucs"] = counts()
    want = {k: TREE_TRAIN * LAUNCHES_PER_COSTREG_TRAIN_STEP[k]
            + TREE_TEST * LAUNCHES_PER_COSTREG_FORWARD[k] for k in LAUNCHES_PER_FORWARD}
    check(launches["cli_train_ucs"] == want, f"cli.train --model ucs: launches "
          f"{launches['cli_train_ucs']}")
    check(out["timing"]["steps"] == [TREE_TRAIN] and os.path.isfile(
        logdir / "ucs" / "rpc" / "1" / "state.pt"), f"cli.train --model ucs: {out['timing']}")
    print(f"[sweeps] cli.train --mode=train --model ucs, one epoch ({TREE_TRAIN} steps, "
          f"{TREE_TEST} test forward): {wall:.2f} s wall, "
          f"{1e3 * out['timing']['train_s'][0] / TREE_TRAIN:.1f} ms a step, launches "
          f"{({k: v for k, v in want.items() if v})} (exact) card={card}", flush=True)
    launches["per_view_forward"] = per_view_forward(card, None, LAUNCHES_PER_VIEW_FORWARD)
    launches["per_view_bf16_forward"] = per_view_forward(card, torch.bfloat16,
                                                         LAUNCHES_PER_VIEW_BF16_FORWARD)
    print(f"[sweeps] phase 11 took {time.time() - t0:.1f} s", flush=True)
    return launches


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
# CostRegNet one launch per 3-D block: conv3d_block 8 (seven ConvBlocks and
# the head) and deconv3d_block 3; no plane conv, no red_recur
COSTREG_FAMILIES = ("casmvs", "ucs")
COSTREG_HEAD_GAIN = 10.0         # the logit heads ×10: a window confidence spread over [0, 1]
COSTREG_PARITY_HW = (96, 192)    # GPU vs CPU at this patch (the CPU's 3-D convs are slow)
LAUNCHES_PER_COSTREG_FORWARD = {**{k: 0 for k in LAUNCHES_PER_FORWARD}, "sweep_variance": 3,
                                "conv3d_block": 24, "deconv3d_block": 9}
COSTREG_KERNELS = ("conv3d_block", "deconv3d_block")
COSTREG_PATHS = (*COSTREG_FAMILIES, "cli_predict_ucs")
COSTREG_BLOCK_TOL = 1e-4         # composed taps vs the plain block, × max(1, max |plain|)


def build_costreg_model(name: str, device, geo_model: str = "rpc", ndepths=NDEPTHS, **knobs):
    """CascadeMVSNet or UCSNet (ndepths 64/32/8 unless given, further
    `CascadeModel` knobs) from seed 0 at flax's
    LeCun scale, its norms and BatchNorm statistics drawn from seed 1
    (scale 1 ± 0.2, shift and mean ± 0.1, var in [0.5, 1.5]: the BN fold is
    far from the identity), the CostRegNet heads × COSTREG_HEAD_GAIN; drawn
    on the CPU, so every device gets the same weights."""
    from satmvs_tpu_torch.models import build_model
    from satmvs_tpu_torch.nn.blocks import BatchNorm

    model = lecun_scale(build_model(name, geo_model, ndepths=ndepths, device="cpu", seed=0,
                                    **knobs))
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


def block_work(op: str, n: int, h: int, w: int, ci: int, co: int,
               b: int = 1) -> tuple[float, float]:
    """Bytes (input, weights, bias and the transposed block's skip read once,
    the output written once) and flops (the taps inside the volume) of one
    3-D block of `costreg_blocks` at B = b: the stride-1 blocks (op
    conv_head) read (n, h, w) planes, the stride-2 ones (conv_dn) 2n planes
    of h × w, the transposed ones (deconv_up) write (2n, 2h, 2w)."""
    if op == "deconv_up":
        d_in, out, taps = n, 8 * n * h * w, (3 * n - 1) * (3 * h - 1) * (3 * w - 1)
    elif op == "conv_dn":
        d_in, out = 2 * n, n * (h // 2) * (w // 2)
        taps = conv_taps(2 * n, n, 2) * conv_taps(h, h // 2, 2) * conv_taps(w, w // 2, 2)
    else:
        d_in, out = n, n * h * w
        taps = conv_taps(n, n, 1) * conv_taps(h, h, 1) * conv_taps(w, w, 1)
    reads_skip = 2 if op == "deconv_up" else 1
    words = b * d_in * h * w * ci + 27 * ci * co + co + b * out * co * reads_skip
    return 4.0 * words, 2.0 * b * taps * ci * co


def composed_taps(op: str, x, w3, bias, skip=None):
    """A 3-D block as the packed CostRegNet composed it before the block
    kernels, phase 10's "was" figure: three per-depth-tap calls of the plane
    convs' CostRegNet forms (conv_head with a zero bias, conv_dn or
    deconv_up with relu off) on the B·D planes, the taps summed t0 + t1 +
    t2, then bias and ReLU (none without a bias: the head) and the skip as
    torch ops."""
    from satmvs_tpu_torch.ops.kernels import plane_conv as pc

    b = x.shape[0]

    def planes(t):
        return t.reshape(-1, *t.shape[2:]).contiguous()

    def per(t):
        return t.view(b, -1, *t.shape[1:])

    if op == "deconv_up":
        u0, even, odd = (per(pc.deconv_up(planes(x), w3[:, :, k], relu=False)) for k in range(3))
        odd[:, :-1] += u0[:, 1:]
        y = torch.stack([even, odd], dim=2).view(b, -1, *even.shape[2:])
    elif op == "conv_dn":
        even, odd = planes(x[:, 0::2]), planes(x[:, 1::2])
        t0, y, t2 = (per(pc.conv_dn(src, w3[:, :, k], relu=False))
                     for k, src in enumerate((odd, even, odd)))
        y[:, 1:] += t0[:, :-1]
        y += t2
    else:
        zb = w3.new_zeros(w3.shape[0])
        t0, y, t2 = (per(pc.conv_head(planes(x), w3[:, :, k], zb)) for k in range(3))
        y[:, 1:] += t0[:, :-1]
        y[:, :-1] += t2[:, 1:]
    if bias is not None:
        y = torch.relu(y + bias)
    return y if skip is None else y + skip


def phase_costreg_kernels(card: str) -> list[dict]:
    """Phase 10, kernels: conv3d_block and deconv3d_block at each of the 33
    3-D blocks of a 384×768 forward (`costreg_blocks`: seven ConvBlocks,
    three DeconvBlocks and the head per stage) against their plain versions
    (KERNEL_TOL), the same bits in a second run, a B = 2 call each
    element the bits of its B = 1 call; kernel ms (events), device ms
    (profiler), bound (bytes or operations at the 3×TF32 rate), plain ms and
    cuDNN's F.conv3d / F.conv_transpose3d on the BN-folded kernel (TF32 off).
    Beside each, the block composed of the plane convs' per-tap forms as
    the port ran it before these kernels, held to the plain block
    (COSTREG_BLOCK_TOL) and timed: the "was" figure."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.ops.kernels import conv3d_block as cb

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    src = "satmvs_tpu_torch/csrc/conv3d_block.cu"
    reps = {"conv3d_block": KernelReport("conv3d_block", src,
                                         "satmvs_tpu/ops/pallas/plane_conv.py:738,394", card),
            "deconv3d_block": KernelReport("deconv3d_block", src,
                                           "satmvs_tpu/ops/pallas/plane_conv.py:582", card)}
    extra = {k: {"device": 0.0, "library_device": 0.0, "composed": 0.0, "blocks": 0}
             for k in reps}
    for stage, block, op, n, h, w, ci, co in costreg_blocks(1):
        d_in = 2 * n if op == "conv_dn" else n  # a stride-2 block reads every plane
        x, x2 = randn(1, d_in, h, w, ci).abs(), randn(1, d_in, h, w, ci).abs()
        scale = (1.0 / (27 * ci)) ** 0.5
        bias = None if block == "Conv_0" else randn(co, scale=0.1)
        if op == "deconv_up":
            name, wt = "deconv3d_block", randn(ci, co, 3, 3, 3, scale=scale)
            skip, skip2 = randn(1, 2 * n, 2 * h, 2 * w, co), randn(1, 2 * n, 2 * h, 2 * w, co)
            kernel = lambda t=x, s=skip: cb.deconv3d_block(t, wt, bias, s)  # noqa: E731
            plain = lambda: cb.deconv3d_block_reference(x, wt, bias, skip)  # noqa: E731
            library = lambda: F.conv_transpose3d(  # noqa: E731
                x.permute(0, 4, 1, 2, 3), wt, bias, stride=2, padding=1, output_padding=1)
            composed = lambda: composed_taps(op, x, wt, bias, skip)  # noqa: E731
            both = lambda: kernel(torch.cat([x, x2]), torch.cat([skip, skip2]))  # noqa: E731
            other = lambda: kernel(x2, skip2)  # noqa: E731
        else:
            name, wt = "conv3d_block", randn(co, ci, 3, 3, 3, scale=scale)
            stride, relu = (2 if op == "conv_dn" else 1), bias is not None
            kernel = lambda t=x: cb.conv3d_block(t, wt, bias, stride, relu)  # noqa: E731
            plain = lambda: cb.conv3d_block_reference(x, wt, bias, stride, relu)  # noqa: E731
            library = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), wt, bias,  # noqa: E731
                                       stride=stride, padding=1)
            composed = lambda: composed_taps(op, x, wt, bias)  # noqa: E731
            both = lambda: kernel(torch.cat([x, x2]))  # noqa: E731
            other = lambda: kernel(x2)  # noqa: E731
        label = f"{stage} {block} {tuple(x.shape)}->{co}"
        rep, ex = reps[name], extra[name]
        with torch.no_grad():
            rep.case(label, kernel, plain, rel_tol, *block_work(op, n, h, w, ci, co), library,
                     rate=TF32X3_FLOPS_PER_S)
            one = kernel()
            same = torch.equal(kernel(), one)
            pair = both()
            b2 = torch.equal(pair[:1], one) and torch.equal(pair[1:], other())
            print(f"[costreg] {name} {label}: same bits in a second run: {same}; a B = 2 call "
                  f"each element the bits of its B = 1 call: {b2}", flush=True)
            check(same, f"{name} {label}: a second run differs")
            check(b2, f"{name} {label}: B = 2 differs from B = 1")
            k_dev = device_ms(kernel, "conv3d_block_kernel", 5)
            l_dev = device_ms(library, lambda key: True, 5)
            was, want = composed(), plain()
            err = (was - want).abs().max().item()
            tol = COSTREG_BLOCK_TOL * max(1.0, want.abs().max().item())
            check(was.shape == want.shape and err <= tol,
                  f"{stage} {block}: composed taps vs the plain block err {err} > {tol}")
            c_ms = time_ms(composed, reps=10)
        ex["device"] += k_dev
        ex["library_device"] += l_dev
        ex["composed"] += c_ms
        ex["blocks"] += 1
        print(f"[costreg] {name} {label}: device time {k_dev:.4f} ms, cuDNN's "
              f"{l_dev:.4f} ms; was (composed per-tap forms) {c_ms:.4f} ms, max abs err "
              f"{err:.3e} to the plain block (tol {tol:.3e}) card={card}", flush=True)
        del x, x2, one, pair, was, want
    for name, rep in reps.items():
        r, ex = rep.rec, extra[name]
        print(f"[costreg] {name} per forward ({ex['blocks']} launches): events {r['ms']:.4f} ms, "
              f"device time {ex['device']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({max(rep.by, key=rep.by.get)}; operations at {TF32X3_FLOPS_PER_S / 1e12:.0f} "
              f"TFLOP/s, 3×TF32); plain {r['plain_ms']:.4f} ms; cuDNN events "
              f"{r['library_ms']:.4f} ms, device time {ex['library_device']:.4f} ms; was "
              f"(the composed per-tap forms) {ex['composed']:.4f} ms card={card}", flush=True)
    return [rep.record() for rep in reps.values()]


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


# phase 12: the pinhole and QC-form RPC camera models.  Pinhole cameras are
# fitted (`geo.pinhole.fit_pinhole_from_rpc`) to the synthetic triplet's RPCs
# in the reference view's UTM zone and composed in the local frame as
# `MVSDataset` composes them; depths are camera z along the fitted reference
# camera's axis (~ −1e5 to −6e5 m: the fitted camera sits at orbit distance)
PIN_COORD_TOL = 0.05   # px, homo_sweep_coords vs float64: the fp32 chain's own ~0.03 px
QC_COORD_TOL = 0.01    # px, rpc_sweep_coords_qc vs float64: tests/test_geo.py's RPC gate
CAMERA_STEPS = 3
PIN_TREE_TRAIN, PIN_TREE_TEST = 2, 1
FUSE_DEPTH_TOL = 1e-4  # relative, pinhole fusion GPU vs CPU on pixels both keep
# the kernels each new path must launch (`run`'s final check)
CAMERA_FORWARD_PATHS = ("pinhole_forward", "qc_forward", "pinhole_streaming",
                        "cli_predict_pinhole", "cli_predict_qc")
CAMERA_TRAIN_PATHS = ("pinhole_step", "qc_step", "cli_train_pinhole", "cli_train_qc")
CAMERA_COSTREG_PATHS = ("pinhole_casmvs",)


def fitted_pinhole(rpcs, width: int, height: int):
    """Pinhole cameras fitted to each RPC of rpcs (view 0 the reference), all
    in the reference's UTM zone: (projs (V, 4, 4) float64 in the local frame
    (`geo.pinhole.local_proj_matrices`), the reference's E (4, 4) in the UTM
    frame, the UTM frame, [(K, median and max fit error px) per view])."""
    from satmvs_tpu_torch.geo import pinhole, rpc as rpclib
    from satmvs_tpu_torch.geo.tmerc import TransverseMercator

    tm = TransverseMercator.utm_for(float(rpcs[0][rpclib.LON_OFF]))
    ks, es, fits = [], [], []
    for rpc in rpcs:
        k, r, t, proj_err, _ = pinhole.fit_pinhole_from_rpc(rpc, width, height, tm=tm)
        e = np.eye(4)
        e[:3, :3], e[:3, 3] = r, t[:, 0]
        ks.append(k)
        es.append(e)
        fits.append((k, float(np.median(proj_err)), float(proj_err.max())))
    return pinhole.local_proj_matrices(np.stack(ks), np.stack(es)), es[0], tm, fits


def camera_z(rpc, e_ref, tm, xs, ys, heights) -> np.ndarray:
    """Camera z (float64, host) of the reference pixels (xs, ys) at heights:
    the inverse RPC to (lat, lon), UTM, then row 2 of the fitted E."""
    from satmvs_tpu_torch.geo import rpc as rpclib

    lat, lon = rpclib.photo_to_obj(rpc, xs, ys, heights)
    en = tm.proj(np.stack([lat, lon], axis=-1))
    return e_ref[2, 0] * en[:, 0] + e_ref[2, 1] * en[:, 1] + e_ref[2, 2] * heights + e_ref[2, 3]


def pinhole_batch(width: int, height: int, seed: int = 0, device="cuda",
                  with_gt: bool = True) -> tuple[dict, dict]:
    """`synthetic.make_batch`'s scene (B = 1) under pinhole cameras fitted to
    its RPCs: per-stage (1, V, 4, 4) float32 projection matrices, the depth
    range the camera z of the reference pixel grid at the scene's lowest and
    highest heights, the ground truth the camera z of its heights.  Returns
    (batch, {"fits": [(K, median px, max px)], "rpcs": (V, 170)})."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.data.preprocess import build_pyramid
    from satmvs_tpu_torch.geo import pinhole

    scene = synthetic.make_scene(width, height, seed=seed, h_amp=80.0)
    order = [2, 0, 1]  # the nadir view is the reference, as in make_batch
    rpcs = scene["rpcs"][order]
    projs, e_ref, tm, fits = fitted_pinhole(rpcs, width, height)
    xs, ys = (g.ravel() for g in np.meshgrid(np.arange(width, dtype=np.float64),
                                             np.arange(height, dtype=np.float64)))
    z = np.concatenate([camera_z(rpcs[0], e_ref, tm, xs, ys, np.full(xs.size, h))
                        for h in scene["h_range"]])
    imgs = scene["images"][order]
    imgs = (imgs - imgs.mean(axis=(1, 2), keepdims=True)) / (
        imgs.std(axis=(1, 2), keepdims=True) + 1e-8)
    batch = {
        "imgs": torch.as_tensor(np.repeat(imgs[None, ..., None], 3, axis=-1).astype(np.float32),
                                device=device),
        "cams": tuple(torch.as_tensor(pinhole.scale_proj_matrix(projs, s)[None],
                                      dtype=torch.float32, device=device)
                      for s in (0.25, 0.5, 1.0)),
        "depth_values": torch.tensor([[z.min(), z.max()]], dtype=torch.float32, device=device),
    }
    if with_gt:
        gt = camera_z(rpcs[0], e_ref, tm, xs, ys,
                      scene["gt_heights"][2].astype(np.float64).ravel())
        pyr = build_pyramid(gt.reshape(height, width).astype(np.float32), 3)
        batch["depth_stages"] = [torch.as_tensor(p[None], device=device) for p in pyr]
        batch["mask_stages"] = [torch.ones_like(d) for d in batch["depth_stages"]]
    return batch, {"fits": fits, "rpcs": rpcs}


def write_pinhole_tree(root: str, num_train: int = 2, num_test: int = 1, width: int = 64,
                       height: int = 64, seed: int = 0) -> str:
    """A pinhole WHU-TLC tree <root>/open_dataset_pinhole/{train,test}/
    {image,camera,depth}/{0,1,2}/blockNNNN.* written with the port's
    `formats.save_camera`, `formats.save_pfm` and PNG writer.  The camera
    text holds one focal length and no skew, so the cameras are
    K·[I | (tx, 0, 0)] with f = 1.5625·width, the principal point at the
    centre and baselines tx of 0, 2 and −2 m; each block is a tilted plane
    at depths ~37-57 m (camera files: 30 to 60 m) with a smooth texture
    drawn from its seed, each view's depth and image exact for its camera.
    Returns root."""
    import os

    from satmvs_tpu_torch.data import formats, png

    f = 1.5625 * width
    k = np.array([[f, 0.0, width / 2], [0.0, f, height / 2], [0.0, 0.0, 1.0]])
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    u, v = (xs - width / 2) / f, (ys - height / 2) / f
    for split, n, s0 in (("train", num_train, 0), ("test", num_test, 1000)):
        base = os.path.join(root, "open_dataset_pinhole", split)
        for kind in ("image", "camera", "depth"):
            for view in range(3):
                os.makedirs(os.path.join(base, kind, str(view)), exist_ok=True)
        for b in range(n):
            rng = np.random.default_rng(seed + s0 + b)
            z0, a, c = 45.0 + rng.uniform(-2, 2), rng.uniform(-0.5, 0.5), rng.uniform(-0.25, 0.25)
            freq = rng.uniform(0.2, 1.2, (8, 2)) * rng.choice([-1, 1], (8, 2))
            phase = rng.uniform(0, 2 * np.pi, 8)
            name = f"block{b:04d}"
            for view, tx in enumerate((0.0, 2.0, -2.0)):
                # the plane z = z0 + a·X + c·Y in world X, Y; camera X = world X + tx
                z = (z0 - a * tx) / (1.0 - a * u - c * v)
                wx, wy = u * z - tx, v * z
                tex = np.sin(wx[..., None] * freq[:, 0] + wy[..., None] * freq[:, 1] + phase)
                img = 127.5 + 127.5 * tex.mean(-1) / np.abs(tex.mean(-1)).max()
                png.write_png(os.path.join(base, "image", str(view), name + ".png"),
                              np.clip(np.round(img), 0, 255).astype(np.uint8))
                formats.save_camera(os.path.join(base, "camera", str(view), name + ".txt"), k,
                                    np.eye(3), np.array([tx, 0.0, 0.0]), 30.0, 60.0, 30.0 / 63,
                                    view, width, height)
                formats.save_pfm(os.path.join(base, "depth", str(view), name + ".pfm"),
                                 z.astype(np.float32))
    return root


def uniform_hyps(lo: float, hi: float, nd: int, h: int, w: int, device) -> torch.Tensor:
    """nd planes evenly over [lo, hi], (nd, h, w) float32."""
    planes = torch.linspace(lo, hi, nd, dtype=torch.float64).to(torch.float32)
    return planes.reshape(nd, 1, 1).expand(nd, h, w).contiguous().to(device)


def pinhole_oracle(src_proj, ref_proj, hyps) -> tuple[np.ndarray, np.ndarray]:
    """homo_sweep_coords in float64 numpy on the same float32 inputs."""
    rel = np.asarray(src_proj, np.float64) @ np.linalg.inv(np.asarray(ref_proj, np.float64))
    d = np.asarray(hyps, np.float64)
    _, h, w = d.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    p = [(rel[c, 0] * xs + rel[c, 1] * ys + rel[c, 2]) * d + rel[c, 3] for c in range(3)]
    return p[0] / p[2], p[1] / p[2]


def rpc_oracle(ref_rpc, src_rpc, scale: float, hyps) -> tuple[np.ndarray, np.ndarray]:
    """The RPC sweep in float64 on the host: the reference's inverse RPC,
    the source's direct one, both at the stage's image scale."""
    from satmvs_tpu_torch.geo import rpc as rpclib

    d = np.asarray(hyps, np.float64)
    _, h, w = d.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xs, ys = np.broadcast_to(xs, d.shape).ravel(), np.broadcast_to(ys, d.shape).ravel()
    ref, src = rpclib.scale_rpc(ref_rpc, scale), rpclib.scale_rpc(src_rpc, scale)
    lat, lon = rpclib.photo_to_obj(ref, xs, ys, d.ravel())
    x_s, y_s = rpclib.obj_to_photo(src, lat, lon, d.ravel())
    return x_s.reshape(d.shape), y_s.reshape(d.shape)


def phase_camera_coords(card: str, pin: dict, pin_info: dict, qc: dict, rpc: dict) -> None:
    """Phase 12 (a): `homo_sweep_coords` (the fitted pinhole cameras) and
    `rpc_sweep_coords_qc` at the forward's three stage shapes, each source
    view, uniform planes over the sweep's range: on the card against a
    float64 oracle (PIN_COORD_TOL, QC_COORD_TOL) and against the same
    function on the CPU (the same tolerances); each geometry's ms a forward
    (3 stages × 2 source views) beside `rpc_sweep_coords`'s."""
    from satmvs_tpu_torch.ops import warp

    for k, (mk, med, mx) in enumerate(pin_info["fits"]):
        print(f"[cameras] pinhole fit of view {k} ({WIDTH}x{HEIGHT}): reprojection error median "
              f"{med:.3f} px, max {mx:.3f} px; fx {mk[0, 0]:.5g}, fy {mk[1, 1]:.5g}, skew "
              f"{mk[0, 1]:.5g}; projection condition "
              f"{np.linalg.cond(pin['cams'][2][0, k].double().cpu().numpy()):.3e}", flush=True)
    jobs = {}
    for i, (sc, nd) in enumerate(zip(STAGE_SCALES, NDEPTHS)):
        h, w = HEIGHT // sc, WIDTH // sc
        p_lo, p_hi = pin["depth_values"][0].tolist()
        r_lo, r_hi = rpc["depth_values"][0].tolist()
        p_hyp = uniform_hyps(p_lo, p_hi, nd, h, w, "cuda")
        r_hyp = uniform_hyps(r_lo, r_hi, nd, h, w, "cuda")
        pin_cams, qc_cams, rpc_cams = pin["cams"][i][0], qc["cams"][i][0], rpc["cams"][i][0]
        for s in range(2):
            jobs[("pinhole", i, s)] = (lambda c=pin_cams, s=s, hy=p_hyp, h=h, w=w:
                                       warp.sweep_coords(c, s, hy, h, w))
            jobs[("qc", i, s)] = (lambda c=qc_cams, s=s, hy=r_hyp, h=h, w=w:
                                  warp.sweep_coords(c, s, hy, h, w))
            jobs[("rpc", i, s)] = (lambda c=rpc_cams, s=s, hy=r_hyp, h=h, w=w:
                                   warp.sweep_coords(c, s, hy, h, w))
            for geo, tol in (("pinhole", PIN_COORD_TOL), ("qc", QC_COORD_TOL)):
                cams, hyp = (pin_cams, p_hyp) if geo == "pinhole" else (qc_cams, r_hyp)
                gx, gy = jobs[(geo, i, s)]()
                cx, cy = warp.sweep_coords(cams.to("cpu"), s, hyp.cpu(), h, w)
                if geo == "pinhole":
                    ox, oy = pinhole_oracle(cams[s + 1].cpu(), cams[0].cpu(), hyp.cpu())
                else:
                    rpcs = pin_info["rpcs"]
                    ox, oy = rpc_oracle(rpcs[0], rpcs[s + 1], 1.0 / sc, hyp.cpu())
                gx, gy, cx, cy = (t.cpu().double().numpy() for t in (gx, gy, cx, cy))
                oracle = max(np.abs(gx - ox).max(), np.abs(gy - oy).max())
                cpu = max(np.abs(gx - cx).max(), np.abs(gy - cy).max())
                cpu_oracle = max(np.abs(cx - ox).max(), np.abs(cy - oy).max())
                print(f"[cameras] {geo} coordinates stage{i + 1} ({nd}, {h}, {w}) source {s}: "
                      f"card vs float64 {oracle:.3e} px (CPU vs float64 {cpu_oracle:.3e}), card "
                      f"vs CPU {cpu:.3e} px (tol {tol})", flush=True)
                check(oracle <= tol and cpu <= tol,
                      f"{geo} coordinates stage{i + 1} source {s}: {oracle} / {cpu} px")
    for geo in ("pinhole", "qc", "rpc"):
        fns = [fn for key, fn in jobs.items() if key[0] == geo]
        ms = time_ms(lambda: [fn() for fn in fns], reps=10, warmup=2)
        print(f"[cameras] {geo} sweep coordinates of a {HEIGHT}x{WIDTH} forward (3 stages x 2 "
              f"source views): {ms:.3f} ms (median of 10, CUDA events) card={card}", flush=True)


def camera_forward(card: str, what: str, model, batch, want: dict, tag: str = "[cameras]",
                   profile: bool = True) -> tuple:
    """A forward with exact launches `want`, finite depth inside the sweep's
    range (stage 1's, widened by the later windows), confidence in [0, 1];
    then its ms (CUDA events), peak memory and (profile) a profile; lines
    under `tag`.  Returns (output, launches)."""
    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    torch.cuda.synchronize()
    reset_counts()
    out = model(imgs, cams, dvals)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == want, f"{what} forward launches {launches}")
    lo, hi = dvals[0].tolist()
    margin = 0.0
    for i, (scale, nd) in enumerate(zip(STAGE_SCALES, model.ndepths), start=1):
        if i > 1 and model.sampler == "window":
            margin += nd / 2 * model.stage_intervals()[i - 1]
        depth, conf = out[f"stage{i}"]["depth"], out[f"stage{i}"]["photometric_confidence"]
        h, w = imgs.shape[2] // scale, imgs.shape[3] // scale
        check(tuple(depth.shape) == (1, h, w) and bool(torch.isfinite(depth).all()),
              f"{what} stage{i}: depth shape {tuple(depth.shape)} or non-finite")
        dmin, dmax = depth.min().item(), depth.max().item()
        slack = 1e-3 + 4 * max(abs(lo), abs(hi)) * 2.0 ** -23  # a few fp32 ulps of the depth
        check(lo - margin - slack <= dmin and dmax <= hi + margin + slack,
              f"{what} stage{i}: depth [{dmin}, {dmax}] outside [{lo - margin}, {hi + margin}]")
        check(0.0 <= conf.min().item() and conf.max().item() <= 1.0 + 1e-6,
              f"{what} stage{i}: confidence")
        print(f"{tag} {what} stage{i} depth [{dmin:.2f}, {dmax:.2f}] m (range {lo:.2f}.."
              f"{hi:.2f} ± {margin:g}), conf [{conf.min().item():.4f}, "
              f"{conf.max().item():.4f}]", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: model(imgs, cams, dvals), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} {what} forward at {imgs.shape[2]}x{imgs.shape[3]}: launches "
          f"{({k: v for k, v in launches.items() if v})} (exact), forward_ms={ms:.2f} (median "
          f"of 5, CUDA events, B=1, 3 views) peak_mem={peak:.2f} GiB card={card}", flush=True)
    if profile:
        profile_forward(lambda: model(imgs, cams, dvals), card, what=f"one {what} forward")
    return out, launches


def stagewise_against(what: str, model, ref_out: dict, imgs, cams, dvals,
                      tag: str = "[cameras]"):
    """`model`'s stages on `cams` against ref_out (the same model on other
    cameras of the same views, or with other knobs), each stage centred on
    ref_out's previous depth: the mean ≤ DEPTH_TOL_MEAN and the p99 ≤
    DEPTH_TOL_P99 of the stage's hypothesis step; the max |Δ| in metres
    beside it."""
    feats = model.features(imgs)
    d_min, d_max = dvals[:, 0], dvals[:, -1]
    for i, step in enumerate(stage_steps(*dvals[0].tolist(), model.stage_intervals())):
        prev = None if i == 0 else ref_out[f"stage{i}"]["depth"]
        got = model.stage(i, feats[i], cams[i], d_min, d_max, prev)["depth"]
        diff = (got - ref_out[f"stage{i + 1}"]["depth"]).abs()
        mean, p99, mx = err_quantiles(diff / step)
        print(f"{tag} {what} stage{i + 1} (step {step:.3f} m), same window centres: depth "
              f"err mean {mean:.3e}, p99 {p99:.3e}, max {mx:.3e} of step (tol mean "
              f"{DEPTH_TOL_MEAN}, p99 {DEPTH_TOL_P99}); max |dh| {diff.max().item():.4f} m",
              flush=True)
        check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
              f"{what} stage{i + 1}: depth err mean {mean}, p99 {p99} of step")


def camera_steps(card: str, what: str, cfg, batch, default_step: dict) -> dict:
    """CAMERA_STEPS train steps (`run_train_steps`: exact launches a step,
    finite losses) beside phase 7's default step.  Returns the launches."""
    *_, launches, times, losses, peak = run_train_steps(
        cfg, batch, CAMERA_STEPS, LAUNCHES_PER_TRAIN_STEP, what, card)
    ms = float(np.median(times))
    print(f"[cameras] {what} train step {ms:.2f} ms (median of {CAMERA_STEPS}), peak_mem="
          f"{peak:.2f} GiB; phase 7's default step {default_step['ms']:.2f} ms, "
          f"{default_step['peak']:.2f} GiB ({ms / default_step['ms']:.3f}x) card={card}",
          flush=True)
    return launches


def cli_against_direct(what: str, folder: str, geo_model: str, use_qc: bool, ckpt: str,
                       slab: int | None = None, **fields) -> None:
    """The maps a predict run wrote under folder/mvs_results against a direct
    forward of the restored model (Config(geo_model, use_qc, **fields); with
    `slab` its streaming forward) on the same pred-mode batches (cuDNN's
    deterministic engines, as the CLI runs): the same bits."""
    from satmvs_tpu_torch.infer.predict import streaming_red_forward

    import os

    from satmvs_tpu_torch.cli import restore_model
    from satmvs_tpu_torch.data import formats
    from satmvs_tpu_torch.data.dataset import MVSDataset
    from satmvs_tpu_torch.data.loader import Loader
    from satmvs_tpu_torch.train import Config

    torch.backends.cudnn.deterministic = True
    model, _, _ = restore_model(Config(geo_model=geo_model, use_qc=use_qc, **fields), ckpt,
                                torch.device("cuda"))
    n = 0
    ds = MVSDataset(folder, "pred", geo_model=geo_model, use_qc=use_qc)
    forward = model if slab is None else (
        lambda *a: streaming_red_forward(model, *a, slab=slab))
    for batch in Loader(ds, 1, device="cuda"):
        want = forward(batch["imgs"], batch["cams"], batch["depth_values"])
        view, name = batch["out_view"][0], batch["out_name"][0]
        for sub, key in (("init", "depth"), ("prob", "photometric_confidence")):
            got = formats.load_pfm(os.path.join(folder, "mvs_results", view, sub, f"{name}.pfm"))
            check(np.array_equal(got, want[key][0].cpu().numpy()),
                  f"{what} view {view} {name} {sub}: not the bits of a direct forward")
            n += 1
    torch.backends.cudnn.deterministic = False
    print(f"[checks] {what}: {n} maps the bits of a direct forward", flush=True)


def camera_cli(card: str, rpc_tree: str) -> dict:
    """Phase 12 (d): a pinhole tree of 3-view HEIGHT × WIDTH blocks
    (`write_pinhole_tree`) through `cli.train --geo_model pinhole` (one
    epoch and its test pass) and `cli.predict --geo_model pinhole`, its maps
    the bits of a direct forward; `filter_depth_pinhole` on the predicted
    maps and on the tree's exact depth maps, card against CPU; then
    `cli.train --use_qc` (one epoch) and `cli.predict --use_qc` on phase 9's
    RPC tree.  Exact launches for every run.  Returns them."""
    import os
    import shutil

    from satmvs_tpu_torch.cli import predict as cli_predict
    from satmvs_tpu_torch.cli import train as cli_train
    from satmvs_tpu_torch.data import formats
    from satmvs_tpu_torch.data.dataset import MVSDataset
    from satmvs_tpu_torch.infer.fuse import filter_depth_pinhole

    launches = {}

    def run(what: str, fn, argv, want: dict):
        reset_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        check(got == want, f"{what}: launches {got}, want {want}")
        print(f"[cameras] {what}: {wall:.2f} s wall, launches "
              f"{({k: v for k, v in got.items() if v})} (exact) card={card}", flush=True)
        return out, got

    t0 = time.time()
    root = str(WORK / "pinhole_tree")
    write_pinhole_tree(root, PIN_TREE_TRAIN, PIN_TREE_TEST, WIDTH, HEIGHT, seed=0)
    print(f"[cameras] pinhole tree of {PIN_TREE_TRAIN} + {PIN_TREE_TEST} blocks of 3 "
          f"{HEIGHT}x{WIDTH} views written in {time.time() - t0:.1f} s", flush=True)
    logdir = str(WORK / "logs_cameras")
    workdir = os.path.join(logdir, "red", "pinhole")
    out, launches["cli_train_pinhole"] = run(
        "cli.train --geo_model pinhole, one epoch", cli_train.main,
        ["--mode=train", f"--dataset_root={root}", f"--logdir={logdir}", "--geo_model",
         "pinhole", "--epochs", "1"], launches_of(PIN_TREE_TRAIN, PIN_TREE_TEST))
    check(out["timing"]["steps"] == [PIN_TREE_TRAIN]
          and os.path.isfile(os.path.join(workdir, "1", "state.pt")), f"pinhole train {out}")
    testpath = os.path.join(root, "open_dataset_pinhole", "test")
    _, launches["cli_predict_pinhole"] = run(
        "cli.predict --geo_model pinhole --fuse", cli_predict.main,
        [f"--dataset_root={testpath}", f"--loadckpt={workdir}", "--geo_model", "pinhole",
         "--fuse"], launches_of(0, 3 * PIN_TREE_TEST))
    cli_against_direct("cli.predict --geo_model pinhole", testpath, "pinhole", False, workdir)

    # fusion on the card against the CPU: the predicted maps (loose thresholds, so
    # that a share of a random model's pixels pass) and the exact depth maps
    ref = MVSDataset(testpath, "pred", geo_model="pinhole")[0]  # views 0, 1, 2
    projs = ref["cams"][-1].double().numpy()
    for what, sub, thresholds in (
            ("predicted maps", ("mvs_results", "{v}", "init"), (4.0, 0.05)),
            ("exact depth maps", ("depth", "{v}"), (1.0, 0.01))):
        depths = np.stack([formats.load_pfm(os.path.join(
            testpath, *(p.format(v=v) for p in sub), "block0000.pfm")) for v in "012"])
        runs = {}
        for dev in ("cuda", "cpu"):
            t1 = time.perf_counter()
            mask, fused = filter_depth_pinhole(depths, projs, *thresholds, device=dev)
            runs[dev] = (time.perf_counter() - t1, mask, fused)
        (t_g, m_g, f_g), (t_c, m_c, f_c) = runs["cuda"], runs["cpu"]
        both = m_g & m_c
        rel = float((np.abs(f_g - f_c) / np.abs(f_c))[both].max()) if both.any() else 0.0
        print(f"[cameras] pinhole fusion of the {what} (p_thre {thresholds[0]}, rel_d_thre "
              f"{thresholds[1]}): valid {m_g.mean():.4f} on the card, {m_c.mean():.4f} on the "
              f"CPU (tol {FUSE_VALID_TOL}); fused depth max relative difference {rel:.3e} on "
              f"{int(both.sum())} pixels both keep (tol {FUSE_DEPTH_TOL}); wall "
              f"{1e3 * t_g:.1f} ms card, {1e3 * t_c:.1f} ms CPU card={card}", flush=True)
        check(abs(m_g.mean() - m_c.mean()) <= FUSE_VALID_TOL and rel <= FUSE_DEPTH_TOL
              and both.any(), f"pinhole fusion of the {what}")

    qc_logdir = str(WORK / "logs_qc")
    out, launches["cli_train_qc"] = run(
        "cli.train --use_qc, one epoch", cli_train.main,
        ["--mode=train", f"--dataset_root={rpc_tree}", f"--logdir={qc_logdir}", "--use_qc",
         "--epochs", "1"], launches_of(TREE_TRAIN, TREE_TEST))
    check(out["timing"]["steps"] == [TREE_TRAIN], f"QC train {out['timing']}")
    copy = WORK / "test_qc"
    shutil.copytree(os.path.join(rpc_tree, "open_dataset_rpc", "test"), copy,
                    ignore=shutil.ignore_patterns("mvs_results", "height_result"))
    qc_ckpt = os.path.join(qc_logdir, "red", "rpc")
    _, launches["cli_predict_qc"] = run(
        "cli.predict --use_qc", cli_predict.main,
        [f"--dataset_root={copy}", f"--loadckpt={qc_ckpt}", "--use_qc"],
        launches_of(0, 3 * TREE_TEST))
    cli_against_direct("cli.predict --use_qc", str(copy), "rpc", True, qc_ckpt)
    return launches


def phase_cameras(card: str, rpc_tree: str, default_step: dict) -> dict:
    """Phase 12: the pinhole and QC-form RPC camera models on the main
    paths.  (a) coordinates (`phase_camera_coords`); (b) CascadeREDNet
    forwards at HEIGHT × WIDTH (heads ×40) on fitted pinhole cameras and on
    QC bundles of the same triplet, each with exact launches, ranges, ms,
    peak memory, a profile and its plain run on the CPU at PARITY_SIZE stage
    by stage; the QC forward against the basis-form forward at full size
    (seeded weights without the ×40); a pinhole CascadeMVSNet forward at
    PARITY_SIZE against its CPU run; a pinhole streaming forward (slab 8)
    against the pinhole full-volume forward; (c) CAMERA_STEPS train steps
    each with Config(geo_model="pinhole") and Config(use_qc=True) on the
    default per-view sweep and one step at PARITY_SIZE against the CPU
    (the pinhole step under PINHOLE_PARITY);
    (d) `camera_cli`.  Returns each path's launches."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models import CascadeREDNet
    from satmvs_tpu_torch.train import Config

    t0 = time.time()
    pin, pin_info = pinhole_batch(WIDTH, HEIGHT, seed=0)
    qc = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda", use_qc=True)
    rpc = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    check(torch.equal(pin["imgs"], qc["imgs"]), "the pinhole and QC batches' images differ")
    phase_camera_coords(card, pin, pin_info, qc, rpc)
    launches = {}

    model = build_model("cuda", "pinhole")
    ph, pw = PARITY_SIZE
    out, launches["pinhole_forward"] = camera_forward(card, "pinhole", model, pin,
                                                      LAUNCHES_PER_FORWARD)
    small, _ = pinhole_batch(pw, ph, seed=1, with_gt=False)
    gpu_vs_cpu("[cameras]", f"pinhole at {ph}x{pw}", model(small["imgs"], small["cams"],
                                                           small["depth_values"]),
               build_model("cpu", "pinhole"), small["imgs"], small["cams"], small["depth_values"])
    reset_counts()
    launches["pinhole_streaming"] = phase_stream_vs_full(
        card, model, (pin["imgs"], pin["cams"], pin["depth_values"]), what="pinhole")
    del out, model

    model = build_model("cuda")
    _, launches["qc_forward"] = camera_forward(card, "QC", model, qc, LAUNCHES_PER_FORWARD)
    small = synthetic.make_batch(1, pw, ph, seed=1, device="cuda", use_qc=True)
    gpu_vs_cpu("[cameras]", f"QC at {ph}x{pw}", model(small["imgs"], small["cams"],
                                                      small["depth_values"]),
               build_model("cpu"), small["imgs"], small["cams"], small["depth_values"])
    del model
    plain = CascadeREDNet(ndepths=NDEPTHS, device="cuda", seed=0)
    basis = plain(rpc["imgs"], rpc["cams"], rpc["depth_values"])
    free = plain(qc["imgs"], qc["cams"], qc["depth_values"])
    gaps = [(free[f"stage{i}"]["depth"] - basis[f"stage{i}"]["depth"]).abs().max().item()
            for i in (1, 2, 3)]
    print(f"[cameras] QC vs basis-form forward at {HEIGHT}x{WIDTH} (seeded weights, heads x1), "
          f"free-running: max |dh| per stage {[round(g, 4) for g in gaps]} m", flush=True)
    stagewise_against("QC vs basis-form forward", plain, basis, qc["imgs"], qc["cams"],
                      qc["depth_values"])
    del plain, basis, free

    casmvs = build_costreg_model("casmvs", "cuda", "pinhole")
    small, _ = pinhole_batch(pw, ph, seed=1, with_gt=False)
    reset_counts()
    gpu_out = casmvs(small["imgs"], small["cams"], small["depth_values"])
    torch.cuda.synchronize()
    launches["pinhole_casmvs"] = counts()
    check(launches["pinhole_casmvs"] == LAUNCHES_PER_COSTREG_FORWARD,
          f"pinhole casmvs launches {launches['pinhole_casmvs']}")
    print(f"[cameras] pinhole CascadeMVSNet forward at {ph}x{pw}: launches "
          f"{({k: v for k, v in launches['pinhole_casmvs'].items() if v})} (exact)", flush=True)
    gpu_vs_cpu("[cameras]", f"pinhole casmvs at {ph}x{pw}", gpu_out,
               build_costreg_model("casmvs", "cpu", "pinhole"), small["imgs"], small["cams"],
               small["depth_values"])
    del casmvs, gpu_out

    pin_cfg = Config(ndepths=NDEPTHS, geo_model="pinhole")
    launches["pinhole_step"] = camera_steps(card, "pinhole", pin_cfg, pin, default_step)
    phase_train_parity(card, "pinhole step", gates=PINHOLE_PARITY, geo_model="pinhole",
                       make_batch=lambda w, h: pinhole_batch(w, h, seed=1, device="cpu")[0])
    qc_train = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda", use_qc=True)
    launches["qc_step"] = camera_steps(card, "QC", Config(ndepths=NDEPTHS, use_qc=True),
                                       qc_train, default_step)
    phase_train_parity(card, "QC step", use_qc=True)
    del pin, qc, rpc, qc_train

    launches.update(camera_cli(card, rpc_tree))
    print(f"[cameras] phase 12 took {time.time() - t0:.1f} s", flush=True)
    return launches


# phase 13: more than one GPU on the one card.  NCCL refuses two ranks on
# one device, so (a) runs one NCCL rank in this process, and (b) and (c) two
# ranks in spawned processes that share cuda:0 over gloo (its CUDA support
# covers the all_reduce and broadcast the data axis uses on CUDA tensors).
DP_RANKS, DP_STEPS = 2, 3
# each step's loss and abs_depth_error against the serial B = 2 step, by
# step: JAX's two-process gate (tests/test_multihost.py) for the first two;
# the third's is fixed from dp_spread.py's six runs of this batch (seed 0)
# on the card, about twice the largest reading (PERF.md, PR 15): the ranks
# 4.968e-04 and the serial step on the batch with its samples swapped
# 4.900e-04, where steps 1 and 2 read at most 1.1e-7 and 3.7e-5.  The ranks
# sum the batch in another order than the serial step, and sweep_scatter's
# float atomics and cuDNN's default engines round otherwise run to run;
# RMSprop's first update, ~lr·√10·sign(g), turns rounding of the gradient
# elements near 0 into whole steps, so the third step moves as far when
# only the batch's order changes as between the ranks and the serial step
DP_LOSS_TOL = (2e-4, 2e-4, 1e-3)
# (a): the one rank's update against the serial step's (relative norm over
# all parameters) where two serial steps are not the same bits either
# (sweep_scatter's atomics): dp_spread.py read two serial steps 1.05e-5 to
# 3.61e-5 apart in eight runs
DP1_UPDATE_TOL = 1e-3
DP_GRAD_ATOL, DP_GRAD_RTOL = 5e-4, 5e-3  # × max |g|; JAX's sharded gradients (tests/test_dist.py)
DP_WORK = WORK / "dp"
DP_PATHS = ("dp1_train_step", "dp_train_step")  # phase 13's train paths; "dp_scene" infers


def state_copy(state) -> dict:
    return {"params": {k: v.detach().cpu().clone() for k, v in state.params.items()},
            "stats": {k: v.cpu().clone() for k, v in state.batch_stats.items()}}


def same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(a[g][k], b[g][k]) for g in ("params", "stats") for k in a[g])


def update_spread(a: dict, b: dict, old: dict) -> float:
    """Relative norm of the difference of two updates (new − old), over all
    parameters."""
    num = den = 0.0
    for k, p in a["params"].items():
        num += (p - b["params"][k]).norm().item() ** 2
        den += (b["params"][k] - old[k]).norm().item() ** 2
    return (num / den) ** 0.5


def dp_step(cfg, batch, mesh=None) -> dict:
    """One train step from fresh weights (cfg's seed) on `batch` (serial,
    or this rank's share under `mesh`): its scalars, launches, the weights
    before it ("old") and the parameters and running statistics after it."""
    from satmvs_tpu_torch.dist import shard_batch
    from satmvs_tpu_torch.train import create_model_and_state, make_train_step

    model, state, tx = create_model_and_state(cfg, batch, 1)
    old = {k: v.detach().cpu().clone() for k, v in state.params.items()}
    step = make_train_step(model, tx, cfg.dlossw, mesh)
    reset_counts()
    state, scalars = step(state, batch if mesh is None else shard_batch(batch, mesh))
    torch.cuda.synchronize()
    return {"scalars": {k: v.item() for k, v in scalars.items()}, "launches": counts(),
            "old": old, **state_copy(state)}


def dp_one_rank(card: str, tree: str) -> dict:
    """Phase 13 (a): a process group of one NCCL rank on the card
    (`init_multihost` under torchrun's environment, WORLD_SIZE=1): a
    384×768 CascadeREDNet train step (B = 1, the fused RED pipeline) through
    the data-parallel path (`make_mesh(data=1)`) against two serial steps
    from the same weights and batch, all on cuDNN's deterministic engines;
    then `cli.train --mesh_data 1` for an epoch of phase 9's tree under
    `python -m torch.distributed.run`.  Returns the data-parallel step's
    launches."""
    import os
    import socket

    import torch.distributed as dist

    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.dist import init_multihost, make_mesh
    from satmvs_tpu_torch.train import Config

    t0 = time.time()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(env)
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        check(init_multihost() == 1 and dist.get_backend() == "nccl",
              "init_multihost under WORLD_SIZE=1: one NCCL rank")
        mesh = make_mesh(data=1)
        batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
        cfg = Config(ndepths=NDEPTHS)
        for what, m in (("serial", None), ("serial again", None), ("data-parallel", mesh)):
            runs[what] = dp_step(cfg, batch, m)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
        torch.backends.cudnn.deterministic = False
    serial, again, dp = runs["serial"], runs["serial again"], runs["data-parallel"]
    check(dp["launches"] == LAUNCHES_PER_TRAIN_STEP, f"one NCCL rank: launches {dp['launches']}")
    check(dp["scalars"] == serial["scalars"] == again["scalars"],
          f"one NCCL rank: scalars {dp['scalars']} against the serial {serial['scalars']}")
    check(all(torch.equal(dp["stats"][k], v) for k, v in serial["stats"].items()),
          "one NCCL rank: the running statistics differ from the serial step's bits")
    repeat, bits = same_bits(serial, again), same_bits(serial, dp)
    old = serial["old"]
    spread, dp_spread = update_spread(again, serial, old), update_spread(dp, serial, old)
    print(f"[multi] (a) one NCCL rank, 384x768 train step on cuDNN's deterministic engines: "
          f"scalars and running statistics the serial step's bits; parameters the serial step's "
          f"bits: {bits} (a second serial step: {repeat}); update relative norm data-parallel "
          f"vs serial {dp_spread:.3e} (tol {DP1_UPDATE_TOL} unless a second serial step is the "
          f"same bits), serial vs serial {spread:.3e}; launches "
          f"{({k: v for k, v in dp['launches'].items() if v})} (exact) card={card}", flush=True)
    if repeat:
        check(bits, "one NCCL rank: the parameters differ from the serial step's bits")
    else:  # sweep_scatter sums with float atomics: the serial step is not repeatable either
        check(dp_spread <= DP1_UPDATE_TOL, f"one NCCL rank: update spread {dp_spread} "
              f"(tol {DP1_UPDATE_TOL})")
    logdir = WORK / "dp_logs"
    t1 = time.time()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "satmvs_tpu_torch.cli.train", "--mode=train", f"--dataset_root={tree}",
           f"--logdir={logdir}", "--epochs", "1", "--mesh_data", "1"]
    out = subprocess.run(cmd, cwd=str(Path(__file__).resolve().parent), capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, f"torchrun cli.train: exit {out.returncode}\n{out.stdout[-3000:]}"
          f"\n{out.stderr[-3000:]}")
    check((logdir / "red" / "rpc" / "1" / "state.pt").is_file(), "torchrun cli.train: no checkpoint")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("epoch 1 test:")]
    check(len(lines) == 1, f"torchrun cli.train: {out.stdout[-2000:]}")
    print(f"[multi] (a) python -m torch.distributed.run --nproc_per_node 1 -m "
          f"satmvs_tpu_torch.cli.train --mesh_data 1, one epoch of phase 9's tree: exit 0 in "
          f"{time.time() - t1:.1f} s, {lines[0][:160]!r}; (a) took {time.time() - t0:.1f} s",
          flush=True)
    return dp["launches"]


def dp_rank(rank: int, init: str, go, scene: bool = True) -> None:
    """Phase 13 (b) and (c) on one of DP_RANKS ranks that share cuda:0 over
    gloo (a spawned process; phase 1 has built the kernels): DP_STEPS
    data-parallel train steps of the global batch in DP_WORK/batch.pt
    (each rank its sample), after the first step's eval-mode gradients,
    then, with `scene`, the scene in DP_WORK/scene.npz tile-parallel.
    Waits for `go` before it times anything; writes DP_WORK/rank<rank>.pt."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import functools

    import torch.distributed as dist

    from satmvs_tpu_torch.dist import (all_reduce_grads, init_multihost, make_mesh, replicate,
                                       shard_batch)
    from satmvs_tpu_torch.infer.predict import streaming_red_forward
    from satmvs_tpu_torch.infer.scene import predict_scene
    from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step
    from satmvs_tpu_torch.train.loop import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_multihost(f"file://{init}", DP_RANKS, rank, backend="gloo", device="cuda:0")
    try:
        mesh = make_mesh(data=DP_RANKS, device="cuda:0")
        # the batch this process wrote for its ranks
        local = shard_batch(torch.load(DP_WORK / "batch.pt", weights_only=False), mesh)
        cfg = Config(ndepths=NDEPTHS)
        model, state, tx = create_model_and_state(cfg, local, DP_STEPS)
        replicate(state.to_dict(), mesh)
        step = make_train_step(model, tx, cfg.dlossw, mesh)
        check(go.wait(600), f"rank {rank}: no start")
        _, loss, _, grads = loss_and_grads(model, state, local, cfg.dlossw, False, mesh)
        out = {"eval_loss": loss.item(), "eval_grads": {k: g.cpu() for k, g in grads.items()},
               "ms": [], "scalars": [], "per_step": []}
        reset_counts()
        for _ in range(DP_STEPS):
            before = counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, scalars = step(state, local)
            end.record()
            end.synchronize()
            out["ms"].append(start.elapsed_time(end))
            out["scalars"].append({k: v.item() for k, v in scalars.items()})
            out["per_step"].append({k: v - before[k] for k, v in counts().items()})
        out["train_launches"] = counts()
        out.update(state_copy(state))
        flat = list(grads.values())
        out["allreduce_ms"] = time_ms(lambda: all_reduce_grads(flat, mesh.group), reps=10)
        out["n_grad"] = sum(g.numel() for g in flat)
        del model, state, tx, step, grads, flat
        if not scene:
            torch.save(out, DP_WORK / f"rank{rank}.pt")
            return
        scene = np.load(DP_WORK / "scene.npz")
        stream = functools.partial(streaming_red_forward, build_model("cuda"), slab=SLAB)
        per_call = []

        def forward(imgs, cams, dvals):
            before = counts()
            res = stream(imgs, cams, dvals)
            per_call.append({k: v - before[k] for k, v in counts().items()})
            return res

        reset_counts()
        stats = {}
        depth, conf = predict_scene(forward, scene["images"], scene["rpcs"], tile=TILE,
                                    halo=HALO, batch_tiles=BATCH_TILES, stats=stats, mesh=mesh)
        torch.cuda.synchronize()
        out.update(scene_launches=counts(), per_chunk=per_call, scene_stats=stats, depth=depth,
                   conf=conf)
        torch.save(out, DP_WORK / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_serial(order: tuple = (0, 1)) -> dict:
    """Phase 13 (b)'s reference: the serial step at B = 2 on the card from
    the same weights, on the batch in DP_WORK/batch.pt with its samples in
    `order`: the first step's eval-mode gradients and DP_STEPS train steps'
    scalars and ms."""
    from satmvs_tpu_torch.train import Config, create_model_and_state, make_train_step
    from satmvs_tpu_torch.train.loop import loss_and_grads

    batch = batch_to(torch.load(DP_WORK / "batch.pt", weights_only=False), "cuda")
    order = list(order)
    batch = {k: (v[order] if isinstance(v, torch.Tensor) else type(v)(c[order] for c in v))
             for k, v in batch.items()}
    cfg = Config(ndepths=NDEPTHS)
    model, state, tx = create_model_and_state(cfg, batch, DP_STEPS)
    _, loss, _, grads = loss_and_grads(model, state, batch, cfg.dlossw, False)
    out = {"eval_loss": loss.item(), "eval_grads": {k: g.cpu() for k, g in grads.items()},
           "scalars": [], "ms": []}
    step = make_train_step(model, tx, cfg.dlossw)
    for _ in range(DP_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, scalars = step(state, batch)
        end.record()
        end.synchronize()
        out["ms"].append(start.elapsed_time(end))
        out["scalars"].append({k: v.item() for k, v in scalars.items()})
    return out


def dp_step_errors(got: list, want: list) -> list:
    """By step, the relative distance of got's loss and abs_depth_error
    from want's."""
    return [{key: abs(g[key] - w[key]) / abs(w[key]) for key in ("loss", "abs_depth_error")}
            for g, w in zip(got, want)]


def phase_multi_gpu(card: str, tree: str, scene_ref: dict) -> dict:
    """Phase 13: the data axis of `satmvs_tpu_torch.dist` on the one card.
    (a) `dp_one_rank`; (b) two ranks sharing the card over gloo, global
    B = 2 at 384×768 (a sample a rank), DP_STEPS train steps against the
    serial B = 2 step from the same weights (each step's loss and
    abs_depth_error to its DP_LOSS_TOL; the first step's eval-mode gradients to
    JAX's sharded-gradient gate; the two replicas' parameters and running
    statistics the same bits; each rank's launches a step those of a serial
    B = 1 step); (c) the two ranks predict phase 5's scene tile-parallel
    (batch_tiles BATCH_TILES, two tiles a rank a chunk) against phase 5's
    serial batch_tiles-BATCH_TILES maps `scene_ref` (exact launches per rank
    per chunk).  Returns the launches of (a), of rank 0's steps and of rank
    0's scene run."""
    import multiprocessing
    import shutil

    from satmvs_tpu_torch.data import synthetic

    t0 = time.time()
    shutil.rmtree(DP_WORK, ignore_errors=True)
    DP_WORK.mkdir(parents=True)
    torch.save(synthetic.make_batch(DP_RANKS, WIDTH, HEIGHT, seed=0, device="cpu"),
               DP_WORK / "batch.pt")
    np.savez(DP_WORK / "scene.npz", images=scene_ref["images"], rpcs=scene_ref["rpcs"])
    ctx = multiprocessing.get_context("spawn")
    go = ctx.Event()
    procs = [ctx.Process(target=dp_rank, args=(r, str(DP_WORK / "init"), go))
             for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    try:
        launches = {"dp1_train_step": dp_one_rank(card, tree)}  # while the ranks start
        serial = dp_serial()
        go.set()
        deadline = time.time() + 600
        for p in procs:
            p.join(max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs), f"a rank failed: exit codes "
          f"{[p.exitcode for p in procs]}")
    ranks = [torch.load(DP_WORK / f"rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    r0 = ranks[0]
    # (b)
    failed = []
    errors = dp_step_errors(r0["scalars"], serial["scalars"])
    for k, (err, tol) in enumerate(zip(errors, DP_LOSS_TOL)):
        for key, rel in err.items():
            print(f"[multi] (b) step {k + 1} {key}: two ranks {r0['scalars'][k][key]:.6f}, "
                  f"serial B=2 {serial['scalars'][k][key]:.6f}, {rel:.3e} relative (tol "
                  f"{tol})", flush=True)
            if rel > tol:
                failed.append(f"step {k + 1} {key} {rel} relative")
    scale = max(g.abs().max().item() for g in serial["eval_grads"].values())
    excess = max(((g - serial["eval_grads"][n]).abs()
                  - DP_GRAD_RTOL * serial["eval_grads"][n].abs()).max().item()
                 for n, g in r0["eval_grads"].items())
    print(f"[multi] (b) first step's eval-mode gradients, two ranks vs serial B=2: max "
          f"(|Δ| − {DP_GRAD_RTOL}·|g|) {excess:.3e} = {excess / scale:.3e} of max |g| (tol "
          f"{DP_GRAD_ATOL})", flush=True)
    replicas = same_bits(ranks[0], ranks[1]) and ranks[0]["scalars"] == ranks[1]["scalars"]
    print(f"[multi] (b) two ranks sharing one card over gloo, 384x768, global B=2: replicas the "
          f"same bits after {DP_STEPS} steps: {replicas}; launches per rank per step "
          f"{r0['per_step'][0] == LAUNCHES_PER_TRAIN_STEP and 'those of a serial B=1 step'}; "
          f"step ms rank 0 {[round(t, 2) for t in r0['ms']]}, rank 1 "
          f"{[round(t, 2) for t in ranks[1]['ms']]} (CUDA events; two processes on one card, "
          f"not a scaling number); serial B=2 step ms {[round(t, 2) for t in serial['ms']]}; "
          f"the gradient all-reduce alone ({r0['n_grad']} floats, one buffer, gloo on CUDA "
          f"tensors) {r0['allreduce_ms']:.3f} ms (median of 10) card={card}", flush=True)
    # (c)
    want_chunk = chunk_launches(BATCH_TILES // DP_RANKS)
    bits = np.array_equal(r0["depth"], scene_ref["depth"])
    mean, p99, mx = err_quantiles(
        torch.from_numpy(np.abs(r0["depth"] - scene_ref["depth"]) / scene_ref["step"]))
    same = float(np.mean(r0["depth"] == scene_ref["depth"]))
    st = r0["scene_stats"]
    print(f"[multi] (c) the {SCENE_SIZE}x{SCENE_SIZE} scene over two ranks, "
          f"{BATCH_TILES // DP_RANKS} tiles a rank a chunk, against phase 5's serial batch_tiles "
          f"{BATCH_TILES}: the same bits {bits} ({same:.4f} of the pixels); depth err mean "
          f"{mean:.3e}, p99 {p99:.3e}, max {mx:.3e} of the final step (tol mean "
          f"{DEPTH_TOL_MEAN}, p99 {DEPTH_TOL_P99}); confidence err max "
          f"{np.abs(r0['conf'] - scene_ref['conf']).max():.3e}; launches per rank per chunk "
          f"{({k: v for k, v in r0['per_chunk'][0].items() if v})} (want "
          f"{({k: v for k, v in want_chunk.items() if v})}); rank 0 wall "
          f"{st['wall_s']:.3f} s, host prep {st['host_prep_s']:.3f} s, host gather "
          f"{st['gather_s']:.3f} s card={card}", flush=True)
    if not bits:
        print("[multi] (c) not the same bits: phase 5 runs FeatureNet on cuDNN's default "
              "engines, which are not bit-reproducible run to run (phase 9), at 4 tiles a "
              "forward against 2 here", flush=True)
    check(not failed, f"two ranks against the serial B=2 steps: {failed}")
    check(excess <= DP_GRAD_ATOL * scale, "two ranks: eval-mode gradients")
    check(replicas, "two ranks: the replicas' parameters or statistics differ")
    for r, res in enumerate(ranks):
        check(all(c == LAUNCHES_PER_TRAIN_STEP for c in res["per_step"]),
              f"rank {r}: launches per step {res['per_step']}")
        n = res["scene_stats"]["n_chunks"]
        check(len(res["per_chunk"]) == n == -(-9 // BATCH_TILES)
              and all(c == want_chunk for c in res["per_chunk"]),
              f"rank {r}: scene launches per chunk {res['per_chunk']}")
        check(res["scene_stats"]["local_tiles"] == BATCH_TILES // DP_RANKS,
              f"rank {r}: {res['scene_stats']}")
    check(np.array_equal(r0["depth"], ranks[1]["depth"])
          and np.array_equal(r0["conf"], ranks[1]["conf"]), "the ranks' stitched maps differ")
    check(bits or (mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99),
          f"tile-parallel scene: depth err mean {mean}, p99 {p99} of step")
    launches.update(dp_train_step=r0["train_launches"], dp_scene=r0["scene_launches"])
    launches.update(phase_sharded(card))
    print(f"[multi] phase 13 took {time.time() - t0:.1f} s", flush=True)
    return launches


# ---- phase 13 (d): the spatial and depth axes (`dist.halo`, the sharded
# cost volumes of `models.cascade`) on two gloo ranks that share cuda:0, at
# the main path's 384×768 and ndepths (64, 32, 8), B = 1 (data extent 1:
# both ranks hold the batch and split each sharded stage's volume)
SHARD_RUNS = (("casmvs", "depth"), ("ucs", "depth"), ("casmvs", "spatial"), ("red", "spatial"))
SHARD_RANKS, SHARD_STEPS = 2, 3
SHARD_WORK = WORK / "shard"
# each train step's loss and abs_depth_error against the serial step's, by
# step: step 1 at JAX's sharded-loss gate; steps 2 and 3 fixed from
# `dp_spread.py --shard`'s six runs of this batch (seed 0) on the card,
# about twice the largest reading (PERF.md, §6).  The CostRegNet
# families read at most 2.70e-03 and 1.32e-02 (the ranks) and 1.93e-03 and
# 1.23e-02 (the serial run against itself: cuDNN's default engines and the
# scatter's atomics round otherwise run to run, and RMSprop's first update
# and the train-mode BatchNorms turn that into whole steps); RED at most
# 2.1e-05 and 5.5e-05, under phase 13 (b)'s gates, which it keeps
SHARD_LOSS_TOL = {"casmvs": (2e-4, 6e-3, 3e-2), "ucs": (2e-4, 6e-3, 3e-2),
                  "red": DP_LOSS_TOL}
# the eval step's maps against the serial eval step's, per stage: phase 10's
# depth gates in hypothesis steps and its confidence gates
SHARD_LAUNCHES_TRAIN = {"casmvs": LAUNCHES_PER_COSTREG_TRAIN_STEP,
                        "ucs": LAUNCHES_PER_COSTREG_TRAIN_STEP, "red": LAUNCHES_PER_TRAIN_STEP}
SHARD_LAUNCHES_EVAL = {"casmvs": LAUNCHES_PER_COSTREG_FORWARD,
                       "ucs": LAUNCHES_PER_COSTREG_FORWARD, "red": LAUNCHES_PER_EVAL_STEP}
SHARD_STEP_PATHS = tuple(f"shard_{m}_{a}_step" for m, a in SHARD_RUNS)
SHARD_EVAL_PATHS = tuple(f"shard_{m}_{a}_eval" for m, a in SHARD_RUNS)
SHARD_RED_PATHS = ("shard_red_spatial_step", "shard_red_spatial_eval")


def shard_config(model: str, axis=None):
    """The run's Config: the model's JAX CLI defaults, ndepths (64, 32, 8),
    mesh_spatial or mesh_depth 2 on `axis` (None: serial)."""
    from satmvs_tpu_torch.train import Config

    extents = {} if axis is None else {f"mesh_{axis}": SHARD_RANKS}
    return Config(model=model, ndepths=NDEPTHS, **extents)


def shard_run(model: str, axis, batch: dict, mesh=None, exchanges: bool = False) -> dict:
    """One model from the config's seed at LeCun scale on `batch` (serial, or
    this rank's share under `mesh`): the eval-mode loss and gradients, the eval step
    (its scalars, maps and launches), then SHARD_STEPS train steps (scalars,
    ms by CUDA events, launches, peak memory; with `exchanges` the
    exchanges' all-reduces a step and their ms by CUDA events)."""
    from satmvs_tpu_torch.dist import exchange_stats, replicate, shard_batch
    from satmvs_tpu_torch.train import create_model_and_state, make_eval_step, make_train_step
    from satmvs_tpu_torch.train.loop import loss_and_grads

    cfg = shard_config(model, None if mesh is None else axis)
    local = batch if mesh is None else shard_batch(batch, mesh)
    net, state, tx = create_model_and_state(cfg, local, SHARD_STEPS, mesh=mesh)
    lecun_scale(net)  # the CPU tests' scale: at He scale the cascade amplifies rounding
    if mesh is not None:
        replicate(state.to_dict(), mesh)
    _, loss, _, grads = loss_and_grads(net, state, local, cfg.dlossw, False, mesh)
    out = {"eval_loss": loss.item(), "eval_grads": {k: g.cpu() for k, g in grads.items()},
           "partition": net.volume_partition, "ms": [], "scalars": [], "per_step": [],
           "halo": []}
    del grads
    reset_counts()
    scalars, _, _ = make_eval_step(net, cfg.dlossw, cfg.min_interval, mesh)(state, local)
    with torch.no_grad():
        maps = net(local["imgs"], local["cams"], local["depth_values"])
    torch.cuda.synchronize()
    out["eval_launches"] = {k: v // 2 for k, v in counts().items()}  # the step, then a forward
    out["eval_scalars"] = {k: v.item() for k, v in scalars.items()}
    out["maps"] = {f"stage{i}": {k: maps[f"stage{i}"][k].cpu()
                                 for k in ("depth", "photometric_confidence")}
                   for i in range(1, 4)}
    del maps
    step = make_train_step(net, tx, cfg.dlossw, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(SHARD_STEPS):
        before = counts()
        exchange_stats.reset(timed=exchanges)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, scalars = step(state, local)
        end.record()
        end.synchronize()
        out["ms"].append(start.elapsed_time(end))
        out["scalars"].append({k: v.item() for k, v in scalars.items()})
        out["per_step"].append({k: v - before[k] for k, v in counts().items()})
        out["halo"].append({**exchange_stats.counts, "ms": exchange_stats.ms()})
    exchange_stats.reset()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["train_launches"] = counts()
    out["params"] = {k: v.detach().cpu() for k, v in state.params.items()}
    return out


def shard_rank(rank: int, init: str, go) -> None:
    """Phase 13 (d) on one of SHARD_RANKS ranks that share cuda:0 over gloo
    (a spawned process): every SHARD_RUNS run on the batch in
    SHARD_WORK/batch.pt under its mesh; waits for `go`; writes
    SHARD_WORK/rank<rank>.pt."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.distributed as dist

    from satmvs_tpu_torch.dist import init_multihost, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_multihost(f"file://{init}", SHARD_RANKS, rank, backend="gloo", device="cuda:0")
    try:
        batch = torch.load(SHARD_WORK / "batch.pt", weights_only=False)
        check(go.wait(900), f"rank {rank}: no start")
        out = {}
        for model, axis in SHARD_RUNS:
            shape = (1, SHARD_RANKS, 1) if axis == "spatial" else (1, 1, SHARD_RANKS)
            mesh = make_mesh(*shape, device="cuda:0")
            out[f"{model}_{axis}"] = shard_run(model, axis, batch, mesh, exchanges=True)
            torch.cuda.empty_cache()
        torch.save(out, SHARD_WORK / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def shard_ranks(init: str, go) -> list:
    """SHARD_RANKS spawned `shard_rank` processes; returns their results
    once `go` is set by the caller and they end."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=shard_rank, args=(r, init, go)) for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    return procs


def shard_join(procs) -> list:
    try:
        deadline = time.time() + 900
        for p in procs:
            p.join(max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs), f"a shard rank failed: exit codes "
          f"{[p.exitcode for p in procs]}")
    return [torch.load(SHARD_WORK / f"rank{r}.pt", weights_only=False)
            for r in range(SHARD_RANKS)]


# the band scatters (sweep_scatter, the fused VJP's dsrcs) against their
# plain versions: float atomics sum up to 4·D = 64 products an element in an
# order that changes from run to run (sweep_gather.cu), within
# 2·(4·D − 1)·2⁻²⁴ of the sum of their magnitudes
SCATTER_BAND_TOL = 1e-4


def band_kernel_checks(card: str) -> None:
    """The sweep kernels on a rank's band of reference rows (the source
    views whole; `Hs` > H in the kernels) at the main path's stage 3 (192
    of 384 rows, 768 wide, 64 hypotheses, C 8) against their plain versions:
    the fused sweep (sweep_variance_batched, row0 192) and its VJP (dref,
    and dsrcs into the whole sources), the per-view gather and its
    scatter."""
    from satmvs_tpu_torch.ops.kernels import sweep_gather as sg
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    gen = torch.Generator("cuda").manual_seed(16)
    h, w, c, d, row0 = HEIGHT, WIDTH, FEAT_CH[2], 16, HEIGHT // 2
    hb = h - row0
    feats = torch.rand((1, 3, h, w, c), generator=gen, device="cuda")
    ys0 = torch.arange(row0, h, device="cuda", dtype=torch.float32).view(1, 1, 1, hb, 1)
    xs0 = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, 1, 1, w)
    shift = torch.rand((1, 2, d, hb, w), generator=gen, device="cuda") * 40 - 20
    xs = (xs0 + shift).contiguous()
    ys = (ys0 + 0.7 * shift + 3.0).contiguous()
    ref_band = feats[:, 0, row0:]
    errs = {}

    def err(got, want) -> float:
        return (got - want).abs().max().item() / max(1.0, want.abs().max().item())

    with torch.no_grad():
        got = sv.sweep_variance_batched(feats, xs, ys, row0)
        want = sv.sweep_variance_reference(ref_band[0], feats[0, 1:], xs[0], ys[0])[None]
        errs["sweep_variance"] = err(got, want)
        g = torch.rand_like(got)
        dref, dsrcs = sv._cotangents(ref_band, feats[:, 1:], 3 * h * w * c, xs, ys, g)
        wdref, wdsrcs = sv._plain_vjp(ref_band, feats[:, 1:], xs, ys, g)
        check(dsrcs.shape == (1, 2, h, w, c), f"band VJP: dsrcs {tuple(dsrcs.shape)}")
        errs["sweep_variance_backward dref"] = err(dref, wdref)
        errs["sweep_variance_backward dsrcs"] = err(dsrcs, wdsrcs)
        src = feats[0, 1].contiguous()
        got = sg.sweep_gather(src, xs[0, 0], ys[0, 0])
        want = sg.sweep_gather_reference(src, xs[0, 0], ys[0, 0])
        errs["sweep_gather"] = err(got, want)
        gv = torch.rand_like(got)
        got = sg.sweep_scatter(gv, xs[0, 0], ys[0, 0], h)
        want = sg.sweep_scatter_reference(gv, xs[0, 0], ys[0, 0], h, w)
        errs["sweep_scatter"] = err(got, want)
    torch.cuda.synchronize()
    print(f"[multi] (d) the sweep kernels on a band of rows {row0}..{h - 1} of {h} (sources "
          f"whole), {d} planes, {w} wide, C {c}, against their plain versions: max |Δ| / "
          f"max(1, max |plain|) " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {KERNEL_TOL}; a scatter's atomics {SCATTER_BAND_TOL}) card={card}",
          flush=True)
    scattered = ("sweep_scatter", "sweep_variance_backward dsrcs")
    for k, v in errs.items():
        check(v <= (SCATTER_BAND_TOL if k in scattered else KERNEL_TOL), f"band {k}: {v}")



def shard_compare(tag: str, model: str, got: dict, want: dict, lo: float, hi: float,
                  intervals) -> list:
    """The failures of a rank's run against the serial run: the eval-mode
    loss (2e-4) and gradients (JAX's gate), the eval step's scalars (1e-5)
    and maps (phase 10's gates), each train step's loss and abs_depth_error
    (SHARD_LOSS_TOL), the launches."""
    failed = []
    rel = abs(got["eval_loss"] - want["eval_loss"]) / abs(want["eval_loss"])
    scale = max(g.abs().max().item() for g in want["eval_grads"].values())
    excess = max(((g - want["eval_grads"][n]).abs() - DP_GRAD_RTOL * want["eval_grads"][n].abs())
                 .max().item() for n, g in got["eval_grads"].items())
    print(f"[multi] (d) {tag}: eval-mode loss {got['eval_loss']:.6f} vs serial "
          f"{want['eval_loss']:.6f}, {rel:.3e} relative (tol 2e-4); gradients max (|Δ| − "
          f"{DP_GRAD_RTOL}·|g|) {excess / scale:.3e} of max |g| (tol {DP_GRAD_ATOL})", flush=True)
    if rel > 2e-4 or excess > DP_GRAD_ATOL * scale:
        failed.append(f"{tag}: eval-mode loss {rel} or gradients {excess / scale}")
    worst = max(abs(got["eval_scalars"][k] - w) / max(abs(w), 1.0)
                for k, w in want["eval_scalars"].items() if "acc" not in k or k == "abs_depth_acc")
    steps = stage_steps(lo, hi, intervals)
    parts = []
    for i in range(1, 4):
        g, w = got["maps"][f"stage{i}"], want["maps"][f"stage{i}"]
        dm, dp, _ = err_quantiles((g["depth"] - w["depth"]).abs() / steps[i - 1])
        cm, cp, _ = err_quantiles((g["photometric_confidence"]
                                   - w["photometric_confidence"]).abs())
        parts.append(f"stage{i} depth mean {dm:.3e} p99 {dp:.3e} of a step, conf mean "
                     f"{cm:.3e} p99 {cp:.3e}")
        if dm > DEPTH_TOL_MEAN or dp > DEPTH_TOL_P99 or cm > CONF_TOL_MEAN or cp > CONF_TOL_P99:
            failed.append(f"{tag}: eval stage{i} depth {dm}/{dp} conf {cm}/{cp}")
    print(f"[multi] (d) {tag}: eval step loss/abs_depth_acc within {worst:.3e} (tol 1e-5); "
          + "; ".join(parts) + f" (tol depth {DEPTH_TOL_MEAN}/{DEPTH_TOL_P99}, conf "
          f"{CONF_TOL_MEAN}/{CONF_TOL_P99})", flush=True)
    if worst > 1e-5:
        failed.append(f"{tag}: eval step scalars {worst}")
    for k, (err, tol) in enumerate(zip(dp_step_errors(got["scalars"], want["scalars"]),
                                       SHARD_LOSS_TOL[model])):
        print(f"[multi] (d) {tag} step {k + 1}: loss {err['loss']:.3e}, abs_depth_error "
              f"{err['abs_depth_error']:.3e} relative to the serial step (tol {tol})", flush=True)
        if max(err.values()) > tol:
            failed.append(f"{tag} step {k + 1}: {err}")
    if got["eval_launches"] != SHARD_LAUNCHES_EVAL[model]:
        failed.append(f"{tag}: eval launches {got['eval_launches']}")
    if any(c != SHARD_LAUNCHES_TRAIN[model] for c in got["per_step"]):
        failed.append(f"{tag}: step launches {got['per_step']}")
    return failed


def phase_sharded(card: str) -> dict:
    """Phase 13 (d): for each SHARD_RUNS run, two ranks that share the card
    over gloo (`shard_rank`) against the serial run from the same weights
    on the same batch (`shard_run`): the eval-mode loss and gradients at
    JAX's gates, the eval step (packed CostRegNet on slabs, fused sweep on
    a slab or band; RED after the row gather) at phase 10's gates, three
    train steps at SHARD_LOSS_TOL, exact launches per rank (the serial
    step's), step ms, the exchanges a step and their ms, peak memory a rank
    against the serial step's.  Returns rank 0's launches by path."""
    import shutil

    from satmvs_tpu_torch.data import synthetic

    t0 = time.time()
    shutil.rmtree(SHARD_WORK, ignore_errors=True)
    SHARD_WORK.mkdir(parents=True)
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cpu")
    torch.save(batch, SHARD_WORK / "batch.pt")
    import multiprocessing

    go = multiprocessing.get_context("spawn").Event()
    procs = shard_ranks(str(SHARD_WORK / "init"), go)
    try:
        band_kernel_checks(card)
        serial = {}
        for model, axis in SHARD_RUNS:
            serial[(model, axis)] = shard_run(model, None, batch_to(batch, "cuda"))
            torch.cuda.empty_cache()
        go.set()
        ranks = shard_join(procs)
    finally:
        go.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    lo, hi = batch["depth_values"][0].tolist()
    failed, launches = [], {}
    for model, axis in SHARD_RUNS:
        key, want = f"{model}_{axis}", serial[(model, axis)]
        r0, r1 = ranks[0][key], ranks[1][key]
        tag = f"{model} mesh_{axis} {SHARD_RANKS}"
        intervals = [r * 2.5 for r in (4.0, 2.0, 1.0)]
        failed += shard_compare(tag, model, r0, want, lo, hi, intervals)
        if r0["scalars"] != r1["scalars"] or any(not torch.equal(v, r1["params"][k])
                                                 for k, v in r0["params"].items()):
            failed.append(f"{tag}: the two ranks' replicas differ")
        halo = r0["halo"][-1]
        vol = {i + 1: (NDEPTHS[i] * (HEIGHT // s) * (WIDTH // s) * FEAT_CH[i] * 4 / 2**20)
               for i, s in enumerate(STAGE_SCALES)}
        print(f"[multi] (d) {tag}: sharded stages "
              f"{[i + 1 for i, spec in enumerate(r0['partition']) if spec[1] or spec[2]]}; "
              f"step ms rank 0 {[round(t, 2) for t in r0['ms']]}, rank 1 "
              f"{[round(t, 2) for t in r1['ms']]} (CUDA events; two processes on one card, not "
              f"a scaling number), serial {[round(t, 2) for t in want['ms']]}; exchanges a step "
              f"(all-reduces) halo {halo['halo']}, gather {halo['gather']}, max {halo['max']}, "
              f"{halo['ms']:.2f} ms of the step by CUDA events (steps "
              f"{[round(x['ms'], 2) for x in r0['halo']]}); peak memory rank 0 "
              f"{r0['peak_gib']:.3f} GiB, rank 1 {r1['peak_gib']:.3f} GiB, serial "
              f"{want['peak_gib']:.3f} GiB; whole stage volumes (MiB, fp32) "
              f"{ {k: round(v, 1) for k, v in vol.items()} }; launches a rank a step "
              f"{r0['per_step'][0] == SHARD_LAUNCHES_TRAIN[model] and 'the serial step' + chr(39) + 's'}"
              f" card={card}", flush=True)
        launches[f"shard_{key}_step"] = r0["train_launches"]
        launches[f"shard_{key}_eval"] = r0["eval_launches"]
    check(not failed, f"phase 13 (d): {failed}")
    print(f"[multi] (d) took {time.time() - t0:.1f} s", flush=True)
    return launches


# ---- phase 14: the model's remaining knobs (coarse-grid sweep coordinates,
# bf16 compute_dtype, remat, torch_compat) and reference checkpoints
COARSE_TOL = 0.02        # px, coarse vs the exact chain and vs float64 (BASELINE.md:47)
COARSE_CPU_TOL = 1e-3    # px, coarse coordinates on the card vs the CPU
KNOB_STEPS = 3
# the bf16 step at PARITY_SIZE, GPU vs CPU: cuDNN's and the CPU's bf16
# convolutions round a few outputs apart, as a perturbation of the inputs
# far below a bf16 ulp does.  On the CPU the compute_dtype bf16 step moves
# under images × (1 + 1e-4·N) (`train_sensitivity.py --only compute_bf16`)
# by 5.24e-4 of its loss, 0.185 of its eval-mode gradients and 0.586 of
# its update over all (1.09 and 1.18 per tensor), and 2.02e-2 of its
# running statistics (the fp32 step: 4.31e-5, 1.76e-2, 0.175, 2.46e-3).
# Gates about 2.5× those; per tensor not gated: the update gate says only
# that the bf16 step is that noisy, the loss and statistics gates bind
COMPUTE_BF16_PARITY = {"loss": 1.5e-3, "step_loss": 1.5e-3, "grad": None, "grad_all": 0.5,
                       "update": None, "update_all": 1.5, "stats": 5e-2}
# per train step with remat on the fused RED pipeline: the backward
# recomputes each stage's regularizer, so its forward kernels launch twice
LAUNCHES_PER_REMAT_STEP = {**LAUNCHES_PER_TRAIN_STEP,
                           **{k: 2 * LAUNCHES_PER_FORWARD[k] for k in RED_FORWARD_KERNELS}}
# a bf16 CostRegNet runs cuDNN's conv3d, no plane-conv or conv3d_block kernel
LAUNCHES_PER_BF16_COSTREG_FORWARD = {**{k: 0 for k in LAUNCHES_PER_FORWARD},
                                     "sweep_variance": 3}
KNOB_FORWARD_PATHS = ("coarse_forward", "compute_bf16_forward", "compat_predict",
                      "compat_streaming")
KNOB_TRAIN_PATHS = ("compute_bf16_step", "remat_step")
KNOB_SWEEP_PATHS = ("compute_bf16_casmvs_step", "remat_casmvs_step")  # the sweep pair only


def flax_variables(model) -> dict:
    """The port model's weights as a flax variables tree (numpy), the names
    of `params.load_jax_variables` read the other way."""
    from satmvs_tpu_torch.params import _children

    def walk(m):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Conv3d,
                          torch.nn.ConvTranspose3d)):
            w = m.weight.detach().cpu().numpy()
            p = {"kernel": w.transpose(*range(2, w.ndim), 1, 0)}
            if m.bias is not None:
                p["bias"] = m.bias.detach().cpu().numpy()
            return p, {}
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
            p = {"scale": m.weight.detach().cpu().numpy(), "bias": m.bias.detach().cpu().numpy()}
            s = ({"mean": m.running_mean.cpu().numpy(), "var": m.running_var.cpu().numpy()}
                 if isinstance(m, torch.nn.BatchNorm2d) else {})
            return p, s
        params, stats = {}, {}
        for name, child in _children(m).items():
            params[name], s = walk(child)
            if s:
                stats[name] = s
        return params, stats

    params, stats = walk(model)
    return {"params": params, "batch_stats": stats}


def reference_state_dict(variables: dict, family: str) -> dict:
    """The reference SatMVS state dict ("module."-prefixed torch tensors, the
    reference's module names) that `train.convert` turns into `variables`:
    every layout rule of the converter inverted (a synthetic reference
    checkpoint), of a three-stage or a one-stage tree (the decoder's heads
    and the regularizers the tree holds)."""
    sd = {}

    def torch_w(kernel) -> np.ndarray:  # a flax kernel (*k, A, B) → (B, A, *k)
        k = np.asarray(kernel)
        return k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))

    def put(name, value):
        sd[f"module.{name}"] = torch.from_numpy(np.ascontiguousarray(value))

    def conv(prefix, tree):
        put(f"{prefix}.weight", torch_w(tree["kernel"]))
        if "bias" in tree:
            put(f"{prefix}.bias", tree["bias"])

    def norm(prefix, tree, stats=None):
        put(f"{prefix}.weight", tree["scale"])
        put(f"{prefix}.bias", tree["bias"])
        if stats is not None:
            put(f"{prefix}.running_mean", stats["mean"])
            put(f"{prefix}.running_var", stats["var"])
            sd[f"module.{prefix}.num_batches_tracked"] = torch.tensor(0)

    def block(prefix, p, s, conv_name="Conv_0"):
        conv(f"{prefix}.conv", p[conv_name])
        if "BatchNorm_0" in p:
            norm(f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    def gru(prefix, p):
        wx = np.asarray(p["Conv_x"]["kernel"])
        ch = p["Conv_c"]["kernel"].shape[-1]
        gate = np.concatenate([wx[..., :2 * ch], p["Conv_h"]["kernel"]], axis=2)
        out = np.concatenate([wx[..., 2 * ch:], p["Conv_c"]["kernel"]], axis=2)
        conv(f"{prefix}.gate_conv", {"kernel": gate, "bias": p["Conv_h"]["bias"]})
        conv(f"{prefix}.output_conv", {"kernel": out, "bias": p["Conv_c"]["bias"]})
        for k, name in enumerate(("reset_gate_norm", "update_gate_norm", "output_norm")):
            norm(f"{prefix}.{name}", p[f"GroupNorm_{k}"])

    params, stats = variables["params"], variables["batch_stats"]
    fp, fs = params["FeatureNet_0"], stats["FeatureNet_0"]
    feat = "feature_extraction" if family == "ucs" else "feature"
    encoder = ("conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv1.2", "conv2.0", "conv2.1",
               "conv2.2")
    for i, name in enumerate(encoder):
        block(f"{feat}.{name}", fp[f"ConvBlock_{i}"], fs[f"ConvBlock_{i}"])
    heads = (("out1", "inner1", "out2", "inner2", "out3") if family == "casmvs" else
             ("out1", "out2", "out3"))
    for i, name in enumerate(heads):
        if f"Conv_{i}" in fp:
            conv(f"{feat}.{name}", fp[f"Conv_{i}"])
    if family != "casmvs":
        for i in (0, 1):
            if f"DeconvFuse_{i}" not in fp:
                continue
            fuse_p, fuse_s = fp[f"DeconvFuse_{i}"], fs[f"DeconvFuse_{i}"]
            block(f"{feat}.deconv{i + 1}.deconv", fuse_p["DeconvBlock_0"],
                  fuse_s["DeconvBlock_0"], "ConvTranspose_0")
            block(f"{feat}.deconv{i + 1}.conv", fuse_p["ConvBlock_0"], fuse_s["ConvBlock_0"])
    for i in range(sum(k.startswith(("REDRegularizer_", "CostRegNet_")) for k in params)):
        pre = f"cost_regularization.{i}"
        if family == "red":
            p = params[f"REDRegularizer_{i}"]["ScanREDStep_0"]
            for k in range(3):
                conv(f"{pre}.conv{k + 1}.conv", p[f"ConvBlock_{k}"]["Conv_0"])
            for k, (cell, up) in enumerate((("conv_gru4", "upconv3"), ("conv_gru3", "upconv2"),
                                            ("conv_gru2", "upconv1"), ("conv_gru1", None))):
                gru(f"{pre}.{cell}", p[f"ConvGRUCell_{k}"])
                if up:
                    conv(f"{pre}.{up}.conv", p[f"DeconvBlock_{k}"]["ConvTranspose_0"])
            # the head, a stride-1 ConvTranspose2d: the flipped, (I, O)-swapped conv
            w = torch_w(p["Conv_0"]["kernel"]).transpose(1, 0, 2, 3)[:, :, ::-1, ::-1]
            put(f"{pre}.upconv2d.weight", w)
            put(f"{pre}.upconv2d.bias", p["Conv_0"]["bias"])
        else:
            p, s = params[f"CostRegNet_{i}"], stats[f"CostRegNet_{i}"]
            for k in range(7):
                block(f"{pre}.conv{k}", p[f"ConvBlock_{k}"], s[f"ConvBlock_{k}"])
            for k, name in enumerate(("conv7", "conv9", "conv11")):
                block(f"{pre}.{name}", p[f"DeconvBlock_{k}"], s[f"DeconvBlock_{k}"],
                      "ConvTranspose_0")
            conv(f"{pre}.prob", p["Conv_0"])
    return sd


def knob_coords(card: str, batch: dict, rpcs) -> None:
    """Phase 14 (a), coordinates: `rpc_sweep_coords_coarse` (through
    `ops.warp.sweep_coords(coords="coarse")`) at the forward's three stage
    shapes, each source view, as the model takes it (stage 1 uniform planes
    over the scene range, evaluated per plane; stages 2-3 windows around
    the ground truth, the quadratic height fit; stage 1 by that fit too,
    JAX's path, for the record): against the exact chain and a float64
    oracle (COARSE_TOL) and against the CPU (COARSE_CPU_TOL); the coarse
    and exact coordinates' ms a forward."""
    from satmvs_tpu_torch.ops import warp
    from satmvs_tpu_torch.ops.depth_range import window_samples

    lo, hi = batch["depth_values"][0].tolist()
    jobs = {}
    for i, (sc, nd, iv) in enumerate(zip(STAGE_SCALES, NDEPTHS, STAGE_INTERVALS)):
        h, w = HEIGHT // sc, WIDTH // sc
        hyp = (uniform_hyps(lo, hi, nd, h, w, "cuda") if i == 0 else
               window_samples(batch["depth_stages"][i][0], nd, iv).contiguous())
        cams = batch["cams"][i][0]
        window = hyp[:, 0, 0] if i == 0 else None  # the model's first-stage planes
        for s in range(2):
            for kind, win in (("coarse", window), ("exact", None)):
                jobs[(kind, i, s)] = (lambda c=cams, s=s, hy=hyp, h=h, w=w, k=kind, win=win:
                                      warp.sweep_coords(c, s, hy, h, w, coords=k, window=win))
            ex, ey = jobs[("exact", i, s)]()
            ox, oy = rpc_oracle(rpcs[0], rpcs[s + 1], 1.0 / sc, hyp.cpu())
            for path, win in (("per plane" if i == 0 else "quadratic fit", window),
                              *((("quadratic fit (JAX's)", None),) if i == 0 else ())):
                gx, gy = warp.sweep_coords(cams, s, hyp, h, w, coords="coarse", window=win)
                cx, cy = warp.sweep_coords(cams.to("cpu"), s, hyp.cpu(), h, w, coords="coarse",
                                           window=None if win is None else win.cpu())
                to_exact = torch.hypot(gx - ex, gy - ey).max().item()
                gx, gy, cx, cy = (t.cpu().double().numpy() for t in (gx, gy, cx, cy))
                oracle = max(np.abs(gx - ox).max(), np.abs(gy - oy).max())
                cpu = max(np.abs(gx - cx).max(), np.abs(gy - cy).max())
                print(f"[knobs] coarse coordinates stage{i + 1} ({nd}, {h}, {w}) source {s}, "
                      f"{path}: vs the exact chain {to_exact:.3e} px, vs float64 {oracle:.3e} px "
                      f"(tol {COARSE_TOL}); card vs CPU {cpu:.3e} px (tol {COARSE_CPU_TOL})",
                      flush=True)
                check(to_exact <= COARSE_TOL and oracle <= COARSE_TOL and cpu <= COARSE_CPU_TOL,
                      f"coarse coordinates stage{i + 1} source {s} {path}: {to_exact} / "
                      f"{oracle} / {cpu}")
    ms = {}
    for kind in ("exact", "coarse"):
        fns = [fn for key, fn in jobs.items() if key[0] == kind]
        ms[kind] = time_ms(lambda: [fn() for fn in fns], reps=10, warmup=2)
    print(f"[knobs] RPC sweep coordinates of a {HEIGHT}x{WIDTH} forward (3 stages x 2 source "
          f"views): coarse {ms['coarse']:.3f} ms, exact {ms['exact']:.3f} ms "
          f"({ms['coarse'] / ms['exact']:.3f}x; median of 10, CUDA events) card={card}",
          flush=True)


def coarse_against_shift(model, exact: dict, batch: dict) -> None:
    """Phase 14 (a): the coarse-coordinate stages against `exact` (the same
    model's exact-coordinate forward), each centred on exact's previous
    depth, beside the same model's exact stages under source views shifted
    by COARSE_TOL px (each source RPC's sample and line offsets moved by
    COARSE_TOL/√2): the coarse stage's depth error, mean and p99 in steps,
    at most the shifted stage's.  The gate is a geometry error's effect,
    not the depth gates: a random-weight cascade's flat softmax over a
    stage's planes turns thousandths of a pixel into percents of a step."""
    import dataclasses

    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    feats = model.features(imgs)
    d_min, d_max = dvals[:, 0], dvals[:, -1]
    for i, step in enumerate(stage_steps(*dvals[0].tolist(), model.stage_intervals())):
        prev = None if i == 0 else exact[f"stage{i}"]["depth"]
        ref = exact[f"stage{i + 1}"]["depth"]
        offset = torch.zeros_like(cams[i].src_denorm)
        offset[..., 1] = COARSE_TOL / 2 ** 0.5
        shifted = dataclasses.replace(cams[i], src_denorm=cams[i].src_denorm + offset)
        model.coords = "coarse"
        got = model.stage(i, feats[i], cams[i], d_min, d_max, prev)["depth"]
        model.coords = "exact"
        moved = model.stage(i, feats[i], shifted, d_min, d_max, prev)["depth"]
        mean, p99, mx = err_quantiles((got - ref).abs() / step)
        s_mean, s_p99, s_mx = err_quantiles((moved - ref).abs() / step)
        print(f"[knobs] coarse vs exact coordinates stage{i + 1} (step {step:.3f} m), same window "
              f"centres: depth err mean {mean:.3e}, p99 {p99:.3e}, max {mx:.3e} of step; the "
              f"exact chain under a {COARSE_TOL} px shift of the source views: mean "
              f"{s_mean:.3e}, p99 {s_p99:.3e}, max {s_mx:.3e} (the gates)", flush=True)
        check(mean <= s_mean and p99 <= s_p99,
              f"coarse stage{i + 1}: depth err mean {mean}, p99 {p99} of step past a "
              f"{COARSE_TOL} px shift's {s_mean}, {s_p99}")
    model.coords = "coarse"


def knob_timed(model, batch) -> tuple[float, float]:
    """A forward's ms (median of 5, CUDA events) and peak GiB."""
    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: model(imgs, cams, dvals), reps=5, warmup=1)
    return ms, torch.cuda.max_memory_allocated() / 2**30


def knob_steps(card: str, what: str, cfg, batch, want: dict, ref: dict,
               remat: bool = False) -> tuple[dict, dict]:
    """KNOB_STEPS train steps (`run_train_steps`: exact launches a step,
    finite losses) beside a reference step (ref: its ms and peak GiB).
    Returns (the launches, {"ms", "peak"})."""
    *_, launches, times, _, peak = run_train_steps(cfg, batch, KNOB_STEPS, want, what, card,
                                                   remat=remat)
    ms = float(np.median(times))
    print(f"[knobs] {what} train step {ms:.2f} ms (median of {KNOB_STEPS}), peak_mem={peak:.3f} "
          f"GiB; {ref['what']} {ref['ms']:.2f} ms, {ref['peak']:.3f} GiB "
          f"({ms / ref['ms']:.3f}x, {peak - ref['peak']:+.3f} GiB) card={card}", flush=True)
    return launches, {"ms": ms, "peak": peak}


def remat_update(what: str, cfg, batch) -> None:
    """One step with remat against one without, from the same weights and
    batch, on cuDNN's deterministic engines (the CostRegNet's conv3d
    gradients on the default ones move a CasMVS update by ~1e-2 run to
    run): the update within DP1_UPDATE_TOL over all parameters (the
    scatter's float atomics keep two serial steps from the same bits) and
    the running statistics within it of each tensor's largest value."""
    from satmvs_tpu_torch.train import create_model_and_state, make_train_step

    torch.backends.cudnn.deterministic = True
    runs = []
    for remat in (False, True):
        model, state, tx = create_model_and_state(cfg, batch, 1)
        model.remat = remat
        old = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        state, _ = make_train_step(model, tx, cfg.dlossw)(state, batch)
        runs.append(state_copy(state))
    torch.backends.cudnn.deterministic = False
    spread = update_spread(runs[1], runs[0], old)
    stats = max((runs[1]["stats"][k] - v).abs().max().item() / v.abs().max().item()
                for k, v in runs[0]["stats"].items())
    print(f"[knobs] {what}: remat step vs the step without, update {spread:.3e} over all (tol "
          f"{DP1_UPDATE_TOL}), running statistics {stats:.3e} of each tensor's largest value "
          f"(tol {DP1_UPDATE_TOL})", flush=True)
    check(spread <= DP1_UPDATE_TOL and stats <= DP1_UPDATE_TOL, f"{what}: remat update")


def knob_compat(card: str, tree: str) -> dict:
    """Phase 14 (d): a synthetic reference checkpoint of phase 3's seeded
    CascadeREDNet (`reference_state_dict`) through `cli.convert_ckpt`
    (the restored weights the model's bits), then `cli.predict
    --torch_compat`, full volume and `--streaming --slab 8`, on a copy of
    phase 9's test split: exact launches, the maps the bits of a direct
    torch_compat forward, the streamed maps against the full volume's at
    the depth gates; the torch_compat forward on the card against the CPU
    at PARITY_SIZE stage by stage, and its streaming forward against its
    full volume on phase 3's batch (`phase_stream_vs_full`).  Returns the
    two predict runs' launches."""
    import os
    import shutil

    from satmvs_tpu_torch.cli import convert_ckpt as cli_convert
    from satmvs_tpu_torch.cli import predict as cli_predict
    from satmvs_tpu_torch.cli import restore_model
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config

    model = build_model("cpu")
    src = WORK / "reference" / "model_000015.ckpt"
    src.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"epoch": 15, "model": reference_state_dict(flax_variables(model), "red")}, src)
    ckpt = str(WORK / "converted")
    t0 = time.perf_counter()
    cli_convert.main([f"--src={src}", f"--out={ckpt}", "--epoch", "15"])
    restored, _, _ = restore_model(Config(), ckpt, torch.device("cpu"))
    want = model.state_dict()
    check(all(torch.equal(v, want[k]) for k, v in restored.state_dict().items()),
          "the converted checkpoint is not the model's weights")
    print(f"[knobs] cli.convert_ckpt: {len(want)} tensors of a synthetic reference checkpoint "
          f"restored bit for bit ({time.perf_counter() - t0:.2f} s)", flush=True)

    copy = WORK / "test_compat"
    shutil.copytree(os.path.join(tree, "open_dataset_rpc", "test"), copy,
                    ignore=shutil.ignore_patterns("mvs_results", "height_result"))
    launches = {}
    for key, slab, want_l in (
            ("compat_predict", None, launches_of(0, 3 * TREE_TEST)),
            ("compat_streaming", SLAB,
             {k: 3 * TREE_TEST * v for k, v in chunk_launches(1).items()})):
        extra = [] if slab is None else ["--streaming", "--slab", str(slab)]
        what = " ".join(["cli.predict --torch_compat", *extra])
        reset_counts()
        t0 = time.perf_counter()
        out = cli_predict.main([f"--dataset_root={copy}", f"--loadckpt={ckpt}", "--torch_compat",
                                *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[key] = counts()
        check(launches[key] == want_l, f"{key}: launches {launches[key]}")
        print(f"[knobs] {what}: {wall:.2f} s wall, "
              f"{len(out['written'])} maps, launches "
              f"{({k: v for k, v in launches[key].items() if v})} (exact) card={card}",
              flush=True)
        cli_against_direct(what, str(copy), "rpc", False, ckpt, slab=slab, torch_compat=True)
    ph, pw = PARITY_SIZE
    small = synthetic.make_batch(1, pw, ph, seed=1, device="cuda", with_gt=False)
    gpu = build_model("cuda", torch_compat=True)
    gpu_vs_cpu("[knobs]", f"torch_compat at {ph}x{pw}",
               gpu(small["imgs"], small["cams"], small["depth_values"]),
               build_model("cpu", torch_compat=True), small["imgs"], small["cams"],
               small["depth_values"])
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda", with_gt=False)
    reset_counts()
    phase_stream_vs_full(card, gpu, (batch["imgs"], batch["cams"], batch["depth_values"]),
                         what="torch_compat")
    return launches


def phase_knobs(card: str, tree: str, default_step: dict) -> dict:
    """Phase 14: the model's remaining knobs on the main paths.  (a) coarse
    coordinates (`knob_coords`), a coarse-coordinate CascadeREDNet forward
    at HEIGHT × WIDTH (seeded weights, heads ×1; exact launches, ms, peak
    memory) stage by stage against the exact forward
    (`coarse_against_shift`); (b)
    compute_dtype bf16: CascadeREDNet and CasMVS forwards (exact launches:
    the fused RED pipeline stays fp32, a bf16 CostRegNet runs cuDNN's
    conv3d) and KNOB_STEPS train steps each, ms and peak memory beside
    fp32's, one step at PARITY_SIZE against the CPU (COMPUTE_BF16_PARITY);
    (c) remat: KNOB_STEPS steps each for RED (its forward kernels twice a
    step) and CasMVS beside the steps without, one step's update against
    the step without (`remat_update`); (d) `knob_compat`.  Returns each
    path's launches."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models import CascadeREDNet
    from satmvs_tpu_torch.train import Config

    t0 = time.time()
    launches = {}
    scene = synthetic.make_scene(WIDTH, HEIGHT, seed=0, h_amp=80.0)
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    knob_coords(card, batch, scene["rpcs"][[2, 0, 1]])
    model = CascadeREDNet(ndepths=NDEPTHS, device="cuda", seed=0)
    exact = model(batch["imgs"], batch["cams"], batch["depth_values"])
    model.coords = "coarse"
    _, launches["coarse_forward"] = camera_forward(card, "coarse-coordinate", model, batch,
                                                   LAUNCHES_PER_FORWARD, tag="[knobs]",
                                                   profile=False)
    coarse_against_shift(model, exact, batch)
    model.coords = "exact"
    fp32 = knob_timed(model, batch)
    del model, exact

    bf16 = build_model("cuda", compute_dtype=torch.bfloat16)
    _, launches["compute_bf16_forward"] = camera_forward(
        card, "bf16 compute_dtype", bf16, batch, LAUNCHES_PER_FORWARD, tag="[knobs]",
        profile=False)
    ms, peak = knob_timed(bf16, batch)
    print(f"[knobs] CascadeREDNet forward: bf16 {ms:.2f} ms, {peak:.3f} GiB; fp32 "
          f"{fp32[0]:.2f} ms, {fp32[1]:.3f} GiB ({ms / fp32[0]:.3f}x) card={card}", flush=True)
    del bf16
    mvs = {dt: build_costreg_model("casmvs", "cuda", compute_dtype=dt)
           for dt in (None, torch.bfloat16)}
    reset_counts()
    mvs[torch.bfloat16](batch["imgs"], batch["cams"], batch["depth_values"])
    torch.cuda.synchronize()
    launches["compute_bf16_casmvs"] = counts()
    check(launches["compute_bf16_casmvs"] == LAUNCHES_PER_BF16_COSTREG_FORWARD,
          f"bf16 casmvs launches {launches['compute_bf16_casmvs']}")
    (b_ms, b_peak), (f_ms, f_peak) = (knob_timed(mvs[dt], batch)
                                      for dt in (torch.bfloat16, None))
    print(f"[knobs] CascadeMVSNet forward: bf16 {b_ms:.2f} ms, {b_peak:.3f} GiB (launches "
          f"{({k: v for k, v in launches['compute_bf16_casmvs'].items() if v})}, exact: cuDNN's "
          f"bf16 conv3d); fp32 {f_ms:.2f} ms, {f_peak:.3f} GiB (the conv3d_block kernels) "
          f"card={card}", flush=True)
    del mvs
    red_ref = {"what": "phase 7's default step", **default_step}
    launches["compute_bf16_step"], _ = knob_steps(card, "bf16 compute_dtype", Config(
        ndepths=NDEPTHS, compute_dtype="bfloat16"), batch, LAUNCHES_PER_TRAIN_STEP, red_ref)
    _, mvs_step = knob_steps(card, "CasMVS fp32", Config(ndepths=NDEPTHS, model="casmvs"), batch,
                             LAUNCHES_PER_COSTREG_TRAIN_STEP, red_ref)
    mvs_ref = {"what": "the CasMVS fp32 step", **mvs_step}
    launches["compute_bf16_casmvs_step"], _ = knob_steps(
        card, "CasMVS bf16 compute_dtype", Config(ndepths=NDEPTHS, model="casmvs",
                                                  compute_dtype="bfloat16"), batch,
        LAUNCHES_PER_COSTREG_TRAIN_STEP, mvs_ref)
    phase_train_parity(card, "compute_dtype bf16 step", gates=COMPUTE_BF16_PARITY,
                       compute_dtype="bfloat16")

    launches["remat_step"], _ = knob_steps(card, "remat", Config(ndepths=NDEPTHS), batch,
                                           LAUNCHES_PER_REMAT_STEP, red_ref, remat=True)
    launches["remat_casmvs_step"], _ = knob_steps(
        card, "CasMVS remat", Config(ndepths=NDEPTHS, model="casmvs"), batch,
        LAUNCHES_PER_COSTREG_TRAIN_STEP, mvs_ref, remat=True)
    for what, cfg in (("RED", Config(ndepths=NDEPTHS)),
                      ("CasMVS", Config(ndepths=NDEPTHS, model="casmvs"))):
        remat_update(what, cfg, batch)
    del batch

    launches.update(knob_compat(card, tree))
    print(f"[knobs] phase 14 took {time.time() - t0:.1f} s", flush=True)
    return launches


# phase 15: host I/O and the tools.  (a) the native host library on a ZY-3
# scene's 5120² image against the numpy paths; (b) `cli.synthetic_e2e` at
# its defaults; (c) `cli.fusion_sweep` over phase 9's per-view scene maps,
# card against CPU; (d) `cli.profile_forward` of a forward and a train step
# against phases 3 and 7's profiles; (e) `cli.collectives_report` on gloo
# ranks sharing the card
NATIVE_SIZE = 5120          # a ZY-3 scene's side
# native center_image (float64 moments) against the float64 normalization:
# JAX's 1e-5.  Numpy's float32 path is no reference at this size: its sums
# over 26 M values drift ~3e-2 from the float64 result (printed beside it)
NATIVE_CENTER_TOL = 1e-5
E2E_LEARNS = 0.25           # the trained test MAE at most this share of the untrained model's
# the JAX package's run at the e2e defaults on its TPU (BASELINE.md:273-278),
# printed beside the port's, not a gate
JAX_E2E = {"test_mae_m": 1.29, "fused_mae_m": 1.23, "fusion_valid_frac": 0.953}
E2E_DEFAULTS = {"scenes": 16, "test_scenes": 4, "epochs": 12}
SWEEP_GRID = ("--p_ratio", "1", "2", "4", "--d_ratio", "2.5", "7.5", "--geo_consist", "1", "2",
              "--confidence", "0.1")
PROFILE_TOL = 0.10          # the profile CLI's device total against phases 3 and 7's
PROFILE_ITERS = 3
COLLECTIVE_RUNS = (("data", 2), ("data_spatial", 2), ("depth", 4))
TOOL_TRAIN_PATHS = ("e2e_step", "profile_train", "collectives_data", "collectives_data_spatial")
TOOL_FORWARD_PATHS = ("e2e_forward", "profile_forward")
TOOL_SWEEP_PATHS = ("collectives_depth",)  # CasMVS: the sweep pair only


def host_ms(fn, reps: int = 3) -> tuple[float, object]:
    """Median host ms of reps calls of fn, and its last result."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), out


def native_io(card: str) -> None:
    """Phase 15 (a): the native library must be built here; PFM write and
    read and center_image on a 5120² image, native against numpy: the same
    bytes and arrays; center_image within NATIVE_CENTER_TOL of the float64
    normalization, numpy's distance from it printed; host ms each."""
    import shutil

    from satmvs_tpu_torch import native
    from satmvs_tpu_torch.data import formats, preprocess

    check(native.available(), "the native host library did not build on this machine")
    real = native.available
    rng = np.random.default_rng(0)
    height = rng.normal(400.0, 60.0, (NATIVE_SIZE, NATIVE_SIZE)).astype(np.float32)
    img = rng.uniform(0.0, 255.0, (NATIVE_SIZE, NATIVE_SIZE, 3)).astype(np.float32)
    folder = WORK / "native"
    folder.mkdir(parents=True, exist_ok=True)
    ms, out = {}, {}
    for path in ("native", "numpy"):
        native.available = real if path == "native" else (lambda: False)
        try:
            pfm = str(folder / f"{path}.pfm")
            ms[("write", path)], _ = host_ms(lambda: formats.save_pfm(pfm, height))
            ms[("read", path)], out[("read", path)] = host_ms(lambda: formats.load_pfm(pfm))
            ms[("center", path)], out[("center", path)] = host_ms(
                lambda: preprocess.center_image(img))
        finally:
            native.available = real
    same_file = (folder / "native.pfm").read_bytes() == (folder / "numpy.pfm").read_bytes()
    check(same_file, "native and numpy PFM files differ")
    for path in ("native", "numpy"):
        check(np.array_equal(out[("read", path)], height), f"{path} PFM read: other values")
    x = img.astype(np.float64)
    exact = (x - x.mean(axis=(0, 1))) / (x.std(axis=(0, 1)) + 1e-8)
    del x
    err = {path: float(np.abs(out[("center", path)] - exact).max()) for path in ("native", "numpy")}
    center_err = float(np.abs(out[("center", "native")] - out[("center", "numpy")]).max())
    check(err["native"] <= NATIVE_CENTER_TOL, f"native center_image {err['native']:.3e} from "
          "the float64 normalization")
    print(f"[tools] native library {native.library_path().name} available: host ms on a "
          f"{NATIVE_SIZE}² image, native / numpy (median of 3): PFM write "
          f"{ms[('write', 'native')]:.1f} / {ms[('write', 'numpy')]:.1f}, PFM read "
          f"{ms[('read', 'native')]:.1f} / {ms[('read', 'numpy')]:.1f} (same bytes and values), "
          f"center_image of {NATIVE_SIZE}²×3 {ms[('center', 'native')]:.1f} / "
          f"{ms[('center', 'numpy')]:.1f}, max |Δ| from the float64 normalization "
          f"{err['native']:.3e} / {err['numpy']:.3e} (native's tol {NATIVE_CENTER_TOL:g}), "
          f"native from numpy {center_err:.3e}; host time card={card}", flush=True)
    shutil.rmtree(folder, ignore_errors=True)


def e2e_run(card: str) -> dict:
    """Phase 15 (b): `cli.synthetic_e2e` at its defaults: exact launches per
    train step (phase 7's list) and per evaluation or prediction forward,
    finite losses, and a test MAE at most E2E_LEARNS of the untrained
    model's on the same split.  Returns the launches of its train steps and
    of its forwards."""
    from satmvs_tpu_torch.cli import synthetic_e2e
    from satmvs_tpu_torch.data.dataset import MVSDataset
    from satmvs_tpu_torch.data.loader import Loader
    from satmvs_tpu_torch.train import create_model, loop

    per_step, losses = [], []
    make_train_step = loop.make_train_step

    def counted_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def run_step(state, batch):
            before = counts()
            state, scalars = step(state, batch)
            per_step.append({k: v - before[k] for k, v in counts().items()})
            losses.append(scalars["loss"].detach())
            return state, scalars
        return run_step

    workdir = WORK / "e2e"
    loop.make_train_step = counted_step
    reset_counts()
    t0 = time.time()
    try:
        res = synthetic_e2e.main(["--workdir", str(workdir)])
    finally:
        loop.make_train_step = make_train_step
    wall = time.time() - t0
    total = counts()
    n = E2E_DEFAULTS
    check(len(per_step) == n["scenes"] * n["epochs"], f"e2e: {len(per_step)} train steps")
    check(all(p == LAUNCHES_PER_TRAIN_STEP for p in per_step),
          f"e2e train step launches {[p for p in per_step if p != LAUNCHES_PER_TRAIN_STEP][:1]}")
    step_launches = {k: len(per_step) * v for k, v in LAUNCHES_PER_TRAIN_STEP.items()}
    forwards = n["test_scenes"] * (n["epochs"] + 1) + 3  # fit's test passes, the final one, 3 views
    fwd_launches = {k: total[k] - step_launches[k] for k in total}
    check(fwd_launches == {k: forwards * v for k, v in LAUNCHES_PER_FORWARD.items()},
          f"e2e forwards' launches {fwd_launches} for {forwards} forwards")
    loss = torch.stack(losses).cpu()
    check(bool(torch.isfinite(loss).all()), "e2e: a non-finite train loss")

    args = synthetic_e2e._parser().parse_args([])
    cfg = synthetic_e2e.e2e_config(args)
    test = Loader(MVSDataset(str(workdir / "test"), "test", 3, 2), 1, device="cuda")
    untrained = synthetic_e2e.evaluate(create_model(cfg, "cuda"), cfg, test)["abs_depth_acc"]
    line = {k: res[k] for k in ("test_mae_m", "acc_1.0m", "acc_2.5m", "acc_7.5m",
                                "acc_3interval", "fused_mae_m", "fusion_valid_frac",
                                "train_seconds", "epochs", "scenes")}
    print(f"[tools] e2e line: {json.dumps(line)}", flush=True)
    print(f"[tools] e2e: wall {wall:.1f} s (generation {res['gen_seconds']:.1f} s, fit "
          f"{res['train_seconds']} s: {sum(res['timing']['steps'])} steps in "
          f"{sum(res['timing']['train_s']):.1f} s, test passes "
          f"{sum(res['timing']['test_s']):.1f} s); launches per step exact "
          f"({len(per_step)} steps), {forwards} forwards exact; loss {loss[0]:.3f} -> "
          f"{loss[-1]:.3f} (mean of the last epoch's {loss[-n['scenes']:].mean():.3f}) "
          f"card={card}", flush=True)
    beyond = {k: res[k] for k, v in JAX_E2E.items()
              if (res[k] < v / 2 if k == "fusion_valid_frac" else res[k] > 2 * v)}
    print(f"[tools] e2e: test MAE {res['test_mae_m']} m against the untrained model's "
          f"{untrained:.3f} m (gate ≤ {E2E_LEARNS:g}×); the JAX package's recorded run at these "
          f"defaults (BASELINE.md, on its TPU): test MAE {JAX_E2E['test_mae_m']} m, fused "
          f"{JAX_E2E['fused_mae_m']} m at {100 * JAX_E2E['fusion_valid_frac']:.1f} % valid; "
          f"beyond twice JAX's: {beyond or 'none'}", flush=True)
    check(res["test_mae_m"] <= E2E_LEARNS * untrained,
          f"e2e: test MAE {res['test_mae_m']} m against the untrained {untrained:.3f} m")
    return {"e2e_step": step_launches, "e2e_forward": fwd_launches}


def fusion_sweep_run(card: str, scene_files, gt_path: str) -> None:
    """Phase 15 (c): `cli.fusion_sweep` over phase 9's per-view maps of the
    scene (`cli.predict_scene --dsm`) with its ground truth, on the card and
    on the CPU: per setting the valid share within FUSE_VALID_TOL and the
    MAE within FUSE_DSM_TOL (phase 9's fusion gates)."""
    import os
    from unittest import mock

    from satmvs_tpu_torch.cli import fusion_sweep

    order = (2, 0, 1)
    args = ["--views", *(str(WORK / f"scene_height_view{v}.pfm") for v in order),
            "--rpcs", *(scene_files[1][v] for v in order),
            "--prob", str(WORK / "scene_height_prob.pfm"), "--gt", gt_path, *SWEEP_GRID]
    t0 = time.perf_counter()
    gpu = fusion_sweep.main(args)
    t_gpu = time.perf_counter() - t0
    with mock.patch.dict(os.environ, {"SATMVS_PLATFORM": "cpu"}):
        t0 = time.perf_counter()
        cpu = fusion_sweep.main(args)
        t_cpu = time.perf_counter() - t0
    check(len(gpu) == len(cpu) == 3 * 2 * 2, f"fusion_sweep rows {len(gpu)} / {len(cpu)}")
    dv = max(abs(g["valid_pct"] - c["valid_pct"]) for g, c in zip(gpu, cpu))
    dm = max(abs(g["mae_m"] - c["mae_m"]) for g, c in zip(gpu, cpu))
    check(dv <= 100 * FUSE_VALID_TOL and dm <= FUSE_DSM_TOL,
          f"fusion_sweep card vs CPU: valid {dv} pp, MAE {dm} m")
    best = min(gpu, key=lambda r: r["mae_m"])
    print(f"[tools] fusion_sweep over {len(gpu)} settings of the {SCENE_SIZE}² scene's maps: "
          f"card {t_gpu:.2f} s, CPU {t_cpu:.2f} s (host clock); card vs CPU valid ≤ {dv:.2f} pp "
          f"(tol {100 * FUSE_VALID_TOL:g}), MAE ≤ {dm:.4f} m (tol {FUSE_DSM_TOL:g}); lowest MAE "
          f"{json.dumps(best)}; valid {min(r['valid_pct'] for r in gpu)}-"
          f"{max(r['valid_pct'] for r in gpu)} % card={card}", flush=True)


def profile_run(card: str) -> dict:
    """Phase 15 (d): `cli.profile_forward` of the flagship forward and of a
    train step: its pools sum to its total, the hand-written pools are not
    empty, the total within PROFILE_TOL of phases 3 and 7's profiles, exact
    launches (a warm-up call and PROFILE_ITERS)."""
    from satmvs_tpu_torch.cli import profile_forward as cli

    launches = {}
    for path, train, ref, per_call in (
            ("profile_forward", False, "one forward", LAUNCHES_PER_FORWARD),
            ("profile_train", True, "one fused train step", LAUNCHES_PER_TRAIN_STEP)):
        reset_counts()
        res = cli.main(["--iters", str(PROFILE_ITERS), "--trace_dir", str(WORK / path),
                        *(["--train"] if train else [])])
        launches[path] = counts()
        want = {k: (PROFILE_ITERS + 1) * v for k, v in per_call.items()}
        check(launches[path] == want, f"{path}: launches {launches[path]}")
        pools = res["pools"]
        check(abs(sum(ms for ms, _ in pools.values()) - res["total_ms"]) <= 1e-6 * res["total_ms"],
              f"{path}: pools do not sum to the total")
        check(pools[cli.SWEEP_POOL][0] > 0 and pools[cli.RED_POOL][0] > 0,
              f"{path}: a hand-written pool is empty: {pools}")
        rel = abs(res["total_ms"] - PROFILED[ref]) / PROFILED[ref]
        print(f"[tools] profile_forward{' --train' if train else ''}: device "
              f"{res['total_ms']:.3f} ms a call against {PROFILED[ref]:.3f} ms in {ref}'s "
              f"profile ({rel:.4f} apart, tol {PROFILE_TOL:g}); wall {res['wall_ms']:.2f} ms; "
              + ", ".join(f"{p} {ms:.3f} ms" for p, (ms, _) in pools.items())
              + f" card={card}", flush=True)
        check(rel <= PROFILE_TOL, f"{path}: device total {res['total_ms']} vs {PROFILED[ref]}")
    return launches


def collective_counts(record: dict, model) -> dict:
    """The counts of a rank's step by issuer, from the model's layers: each
    BatchNorm whose moments span ranks (FeatureNet's under a data axis
    above 1, a sharded stage's regularizer's) forward and backward; a loss
    mask count a stage, a loss sum, a metric sum, one gradient all-reduce;
    per sharded stage a slab gather (RED, rows) or a halo per 3-D conv and
    a group max (the CostRegNets, planes), forward and backward."""
    from satmvs_tpu_torch.nn.blocks import BatchNorm

    sharded = [i for i, spec in enumerate(record["volume_partition"]) if spec[1] or spec[2]]
    bn = (sum(isinstance(m, BatchNorm) for m in model.feature.modules())
          if record["mesh"]["data"] > 1 else 0)
    bn += sum(isinstance(m, BatchNorm) for i in sharded for m in model.regs[i].modules())
    convs = sum(isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))
                for i in sharded for m in model.regs[i].modules())
    red = record["model"] == "red"
    want = {"gradients": 1, "batchnorm moments": bn, "batchnorm moments (backward)": bn,
            "loss mask counts": len(model.ndepths), "loss sums": 1, "metric sums": 1,
            "slab gather": len(sharded) if red else 0,
            "slab gather (backward)": len(sharded) if red else 0,
            "halo exchange": 0 if red else convs, "halo exchange (backward)": 0 if red else convs,
            "group max": 0 if red else len(sharded)}
    return want


def collectives_run(card: str) -> dict:
    """Phase 15 (e): `cli.collectives_report` at its defaults (RED,
    384×768, ndepths 64/32/8) on gloo ranks sharing the card: `data` and
    `data_spatial` on 2 ranks, `depth` (CasMVS) on 4, the three worlds at
    once.  Every rank's step launches exactly a step's kernels and records
    the inventory of rank 0; the gradient all-reduce is 4 bytes a
    parameter; the counts follow `collective_counts`.  Returns rank 0's
    launches per mesh."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from satmvs_tpu_torch.cli import collectives_report
    from satmvs_tpu_torch.train import Config, create_model

    t0 = time.time()
    # the ranks render their batches at once: a core each
    one_thread = {var: "1" for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                       "MKL_NUM_THREADS")}
    with mock.patch.dict(os.environ, one_thread), ThreadPoolExecutor(len(COLLECTIVE_RUNS)) as pool:
        jobs = [pool.submit(collectives_report.collect, ["--devices", str(n), "--mesh", mesh])
                for mesh, n in COLLECTIVE_RUNS]
        worlds = [job.result() for job in jobs]
    wall = time.time() - t0
    launches = {}
    for (mesh, devices), (args, ranks) in zip(COLLECTIVE_RUNS, worlds):
        collectives_report.print_report(args, ranks)
        want_launches = (LAUNCHES_PER_TRAIN_STEP if args.model == "red" else
                         LAUNCHES_PER_COSTREG_TRAIN_STEP)
        for r in ranks:
            got = {k: r["launches"].get(k, 0) for k in want_launches}
            check(got == want_launches, f"collectives {mesh} rank {r['rank']}: launches {got}")
            check(np.isfinite(r["loss"]), f"collectives {mesh} rank {r['rank']}: loss {r['loss']}")
        r0 = ranks[0]
        rows = {row["issuer"]: row for row in r0["inventory"]}
        check(rows["gradients"]["bytes"] == 4 * r0["params"],
              f"collectives {mesh}: gradient bytes {rows['gradients']['bytes']}")
        model = create_model(Config(model=args.model, ndepths=NDEPTHS), "cpu")
        want = collective_counts(r0, model)
        got = {k: rows[k]["count"] if k in rows else 0 for k in want}
        check(got == want, f"collectives {mesh}: counts {got}, want {want}")
        key = ("op", "issuer", "count", "bytes")
        inv = [[tuple(row[k] for k in key) for row in r["inventory"]] for r in ranks]
        check(all(i == inv[0] for i in inv), f"collectives {mesh}: the ranks' inventories differ")
        total = sum(row["bytes"] for row in rows.values())
        useful = sum(row["useful_bytes"] for row in rows.values())
        sharded = [i + 1 for i, spec in enumerate(r0["volume_partition"]) if spec[1] or spec[2]]
        print(f"[tools] collectives {mesh} on {devices} gloo ranks sharing the card: "
              f"{args.model}, sharded stages {sharded}, "
              f"{sum(row['count'] for row in rows.values())} collectives a step, "
              f"{total} bytes ({useful} useful), gradients {rows['gradients']['bytes']} = 4 × "
              f"{r0['params']} parameters; counts {got} (exact); each rank's step launched "
              f"exactly a step's kernels card={card}", flush=True)
        launches[f"collectives_{mesh}"] = {k: r0["launches"].get(k, 0) for k in counts()}
    print(f"[tools] the three collectives worlds ({sum(n for _, n in COLLECTIVE_RUNS)} ranks "
          f"at once) took {wall:.1f} s", flush=True)
    return launches


def phase_tools(card: str, scene_files, gt_path: str) -> dict:
    """Phase 15: (a)-(e) above; returns the launches of the new paths."""
    t0, launches, took = time.time(), {}, {}
    for part, run_part in (("a", lambda: native_io(card)), ("b", lambda: e2e_run(card)),
                           ("c", lambda: fusion_sweep_run(card, scene_files, gt_path)),
                           ("d", lambda: profile_run(card)), ("e", lambda: collectives_run(card))):
        t1 = time.time()
        launches.update(run_part() or {})
        took[part] = round(time.time() - t1, 1)
    print(f"[tools] phase 15 took {time.time() - t0:.1f} s ({took} s by part)", flush=True)
    return launches


# ---- phase 16: the widths the JAX package takes past the default ones, and
# remat under a mesh
WIDTH_STATES = (2, 6, 10)   # ConvGRU state widths that are not a multiple of 4
NARROW_RED = (6, 6, 6)      # cr_base_chs of the narrow CascadeREDNet: first cells of 6 channels
WIDE_COSTREG = (16, 16, 16)  # cr_base_chs of the wide CostRegNets: 3-D blocks of 128 channels
WIDE_BLOCK_BASES = (12, 16)  # the 3-D blocks past 64 channels at these base widths
WIDTH_STEPS = 3
WIDTH_HW = (96, 192)        # GPU vs CPU, and the streamed chunk's tiles
# cr_base_chs of the wide CascadeREDNet: stage 1's cells of 129, 258, 516 and
# 1032 state channels (run at 132, 260, 516, 1032), past the 4·256 where a
# thread of the ConvGRU kernels' own-pixel passes walks more than one group
WIDE_RED = (129, 8, 8)
# red_recur past 1024 state channels, (label, B, D, h, w, Cin, C, seeded,
# timed): the wide forward's deepest cell (stage 1, scale 8), from a zero
# and a seeded start state and at Cn = 1030 (run padded to 1032); C = 2056,
# where some threads walk three groups, on a small plane; and a 4-tile scene
# chunk's deepest cell (448² tiles, an 8-plane slab)
WIDE_RECUR_CASES = (
    ("deepest cell", 1, NDEPTHS[0], HEIGHT // 32, WIDTH // 32, 8 * WIDE_RED[0],
     8 * WIDE_RED[0], False, True),
    ("deepest cell", 1, NDEPTHS[0], HEIGHT // 32, WIDTH // 32, 8 * WIDE_RED[0],
     8 * WIDE_RED[0], True, False),
    ("deepest cell", 1, NDEPTHS[0], HEIGHT // 32, WIDTH // 32, 8 * WIDE_RED[0], 1030, False,
     False),
    ("three groups a thread", 1, 8, 6, 12, 64, 2056, True, True),
    ("scene chunk", BATCH_TILES, SLAB, TILE_HW // 32, TILE_HW // 32, 8 * WIDE_RED[0],
     8 * WIDE_RED[0], True, True))
REMAT_MESH_RUNS = (("casmvs", "depth"), ("red", "spatial"))
REMAT_WORK = WORK / "remat"
# sha256 (first 16 hex digits) of `default_plans(264)`: red_recur's launch
# plans at the default widths on an H100 (264 resident blocks), as the
# plans were before the kernels took widths that are not a multiple of 4
DEFAULT_PLAN_DIGEST = "d86fa01d6a690ceb"
WIDTH_FORWARD_PATHS = ("narrow_red_forward", "narrow_red_stream", "wide_red_forward",
                       "wide_red_stream")
WIDTH_TRAIN_PATHS = ("narrow_red_step", "remat_red_spatial", "wide_red_step")
WIDTH_COSTREG_PATHS = ("wide_casmvs", "wide_ucs")
WIDTH_SWEEP_PATHS = ("remat_casmvs_depth",)  # CasMVS training: the sweep pair only


def default_plans(resident: int) -> list:
    """red_recur's forward and backward plans at the 12 recurrences of a
    384×768 forward (B = 1 and 2) and the forward's at the 12 of a 4-tile
    scene chunk (B = 4), the default base width 8."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    plans = []
    for _, _, h, w, cin in red_shapes():
        for s, ci, c in red_scales(cin):
            for b in (1, 2):
                plans.append(["fwd", b, h // s, w // s, ci, c,
                              rr.red_recur_plan(b, h // s, w // s, ci, c, resident)])
                plans.append(["bwd", b, h // s, w // s, ci, c,
                              rr.red_recur_bwd_plan(b, h // s, w // s, ci, c, resident)])
    for scale, cin in zip(STAGE_SCALES, FEAT_CH):
        for s, ci, c in red_scales(cin):
            hh = TILE_HW // scale // s
            plans.append(["fwd", 4, hh, hh, ci, c, rr.red_recur_plan(4, hh, hh, ci, c, resident)])
    return plans


def width_recur_kernels(card: str) -> None:
    """Phase 16 (a): red_recur at state widths WIDTH_STATES (run padded to a
    multiple of 4) at the first cell of each stage of a 384×768 forward
    (Cin the stage's features), from a zero start state, seeded at stage
    3, batched (B = 4, a scene chunk's stage-1 slab, each element seeded),
    and its backward at each stage: against the plain versions at phases 2
    and 8's tolerances, the same bits in a second run; kernel, plain and
    bound ms, and the forward beside the same calls at the padded width
    (what the pads cost).  The default widths' plans are checked to be
    what they were (DEFAULT_PLAN_DIGEST)."""
    import hashlib

    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    resident = rr.resident()
    digest = hashlib.sha256(json.dumps(default_plans(resident), sort_keys=True).encode())
    same = digest.hexdigest()[:16] == DEFAULT_PLAN_DIGEST
    print(f"[widths] red_recur plans at the default widths ({resident} resident blocks): "
          f"digest {digest.hexdigest()[:16]}, as before ({DEFAULT_PLAN_DIGEST}): {same}",
          flush=True)
    check(resident != 264 or same, "the default widths' red_recur plans changed")
    gen = torch.Generator(device="cuda").manual_seed(16)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    src = "satmvs_tpu_torch/csrc/red_recur.cu"
    for c in WIDTH_STATES:
        c4 = rr.padded_width(c)
        fwd = KernelReport("red_recur", src, "satmvs_tpu/ops/pallas/red_recur.py:259", card)
        bwd = KernelReport("red_recur_backward", src, "satmvs_tpu/ops/pallas/red_recur.py:755",
                           card)
        padded_ms = 0.0
        for stage, d, h, w, cin in red_shapes():
            cell, cell4 = red_cell(cin, c, 100 + c, randn), red_cell(cin, c4, 100 + c, randn)
            x = randn(d, h, w, cin)
            cases = [("", None)] + ([(" h0", torch.tanh(randn(h, w, c)))]
                                    if stage == "stage3" else [])
            for tag, h0 in cases:
                label = f"C={c} {stage} scale1{tag} {(d, h, w, cin)}->{c}"
                with torch.no_grad():
                    fwd.case(label, lambda: rr.red_recur(x, cell, h0),
                             lambda: rr.red_recur_reference(x, cell, h0),
                             lambda want: RED_RECUR_TOL, *recur_work(x, c, cell),
                             timed=h0 is None)
                    recur_same_bits(rr, label, x, cell, h0)
                    if h0 is None:
                        padded_ms += time_ms(lambda: rr.red_recur(x, cell4), reps=10)
            with torch.no_grad():
                out = rr.red_recur(x[None], cell)
            g = randn(*out.shape)
            nbytes, flops = recur_work(x, c, cell)
            label = f"C={c} {stage} scale1 backward {(d, h, w, cin)}->{c}"

            def flat(res):
                return (res[0], *res[1])

            bwd.case(label, lambda: flat(rr.red_recur_backward(x[None], out, g, cell)),
                     lambda: flat(rr.red_recur_backward_reference(x[None], out, g, cell)),
                     lambda want: RED_BWD_TOL * max(1.0, want.abs().max().item()),
                     2 * nbytes + 4 * out.numel(), 3 * flops)
            a, b = (flat(rr.red_recur_backward(x[None], out, g, cell)) for _ in range(2))
            check(all(torch.equal(u, v) for u, v in zip(a, b)),
                  f"red_recur_backward {label}: a second run differs")
            del out, g, a, b
        # the batched form: a 4-tile chunk's stage-1 slab, each tile from its own state
        hh = TILE_HW // STAGE_SCALES[0]
        cell = red_cell(FEAT_CH[0], c, 110 + c, randn)
        xb = randn(BATCH_TILES, SLAB, hh, hh, FEAT_CH[0])
        h0 = torch.tanh(randn(BATCH_TILES, hh, hh, c))
        label = f"C={c} stage1 scale1 B={BATCH_TILES} {(SLAB, hh, hh, FEAT_CH[0])}->{c} h0"
        with torch.no_grad():
            fwd.case(label, lambda: rr.red_recur(xb, cell, h0),
                     lambda: rr.red_recur_reference(xb, cell, h0), lambda want: RED_RECUR_TOL,
                     *recur_work(xb, c, cell), timed=False)
            recur_same_bits(rr, label, xb, cell, h0)
            got = rr.red_recur(xb, cell, h0)
            err = max((got[e] - rr.red_recur(xb[e], cell, h0[e])).abs().max().item()
                      for e in range(BATCH_TILES))
        check(err <= RED_RECUR_TOL, f"red_recur {label}: B vs B = 1 max abs err {err}")
        f, bk = fwd.record(), bwd.record()
        print(f"[widths] red_recur C={c} (run at {c4}) over the three stages' first cells: "
              f"forward {f['ms']:.4f} ms (at C={c4}: {padded_ms:.4f} ms), plain "
              f"{f['plain_ms']:.4f}, bound {f['bound_ms']:.4f} ({f['bound_by']}), max abs err "
              f"{f['max_abs_err']:.3e} (tol {RED_RECUR_TOL}); backward {bk['ms']:.4f} ms, plain "
              f"{bk['plain_ms']:.4f}, bound {bk['bound_ms']:.4f} ({bk['bound_by']}), max abs "
              f"err {bk['max_abs_err']:.3e} (tol {RED_BWD_TOL} × max(1, |plain|)); batched "
              f"B={BATCH_TILES} each element vs its B = 1 call {err:.3e} card={card}",
              flush=True)


def width_stream(card: str, model, cpu_model, batch, what: str) -> dict:
    """Phase 16 (b) and (e), a streamed chunk of `what`: `streaming_red_forward`
    (slab 8) of the batch's tiles on the card, exact launches, then stage by
    stage against the same model's plain full-volume stages on the CPU, each
    centred on the card's previous-stage depth (the depth gates)."""
    from satmvs_tpu_torch.infer.predict import streaming_red_forward

    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    bt = imgs.shape[0]
    reset_counts()
    with torch.no_grad():
        stream = streaming_red_forward(model, imgs, cams, dvals, slab=SLAB)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == chunk_launches(bt), f"{what} streaming launches {launches}")
    cams_cpu, dv_cpu = [c.to("cpu") for c in cams], dvals.cpu()
    feats = cpu_model.features(imgs.cpu())
    for i, step in enumerate(stage_steps(*dv_cpu[0].tolist(), cpu_model.stage_intervals())):
        prev = None if i == 0 else stream[f"stage{i}"]["depth"].cpu()
        ref = cpu_model.stage(i, feats[i], cams_cpu[i], dv_cpu[:, 0], dv_cpu[:, -1], prev)
        got = stream[f"stage{i + 1}"]["depth"].cpu()
        mean, p99, mx = err_quantiles((got - ref["depth"]).abs() / step)
        print(f"[widths] {what} streamed chunk (B={bt}, slab {SLAB}) on the card "
              f"vs the CPU's plain stages, stage{i + 1}: depth err mean {mean:.3e}, p99 "
              f"{p99:.3e}, max {mx:.3e} of step (tol {DEPTH_TOL_MEAN}, {DEPTH_TOL_P99})",
              flush=True)
        check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
              f"{what} streaming stage{i + 1}: depth err mean {mean}, p99 {p99}")
    return launches


def red_at_width(card: str, default_step: dict, base_chs: tuple, name: str) -> dict:
    """Phase 16 (b) and (e): CascadeREDNet at cr_base_chs `base_chs`: a
    384×768 forward (exact launches, ranges) and its ms and peak memory
    beside the default width's; GPU vs CPU at WIDTH_HW; a streamed chunk of
    two WIDTH_HW tiles against the CPU; WIDTH_STEPS train steps at 384×768
    (exact launches) beside phase 7's; one step at 96×192 against the CPU
    (phase 7's gates).  Returns the launches of each path, named
    `<name>_red_forward`, `_stream` and `_step`."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config

    what = f"RED b={base_chs[0]}"
    model = build_model("cuda", cr_base_chs=base_chs)
    check(all(reg.step.gru1.features == b for reg, b in zip(model.regs, base_chs)),
          f"{what}: the first cells' widths")
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    torch.cuda.synchronize()
    reset_counts()
    out = model(imgs, cams, dvals)
    torch.cuda.synchronize()
    launches = {f"{name}_red_forward": counts()}
    check(launches[f"{name}_red_forward"] == LAUNCHES_PER_FORWARD,
          f"{what} forward launches {launches[f'{name}_red_forward']}")
    depth = out["depth"]
    lo, hi = dvals[0].tolist()
    margin = sum(nd / 2 * iv for nd, iv in zip(NDEPTHS[1:], model.stage_intervals()[1:]))
    check(bool(torch.isfinite(depth).all()) and lo - margin - 1e-3 <= depth.min().item()
          and depth.max().item() <= hi + margin + 1e-3, f"{what} forward: depth range")
    del out, depth
    ms, peak = knob_timed(model, batch)
    ms8, peak8 = knob_timed(build_model("cuda"), batch)
    print(f"[widths] {what} forward at {HEIGHT}x{WIDTH}: launches a forward's "
          f"(exact); {ms:.2f} ms, peak_mem={peak:.3f} GiB; b={RED_BASE} in this phase {ms8:.2f} "
          f"ms, {peak8:.3f} GiB ({ms / ms8:.3f}x) card={card}", flush=True)
    h, w = WIDTH_HW
    cpu_model = build_model("cpu", cr_base_chs=base_chs)
    small = synthetic.make_batch(1, w, h, seed=1, device="cuda")
    with torch.no_grad():
        gpu_out = model(small["imgs"], small["cams"], small["depth_values"])
    gpu_vs_cpu("[widths]", f"{what} at {h}x{w}", gpu_out, cpu_model,
               small["imgs"], small["cams"], small["depth_values"])
    launches[f"{name}_red_stream"] = width_stream(
        card, model, cpu_model, synthetic.make_batch(2, w, h, seed=2, device="cuda"), what)
    del model, cpu_model
    cfg = Config(ndepths=NDEPTHS, cr_base_chs=base_chs)
    *_, step_launches, times, _, step_peak = run_train_steps(
        cfg, batch, WIDTH_STEPS, LAUNCHES_PER_TRAIN_STEP, what, card)
    launches[f"{name}_red_step"] = step_launches
    step_ms = float(np.median(times))
    print(f"[widths] {what} train step {step_ms:.2f} ms (median of "
          f"{WIDTH_STEPS}), peak_mem={step_peak:.3f} GiB; phase 7's b={RED_BASE} step "
          f"{default_step['ms']:.2f} ms, {default_step['peak']:.3f} GiB "
          f"({step_ms / default_step['ms']:.3f}x) card={card}", flush=True)
    phase_train_parity(card, f"{what} step", cr_base_chs=base_chs)
    return launches


def wide_recur_kernels(card: str) -> None:
    """Phase 16 (e), the kernels: red_recur and its backward at
    WIDE_RECUR_CASES, past the 4·256 state channels where a thread of the
    kernels' own-pixel passes walks more than one group of four channels
    (and keeps the GroupNorm parameter sums of its later groups in device
    memory): against the plain versions at phases 2 and 8's tolerances,
    the same bits in a second run, each element of the batched call against
    its B = 1 call; the plans; kernel, plain and bound ms of the timed
    cases."""
    from satmvs_tpu_torch.ops.kernels import red_recur as rr

    gen = torch.Generator(device="cuda").manual_seed(18)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def flat(res):
        return (res[0], *res[1])

    src = "satmvs_tpu_torch/csrc/red_recur.cu"
    for label, b, d, h, w, cin, c, seeded, timed in WIDE_RECUR_CASES:
        fwd = KernelReport("red_recur", src, "satmvs_tpu/ops/pallas/red_recur.py:259", card)
        bwd = KernelReport("red_recur_backward", src, "satmvs_tpu/ops/pallas/red_recur.py:755",
                           card)
        cell = red_cell(cin, c, 120 + c, randn)
        x = randn(b, d, h, w, cin)
        h0 = torch.tanh(randn(b, h, w, c)) if seeded else None
        tag = f"C={c} {label} B={b} {(d, h, w, cin)}->{c}{' h0' if seeded else ''}"
        nbytes, flops = recur_work(x, c, cell)
        with torch.no_grad():
            fwd.case(tag, lambda: rr.red_recur(x, cell, h0),
                     lambda: rr.red_recur_reference(x, cell, h0), lambda want: RED_RECUR_TOL,
                     nbytes, flops, timed=timed, reps=3)
            recur_same_bits(rr, tag, x, cell, h0)
            out = rr.red_recur(x, cell, h0)
            err = max((out[e] - rr.red_recur(x[e], cell, None if h0 is None else h0[e]))
                      .abs().max().item() for e in range(b)) if b > 1 else 0.0
        check(err <= RED_RECUR_TOL, f"red_recur {tag}: B vs B = 1 max abs err {err}")
        g = randn(*out.shape)
        bwd.case(tag + " backward", lambda: flat(rr.red_recur_backward(x, out, g, cell, h0)),
                 lambda: flat(rr.red_recur_backward_reference(x, out, g, cell, h0)),
                 lambda want: RED_BWD_TOL * max(1.0, want.abs().max().item()),
                 2 * nbytes + 4 * out.numel(), 3 * flops, timed=timed, reps=2)
        one, two = (flat(rr.red_recur_backward(x, out, g, cell, h0)) for _ in range(2))
        check(all(torch.equal(u, v) for u, v in zip(one, two)),
              f"red_recur_backward {tag}: a second run differs")
        plan = rr.red_recur_bwd_plan(b, h, w, cin, c, rr.resident())
        f, bk = fwd.record(), bwd.record()
        times = (f"forward {f['ms']:.4f} ms, plain {f['plain_ms']:.4f}, bound "
                 f"{f['bound_ms']:.4f} ({f['bound_by']}); backward {bk['ms']:.4f} ms, plain "
                 f"{bk['plain_ms']:.4f}, bound {bk['bound_ms']:.4f} ({bk['bound_by']}); "
                 if timed else "")
        print(f"[widths] (e) red_recur {tag} (run at {rr.padded_width(c)}, "
              f"{rr.own_pixel_lanes(c)} pixel a block pass, {plan['per_element']} blocks an "
              f"element): {times}max abs err forward {f['max_abs_err']:.3e} (tol "
              f"{RED_RECUR_TOL}), backward {bk['max_abs_err']:.3e} (tol {RED_BWD_TOL} × max(1, "
              f"|plain|)); the same bits twice; each element vs its B = 1 call {err:.3e} "
              f"card={card}", flush=True)
        del cell, x, h0, out, g, one, two
        torch.cuda.empty_cache()


def wide_blocks(card: str) -> None:
    """Phase 16 (c): conv3d_block and deconv3d_block at the 3-D blocks of a
    384×768 CostRegNet forward that read or write more than 64 channels at
    base widths WIDE_BLOCK_BASES (ConvBlock_5, ConvBlock_6, DeconvBlock_0 of
    each stage): against their plain versions (KERNEL_TOL), one launch a
    block, the same bits twice, kernel, bound, plain and cuDNN ms."""
    import torch.nn.functional as F

    from satmvs_tpu_torch.ops.kernels import conv3d_block as cb

    gen = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    src = "satmvs_tpu_torch/csrc/conv3d_block.cu"
    for base in WIDE_BLOCK_BASES:
        reps = {"conv3d_block": KernelReport("conv3d_block", src,
                                             "satmvs_tpu/ops/pallas/plane_conv.py:738,394", card),
                "deconv3d_block": KernelReport("deconv3d_block", src,
                                               "satmvs_tpu/ops/pallas/plane_conv.py:582", card)}
        for stage, block, op, n, h, w, ci, co in costreg_blocks(1, base):
            if max(ci, co) <= 64:
                continue
            d_in = 2 * n if op == "conv_dn" else n
            x = randn(1, d_in, h, w, ci).abs()
            scale, bias = (1.0 / (27 * ci)) ** 0.5, randn(co, scale=0.1)
            if op == "deconv_up":
                name, wt = "deconv3d_block", randn(ci, co, 3, 3, 3, scale=scale)
                skip = randn(1, 2 * n, 2 * h, 2 * w, co)
                kernel = lambda: cb.deconv3d_block(x, wt, bias, skip)  # noqa: E731
                plain = lambda: cb.deconv3d_block_reference(x, wt, bias, skip)  # noqa: E731
                library = lambda: F.conv_transpose3d(  # noqa: E731
                    x.permute(0, 4, 1, 2, 3), wt, bias, stride=2, padding=1, output_padding=1)
            else:
                name, wt = "conv3d_block", randn(co, ci, 3, 3, 3, scale=scale)
                stride = 2 if op == "conv_dn" else 1
                kernel = lambda: cb.conv3d_block(x, wt, bias, stride, True)  # noqa: E731
                plain = lambda: cb.conv3d_block_reference(x, wt, bias, stride, True)  # noqa: E731
                library = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), wt, bias,  # noqa: E731
                                           stride=stride, padding=1)
            label = f"b={base} {stage} {block} {tuple(x.shape)}->{co}"
            wrapper = cb.deconv3d_block if op == "deconv_up" else cb.conv3d_block
            with torch.no_grad():
                before = wrapper.launches
                one = kernel()
                check(wrapper.launches == before + 1, f"{name} {label}: launches")
                check(torch.equal(kernel(), one), f"{name} {label}: a second run differs")
                reps[name].case(label, kernel, plain, rel_tol,
                                *block_work(op, n, h, w, ci, co), library,
                                rate=TF32X3_FLOPS_PER_S)
            del x, one
        for name, rep in reps.items():
            r = rep.rec
            print(f"[widths] {name} at base {base}, its blocks past 64 channels: kernel "
                  f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({max(rep.by, key=rep.by.get)}), plain {r['plain_ms']:.4f} ms, cuDNN "
                  f"{r['library_ms']:.4f} ms, max abs err {r['max_abs_err']:.3e}, one launch a "
                  f"block, the same bits twice card={card}", flush=True)


def wide_costreg(card: str, name: str) -> dict:
    """Phase 16 (c), one family at cr_base_chs WIDE_COSTREG: a 384×768
    forward (exact launches: 24 conv3d_block, 9 deconv3d_block), ranges,
    its ms and peak memory beside the default width's, and GPU vs CPU at
    WIDTH_HW (phase 10's gates).  Returns the forward's launches."""
    from satmvs_tpu_torch.data import synthetic

    model = build_costreg_model(name, "cuda", cr_base_chs=WIDE_COSTREG)
    check(model.regs[0].convs[6].conv.weight.shape[0] == 8 * WIDE_COSTREG[0],
          f"wide {name}: the deepest block's width")
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    torch.cuda.synchronize()
    reset_counts()
    out = model(imgs, cams, dvals)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == LAUNCHES_PER_COSTREG_FORWARD, f"wide {name} forward launches {launches}")
    for i in range(1, 4):
        stage = out[f"stage{i}"]
        check(all(bool(torch.isfinite(v).all()) for v in stage.values()),
              f"wide {name} stage{i}: non-finite output")
        conf = stage["photometric_confidence"]
        check(0.0 <= conf.min().item() and conf.max().item() <= 1.0 + 1e-6,
              f"wide {name} stage{i}: confidence range")
    del out
    ms, peak = knob_timed(model, batch)
    ms8, peak8 = knob_timed(build_costreg_model(name, "cuda"), batch)
    print(f"[widths] {name} b={WIDE_COSTREG[0]} forward at {HEIGHT}x{WIDTH}: launches "
          f"{({k: v for k, v in launches.items() if v})} (exact); {ms:.2f} ms, peak_mem="
          f"{peak:.3f} GiB; b={COSTREG_BASE} in this phase {ms8:.2f} ms, {peak8:.3f} GiB "
          f"({ms / ms8:.3f}x) card={card}", flush=True)
    h, w = WIDTH_HW
    small = synthetic.make_batch(1, w, h, seed=1, device="cuda")
    with torch.no_grad():
        gpu_out = model(small["imgs"], small["cams"], small["depth_values"])
    gpu_vs_cpu("[widths]", f"{name} b={WIDE_COSTREG[0]} at {h}x{w}", gpu_out,
               build_costreg_model(name, "cpu", cr_base_chs=WIDE_COSTREG), small["imgs"],
               small["cams"], small["depth_values"])
    return launches


def remat_mesh_run(model: str, axis: str, batch: dict, mesh, remat: bool) -> dict:
    """Two train steps of `shard_config(model, axis)` from the config's seed
    at LeCun scale under `mesh` (this rank's share of batch), with remat or
    without, on cuDNN's deterministic engines.  Of the first: scalars, the
    old and new parameters and statistics, the launches, the regularizers'
    forwards (the recompute's included) and its ms; of the second (past a
    process's first checkpointed recompute, which costs seconds once, on
    the CPU too) its ms and peak memory."""
    from satmvs_tpu_torch.dist import replicate, shard_batch
    from satmvs_tpu_torch.train import create_model_and_state, make_train_step

    cfg = shard_config(model, axis)
    local = shard_batch(batch, mesh)
    net, state, tx = create_model_and_state(cfg, local, 1, mesh=mesh)
    lecun_scale(net)
    net.remat = remat
    replicate(state.to_dict(), mesh)
    old = state_copy(state)["params"]
    calls = []
    for reg in net.regs:
        reg.register_forward_pre_hook(lambda *a: calls.append(1))
    step = make_train_step(net, tx, cfg.dlossw, mesh)
    torch.cuda.synchronize()
    reset_counts()
    times = []
    for k in range(2):
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, scalars = step(state, local)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if k == 0:
            first = {"scalars": {k: v.item() for k, v in scalars.items()}, "old": old,
                     **state_copy(state), "launches": counts(), "reg_calls": len(calls)}
    return {**first, "ms": times, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def remat_rank(rank: int, init: str) -> None:
    """Phase 16 (d) on one of two ranks that share cuda:0 over gloo (a
    spawned process): each REMAT_MESH_RUNS run without remat and with it on
    the batch in REMAT_WORK/batch.pt; writes REMAT_WORK/rank<rank>.pt."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.distributed as dist

    from satmvs_tpu_torch.dist import init_multihost, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    init_multihost(f"file://{init}", SHARD_RANKS, rank, backend="gloo", device="cuda:0")
    try:
        batch = torch.load(REMAT_WORK / "batch.pt", weights_only=False)
        out = {}
        for model, axis in REMAT_MESH_RUNS:
            shape = (1, SHARD_RANKS, 1) if axis == "spatial" else (1, 1, SHARD_RANKS)
            mesh = make_mesh(*shape, device="cuda:0")
            for remat in (False, True):
                out[(model, axis, remat)] = remat_mesh_run(model, axis, batch, mesh, remat)
                torch.cuda.empty_cache()
        torch.save(out, REMAT_WORK / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def remat_mesh(card: str) -> dict:
    """Phase 16 (d): remat on two gloo ranks sharing the card, CasMVS under
    mesh_depth 2 (the CostRegNet's train-mode BatchNorms over the mesh and
    its depth halos inside the checkpoint) and RED under mesh_spatial 2
    (the fused pipeline after its row gather), each one 384×768 step
    against the same mesh without remat: the loss (the forward is the
    same: 1e-6 relative), the update and the running statistics within
    DP1_UPDATE_TOL (the scatter's float atomics), the regularizers run
    again in the backward, exact launches a rank (RED's forward kernels
    twice), the replicas the same bits; a second step's ms and peak memory
    a rank.
    Returns rank 0's remat launches by path."""
    import multiprocessing
    import shutil

    from satmvs_tpu_torch.data import synthetic

    shutil.rmtree(REMAT_WORK, ignore_errors=True)
    REMAT_WORK.mkdir(parents=True)
    torch.save(synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cpu"),
               REMAT_WORK / "batch.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=remat_rank, args=(r, str(REMAT_WORK / "init")))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    try:
        deadline = time.time() + 600
        for p in procs:
            p.join(max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"a remat rank failed: exit codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(REMAT_WORK / f"rank{r}.pt", weights_only=False)
             for r in range(SHARD_RANKS)]
    launches = {}
    remat_launches = {"red": LAUNCHES_PER_REMAT_STEP, "casmvs": LAUNCHES_PER_COSTREG_TRAIN_STEP}
    for model, axis in REMAT_MESH_RUNS:
        for r, rank in enumerate(ranks):
            plain, remat = rank[(model, axis, False)], rank[(model, axis, True)]
            tag = f"{model} mesh_{axis} {SHARD_RANKS} rank {r}"
            loss = abs(remat["scalars"]["loss"] - plain["scalars"]["loss"]) / abs(
                plain["scalars"]["loss"])
            spread = update_spread(remat, plain, plain["old"])
            stats = max((remat["stats"][k] - v).abs().max().item() / v.abs().max().item()
                        for k, v in plain["stats"].items())
            bits = all(torch.equal(remat["params"][k], v) for k, v in plain["params"].items())
            print(f"[widths] remat {tag}: loss {loss:.3e} relative to the step without (tol "
                  f"1e-6), update {spread:.3e} over all (tol {DP1_UPDATE_TOL}; the same bits: "
                  f"{bits}), running statistics {stats:.3e} (tol {DP1_UPDATE_TOL}); "
                  f"regularizer forwards {remat['reg_calls']} against {plain['reg_calls']}; "
                  f"second step {remat['ms'][1]:.2f} ms against {plain['ms'][1]:.2f} "
                  f"({remat['ms'][1] / plain['ms'][1]:.3f}x; first {remat['ms'][0]:.2f} against "
                  f"{plain['ms'][0]:.2f}; CUDA events, two processes on one card); its peak_mem "
                  f"{remat['peak_gib']:.3f} GiB against {plain['peak_gib']:.3f} GiB "
                  f"({remat['peak_gib'] - plain['peak_gib']:+.3f}) card={card}", flush=True)
            check(loss <= 1e-6 and spread <= DP1_UPDATE_TOL and stats <= DP1_UPDATE_TOL,
                  f"remat {tag}: against the step without")
            check(remat["reg_calls"] == 2 * plain["reg_calls"] > 0,
                  f"remat {tag}: the regularizers ran {remat['reg_calls']} times")
            check(plain["launches"] == SHARD_LAUNCHES_TRAIN[model]
                  and remat["launches"] == remat_launches[model],
                  f"remat {tag}: launches {plain['launches']}, {remat['launches']}")
        r0, r1 = (rank[(model, axis, True)] for rank in ranks)
        check(r0["scalars"] == r1["scalars"]
              and all(torch.equal(v, r1["params"][k]) for k, v in r0["params"].items()),
              f"remat {model} mesh_{axis}: the replicas differ")
        launches[f"remat_{model}_{axis}"] = r0["launches"]
    return launches


def phase_widths(card: str, default_step: dict) -> dict:
    """Phase 16: (a)-(e) above; returns the launches of the new paths."""
    t0, launches, took = time.time(), {}, {}
    parts = (("a", lambda: width_recur_kernels(card)),
             ("b", lambda: red_at_width(card, default_step, NARROW_RED, "narrow")),
             ("c", lambda: (wide_blocks(card),
                            {f"wide_{n}": wide_costreg(card, n) for n in COSTREG_FAMILIES})[1]),
             ("d", lambda: remat_mesh(card)),
             ("e", lambda: (wide_recur_kernels(card),
                            red_at_width(card, default_step, WIDE_RED, "wide"))[1]))
    for part, run_part in parts:
        t1 = time.time()
        launches.update(run_part() or {})
        torch.cuda.empty_cache()
        took[part] = round(time.time() - t1, 1)
    print(f"[widths] phase 16 took {time.time() - t0:.1f} s ({took} s by part)", flush=True)
    return launches


# ---- phase 17: the one-stage cascade (`--ndepths 64`): stage 1 alone, at 1/4
# resolution, the top-level maps stage 1's; its kernels run as in stage 1 of
# a three-stage forward.  Training, evaluation and the scene refuse it, as
# JAX fails there (`models/losses.py`, `infer/scene.py`).
ONE_STAGE = (64,)
ONE_STAGE_GRAD_HW = (96, 192)  # the differentiable check, card against CPU
ONE_STAGE_SCENE = 128          # the scene refusal: four 64² tiles
LAUNCHES_PER_ONE_STAGE_FORWARD = {**{k: 0 for k in LAUNCHES_PER_FORWARD}, "sweep_variance": 1,
                                  "conv_dn": 3, "red_recur": 4, "deconv_up": 3, "conv_head": 1}
LAUNCHES_PER_ONE_STAGE_COSTREG = {**{k: 0 for k in LAUNCHES_PER_FORWARD}, "sweep_variance": 1,
                                  "conv3d_block": 8, "deconv3d_block": 3}
# streamed at slab 8: each of the 8 slabs a forward's stage-1 kernels
LAUNCHES_PER_ONE_STAGE_STREAM = {k: ONE_STAGE[0] // SLAB * n
                                 for k, n in LAUNCHES_PER_ONE_STAGE_FORWARD.items()}
# forward and backward under autograd: the per-view sweep (2 source views),
# the RED kernels, their backward kernels and 3 + 3 + 1 + 8 weight reductions
LAUNCHES_PER_ONE_STAGE_GRAD = {**LAUNCHES_PER_ONE_STAGE_FORWARD, "sweep_variance": 0,
                               "sweep_gather": 2, "sweep_scatter": 2, "conv_dn_backward": 3,
                               "red_recur_backward": 4, "deconv_up_backward": 3,
                               "conv_head_backward": 1, "wgrad3x3": 15}
ONE_STAGE_FORWARD_PATHS = ("one_stage_red", "one_stage_stream", "one_stage_cli")
ONE_STAGE_COSTREG_PATHS = ("one_stage_casmvs", "one_stage_ucs")
ONE_STAGE_TRAIN_PATHS = ("one_stage_grad",)


def one_stage_forward(card: str, name: str, batch: dict, batch3: dict) -> dict:
    """Phase 17 (a), one family at ndepths ONE_STAGE on phase 3's triplet
    (`batch`; `batch3` the same with three stages' cameras): exact launches,
    the outputs' keys, shape and range, the plain run on the CPU (depth and
    confidence gates), its ms and peak memory beside the three-stage
    forward's in this phase; for RED also the streamed forward at slab 8
    (exact launches) against it.  Returns the launches of each path."""
    from satmvs_tpu_torch.infer.predict import streaming_red_forward

    def family(device, ndepths):
        return (build_model(device, ndepths=ndepths) if name == "red" else
                build_costreg_model(name, device, ndepths=ndepths))

    model = family("cuda", ONE_STAGE)
    imgs, cams, dvals = batch["imgs"], batch["cams"], batch["depth_values"]
    want = LAUNCHES_PER_ONE_STAGE_FORWARD if name == "red" else LAUNCHES_PER_ONE_STAGE_COSTREG
    torch.cuda.synchronize()
    reset_counts()
    out = model(imgs, cams, dvals)
    torch.cuda.synchronize()
    launches = {f"one_stage_{name}": counts()}
    check(launches[f"one_stage_{name}"] == want,
          f"one-stage {name} forward launches {launches[f'one_stage_{name}']}")
    keys = ["depth", "photometric_confidence", "stage1"] + (["variance"] if name == "ucs" else [])
    check(sorted(out) == sorted(keys), f"one-stage {name} outputs {sorted(out)}")
    depth, conf = out["depth"], out["photometric_confidence"]
    lo, hi = dvals[0].tolist()
    check(tuple(depth.shape) == (1, HEIGHT // 4, WIDTH // 4) and bool(torch.isfinite(depth).all())
          and torch.equal(depth, out["stage1"]["depth"]), f"one-stage {name} depth")
    dmin, dmax = depth.min().item(), depth.max().item()
    cmin, cmax = conf.min().item(), conf.max().item()
    check(lo - 1e-3 <= dmin and dmax <= hi + 1e-3 and 0.0 <= cmin and cmax <= 1.0 + 1e-6,
          f"one-stage {name}: depth [{dmin}, {dmax}], confidence [{cmin}, {cmax}]")
    print(f"[one stage] {name} forward at {HEIGHT}x{WIDTH}, ndepths {ONE_STAGE}: launches "
          f"{({k: v for k, v in want.items() if v})} (exact), depth {tuple(depth.shape)} in "
          f"[{dmin:.2f}, {dmax:.2f}] m (range {lo:.0f}..{hi:.0f}), conf [{cmin:.4f}, "
          f"{cmax:.4f}]", flush=True)
    t0 = time.time()
    gpu_vs_cpu("[one stage]", f"{name} at {HEIGHT}x{WIDTH}", out, family("cpu", ONE_STAGE), imgs,
               cams, dvals, gate_conf=True)
    print(f"[one stage] {name} CPU plain run took {time.time() - t0:.1f} s", flush=True)
    if name == "red":
        torch.cuda.synchronize()
        reset_counts()
        stream = streaming_red_forward(model, imgs, cams, dvals, slab=SLAB)
        torch.cuda.synchronize()
        launches["one_stage_stream"] = counts()
        check(launches["one_stage_stream"] == LAUNCHES_PER_ONE_STAGE_STREAM,
              f"one-stage streaming launches {launches['one_stage_stream']}")
        step = (hi - lo) / (ONE_STAGE[0] - 1)
        mean, p99, mx = err_quantiles((stream["depth"] - depth).abs() / step)
        cerr = (stream["photometric_confidence"] - conf).abs().max().item()
        print(f"[one stage] red streamed at slab {SLAB}: launches "
              f"{({k: v for k, v in LAUNCHES_PER_ONE_STAGE_STREAM.items() if v})} (exact); "
              f"against the full volume depth err mean {mean:.3e}, p99 {p99:.3e}, max {mx:.3e} "
              f"of step (tol mean {DEPTH_TOL_MEAN}, p99 {DEPTH_TOL_P99}), conf err max "
              f"{cerr:.3e}", flush=True)
        check(mean <= DEPTH_TOL_MEAN and p99 <= DEPTH_TOL_P99,
              f"one-stage streaming vs full: depth err mean {mean}, p99 {p99} of step")
        s_ms = time_ms(lambda: streaming_red_forward(model, imgs, cams, dvals, slab=SLAB),
                       reps=5, warmup=1)
        print(f"[one stage] red streamed forward {s_ms:.2f} ms (median of 5, CUDA events) "
              f"card={card}", flush=True)
        del stream
    del out, depth, conf
    ms1, peak1 = knob_timed(model, batch)
    del model
    ms3, peak3 = knob_timed(family("cuda", NDEPTHS), batch3)
    print(f"[one stage] {name} forward at {HEIGHT}x{WIDTH}: ndepths {ONE_STAGE} {ms1:.2f} ms, "
          f"peak_mem={peak1:.3f} GiB; ndepths {NDEPTHS} in this phase {ms3:.2f} ms, "
          f"{peak3:.3f} GiB ({ms1 / ms3:.3f}x) card={card}", flush=True)
    return launches


def one_stage_grad(card: str) -> dict:
    """Phase 17 (b): CascadeREDNet at ndepths ONE_STAGE, one differentiable
    forward (eval mode) and its backward at ONE_STAGE_GRAD_HW on the card and
    on the CPU from the same weights (seed 5, LeCun scale) and batch, with
    stage-scale ground truth (the full-resolution map at every fourth
    pixel): the loss and eval-mode gradients at phase 7's gates, exact
    launches on the card.  Returns them."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models import CascadeREDNet
    from satmvs_tpu_torch.models.losses import cascade_loss

    h, w = ONE_STAGE_GRAD_HW
    cpu_batch = synthetic.make_batch(1, w, h, seed=1, device="cpu", num_stage=1)
    runs = {}
    for dev in ("cuda", "cpu"):
        batch = batch_to(cpu_batch, dev)
        model = lecun_scale(CascadeREDNet(ndepths=ONE_STAGE, device=dev, seed=5))
        params = dict(model.named_parameters())
        gt = batch["depth_stages"][0][:, ::4, ::4]

        def loss_and_grads():
            with torch.enable_grad():
                out = model.run_cascade(batch["imgs"], batch["cams"], batch["depth_values"],
                                        False)
                loss = cascade_loss(out, [gt], [torch.ones_like(gt)])[0]
                return loss, torch.autograd.grad(loss, list(params.values()))

        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts()
        loss, grads = loss_and_grads()
        runs[dev] = {"loss": loss.item(), "grads": {n: g.cpu() for n, g in zip(params, grads)}}
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = counts()
            ms = time_ms(loss_and_grads, reps=3, warmup=1)
    check(launches == LAUNCHES_PER_ONE_STAGE_GRAD, f"one-stage RED gradient launches {launches}")
    gpu, cpu = runs["cuda"], runs["cpu"]
    rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    scale = max(g.abs().max().item() for g in cpu["grads"].values())
    worst, head, num, den, worst_name = 0.0, 0.0, 0.0, 0.0, ""
    for n, g in gpu["grads"].items():
        diff = (g - cpu["grads"][n]).norm().item()
        if n.endswith("head.bias"):
            head = max(head, diff / scale)
        else:
            worst, worst_name = max((worst, worst_name), (diff / cpu["grads"][n].norm().item(), n))
            num += diff ** 2
            den += cpu["grads"][n].norm().item() ** 2
    total = (num / den) ** 0.5
    print(f"[one stage] RED forward + backward at {h}x{w}, ndepths {ONE_STAGE}, stage-scale ground "
          f"truth: launches {({k: v for k, v in launches.items() if v})} (exact); {ms:.2f} ms "
          f"(median of 3, CUDA events) card={card}", flush=True)
    print(f"[one stage] GPU vs CPU: loss {gpu['loss']:.6f} vs {cpu['loss']:.6f}, {rel:.3e} "
          f"relative (tol {PARITY_LOSS}); eval-mode gradients max relative norm {worst:.3e} over "
          f"{len(gpu['grads'])} tensors ({worst_name}; tol {PARITY_GRAD}), {total:.3e} over all "
          f"(tol {PARITY_GRAD_ALL}), head biases {head:.3e} of the largest element (tol "
          f"{PARITY_HEAD})", flush=True)
    check(rel <= PARITY_LOSS, f"one-stage RED loss {rel} relative")
    check(worst <= PARITY_GRAD and total <= PARITY_GRAD_ALL and head <= PARITY_HEAD,
          "one-stage RED eval-mode gradients")
    return launches


def one_stage_cli(card: str, tree: str) -> dict:
    """Phase 17 (c): `cli.predict --ndepths 64` from a one-stage port
    checkpoint of `build_model(ndepths=ONE_STAGE)` on a copy of phase 9's
    test split: exact launches (a one-stage forward for each view), maps at
    1/4 resolution, the bits of a direct forward of the restored model.
    Returns its launches."""
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

    cfg = Config(ndepths=ONE_STAGE)
    ckpt = WORK / "one_stage_ckpt"
    save_checkpoint(str(ckpt), 1, state_of(build_model("cuda", ndepths=ONE_STAGE),
                                           make_optimizer(cfg, 1)))
    copy = WORK / "test_one_stage"
    shutil.copytree(os.path.join(tree, "open_dataset_rpc", "test"), copy,
                    ignore=shutil.ignore_patterns("mvs_results", "height_result"))
    reset_counts()
    t0 = time.perf_counter()
    out = cli_predict.main([f"--dataset_root={copy}", f"--loadckpt={ckpt}", "--ndepths", "64"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = {k: 3 * TREE_TEST * v for k, v in LAUNCHES_PER_ONE_STAGE_FORWARD.items()}
    check(launches == want, f"cli.predict --ndepths 64: launches {launches}")
    model, _, _ = restore_model(cfg, str(ckpt), torch.device("cuda"))
    n_maps = 0
    for batch in Loader(MVSDataset(str(copy), "pred", num_stage=1), 1, device="cuda"):
        ref = model(batch["imgs"], batch["cams"], batch["depth_values"])
        view, block = batch["out_view"][0], batch["out_name"][0]
        for sub, key in (("init", "depth"), ("prob", "photometric_confidence")):
            got = formats.load_pfm(str(copy / "mvs_results" / view / sub / f"{block}.pfm"))
            check(got.shape == (HEIGHT // 4, WIDTH // 4) and
                  np.array_equal(got, ref[key][0].cpu().numpy()),
                  f"cli.predict --ndepths 64 {view} {block} {sub}: not a direct forward")
            n_maps += 1
    print(f"[one stage] cli.predict --ndepths 64: {wall:.2f} s wall, forwards "
          f"{[round(1e3 * t, 2) for t in out['forward_s']]} ms, launches "
          f"{({k: v for k, v in launches.items() if v})} (exact); {n_maps} maps of "
          f"{HEIGHT // 4}x{WIDTH // 4}, the bits of a direct forward card={card}", flush=True)
    return launches


def refused(what: str, fn, words: str) -> None:
    """fn() must raise ValueError naming `words` (phase 17's refusals)."""
    try:
        fn()
    except ValueError as e:
        check(words in str(e), f"{what}: refused without naming {words!r}: {e}")
        print(f"[one stage] {what} refused on the card: {str(e)[:160]}", flush=True)
        return
    raise RuntimeError(f"check failed: {what} ran where JAX fails")


def one_stage_refusals() -> None:
    """Phase 17 (d): on the card, as on the CPU (`tests/test_torch_one_stage.py`):
    two stages, the one-stage train and eval steps on the dataset's
    full-resolution ground truth, and `predict_scene` at one stage."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.infer.scene import predict_scene
    from satmvs_tpu_torch.train import (Config, create_model_and_state, make_eval_step,
                                        make_train_step)

    refused("ndepths (64, 32)", lambda: build_model("cuda", ndepths=(64, 32)), "STAGE_SCALES")
    h, w = ONE_STAGE_GRAD_HW
    batch = synthetic.make_batch(1, w, h, seed=1, device="cuda", num_stage=1)
    cfg = Config(ndepths=ONE_STAGE)
    model, state, tx = create_model_and_state(cfg, batch, 1)
    refused("the one-stage train step", lambda: make_train_step(model, tx, cfg.dlossw)(
        state, batch), "build_pyramid")
    refused("the one-stage eval step", lambda: make_eval_step(model, cfg.dlossw, cfg.min_interval)(
        state, batch), "build_pyramid")
    scene = synthetic.make_scene(ONE_STAGE_SCENE, ONE_STAGE_SCENE, seed=2, h_amp=40.0)
    order = [2, 0, 1]
    refused("predict_scene(num_stage=1)", lambda: predict_scene(
        model, scene["images"][order], scene["rpcs"][order], tile=64, halo=0, device="cuda",
        num_stage=1), "1/4 of the tile")


def phase_one_stage(card: str, tree: str) -> dict:
    """Phase 17: (a)-(d) above; returns the launches of the new paths."""
    from satmvs_tpu_torch.data import synthetic

    t0, launches, took = time.time(), {}, {}
    batch = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda", num_stage=1)
    batch3 = synthetic.make_batch(1, WIDTH, HEIGHT, seed=0, device="cuda")
    parts = (("a", lambda: {k: v for name in ("red", *COSTREG_FAMILIES)
                            for k, v in one_stage_forward(card, name, batch, batch3).items()}),
             ("b", lambda: {"one_stage_grad": one_stage_grad(card)}),
             ("c", lambda: {"one_stage_cli": one_stage_cli(card, tree)}),
             ("d", one_stage_refusals))
    for part, run_part in parts:
        t1 = time.time()
        launches.update(run_part() or {})
        torch.cuda.empty_cache()
        took[part] = round(time.time() - t1, 1)
    print(f"[one stage] phase 17 took {time.time() - t0:.1f} s ({took} s by part)", flush=True)
    return launches


# device totals of the profiles phase 15 (d) holds the profile CLI to
PROFILED = {}


def profile_forward(fn, card: str, top: int = 8, what: str = "one forward") -> dict:
    """Device time by kernel over one call of fn (torch.profiler), the share
    of its wall time the device was busy and the cost map's pools: the
    profile CLI's own trace and aggregation (`cli.profile_forward`).
    Returns its aggregate with "wall_ms"; the total is kept in PROFILED
    under `what`."""
    from satmvs_tpu_torch.cli.profile_forward import aggregate, trace_calls

    prof, wall_us = trace_calls(fn, 1)
    res = aggregate(prof, top=top)
    busy_us = 1e3 * res["total_ms"]
    print(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms (profiler on), device busy "
          f"{busy_us / 1e3:.2f} ms = {busy_us / wall_us:.3f} of wall, {res['count']:.0f} device "
          f"kernels/copies card={card}", flush=True)
    for name, ms, n in res["top"]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<5.0f} {name[:90]}", flush=True)
    print("[profile]   pools: " + ", ".join(f"{pool} {ms:.3f} ms x{n:.0f}"
                                            for pool, (ms, n) in res["pools"].items()), flush=True)
    PROFILED[what] = res["total_ms"]
    return {**res, "wall_ms": wall_us / 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import multiprocessing
    import shutil

    shutil.rmtree(WORK, ignore_errors=True)
    # the workers render phase 3's batches, the scene and phase 9's tree
    # while phases 1-3 run; leaving the block stops them
    with ProcessPoolExecutor(2 + len(AHEAD_SCENES),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return run(pool.submit(render_scene), pool.submit(render_tree, str(WORK / "whu_tlc")),
                   lambda: {key: pool.submit(render_scene, key) for key in AHEAD_SCENES})


def took(tag: str, phase: str, t0: float) -> None:
    """Prints the seconds since t0 that a phase took."""
    print(f"{tag} phase {phase} took {time.time() - t0:.1f} s", flush=True)


def run(scene_job, tree_job, render_ahead) -> int:
    from satmvs_tpu_torch.ops.kernels import build

    # phase 0
    ahead = {}  # filled after phase 1, whose nvcc processes want the cores
    memo_scenes(ahead)
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
    spills = {}  # plane-conv, sweep and conv3d_block instance → bytes of spill stores
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
                                        "sweep_variance_groups_kernel",
                                        "sweep_variance_backward_kernel",
                                        "sweep_variance_backward_groups_kernel",
                                        "conv3d_block_kernel", "sweep_gather_bf16_kernel",
                                        "sweep_scatter_bf16_kernel")):
                spills[kernel] = int(m.group(1))
    if spills:  # built in this run: these instances must not spill
        print(f"[build] {len(spills)} instances of conv3x3_kernel, deconv3x3_s2_kernel, "
              f"sweep_variance_kernel, sweep_variance_groups_kernel, "
              f"sweep_variance_backward_kernel, sweep_variance_backward_groups_kernel, "
              f"conv3d_block_kernel, sweep_gather_bf16_kernel and sweep_scatter_bf16_kernel, "
              f"{sum(spills.values())} bytes of spill", flush=True)
        check(not any(spills.values()), f"an instance spills: {spills}")
    took("[build]", "1", t0)
    ahead.update(render_ahead())

    # phases 2, 2c, 2b, 6, 11 (c), 8 and 3
    t0 = time.time()
    sweep, dn, rec, up, head = phase_sweep(smi), *phase_red_kernels(smi)
    took("[kernels]", "2", t0)
    t0 = time.time()
    phase_many_views(smi)
    took("[views]", "2c", t0)
    t0 = time.time()
    records = [*sweep, dn, rec, phase_batched_red(smi), up, head]
    took("[batched]", "2b", t0)
    t0 = time.time()
    records += phase_sweep_gather(smi)
    took("[kernels]", "6", t0)
    t0 = time.time()
    records += phase_sweep_train_kernels(smi)
    took("[sweeps]", "11 (c)", t0)
    t0 = time.time()
    records += phase_red_backward(smi)
    took("[kernels]", "8", t0)
    t0 = time.time()
    launches = {"forward": phase_slice(smi)}
    took("[slice]", "3", t0)

    # phase 5, then phase 4 on phase 5's first chunk
    t0 = time.time()
    scene = scene_job.result()
    print(f"[scene] {SCENE_SIZE}x{SCENE_SIZE} triplet rendered on the host (waited "
          f"{time.time() - t0:.1f} s for it after phase 3)", flush=True)
    model = build_model("cuda")
    scene_launches, chunk, scene_ref = phase_scene(smi, model, scene)
    launches.update(scene_launches)
    launches["streaming"] = phase_stream_vs_full(smi, model, chunk)
    scene_files = write_scene_files(scene, WORK / "scene")
    scene_gt = str(WORK / "scene" / "gt_view2.npy")  # phase 15 (c) scores the fusion with it
    np.save(scene_gt, scene["gt_heights"][2])
    del model, chunk, scene
    took("[scene]", "5 and 4", t0)

    # phase 7
    t0 = time.time()
    train_launches, default_step = phase_train(smi)
    launches.update(train_launches)
    took("[train]", "7", t0)

    # phase 9
    t0 = time.time()
    tree = tree_job.result()
    print(f"[disk] {TREE_TRAIN} + {TREE_TEST} blocks of 3 {HEIGHT}x{WIDTH} views written "
          f"(waited {time.time() - t0:.1f} s for them after phase 7)", flush=True)
    launches.update(phase_from_disk(smi, tree, scene_files))
    took("[disk]", "9", t0)

    # phase 10
    t0 = time.time()
    records += phase_costreg_kernels(smi)
    for name in COSTREG_FAMILIES:
        launches[name] = costreg_forward(smi, name)
    launches["cli_predict_ucs"] = costreg_cli(smi, tree)
    print(f"[costreg] phase 10 took {time.time() - t0:.1f} s", flush=True)

    # phase 11
    launches.update(phase_training_sweeps(smi, tree, default_step))

    # phase 12
    launches.update(phase_cameras(smi, tree, default_step))

    # phase 13
    launches.update(phase_multi_gpu(smi, tree, scene_ref))

    # phase 14
    knobs = phase_knobs(smi, tree, default_step)
    check(not set(knobs) & set(launches), f"phase 14 reuses path names: {sorted(knobs)}")
    launches.update(knobs)

    # phase 15
    tools = phase_tools(smi, scene_files, scene_gt)
    check(not set(tools) & set(launches), f"phase 15 reuses path names: {sorted(tools)}")
    launches.update(tools)

    # phase 16
    widths = phase_widths(smi, default_step)
    check(not set(widths) & set(launches), f"phase 16 reuses path names: {sorted(widths)}")
    launches.update(widths)

    # phase 17
    one_stage = phase_one_stage(smi, tree)
    check(not set(one_stage) & set(launches), f"phase 17 reuses path names: {sorted(one_stage)}")
    launches.update(one_stage)

    for record in records:
        # a batched record is the same wrapper, read on the path that batches
        batched = record["name"].endswith("_batched")
        wrapper = record["name"].removesuffix("_batched")
        costreg = wrapper in COSTREG_KERNELS
        record["launches_by_path"] = {path: n[wrapper] for path, n in launches.items()}
        train = wrapper in TRAIN_KERNELS
        main = (SWEEP_TRAIN_PATHS[wrapper][0] if wrapper in SWEEP_TRAIN_PATHS else
                "casmvs" if costreg else "train_step" if train else
                f"scene_b{BATCH_TILES}" if batched else "forward")
        record["launches"] = launches[main][wrapper]
        shard_costreg = tuple(p for p in SHARD_EVAL_PATHS if p not in SHARD_RED_PATHS)
        shard_train = (SHARD_STEP_PATHS if wrapper in ("sweep_gather", "sweep_scatter") else
                       SHARD_RED_PATHS[:1])
        paths = (SWEEP_TRAIN_PATHS[wrapper] if wrapper in SWEEP_TRAIN_PATHS else
                 COSTREG_PATHS + CAMERA_COSTREG_PATHS + shard_costreg + WIDTH_COSTREG_PATHS
                 + ONE_STAGE_COSTREG_PATHS if costreg else
                 ("train_step", "cli_train", *FP32_SWEEP_PATHS.get(wrapper, ()),
                  *CAMERA_TRAIN_PATHS, *DP_PATHS, *shard_train, *KNOB_TRAIN_PATHS,
                  *TOOL_TRAIN_PATHS, *WIDTH_TRAIN_PATHS, *ONE_STAGE_TRAIN_PATHS,
                  *(KNOB_SWEEP_PATHS + TOOL_SWEEP_PATHS + WIDTH_SWEEP_PATHS
                    if wrapper in ("sweep_gather", "sweep_scatter") else ()))
                 if train else (
                     INFERENCE_PATHS + CLI_PATHS + CAMERA_FORWARD_PATHS + ("dp_scene",)
                     + KNOB_FORWARD_PATHS + TOOL_FORWARD_PATHS + WIDTH_FORWARD_PATHS
                     + ONE_STAGE_FORWARD_PATHS + (
                         ("eval_step", "fused_sweep_step", *SHARD_EVAL_PATHS,
                          "compute_bf16_casmvs", *WIDTH_COSTREG_PATHS, *ONE_STAGE_COSTREG_PATHS)
                         if wrapper == "sweep_variance" else
                         ("train_step", "eval_step", *CAMERA_TRAIN_PATHS, *DP_PATHS,
                          *SHARD_RED_PATHS, *KNOB_TRAIN_PATHS, *TOOL_TRAIN_PATHS,
                          *WIDTH_TRAIN_PATHS, *ONE_STAGE_TRAIN_PATHS)
                         if wrapper in RED_FORWARD_KERNELS else ())))
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
