#!/usr/bin/env python3
"""Build variants of the fused sweep's VJP kernel (csrc/sweep_variance.cu,
`sweep_variance_backward_kernel` and `sweep_variance_backward_groups_kernel`)
and time each on one CUDA device, in turns within one process, at the three
stage shapes of a 384×768 train step (B = 1, S = 2, chip_smoke.py's
`sweep_inputs`, seed 11).

    python3 sweep_vjp_variants.py [--rounds N] [--reps N]

Each variant is a text substitution of the source as it stands, built with
the port's nvcc flags into build/vjp_variants/:

  as_built  the source unchanged;
  bounds_2  __launch_bounds__(256, 2) on both backward kernels (at most 128
            registers a thread, two blocks an SM) in place of (256, 1);
  no_keep   no view keeps its corner values from plane to plane (each
            plane loads its four corners again);
  no_carry  no column carry: every move of a floor corner adds all four of
            its corner sums (the fp32 scatter's runs of planes).

Prints every backward instance's registers and spills (ptxas -v), then for
each round and variant the device time of the kernel summed over the three
stages (torch.profiler, chip_smoke.device_ms) and its greatest error against
the plain VJP, and last one JSON line {variant: [ms of each round]}.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
BOUNDS = "__global__ void __launch_bounds__(kMaxThreads, {}) sweep_variance_backward{}_kernel("
VARIANTS = {
    "as_built": [],
    "bounds_2": [(BOUNDS.format(1, k), BOUNDS.format(2, k)) for k in ("", "_groups")],
    "no_keep": [("constexpr int kKeptViews = 2;", "constexpr int kKeptViews = 0;")],
    "no_carry": [("  if (t.y0 == v.y0 && t.x0 == v.x0 + 1) {",
                  "  if (false && t.y0 == v.y0 && t.x0 == v.x0 + 1) {"),
                 ("  } else if (t.y0 == v.y0 && t.x0 == v.x0 - 1) {",
                  "  } else if (false && t.y0 == v.y0 && t.x0 == v.x0 - 1) {")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2, help="turns over all variants")
    ap.add_argument("--reps", type=int, default=10, help="profiled calls a stage")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_vjp_variants: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from satmvs_tpu_torch.ops.kernels import build
    from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[variants] card: {card}", flush=True)

    src = (build.CSRC / "sweep_variance.cu").read_text()
    out = HERE / "build" / "vjp_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bilinear.cuh").write_text((build.CSRC / "bilinear.cuh").read_text())
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
               str(out / f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    fns = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        kernel = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = cs.kernel_instance(line.split()[-1])
            if kernel.startswith("sweep_variance_backward") and ("registers" in line
                                                                 or "spill" in line):
                print(f"[variants] {name} {kernel}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).sweep_variance_backward_f32
        fn.argtypes = sv._c_bwd().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for i in range(3):
        h, w = cs.HEIGHT // cs.STAGE_SCALES[i], cs.WIDTH // cs.STAGE_SCALES[i]
        feats, xs, ys = cs.sweep_inputs(i, 1, h, w, gen)
        g = torch.randn((1, cs.NDEPTHS[i], h, w, cs.FEAT_CH[i]), generator=gen, device="cuda")
        cases.append((feats, xs, ys, g, sv.sweep_variance_backward_reference(feats, xs, ys, g)))
    built = sv._c_bwd
    times = {name: [] for name in fns}
    try:
        for rnd in range(args.rounds):
            for name, fn in fns.items():
                sv._c_bwd = lambda fn=fn: fn  # the wrapper launches this variant's entry
                total, err = 0.0, 0.0
                for feats, xs, ys, g, want in cases:
                    got = sv.sweep_variance_backward(feats, xs, ys, g)
                    err = max([err] + [(a - b).abs().max().item() for a, b in zip(got, want)])
                    total += cs.device_ms(lambda: sv.sweep_variance_backward(feats, xs, ys, g),
                                          "sweep_variance_backward", args.reps)
                times[name].append(total)
                print(f"[variants] round {rnd} {name}: device {total:.4f} ms over the 3 stages, "
                      f"max abs err against the plain VJP {err:.3e} card={card}", flush=True)
    finally:
        sv._c_bwd = built
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
