"""Trace-driven profiling of the model's forward or train step: the twin of
scripts/profile_forward.py.

    python -m satmvs_tpu_torch.cli.profile_forward [--model red|casmvs|ucs] \
        [--size 384x768] [--ndepths 64,32,8] [--iters 3] [--trace_dir DIR] [--train]

After one warm-up call it traces `iters` forwards (B = 1, a seeded
synthetic batch, seeded weights) or, with --train, `iters` train steps
(`train.loop.make_train_step` on Config()'s defaults for the model) under
`torch.profiler`, writes the Chrome trace to <trace_dir>/trace.json, and
prints the device total a call, a cost map and the top ops.  On the card
the events are the CUDA kernels, copies and memsets (their own device
time); under SATMVS_PLATFORM=cpu they are the operators' own CPU time.
The cost map's pools replace the JAX script's XLA pools with the port's
(`bucket`): the hand-written sweep kernels (`sweep_variance*`,
`sweep_gather*`, `sweep_scatter*`), the hand-written regularizer kernels
(`red_recur*`, `conv3x3_kernel`, `deconv3x3_s2_kernel`, `wgrad3x3`'s
`wgrad_partial_kernel` / `wgrad_reduce_kernel`, and the CostRegNet's
`conv3d_block_kernel`), cuDNN /
cuBLAS convolutions and GEMMs (oneDNN's on the CPU), copies and relayout,
and the rest (elementwise, reductions).  On the CPU the port's kernels run
their plain versions, whose time falls in the other pools.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch

from . import cli_device

SWEEP_POOL = "hand-written: sweep kernels"
RED_POOL = "hand-written: regularizer kernels"
LIBRARY_POOL = "cuDNN / cuBLAS convs and GEMMs"
COPY_POOL = "copies / relayout"
OTHER_POOL = "elementwise / reductions / other"
POOLS = (SWEEP_POOL, RED_POOL, LIBRARY_POOL, COPY_POOL, OTHER_POOL)

# the kernels of satmvs_tpu_torch/csrc by their names on the card
_SWEEP = re.compile(r"\b(sweep_variance|sweep_gather|sweep_scatter)\w*")
_RED = re.compile(r"\b(red_recur\w*|conv3x3_kernel|deconv3x3_s2_kernel|wgrad3x3\w*|"
                  r"wgrad_partial_kernel|wgrad_reduce_kernel|conv3d_block_kernel)\b")
_COPY = re.compile(r"CatArrayBatchedCopy|copy_|[Mm]emcpy|[Mm]emset|[Tt]ranspose|aten::cat\b|"
                   r"aten::(permute|contiguous|clone|stack)\b")
_LIBRARY = re.compile(r"cudnn|cublas|cutlass|xmma|gemm|implicit_convolve|convolve|conv2d|"
                      r"conv3d|convolution|conv_transpose|fprop|dgrad|wgrad|nchwToNhwc|"
                      r"nhwcToNchw|mkldnn|onednn|aten::(mm|bmm|addmm|matmul)\b", re.I)


def bucket(name: str) -> str:
    """The cost-map pool of a kernel or operator name (first match wins:
    the port's own kernels before the library patterns their names share,
    such as "conv")."""
    if _SWEEP.search(name):
        return SWEEP_POOL
    if _RED.search(name):
        return RED_POOL
    if _COPY.search(name):
        return COPY_POOL
    if _LIBRARY.search(name):
        return LIBRARY_POOL
    return OTHER_POOL


def trace_calls(fn: Callable[[], object], iters: int = 1, cuda: bool = True):
    """(profiler, wall µs) of `iters` calls of fn under torch.profiler, the
    card synchronized before the clock stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return prof, wall_us


def aggregate(prof, cuda: bool = True, iters: int = 1, top: int = 25) -> dict:
    """The trace's events (on the card: device kernels, copies and memsets
    by their own device time, an operator's entry repeating its kernels'
    time left out; on the CPU: operators by their own CPU time), per call:
    {"total_ms", "count", "pools": {pool: (ms, count)} with every pool of
    POOLS, "top": [(name, ms, count)] by time}."""
    from torch.autograd import DeviceType

    if cuda:
        events = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    else:
        events = [(e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                  if e.self_cpu_time_total > 0]
    pools = collections.OrderedDict((p, [0.0, 0]) for p in POOLS)
    for name, us, n in events:
        pool = pools[bucket(name)]
        pool[0] += us / 1e3 / iters
        pool[1] += n
    rows = sorted(events, key=lambda e: -e[1])[:top]
    return {"total_ms": sum(us for _, us, _ in events) / 1e3 / iters,
            "count": sum(n for _, _, n in events) / iters,
            "pools": {p: (ms, n / iters) for p, (ms, n) in pools.items()},
            "top": [(name, us / 1e3 / iters, n / iters) for name, us, n in rows]}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="satmvs_tpu_torch forward / train-step profile")
    p.add_argument("--model", default="red", choices=["red", "casmvs", "ucs"])
    p.add_argument("--size", default="384x768")
    p.add_argument("--ndepths", default="64,32,8")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--trace_dir", default=None)
    p.add_argument("--train", action="store_true",
                   help="profile the full train step (loss+grads+update)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Profile; returns `aggregate`'s dict plus "wall_ms" (a call, profiler
    on), "trace" (the Chrome trace's path) and "what"."""
    from ..data import synthetic
    from ..train import Config, create_model, create_model_and_state, make_train_step

    a = _parser().parse_args(argv)
    device = cli_device()
    cuda = device.type == "cuda"
    h, w = (int(x) for x in a.size.split("x"))
    cfg = Config(model=a.model, geo_model="rpc",
                 ndepths=tuple(int(x) for x in a.ndepths.split(",")))
    batch = synthetic.make_batch(batch_size=1, width=w, height=h, seed=0, device=device)
    if a.train:
        model, state, tx = create_model_and_state(cfg, batch, steps_per_epoch=100)
        train_step = make_train_step(model, tx, tuple(cfg.dlossw))

        def call():
            train_step(state, batch)
    else:
        model = create_model(cfg, device)

        @torch.no_grad()
        def call():
            model(batch["imgs"], batch["cams"], batch["depth_values"], train=False)

    call()  # warm-up: builds the kernels, cuDNN's plans, the allocator's pools
    if cuda:
        torch.cuda.synchronize()
    prof, wall_us = trace_calls(call, a.iters, cuda)
    trace_dir = a.trace_dir or tempfile.mkdtemp(prefix="satmvs_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    trace = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(trace)

    res = aggregate(prof, cuda, a.iters)
    what = "train step" if a.train else "forward"
    where = "device" if cuda else "CPU (operators' own time)"
    print(f"{where} total: {res['total_ms']:.1f} ms/{what} ({a.model} {a.size}, ndepths "
          f"{a.ndepths}); wall {wall_us / 1e3 / a.iters:.1f} ms/{what} (profiler on)")
    print("cost map (pool, ms, ops):")
    for pool, (ms, n) in sorted(res["pools"].items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:7.1f} ms {n:8.0f} ops  {pool}")
    print(f"{'ms/call':>9}  {'count':>6}  op")
    for name, ms, n in res["top"]:
        print(f"{ms:9.2f}  {n:6.0f}  {name[:70]}")
    print(f"trace: {trace}")
    return {**res, "wall_ms": wall_us / 1e3 / a.iters, "trace": trace, "what": what}


if __name__ == "__main__":
    main(sys.argv[1:])
