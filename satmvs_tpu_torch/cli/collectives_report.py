"""The collectives of one train step over a mesh: the twin of
scripts/collectives_report.py.

    python -m satmvs_tpu_torch.cli.collectives_report [--devices 8] [--size 384x768] \
        [--model red] [--ndepths 64,32,8] [--mesh data|data_spatial|depth]

The JAX script lists the collectives XLA compiled into the SPMD train step.
The port has no compiled program, so it runs the step: `--devices` ranks
join a gloo world (CPU processes under SATMVS_PLATFORM=cpu; otherwise
ranks on the cards, rank r on cuda:(r mod cards), sharing a card where
there are fewer cards than ranks: NCCL refuses two ranks a device).  The
mesh is JAX's: `data` N × 1 × 1, `data_spatial` N/2 × 2 × 1, `depth` N/4 ×
1 × 4 (RED switches to CasMVS there, as in JAX).  The global batch is
JAX's, B = the data extent from `synthetic.make_batch` at seed 0; each
rank renders its own share (sample b of that batch comes from seed b),
builds the model (`train.loop.create_model_and_state`,
whose `partition_model` shards the stage volumes with JAX's guards),
takes one warm-up step, then records exactly one `make_train_step` step.

The recorder wraps `torch.distributed.all_reduce`, `broadcast` and
`all_gather`, through which every collective of the port goes, for the
length of that step, process-wide and under a lock (on the card the
backward's collectives run on autograd's device thread).  Per call it
records the op, the dtype, the buffer's bytes (numel × element size; an
all_gather's gathered result), the group's size and the port function that
issued it, read from the Python stack: the gradient all-reduce, BatchNorm
moments, the loss's mask counts and sums, the metric sums, the variance
moments, the regression's sums over a depth slab, a halo exchange, a slab
gather, a group max ("(backward)" where autograd's backward issued it).
A port halo, slab gather or group max is an `all_reduce` of a zero buffer
that each rank fills at its place (`dist/halo.py`), so its buffer bytes
are the whole buffer while GSPMD's collective-permute moves only the halo:
the report gives both the buffer's bytes and the useful bytes (the slices
this rank receives from the others), and its TOTAL sums the buffer bytes.

Rank 0's inventory is printed in the JAX script's layout; `main` returns
every rank's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import cli_device

PACKAGE = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 1800
MESHES = ("data", "data_spatial", "depth")

# (port module, function) → the issuer's name in the report
_ISSUERS = {
    ("dist/collectives.py", "all_reduce_grads"): "gradients",
    ("dist/collectives.py", "host_gather"): "host gather",
    ("dist/mesh.py", "replicate"): "replicate",
    ("nn/blocks.py", "forward"): "batchnorm moments",
    ("models/losses.py", "masked_mean"): "loss mask counts",
    ("train/loop.py", "_global"): "loss sums",
    ("train/metrics.py", "_batch_means"): "metric sums",
    ("ops/cost_volume.py", "variance_cost_volume"): "variance moments",
}
_HALO_KINDS = {"halo": "halo exchange", "gather": "slab gather", "max": "group max"}


def _port_frame(frame):
    """(path in the package, function) of a frame of the port, else None."""
    path = frame.f_code.co_filename
    try:
        rel = Path(path).resolve().relative_to(PACKAGE).as_posix()
    except ValueError:
        return None
    return rel, frame.f_code.co_name


def _useful_bytes(kind: str, frame, nbytes: int) -> int:
    """Bytes of an exchange buffer that this rank reads from the others:
    the halo slices it receives, the other ranks' slabs of a gather, the
    other ranks' values of a max."""
    loc = frame.f_locals
    shard = loc["shard"]
    r, size = shard.index, shard.size
    if kind == "halo":
        before, after = loc["before"], loc["after"]
        per_slice = nbytes // max(size * (before + after), 1)
        backward = frame.f_code.co_name == "backward"
        got = ((after if backward else before) * (r > 0)
               + (before if backward else after) * (r < size - 1))
        return got * per_slice
    if kind == "gather":
        return nbytes * (shard.extent - (shard.hi - shard.lo)) // shard.extent
    return nbytes * (size - 1) // size


def issuer(frame) -> tuple[str, Optional[tuple]]:
    """(the port function that issued a collective, and for an exchange of
    `dist/halo.py` its (kind, the exchange's frame), else None), from the
    stack above the wrapped torch.distributed call at `frame`."""
    f = frame
    while f is not None:
        where = _port_frame(f)
        if where is None:
            f = f.f_back
            continue
        rel, fn = where
        if rel == "dist/halo.py" and fn == "_all_reduce":
            caller = f.f_back
            kind = f.f_locals["kind"]
            label = _HALO_KINDS[kind] + (" (backward)" if caller.f_code.co_name == "backward"
                                         else "")
            return label, (kind, caller)
        if rel == "dist/collectives.py" and fn in ("forward", "backward"):
            ctx = f.f_locals.get("ctx")
            if fn == "backward":
                return getattr(ctx, "report_issuer", "all_reduce_sum") + " (backward)", None
            label = _caller_of_all_reduce_sum(f.f_back)
            if ctx is not None:
                ctx.report_issuer = label
            return label, None
        if (rel, fn) in _ISSUERS:
            return _ISSUERS[(rel, fn)], None
        return f"{rel}:{fn}", None
    return "outside the port", None


def _caller_of_all_reduce_sum(f) -> str:
    """The first port function above `all_reduce_sum`."""
    while f is not None:
        where = _port_frame(f)
        if where is not None and where[0] != "dist/collectives.py":
            rel, fn = where
            return _ISSUERS.get((rel, fn), f"{rel.removesuffix('.py').replace('/', '.')}.{fn}")
        f = f.f_back
    return "all_reduce_sum"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Recorder:
    """Within the block, every `torch.distributed.all_reduce`, `broadcast`
    and `all_gather` call of this process is recorded in `calls` (dicts of
    op, dtype, bytes, useful_bytes, group_size, issuer), then made."""

    OPS = ("all_reduce", "broadcast", "all_gather")

    def __init__(self):
        self.calls: list[dict] = []
        self._lock = threading.Lock()
        self._saved: dict = {}

    def _wrap(self, op: str, fn):
        def wrapped(*args, **kwargs):
            if op == "all_gather":
                out, tensor = args[0], args[1]
                nbytes, dtype = sum(_nbytes(t) for t in out), tensor.dtype
            else:
                tensor = args[0] if args else kwargs["tensor"]
                nbytes, dtype = _nbytes(tensor), tensor.dtype
            group = kwargs.get("group")
            label, exchange = issuer(sys._getframe(1))
            useful = nbytes if exchange is None else _useful_bytes(*exchange, nbytes)
            record = {"op": op, "dtype": str(dtype).removeprefix("torch."), "bytes": nbytes,
                      "useful_bytes": useful, "group_size": dist.get_world_size(group),
                      "issuer": label}
            with self._lock:
                self.calls.append(record)
            return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        for op in self.OPS:
            self._saved[op] = getattr(dist, op)
            setattr(dist, op, self._wrap(op, self._saved[op]))
        return self

    def __exit__(self, *exc):
        for op, fn in self._saved.items():
            setattr(dist, op, fn)
        self._saved.clear()


def inventory(calls: Sequence[dict]) -> list[dict]:
    """Calls grouped by (op, issuer, dtype, group size) in first-call order:
    rows of collective, count, bytes and useful bytes a step."""
    rows: dict = collections.OrderedDict()
    for c in calls:
        key = (c["op"], c["issuer"], c["dtype"], c["group_size"])
        row = rows.setdefault(key, {"op": c["op"], "issuer": c["issuer"], "dtype": c["dtype"],
                                    "group_size": c["group_size"], "count": 0, "bytes": 0,
                                    "useful_bytes": 0})
        row["count"] += 1
        row["bytes"] += c["bytes"]
        row["useful_bytes"] += c["useful_bytes"]
    return list(rows.values())


def mesh_shape(mesh: str, devices: int) -> tuple[int, int, int]:
    """JAX's (data, spatial, depth) extents of a mesh name on `devices`."""
    spatial, depth = {"data": (1, 1), "data_spatial": (2, 1), "depth": (1, 4)}[mesh]
    if devices % (spatial * depth):
        raise SystemExit(f"--mesh {mesh} needs a multiple of {spatial * depth} devices, "
                         f"got {devices}")
    return devices // (spatial * depth), spatial, depth


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="satmvs_tpu_torch collectives of a train step")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--size", default="384x768")
    p.add_argument("--model", default="red")
    p.add_argument("--ndepths", default="64,32,8")
    p.add_argument("--mesh", default="data", choices=list(MESHES),
                   help="data: pure data-parallel; data_spatial: devices/2 x 2-way H sharding "
                        "of the cost volumes; depth: devices/4 x 4-way D-slab sharding "
                        "(extent-guarded)")
    # one rank of the world, started by the report itself
    for flag in ("--rank", "--init", "--out"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    return p


def _rank(a) -> None:
    """One rank: the warm-up step, then the recorded step (its collectives,
    and its hand-written kernels' launches); writes <out>/rank<r>.json."""
    from ..data import synthetic
    from ..dist import init_multihost, make_mesh, replicate
    from ..ops.kernels import launch_counts
    from ..train import Config, create_model_and_state, make_train_step

    rank, world = int(a.rank), a.devices
    device = cli_device()
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_multihost(a.init, world, rank, backend="gloo", device=device)
    clock = [time.perf_counter()]

    def lap() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize()
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    try:
        data, spatial, depth = mesh_shape(a.mesh, world)
        h, w = (int(x) for x in a.size.split("x"))
        nd = tuple(int(x) for x in a.ndepths.split(","))
        mesh = make_mesh(data, spatial, depth, device=device)
        # this rank's share of the global batch of `data` samples: make_batch's
        # sample b comes from seed b, so sample d is the share shard_batch cuts
        local = synthetic.make_batch(batch_size=1, width=w, height=h, seed=mesh.coords[0],
                                     device=device)
        seconds = {"batch": lap()}
        cfg = Config(model=a.model, geo_model="rpc", ndepths=nd)
        model, state, tx = create_model_and_state(cfg, local, steps_per_epoch=100, mesh=mesh)
        replicate(state.to_dict(), mesh)
        step = make_train_step(model, tx, tuple(cfg.dlossw), mesh)
        seconds["model"] = lap()
        step(state, local)  # warm-up: kernels built, cuDNN's plans chosen
        seconds["warmup_step"] = lap()
        before = launch_counts()
        with Recorder() as rec:
            _, scalars = step(state, local)
            loss = float(scalars["loss"])
            seconds["step"] = lap()
        launches = {k: v - before[k] for k, v in launch_counts().items() if v > before[k]}
        out = {"rank": rank, "calls": rec.calls, "inventory": inventory(rec.calls),
               "launches": launches,
               "params": sum(p.numel() for p in state.params.values()),
               "volume_partition": [list(s) for s in (model.volume_partition or ())],
               "mesh": {"data": data, "spatial": spatial, "depth": depth}, "loss": loss,
               "model": a.model, "seconds": seconds}
        Path(a.out, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run_world(a, workdir: str) -> list[dict]:
    """Start a.devices rank processes of this module and wait for them;
    returns their records in rank order (raises with a rank's log on
    failure or timeout)."""
    out = Path(workdir)
    out.mkdir(parents=True, exist_ok=True)
    init = f"file://{out / 'init'}"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(PACKAGE.parent), *filter(None, [os.environ.get("PYTHONPATH")])])}
    # the ranks render their batches with numpy at once: a share of the
    # host's cores each, unless the caller says otherwise
    threads = str(max(1, (os.cpu_count() or 1) // a.devices))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env.setdefault(var, threads)
    args = ["--devices", str(a.devices), "--size", a.size, "--model", a.model,
            "--ndepths", a.ndepths, "--mesh", a.mesh, "--init", init, "--out", str(out)]
    procs, logs = [], []
    for r in range(a.devices):
        log = open(out / f"log{r}", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-m", __spec__.name, *args, "--rank",
                                       str(r)], env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        deadline = time.time() + RANK_TIMEOUT_S
        for p in procs:
            p.wait(max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (out / f"log{r}").read_text()[-3000:]
            raise RuntimeError(f"collectives_report rank {r} exited {p.returncode}:\n{tail}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(a.devices)]


def print_report(a, ranks: list[dict]) -> None:
    """Rank 0's inventory in the JAX script's layout."""
    r0 = ranks[0]
    m = r0["mesh"]
    nd = tuple(int(x) for x in a.ndepths.split(","))
    if r0["volume_partition"]:
        print(f"[collectives_report] volume specs: {[tuple(s) for s in r0['volume_partition']]}")
    print(f"[collectives_report] {r0['model']} {a.size} D={nd} mesh data={m['data']} "
          f"spatial={m['spatial']} depth={m['depth']}; params {r0['params']} "
          f"({r0['params'] * 4 / 1e6:.2f} MB fp32)")
    rows = r0["inventory"]
    print(f"{'collective':52s} {'count':>6s} {'bytes/step':>12s} {'useful/step':>12s}")
    for row in rows:
        name = f"{row['op']} {row['issuer']} ({row['dtype']}, {row['group_size']})"
        print(f"{name:52s} {row['count']:6d} {row['bytes']:12d} {row['useful_bytes']:12d}")
    total = sum(row["bytes"] for row in rows)
    useful = sum(row["useful_bytes"] for row in rows)
    print(f"{'TOTAL':52s} {sum(row['count'] for row in rows):6d} {total:12d} {useful:12d}  "
          f"({total / 1e6:.2f} MB/step; the total sums buffer bytes, what gloo moves; "
          f"useful {useful / 1e6:.2f} MB)")
    print(f"[collectives_report] rank 0: batch {r0['seconds']['batch']:.1f} s, model "
          f"{r0['seconds']['model']:.1f} s, warm-up step {r0['seconds']['warmup_step']:.2f} s, "
          f"the recorded step {r0['seconds']['step']:.2f} s (host clock, the recorder on)"
          + (f"; it launched {r0['launches']}" if r0["launches"] else ""))


def collect(argv: Optional[Sequence[str]] = None):
    """Run the world of main's arguments without printing the report;
    returns (the parsed arguments, every rank's record)."""
    a = _parser().parse_args(argv)
    mesh_shape(a.mesh, a.devices)
    if a.mesh == "depth" and a.model == "red":
        # fit() refuses depth sharding for RED (it scans D in one launch);
        # report the conv-regularizer family instead
        print("[collectives_report] depth mesh: switching model to casmvs (RED scans D "
              "on-chip; fit() refuses --mesh_depth)")
        a.model = "casmvs"
    cli_device()  # raises without a GPU unless SATMVS_PLATFORM=cpu
    with tempfile.TemporaryDirectory(prefix="satmvs_coll_") as workdir:
        return a, run_world(a, workdir)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the report; returns {"ranks": every rank's record (inventory,
    calls, launches, params, volume_partition, mesh, loss, seconds),
    "model", "mesh"}."""
    a = _parser().parse_args(argv)
    if a.rank is not None:
        _rank(a)
        return {}
    a, ranks = collect(argv)
    print_report(a, ranks)
    return {"ranks": ranks, "model": a.model, "mesh": a.mesh}


if __name__ == "__main__":
    main(sys.argv[1:])
