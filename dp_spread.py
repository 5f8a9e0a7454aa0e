#!/usr/bin/env python3
"""How far the train steps of chip_smoke.py's phase 13 move on their own,
on one CUDA device: the readings that phase's fixed gates are set from.

    python3 dp_spread.py [--seeds 0 0 0 0 0 0 1 2]
    python3 dp_spread.py --shard [--seeds 0 0 0 0 0 0]

Builds the kernels, then for each entry of --seeds (a global batch of
`synthetic.make_batch(2, 768, 384, seed=s)`; phase 13's is seed 0, so a
repeated 0 reads the spread run to run of the smoke's own case), from the
same weights and on cuDNN's default engines, as phase 13 (b) runs them:

  - the serial B = 2 train step, chip_smoke.DP_STEPS steps, twice on the
    batch and once with its two samples swapped (`chip_smoke.dp_serial`);
  - the same steps on two ranks that share the card over gloo, one sample
    a rank (`chip_smoke.dp_rank`);

and prints a JSON line a run: by step, the relative distance of the loss
and of abs_depth_error from the first serial run's, for the second serial
run ("again"), the swapped batch ("swapped") and the two ranks ("ranks");
and phase 13 (a)'s yardstick on the same seed: two serial 384×768 B = 1
steps from the same weights on cuDNN's deterministic engines, the relative
norm of the difference of their updates over all parameters ("update") and
whether they are the same bits.  With --shard, phase 13 (d)'s runs instead
(chip_smoke.SHARD_RUNS: CasMVS and UCS at mesh_depth 2, CasMVS and RED at
mesh_spatial 2, B = 1, `synthetic.make_batch(1, 768, 384, seed=s)`): the
serial run twice (`chip_smoke.shard_run`) and the two ranks that share the
card (`chip_smoke.shard_rank`), and a JSON line a run: by run and step, the
relative distance of the loss and of abs_depth_error from the first serial
run's, for the second serial run ("again") and the ranks ("ranks").  The
line before the last holds the largest of each reading over the runs; the
last, the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402


def ranks_run(k: int) -> list:
    """chip_smoke.dp_rank's train steps (no scene) on DP_RANKS spawned ranks."""
    ctx = multiprocessing.get_context("spawn")
    go = ctx.Event()
    go.set()
    init = str(cs.DP_WORK / f"init{k}")  # a FileStore of its own for each run
    procs = [ctx.Process(target=cs.dp_rank, args=(r, init, go, False))
             for r in range(cs.DP_RANKS)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    cs.check(all(p.exitcode == 0 for p in procs),
             f"a rank failed: exit codes {[p.exitcode for p in procs]}")
    return [torch.load(cs.DP_WORK / f"rank{r}.pt", weights_only=False)
            for r in range(cs.DP_RANKS)]


def one_rank_yardstick(seed: int) -> dict:
    """Two serial B = 1 steps from the same weights on cuDNN's deterministic
    engines, as phase 13 (a) runs its serial steps."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config

    batch = synthetic.make_batch(1, cs.WIDTH, cs.HEIGHT, seed=seed, device="cuda")
    torch.backends.cudnn.deterministic = True
    try:
        a, b = (cs.dp_step(Config(ndepths=cs.NDEPTHS), batch) for _ in range(2))
    finally:
        torch.backends.cudnn.deterministic = False
    return {"update": cs.update_spread(b, a, a["old"]), "same_bits": cs.same_bits(a, b)}


def shard_spread(seeds, worst: dict) -> None:
    """--shard: phase 13 (d)'s runs on each seed's batch, a JSON line each."""
    import multiprocessing

    from satmvs_tpu_torch.data import synthetic

    shutil.rmtree(cs.SHARD_WORK, ignore_errors=True)
    cs.SHARD_WORK.mkdir(parents=True)
    for k, seed in enumerate(seeds):
        batch = synthetic.make_batch(1, cs.WIDTH, cs.HEIGHT, seed=seed, device="cpu")
        torch.save(batch, cs.SHARD_WORK / "batch.pt")
        on_card = cs.batch_to(batch, "cuda")
        runs = {}
        for model, axis in cs.SHARD_RUNS:
            first = cs.shard_run(model, None, on_card)["scalars"]
            runs[(model, axis)] = {"first": first,
                                   "again": cs.shard_run(model, None, on_card)["scalars"]}
            torch.cuda.empty_cache()
        go = multiprocessing.get_context("spawn").Event()
        go.set()
        ranks = cs.shard_join(cs.shard_ranks(str(cs.SHARD_WORK / f"init{k}"), go))
        line = {"run": k, "seed": seed}
        for (model, axis), r in runs.items():
            tag = f"{model}_{axis}"
            line[tag] = {"again": cs.dp_step_errors(r["again"], r["first"]),
                         "ranks": cs.dp_step_errors(ranks[0][tag]["scalars"], r["first"])}
            for what, errs in line[tag].items():
                for step, err in enumerate(errs):
                    for key, rel in err.items():
                        name = f"{tag} {what} step {step + 1} {key}"
                        worst[name] = max(worst.get(name, 0.0), rel)
        print(json.dumps(line), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=None)
    p.add_argument("--shard", action="store_true",
                   help="phase 13 (d)'s spatial and depth runs (default seeds 0 ×6)")
    a = p.parse_args()
    if a.seeds is None:
        a.seeds = [0] * 6 if a.shard else [0, 0, 0, 0, 0, 0, 1, 2]
    if not torch.cuda.is_available():
        print("dp_spread: no CUDA device available", file=sys.stderr)
        return 1
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build_all()
    for name in build.sources():
        build.load(name)
    worst: dict = {}
    if a.shard:
        shard_spread(a.seeds, worst)
        print(json.dumps({"largest": worst, "runs": len(a.seeds)}), flush=True)
        print(smi, flush=True)
        return 0
    shutil.rmtree(cs.DP_WORK, ignore_errors=True)
    cs.DP_WORK.mkdir(parents=True)
    for k, seed in enumerate(a.seeds):
        torch.save(synthetic.make_batch(cs.DP_RANKS, cs.WIDTH, cs.HEIGHT, seed=seed,
                                        device="cpu"), cs.DP_WORK / "batch.pt")
        first = cs.dp_serial()["scalars"]
        runs = {"again": cs.dp_serial()["scalars"], "swapped": cs.dp_serial((1, 0))["scalars"],
                "ranks": ranks_run(k)[0]["scalars"]}
        line = {"run": k, "seed": seed,
                **{what: cs.dp_step_errors(got, first) for what, got in runs.items()},
                "one_rank": one_rank_yardstick(seed)}
        print(json.dumps(line), flush=True)
        for what in runs:
            for step, err in enumerate(line[what]):
                for key, rel in err.items():
                    name = f"{what} step {step + 1} {key}"
                    worst[name] = max(worst.get(name, 0.0), rel)
        worst["one_rank update"] = max(worst.get("one_rank update", 0.0),
                                       line["one_rank"]["update"])
    print(json.dumps({"largest": worst, "runs": len(a.seeds)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
