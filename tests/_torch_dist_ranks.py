"""One rank of the port's data-parallel CPU checks (tests/test_torch_dist.py).

    python tests/_torch_dist_ranks.py --world 2 --rank 0 --init file:///tmp/x/init \
        --out /tmp/x [--jobs red casmvs ...]

Each rank joins a gloo process group (a FileStore under --init, so that
test workers running side by side never race for a TCP port), runs the
named jobs on one intra-op thread and saves what they return to
<out>/rank<r>.pt.  The inputs, weights and settings live here so that the
test process computes its serial references from the same definitions.
This module imports torch and the port only.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np
import torch

NDEPTHS = (8, 8, 8)       # CasMVS's CostRegNet needs D % 8 == 0
HW = (32, 64)             # height, width
GLOBAL_B = 2
SEED = 5
STEPS = 2
SCENE = {"size": 96, "seed": 9, "h_amp": 50.0, "tile": 64, "halo": 32, "slab": 4,
         "batch_tiles": 4, "ndepths": (8, 4, 4)}


def config(model: str, **kw):
    from satmvs_tpu_torch.train import Config

    return Config(model=model, ndepths=NDEPTHS, seed=SEED, **kw)


def global_batch(ragged_masks: bool = False) -> dict:
    """The global batch of GLOBAL_B synthetic samples on the CPU; with
    ragged_masks the second sample keeps a quarter of its valid pixels at
    every stage (rows of the top quarter), so the two halves of the batch
    hold different mask counts."""
    from satmvs_tpu_torch.data import synthetic

    batch = synthetic.make_batch(GLOBAL_B, HW[1], HW[0], seed=0, device="cpu")
    if ragged_masks:
        for m in batch["mask_stages"]:
            m[1, m.shape[1] // 4:] = 0.0
    return batch


def lecun(model):
    """Scale the seeded He-normal convolution kernels to flax's LeCun scale
    (variance 1/fan_in), as the port's CPU parity tests seed them."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Conv3d,
                              torch.nn.ConvTranspose3d)):
                m.weight.mul_(0.5 ** 0.5)
    return model


def model_and_state(model: str, batch: dict, variables=None):
    """The model from SEED at LeCun scale, or from a flax variables tree."""
    from satmvs_tpu_torch.train import create_model_and_state

    cfg = config(model)
    net, state, tx = create_model_and_state(cfg, batch, 1, variables)
    if variables is None:
        lecun(net)
    return cfg, net, state, tx


def snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def train_run(model: str, batch: dict, mesh=None, variables=None) -> dict:
    """Eval-mode gradients of the fresh model, then STEPS train steps:
    their scalars, the running statistics after the first step, the
    parameters and statistics after the last.  Under a mesh `batch` is the
    global batch and the rank takes its share.  `variables`: the weights
    of a flax variables tree."""
    from satmvs_tpu_torch.dist import shard_batch
    from satmvs_tpu_torch.train.loop import loss_and_grads, make_train_step

    local = batch if mesh is None else shard_batch(batch, mesh)
    cfg, net, state, tx = model_and_state(model, local, variables)
    step = make_train_step(net, tx, cfg.dlossw, mesh)  # sets the BatchNorms' group
    _, loss, _, grads = loss_and_grads(net, state, local, cfg.dlossw, False, mesh)
    out = {"eval_loss": loss.item(), "eval_grads": snapshot(grads), "scalars": []}
    for k in range(STEPS):
        state, scalars = step(state, local)
        out["scalars"].append({n: v.item() for n, v in scalars.items()})
        if k == 0:
            out["stats_1"] = snapshot(state.batch_stats)
    out["params"] = snapshot(state.params)
    out["stats"] = snapshot(state.batch_stats)
    return out


def eval_run(batch: dict, mesh=None) -> dict:
    """The eval step of a fresh RED model: scalars, depth and confidence."""
    from satmvs_tpu_torch.dist import shard_batch
    from satmvs_tpu_torch.train.loop import make_eval_step

    local = batch if mesh is None else shard_batch(batch, mesh)
    cfg, net, state, _ = model_and_state("red", local)
    scalars, depth, conf = make_eval_step(net, cfg.dlossw, cfg.min_interval, mesh)(state, local)
    return {"scalars": {k: v.item() for k, v in scalars.items()}, "depth": depth, "conf": conf}


def ragged_run(mesh=None) -> dict:
    """The eval-mode loss of the ragged-mask batch; under a mesh also this
    rank's loss over its own share alone (a per-rank mean)."""
    from satmvs_tpu_torch.dist import shard_batch
    from satmvs_tpu_torch.models.losses import cascade_loss
    from satmvs_tpu_torch.train.loop import loss_and_grads

    batch = global_batch(ragged_masks=True)
    local = batch if mesh is None else shard_batch(batch, mesh)
    cfg, net, state, _ = model_and_state("red", local)
    out, loss, _, grads = loss_and_grads(net, state, local, cfg.dlossw, False, mesh)
    own = cascade_loss(out, local["depth_stages"], local["mask_stages"], cfg.dlossw)[0]
    return {"loss": loss.item(), "own_mean": own.item(), "grads": snapshot(grads)}


def variance_inputs():
    """ref (8, 8, 4) and two source volumes (2, 5, 8, 8, 4), as the JAX
    package's view-sharded moments test draws them."""
    rng = np.random.default_rng(2)
    ref = rng.normal(size=(8, 8, 4)).astype(np.float32)
    srcs = rng.normal(size=(2, 5, 8, 8, 4)).astype(np.float32)
    return ref, srcs


def variance_run(mesh) -> dict:
    """Rank r holds source view r, rank 0 also the reference; the volume
    and the gradient of Σ sin(volume)/ranks (the ranks' losses sum to the
    serial Σ sin(volume)) in the rank's own inputs."""
    from satmvs_tpu_torch.ops.cost_volume import variance_cost_volume

    ref, srcs = variance_inputs()
    r, n = mesh.rank, mesh.shape["data"]
    src = torch.from_numpy(srcs[r]).requires_grad_(True)
    ref_t = torch.from_numpy(ref).requires_grad_(True) if r == 0 else None
    vol = variance_cost_volume(ref_t, [src], num_views=3, group=mesh.group)
    leaves = [src] + ([ref_t] if r == 0 else [])
    grads = torch.autograd.grad(torch.sin(vol).sum() / n, leaves)
    return {"vol": vol.detach(), "grad_src": grads[0],
            "grad_ref": grads[1] if r == 0 else None}


def scene_model():
    """CascadeREDNet (rpc, SCENE's ndepths) from seed 0, the logit heads ×40
    (a peaked softmax)."""
    from satmvs_tpu_torch.models import CascadeREDNet

    model = CascadeREDNet(geo_model="rpc", ndepths=SCENE["ndepths"], device="cpu", seed=0)
    lecun(model)
    with torch.no_grad():
        for reg in model.regs:
            reg.step.head.weight.mul_(40.0)
            reg.step.head.bias.mul_(40.0)
    return model


def scene_run(mesh=None, batch_tiles: int = SCENE["batch_tiles"]) -> dict:
    """predict_scene of SCENE's triplet over the slab-streaming forward."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.infer.predict import streaming_red_forward
    from satmvs_tpu_torch.infer.scene import predict_scene

    scene = synthetic.make_scene(SCENE["size"], SCENE["size"], seed=SCENE["seed"],
                                 h_amp=SCENE["h_amp"])
    images, rpcs = scene["images"][[2, 0, 1]], scene["rpcs"][[2, 0, 1]]
    calls = []

    def forward(imgs, cams, dvals):
        calls.append(imgs.shape[0])
        return streaming_red_forward(model, imgs, cams, dvals, slab=SCENE["slab"])

    model = scene_model()
    stats = {}
    depth, conf = predict_scene(forward, images, rpcs, tile=SCENE["tile"], halo=SCENE["halo"],
                                batch_tiles=batch_tiles, stats=stats, device="cpu",
                                mesh=mesh)
    return {"depth": depth, "conf": conf, "calls": calls, "stats": stats}


def fit_run(mesh, workdir: str) -> dict:
    """fit of Config(mesh_data=ranks): one epoch of two global batches of
    GLOBAL_B, a test pass, a checkpoint."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config, fit

    batches = [synthetic.make_batch(GLOBAL_B, HW[1], HW[0], seed=s, device="cpu")
               for s in (0, 2)]
    cfg = Config(ndepths=(8, 4, 4), epochs=1, batch_size=GLOBAL_B, summary_freq=1, seed=3,
                 mesh_data=mesh.shape["data"])
    logs = []
    _, state, timing = fit(cfg, batches, batches[:1], workdir, log_fn=logs.append)
    return {"params": snapshot(state.params), "stats": snapshot(state.batch_stats),
            "logs": logs, "steps": timing["steps"]}


def jax_weights_run(mesh, path: str) -> dict:
    """The CasMVS train run from the flax variables tree the test process
    saved at `path`."""
    return train_run("casmvs", global_batch(), mesh, torch.load(path, weights_only=False))


def bits_run(mesh) -> dict:
    """World of one: each data-parallel path against the serial path in
    this process, compared bit for bit here."""
    batch = global_batch()
    out = {}
    serial, dp = train_run("red", batch), train_run("red", batch, mesh)
    out["train"] = (serial["scalars"] == dp["scalars"]
                    and all(torch.equal(serial[g][k], dp[g][k])
                            for g in ("params", "stats", "stats_1", "eval_grads")
                            for k in serial[g]))
    serial, dp = eval_run(batch), eval_run(batch, mesh)
    out["eval"] = (serial["scalars"] == dp["scalars"] and torch.equal(serial["depth"], dp["depth"])
                   and torch.equal(serial["conf"], dp["conf"]))
    serial, dp = scene_run(), scene_run(mesh)
    out["scene"] = (np.array_equal(serial["depth"], dp["depth"])
                    and np.array_equal(serial["conf"], dp["conf"])
                    and serial["calls"] == dp["calls"])
    return out


JOBS = {
    "bits": bits_run,
    "red": lambda mesh: train_run("red", global_batch(), mesh),
    "casmvs": lambda mesh: train_run("casmvs", global_batch(), mesh),
    "eval": lambda mesh: eval_run(global_batch(), mesh),
    "ragged": ragged_run,
    "variance": variance_run,
    "scene": scene_run,
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--jobs", nargs="+", required=True)
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from satmvs_tpu_torch.dist import init_multihost, make_mesh

    init_multihost(a.init, a.world, a.rank, device="cpu")
    try:
        mesh = make_mesh(data=a.world)
        jobs = dict(JOBS, fit=functools.partial(fit_run, workdir=os.path.join(a.out, "fit")),
                    jax=functools.partial(jax_weights_run, path=os.path.join(a.out, "vars.pt")))
        results = {job: jobs[job](mesh) for job in a.jobs}
        torch.save(results, os.path.join(a.out, f"rank{a.rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
