"""One rank of the port's distributed CPU checks (tests/test_torch_dist.py,
the data axis; tests/test_torch_dist_shard.py, the spatial and depth axes).

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


def config(model: str, ndepths=NDEPTHS, **kw):
    from satmvs_tpu_torch.train import Config

    return Config(model=model, ndepths=ndepths, seed=SEED, **kw)


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


def model_and_state(model: str, batch: dict, variables=None, mesh=None, ndepths=NDEPTHS,
                    lr: float = 1e-3):
    """The model from SEED at LeCun scale, or from a flax variables tree;
    its volumes sharded as the mesh says."""
    from satmvs_tpu_torch.train import create_model_and_state

    cfg = config(model, ndepths, lr=lr)
    net, state, tx = create_model_and_state(cfg, batch, 1, variables, mesh)
    if variables is None:
        lecun(net)
    return cfg, net, state, tx


def snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def train_run(model: str, batch: dict, mesh=None, variables=None, ndepths=NDEPTHS,
              lr: float = 1e-3) -> dict:
    """Eval-mode gradients of the fresh model, then STEPS train steps:
    their scalars, the running statistics after the first step, the
    parameters and statistics after the last.  Under a mesh `batch` is the
    global batch and the rank takes its share.  `variables`: the weights
    of a flax variables tree."""
    from satmvs_tpu_torch.dist import shard_batch
    from satmvs_tpu_torch.train.loop import loss_and_grads, make_train_step

    local = batch if mesh is None else shard_batch(batch, mesh)
    cfg, net, state, tx = model_and_state(model, local, variables, mesh, ndepths, lr)
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


# ---- the spatial and depth axes (tests/test_torch_dist_shard.py)

SHARD_HW = (32, 32)
SHARD_NDEPTHS = {"casmvs": (32, 8, 8), "ucs": (32, 8, 8), "red": (8, 8, 8)}
# job → (model, mesh (data, spatial, depth))
SHARD_GRADS = {"casmvs_d2": ("casmvs", (1, 1, 2)), "ucs_d2": ("ucs", (1, 1, 2)),
               "casmvs_s2": ("casmvs", (1, 2, 1)), "red_s2": ("red", (1, 2, 1)),
               "casmvs_d4": ("casmvs", (1, 1, 4)), "ucs_d4": ("ucs", (1, 1, 4)),
               "casmvs_dp2_d4": ("casmvs", (2, 1, 4))}  # JAX's own mesh: 8 ranks, slow
# the train-mode steps: model, mesh, the batch's (height, width), ndepths,
# learning rate (CasMVS at 1e-4: at 1e-3 its serial step's second loss
# moves 9.1e-5 to 1.5e-3 relative when only the batch's order changes, at
# these sizes, the order of its 3e-4 gate; at 1e-4, 8.4e-8 to 2.9e-5:
# `reorder_spread`)
SHARD_STEPS = {"casmvs_dp2_d2": ("casmvs", (2, 1, 2), SHARD_HW, (16, 8, 8), 1e-4),
               "red_dp2_s2": ("red", (2, 2, 1), HW, NDEPTHS, 1e-3)}
SHARD_EVALS = {"eval_casmvs_d2": ("casmvs", (1, 1, 2)), "eval_casmvs_s2": ("casmvs", (1, 2, 1)),
               "eval_ucs_d2": ("ucs", (1, 1, 2)), "eval_red_s2": ("red", (1, 2, 1))}


def shard_batch_global(hw=SHARD_HW) -> dict:
    """The global batch of the sharding checks: GLOBAL_B samples at hw."""
    from satmvs_tpu_torch.data import synthetic

    return synthetic.make_batch(GLOBAL_B, hw[1], hw[0], seed=0, device="cpu")


def grads_run(model: str, shape, path: str) -> dict:
    """Under a mesh of `shape`, the eval-mode loss and gradients (summed
    over the mesh) of the model from the flax variables tree at `path`, and
    the exchanges they issued."""
    from satmvs_tpu_torch.dist import exchange_stats, make_mesh, shard_batch
    from satmvs_tpu_torch.train.loop import loss_and_grads

    mesh = make_mesh(*shape)
    local = shard_batch(shard_batch_global(), mesh)
    variables = torch.load(path, weights_only=False)
    cfg, net, state, _ = model_and_state(model, local, variables, mesh, SHARD_NDEPTHS[model])
    exchange_stats.reset()
    _, loss, _, grads = loss_and_grads(net, state, local, cfg.dlossw, False, mesh)
    return {"loss": loss.item(), "grads": snapshot(grads),
            "exchanges": dict(exchange_stats.counts),
            "partition": net.volume_partition}


def steps_run(job: str, serial: bool = False) -> dict:
    """`train_run` (eval-mode gradients, STEPS train steps) of SHARD_STEPS'
    `job`, under its mesh (serial: at B = 2 in one process)."""
    from satmvs_tpu_torch.dist import make_mesh

    model, shape, hw, ndepths, lr = SHARD_STEPS[job]
    return train_run(model, shard_batch_global(hw), None if serial else make_mesh(*shape),
                     ndepths=ndepths, lr=lr)


def reorder_spread(model: str, hw=SHARD_HW, ndepths=(16, 8, 8), lr: float = 1e-3,
                   seed: int = 0) -> list:
    """How far the serial B = 2 step moves by itself: by step, the relative
    distance of the loss of `train_run` on a batch with its two samples
    swapped from that on the batch (the yardstick of the train-mode gates;
    from tests/: python -c "import _torch_dist_ranks as r;
    print(r.reorder_spread('casmvs'))")."""
    from satmvs_tpu_torch.data import synthetic

    batch = synthetic.make_batch(GLOBAL_B, hw[1], hw[0], seed=seed, device="cpu")
    swapped = {k: (v[[1, 0]] if isinstance(v, torch.Tensor) else type(v)(c[[1, 0]] for c in v))
               for k, v in batch.items()}
    a, b = (train_run(model, x, ndepths=ndepths, lr=lr)["scalars"] for x in (batch, swapped))
    return [abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(a, b)]


def shard_eval_run(model: str, shape=None) -> dict:
    """The eval step (packed CostRegNet, fused sweep) of the seeded model,
    under a mesh of `shape` (None: serial): scalars, depth and confidence."""
    from satmvs_tpu_torch.dist import make_mesh, shard_batch
    from satmvs_tpu_torch.train.loop import make_eval_step

    mesh = None if shape is None else make_mesh(*shape)
    batch = shard_batch_global()
    local = batch if mesh is None else shard_batch(batch, mesh)
    cfg, net, state, _ = model_and_state(model, local, None, mesh, SHARD_NDEPTHS[model])
    scalars, depth, conf = make_eval_step(net, cfg.dlossw, cfg.min_interval, mesh)(state, local)
    return {"scalars": {k: v.item() for k, v in scalars.items()}, "depth": depth, "conf": conf}


def fit_shard_run(mesh, workdir: str) -> dict:
    """fit of Config(model="casmvs", mesh_depth=2) on two ranks: one epoch
    of two global batches of GLOBAL_B at SHARD_HW, a test pass, a
    checkpoint."""
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config, fit

    batches = [synthetic.make_batch(GLOBAL_B, SHARD_HW[1], SHARD_HW[0], seed=s, device="cpu")
               for s in (0, 2)]
    cfg = Config(model="casmvs", ndepths=(16, 8, 8), epochs=1, batch_size=GLOBAL_B,
                 summary_freq=1, seed=3, mesh_depth=2)
    logs = []
    model, state, timing = fit(cfg, batches, batches[:1], workdir, log_fn=logs.append)
    return {"params": snapshot(state.params), "stats": snapshot(state.batch_stats),
            "logs": logs, "steps": timing["steps"], "partition": model.volume_partition}


OPS_SHAPE = (2, 3, 16, 16, 8)  # NCDHW: a slab axis of 16 at either place


def ops_inputs():
    """x, an output cotangent for each block kind, per-rank cotangents of a
    gathered tensor, and the seeded blocks: a stride-1 and a stride-2
    Conv3d, a stride-2 ConvTranspose3d."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=OPS_SHAPE).astype(np.float32))
    torch.manual_seed(3)
    blocks = {"s1": torch.nn.Conv3d(3, 4, 3, 1, 1), "s2": torch.nn.Conv3d(3, 4, 3, 2, 1),
              "up": torch.nn.ConvTranspose3d(3, 4, 3, 2, 1, 1)}
    with torch.no_grad():
        cots = {k: torch.from_numpy(rng.normal(size=tuple(b(x).shape)).astype(np.float32))
                for k, b in blocks.items()}
    gathers = [torch.from_numpy(rng.normal(size=OPS_SHAPE).astype(np.float32))
               for _ in range(2)]
    return x, cots, gathers, blocks


def ops_run(axis: str) -> dict:
    """On a mesh of two ranks along `axis`: each block kind on this rank's
    slab of x (its output slab, the gradients of Σ output·cotangent in the
    slab and in the weights), `slab_gather` of the slab (the gradient of
    Σ gathered·(this rank's cotangent)) and `group_max`."""
    from satmvs_tpu_torch.dist import group_max, make_mesh, slab_gather
    from satmvs_tpu_torch.nn.blocks import conv3d_slab, conv_transpose3d_slab

    mesh = make_mesh(1, 2, 1) if axis == "spatial" else make_mesh(1, 1, 2)
    dim = 3 if axis == "spatial" else 2
    shard = mesh.shard(axis, OPS_SHAPE[dim])
    x, cots, gathers, blocks = ops_inputs()
    out = {}
    for kind, block in blocks.items():
        xs = x.narrow(dim, shard.lo, shard.hi - shard.lo).clone().requires_grad_(True)
        fn = conv_transpose3d_slab if kind == "up" else conv3d_slab
        y = fn(block, xs, shard)
        scale = 2 if kind == "up" else (0.5 if kind == "s2" else 1)
        lo, n = int(shard.lo * scale), y.shape[dim]
        loss = (y * cots[kind].narrow(dim, lo, n)).sum()
        gx, gw, gb = torch.autograd.grad(loss, [xs, block.weight, block.bias])
        out[kind] = {"y": y.detach(), "gx": gx, "gw": gw, "gb": gb, "lo": lo}
    xs = x.narrow(dim, shard.lo, shard.hi - shard.lo).clone().requires_grad_(True)
    full = slab_gather(xs, dim, shard)
    (gx,) = torch.autograd.grad((full * gathers[shard.index]).sum(), [xs])
    out["gather"] = {"full": full.detach(), "gx": gx, "lo": shard.lo}
    out["max"] = group_max(gathers[shard.index], shard)
    return out


JOBS = {
    "bits": bits_run,
    "red": lambda mesh: train_run("red", global_batch(), mesh),
    "casmvs": lambda mesh: train_run("casmvs", global_batch(), mesh),
    "eval": lambda mesh: eval_run(global_batch(), mesh),
    "ragged": ragged_run,
    "variance": variance_run,
    "scene": scene_run,
    "ops_depth": lambda mesh: ops_run("depth"),
    "ops_spatial": lambda mesh: ops_run("spatial"),
    **{job: (lambda mesh, j=job: steps_run(j)) for job in SHARD_STEPS},
    **{job: (lambda mesh, m=m, sh=sh: shard_eval_run(m, sh))
       for job, (m, sh) in SHARD_EVALS.items()},
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
                    jax=functools.partial(jax_weights_run, path=os.path.join(a.out, "vars.pt")),
                    fit_shard=functools.partial(fit_shard_run,
                                                workdir=os.path.join(a.out, "fit_shard")),
                    **{job: functools.partial(
                        lambda mesh, m, sh: grads_run(m, sh, os.path.join(a.out, f"vars_{m}.pt")),
                        m=m, sh=sh) for job, (m, sh) in SHARD_GRADS.items()})
        results = {job: jobs[job](mesh) for job in a.jobs}
        torch.save(results, os.path.join(a.out, f"rank{a.rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
