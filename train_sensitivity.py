#!/usr/bin/env python3
"""How far rounding-level changes move the training steps that the port's
parity checks compare, on the CPU: the numbers behind the stated gates of
tests/test_torch_train_costreg.py and of chip_smoke.py's BF16_PARITY,
COSTREG_PARITY, CAMERA_PARITY, COMPUTE_BF16_PARITY and per-view bf16
forward.

    JAX_PLATFORMS=cpu python3 train_sensitivity.py \
        [--only jax|bf16|forward|cameras|compute_bf16]

  jax      JAX's own CasMVS / UCS train step (`make_train_step`) at 32×64,
           B = 1, ndepths (8, 8, 8), tests/test_torch_train_costreg.py's
           weights (seed 7), on the images and on the images × (1 + ε·N(0,
           1)), ε 1e-7 and 1e-6, two draws each: the relative change of
           the loss, depth_loss and abs_depth_error, of the update (per
           tensor, over all) and of the running statistics;
  bf16     the port's train step with bf16 volumes and in fp32 at 96×192,
           ndepths (16, 8, 4), seed 5, LeCun scale (chip_smoke.py's
           parity step), on the images and on the images × (1 + 1e-7·N):
           the eval-mode gradients' and the update's relative norms;
  cameras  as bf16, for the three camera models in fp32: the RPC basis
           form, QC (`use_qc`) and pinhole cameras fitted to the same
           triplet (`chip_smoke.pinhole_batch`, depths ~ −1.4e5 m);
  compute_bf16  as bf16, with compute_dtype bfloat16 (FeatureNet's convs
           in bf16; the fused RED pipeline stays fp32) and in fp32, under
           perturbations of 1e-7 and 1e-4 (a 1e-7 change of an fp32 image
           rarely flips a bf16 rounding; 1e-4 is still far below a bf16
           ulp, 2⁻⁸);
  forward  the port's per-view forward with bf16 volumes against its fp32
           default at 96×192, ndepths 64/32/8, LeCun scale, heads ×1 and
           ×40, each stage from the default's previous depth: the depth
           error in hypothesis steps (mean, p99, max).

It prints one line per measurement.  Needs the JAX package (jax) and the
port (torch); runs on the CPU only.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def is_head_bias(name: str) -> bool:
    """A logit head's bias (port or flax name): its gradient is 0 up to
    rounding (a softmax ignores a shift of all logits)."""
    return name.endswith("head.bias") or ("CostRegNet" in name and "Conv_0']['bias']" in name)


def update_gaps(new, ref, old, stats, ref_stats) -> tuple[float, float, float]:
    """Largest per-tensor and over-all relative norm of (new − old) − (ref −
    old), the logit heads' biases left out, and the statistics' largest
    difference relative to each tensor's largest value; dicts of arrays."""
    num = den = worst = 0.0
    for n in ref:
        if is_head_bias(n):
            continue
        d = np.linalg.norm((new[n] - old[n]) - (ref[n] - old[n]))
        r = np.linalg.norm(ref[n] - old[n])
        num, den = num + d * d, den + r * r
        worst = max(worst, d / r)
    stat = max(float(np.abs(stats[n] - ref_stats[n]).max() / np.abs(ref_stats[n]).max())
               for n in ref_stats)
    return worst, (num / den) ** 0.5, stat


def jax_costreg():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from satmvs_tpu.data import synthetic as jsyn
    from satmvs_tpu.models import build_model as jbuild
    from satmvs_tpu.train.config import Config as JConfig
    from satmvs_tpu.train.loop import TrainState, make_optimizer, make_train_step, numeric_batch

    def seeded(shapes, seed):  # tests/test_torch_train_costreg.py's seeded_variables
        rng = np.random.default_rng(seed)

        def draw(path, s):
            name = getattr(path[-1], "key", None)
            if name == "kernel":
                return rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
            if name == "scale":
                return 1.0 + 0.2 * rng.normal(size=s.shape)
            if name == "var":
                return rng.uniform(0.5, 1.5, s.shape)
            return 0.1 * rng.normal(size=s.shape)

        return jax.tree_util.tree_map_with_path(
            lambda p, s: np.asarray(draw(p, s), np.float32), shapes)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    for name in ("casmvs", "ucs"):
        jb = numeric_batch(jsyn.make_batch(1, 64, 32, seed=0))
        model = jbuild(name, "rpc", ndepths=(8, 8, 8))
        args = (jb["imgs"], jb["cams"], jb["depth_values"])
        v = seeded(jax.eval_shape(functools.partial(model.init, train=False),
                                  jax.random.PRNGKey(0), *args), 7)
        cfg = JConfig(model=name, ndepths=(8, 8, 8))
        tx = make_optimizer(cfg, 2)
        state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
        step = make_train_step(model, tx, tuple(cfg.dlossw))
        base, base_sc = step(state, jb)
        old = flat(v["params"])
        for eps in (1e-7, 1e-6):
            for draw in (0, 1):
                imgs = np.asarray(jb["imgs"])
                noisy = imgs * (1 + eps * np.random.default_rng(draw).normal(size=imgs.shape))
                new, sc = step(state, {**jb, "imgs": jnp.asarray(noisy, jnp.float32)})
                gaps = update_gaps(flat(new.params), flat(base.params), old,
                                   flat(new.batch_stats), flat(base.batch_stats))
                rel = {k: abs(float(sc[k]) - float(base_sc[k])) / abs(float(base_sc[k]))
                       for k in ("loss", "depth_loss", "abs_depth_error")}
                print(f"[jax] {name} eps {eps:g} draw {draw}: loss {rel['loss']:.2e}, depth_loss "
                      f"{rel['depth_loss']:.2e}, abs_depth_error {rel['abs_depth_error']:.2e}; "
                      f"update {gaps[0]:.2e} per tensor, {gaps[1]:.2e} over all; statistics "
                      f"{gaps[2]:.2e}", flush=True)


def step_spread(tag: str, what: str, cfg, base: dict, eps: float = 1e-7) -> None:
    """The port's train step of cfg (LeCun scale, chip_smoke.py's parity
    step) on base and on base's images × (1 + eps·N(0, 1)): the relative
    change of the loss, of the eval-mode gradients and of the update, per
    tensor and over all, the logit heads' biases left out, and of the
    running statistics."""
    import torch

    import chip_smoke as cs
    from satmvs_tpu_torch.models.losses import cascade_loss
    from satmvs_tpu_torch.train import create_model_and_state, make_train_step

    noise = torch.from_numpy(np.random.default_rng(0).normal(size=base["imgs"].shape)
                             .astype(np.float32))
    runs = []
    for e in (0.0, eps):
        batch = {**base, "imgs": base["imgs"] * (1 + e * noise)}
        model, state, tx = create_model_and_state(cfg, batch, 1)
        cs.lecun_scale(model)
        old = {k: v.detach().clone().numpy() for k, v in state.params.items()}
        out = model.run_cascade(batch["imgs"], batch["cams"], batch["depth_values"], False)
        loss = cascade_loss(out, batch["depth_stages"], batch["mask_stages"], cfg.dlossw)[0]
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        state, scalars = make_train_step(model, tx, cfg.dlossw)(state, batch)
        runs.append(({n: g.numpy() for n, g in zip(names, grads)}, old,
                     {k: v.detach().numpy() for k, v in state.params.items()},
                     scalars["loss"].item(),
                     {k: v.detach().numpy() for k, v in state.batch_stats.items()}))
    (g0, o0, p0, l0, s0), (g1, _, p1, l1, s1) = runs
    keep = [n for n in g0 if not is_head_bias(n)]
    per = max(np.linalg.norm(g1[n] - g0[n]) / np.linalg.norm(g0[n]) for n in keep)
    all_ = (sum(np.linalg.norm(g1[n] - g0[n]) ** 2 for n in keep)
            / sum(np.linalg.norm(g0[n]) ** 2 for n in keep)) ** 0.5
    upd = update_gaps(p1, p0, o0, s1, s0)
    print(f"[{tag}] port train step, {what}, eps {eps:g}: loss {abs(l1 - l0) / abs(l0):.2e} "
          f"relative; eval-mode gradients {per:.2e} per tensor, {all_:.2e} over all; update "
          f"{upd[0]:.2e} per tensor, {upd[1]:.2e} over all; running statistics {upd[2]:.2e}",
          flush=True)


def port_bf16():
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config

    base = synthetic.make_batch(1, 192, 96, seed=1, device="cpu")
    for dtype in ("float32", "bfloat16"):
        step_spread("bf16", f"volume_dtype {dtype}",
                    Config(ndepths=(16, 8, 4), seed=5, volume_dtype=dtype), base)


def port_compute_bf16():
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config

    base = synthetic.make_batch(1, 192, 96, seed=1, device="cpu")
    for dtype in ("float32", "bfloat16"):
        for eps in (1e-7, 1e-4):
            step_spread("compute_bf16", f"compute_dtype {dtype}",
                        Config(ndepths=(16, 8, 4), seed=5, compute_dtype=dtype), base, eps)


def port_cameras():
    import chip_smoke as cs
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.train import Config

    for what, fields, base in (
            ("RPC basis form", {}, synthetic.make_batch(1, 192, 96, seed=1, device="cpu")),
            ("QC", {"use_qc": True},
             synthetic.make_batch(1, 192, 96, seed=1, device="cpu", use_qc=True)),
            ("pinhole", {"geo_model": "pinhole"},
             cs.pinhole_batch(192, 96, seed=1, device="cpu")[0])):
        step_spread("cameras", what, Config(ndepths=(16, 8, 4), seed=5, **fields), base)


def port_forward():
    import torch

    import chip_smoke as cs
    from satmvs_tpu_torch.data import synthetic
    from satmvs_tpu_torch.models import CascadeREDNet

    b = synthetic.make_batch(1, 192, 96, seed=1, device="cpu")
    for gain in (1.0, 40.0):
        m = cs.lecun_scale(CascadeREDNet(geo_model="rpc", ndepths=cs.NDEPTHS, device="cpu", seed=0))
        with torch.no_grad():
            for reg in m.regs:
                reg.step.head.weight.mul_(gain)
                reg.step.head.bias.mul_(gain)
        want = m(b["imgs"], b["cams"], b["depth_values"])
        m.fused_sweep, m.volume_dtype = False, torch.bfloat16
        feats = m.features(b["imgs"])
        lo, hi = b["depth_values"][0].tolist()
        for i, step in enumerate(cs.stage_steps(lo, hi, m.stage_intervals())):
            prev = None if i == 0 else want[f"stage{i}"]["depth"]
            got = m.stage(i, feats[i], b["cams"][i], b["depth_values"][:, 0],
                          b["depth_values"][:, -1], prev)
            mean, p99, mx = cs.err_quantiles((got["depth"] - want[f"stage{i + 1}"]["depth"]).abs()
                                             / step)
            print(f"[forward] bf16 per-view against fp32, heads ×{gain:g}, stage{i + 1}: depth "
                  f"err mean {mean:.2e}, p99 {p99:.2e}, max {mx:.2e} of step", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=["jax", "bf16", "forward", "cameras", "compute_bf16"])
    a = p.parse_args(argv)
    os.environ.setdefault("SATMVS_PLATFORM", "cpu")
    sys.path.insert(0, str(ROOT))
    for key, fn in (("jax", jax_costreg), ("bf16", port_bf16), ("forward", port_forward),
                    ("cameras", port_cameras), ("compute_bf16", port_compute_bf16)):
        if a.only in (None, key):
            fn()
    return 0


if __name__ == "__main__":
    sys.exit(main())
