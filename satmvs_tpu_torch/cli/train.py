"""Training, evaluation and profiling CLI: the twin of scripts/train.py.

    python -m satmvs_tpu_torch.cli.train --mode=train --model=red --geo_model=rpc \
        --dataset_root=/path/WHU_TLC --min_interval=5 --ndepths=64,32,8

Flags and defaults are `train.Config.from_args`'s (those of the JAX
script); values whose features the port lacks raise.  --mode=train fits
over <dataset_root>/open_dataset_<geo_model>/{train,test} (or dataset_root
itself when it is a split directory) into <logdir>/<model>/<geo_model>;
--geo_model pinhole reads the camera-text layout, --use_qc takes the RPC
cameras in QC form;
--mode=test restores the latest checkpoint there (or --loadckpt's),
evaluates the test split and writes height_result/{name}_{view}{,_prob,_err}.pfm
beside it (-999 in _err where the mask is off); --mode=profile takes
three train steps under torch.profiler into <logdir>/<model>/<geo_model>/profile.

On N GPUs, data-parallel (each rank on its own card, trained on its share
of every batch of --batch_size, a multiple of N; rank 0 writes the files):

    python -m torch.distributed.run --nproc_per_node N -m satmvs_tpu_torch.cli.train \
        --mode=train --mesh_data N --batch_size N ...

or with each stage's cost volume cut into depth slabs (--model casmvs or
ucs) or bands of rows over the ranks of a batch share, as JAX's trainer:

    python -m torch.distributed.run --nproc_per_node 2 -m satmvs_tpu_torch.cli.train \
        --mode=train --model casmvs --mesh_depth 2 ...
    python -m torch.distributed.run --nproc_per_node 2 -m satmvs_tpu_torch.cli.train \
        --mode=train --mesh_spatial 2 ...

--mesh_data × --mesh_spatial × --mesh_depth must equal the ranks launched
(`dist.make_mesh` refuses other counts); test and profile run on one rank.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import cli_device, process_group, restore_model


def _splits(cfg) -> tuple[str, str]:
    root = os.path.join(cfg.dataset_root, f"open_dataset_{cfg.geo_model}")
    trainpath, testpath = os.path.join(root, "train"), os.path.join(root, "test")
    if not os.path.isdir(trainpath):  # dataset_root is a split directory
        trainpath = testpath = cfg.dataset_root
    return trainpath, testpath


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run one mode.  Returns what it measured: train → {"timing": fit's
    per-epoch seconds, "train_loader"/"test_loader": the loaders' timing
    (latest pass), "train_data": the train dataset's (every sample read)};
    test → {"metrics", "epoch", "out_dir", "eval_s"}; profile →
    {"profile_dir"}."""
    from ..train import Config

    cfg = Config.from_args(argv)
    device = cli_device(deterministic=cfg.mode == "test")  # test writes maps
    with process_group(device) as world:
        return _run(cfg, device, world)


def _run(cfg, device, world: int) -> dict:
    import torch.distributed as dist

    from ..data.dataset import find_dataset
    from ..data.loader import Loader
    from ..dist import make_mesh
    from ..train import fit

    if world > 1 and cfg.mode != "train":
        raise ValueError(f"--mode={cfg.mode} runs on one rank, not {world}")
    workdir = os.path.join(cfg.logdir, cfg.model, cfg.geo_model)
    os.makedirs(workdir, exist_ok=True)
    trainpath, testpath = _splits(cfg)
    ds_cls = find_dataset(cfg.geo_model)

    def make(path, mode):
        return ds_cls(path, mode, cfg.view_num, cfg.ref_view, cfg.geo_model, cfg.num_stage,
                      cfg.seed, use_qc=cfg.use_qc, max_h=cfg.max_h, max_w=cfg.max_w)

    if cfg.mode == "train":
        tl = Loader(make(trainpath, "train"), cfg.batch_size, shuffle=True, seed=cfg.seed,
                    device=device)
        el = Loader(make(testpath, "test"), cfg.batch_size, device=device)
        mesh = (make_mesh(cfg.mesh_data, cfg.mesh_spatial, cfg.mesh_depth)
                if dist.is_initialized() else None)
        _, _, timing = fit(cfg, tl, el, workdir, mesh=mesh)
        return {"timing": timing, "train_loader": tl.timing, "test_loader": el.timing,
                "train_data": tl.dataset.timing}
    if cfg.mode == "test":
        return _test(cfg, make(testpath, "test"), testpath, workdir, device)
    return _profile(cfg, make(trainpath, "train"), workdir, device)


def _test(cfg, dataset, testpath: str, workdir: str, device) -> dict:
    from ..data import formats
    from ..data.loader import Loader
    from ..train.loop import make_eval_step
    from ..train.metrics import DictAverageMeter

    el = Loader(dataset, cfg.batch_size, device=device)
    model, state, epoch = restore_model(cfg, cfg.loadckpt or workdir, device)
    eval_step = make_eval_step(model, tuple(cfg.dlossw), cfg.min_interval)
    meter = DictAverageMeter()
    out_dir = os.path.join(testpath, "height_result")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    for i, batch in enumerate(el):
        scalars, depth, conf = eval_step(state, batch)
        scal = {k: float(v) for k, v in scalars.items()}
        meter.update(scal)
        print(f"iter {i}/{len(el)} {batch['out_name'][0]} {scal}")
        depth = depth.cpu().numpy().astype(np.float32)
        conf = conf.cpu().numpy().astype(np.float32)
        gt = batch["depth_stages"][-1].cpu().numpy()
        mask = batch["mask_stages"][-1].cpu().numpy()
        for j in range(depth.shape[0]):
            stem = os.path.join(out_dir, f"{batch['out_name'][j]}_{batch['out_view'][j]}")
            formats.save_pfm(stem + ".pfm", depth[j])
            formats.save_pfm(stem + "_prob.pfm", conf[j])
            formats.save_pfm(stem + "_err.pfm",
                             np.where(mask[j] > 0.5, depth[j] - gt[j], np.float32(-999.0)))
    eval_s = time.perf_counter() - t0
    means = meter.mean()
    print(f"height maps written to {out_dir}")
    print("final:", means)
    return {"metrics": means, "epoch": epoch, "out_dir": out_dir, "eval_s": eval_s}


def _profile(cfg, dataset, workdir: str, device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..data.loader import Loader
    from ..train.loop import create_model_and_state, make_train_step

    tl = Loader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed, device=device)
    first = next(iter(tl))
    model, state, tx = create_model_and_state(cfg, first, max(len(tl), 1))
    step = make_train_step(model, tx, tuple(cfg.dlossw))
    state, _ = step(state, first)  # the first step's set-up stays out of the trace
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profile_dir = os.path.join(workdir, "profile")
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        for _ in range(3):
            state, scalars = step(state, first)
        if device.type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    print(f"profile written to {profile_dir}")
    return {"profile_dir": profile_dir}


if __name__ == "__main__":
    main(sys.argv[1:])
