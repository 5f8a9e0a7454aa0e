"""Configuration: one dataclass carrying the training CLI's knobs.

Counterpart of `satmvs_tpu/train/config.py`, with the same fields, CLI
surface and defaults, so a command line means the same in both packages.
Values whose features the port lacks raise when set away from their
defaults: the mesh extents (multi-GPU), use_qc, geo_model="pinhole",
compute_dtype and volume_dtype other than float32, torch_compat, and
fused_sweep=False.  model "casmvs" and "ucs" run at inference (evaluation,
prediction); training them raises in `loop.create_model_and_state`.
`sweep_stencil` is a tap width of the TPU gather; the port's gather has no
stencil, so it is accepted and has no effect.

fused_red: None ("auto") and True run the RED regularizer's fused pipeline
(its CUDA kernels and their backward kernels) in training and evaluation,
as the JAX package's "auto" does on its accelerator; False runs the scan
path (torch built-ins) in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# field → the value the port supports (every other value raises)
_ONLY = {"geo_model": "rpc", "use_qc": False, "compute_dtype": "float32",
         "volume_dtype": "float32", "torch_compat": False, "mesh_data": 1,
         "mesh_spatial": 1, "mesh_depth": 1}


@dataclasses.dataclass
class Config:
    # mode / model selection
    mode: str = "train"                      # train | test | profile
    model: str = "red"                       # red | casmvs | ucs
    geo_model: str = "rpc"                   # rpc | pinhole
    dataset_root: str = ""
    loadckpt: Optional[str] = None
    logdir: str = "./checkpoints"
    resume: bool = False

    # input
    view_num: int = 3
    ref_view: int = 2
    batch_size: int = 1
    use_qc: bool = False
    max_h: int = 0                           # crop cap (0 = only round to x32)
    max_w: int = 0

    # cascade
    ndepths: Sequence[int] = (64, 32, 8)
    min_interval: float = 2.5                # = image GSD in meters
    depth_inter_r: Sequence[float] = (4.0, 2.0, 1.0)
    lamb: float = 1.5
    dlossw: Sequence[float] = (0.5, 1.0, 2.0)
    cr_base_chs: Sequence[int] = (8, 8, 8)
    sweep_stencil: int = 0                   # TPU tap width: accepted, no effect
    compute_dtype: str = "float32"
    volume_dtype: str = "float32"
    torch_compat: bool = False
    fused_red: Optional[bool] = None         # None = auto: the fused pipeline (see above)
    fused_sweep: Optional[bool] = None       # None/True: the sweep_variance kernel at inference

    # optimization
    epochs: int = 30
    lr: float = 1e-3
    lr_milestones: Sequence[int] = (10, 12, 14)   # epoch ids
    lr_gamma: float = 0.5                          # multiply at each milestone
    wd: float = 0.0
    seed: int = 1

    # logging / checkpointing
    summary_freq: int = 50
    save_freq: int = 1

    # distribution
    mesh_data: int = 1
    mesh_spatial: int = 1
    mesh_depth: int = 1

    def __post_init__(self):
        if self.model not in ("red", "casmvs", "ucs"):
            raise ValueError(f"model={self.model!r}: want 'red', 'casmvs' or 'ucs'")
        for name, value in _ONLY.items():
            if getattr(self, name) != value:
                raise ValueError(f"{name}={getattr(self, name)!r}: the port supports "
                                 f"{name}={value!r} only")
        if self.fused_sweep is False:
            raise ValueError("fused_sweep=False: the port's inference sweep is the "
                             "sweep_variance kernel only")

    @property
    def num_stage(self) -> int:
        return len(self.ndepths)

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "Config":
        import argparse

        p = argparse.ArgumentParser(description="satmvs_tpu_torch")
        d = cls()
        p.add_argument("--mode", default=d.mode, choices=["train", "test", "profile"])
        p.add_argument("--model", default=d.model, choices=["red", "casmvs", "ucs"])
        p.add_argument("--geo_model", default=d.geo_model, choices=["rpc", "pinhole"])
        p.add_argument("--dataset_root", default=d.dataset_root)
        p.add_argument("--loadckpt", default=None)
        p.add_argument("--logdir", default=d.logdir)
        p.add_argument("--resume", action="store_true")
        p.add_argument("--view_num", type=int, default=d.view_num)
        p.add_argument("--ref_view", type=int, default=d.ref_view)
        p.add_argument("--batch_size", type=int, default=d.batch_size)
        p.add_argument("--use_qc", action="store_true")
        p.add_argument("--max_h", type=int, default=d.max_h)
        p.add_argument("--max_w", type=int, default=d.max_w)
        p.add_argument("--ndepths", default="64,32,8")
        p.add_argument("--min_interval", type=float, default=d.min_interval)
        p.add_argument("--depth_inter_r", default="4,2,1")
        p.add_argument("--lamb", type=float, default=d.lamb)
        p.add_argument("--dlossw", default="0.5,1.0,2.0")
        p.add_argument("--cr_base_chs", default="8,8,8")
        p.add_argument("--sweep_stencil", type=int, default=d.sweep_stencil, choices=[0, 4, 8])
        p.add_argument("--compute_dtype", default=d.compute_dtype,
                       choices=["float32", "bfloat16"])
        p.add_argument("--volume_dtype", default=d.volume_dtype,
                       choices=["float32", "bfloat16"])
        p.add_argument("--fused_red", default="auto", choices=["auto", "on", "off"])
        p.add_argument("--fused_sweep", default="auto", choices=["auto", "on", "off"])
        p.add_argument("--epochs", type=int, default=d.epochs)
        p.add_argument("--lr", type=float, default=d.lr)
        p.add_argument("--lrepochs", default="10,12,14:2")
        p.add_argument("--wd", type=float, default=d.wd)
        p.add_argument("--seed", type=int, default=d.seed)
        p.add_argument("--summary_freq", type=int, default=d.summary_freq)
        p.add_argument("--save_freq", type=int, default=d.save_freq)
        p.add_argument("--mesh_data", type=int, default=d.mesh_data)
        p.add_argument("--mesh_spatial", type=int, default=d.mesh_spatial)
        p.add_argument("--mesh_depth", type=int, default=d.mesh_depth)
        a = p.parse_args(argv)

        milestones_str, gamma_str = a.lrepochs.split(":")
        tristate = {"auto": None, "on": True, "off": False}
        return cls(
            mode=a.mode, model=a.model, geo_model=a.geo_model,
            dataset_root=a.dataset_root, loadckpt=a.loadckpt, logdir=a.logdir,
            resume=a.resume, view_num=a.view_num, ref_view=a.ref_view,
            batch_size=a.batch_size, use_qc=a.use_qc, max_h=a.max_h, max_w=a.max_w,
            ndepths=tuple(int(x) for x in a.ndepths.split(",") if x),
            min_interval=a.min_interval,
            depth_inter_r=tuple(float(x) for x in a.depth_inter_r.split(",") if x),
            lamb=a.lamb,
            dlossw=tuple(float(x) for x in a.dlossw.split(",") if x),
            cr_base_chs=tuple(int(x) for x in a.cr_base_chs.split(",") if x),
            sweep_stencil=a.sweep_stencil, compute_dtype=a.compute_dtype,
            volume_dtype=a.volume_dtype, fused_red=tristate[a.fused_red],
            fused_sweep=tristate[a.fused_sweep],
            epochs=a.epochs, lr=a.lr,
            lr_milestones=tuple(int(x) for x in milestones_str.split(",") if x),
            lr_gamma=1.0 / float(gamma_str),
            wd=a.wd, seed=a.seed, summary_freq=a.summary_freq, save_freq=a.save_freq,
            mesh_data=a.mesh_data, mesh_spatial=a.mesh_spatial, mesh_depth=a.mesh_depth,
        )
