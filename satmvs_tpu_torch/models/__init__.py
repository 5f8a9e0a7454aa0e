"""Model builders.  Counterpart of `satmvs_tpu/models/__init__.py`: the three
families as configurations of `CascadeModel`, with the JAX package's
signatures and defaults, each in eval mode on `device` (the GPU unless
"cpu" is passed) with weights drawn from numpy seed `seed`; load trained
weights with `params.load_jax_variables`.

  CascadeREDNet  RED regularizer, unet features, max-prob confidence
  CascadeMVSNet  CostRegNet, fpn features, 4-plane window confidence,
                 detached inter-stage depth
  UCSNet         CostRegNet, unet features, uncertainty windows (λ·std)
"""

from __future__ import annotations

from ..device import resolve_device
from ..params import init_from_seed
from .cascade import CascadeModel

MODEL_NAMES = ("red", "casmvs", "ucs")


def _build(geo_model: str, device, seed: int, **knobs) -> CascadeModel:
    if geo_model != "rpc":
        raise ValueError(f"geo_model {geo_model!r}: the port supports 'rpc' only")
    dev = resolve_device(device)
    model = CascadeModel(**knobs)
    init_from_seed(model, seed)
    return model.to(dev).eval()


def CascadeREDNet(geo_model: str = "rpc", min_interval: float = 2.5,
                  ndepths=(64, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0),
                  cr_base_chs=(8, 8, 8), fused_red: bool | None = None,
                  train_fused_sweep: bool = False, device=None, seed: int = 0) -> CascadeModel:
    """CascadeREDNet.  `fused_red` and `train_fused_sweep` are
    `CascadeModel`'s (the JAX package's environment override of fused_red
    is not ported)."""
    return _build(geo_model, device, seed, ndepths=tuple(ndepths),
                  depth_intervals_ratio=tuple(depth_intervals_ratio), min_interval=min_interval,
                  cr_base_chs=tuple(cr_base_chs), fused_red=fused_red,
                  train_fused_sweep=train_fused_sweep, arch_mode="unet", regularizer="red",
                  sampler="window", confidence="max", grad_method="through")


def CascadeMVSNet(geo_model: str = "rpc", min_interval: float = 2.5, ndepths=(64, 32, 8),
                  depth_intervals_ratio=(4.0, 2.0, 1.0), cr_base_chs=(8, 8, 8),
                  share_cr: bool = False, grad_method: str = "detach", arch_mode: str = "fpn",
                  device=None, seed: int = 0, **kw) -> CascadeModel:
    """CascadeMVSNet; `kw` are further `CascadeModel` knobs."""
    return _build(geo_model, device, seed, min_interval=min_interval, ndepths=tuple(ndepths),
                  depth_intervals_ratio=tuple(depth_intervals_ratio),
                  cr_base_chs=tuple(cr_base_chs), arch_mode=arch_mode,
                  regularizer="costreg", sampler="window", confidence="window4",
                  grad_method=grad_method, share_cr=share_cr, **kw)


def UCSNet(geo_model: str = "rpc", lamb: float = 1.5, ndepths=(64, 32, 8),
           cr_base_chs=(8, 8, 8), feat_base_chs: int = 8, grad_method: str = "detach",
           device=None, seed: int = 0, **kw) -> CascadeModel:
    """UCSNet; `kw` are further `CascadeModel` knobs."""
    return _build(geo_model, device, seed, ndepths=tuple(ndepths),
                  cr_base_chs=tuple(cr_base_chs), feat_base_chs=feat_base_chs,
                  arch_mode="unet", regularizer="costreg", sampler="uncertainty",
                  confidence="window4", grad_method=grad_method, lamb=lamb, **kw)


def build_model(name: str, geo_model: str, **kw) -> CascadeModel:
    """Model dispatch by CLI name (the JAX package's environment overrides
    of fused_red and fused_sweep are not ported)."""
    builders = {"red": CascadeREDNet, "casmvs": CascadeMVSNet, "ucs": UCSNet}
    if name not in builders:
        raise ValueError(f"unknown model {name!r}; expected one of {MODEL_NAMES}")
    return builders[name](geo_model, **kw)
