"""Model builders.  Counterpart of `satmvs_tpu/models/__init__.py` (RED)."""

from __future__ import annotations

from ..device import resolve_device
from ..params import init_from_seed
from .cascade import CascadeModel


def CascadeREDNet(geo_model: str = "rpc", min_interval: float = 2.5,
                  ndepths=(64, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0),
                  cr_base_chs=(8, 8, 8), device=None, seed: int = 0) -> CascadeModel:
    """CascadeREDNet in eval mode on `device` (the GPU unless "cpu" is
    passed), weights drawn from numpy seed `seed`; load trained weights with
    `params.load_jax_variables`."""
    if geo_model != "rpc":
        raise ValueError(f"geo_model {geo_model!r}: the port supports 'rpc' only")
    dev = resolve_device(device)
    model = CascadeModel(ndepths, depth_intervals_ratio, min_interval, cr_base_chs)
    init_from_seed(model, seed)
    return model.to(dev).eval()
