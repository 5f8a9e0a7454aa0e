"""RPC plane-sweep geometry.

Counterpart of `satmvs_tpu/ops/warp.py` (RPC, exact per-pixel coordinates).
`build_rpc_warp_cams` turns (V, 170) float64 RPCs into the float32
`RpcWarpCams` the device chain consumes; float64 appears only there, on the
host.  The chain ref photo → ref-normalized object → (host-fp64 renorm
affine) → src-normalized object → src photo then runs in float32 without
ever forming absolute lat/lon.  Geometry carries no gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..geo import rpc as rpclib


@dataclasses.dataclass(frozen=True)
class RpcWarpCams:
    """float32 camera bundle of one (ref, srcs...) plane sweep.

    The source-view axis S = V - 1 leads the src_* fields.  A batched bundle
    (from `stack_cams`) has one more leading axis B on every field; index it
    with `cams[b]` to get one sample's bundle.
    """

    ref_inv: torch.Tensor     # (20, 4)    inverse RPC of the reference view
    ref_norm: torch.Tensor    # (3, 2)     [[off, 1/scale] x (samp, line, hei)]
    src_fwd: torch.Tensor     # (S, 20, 4) direct RPCs of the source views
    src_denorm: torch.Tensor  # (S, 2, 2)  [[scale, off] x (samp, line)]
    renorm: torch.Tensor      # (S, 3, 2)  [[scale, shift] x (lat, lon, hei)]

    def map(self, fn) -> "RpcWarpCams":
        """The bundle with fn applied to every field."""
        return RpcWarpCams(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))

    def to(self, device) -> "RpcWarpCams":
        return self.map(lambda t: t.to(device))

    def __getitem__(self, b) -> "RpcWarpCams":
        return self.map(lambda t: t[b])


def build_rpc_warp_cams(rpcs, ref_index: int = 0, stage_scale: float = 1.0,
                        device=None) -> RpcWarpCams:
    """`RpcWarpCams` from raw (V, 170) float64 RPCs, row `ref_index` the
    reference view, for a cascade stage at image scale `stage_scale`."""
    dev = resolve_device(device)
    rpcs = np.asarray(rpcs, dtype=np.float64)
    scaled = np.stack([rpclib.scale_rpc(r, stage_scale) for r in rpcs])
    ref = scaled[ref_index]
    srcs = [scaled[v] for v in range(len(scaled)) if v != ref_index]

    ref_norm = np.array([
        [ref[rpclib.SAMP_OFF], 1.0 / ref[rpclib.SAMP_SCALE]],
        [ref[rpclib.LINE_OFF], 1.0 / ref[rpclib.LINE_SCALE]],
        [ref[rpclib.HEI_OFF], 1.0 / ref[rpclib.HEI_SCALE]],
    ])
    src_denorm = np.stack([
        np.array([[s[rpclib.SAMP_SCALE], s[rpclib.SAMP_OFF]],
                  [s[rpclib.LINE_SCALE], s[rpclib.LINE_OFF]]])
        for s in srcs
    ])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return RpcWarpCams(
        ref_inv=f32(rpclib.inv_coef_matrix(ref)),
        ref_norm=f32(ref_norm),
        src_fwd=f32(np.stack([rpclib.fwd_coef_matrix(s) for s in srcs])),
        src_denorm=f32(src_denorm),
        renorm=f32(np.stack([rpclib.renorm_affine(ref, s) for s in srcs])),
    )


def build_stage_cams(rpcs, ref_index: int = 0, device=None):
    """Camera bundles of the three cascade stages, coarsest first (image
    scales 1/4, 1/2, 1)."""
    return tuple(build_rpc_warp_cams(rpcs, ref_index, s, device) for s in (0.25, 0.5, 1.0))


def stack_cams(cams_list) -> RpcWarpCams:
    """Stack per-sample bundles into one batched bundle (leading B)."""
    return RpcWarpCams(*(
        torch.stack([getattr(c, f.name) for c in cams_list])
        for f in dataclasses.fields(RpcWarpCams)
    ))


def rpc_transform_points(cams: RpcWarpCams, src_index: int, x, y, h):
    """Reference-view photo coordinates + heights → source-view photo
    coordinates (x_src, y_src), shaped like x.  Unbatched `cams`."""
    rn = cams.ref_norm
    xn = (x - rn[0, 0]) * rn[0, 1]
    yn = (y - rn[1, 0]) * rn[1, 1]
    hn = (h - rn[2, 0]) * rn[2, 1]

    lat_n, lon_n = rpclib.photo_to_obj_n(cams.ref_inv, xn, yn, hn)

    aff = cams.renorm[src_index]
    lat_s = lat_n * aff[0, 0] + aff[0, 1]
    lon_s = lon_n * aff[1, 0] + aff[1, 1]
    hei_s = hn * aff[2, 0] + aff[2, 1]

    samp_n, line_n = rpclib.obj_to_photo_n(cams.src_fwd[src_index], lat_s, lon_s, hei_s)

    dn = cams.src_denorm[src_index]
    return samp_n * dn[0, 0] + dn[0, 1], line_n * dn[1, 0] + dn[1, 1]


@torch.no_grad()
def rpc_sweep_coords(cams: RpcWarpCams, src_index: int, depth_values: torch.Tensor,
                     height: int, width: int):
    """Source-view pixel coordinates of the RPC plane sweep.

    depth_values: (D, H, W) or (D,) height hypotheses in metres.
    Returns (x_src, y_src), each (D, H, W) float32, exact per pixel.
    """
    d = depth_values.shape[0]
    dev = depth_values.device
    hyp = depth_values.to(torch.float32)
    if hyp.ndim == 1:
        hyp = hyp.reshape(d, 1, 1)
    hyp = hyp.expand(d, height, width)
    xs = torch.arange(width, dtype=torch.float32, device=dev).expand(d, height, width)
    ys = torch.arange(height, dtype=torch.float32, device=dev).reshape(height, 1).expand(
        d, height, width)
    return rpc_transform_points(cams, src_index, xs, ys, hyp)
