"""Coarse-grid evaluation of the RPC plane-sweep coordinates.

Counterpart of `satmvs_tpu/ops/coarse_coords.py`, the coordinates JAX's
sweep takes by default on its accelerator.  The RPC coordinate field is a
smooth rational map at the few-pixel scale, so the exact chain
(`ops.warp.rpc_transform_points`, the port's `geo/rpc.py`: elementwise
fp32, no matmul) runs on a grid subsampled by `factor` (4 by default) plus
one sample past the edge, and an exact separable lerp brings it back to
every pixel.

Per-plane heights ((D,) hypotheses) are evaluated exactly per plane.
Per-pixel hypotheses ((D, H, W)) make the field follow the terrain through
the parallax term, so the height dependence is fitted instead: the chain
runs at three normalized heights h0 − δ, h0, h0 + δ around the mean h0 of
the hypotheses (δ their largest distance from it, at least 1e-3), and each
pixel's coordinate is the quadratic through those three, a + (b + c·Δh)·Δh.

A band of reference rows (row0, height sharding) gives the serial run's
rows: its coarse nodes sit on global multiples of `factor` (row0 must be
one) and `window`, the whole stage's hypotheses, sets h0 and δ.  A (D,)
`window` says the (D, H, W) hypotheses are planes of one height each (the
cascade's first stage), which are then evaluated exactly per plane.
"""

from __future__ import annotations

import torch

from ..geo import rpc as rpclib


def _lerp_upsample_axis(coarse: torch.Tensor, factor: int, axis: int,
                        out_size: int) -> torch.Tensor:
    """Exact linear upsample by `factor` along `axis`: coarse holds n + 1
    samples at 0, f, .., n·f; fine sample j = lerp(coarse[j // f],
    coarse[j // f + 1], (j mod f) / f), cut to out_size."""
    coarse = coarse.movedim(axis, -1)
    left, right = coarse[..., :-1], coarse[..., 1:]
    w = torch.arange(factor, dtype=coarse.dtype, device=coarse.device) / factor
    fine = left[..., None] * (1.0 - w) + right[..., None] * w
    fine = fine.reshape(*fine.shape[:-2], -1)[..., :out_size]
    return fine.movedim(-1, axis)


def _coarse_grid(height: int, width: int, factor: int, row0: int, device):
    """The coarse nodes' rows (from row0) and columns, float32."""
    hc, wc = -(-height // factor), -(-width // factor)
    ys = (torch.arange(hc + 1, device=device) * factor + row0).to(torch.float32)
    xs = (torch.arange(wc + 1, device=device) * factor).to(torch.float32)
    return ys, xs


@torch.no_grad()
def rpc_sweep_coords_coarse(cams, src_index: int, depth_values: torch.Tensor, height: int,
                            width: int, factor: int = 4, row0: int = 0,
                            window: torch.Tensor | None = None):
    """`ops.warp.rpc_sweep_coords` on the coarse grid (module docstring).

    depth_values: (D,) per-plane heights or (D, H, W) per-pixel hypotheses
    of the reference rows row0 .. row0 + H − 1; window: the hypotheses
    whose mean and spread set the quadratic fit's h0 and δ (None:
    depth_values itself; the whole stage's when depth_values is a band or
    a slab of them), or (D,) heights that say depth_values are planes of
    one height each (the first stage's uniform sweep), which the chain then
    evaluates exactly per plane.  Returns (x_src, y_src), each (D, H, W)
    float32.
    """
    if row0 % factor:
        raise ValueError(f"rpc_sweep_coords_coarse: row0={row0} is not a multiple of "
                         f"factor={factor}, so the band's coarse nodes would not be the "
                         f"whole grid's")
    rn = cams.ref_norm
    aff = cams.renorm[src_index]
    dn = cams.src_denorm[src_index]
    fwd = cams.src_fwd[src_index]
    ys, xs = _coarse_grid(height, width, factor, row0, depth_values.device)
    xn = ((xs - rn[0, 0]) * rn[0, 1])[None, :]
    yn = ((ys - rn[1, 0]) * rn[1, 1])[:, None]
    xn, yn = torch.broadcast_tensors(xn, yn)          # (Hc + 1, Wc + 1)

    def project(hn: torch.Tensor):
        """The exact chain over the coarse grid at normalized heights hn
        (broadcast against it)."""
        shape = torch.broadcast_shapes(hn.shape, xn.shape)
        x, y, h = (t.expand(shape) for t in (xn, yn, hn))
        lat_n, lon_n = rpclib.photo_to_obj_n(cams.ref_inv, x, y, h)
        lat_s = lat_n * aff[0, 0] + aff[0, 1]
        lon_s = lon_n * aff[1, 0] + aff[1, 1]
        hei_s = h * aff[2, 0] + aff[2, 1]
        samp_n, line_n = rpclib.obj_to_photo_n(fwd, lat_s, lon_s, hei_s)
        return samp_n * dn[0, 0] + dn[0, 1], line_n * dn[1, 0] + dn[1, 1]

    def upsample(c: torch.Tensor) -> torch.Tensor:
        c = _lerp_upsample_axis(c, factor, -2, height)
        return _lerp_upsample_axis(c, factor, -1, width)

    if window is not None and window.ndim == 1:
        depth_values = window
    h_n = (depth_values.to(torch.float32) - rn[2, 0]) * rn[2, 1]
    if depth_values.ndim == 1:  # per-plane heights: exact per plane
        cx, cy = project(h_n[:, None, None])
        return upsample(cx), upsample(cy)

    # per-pixel hypotheses: the quadratic through three heights of the window
    w_n = h_n if window is None else (window.to(torch.float32) - rn[2, 0]) * rn[2, 1]
    h0 = w_n.mean()
    delta = torch.clamp((w_n - h0).abs().max(), min=1e-3)
    xm, ym = project(h0 - delta)
    xc0, yc0 = project(h0)
    xp, yp = project(h0 + delta)

    def fit(minus, mid, plus):
        return (upsample(mid), upsample((plus - minus) / (2.0 * delta)),
                upsample((plus + minus - 2.0 * mid) / (2.0 * delta * delta)))

    ax, bx, cx = fit(xm, xc0, xp)
    ay, by, cy = fit(ym, yc0, yp)
    dh = h_n - h0                                     # (D, H, W)
    return ax + (bx + cx * dh) * dh, ay + (by + cy * dh) * dh
