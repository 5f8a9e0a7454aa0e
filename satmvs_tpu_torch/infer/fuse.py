"""Multi-view fusion: geometric-consistency filtering and DSM rasterization.

Counterpart of `satmvs_tpu/infer/fuse.py`.  The reprojection chains run on
the device (the GPU unless "cpu" is passed) in float32, as elementwise
products and sums with no matmul, so no TF32 setting reaches them: RPC
through the warp's normalized chain (`ops.warp.rpc_transform_points`),
pinhole through each pair's 4×4 relative transform, formed in float64
(`ops.warp.relative_transform`).  Georeferencing (photo → lat/lon → UTM
grid) and rasterization stay on the host in float64; they are RPC's only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import formats
from ..device import resolve_device
from ..geo import rpc as rpclib
from ..geo.tmerc import TransverseMercator
from ..ops.sampling import bilinear_sample_scalar
from ..ops.warp import (RpcWarpCams, build_rpc_warp_cams, guard_z, relative_transform,
                        rpc_transform_points)

INVALID_DEPTH = -999.0


def _check_consistency_rpc(depth_ref: torch.Tensor, depth_src: torch.Tensor,
                           cams_rs: RpcWarpCams, cams_sr: RpcWarpCams, p_ratio: float,
                           d_ratio: float):
    """Forward-backward reprojection check of one (ref, src) pair: a ref
    pixel at its height goes to the src view, takes the src height there
    (bilinear, INVALID_DEPTH outside), and comes back at that height; it is
    consistent iff it lands < p_ratio px from where it started and the two
    heights differ by < d_ratio m.  Returns (mask, the src height where
    consistent else 0)."""
    h, w = depth_ref.shape
    dev = depth_ref.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    x_src, y_src = rpc_transform_points(cams_rs, 0, xs, ys, depth_ref)
    sampled = bilinear_sample_scalar(depth_src, x_src, y_src, fill=INVALID_DEPTH)
    x_re, y_re = rpc_transform_points(cams_sr, 0, x_src, y_src, sampled)
    dist = torch.hypot(x_re - xs, y_re - ys)
    mask = (dist < p_ratio) & ((sampled - depth_ref).abs() < d_ratio)
    return mask, torch.where(mask, sampled, torch.zeros_like(sampled))


@torch.no_grad()
def filter_depth_rpc(depths: np.ndarray, rpcs: np.ndarray, p_ratio: float = 1.0,
                     d_ratio: float = 2.5, geo_consist_num: int = 1,
                     prob: np.ndarray | None = None, confidence_ratio: float = 0.0,
                     device=None):
    """Fuse one scene's per-view height maps into a filtered reference map.

    depths (V, H, W), view 0 the reference; rpcs (V, 170) float64; prob
    (H, W) the reference's photometric confidence.  A pixel is kept where
    prob > confidence_ratio and at least geo_consist_num source views are
    consistent; its height is the mean of the reference's and the
    consistent views'.  Runs on `device` (the GPU unless "cpu" is passed).
    Returns (final_mask (H, W) bool, fused_height (H, W) float32), numpy.
    """
    dev = resolve_device(device)
    depths = np.asarray(depths, np.float32)
    ref_depth = torch.from_numpy(depths[0]).to(dev)
    if prob is not None:
        photo_mask = torch.from_numpy(np.asarray(prob, np.float32)).to(dev) > confidence_ratio
    else:
        photo_mask = torch.ones_like(ref_depth, dtype=torch.bool)
    geo_count = torch.zeros_like(ref_depth, dtype=torch.int32)
    height_sum = ref_depth.clone()
    for v in range(1, depths.shape[0]):
        pair = np.stack([rpcs[0], rpcs[v]])
        cams_rs = build_rpc_warp_cams(pair, 0, device=dev)
        cams_sr = build_rpc_warp_cams(pair[::-1], 0, device=dev)
        mask, reproj = _check_consistency_rpc(ref_depth, torch.from_numpy(depths[v]).to(dev),
                                              cams_rs, cams_sr, p_ratio, d_ratio)
        geo_count += mask.to(torch.int32)
        height_sum += reproj
    fused = height_sum / (geo_count + 1).to(torch.float32)
    final_mask = photo_mask & (geo_count >= geo_consist_num)
    return final_mask.cpu().numpy(), fused.cpu().numpy()


def _project_pinhole(rel: torch.Tensor, x, y, d):
    """Pixels (x, y) at depth d through a 4×4 relative transform rel (float32)
    → (x', y', d') in the other view, the z division guarded (`ops.warp.guard_z`)."""
    p = [rel[c, 0] * (x * d) + rel[c, 1] * (y * d) + rel[c, 2] * d + rel[c, 3] for c in range(3)]
    z = guard_z(p[2])
    return p[0] / z, p[1] / z, p[2]


def _check_consistency_pinhole(depth_ref: torch.Tensor, depth_src: torch.Tensor,
                               rel_rs: torch.Tensor, rel_sr: torch.Tensor, p_thre: float,
                               rel_d_thre: float):
    """`_check_consistency_rpc` of pinhole cameras: a ref pixel at its depth
    goes to the src view (rel_rs = src · ref⁻¹), takes the src depth there
    and comes back (rel_sr); it is consistent iff it lands < p_thre px
    from where it started and the depth it comes back with differs from the
    reference's by < rel_d_thre of it.  Returns (mask, the returned depth
    where consistent else 0)."""
    h, w = depth_ref.shape
    dev = depth_ref.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    x_src, y_src, _ = _project_pinhole(rel_rs, xs, ys, depth_ref)
    sampled = bilinear_sample_scalar(depth_src, x_src, y_src, fill=INVALID_DEPTH)
    x_re, y_re, d_re = _project_pinhole(rel_sr, x_src, y_src, sampled)
    dist = torch.hypot(x_re - xs, y_re - ys)
    rel_diff = (d_re - depth_ref).abs() / depth_ref.clamp(min=1e-6)
    mask = (dist < p_thre) & (rel_diff < rel_d_thre)
    return mask, torch.where(mask, d_re, torch.zeros_like(d_re))


@torch.no_grad()
def filter_depth_pinhole(depths: np.ndarray, projs: np.ndarray, p_thre: float = 1.0,
                         rel_d_thre: float = 0.01, geo_consist_num: int = 1,
                         prob: np.ndarray | None = None, confidence_ratio: float = 0.0,
                         device=None):
    """`filter_depth_rpc` of pinhole cameras: depths (V, H, W) along each
    camera's axis, view 0 the reference; projs (V, 4, 4) projection
    matrices K·E; the depth test relative (< rel_d_thre of the reference
    depth).  A kept pixel's depth is the mean of the reference's and the
    consistent views' returned depths.  Runs on `device` (the GPU unless
    "cpu" is passed).  Returns (final_mask (H, W) bool, fused_depth (H, W)
    float32), numpy."""
    dev = resolve_device(device)
    depths = np.asarray(depths, np.float32)
    projs = torch.as_tensor(np.asarray(projs, np.float64), device=dev)
    ref_depth = torch.from_numpy(depths[0]).to(dev)
    if prob is not None:
        photo_mask = torch.from_numpy(np.asarray(prob, np.float32)).to(dev) > confidence_ratio
    else:
        photo_mask = torch.ones_like(ref_depth, dtype=torch.bool)
    geo_count = torch.zeros_like(ref_depth, dtype=torch.int32)
    depth_sum = ref_depth.clone()
    for v in range(1, depths.shape[0]):
        mask, reproj = _check_consistency_pinhole(
            ref_depth, torch.from_numpy(depths[v]).to(dev),
            relative_transform(projs[v], projs[0]), relative_transform(projs[0], projs[v]),
            p_thre, rel_d_thre)
        geo_count += mask.to(torch.int32)
        depth_sum += reproj
    fused = depth_sum / (geo_count + 1).to(torch.float32)
    final_mask = photo_mask & (geo_count >= geo_consist_num)
    return final_mask.cpu().numpy(), fused.cpu().numpy()


def rasterize_dsm(lat: np.ndarray, lon: np.ndarray, height: np.ndarray, mask: np.ndarray,
                  tm: TransverseMercator, grid_res: float = 5.0,
                  invalid: float = INVALID_DEPTH):
    """Bin the masked (lat, lon, h) points into a north-up UTM grid of
    grid_res metres, the mean height of each cell, `invalid` where no point
    falls.  Returns (dsm (Hg, Wg) float32, e_ul, n_ul), the upper-left
    corner for the TFW sidecar."""
    m = np.asarray(mask, bool).reshape(-1)
    pts = np.stack([np.asarray(lat).reshape(-1)[m], np.asarray(lon).reshape(-1)[m]], -1)
    h = np.asarray(height, np.float64).reshape(-1)[m]
    if pts.shape[0] == 0:
        raise ValueError("no valid points to rasterize")
    en = tm.proj(pts)
    e, n = en[:, 0], en[:, 1]
    e_min, e_max = e.min(), e.max()
    n_min, n_max = n.min(), n.max()
    wg = int(np.ceil((e_max - e_min) / grid_res)) + 1
    hg = int(np.ceil((n_max - n_min) / grid_res)) + 1
    col = np.clip(((e - e_min) / grid_res).astype(np.int64), 0, wg - 1)
    row = np.clip(((n_max - n) / grid_res).astype(np.int64), 0, hg - 1)
    idx = row * wg + col
    acc = np.zeros(hg * wg, np.float64)
    cnt = np.zeros(hg * wg, np.int64)
    np.add.at(acc, idx, h)
    np.add.at(cnt, idx, 1)
    dsm = np.full(hg * wg, invalid, np.float64)
    filled = cnt > 0
    dsm[filled] = acc[filled] / cnt[filled]
    return dsm.reshape(hg, wg).astype(np.float32), float(e_min), float(n_max)


def fuse_scene_to_dsm(depths: np.ndarray, rpcs: np.ndarray, out_path: str,
                      tm: TransverseMercator | None = None, grid_res: float = 5.0,
                      prob: np.ndarray | None = None, device=None, **filter_kw):
    """Filter one scene's height maps (`filter_depth_rpc` on `device`), take
    the fused reference heights to (lat, lon) through the reference RPC
    (host float64), and write the UTM DSM (`formats.write_dsm`; by default
    the UTM zone of the reference RPC's centre).  Returns (raster path,
    final_mask, fused_height)."""
    tm = tm or TransverseMercator.utm_for(float(rpcs[0][rpclib.LON_OFF]))
    final_mask, fused = filter_depth_rpc(depths, rpcs, prob=prob, device=device, **filter_kw)
    h, w = fused.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    lat, lon = rpclib.photo_to_obj(np.asarray(rpcs[0], np.float64), xs.ravel(), ys.ravel(),
                                   fused.astype(np.float64).ravel())
    dsm, e_ul, n_ul = rasterize_dsm(lat, lon, fused.ravel(), final_mask.ravel(), tm, grid_res)
    return formats.write_dsm(out_path, dsm, e_ul, n_ul, grid_res, grid_res), final_mask, fused
