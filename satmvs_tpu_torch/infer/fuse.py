"""Multi-view fusion: geometric-consistency filtering and DSM rasterization.

Counterpart of `satmvs_tpu/infer/fuse.py` (RPC geometry).  The reprojection
chain runs on the device (the GPU unless "cpu" is passed) in float32
through the warp's normalized RPC chain (`ops.warp.rpc_transform_points`:
elementwise products and sums, no matmul, so no TF32 setting reaches it);
georeferencing (photo → lat/lon → UTM grid) and rasterization stay on the
host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import formats
from ..device import resolve_device
from ..geo import rpc as rpclib
from ..geo.tmerc import TransverseMercator
from ..ops.sampling import bilinear_sample_scalar
from ..ops.warp import RpcWarpCams, build_rpc_warp_cams, rpc_transform_points

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
