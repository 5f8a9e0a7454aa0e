"""Synthetic satellite-MVS scenes: RPC triplets, terrain, rendered views.

Counterpart of `satmvs_tpu/data/synthetic.py`: in-memory scenes and
batches, and the same scenes written to disk in the WHU-TLC layout
(`write_synthetic_dataset`, `write_whu_tlc_tree`; the same files as the
JAX package's writers, PNGs through the port's own codec).  Host-side
numpy float64 throughout; `make_batch` puts the result on a device.  A camera is a hand-built direct RPC (affine ground → image,
height parallax along the look azimuth, small cubic distortions) whose
inverse RPC is fitted with `geo.rpc.fit_inverse_rpc`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..device import resolve_device
from ..geo import rpc as rpclib
from ..ops import warp as warplib
from . import formats, png
from .preprocess import build_pyramid

_M_PER_DEG = 111_320.0  # metres per degree of latitude, near enough


def make_synthetic_rpc(width: int = 256, height: int = 256, gsd: float = 2.5,
                       off_nadir_deg: float = 0.0, azimuth_deg: float = 0.0,
                       lat0: float = 30.0, lon0: float = 120.0, h0: float = 500.0,
                       h_scale: float = 450.0, distortion: float = 3e-3, seed: int = 0,
                       fit_inverse: bool = True) -> np.ndarray:
    """A plausible 170-parameter RPC of one view of a scene."""
    rng = np.random.default_rng(seed)
    data = np.zeros(rpclib.NUM_PARAMS, dtype=np.float64)

    samp_scale = width / 2.0
    line_scale = height / 2.0
    lat_scale = height * gsd / 2.0 / _M_PER_DEG
    lon_scale = width * gsd / 2.0 / (_M_PER_DEG * math.cos(math.radians(lat0)))

    data[rpclib.LINE_OFF] = (height - 1) / 2.0
    data[rpclib.SAMP_OFF] = (width - 1) / 2.0
    data[rpclib.LAT_OFF] = lat0
    data[rpclib.LON_OFF] = lon0
    data[rpclib.HEI_OFF] = h0
    data[rpclib.LINE_SCALE] = line_scale
    data[rpclib.SAMP_SCALE] = samp_scale
    data[rpclib.LAT_SCALE] = lat_scale
    data[rpclib.LON_SCALE] = lon_scale
    data[rpclib.HEI_SCALE] = h_scale

    # height parallax in normalized units
    par = math.tan(math.radians(off_nadir_deg))
    par_samp = par * math.cos(math.radians(azimuth_deg)) * h_scale / (samp_scale * gsd)
    par_line = par * math.sin(math.radians(azimuth_deg)) * h_scale / (line_scale * gsd)

    # basis order [1, L, P, H, LP, ...] with P = lat_n, L = lon_n, H = hei_n
    snum = np.zeros(20)
    snum[1] = 1.0          # samp_n ≈ lon_n
    snum[2] = 0.02         # slight row/column coupling
    snum[3] = par_samp
    lnum = np.zeros(20)
    lnum[2] = -1.0         # line_n ≈ -lat_n (rows grow southward)
    lnum[1] = 0.015
    lnum[3] = par_line

    for vec in (snum, lnum):
        vec[4:10] += rng.normal(0.0, distortion, 6)
        vec[10:20] += rng.normal(0.0, distortion / 10.0, 10)
    sdem = np.zeros(20)
    ldem = np.zeros(20)
    sdem[0] = 1.0
    ldem[0] = 1.0
    sdem[1:4] += rng.normal(0.0, distortion / 3.0, 3)
    ldem[1:4] += rng.normal(0.0, distortion / 3.0, 3)

    data[rpclib.SNUM] = snum
    data[rpclib.SDEM] = sdem
    data[rpclib.LNUM] = lnum
    data[rpclib.LDEM] = ldem

    if fit_inverse:
        data = rpclib.fit_inverse_rpc(data)
    return data


def make_rpc_triplet(width: int = 256, height: int = 256, seed: int = 0, **kw) -> list[np.ndarray]:
    """Forward / backward / nadir looks (views 0, 1, 2; 2 is the nadir)."""
    angles = [(22.0, 0.0), (-22.0, 0.0), (0.0, 0.0)]
    return [
        make_synthetic_rpc(width, height, off_nadir_deg=a, azimuth_deg=az,
                           seed=seed + 17 * i, **kw)
        for i, (a, az) in enumerate(angles)
    ]


def _terrain(lat_n, lon_n, h0: float, h_amp: float, seed: int, freq_scale: float = 1.0):
    """Smooth random terrain h(lat_n, lon_n), a small Fourier series whose
    slope times the ±22° parallax stays < 1 (the renderer's contraction)."""
    rng = np.random.default_rng(seed + 1000)
    h = np.full_like(lat_n, float(h0))
    for k in range(6):
        fx, fy = rng.uniform(0.3, 1.5, 2) * freq_scale
        px, py = rng.uniform(0, 2 * np.pi, 2)
        amp = h_amp / (1.6 ** k) / (1.0 + 0.6 * (fx + fy) / freq_scale)
        h = h + amp * np.sin(fx * np.pi * lon_n + px) * np.sin(fy * np.pi * lat_n + py)
    return h


def _texture(lat_n, lon_n, seed: int, freq_scale: float = 1.0):
    """Ground albedo in [40, 230] with multi-scale detail."""
    rng = np.random.default_rng(seed + 2000)
    t = np.zeros_like(lat_n)
    for k in range(8):
        fx, fy = rng.uniform(2.0, 40.0, 2) * freq_scale
        px, py = rng.uniform(0, 2 * np.pi, 2)
        t = t + np.sin(fx * np.pi * lon_n + px) * np.cos(fy * np.pi * lat_n + py) / (1.2 ** k)
    t = (t - t.min()) / (t.max() - t.min() + 1e-9)
    return 40.0 + 190.0 * t


def render_view(rpc: np.ndarray, width: int, height: int, terrain_seed: int = 0,
                h_amp: float = 120.0, iters: int = 24):
    """One view of the scene and its height map: per pixel, the ray-terrain
    intersection by damped fixed-point iteration, then the ground texture.
    Returns (image (H, W) float32, height map (H, W) float32)."""
    x, y = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    x, y = x.reshape(-1), y.reshape(-1)
    h0 = rpc[rpclib.HEI_OFF]
    fscale = max(1.0, max(width, height) / 256.0)  # size-invariant per-pixel statistics

    def terrain_at(lat, lon):
        lat_n = (lat - rpc[rpclib.LAT_OFF]) / rpc[rpclib.LAT_SCALE]
        lon_n = (lon - rpc[rpclib.LON_OFF]) / rpc[rpclib.LON_SCALE]
        return _terrain(lat_n, lon_n, h0, h_amp, terrain_seed, fscale)

    h = np.full_like(x, float(h0))
    for _ in range(iters):
        lat, lon = rpclib.photo_to_obj(rpc, x, y, h)
        h = 0.5 * h + 0.5 * terrain_at(lat, lon)

    lat, lon = rpclib.photo_to_obj(rpc, x, y, h)
    lat_n = (lat - rpc[rpclib.LAT_OFF]) / rpc[rpclib.LAT_SCALE]
    lon_n = (lon - rpc[rpclib.LON_OFF]) / rpc[rpclib.LON_SCALE]
    img = _texture(lat_n, lon_n, terrain_seed, fscale).reshape(height, width)
    return img.astype(np.float32), h.reshape(height, width).astype(np.float32)


def make_scene(width: int = 128, height: int = 128, seed: int = 0, h_amp: float = 120.0) -> dict:
    """Three rendered views and their height maps: {images (V, H, W),
    rpcs (V, 170) float64, gt_height (H, W) of the nadir view, gt_heights,
    h_range (2,) float32}."""
    rpcs = make_rpc_triplet(width, height, seed=seed)
    images, heights = [], []
    for rpc in rpcs:
        img, hmap = render_view(rpc, width, height, terrain_seed=seed, h_amp=h_amp)
        images.append(img)
        heights.append(hmap)
    h_min, h_max = rpclib.height_range(rpcs[-1])
    return {
        "images": np.stack(images),
        "rpcs": np.stack(rpcs),
        "gt_height": heights[-1],
        "gt_heights": np.stack(heights),
        "h_range": np.array([h_min, h_max], dtype=np.float32),
    }


def make_batch(batch_size: int = 1, width: int = 64, height: int = 64, seed: int = 0,
               with_gt: bool = True, device=None, use_qc: bool = False,
               num_stage: int = 3) -> dict:
    """A batch of synthetic scenes (sample b from seed + b) on `device`
    (the GPU unless "cpu" is passed), for a cascade of num_stage stages
    (3, or 1: the first of each per-stage list below alone, its ground
    truth at full resolution as JAX's `build_pyramid` gives it):

      imgs          (B, V, H, W, 3) float32, reference (nadir) view first,
                    each view normalized to zero mean and unit std
      cams          per-stage batched RpcWarpCams (QcWarpCams with use_qc),
                    coarsest first
      depth_values  (B, 2) float32 scene height range
      depth_stages  with_gt: per-stage GT heights of the reference view,
                    (B, H/4, W/4), (B, H/2, W/2), (B, H, W), coarsest first
      mask_stages   with_gt: per-stage valid masks (all ones), same shapes
    """
    dev = resolve_device(device)
    build = warplib.build_qc_stage_cams if use_qc else warplib.build_stage_cams
    sample_cams, imgs_all, dvals_all, gt_all = [], [], [], []
    for b in range(batch_size):
        scene = make_scene(width, height, seed=seed + b, h_amp=80.0)
        order = [2, 0, 1]  # nadir view is the reference, ref-first
        sample_cams.append(build(scene["rpcs"][order], 0, dev, num_stage))
        imgs = scene["images"][order]
        imgs = (imgs - imgs.mean(axis=(1, 2), keepdims=True)) / (
            imgs.std(axis=(1, 2), keepdims=True) + 1e-8)
        imgs_all.append(np.repeat(imgs[..., None], 3, axis=-1).astype(np.float32))
        dvals_all.append(scene["h_range"])
        gt_all.append(scene["gt_heights"][2])
    batch = {
        "imgs": torch.as_tensor(np.stack(imgs_all), device=dev),
        "cams": tuple(warplib.stack_cams([c[i] for c in sample_cams])
                      for i in range(num_stage)),
        "depth_values": torch.as_tensor(np.stack(dvals_all), device=dev),
    }
    if with_gt:
        pyrs = [build_pyramid(g, num_stage) for g in gt_all]
        batch["depth_stages"] = [torch.as_tensor(np.stack([p[i] for p in pyrs]), device=dev)
                                 for i in range(num_stage)]
        batch["mask_stages"] = [torch.ones_like(d) for d in batch["depth_stages"]]
    return batch


def write_synthetic_dataset(root: str, num_scenes: int = 2, width: int = 64, height: int = 64,
                            view_num: int = 3, seed: int = 0, h_amp: float = 80.0,
                            name_prefix: str = "scene", **rpc_kwargs) -> str:
    """Write synthetic scenes in the WHU-TLC layout under `root`:
    image/{v}/name.png (8-bit gray), rpc/{v}/name.rpc and
    height/{v}/name.pfm for views v of make_rpc_triplet (scene s from seed
    seed + 31·s, named name_prefix + 4 digits).  Returns root."""
    for v in range(view_num):
        for kind in ("image", "rpc", "height"):
            os.makedirs(os.path.join(root, kind, str(v)), exist_ok=True)
    for s in range(num_scenes):
        rpcs = make_rpc_triplet(width, height, seed=seed + 31 * s, **rpc_kwargs)
        name = f"{name_prefix}{s:04d}"
        for v, rpc in enumerate(rpcs):
            img, hmap = render_view(rpc, width, height, terrain_seed=seed + 31 * s, h_amp=h_amp)
            png.write_png(os.path.join(root, "image", str(v), name + ".png"), img.astype(np.uint8))
            formats.save_rpc(os.path.join(root, "rpc", str(v), name + ".rpc"), rpc)
            formats.save_pfm(os.path.join(root, "height", str(v), name + ".pfm"), hmap)
    return root


def write_whu_tlc_tree(root: str, num_train: int = 2, num_test: int = 1, width: int = 64,
                       height: int = 64, seed: int = 0, h_amp: float = 80.0, **rpc_kwargs) -> str:
    """The WHU-TLC "open_dataset" tree with synthetic content:
    <root>/open_dataset_rpc/{train,test}/{image,rpc,height}/{0,1,2}/blockNNNN.*,
    the train split from `seed`, the test split from seed + 1000.  Returns root."""
    for split, n, s0 in (("train", num_train, 0), ("test", num_test, 1000)):
        write_synthetic_dataset(os.path.join(root, "open_dataset_rpc", split), num_scenes=n,
                                width=width, height=height, seed=seed + s0, h_amp=h_amp,
                                name_prefix="block", **rpc_kwargs)
    return root
