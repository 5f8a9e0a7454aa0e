"""The dataset over the WHU-TLC directory layout, RPC and pinhole geometry.

Counterpart of `satmvs_tpu/data/dataset.py`.  A sample stays on the host:

  imgs          (V, H, W, 3) float32, each view normalized, view 0 the reference
  cams          per-stage cameras on the CPU, coarsest first:
                  rpc      `ops.warp.RpcWarpCams` (`QcWarpCams` with use_qc)
                  pinhole  (V, 4, 4) float32 projection matrices K·E in an
                           object frame moved to the mean camera centre
                           (`geo.pinhole.local_proj_matrices`), rows 0-1
                           scaled to the stage
  depth_values  (2,) float32: [h_min, h_max] of the reference RPC, or the
                reference camera's [d_min, d_max]
  depth_stages / mask_stages   train, val and test modes: coarsest-first
                GT height (depth) and valid-mask pyramids of the reference view
  out_view / out_name          output routing strings

`data.loader.Loader` batches samples and moves them to the device.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..geo import pinhole as pinlib
from ..geo import rpc as rpclib
from ..ops import warp as warplib
from . import formats, preprocess, samples


class MVSDataset:
    """mode ∈ {train, val, test, pred}: train jitters the colours (from
    `seed`); pred takes every view in turn as the reference and reads no
    ground truth; the others take view `ref_view`.  Every view is
    centre-cropped to multiples of 32 (capped at max_h × max_w when
    nonzero) with its camera shifted (an RPC's image offsets, a pinhole
    camera's principal point); a 90-value (direct only) RPC gets its
    inverse fitted on load, once per file.  geo_model "rpc" reads the rpc
    layout (`data.samples`), with use_qc its cameras in QC form; "pinhole"
    reads the camera-text layout.

    A sample's views load in parallel threads.  `timing` adds up, over
    every sample read, the seconds each view spent being read and cropped
    (read_s), having its colours jittered (color_s) and being normalized
    (center_s), and the seconds spent building the cameras and the ground
    truth (cams_gt_s)."""

    def __init__(self, root: str, mode: str, view_num: int = 3, ref_view: int = 2,
                 geo_model: str = "rpc", num_stage: int = 3, seed: int = 0,
                 use_qc: bool = False, max_h: int = 0, max_w: int = 0):
        if mode not in ("train", "val", "test", "pred"):
            raise ValueError(f"mode {mode!r}: want train, val, test or pred")
        if geo_model not in ("rpc", "pinhole"):
            raise ValueError(f"unknown geo_model {geo_model!r}")
        self.root = root
        self.mode = mode
        self.view_num = view_num
        self.geo_model = geo_model
        self.use_qc = use_qc
        self.num_stage = num_stage
        self.max_h = max_h
        self.max_w = max_w
        self._inv_rpc_cache: dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)
        self.timing = {"samples": 0, "read_s": 0.0, "color_s": 0.0, "center_s": 0.0,
                       "cams_gt_s": 0.0}
        self.sample_list = samples.gen_list(root, view_num, -1 if mode == "pred" else ref_view,
                                            geo_model)

    def __len__(self) -> int:
        return len(self.sample_list)

    def _load_rpc_full(self, path: str) -> np.ndarray:
        """The file's 170 RPC values; for a 90-value file the inverse block
        is fitted (`geo.rpc.fit_inverse_rpc`), once per path."""
        cam = formats.load_rpc(path)[0]
        if cam.shape[0] == 170:
            return cam
        hit = self._inv_rpc_cache.get(path)
        if hit is None:
            full = np.zeros(rpclib.NUM_PARAMS, np.float64)
            full[:90] = cam
            hit = rpclib.fit_inverse_rpc(full)
            self._inv_rpc_cache[path] = hit
        return hit

    def _load_cam(self, path: str) -> np.ndarray:
        """One view's camera: 170 RPC values, or the pinhole (2, 4, 4)
        [E; K and the depth row] (`formats.load_camera_nn`)."""
        if self.geo_model == "rpc":
            return self._load_rpc_full(path)
        return formats.load_camera_nn(path)

    def _crop_view(self, img, cam):
        """Centre-crop one view to multiples of 32, shifting its RPC's image
        offsets or its principal point."""
        sh, sw, nh, nw = preprocess.crop_to_multiple(img, self.max_h, self.max_w)
        if (sh, sw, nh, nw) == (0, 0, img.shape[0], img.shape[1]):
            return img, cam, (0, 0, nh, nw)
        if self.geo_model == "rpc":
            cam = rpclib.crop_rpc(cam, sw, sh)
        else:
            cam = np.asarray(cam, np.float64).copy()
            cam[1, 0, 2] -= sw
            cam[1, 1, 2] -= sh
        return img[sh:sh + nh, sw:sw + nw], cam, (sh, sw, nh, nw)

    def _build_cams(self, cams_raw: np.ndarray):
        """The per-stage cameras of a sample's views (view 0 the reference)."""
        if self.geo_model == "rpc":
            build = warplib.build_qc_stage_cams if self.use_qc else warplib.build_stage_cams
            return build(cams_raw, 0, device="cpu", num_stage=self.num_stage)
        projs = pinlib.local_proj_matrices(cams_raw[:, 1, :3, :3], cams_raw[:, 0])
        return tuple(torch.from_numpy(np.asarray(pinlib.scale_proj_matrix(projs, s), np.float32))
                     for s in warplib.STAGE_SCALES[self.num_stage])

    def _depth_range(self, paths) -> np.ndarray:
        """[h_min, h_max] of the reference RPC file, or [d_min, d_max] of the
        reference camera file, float32."""
        if self.geo_model == "rpc":
            _, h_max, h_min = formats.load_rpc(paths[1])
            return np.array([h_min, h_max], dtype=np.float32)
        cam = formats.load_camera_nn(paths[1])
        return np.array([cam[1, 3, 0], cam[1, 3, 3]], dtype=np.float32)

    def _load_view(self, img_path: str, cam_path: str, factors) -> tuple:
        """One view read, cropped, jittered when `factors` is given, and
        normalized; with the seconds of each of the three steps."""
        t0 = time.perf_counter()
        img, cam, window = self._crop_view(formats.read_image(img_path),
                                           self._load_cam(cam_path))
        t1 = time.perf_counter()
        if factors is not None:
            img = preprocess.jitter_color(img, factors)
        t2 = time.perf_counter()
        img = preprocess.center_image(img)
        return img, cam, window, (t1 - t0, t2 - t1, time.perf_counter() - t2)

    def _load_views(self, paths):
        # the colour factors drawn in view order, as JAX's dataset draws
        # them; the views then load in parallel (numpy and zlib release the
        # interpreter lock)
        factors = [preprocess.color_factors(self.rng) if self.mode == "train" else None
                   for _ in range(self.view_num)]
        with ThreadPoolExecutor(self.view_num) as pool:
            views = list(pool.map(self._load_view, paths[0:2 * self.view_num:2],
                                  paths[1:2 * self.view_num:2], factors))
        for key, i in (("read_s", 0), ("color_s", 1), ("center_s", 2)):
            self.timing[key] += sum(v[3][i] for v in views)
        return (np.stack([v[0] for v in views]), np.stack([v[1] for v in views]), views[0][2])

    def __getitem__(self, idx: int) -> dict:
        paths = self.sample_list[idx]
        imgs, cams_raw, (sh, sw, nh, nw) = self._load_views(paths)
        t0 = time.perf_counter()
        depth_values = self._depth_range(paths)
        sample = {
            "imgs": imgs,
            "cams": self._build_cams(cams_raw),
            "depth_values": depth_values,
            "out_view": paths[0].split("/")[-2],
            "out_name": os.path.splitext(os.path.basename(paths[0]))[0],
        }
        if self.mode != "pred":
            depth = formats.load_pfm(paths[2 * self.view_num])[sh:sh + nh, sw:sw + nw]
            mask = ((depth >= depth_values[0]) & (depth <= depth_values[1])).astype(np.float32)
            sample["depth_stages"] = preprocess.build_pyramid(depth, self.num_stage)
            sample["mask_stages"] = preprocess.build_pyramid(mask, self.num_stage)
        self.timing["cams_gt_s"] += time.perf_counter() - t0
        self.timing["samples"] += 1
        return sample


def find_dataset(geo_model: str):
    """The dataset class for `geo_model`: both geo models share one."""
    if geo_model not in ("rpc", "pinhole"):
        raise ValueError(f"unknown geo_model {geo_model!r}")
    return MVSDataset
