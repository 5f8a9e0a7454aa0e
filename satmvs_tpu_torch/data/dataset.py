"""The dataset over the WHU-TLC directory layout, RPC geometry.

Counterpart of `satmvs_tpu/data/dataset.py` (its RPC branch).  A sample
stays on the host:

  imgs          (V, H, W, 3) float32, each view normalized, view 0 the reference
  cams          per-stage `ops.warp.RpcWarpCams` on the CPU, coarsest first
  depth_values  (2,) float32 [h_min, h_max] of the reference RPC
  depth_stages / mask_stages   train, val and test modes: coarsest-first
                GT height and valid-mask pyramids of the reference view
  out_view / out_name          output routing strings

`data.loader.Loader` batches samples and moves them to the device.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..geo import rpc as rpclib
from ..ops import warp as warplib
from . import formats, preprocess, samples


class MVSDataset:
    """mode ∈ {train, val, test, pred}: train jitters the colours (from
    `seed`); pred takes every view in turn as the reference and reads no
    ground truth; the others take view `ref_view`.  Every view is
    centre-cropped to multiples of 32 (capped at max_h × max_w when
    nonzero) with its RPC shifted; a 90-value (direct only) RPC gets its
    inverse fitted on load, once per file.

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
        if geo_model != "rpc":
            raise ValueError(f"geo_model {geo_model!r}: the port supports 'rpc' only")
        if use_qc:
            raise ValueError("use_qc=True: the QC-form RPC warp is not ported")
        self.root = root
        self.mode = mode
        self.view_num = view_num
        self.num_stage = num_stage
        self.max_h = max_h
        self.max_w = max_w
        self._inv_rpc_cache: dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)
        self.timing = {"samples": 0, "read_s": 0.0, "color_s": 0.0, "center_s": 0.0,
                       "cams_gt_s": 0.0}
        self.sample_list = samples.gen_list(root, view_num, -1 if mode == "pred" else ref_view)

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

    def _crop_view(self, img, cam):
        """Centre-crop one view to multiples of 32, shifting its RPC."""
        sh, sw, nh, nw = preprocess.crop_to_multiple(img, self.max_h, self.max_w)
        if (sh, sw, nh, nw) == (0, 0, img.shape[0], img.shape[1]):
            return img, cam, (0, 0, nh, nw)
        return img[sh:sh + nh, sw:sw + nw], rpclib.crop_rpc(cam, sw, sh), (sh, sw, nh, nw)

    def _load_view(self, img_path: str, rpc_path: str, factors) -> tuple:
        """One view read, cropped, jittered when `factors` is given, and
        normalized; with the seconds of each of the three steps."""
        t0 = time.perf_counter()
        img, cam, window = self._crop_view(formats.read_image(img_path),
                                           self._load_rpc_full(rpc_path))
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
        imgs, rpcs, (sh, sw, nh, nw) = self._load_views(paths)
        t0 = time.perf_counter()
        _, h_max, h_min = formats.load_rpc(paths[1])
        depth_values = np.array([h_min, h_max], dtype=np.float32)
        sample = {
            "imgs": imgs,
            "cams": warplib.build_stage_cams(rpcs, 0, device="cpu", num_stage=self.num_stage),
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
    """The dataset class for `geo_model` (the port has the RPC one)."""
    if geo_model != "rpc":
        raise ValueError(f"geo_model {geo_model!r}: the port supports 'rpc' only")
    return MVSDataset
