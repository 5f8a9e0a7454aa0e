"""Sample lists over the WHU-TLC directory layout.

Counterpart of `satmvs_tpu/data/samples.py`.  Layouts:
  rpc geo model:     image/{v}/name.png  rpc/{v}/name.rpc     height/{v}/name.pfm
  pinhole geo model: image/{v}/name.png  camera/{v}/name.txt  depth/{v}/name.pfm
A sample is [ref image, ref camera, src image, src camera, ..., ref height
or depth].
"""

from __future__ import annotations

import os


def _path(root: str, kind: str, view: int, name: str, ext: str) -> str:
    return os.path.join(root, kind, str(view), f"{name}{ext}").replace("\\", "/")


def _list_names(root: str, view: int) -> list[str]:
    return sorted(os.path.splitext(p)[0] for p in os.listdir(os.path.join(root, "image", str(view))))


_LAYOUT = {"rpc": ("rpc", ".rpc", "height"), "pinhole": ("camera", ".txt", "depth")}


def _make_sample(root: str, ref_view: int, view_num: int, name: str, geo_model: str) -> list[str]:
    cam_dir, cam_ext, gt_dir = _LAYOUT[geo_model]
    sample = []
    for s in range(view_num):
        sv = (ref_view + s) % view_num  # the reference first, then the others cyclically
        sample += [_path(root, "image", sv, name, ".png"), _path(root, cam_dir, sv, name, cam_ext)]
    sample.append(_path(root, gt_dir, ref_view, name, ".pfm"))
    return sample


def gen_list(root: str, view_num: int, ref_view: int = 2, geo_model: str = "rpc"):
    """Samples with view `ref_view` as the reference, sorted by name; with
    ref_view < 0 every view takes a turn (the prediction mode).  The source
    views follow the reference cyclically.  geo_model: "rpc" or "pinhole"
    (the module docstring's layouts)."""
    if geo_model not in _LAYOUT:
        raise ValueError(f"unknown geo_model {geo_model!r}")
    refs = range(view_num) if ref_view < 0 else [ref_view]
    return [_make_sample(root, r, view_num, name, geo_model)
            for r in refs for name in _list_names(root, r)]
