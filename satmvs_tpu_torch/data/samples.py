"""Sample lists over the WHU-TLC directory layout (RPC geometry).

Counterpart of `satmvs_tpu/data/samples.py`.  Layout:
image/{v}/name.png, rpc/{v}/name.rpc, height/{v}/name.pfm.  A sample is
[ref image, ref rpc, src image, src rpc, ..., ref height].
"""

from __future__ import annotations

import os


def _path(root: str, kind: str, view: int, name: str, ext: str) -> str:
    return os.path.join(root, kind, str(view), f"{name}{ext}").replace("\\", "/")


def _list_names(root: str, view: int) -> list[str]:
    return sorted(os.path.splitext(p)[0] for p in os.listdir(os.path.join(root, "image", str(view))))


def _make_sample(root: str, ref_view: int, view_num: int, name: str) -> list[str]:
    sample = [_path(root, "image", ref_view, name, ".png"), _path(root, "rpc", ref_view, name, ".rpc")]
    for s in range(view_num):
        sv = (ref_view + s) % view_num
        if sv != ref_view:
            sample += [_path(root, "image", sv, name, ".png"), _path(root, "rpc", sv, name, ".rpc")]
    sample.append(_path(root, "height", ref_view, name, ".pfm"))
    return sample


def gen_list(root: str, view_num: int, ref_view: int = 2, geo_model: str = "rpc"):
    """Samples with view `ref_view` as the reference, sorted by name; with
    ref_view < 0 every view takes a turn (the prediction mode).  The source
    views follow the reference cyclically."""
    if geo_model != "rpc":
        raise ValueError(f"geo_model {geo_model!r}: the port supports 'rpc' only")
    refs = range(view_num) if ref_view < 0 else [ref_view]
    return [_make_sample(root, r, view_num, name) for r in refs for name in _list_names(root, r)]
