"""File formats: PFM, RPC text, pinhole camera text, TFW, images, scene
rasters, DSM rasters.

Counterpart of `satmvs_tpu/data/formats.py`.  PNG goes through the port's
own codec (`data/png.py`) always; other rasters (TIFF) through GDAL or
Pillow where one is importable, and raise an error naming the format where
neither is.  A DSM is a GeoTIFF
with GDAL, else a PFM with the same TFW sidecar.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from . import png


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------
def load_pfm(path: str) -> np.ndarray:
    """Read a PFM file → (H, W) or (H, W, 3) float32, top row first.  The
    native decoder (`native.pfm_read`) reads it where the library is built,
    as the JAX package's does."""
    from .. import native

    if native.available():
        out = native.pfm_read(path)
        if out is not None:
            return out
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not dim_match:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().decode("latin-1").rstrip())
        data = np.fromfile(f, "<f" if scale < 0 else ">f")
    shape = (height, width, 3) if color else (height, width)
    if data.size != np.prod(shape):
        raise ValueError(f"{path}: PFM holds {data.size} values, header says {shape}")
    return np.flipud(data.reshape(shape)).astype(np.float32)


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write an (H, W), (H, W, 1) or (H, W, 3) float32 image as PFM.  Where
    the native library is built it writes the file (`native.pfm_write`) as
    the JAX package's does: little endian with scale −1.0 whatever `scale`
    is passed.  The numpy path writes ±`scale` by the array's byte order."""
    image = np.asarray(image)
    if image.dtype.name != "float32":
        raise ValueError("PFM image dtype must be float32")
    color = image.ndim == 3 and image.shape[2] == 3
    if not (color or image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1)):
        raise ValueError("image must be HxW, HxWx1, or HxWx3")
    from .. import native

    if native.available() and native.pfm_write(path, image):
        return
    endian = image.dtype.byteorder
    if endian == "<" or (endian == "=" and sys.byteorder == "little"):
        scale = -scale
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        f.write(np.flipud(image).tobytes())


# ---------------------------------------------------------------------------
# RPC text
# ---------------------------------------------------------------------------
_RPC_SCALAR_LABELS = [
    "LINE_OFF:", "SAMP_OFF:", "LAT_OFF:", "LONG_OFF:", "HEIGHT_OFF:",
    "LINE_SCALE:", "SAMP_SCALE:", "LAT_SCALE:", "LONG_SCALE:", "HEIGHT_SCALE:",
]
_RPC_SCALAR_UNITS = [
    "pixels", "pixels", "degrees", "degrees", "meters",
    "pixels", "pixels", "degrees", "degrees", "meters",
]
_RPC_BLOCKS = [
    "LINE_NUM_COEFF", "LINE_DEN_COEFF", "SAMP_NUM_COEFF", "SAMP_DEN_COEFF",
    "LAT_NUM_COEFF", "LAT_DEN_COEFF", "LONG_NUM_COEFF", "LONG_DEN_COEFF",
]


def load_rpc(path: str):
    """Read a `.rpc` text file → ((N,) float64, h_max, h_min); N is 90
    (direct only) or 170 (direct + inverse), each value the second
    space-separated token of its line."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"RPC not found: {path}")
    with open(path) as f:
        lines = f.read().splitlines()
    data = np.array([ln.split(" ")[1] for ln in lines if ln.strip()], dtype=np.float64)
    if data.shape[0] not in (90, 170):
        raise ValueError(f"{path}: expected 90 or 170 RPC values, got {data.shape[0]}")
    return data, data[4] + data[9], data[4] - data[9]


def save_rpc(path: str, data: np.ndarray) -> None:
    """Write a 90- or 170-value RPC in the `.rpc` text layout."""
    data = np.asarray(data, dtype=np.float64)
    lines = [f"{label} {float(val):.17g} {unit}"
             for label, val, unit in zip(_RPC_SCALAR_LABELS, data[:10], _RPC_SCALAR_UNITS)]
    for blk in range((data.shape[0] - 10) // 20):
        lines += [f"{_RPC_BLOCKS[blk]}_{i + 1}: {float(data[10 + blk * 20 + i]):.17g}"
                  for i in range(20)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# pinhole camera text: the 4×4 extrinsics, then "f x0 y0", then
# "d_min d_max d_interval" (one focal length, no skew)
# ---------------------------------------------------------------------------
def load_camera(path: str):
    """Read a pinhole camera text file → (K (3, 3), E (4, 4), d_min, d_max,
    d_interval), float64."""
    with open(path) as f:
        lines = f.read().splitlines()
    e = np.array([[float(v) for v in lines[r].split(" ")] for r in range(4)])
    f_, x0, y0 = (float(v) for v in lines[5].split(" "))
    k = np.array([[f_, 0.0, x0], [0.0, f_, y0], [0.0, 0.0, 1.0]])
    d_min, d_max, d_inter = (float(v) for v in lines[7].split(" "))
    return k, e, d_min, d_max, d_inter


def save_camera(path, k, r, t, d_min, d_max, d_interval, img_index=0, width=0, height=0):
    """Write a pinhole camera text file of K (its K[0, 0], K[0, 2] and
    K[1, 2]), R (3, 3), t (3,) and the depth range."""
    e = np.concatenate([np.asarray(r), np.asarray(t).reshape(3, 1)], axis=-1)
    lines = [" ".join(str(v) for v in row) for row in e]
    lines += ["0 0 0 1", "", f"{k[0, 0]} {k[0, 2]} {k[1, 2]}", ""]
    lines += [f"{d_min} {d_max} {d_interval}", f"{img_index} 0 0 0 0 {width} {height}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_camera_nn(path: str) -> np.ndarray:
    """A camera text file as the pinhole dataset takes it: (2, 4, 4) float64
    [E; K in [:3, :3] with the depth row (d_min, d_interval, 0, d_max)]."""
    k, e, d_min, d_max, d_inter = load_camera(path)
    cam = np.zeros((2, 4, 4), dtype=np.float64)
    cam[0] = e
    cam[1, :3, :3] = k
    cam[1, 3, 0] = d_min
    cam[1, 3, 1] = d_inter
    cam[1, 3, 3] = d_max
    return cam


# ---------------------------------------------------------------------------
# TFW georeference sidecar
# ---------------------------------------------------------------------------
def read_tfw(path: str) -> np.ndarray:
    with open(path) as f:
        vals = np.array(f.read().splitlines(), dtype=np.float64)
    if vals.shape[0] != 6:
        raise ValueError(f"{path}: expected 6 TFW parameters, got {vals.shape[0]}")
    return vals


def write_tfw(path: str, e_ul: float, n_ul: float, x_unit: float, y_unit: float) -> None:
    with open(path, "w") as f:
        f.write(f"{x_unit}\n0\n0\n{-y_unit}\n{e_ul}\n{n_ul}\n")


# ---------------------------------------------------------------------------
# rasters
# ---------------------------------------------------------------------------
def _gdal():
    """GDAL's module, or None where it is not installed."""
    try:
        from osgeo import gdal
    except ImportError:
        return None
    return gdal


def _pil_image():
    """Pillow's Image module; raises naming the format where it is absent."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("reading this raster format needs GDAL or Pillow, and neither is "
                           "installed (PNG is read without them)") from None
    return Image


def _is_png(path: str) -> bool:
    return path.lower().endswith(".png")


def read_image(path: str) -> np.ndarray:
    """Read an image → (H, W, 3) float32: gray (with or without alpha) is
    replicated to 3 channels, an alpha channel of RGBA dropped."""
    if _is_png(path):
        arr = png.read_png(path)
    else:
        with _pil_image().open(path) as img:
            arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 2:
        arr = arr[..., 0]
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    elif arr.shape[2] > 3:
        arr = arr[..., :3]
    return arr.astype(np.float32)


def scene_size(path: str):
    """(width, height) of a scene raster without reading its pixels."""
    if _is_png(path):
        return png.png_size(path)
    gdal = _gdal()
    if gdal is not None:
        ds = gdal.Open(path)
        if ds is None:
            raise IOError(f"GDAL failed to open {path}")
        return ds.RasterXSize, ds.RasterYSize
    with _pil_image().open(path) as img:
        return img.size


def read_scene_image(path: str, x_lu: int = 0, y_lu: int = 0,
                     x_size: int | None = None, y_size: int | None = None,
                     tone: object = "auto") -> np.ndarray:
    """Windowed read of one scene raster → (H, W) float32, bands averaged.

    tone: "auto" applies `tone_map` (γ = 1/2.2 and a 0.5/99.5-percentile
    stretch) iff the source is not 8-bit (raw GeoTIFF radiometry; prepared
    uint8 images are read untouched); True/False force it.
    """
    gdal = None if _is_png(path) else _gdal()
    if gdal is not None:
        ds = gdal.Open(path)
        if ds is None:
            raise IOError(f"GDAL failed to open {path}")
        if x_size is None:
            x_size = ds.RasterXSize - x_lu
        if y_size is None:
            y_size = ds.RasterYSize - y_lu
        data = ds.ReadAsArray(x_lu, y_lu, x_size, y_size)
        if data.ndim > 2:
            data = data.astype(np.float64).mean(axis=0)
    else:
        if _is_png(path):
            full = png.read_png(path)
        else:
            with _pil_image().open(path) as img:
                full = np.asarray(img)
        if x_size is None:
            x_size = full.shape[1] - x_lu
        if y_size is None:
            y_size = full.shape[0] - y_lu
        data = full[y_lu:y_lu + y_size, x_lu:x_lu + x_size]
        if data.ndim > 2:
            data = data.astype(np.float64).mean(axis=-1)
    apply_tone = tone is True or (tone == "auto" and data.dtype != np.uint8)
    data = data.astype(np.float32)
    if apply_tone:
        data = tone_map(data).astype(np.float32)
    return data


def tone_map(data: np.ndarray) -> np.ndarray:
    """γ = 1/2.2 and a 0.5/99.5-percentile stretch → [0, 255] float64, for
    raw (more than 8-bit) radiometry."""
    im = np.power(np.maximum(data.astype(np.float64), 0.0), 1.0 / 2.2)
    lo = np.percentile(im, 0.5)
    hi = np.percentile(im, 99.5)
    im = np.clip(im, lo, hi)
    return 255.0 * (im - lo) / max(hi - lo, 1e-9)


# ---------------------------------------------------------------------------
# DSM raster
# ---------------------------------------------------------------------------
def write_dsm(path: str, data: np.ndarray, e_ul: float, n_ul: float,
              x_unit: float, y_unit: float) -> str:
    """Write a georeferenced DSM: a GeoTIFF and its TFW where GDAL is
    installed and `path` ends in .tif; otherwise a PFM (".tif" replaced by
    ".pfm") and its TFW, the same information.  Returns the raster path
    written."""
    data = np.asarray(data, dtype=np.float32)
    gdal = _gdal() if path.endswith(".tif") else None
    if gdal is not None:
        ds = gdal.GetDriverByName("GTiff").Create(path, data.shape[1], data.shape[0], 1,
                                                  gdal.GDT_Float32)
        ds.GetRasterBand(1).WriteArray(data)
        del ds
        write_tfw(path[:-4] + ".tfw", e_ul, n_ul, x_unit, y_unit)
        return path
    out = path[:-4] + ".pfm" if path.endswith(".tif") else path
    save_pfm(out, data)
    write_tfw(os.path.splitext(out)[0] + ".tfw", e_ul, n_ul, x_unit, y_unit)
    return out


def read_dsm(path: str):
    """Read a DSM raster and its TFW → (data, tfw (6,))."""
    if path.endswith(".pfm"):
        data = load_pfm(path)
    else:
        gdal = _gdal()
        if gdal is None:
            raise RuntimeError(f"{path}: reading a GeoTIFF DSM needs GDAL; the PFM fallback "
                               f"is read without it")
        data = gdal.Open(path).ReadAsArray()
    return data, read_tfw(os.path.splitext(path)[0] + ".tfw")
