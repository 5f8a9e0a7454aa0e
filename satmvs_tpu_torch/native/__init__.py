"""Host-side data-plane routines in C++ (`io_kernels.cpp`), loaded with ctypes.

The port's counterpart of `satmvs_tpu/native`: PFM decode and encode, the
per-channel `center_image`, the histogram tone map and the nearest
downsample, with the JAX package's signatures and arithmetic.  The library
is compiled at first use with `g++ -O3 -shared -fPIC -std=c++17` into
`build/native/` at the repository root, under a file name that carries a
hash of the source, the flags and the compiler, written to a temporary file
and renamed into place: an edited source is rebuilt, a stale library is
never loaded, and processes that build at once each rename a whole file.
Where no compiler is found or the build fails, every function returns None
(or False) and the callers in `data/formats.py` and `data/preprocess.py`
take their numpy paths; `available()` says which path runs.
SATMVS_NO_NATIVE=1 turns the library off, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "io_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def compiler() -> Optional[str]:
    """g++ on the PATH, or None."""
    return shutil.which("g++")


def library_path(build_dir: Optional[Path] = None, cxx: Optional[str] = None) -> Path:
    """The hash-named library file of the current source, flags and compiler."""
    digest = hashlib.sha256(" ".join((cxx or compiler() or "", *CXX_FLAGS)).encode())
    digest.update(SRC.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libio_kernels-{digest.hexdigest()[:16]}.so"


def build_library(build_dir: Optional[Path] = None) -> Optional[Path]:
    """The library's path, compiled first unless a build of this source is
    there; None where no compiler is found or the compiler fails."""
    cxx = compiler()
    if cxx is None:
        return None
    out = library_path(build_dir, cxx)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.pfm_read_header.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_int_p, c_int_p,
                                    ctypes.POINTER(ctypes.c_long)]
    lib.pfm_read.argtypes = [ctypes.c_char_p, c_float_p]
    lib.pfm_write.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.center_image.argtypes = [c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tone_map_u8.argtypes = [c_float_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                                ctypes.c_double, ctypes.c_double]
    lib.downsample_nearest.argtypes = [c_float_p, c_float_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SATMVS_NO_NATIVE") == "1":
            return None
        path = build_library()
        if path is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except OSError:
            return None
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (else the numpy paths run)."""
    return _load() is not None


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pfm_read(path: str):
    """A PFM file → (H, W) or (H, W, 3) float32, top row first; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    w, h, c, le = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    off = ctypes.c_long()
    if lib.pfm_read_header(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                           ctypes.byref(le), ctypes.byref(off)) != 0:
        raise ValueError(f"{path}: not a valid PFM file")
    shape = (h.value, w.value, 3) if c.value == 3 else (h.value, w.value)
    out = np.empty(shape, np.float32)
    if lib.pfm_read(path.encode(), _fptr(out)) != 0:
        raise IOError(f"{path}: PFM read failed")
    return out


def pfm_write(path: str, image: np.ndarray) -> bool:
    """Write an (H, W), (H, W, 1) or (H, W, 3) image as a little-endian PFM
    with scale −1.0; False without the library."""
    lib = _load()
    if lib is None:
        return False
    image = np.ascontiguousarray(image, np.float32)
    channels = 3 if (image.ndim == 3 and image.shape[2] == 3) else 1
    rc = lib.pfm_write(path.encode(), _fptr(image), image.shape[0], image.shape[1], channels)
    if rc != 0:
        raise IOError(f"{path}: PFM write failed ({rc})")
    return True


def center_image(img: np.ndarray):
    """Per-channel (img − mean) / (std + 1e-8) over the spatial axes, the
    moments summed in float64; a new float32 array, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    out = np.ascontiguousarray(img, np.float32).copy()
    h, w = out.shape[:2]
    c = out.shape[2] if out.ndim == 3 else 1
    lib.center_image(_fptr(out), h, w, c)
    return out


def tone_map_u8(data: np.ndarray, lo_pct: float = 0.5, hi_pct: float = 99.5):
    """Gamma 1/2.2, then the [lo_pct, hi_pct] percentiles (a 65536-bin
    histogram) stretched to [0, 255] → uint8; None without the library."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(data, np.float32)
    out = np.empty(flat.shape, np.uint8)
    lib.tone_map_u8(_fptr(flat), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    flat.size, lo_pct, hi_pct)
    return out


def downsample_nearest(arr: np.ndarray, step: int):
    """Every step-th row and column of an (H, W) map, float32; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.float32)
    h, w = arr.shape
    out = np.empty(((h + step - 1) // step, (w + step - 1) // step), np.float32)
    lib.downsample_nearest(_fptr(arr), _fptr(out), h, w, step)
    return out
