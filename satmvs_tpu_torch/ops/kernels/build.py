"""Build and load the hand-written CUDA kernels.

Each `satmvs_tpu_torch/csrc/<name>.cu` has a plain C interface and is
compiled on its own by `nvcc` for Hopper (sm_90a) into a shared library
under `build/kernels/` at the repository root, at first use.  The file name
carries a hash of the source, the headers beside it and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Libraries
are loaded with ctypes; the caller sets `argtypes` on the functions it uses.
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def sources() -> list[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, temp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return log


def build_all() -> dict[str, str]:
    """Compile every source in csrc/ that is not built yet, one nvcc each,
    all started together.  Returns {name: compiler log} of what was built."""
    jobs = {name: _start_build(name) for name in sources()}
    return {name: _finish_build(name, job) for name, job in jobs.items() if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
