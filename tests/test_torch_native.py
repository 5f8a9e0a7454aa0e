"""The port's native host library (satmvs_tpu_torch/native) against the JAX
package's (satmvs_tpu.native), on the CPU.

Where a C++ compiler builds both libraries: the port's five functions give
JAX's bits on the same seeded inputs (PFM files written and arrays read,
gray and colour, both byte orders; center_image; tone_map_u8;
downsample_nearest), PFM files round-trip across the native and numpy
paths of both packages, and the library is built once under a hash-named
file that concurrent loads share.  Everywhere: SATMVS_NO_NATIVE=1 and a
monkeypatched `available` give the numpy paths, and `load_pfm`, `save_pfm`
and `center_image` dispatch to the library exactly where JAX's do."""

import os
import subprocess
import threading

import numpy as np
import pytest

from satmvs_tpu import native as jnative
from satmvs_tpu.data import formats as jfmt
from satmvs_tpu.data import preprocess as jpre
from satmvs_tpu_torch import native as tnative
from satmvs_tpu_torch.data import formats as tfmt
from satmvs_tpu_torch.data import preprocess as tpre

requires_native = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason="native library unavailable (no g++?)")


def _write_pfm(path, image: np.ndarray, byteorder: str) -> None:
    """A PFM file by hand: '<' little endian (scale −1), '>' big (scale 1)."""
    color = image.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(b"-1.0\n" if byteorder == "<" else b"1.0\n")
        f.write(np.flipud(image).astype(byteorder + "f4").tobytes())


@requires_native
@pytest.mark.parametrize("shape", [(33, 47), (9, 5, 3), (16, 24, 1)])
def test_pfm_bytes_and_arrays_are_jax_bits(tmp_path, shape):
    rng = np.random.default_rng(0)
    img = rng.normal(size=shape).astype(np.float32)
    a, b = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
    assert tnative.pfm_write(a, img) and jnative.pfm_write(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    want = img[..., 0] if shape[-1:] == (1,) and len(shape) == 3 else img
    for order in "<>":
        path = str(tmp_path / f"{order == '<'}.pfm")
        _write_pfm(path, want, order)
        got = tnative.pfm_read(path)
        np.testing.assert_array_equal(got, jnative.pfm_read(path))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError):
        tnative.pfm_read(str(tmp_path / "bad.pfm"))


@requires_native
def test_center_tone_map_and_downsample_are_jax_bits():
    rng = np.random.default_rng(2)
    for shape in ((32, 48), (32, 48, 3), (7, 5, 4)):
        img = rng.uniform(0, 255, shape).astype(np.float32)
        got = tnative.center_image(img)
        np.testing.assert_array_equal(got, jnative.center_image(img))
        assert got.dtype == np.float32 and got.shape == img.shape
    for lo, hi in ((0.5, 99.5), (2.0, 98.0)):
        raw = rng.uniform(0, 4000, (64, 80)).astype(np.float32)
        raw[0, :5] = -3.0  # gamma of a clipped negative
        got = tnative.tone_map_u8(raw, lo, hi)
        np.testing.assert_array_equal(got, jnative.tone_map_u8(raw, lo, hi))
        assert got.dtype == np.uint8 and 0 < got.mean() < 255
    arr = rng.normal(size=(37, 29)).astype(np.float32)
    for step in (1, 2, 4, 5):
        got = tnative.downsample_nearest(arr, step)
        np.testing.assert_array_equal(got, jnative.downsample_nearest(arr, step))
        np.testing.assert_array_equal(got, arr[::step, ::step])


@requires_native
def test_pfm_files_round_trip_across_paths_of_both_packages(tmp_path, monkeypatch):
    """Each writer (port / JAX, native / numpy) → each reader: the same array."""
    rng = np.random.default_rng(1)
    for shape in ((16, 24), (6, 10, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        paths = []
        for pkg, fmt, nat in (("t", tfmt, tnative), ("j", jfmt, jnative)):
            for on in (True, False):
                path = str(tmp_path / f"{pkg}{on}{len(shape)}.pfm")
                with monkeypatch.context() as m:
                    m.setattr(nat, "available", lambda on=on: on)
                    fmt.save_pfm(path, img)
                paths.append(path)
        for path in paths:
            for fmt, nat in ((tfmt, tnative), (jfmt, jnative)):
                for on in (True, False):
                    with monkeypatch.context() as m:
                        m.setattr(nat, "available", lambda on=on: on)
                        np.testing.assert_array_equal(fmt.load_pfm(path), img)


@requires_native
def test_build_is_hash_named_and_a_concurrent_load_reuses_it(tmp_path, monkeypatch):
    """Two builds at once into an empty directory leave one library under
    the source's hash and no temporary file; a later load compiles
    nothing."""
    build_dir = tmp_path / "native"
    got = []
    threads = [threading.Thread(target=lambda: got.append(tnative.build_library(build_dir)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    path = tnative.library_path(build_dir)
    assert got == [path, path]
    assert [p.name for p in build_dir.iterdir()] == [path.name]
    assert path.name.startswith("libio_kernels-") and len(path.stem.split("-")[1]) == 16

    def no_compile(*a, **k):
        raise AssertionError("the library was compiled again")

    monkeypatch.setattr(subprocess, "run", no_compile)
    assert tnative.build_library(build_dir) == path
    # an edited source gets another name
    (tmp_path / "edited.cpp").write_bytes(tnative.SRC.read_bytes() + b"\n")
    monkeypatch.setattr(tnative, "SRC", tmp_path / "edited.cpp")
    assert tnative.library_path(build_dir) != path


def test_no_native_env_and_unavailable_library_take_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("SATMVS_NO_NATIVE", "1")
    assert not tnative.available()
    assert tnative.pfm_read(str(tmp_path / "x.pfm")) is None
    assert tnative.pfm_write(str(tmp_path / "x.pfm"), np.zeros((2, 2), np.float32)) is False
    assert tnative.center_image(np.zeros((2, 2), np.float32)) is None
    assert tnative.tone_map_u8(np.zeros(4, np.float32)) is None
    assert tnative.downsample_nearest(np.zeros((2, 2), np.float32), 2) is None
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.delenv("SATMVS_NO_NATIVE")
    monkeypatch.setattr(tnative, "compiler", lambda: None)
    assert not tnative.available()
    # the formats and preprocess paths still work: numpy's
    rng = np.random.default_rng(3)
    img = rng.uniform(40.0, 230.0, (12, 10, 3)).astype(np.float32)
    path = str(tmp_path / "n.pfm")
    tfmt.save_pfm(path, img[..., 0], scale=2.0)
    assert open(path, "rb").read().split(b"\n")[2] == b"-2.0"  # numpy writes the scale
    np.testing.assert_array_equal(tfmt.load_pfm(path), img[..., 0])
    mean, var = img.mean(axis=(0, 1)), img.var(axis=(0, 1))
    np.testing.assert_array_equal(tpre.center_image(img), (img - mean) / (np.sqrt(var) + 1e-8))


class _Recorder:
    """A stand-in library: records the calls, answers with `result`."""

    def __init__(self, result):
        self.calls, self.result = [], result

    def __call__(self, name):
        def fn(*args):
            self.calls.append(name)
            return self.result(name, args) if callable(self.result) else self.result
        return fn


@pytest.mark.parametrize("answer", ["native", "declines"])
def test_formats_and_preprocess_dispatch_as_jax_does(tmp_path, monkeypatch, answer):
    """With `available` true, load_pfm / save_pfm / center_image call the
    library first, and take numpy where it declines (None / False), in
    both packages alike; with it false they never call it."""
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = str(tmp_path / "d.pfm")
    jfmt.save_pfm(path, img)
    seen = {}
    for pkg, nat, fmt, pre in (("t", tnative, tfmt, tpre), ("j", jnative, jfmt, jpre)):
        for on in (True, False):
            marker = np.full((1, 1), 7.0, np.float32)
            rec = _Recorder((lambda name, args: marker if name != "pfm_write" else True)
                            if answer == "native" else
                            (lambda name, args: False if name == "pfm_write" else None))
            with monkeypatch.context() as m:
                m.setattr(nat, "available", lambda on=on: on)
                for name in ("pfm_read", "pfm_write", "center_image"):
                    m.setattr(nat, name, rec(name))
                out = str(tmp_path / f"{pkg}{on}.pfm")
                results = (fmt.load_pfm(path), fmt.save_pfm(out, img), pre.center_image(img))
            wrote = os.path.exists(out)
            seen[(pkg, on)] = (rec.calls, [r is marker for r in results], wrote)
    for on in (True, False):
        assert seen[("t", on)] == seen[("j", on)], on
    assert seen[("t", False)][0] == []
    assert seen[("t", True)][0] == ["pfm_read", "pfm_write", "center_image"]
    assert seen[("t", True)][2] == (answer == "declines")  # numpy wrote it
