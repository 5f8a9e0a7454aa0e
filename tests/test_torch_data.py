"""The port's data layer against the JAX package's, on the CPU:
satmvs_tpu_torch/data/{formats,png,preprocess,samples,dataset,loader,synthetic}.py.

PFM, RPC and TFW round-trip and cross-read with the JAX `formats`; the
port's PNG codec decodes what Pillow writes (8- and 16-bit gray, gray +
alpha, RGB, RGBA) and files with each of the five row filters; the sample
lists, and `MVSDataset` samples in train (colour jitter from the same
seed), test and pred modes, equal JAX's on a tree the JAX writer wrote
(`random_color`, which runs in blocks of rows, gives JAX's bits)
(images within 1e-6, cameras to float32 rounding, GT pyramids and masks
exactly, routing strings); the ×32 crop; a 90-value RPC's inverse fitted
on load; the port's writers give JAX's files (RPC and PFM bytes, PNG
pixels); `Loader` order, shuffle, device and exceptions."""

import os
import struct
import threading
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from satmvs_tpu.data import dataset as jds
from satmvs_tpu.data import formats as jfmt
from satmvs_tpu.data import loader as jld
from satmvs_tpu.data import preprocess as jpre
from satmvs_tpu.data import samples as jsamples
from satmvs_tpu import native
from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu_torch import native as tnative
from satmvs_tpu_torch.data import dataset as tds
from satmvs_tpu_torch.data import formats as tfmt
from satmvs_tpu_torch.data import loader as tld
from satmvs_tpu_torch.data import png
from satmvs_tpu_torch.data import preprocess as tpre
from satmvs_tpu_torch.data import samples as tsamples
from satmvs_tpu_torch.data import synthetic as tsyn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CAM_FIELDS = ("ref_inv", "ref_norm", "src_fwd", "src_denorm", "renorm")


@pytest.fixture(autouse=True)
def _jax_numpy_center_image(monkeypatch):
    """Both packages' datasets normalize images on their numpy paths: like
    with like (the native libraries, where they are built, sum the moments
    in float64: ~3e-6 from numpy on a view whose contrast the jitter
    shrank).  `test_dataset_samples_match_jax_natively` turns both
    libraries on and holds the samples to JAX's bit for bit."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """Two 32² scenes written by the JAX package's writer."""
    root = str(tmp_path_factory.mktemp("jtree"))
    jsyn.write_synthetic_dataset(root, num_scenes=2, width=32, height=32, h_amp=40.0,
                                 h_scale=120.0)
    return root


def test_pfm_rpc_tfw_round_trip_and_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((5, 7), (4, 6, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        tfmt.save_pfm(str(tmp_path / "t.pfm"), img)
        jfmt.save_pfm(str(tmp_path / "j.pfm"), img)
        assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
        for path in ("t.pfm", "j.pfm"):
            np.testing.assert_array_equal(tfmt.load_pfm(str(tmp_path / path)), img)
            np.testing.assert_array_equal(jfmt.load_pfm(str(tmp_path / path)), img)
    with pytest.raises(ValueError):
        tfmt.save_pfm(str(tmp_path / "x.pfm"), img.astype(np.float64))
    for n in (90, 170):
        rpc = rng.normal(size=n) * 10.0 ** rng.integers(-8, 4, n)
        tfmt.save_rpc(str(tmp_path / "t.rpc"), rpc)
        jfmt.save_rpc(str(tmp_path / "j.rpc"), rpc)
        assert (tmp_path / "t.rpc").read_bytes() == (tmp_path / "j.rpc").read_bytes()
        got, jgot = tfmt.load_rpc(str(tmp_path / "j.rpc")), jfmt.load_rpc(str(tmp_path / "t.rpc"))
        np.testing.assert_array_equal(got[0], rpc)
        assert got[1:] == jgot[1:]
    (tmp_path / "bad.rpc").write_text("LINE_OFF: 1 pixels\n")
    with pytest.raises(ValueError, match="90 or 170"):
        tfmt.load_rpc(str(tmp_path / "bad.rpc"))
    tfmt.write_tfw(str(tmp_path / "t.tfw"), 500123.5, 3312345.25, 5.0, 5.0)
    jfmt.write_tfw(str(tmp_path / "j.tfw"), 500123.5, 3312345.25, 5.0, 5.0)
    assert (tmp_path / "t.tfw").read_bytes() == (tmp_path / "j.tfw").read_bytes()
    np.testing.assert_array_equal(tfmt.read_tfw(str(tmp_path / "t.tfw")),
                                  [5.0, 0, 0, -5.0, 500123.5, 3312345.25])
    dsm = rng.normal(size=(6, 9)).astype(np.float32)
    path = tfmt.write_dsm(str(tmp_path / "d.tif"), dsm, 1.0, 2.0, 5.0, 5.0)
    assert path.endswith(".pfm")  # no GDAL here: the PFM + TFW fallback
    data, tfw = tfmt.read_dsm(path)
    np.testing.assert_array_equal(data, dsm)
    np.testing.assert_array_equal(tfw, jfmt.read_dsm(path)[1])


@pytest.mark.parametrize("mode,dtype,channels", [
    ("L", np.uint8, 1), ("LA", np.uint8, 2), ("RGB", np.uint8, 3), ("RGBA", np.uint8, 4),
    ("I;16", np.uint16, 1)])
def test_png_codec_reads_and_writes_what_pillow_does(tmp_path, mode, dtype, channels):
    rng = np.random.default_rng(channels)
    hi = 65536 if dtype == np.uint16 else 256
    arr = rng.integers(0, hi, size=(13, 21, channels)).astype(dtype)
    arr = arr[..., 0] if channels == 1 else arr
    pil = Image.fromarray(arr)
    assert pil.mode == mode
    pil.save(tmp_path / "pil.png")
    got = png.read_png(str(tmp_path / "pil.png"))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, arr)
    assert png.png_size(str(tmp_path / "pil.png")) == (21, 13)
    png.write_png(str(tmp_path / "port.png"), arr)
    with Image.open(tmp_path / "port.png") as img:
        np.testing.assert_array_equal(np.asarray(img), arr)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")), arr)


def _filtered_png(path, arr: np.ndarray, depth: int):
    """A PNG whose rows use filters 0-4 in turn (the PNG spec's filters,
    written out here independently of the decoder)."""
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    bpp = ch * depth // 8
    rows = np.ascontiguousarray(arr, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int64)
    out, prior = bytearray(), np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        cur, kind = rows[y], y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                                    0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels,depth", [(1, 8), (3, 8), (4, 8), (2, 8), (1, 16), (3, 16)])
def test_png_decoder_undoes_all_five_filters(tmp_path, channels, depth):
    rng = np.random.default_rng(depth + channels)
    dtype = np.uint16 if depth == 16 else np.uint8
    arr = rng.integers(0, 2 ** depth, size=(11, 9, channels)).astype(dtype)
    arr = arr[..., 0] if channels == 1 else arr
    _filtered_png(tmp_path / "f.png", arr, depth)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "f.png")), arr)
    if depth == 8:  # Pillow reads these back the same
        with Image.open(tmp_path / "f.png") as img:
            np.testing.assert_array_equal(np.asarray(img), arr)


def test_png_refusals_name_the_format(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint8), mode="L").convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        png.read_png(str(tmp_path / "p.png"))
    data = bytearray((tmp_path / "p.png").read_bytes())
    data[40] ^= 0xFF  # inside a chunk: its CRC no longer matches
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt|palette"):
        png.read_png(str(tmp_path / "bad.png"))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((2, 2), np.float32))


def test_images_and_scene_rasters_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (16, 24)).astype(np.uint8)
    rgb = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    g16 = rng.integers(0, 65536, (16, 24)).astype(np.uint16)
    for name, arr in (("g.png", gray), ("c.png", rgb), ("w.png", g16)):
        png.write_png(str(tmp_path / name), arr)
        path = str(tmp_path / name)
        if arr.dtype == np.uint8:
            np.testing.assert_array_equal(tfmt.read_image(path), jfmt.read_image(path))
        np.testing.assert_array_equal(tfmt.read_scene_image(path), jfmt.read_scene_image(path))
        np.testing.assert_array_equal(tfmt.read_scene_image(path, 3, 2, 10, 7),
                                      jfmt.read_scene_image(path, 3, 2, 10, 7))
        assert tfmt.scene_size(path) == jfmt.scene_size(path) == (24, 16)
    assert tfmt.read_image(str(tmp_path / "g.png")).shape == (16, 24, 3)


@pytest.mark.parametrize("shape,dtype", [((70, 45, 3), np.uint8), ((33, 8, 3), np.float32),
                                         ((1, 5, 3), np.uint8)])
def test_random_color_is_jax_bit_for_bit(shape, dtype):
    """The jitter in blocks of rows (the last one short here) gives the bits
    of JAX's whole-image expressions, from the same generator draws."""
    img = (np.random.default_rng(7).random(shape) * 255).astype(dtype)
    for seed in range(3):
        want = jpre.random_color(img, np.random.default_rng(seed))
        got = tpre.random_color(img, np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sample_lists_match_jax(jax_tree):
    for ref_view in (2, 0, -1):
        assert tsamples.gen_list(jax_tree, 3, ref_view) == jsamples.gen_list(jax_tree, 3, ref_view)
    assert len(tsamples.gen_list(jax_tree, 3, -1)) == 6


def _assert_sample_matches(got: dict, want: dict):
    np.testing.assert_allclose(got["imgs"], want["imgs"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
    assert (got["out_view"], got["out_name"]) == (want["out_view"], want["out_name"])
    assert len(got["cams"]) == len(want["cams"])
    for gc, wc in zip(got["cams"], want["cams"]):
        assert gc.ref_inv.device.type == "cpu"
        for field in CAM_FIELDS:  # both cast the same float64 values to float32
            np.testing.assert_allclose(getattr(gc, field).numpy(),
                                       np.asarray(getattr(wc, field)), rtol=1e-6, atol=0)
    assert ("depth_stages" in got) == ("depth_stages" in want)
    for key in ("depth_stages", "mask_stages"):
        for g, w in zip(got.get(key, []), want.get(key, [])):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["train", "test", "pred"])
def test_dataset_samples_match_jax(jax_tree, mode):
    """Train mode jitters the colours from the same seed (the same
    Generator calls in the same order), so every sample equals JAX's."""
    tset = tds.MVSDataset(jax_tree, mode, 3, 2, seed=7)
    jset = jds.MVSDataset(jax_tree, mode, 3, 2, seed=7)
    assert len(tset) == len(jset) == (6 if mode == "pred" else 2)
    for i in range(len(tset)):
        got, want = tset[i], jset[i]
        _assert_sample_matches(got, want)
        if mode != "pred":
            assert [d.shape for d in got["depth_stages"]] == [(8, 8), (16, 16), (32, 32)]


@pytest.mark.skipif(not (tnative.available() and native.available()),
                    reason="native library unavailable (no g++?)")
@pytest.mark.parametrize("mode", ["train", "test"])
def test_dataset_samples_match_jax_natively(jax_tree, mode, monkeypatch):
    """Both native libraries on (PFM reads and center_image in C++): the
    images are JAX's bit for bit, the rest as on the numpy path."""
    monkeypatch.setattr(native, "available", lambda: True)
    monkeypatch.setattr(tnative, "available", lambda: True)
    tset = tds.MVSDataset(jax_tree, mode, 3, 2, seed=7)
    jset = jds.MVSDataset(jax_tree, mode, 3, 2, seed=7)
    for i in range(len(tset)):
        got, want = tset[i], jset[i]
        np.testing.assert_array_equal(got["imgs"], want["imgs"])
        _assert_sample_matches(got, want)


def test_dataset_crops_to_multiples_of_32_with_shifted_cameras(tmp_path):
    root = str(tmp_path / "odd")
    jsyn.write_synthetic_dataset(root, num_scenes=1, width=72, height=40, h_amp=40.0,
                                 h_scale=120.0)
    for max_h, max_w in ((0, 0), (32, 32)):
        tset = tds.MVSDataset(root, "test", max_h=max_h, max_w=max_w)
        jset = jds.MVSDataset(root, "test", max_h=max_h, max_w=max_w)
        got, want = tset[0], jset[0]
        assert got["imgs"].shape == (3, 32, 32 if max_w else 64, 3)
        _assert_sample_matches(got, want)


def test_dataset_fits_the_inverse_of_a_90_value_rpc(tmp_path):
    root = str(tmp_path / "direct")
    jsyn.write_synthetic_dataset(root, num_scenes=1, width=32, height=32, h_amp=40.0,
                                 h_scale=120.0)
    for v in range(3):
        path = os.path.join(root, "rpc", str(v), "scene0000.rpc")
        jfmt.save_rpc(path, jfmt.load_rpc(path)[0][:90])
    tset, jset = tds.MVSDataset(root, "test"), jds.MVSDataset(root, "test")
    got, want = tset[0], jset[0]
    _assert_sample_matches(got, want)
    assert len(tset._inv_rpc_cache) == 3
    again = tset[0]  # the fit is cached per path
    for field in CAM_FIELDS:
        assert torch.equal(getattr(again["cams"][2], field), getattr(got["cams"][2], field))


def test_port_writers_write_the_jax_writers_files(tmp_path):
    kw = dict(num_train=1, num_test=1, width=32, height=48, h_amp=40.0, h_scale=120.0)
    jsyn.write_whu_tlc_tree(str(tmp_path / "j"), **kw)
    tsyn.write_whu_tlc_tree(str(tmp_path / "t"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                           for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert len(files) == 2 * 3 * 3
    for rel in files:
        a, b = tmp_path / "j" / rel, tmp_path / "t" / rel
        if rel.endswith(".png"):
            with Image.open(a) as img:
                np.testing.assert_array_equal(png.read_png(str(b)), np.asarray(img))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


class _Failing:
    """A dataset whose sample `bad` raises."""

    def __init__(self, inner, bad):
        self.inner, self.bad = inner, bad

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"sample {i} is unreadable")
        return self.inner[i]


@pytest.mark.parametrize("batch_size", [2, 4])
def test_loader_order_shuffle_device_and_errors(jax_tree, batch_size, monkeypatch):
    tset = tds.MVSDataset(jax_tree, "pred")
    jset = jds.MVSDataset(jax_tree, "pred")
    names = [(s[0].split("/")[-2], os.path.basename(s[0])[:-4]) for s in tset.sample_list]
    in_order = tld.Loader(tset, batch_size, device="cpu")
    order = list(in_order)
    assert len(order) == len(in_order) == -(-6 // batch_size)  # the last batch may be short
    assert [(v, n) for b in order for v, n in zip(b["out_view"], b["out_name"])] == names
    b = order[0]
    assert b["imgs"].shape == (batch_size, 3, 32, 32, 3) and b["imgs"].device.type == "cpu"
    assert b["cams"][0].src_fwd.shape == (batch_size, 2, 20, 4)
    assert b["depth_values"].shape == (batch_size, 2) and "depth_stages" not in b
    assert order[-1]["imgs"].shape[0] == 6 - batch_size * (len(order) - 1)
    assert in_order.timing["batches"] == len(order) and in_order.timing["read_s"] > 0
    assert tset.timing["samples"] == 6 and tset.timing["center_s"] > 0
    shuffled = tld.Loader(tset, 1, shuffle=True, seed=3, device="cpu")
    jshuffled = jld.Loader(jset, 1, shuffle=True, seed=3)
    for _ in range(2):  # each pass draws a new order, as JAX's loader does
        got = [(x["out_view"][0], x["out_name"][0]) for x in shuffled]
        assert got == [(x["out_view"][0], x["out_name"][0]) for x in jshuffled]
    assert shuffled.timing["batches"] == 6

    threads = threading.active_count()
    failing = tld.Loader(_Failing(tset, 3), 1, device="cpu")
    seen = []
    with pytest.raises(OSError, match="sample 3"):
        for x in failing:
            seen.append(x["out_name"][0])
    assert len(seen) == 3
    it = iter(tld.Loader(tset, 1, device="cpu"))
    next(it)
    it.close()  # a consumer that stops early releases the worker
    assert threading.active_count() == threads

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tld.Loader(tset, 1)


def test_test_mode_batch_has_the_training_layout(jax_tree):
    batch = next(iter(tld.Loader(tds.MVSDataset(jax_tree, "test"), 2, device="cpu")))
    want = tsyn.make_batch(2, 32, 32, device="cpu")
    assert set(batch) - {"out_view", "out_name"} == set(want)
    for key in ("depth_stages", "mask_stages"):
        assert [t.shape for t in batch[key]] == [t.shape for t in want[key]]
        assert all(t.dtype == torch.float32 for t in batch[key])
    for got, ref in zip(batch["cams"], want["cams"]):
        for field in CAM_FIELDS:
            assert getattr(got, field).shape == getattr(ref, field).shape
