"""A PNG codec on the standard library (zlib, struct) and numpy.

The port reads and writes its images without Pillow.  `read_png` decodes
non-interlaced 8- and 16-bit grayscale, grayscale + alpha, RGB and RGBA
with any of the five row filters; `write_png` encodes the same types with
filter 0 (None) on every row.  Other PNGs (palette, bit depths below 8,
interlaced) raise ValueError naming what they are.  Chunk CRCs are checked.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type → samples a pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}
_NAMES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale + alpha", 6: "RGBA"}


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRC checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, payload
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without IEND")


def _header(payload: bytes, path: str):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: {depth}-bit {_NAMES.get(ctype, f'colour type {ctype}')} PNG "
                         f"is not supported (8- or 16-bit gray, gray + alpha, RGB, RGBA only)")
    if comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNG is not supported")
    return w, h, depth, _CHANNELS[ctype]


def png_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG from its header."""
    with open(path, "rb") as f:
        head = f.read(33)
    kind, payload = next(_chunks(head, path))
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG does not start with IHDR")
    return struct.unpack(">II", payload[:8])


def _paeth_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters: (h, 1 + stride) filtered bytes → (h, stride)."""
    rows = data.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {int(kinds.max())} does not exist")
    out = np.empty((h, stride), np.uint8)
    if not kinds.any():  # filter 0 on every row (what write_png writes)
        out[:] = rows[:, 1:]
        return out
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        raw = rows[y, 1:]
        kind = kinds[y]
        if kind == 0:
            cur = raw
        elif kind == 1:  # Sub: running sum along the row, per byte of a pixel
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = raw + prior
        elif kind == 3:
            cur = _average_row(raw, prior, bpp)
        else:
            cur = _paeth_row(raw, prior, bpp)
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG → (H, W) for gray, else (H, W, channels); uint8 for
    8-bit files, uint16 for 16-bit ones (every sample as stored)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = _header(payload, path)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ch = header
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, want {h * (stride + 1)}")
    pix = _unfilter(raw, h, stride, bpp, path)
    arr = pix.view(">u2").astype(np.uint16) if depth == 16 else pix
    arr = arr.reshape(h, w, ch)
    return arr[..., 0] if ch == 1 else arr


def write_png(path: str, image: np.ndarray) -> None:
    """Encode (H, W) or (H, W, 1-4) uint8 or uint16 samples (gray, gray +
    alpha, RGB, RGBA) as a non-interlaced PNG, filter 0 on every row."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got {image.dtype}")
    arr = image[..., None] if image.ndim == 2 else image
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG image must be (H, W) or (H, W, 1-4), got {image.shape}")
    h, w, ch = arr.shape
    depth = 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + chunk(b"IEND", b""))
