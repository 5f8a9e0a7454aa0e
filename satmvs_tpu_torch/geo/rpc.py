"""Rational Polynomial Camera (RPC) model.

Counterpart of `satmvs_tpu/geo/rpc.py`.  An RPC is a flat (170,) float array
in the `.rpc` text layout:

    [0..9]    LINE_OFF SAMP_OFF LAT_OFF LON_OFF HEI_OFF
              LINE_SCALE SAMP_SCALE LAT_SCALE LON_SCALE HEI_SCALE
    [10..90]  LNUM(20) LDEM(20) SNUM(20) SDEM(20)        (direct: obj → photo)
    [90..170] LATNUM(20) LATDEM(20) LONNUM(20) LONDEM(20) (inverse: photo → obj)

Two halves:
  * the device chain (`photo_to_obj_n` / `obj_to_photo_n`) works in torch
    float32 on *normalized* coordinates (≈[-1, 1]).  It evaluates the
    polynomials with explicit fp32 products and sums, never a matmul, so no
    TF32 setting of the caller can reach it: TF32 keeps ~3 decimal digits,
    which at a 768-px image is ±1 px (the TPU's bf16 matmul did the same at
    larger extents);
  * the host half (`photo_to_obj`, `obj_to_photo`, `renorm_affine`,
    `scale_rpc`, `crop_rpc`, the inverse fit) is numpy float64, so absolute
    lat/lon never reach the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .solver import solve_iccv

LINE_OFF, SAMP_OFF, LAT_OFF, LON_OFF, HEI_OFF = 0, 1, 2, 3, 4
LINE_SCALE, SAMP_SCALE, LAT_SCALE, LON_SCALE, HEI_SCALE = 5, 6, 7, 8, 9
LNUM = slice(10, 30)
LDEM = slice(30, 50)
SNUM = slice(50, 70)
SDEM = slice(70, 90)
LATNUM = slice(90, 110)
LATDEM = slice(110, 130)
LONNUM = slice(130, 150)
LONDEM = slice(150, 170)

NUM_PARAMS = 170


def poly_basis(p, l, h):
    """20-term cubic monomial basis, stacked on a new last axis.

    Term order: [1, L, P, H, LP, LH, PH, L², P², H², PLH,
                 L³, LP², LH², L²P, P³, PH², L²H, P²H, H³].
    Works on numpy arrays or torch tensors.
    """
    is_tensor = isinstance(p, torch.Tensor)
    stack = torch.stack if is_tensor else np.stack
    one = torch.ones_like(p) if is_tensor else np.ones_like(p)
    lp, lh, ph = l * p, l * h, p * h
    l2, p2, h2 = l * l, p * p, h * h
    return stack(
        [
            one, l, p, h, lp, lh, ph, l2, p2, h2,
            lp * h, l2 * l, l * p2, l * h2, l2 * p,
            p2 * p, p * h2, l2 * h, p2 * h, h2 * h,
        ],
        -1,
    )


def fwd_coef_matrix(rpc):
    """(20, 4) direct-projection coefficients [SNUM | SDEM | LNUM | LDEM]."""
    return np.stack([rpc[SNUM], rpc[SDEM], rpc[LNUM], rpc[LDEM]], axis=-1)


def inv_coef_matrix(rpc):
    """(20, 4) inverse-projection coefficients [LATNUM | LATDEM | LONNUM | LONDEM]."""
    return np.stack([rpc[LATNUM], rpc[LATDEM], rpc[LONNUM], rpc[LONDEM]], axis=-1)


def _rational_pair(coefs: torch.Tensor, p, l, h):
    """Two rational polynomials sharing one basis: coefs (20, 4) =
    [num_a | den_a | num_b | den_b] → (num_a/den_a, num_b/den_b) like p.

    Elementwise fp32 products summed over the 20 terms: unlike a matmul this
    cannot be lowered to TF32, whatever `torch.backends` flags say.
    """
    basis = poly_basis(p, l, h)  # (..., 20)
    vals = [(basis * coefs[:, k]).sum(-1) for k in range(4)]
    return vals[0] / vals[1], vals[2] / vals[3]


def photo_to_obj_n(inv_coefs, samp_n, line_n, hei_n):
    """Inverse RPC in normalized space: (samp_n, line_n, hei_n) → (lat_n, lon_n).
    Basis convention P = samp, L = line."""
    return _rational_pair(inv_coefs, samp_n, line_n, hei_n)


def obj_to_photo_n(fwd_coefs, lat_n, lon_n, hei_n):
    """Direct RPC in normalized space: (lat_n, lon_n, hei_n) → (samp_n, line_n).
    Basis convention P = lat, L = lon."""
    return _rational_pair(fwd_coefs, lat_n, lon_n, hei_n)


# ---------------------------------------------------------------------------
# host side, numpy float64
# ---------------------------------------------------------------------------
def obj_to_photo(rpc, lat, lon, hei):
    """(lat, lon, hei) → (samp, line) with the direct RPC (numpy)."""
    lat_n = (lat - rpc[LAT_OFF]) / rpc[LAT_SCALE]
    lon_n = (lon - rpc[LON_OFF]) / rpc[LON_SCALE]
    hei_n = (hei - rpc[HEI_OFF]) / rpc[HEI_SCALE]
    basis = poly_basis(lat_n, lon_n, hei_n)
    samp_n = basis @ rpc[SNUM] / (basis @ rpc[SDEM])
    line_n = basis @ rpc[LNUM] / (basis @ rpc[LDEM])
    return samp_n * rpc[SAMP_SCALE] + rpc[SAMP_OFF], line_n * rpc[LINE_SCALE] + rpc[LINE_OFF]


def photo_to_obj(rpc, samp, line, hei):
    """(samp, line, hei) → (lat, lon) with the inverse RPC (numpy)."""
    samp_n = (samp - rpc[SAMP_OFF]) / rpc[SAMP_SCALE]
    line_n = (line - rpc[LINE_OFF]) / rpc[LINE_SCALE]
    hei_n = (hei - rpc[HEI_OFF]) / rpc[HEI_SCALE]
    basis = poly_basis(samp_n, line_n, hei_n)
    lat_n = basis @ rpc[LATNUM] / (basis @ rpc[LATDEM])
    lon_n = basis @ rpc[LONNUM] / (basis @ rpc[LONDEM])
    return lat_n * rpc[LAT_SCALE] + rpc[LAT_OFF], lon_n * rpc[LON_SCALE] + rpc[LON_OFF]


def renorm_affine(ref_rpc, src_rpc) -> np.ndarray:
    """(3, 2) float64 [[scale, shift] x (lat, lon, hei)] mapping ref-normalized
    object coordinates to src-normalized ones:  x_src_n = x_ref_n·scale + shift.
    """
    ref = np.asarray(ref_rpc, dtype=np.float64)
    src = np.asarray(src_rpc, dtype=np.float64)
    out = np.empty((3, 2), dtype=np.float64)
    for row, (off, scale) in enumerate(
        [(LAT_OFF, LAT_SCALE), (LON_OFF, LON_SCALE), (HEI_OFF, HEI_SCALE)]
    ):
        out[row, 0] = ref[scale] / src[scale]
        out[row, 1] = (ref[off] - src[off]) / src[scale]
    return out


def height_range(rpc):
    """(h_min, h_max) = HEIGHT_OFF ± HEIGHT_SCALE."""
    return rpc[HEI_OFF] - rpc[HEI_SCALE], rpc[HEI_OFF] + rpc[HEI_SCALE]


def scale_rpc(rpc, scale) -> np.ndarray:
    """RPC of the image resized by `scale`: image-space offsets and scales
    are multiplied, object space and the polynomials are unchanged."""
    out = np.asarray(rpc, dtype=np.float64).copy()
    out[[LINE_OFF, SAMP_OFF, LINE_SCALE, SAMP_SCALE]] *= scale
    return out


def crop_rpc(rpc, start_w, start_h) -> np.ndarray:
    """RPC of a crop whose top-left corner is (start_w, start_h) px: the
    image-space offsets shift."""
    out = np.asarray(rpc, dtype=np.float64).copy()
    out[SAMP_OFF] -= start_w
    out[LINE_OFF] -= start_h
    return out


def create_virtual_grid(rpc, xy_samples: int = 30, z_samples: int = 20) -> np.ndarray:
    """(N, 5) [samp, line, lat, lon, hei] control grid over the RPC's
    object-space box, kept where it projects inside the image-space box."""
    rpc = np.asarray(rpc, dtype=np.float64)
    lat = np.linspace(rpc[LAT_OFF] - rpc[LAT_SCALE], rpc[LAT_OFF] + rpc[LAT_SCALE], xy_samples)
    lon = np.linspace(rpc[LON_OFF] - rpc[LON_SCALE], rpc[LON_OFF] + rpc[LON_SCALE], xy_samples)
    hei = np.linspace(rpc[HEI_OFF] - rpc[HEI_SCALE], rpc[HEI_OFF] + rpc[HEI_SCALE], z_samples)
    glat, glon, ghei = (g.reshape(-1) for g in np.meshgrid(lat, lon, hei))
    samp, line = obj_to_photo(rpc, glat, glon, ghei)
    keep = (
        (samp >= rpc[SAMP_OFF] - rpc[SAMP_SCALE])
        & (samp <= rpc[SAMP_OFF] + rpc[SAMP_SCALE])
        & (line >= rpc[LINE_OFF] - rpc[LINE_SCALE])
        & (line <= rpc[LINE_OFF] + rpc[LINE_SCALE])
    )
    return np.stack([samp, line, glat, glon, ghei], axis=-1)[keep]


def _rational_design_matrix(in_basis: np.ndarray, out_a: np.ndarray, out_b: np.ndarray):
    """Design matrix (2N, 78) and right-hand side for jointly fitting two
    rational polynomials (numerator 20 + denominator 19, den[0] = 1)."""
    n = in_basis.shape[0]
    a = np.zeros((2 * n, 78), dtype=np.float64)
    a[:n, 0:20] = -in_basis
    a[:n, 20:39] = out_a[:, None] * in_basis[:, 1:]
    a[n:, 39:59] = -in_basis
    a[n:, 59:78] = out_b[:, None] * in_basis[:, 1:]
    rhs = -np.concatenate([out_a, out_b])
    return a, rhs


def fit_inverse_rpc(rpc, xy_samples: int = 30, z_samples: int = 20) -> np.ndarray:
    """Fill slots [90:170] (inverse RPC) by fitting the direct RPC on a
    virtual control grid with the ICCV solver.  Returns a new (170,) array."""
    rpc = np.asarray(rpc, dtype=np.float64).copy()
    grid = create_virtual_grid(rpc, xy_samples, z_samples)
    samp_n = (grid[:, 0] - rpc[SAMP_OFF]) / rpc[SAMP_SCALE]
    line_n = (grid[:, 1] - rpc[LINE_OFF]) / rpc[LINE_SCALE]
    lat_n = (grid[:, 2] - rpc[LAT_OFF]) / rpc[LAT_SCALE]
    lon_n = (grid[:, 3] - rpc[LON_OFF]) / rpc[LON_SCALE]
    hei_n = (grid[:, 4] - rpc[HEI_OFF]) / rpc[HEI_SCALE]

    basis = poly_basis(samp_n, line_n, hei_n)  # P = samp, L = line
    a, rhs = _rational_design_matrix(basis, lat_n, lon_n)
    x, _ = solve_iccv(a.T @ a, a.T @ rhs)

    rpc[LATNUM] = x[0:20]
    rpc[110] = 1.0
    rpc[111:130] = x[20:39]
    rpc[LONNUM] = x[39:59]
    rpc[150] = 1.0
    rpc[151:170] = x[59:78]
    return rpc
