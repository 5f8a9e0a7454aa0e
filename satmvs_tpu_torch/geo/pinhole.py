"""Pinhole cameras: the DLT fit of K·[R|t] to an RPC, and the projection
matrices the pinhole plane sweep consumes.

Counterpart of `satmvs_tpu/geo/pinhole.py`.  Host numpy/scipy in float64:
cameras are fitted and composed while data is prepared, and only their
float32 projection matrices reach the device.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg


def factorize(p: np.ndarray):
    """(K, R, t) of a 3×4 projection matrix: K upper-triangular with a
    positive diagonal, normalized by K[2, 2]; det(R) = 1; t (3, 1)."""
    k, r = linalg.rq(p[:, :3])
    t = linalg.lstsq(k, p[:, 3:4])[0]

    neg = int(k[0, 0] < 0) + int(k[1, 1] < 0) + int(k[2, 2] < 0)
    if neg in (1, 3):
        k = -k
    fix = np.diag((1.0, 1.0, 1.0))
    if k[0, 0] < 0 and k[1, 1] < 0:
        fix = np.diag((-1.0, -1.0, 1.0))
    elif k[0, 0] < 0 and k[2, 2] < 0:
        fix = np.diag((-1.0, 1.0, -1.0))
    elif k[1, 1] < 0 and k[2, 2] < 0:
        fix = np.diag((1.0, -1.0, -1.0))
    k = k @ fix
    r = fix @ r
    t = fix @ t
    if linalg.det(r) <= 0:
        raise ValueError("factorize: the rotation's determinant is not positive")
    k /= k[2, 2]
    return k, r, t


def _columns(xx, yy, zz, col, row, keep_mask):
    arrays = [np.asarray(a, dtype=np.float64).reshape(-1, 1) for a in (xx, yy, zz, col, row)]
    if keep_mask is not None:
        mask = np.asarray(keep_mask).reshape(-1)
        arrays = [a[mask].reshape(-1, 1) for a in arrays]
    return arrays


def solve_perspective(xx, yy, zz, col, row, keep_mask=None):
    """(K, R, t) fitted to object points (xx, yy, zz) and their pixels
    (col, row): the SVD of the 2N × 12 DLT system, then `factorize`."""
    xx, yy, zz, col, row = _columns(xx, yy, zz, col, row, keep_mask)
    n = xx.size
    ones = np.ones((n, 1))
    zeros = np.zeros((n, 4))
    a1 = np.hstack([xx, yy, zz, ones, zeros, -col * xx, -col * yy, -col * zz, -col])
    a2 = np.hstack([zeros, xx, yy, zz, ones, -row * xx, -row * yy, -row * zz, -row])
    _, _, vh = linalg.svd(np.vstack([a1, a2]), full_matrices=False)
    return factorize(np.real(vh[11, :]).reshape(3, 4))


def check_perspective_error(xx, yy, zz, col, row, k, r, t, keep_mask=None):
    """A fitted camera's forward projection error (px) and inverse
    projection error (m: the point against the ray through its pixel,
    scaled to the least-squares depth).  Returns (proj_err, inv_err), each
    (N, 1)."""
    xx, yy, zz, col, row = _columns(xx, yy, zz, col, row, keep_mask)
    ones = np.ones((xx.size, 1))
    pts = np.hstack([xx, yy, zz])

    cam = pts @ r.T + t.T
    proj = np.hstack([pts, ones]) @ (k @ np.hstack([r, t])).T
    est_col = proj[:, 0:1] / proj[:, 2:3]
    est_row = proj[:, 1:2] / proj[:, 2:3]
    proj_err = np.hypot(est_row - row, est_col - col)

    rays = np.hstack([col, row, ones]) @ np.linalg.inv(k.T)
    scale = np.sum(cam * rays, axis=1, keepdims=True) / np.sum(rays * rays, axis=1, keepdims=True)
    inv_err = np.sqrt(np.sum((rays * scale - cam) ** 2, axis=1, keepdims=True))
    return proj_err, inv_err


def remap_skew(image: np.ndarray, k: np.ndarray):
    """The image resampled (bilinear) through K_noskew · K⁻¹ so that its
    intrinsics lose the skew K[0, 1].  Returns (image_noskew, K_noskew)."""
    from scipy.ndimage import map_coordinates

    k = np.asarray(k, dtype=np.float64)
    k_ns = k.copy()
    k_ns[0, 1] = 0.0
    m = k @ np.linalg.inv(k_ns)  # target pixel → source pixel
    h, w = image.shape[:2]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    src = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ m.T
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]

    def sample(plane):
        return map_coordinates(plane.astype(np.float64), [sy, sx], order=1, mode="constant")

    if image.ndim == 2:
        out = sample(image)
    else:
        out = np.stack([sample(image[..., c]) for c in range(image.shape[2])], axis=-1)
    return out.astype(image.dtype), k_ns


def fit_pinhole_from_rpc(rpc, width: int, height: int, tm=None, xy_samples: int = 20,
                         z_samples: int = 10):
    """A pinhole camera K·[R|t] fitted to an RPC over its image and height
    range: a pixel grid at z_samples heights, taken to (lat, lon) by the
    inverse RPC and to UTM east/north (`tm`, by default the zone of the
    RPC's centre), then `solve_perspective`.  Object points are (east,
    north, height).  Returns (K, R, t, proj_err_px, inv_err_m)."""
    from . import rpc as rpclib
    from .tmerc import TransverseMercator

    rpc = np.asarray(rpc, dtype=np.float64)
    tm = tm or TransverseMercator.utm_for(float(rpc[rpclib.LON_OFF]))

    h_min, h_max = rpclib.height_range(rpc)
    x = np.linspace(0, width - 1, xy_samples)
    y = np.linspace(0, height - 1, xy_samples)
    z = np.linspace(h_min, h_max, z_samples)
    gx, gy, gz = (g.reshape(-1) for g in np.meshgrid(x, y, z))
    lat, lon = rpclib.photo_to_obj(rpc, gx, gy, gz)
    en = tm.proj(np.stack([lat, lon], axis=-1))
    xx, yy = en[:, 0], en[:, 1]

    k, r, t = solve_perspective(xx, yy, gz, gx, gy)
    proj_err, inv_err = check_perspective_error(xx, yy, gz, gx, gy, k, r, t)
    return k, r, t, proj_err, inv_err


def compose_proj_matrix(intrinsics: np.ndarray, extrinsics: np.ndarray) -> np.ndarray:
    """4×4 projection matrix [K·E[:3]; 0 0 0 1] of a 3×3 K and a 4×4 E."""
    proj = np.asarray(extrinsics, dtype=np.float64).copy()
    proj[:3, :4] = intrinsics @ proj[:3, :4]
    return proj


def scale_proj_matrix(proj: np.ndarray, scale: float) -> np.ndarray:
    """Projection matrices (..., 4, 4) of the image resized by `scale`:
    rows 0-1 scale."""
    out = np.asarray(proj, dtype=np.float64).copy()
    out[..., :2, :] *= scale
    return out


def local_proj_matrices(ks: np.ndarray, es: np.ndarray) -> np.ndarray:
    """(V, 4, 4) projection matrices K·E of the views' intrinsics ks
    (V, 3, 3) and extrinsics es (V, 4, 4), in an object frame moved to the
    mean camera centre: the relative transforms of the sweep are the same,
    and the matrices stay far better conditioned than in the UTM frame."""
    es = np.asarray(es, dtype=np.float64)
    centers = np.stack([-e[:3, :3].T @ e[:3, 3] for e in es])
    origin = centers.mean(axis=0)
    projs = []
    for e, k in zip(es, ks):
        e_local = e.copy()
        e_local[:3, 3] = e[:3, 3] + e[:3, :3] @ origin
        projs.append(compose_proj_matrix(k, e_local))
    return np.stack(projs)
