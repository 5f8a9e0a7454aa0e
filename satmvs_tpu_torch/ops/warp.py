"""Plane-sweep geometry under the RPC camera (basis and QC forms) and the
pinhole camera.

Counterpart of `satmvs_tpu/ops/warp.py`: exact per-pixel coordinates by
default, the coarse grid of `ops/coarse_coords.py` on request
(coords="coarse", RPC basis cameras only, as in JAX).
Geometry carries no gradient, and none of it is a matmul: every product is
an elementwise fp32 product, so no TF32 setting of the caller reaches it.

RPC: `build_rpc_warp_cams` turns (V, 170) float64 RPCs into the float32
`RpcWarpCams` the device chain consumes; float64 appears only there, on
the host.  The chain ref photo → ref-normalized object → (host-fp64 renorm
affine) → src-normalized object → src photo then runs in float32 without
ever forming absolute lat/lon.  `QcWarpCams` (`build_qc_warp_cams`, the
`use_qc` variant) carries the same polynomials packed as symmetric
(4, 4, 4) tensors and `rpc_sweep_coords_qc` sums their 64 terms.

Pinhole: a sample's cameras are (V, 4, 4) projection matrices K·E
(`geo.pinhole.local_proj_matrices`); `homo_sweep_coords` forms the 4×4
relative transform src · ref⁻¹ in float64 on the tensor's device, casts it
to float32, and maps each pixel with a 3×3 product written out in
multiply-adds.

`sweep_coords` picks the chain by the cameras' type; `sample_coords` adds
the reference's grid_sample stretch under convention="torch" (the
`torch_compat` mode).  `rpc_warp` and `homo_warp` are the per-view
training warps: coordinates as above, then the `sweep_gather` kernel,
differentiable in the source features.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..geo import rpc as rpclib
from .kernels.sweep_gather import sweep_gather
from .sampling import torch_grid_coords


class _Bundle:
    """A frozen dataclass of tensors: `map`, `to` and indexing act on every
    field."""

    def map(self, fn):
        """The bundle with fn applied to every field."""
        return type(self)(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))

    def to(self, device):
        return self.map(lambda t: t.to(device))

    def __getitem__(self, b):
        return self.map(lambda t: t[b])


@dataclasses.dataclass(frozen=True)
class RpcWarpCams(_Bundle):
    """float32 camera bundle of one (ref, srcs...) plane sweep.

    The source-view axis S = V - 1 leads the src_* fields.  A batched bundle
    (from `stack_cams`) has one more leading axis B on every field; index it
    with `cams[b]` to get one sample's bundle.
    """

    ref_inv: torch.Tensor     # (20, 4)    inverse RPC of the reference view
    ref_norm: torch.Tensor    # (3, 2)     [[off, 1/scale] x (samp, line, hei)]
    src_fwd: torch.Tensor     # (S, 20, 4) direct RPCs of the source views
    src_denorm: torch.Tensor  # (S, 2, 2)  [[scale, off] x (samp, line)]
    renorm: torch.Tensor      # (S, 3, 2)  [[scale, shift] x (lat, lon, hei)]


@dataclasses.dataclass(frozen=True)
class QcWarpCams(_Bundle):
    """`RpcWarpCams` with the polynomials in QC form: each of the four
    rational polynomials' numerator and denominator a symmetric (4, 4, 4)
    tensor over x = (1, L, P, H) (`geo.rpc.to_qc_tensor`).  Batched and
    indexed as `RpcWarpCams`."""

    ref_inv_qc: torch.Tensor  # (4, 4, 4, 4)    [latnum, latden, lonnum, londen]
    ref_norm: torch.Tensor    # (3, 2)
    src_fwd_qc: torch.Tensor  # (S, 4, 4, 4, 4) [snum, sden, lnum, lden]
    src_denorm: torch.Tensor  # (S, 2, 2)
    renorm: torch.Tensor      # (S, 3, 2)


def build_rpc_warp_cams(rpcs, ref_index: int = 0, stage_scale: float = 1.0,
                        device=None) -> RpcWarpCams:
    """`RpcWarpCams` from raw (V, 170) float64 RPCs, row `ref_index` the
    reference view, for a cascade stage at image scale `stage_scale`."""
    dev = resolve_device(device)
    rpcs = np.asarray(rpcs, dtype=np.float64)
    scaled = np.stack([rpclib.scale_rpc(r, stage_scale) for r in rpcs])
    ref = scaled[ref_index]
    srcs = [scaled[v] for v in range(len(scaled)) if v != ref_index]

    ref_norm = np.array([
        [ref[rpclib.SAMP_OFF], 1.0 / ref[rpclib.SAMP_SCALE]],
        [ref[rpclib.LINE_OFF], 1.0 / ref[rpclib.LINE_SCALE]],
        [ref[rpclib.HEI_OFF], 1.0 / ref[rpclib.HEI_SCALE]],
    ])
    src_denorm = np.stack([
        np.array([[s[rpclib.SAMP_SCALE], s[rpclib.SAMP_OFF]],
                  [s[rpclib.LINE_SCALE], s[rpclib.LINE_OFF]]])
        for s in srcs
    ])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return RpcWarpCams(
        ref_inv=f32(rpclib.inv_coef_matrix(ref)),
        ref_norm=f32(ref_norm),
        src_fwd=f32(np.stack([rpclib.fwd_coef_matrix(s) for s in srcs])),
        src_denorm=f32(src_denorm),
        renorm=f32(np.stack([rpclib.renorm_affine(ref, s) for s in srcs])),
    )


STAGE_SCALES = {3: (0.25, 0.5, 1.0), 2: (0.25, 1.0), 1: (0.25,)}


def build_qc_warp_cams(rpcs, ref_index: int = 0, stage_scale: float = 1.0,
                       device=None) -> QcWarpCams:
    """`build_rpc_warp_cams` with the polynomials packed in QC form."""
    base = build_rpc_warp_cams(rpcs, ref_index, stage_scale, device)
    rpcs = np.asarray(rpcs, dtype=np.float64)
    ref = rpcs[ref_index]  # the polynomials do not depend on the stage's scale
    srcs = [rpcs[v] for v in range(len(rpcs)) if v != ref_index]
    ref_qc = np.stack([rpclib.to_qc_tensor(ref[sl]) for sl in
                       (rpclib.LATNUM, rpclib.LATDEM, rpclib.LONNUM, rpclib.LONDEM)])
    src_qc = np.stack([np.stack([rpclib.to_qc_tensor(s[sl]) for sl in
                                 (rpclib.SNUM, rpclib.SDEM, rpclib.LNUM, rpclib.LDEM)])
                       for s in srcs])
    dev = base.ref_norm.device
    return QcWarpCams(
        ref_inv_qc=torch.as_tensor(ref_qc.astype(np.float32), device=dev),
        ref_norm=base.ref_norm,
        src_fwd_qc=torch.as_tensor(src_qc.astype(np.float32), device=dev),
        src_denorm=base.src_denorm,
        renorm=base.renorm,
    )


def build_stage_cams(rpcs, ref_index: int = 0, device=None, num_stage: int = 3):
    """Camera bundles of the cascade's stages, coarsest first (image scales
    1/4, 1/2, 1 for three stages; 1/4, 1 for two; 1/4 for one)."""
    return tuple(build_rpc_warp_cams(rpcs, ref_index, s, device)
                 for s in STAGE_SCALES[num_stage])


def build_qc_stage_cams(rpcs, ref_index: int = 0, device=None, num_stage: int = 3):
    """`build_stage_cams` in QC form (the `use_qc` variant)."""
    return tuple(build_qc_warp_cams(rpcs, ref_index, s, device)
                 for s in STAGE_SCALES[num_stage])


def stack_cams(cams_list):
    """Stack per-sample cameras into one batch (leading B): bundles of one
    type field by field, pinhole (V, 4, 4) tensors into (B, V, 4, 4)."""
    first = cams_list[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(cams_list)
    return type(first)(*(torch.stack([getattr(c, f.name) for c in cams_list])
                         for f in dataclasses.fields(first)))


def rpc_transform_points(cams: RpcWarpCams, src_index: int, x, y, h):
    """Reference-view photo coordinates + heights → source-view photo
    coordinates (x_src, y_src), shaped like x.  Unbatched `cams`."""
    rn = cams.ref_norm
    xn = (x - rn[0, 0]) * rn[0, 1]
    yn = (y - rn[1, 0]) * rn[1, 1]
    hn = (h - rn[2, 0]) * rn[2, 1]

    lat_n, lon_n = rpclib.photo_to_obj_n(cams.ref_inv, xn, yn, hn)

    aff = cams.renorm[src_index]
    lat_s = lat_n * aff[0, 0] + aff[0, 1]
    lon_s = lon_n * aff[1, 0] + aff[1, 1]
    hei_s = hn * aff[2, 0] + aff[2, 1]

    samp_n, line_n = rpclib.obj_to_photo_n(cams.src_fwd[src_index], lat_s, lon_s, hei_s)

    dn = cams.src_denorm[src_index]
    return samp_n * dn[0, 0] + dn[0, 1], line_n * dn[1, 0] + dn[1, 1]


def _sweep_grid(depth_values: torch.Tensor, height: int, width: int, row0: int = 0):
    """(xs, ys, hyps), each (D, H, W) float32: the reference pixel grid of
    rows row0 .. row0 + H − 1 and the hypotheses ((D, H, W) or (D,))
    broadcast over it."""
    d = depth_values.shape[0]
    dev = depth_values.device
    hyp = depth_values.to(torch.float32)
    if hyp.ndim == 1:
        hyp = hyp.reshape(d, 1, 1)
    hyp = hyp.expand(d, height, width)
    xs = torch.arange(width, dtype=torch.float32, device=dev).expand(d, height, width)
    ys = torch.arange(row0, row0 + height, dtype=torch.float32, device=dev).reshape(
        height, 1).expand(d, height, width)
    return xs, ys, hyp


@torch.no_grad()
def rpc_sweep_coords(cams: RpcWarpCams, src_index: int, depth_values: torch.Tensor,
                     height: int, width: int, row0: int = 0):
    """Source-view pixel coordinates of the RPC plane sweep.

    depth_values: (D, H, W) or (D,) height hypotheses in metres, for the
    reference rows row0 .. row0 + H − 1 (a band of them under height
    sharding).  Returns (x_src, y_src), each (D, H, W) float32, exact per
    pixel.
    """
    return rpc_transform_points(cams, src_index, *_sweep_grid(depth_values, height, width, row0))


def _qc_pair(qc4: torch.Tensor, p, l, h):
    """Two rational QC polynomials sharing x = (1, L, P, H): qc4 (4, 4, 4, 4)
    = [num_a, den_a, num_b, den_b] → (num_a/den_a, num_b/den_b) like p.
    Each is Σ T[i,j,k]·x_i·x_j·x_k over the 64 terms, fp32 products and
    sums (`geo.rpc.qc_monomials`), no matmul."""
    mono = rpclib.qc_monomials(torch.stack([torch.ones_like(p), l, p, h], -1))
    vals = [(mono * qc4[n].reshape(64)).sum(-1) for n in range(4)]
    return vals[0] / vals[1], vals[2] / vals[3]


@torch.no_grad()
def rpc_sweep_coords_qc(cams: QcWarpCams, src_index: int, depth_values: torch.Tensor,
                        height: int, width: int, row0: int = 0):
    """`rpc_sweep_coords` of QC-form cameras (the `use_qc` variant): the same
    chain, each rational polynomial summed over its (4, 4, 4) tensor."""
    xs, ys, hyp = _sweep_grid(depth_values, height, width, row0)
    rn = cams.ref_norm
    xn = (xs - rn[0, 0]) * rn[0, 1]
    yn = (ys - rn[1, 0]) * rn[1, 1]
    hn = (hyp - rn[2, 0]) * rn[2, 1]

    lat_n, lon_n = _qc_pair(cams.ref_inv_qc, xn, yn, hn)  # P = samp_n, L = line_n
    aff = cams.renorm[src_index]
    lat_s = lat_n * aff[0, 0] + aff[0, 1]
    lon_s = lon_n * aff[1, 0] + aff[1, 1]
    hei_s = hn * aff[2, 0] + aff[2, 1]
    samp_n, line_n = _qc_pair(cams.src_fwd_qc[src_index], lat_s, lon_s, hei_s)  # P = lat_n
    dn = cams.src_denorm[src_index]
    return samp_n * dn[0, 0] + dn[0, 1], line_n * dn[1, 0] + dn[1, 1]


def relative_transform(proj_to: torch.Tensor, proj_from: torch.Tensor) -> torch.Tensor:
    """proj_to · proj_from⁻¹ of two 4×4 projection matrices, formed in
    float64 on their device and returned in float32.  Cameras fitted to a
    satellite's RPC have condition numbers near 1e16: a float32 inverse
    would depend on how the device's LU pivots and rounds, the float64 one
    agrees with any other to far below float32's precision."""
    to64, from64 = proj_to.to(torch.float64), proj_from.to(torch.float64)
    inv, _ = torch.linalg.inv_ex(from64)
    return (to64 @ inv).to(torch.float32)


def guard_z(z: torch.Tensor) -> torch.Tensor:
    """z with |z| < 1e-6 set to 1e-6 (a division guard behind the camera)."""
    return torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)


@torch.no_grad()
def homo_sweep_coords(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                      depth_values: torch.Tensor, height: int, width: int, row0: int = 0):
    """Source-view pixel coordinates of the pinhole homography sweep:
    p ~ rel[:3, :3]·(x, y, 1)·d + rel[:3, 3] with rel = src_proj · ref_proj⁻¹
    (`relative_transform`).  src_proj, ref_proj (4, 4); depth_values
    (D, H, W) or (D,) depth hypotheses of the reference rows row0 .. row0 +
    H − 1.  Returns (x_src, y_src), each (D, H, W) float32; the 3×3 product
    is written out in fp32 multiply-adds."""
    rel = relative_transform(src_proj, ref_proj)
    d = depth_values.shape[0]
    hyp = depth_values.to(torch.float32)
    hyp = (hyp.reshape(d, 1, 1) if hyp.ndim == 1 else hyp).expand(d, height, width)
    dev = depth_values.device
    xs = torch.arange(width, dtype=torch.float32, device=dev).expand(height, width)
    ys = torch.arange(row0, row0 + height, dtype=torch.float32, device=dev).reshape(
        height, 1).expand(height, width)
    p = [(xs * rel[c, 0] + ys * rel[c, 1] + rel[c, 2]) * hyp + rel[c, 3] for c in range(3)]
    z = guard_z(p[2])
    return p[0] / z, p[1] / z


COORDS = ("exact", "coarse")
CONVENTIONS = ("exact", "torch")


def _check_choice(what: str, value: str, choices: tuple) -> None:
    if value not in choices:
        raise ValueError(f"{what}={value!r}: want one of {choices}")


def sweep_coords(cams, src_index: int, depth_values: torch.Tensor, height: int, width: int,
                 row0: int = 0, coords: str = "exact", window: torch.Tensor | None = None):
    """One sample's sweep coordinates for source view src_index under its
    cameras, for the reference rows row0 .. row0 + height − 1:
    `rpc_sweep_coords` for `RpcWarpCams` (`ops.coarse_coords.
    rpc_sweep_coords_coarse` with coords="coarse", window its fit's
    hypotheses), `rpc_sweep_coords_qc` for `QcWarpCams`, `homo_sweep_coords`
    for pinhole (V, 4, 4) projection matrices (view 0 the reference).  As
    in JAX (`satmvs_tpu/ops/warp.py:189-194`), QC and pinhole cameras take
    their exact chain whatever coords says."""
    _check_choice("coords", coords, COORDS)
    if isinstance(cams, torch.Tensor):
        return homo_sweep_coords(cams[src_index + 1], cams[0], depth_values, height, width,
                                 row0)
    if isinstance(cams, QcWarpCams):
        return rpc_sweep_coords_qc(cams, src_index, depth_values, height, width, row0)
    if coords == "coarse":
        from .coarse_coords import rpc_sweep_coords_coarse

        return rpc_sweep_coords_coarse(cams, src_index, depth_values, height, width,
                                       row0=row0, window=window)
    return rpc_sweep_coords(cams, src_index, depth_values, height, width, row0)


def sample_coords(cams, src_index: int, depth_values: torch.Tensor, height: int, width: int,
                  src_hw: tuple[int, int], row0: int = 0, coords: str = "exact",
                  convention: str = "exact", window: torch.Tensor | None = None):
    """`sweep_coords`, then under convention="torch" the reference's
    grid_sample stretch (`ops.sampling.torch_grid_coords`) of a source map
    of src_hw = (rows, columns): the positions a sweep kernel samples."""
    _check_choice("convention", convention, CONVENTIONS)
    xs, ys = sweep_coords(cams, src_index, depth_values, height, width, row0, coords, window)
    if convention == "torch":
        xs, ys = torch_grid_coords(xs, ys, *src_hw)
    return xs, ys


def rpc_warp(src_feat: torch.Tensor, cams: RpcWarpCams | QcWarpCams, src_index: int,
             depth_values: torch.Tensor, convention: str = "exact",
             out_dtype=None, row0: int = 0, coords: str = "exact",
             window: torch.Tensor | None = None) -> torch.Tensor:
    """RPC plane-sweep warp of one source view: src_feat (H, W, C) sampled at
    the sweep coordinates of `depth_values` ((D, H, W) or (D,) heights) →
    (D, H, W, C), differentiable in src_feat; the coordinates carry no
    gradient.

    Counterpart of `satmvs_tpu/ops/warp.py:rpc_warp`; its `method` and
    `stencil` choose among TPU implementations and have none here.
    coords: "exact" (the default) or "coarse" (`ops.coarse_coords`; window
    as there).  convention: "exact" samples at the projected pixel, "torch"
    where the reference's grid_sample reads (`ops.sampling.
    torch_grid_coords`, stretched by the source map's own height and
    width).  out_dtype: the warped volume's storage dtype (None: float32;
    torch.bfloat16 halves the volume's bytes: the sample is taken in
    float32 and rounded once, and the backward reads the bf16 cotangent
    into the float32 scatter).  Unbatched `cams`, of either RPC form.  With
    (D, H', W) hypotheses the warp covers the reference rows row0 .. row0 +
    H' − 1 (a rank's band under height sharding) and reads the source whole
    → (D, H', W, C).
    """
    h, w, _ = src_feat.shape
    hb = depth_values.shape[1] if depth_values.ndim == 3 else h
    xs, ys = sample_coords(cams, src_index, depth_values, hb, w, (h, w), row0, coords,
                           convention, window)
    return sweep_gather(src_feat, xs.contiguous(), ys.contiguous(), out_dtype)


def homo_warp(src_feat: torch.Tensor, src_proj: torch.Tensor, ref_proj: torch.Tensor,
              depth_values: torch.Tensor, convention: str = "exact",
              out_dtype=None, row0: int = 0) -> torch.Tensor:
    """Pinhole plane-sweep warp of one source view: src_feat (H, W, C)
    sampled at the homography sweep's coordinates (`homo_sweep_coords`) →
    (D, H, W, C) by the `sweep_gather` kernel, differentiable in src_feat;
    out_dtype, convention and a band of rows (row0) as in `rpc_warp`."""
    _check_choice("convention", convention, CONVENTIONS)
    h, w, _ = src_feat.shape
    hb = depth_values.shape[1] if depth_values.ndim == 3 else h
    xs, ys = homo_sweep_coords(src_proj, ref_proj, depth_values, hb, w, row0)
    if convention == "torch":
        xs, ys = torch_grid_coords(xs, ys, h, w)
    return sweep_gather(src_feat, xs.contiguous(), ys.contiguous(), out_dtype)
