"""Target-side ray generation ('steppers').

PyTorch counterpart of envutil_tpu/models/stepper.py. The reference's
steppers (stepper.h:215-1789) walk the target raster and emit, per
pixel, a 3D ray already rotated into a source facet's coordinate
system. Here the raster (or a window of it) is materialized at once:

    planar grid (edge-to-edge affine, stepper.h:294-333)
    -> per-projection planar->ray (geometry.py)
    -> rotation by the camera-to-facet basis matrix
    -> optional normalization

Axes are computed host-side in float64 numpy and cast once to float32,
as the JAX package does. ``target_ninepack`` gives the three grids of
the twining 'deriv stepper' (centre and the two DERIV_BIAS-biased
ones). The JAX package's traced-origin variants (``*_dyn``) serve its
per-tile fallback and have no caller here.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import geometry as geo
from ..core.conventions import Projection

# sub-pixel offset of the derivative grids, in sample steps: small
# enough that differencing stays on one side of most discontinuities
# (stepper.h:1587-1715)
DERIV_BIAS = 0.25


def planar_axis(n: int, lo: float, hi: float, bias: float,
                dtype=np.float32, i0: int = 0,
                i1: int | None = None) -> np.ndarray:
    """Edge-to-edge sample positions: samples i0..i1 of an n-sample
    axis placed half a step inside [lo, hi] plus a bias offset in
    *sample-step* units (stepper.h:294-333: the doubled-int formulation
    keeps the samples exactly in range; we compute in float64
    host-side which is at least as precise). Indices beyond n
    extrapolate smoothly (used for tile padding)."""
    i1 = n if i1 is None else i1
    i = np.arange(i0, i1, dtype=np.float64)
    ll = 2.0 * i + 1.0
    fx0 = lo / (2.0 * n)
    fx1 = hi / (2.0 * n)
    b = bias * (hi - lo) / n
    return (b + ll * fx1 + (2.0 * n - ll) * fx0).astype(dtype)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def planar_grid(width: int, height: int, extent, bias=(0.0, 0.0),
                dtype=np.float32, window=None, device="cpu"):
    """SoA planar coordinate grid (px, py), each (H, W) (or the window's
    shape if ``window=(y0, y1, x0, x1)`` in discrete pixels is given)."""
    if window is not None:
        y0, y1, x0, x1 = window
        xs = planar_axis(width, extent.x0, extent.x1, bias[0], dtype,
                         x0, x1)
        ys = planar_axis(height, extent.y0, extent.y1, bias[1], dtype,
                         y0, y1)
    else:
        xs = planar_axis(width, extent.x0, extent.x1, bias[0], dtype)
        ys = planar_axis(height, extent.y0, extent.y1, bias[1], dtype)
    shape = (ys.size, xs.size)
    px = _tensor(xs, device)[None, :].expand(shape)
    py = _tensor(ys, device)[:, None].expand(shape)
    return px, py


def _cubemap_target_rays(projection, width, height, extent, px, py,
                         row_index):
    """Cubemap/biatan6 targets: the face is determined by the integer
    row (iy // width, stepper.h:1289), which is robust at section
    boundaries; in-face coordinates come from the planar grid."""
    section_md = extent.x1 - extent.x0
    refc_md = section_md / 2.0
    face = torch.div(row_index, width, rounding_mode="floor").to(torch.int32)
    p1 = py + (3.0 - face.to(py.dtype)) * section_md - refc_md
    p0 = px
    if projection == Projection.BIATAN6:
        p0 = torch.tan(p0 * (math.pi / 4.0))
        p1 = torch.tan(p1 * (math.pi / 4.0))
    return geo.in_face_to_ray(face, p0, p1)


def _separable_target_rays(projection, width, height, extent, bias,
                           window, device):
    """Spherical/cylindrical targets factor into per-axis terms
    (ll_to_ray = outer products of sincos(lon) and sincos(lat)): the
    transcendentals run host-side in float64 on the two 1D axes and
    the device only sees broadcast multiplies (the reference steppers'
    row-invariant sincos tricks, stepper.h:520-707)."""
    y0, y1, x0, x1 = (0, height, 0, width) if window is None \
        else window
    xs = planar_axis(width, extent.x0, extent.x1, bias[0],
                     np.float64, x0, x1)
    ys = planar_axis(height, extent.y0, extent.y1, bias[1],
                     np.float64, y0, y1)
    shape = (ys.size, xs.size)

    def col(a):
        return _tensor(a.astype(np.float32), device)[None, :]

    def row(a):
        return _tensor(a.astype(np.float32), device)[:, None]

    if projection == Projection.SPHERICAL:
        sl, cl = col(np.sin(xs)), col(np.cos(xs))
        st, ct = row(np.sin(ys)), row(np.cos(ys))
        return ((sl * ct).expand(shape), st.expand(shape),
                (cl * ct).expand(shape))
    # cylindrical: (sin(az), y, cos(az))
    return (col(np.sin(xs)).expand(shape), row(ys).expand(shape),
            col(np.cos(xs)).expand(shape))


def target_rays(projection: Projection, width: int, height: int, extent,
                basis: Optional[np.ndarray] = None,
                normalize: bool = True,
                bias=(0.0, 0.0),
                dtype=np.float32,
                window=None,
                device="cpu",
                planar_to_ray=None):
    """Rays for every pixel of the target raster (or ``window``), in the
    coordinate system selected by ``basis`` (3x3 host matrix; None =
    target CS), as tensors on ``device``.

    ``planar_to_ray`` overrides the projection-based transform: the
    'generic stepper' case (stepper.h:356-490) where lens correction or
    translation chains replace the plain projection."""
    if (planar_to_ray is None and dtype == np.float32
            and projection in (Projection.SPHERICAL,
                               Projection.CYLINDRICAL)):
        ray = _separable_target_rays(projection, width, height,
                                     extent, bias, window, device)
    else:
        px, py = planar_grid(width, height, extent, bias, dtype, window,
                             device)
        if planar_to_ray is not None:
            ray = planar_to_ray(px, py)
        elif projection in (Projection.CUBEMAP, Projection.BIATAN6):
            y_lo = 0 if window is None else window[0]
            rows = torch.arange(y_lo, y_lo + px.shape[0],
                                device=px.device)[:, None].expand(px.shape)
            ray = _cubemap_target_rays(projection, width, height, extent,
                                       px, py, rows)
        else:
            ray = geo.to_ray(projection)(px, py)
    if basis is not None:
        ray = geo.apply_matrix(basis, *ray)
    if normalize:
        ray = geo.normalize(*ray)
    return ray


def target_ninepack(projection, width, height, extent, basis=None,
                    normalize=True, dtype=np.float32, planar_to_ray=None,
                    window=None, device="cpu"):
    """The three ray grids for twining: centre, +DERIV_BIAS in x,
    +DERIV_BIAS in y (deriv_stepper, stepper.h:1587-1715). For cubemap
    and biatan6 targets all three take their face from the integer row,
    so a biased grid never leaves the centre's face."""
    def mk(bias):
        return target_rays(projection, width, height, extent, basis,
                           normalize, bias, dtype, window, device,
                           planar_to_ray)
    return mk((0.0, 0.0)), mk((DERIV_BIAS, 0.0)), mk((0.0, DERIV_BIAS))
