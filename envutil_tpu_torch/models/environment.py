"""Facet 'environments': ray -> pixel lookup over loaded image data.

PyTorch counterpart of envutil_tpu/models/environment.py (the
reference's environment.h). A facet becomes a ``FacetSource``: the
prefiltered spline coefficients as a tensor on the render device plus a
hashable ``SourceStatic`` that selects the lookup math.

Lookup semantics mirror mount_t (environment.h:1030-1197): ray ->
planar (per projection), optional PTO planar transform, window-extent
validity mask (+z>0 for rectilinear), miss -> 0; then alpha_masking_t
(masking.h:93), repix_t channel adaptation (environment.h:1199-1384)
and the per-facet 'brighten' (environment.h:1821-1842).

cubemap_view_t (environment.h:1396-1488) for cubemap/biatan6 IR
sources: ray -> cube face + in-face coordinates -> IR pickup, with the
biatan6 in-plane atan (the IR itself is built by models/cubemap.py).

Paint (--mask_for) sources and the alpha synthesis of PTO masks and
lens crops wait for later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core import geometry as geo
from ..core.conventions import Projection
from ..core.facet import Facet
from ..core.metrics import CubemapMetrics, Extent, get_extent
from ..ops import spline as S
from ..runtime.platform import resolve_device
from . import lens as L


@dataclasses.dataclass(frozen=True)
class SourceStatic:
    """Hashable per-facet configuration that selects the lookup math."""
    kind: str                      # "mount" | "cubemap" | "paint"
    projection: Projection
    total_extent: Extent
    window_extent: Extent
    total_width: int
    total_height: int
    window_x_offset: int
    window_y_offset: int
    nch_native: int
    recip_step: float
    brighten: float
    masked: int = -1
    full_fisheye: bool = False
    # PTO planar transform (target->source direction)
    has_lcp: bool = False
    has_shift: bool = False
    has_shear: bool = False
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    s: float = 1.0
    h: float = 0.0
    v: float = 0.0
    shear_g: float = 0.0
    shear_t: float = 0.0
    # cubemap IR
    metrics: Optional[CubemapMetrics] = None


@dataclasses.dataclass
class FacetSource:
    static: SourceStatic
    spl: Optional[S.Spline2D]


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------

def is_full_spherical(fct: Facet) -> bool:
    return (fct.projection == Projection.SPHERICAL
            and abs(fct.hfov - 2.0 * math.pi) < 1e-6
            and fct.width == 2 * fct.height)


def make_mount_source(fct: Facet, img: np.ndarray, spline_degree: int,
                      prefilter_degree: int, verbose: bool = False,
                      device=None) -> FacetSource:
    """source_t + mount_t construction (environment.h:594-962); the
    spline is prefiltered on ``device`` (CUDA unless the caller asks
    for the CPU)."""
    device = resolve_device(device)
    if img.ndim != 3:
        raise ValueError(
            f"mount source expects (H, W, C) pixel data, got {img.shape}")
    if fct.has_lens_crop or fct.has_pto_mask:
        raise NotImplementedError(
            "PTO exclude masks and lens crops (alpha synthesis) wait for "
            "the PTO slice of the PyTorch port")
    nch = img.shape[-1]

    bc0 = S.REFLECT
    if fct.projection in (Projection.SPHERICAL, Projection.CYLINDRICAL):
        if abs(fct.hfov - 2.0 * math.pi) < 1e-6:
            bc0 = S.PERIODIC

    spherical = is_full_spherical(fct)
    if verbose:
        kind = "spherical" if spherical else "ordinary"
        print(f"applying {kind} b-spline prefilter, degree "
              f"{prefilter_degree}")
    image = torch.from_numpy(
        np.ascontiguousarray(img, np.float32)).to(device)
    spl = S.make_spline(image, spline_degree, prefilter_degree,
                        bcs=(S.REFLECT, bc0), spherical=spherical)

    return FacetSource(static=mount_static(fct, nch), spl=spl)


def mount_static(fct: Facet, nch: int) -> SourceStatic:
    """The lookup configuration of a mount facet with ``nch`` native
    channels (source_t ctor, environment.h:594-962)."""
    total_extent = get_extent(fct.projection, fct.width, fct.height,
                              fct.hfov)
    # window extent for cropped input (source_t ctor,
    # environment.h:606-631 - note the reference derives both the x and
    # y fractions from total_width; we reproduce the y math faithfully
    # only when offsets are 0, and use the natural formula otherwise)
    wx = total_extent.x1 - total_extent.x0
    wy = total_extent.y1 - total_extent.y0
    x0 = total_extent.x0 + (fct.window_x_offset / fct.width) * wx
    y0 = total_extent.y0 + (fct.window_y_offset / fct.height) * wy
    x1 = total_extent.x0 + ((fct.window_x_offset + fct.window_width)
                            / fct.width) * wx
    y1 = total_extent.y0 + ((fct.window_y_offset + fct.window_height)
                            / fct.height) * wy
    window_extent = Extent(x0, x1, y0, y1)

    static = SourceStatic(
        kind="mount", projection=fct.projection,
        total_extent=total_extent, window_extent=window_extent,
        total_width=fct.width, total_height=fct.height,
        window_x_offset=fct.window_x_offset,
        window_y_offset=fct.window_y_offset,
        nch_native=nch, recip_step=1.0 / fct.step, brighten=fct.brighten,
        masked=fct.masked,
        full_fisheye=(fct.projection == Projection.FISHEYE
                      and fct.hfov >= 2.0 * math.pi),
        has_lcp=fct.has_lcp, has_shift=fct.has_shift,
        has_shear=fct.has_shear, a=fct.a, b=fct.b, c=fct.c, s=fct.s,
        h=fct.h, v=fct.v, shear_g=fct.shear_g, shear_t=fct.shear_t)
    return static


def source_from_arrays(coeff: np.ndarray, static: dict, pad: int,
                       degree: int, bcs, core_shape, spherical: bool,
                       device=None) -> FacetSource:
    """A ``FacetSource`` around already-braced (Hp, Wp, C) coefficients
    and the ``SourceStatic`` fields as a plain dict (extents and cubemap
    metrics as dicts or as their dataclasses, the projection as its
    integer code). This carries a table built elsewhere, for example by
    the JAX package, into the port unchanged, so a comparison of
    lookups is not also one of prefilters. A bfloat16 table (a numpy
    array of dtype ``bfloat16``, as the JAX package hands it over, or
    its 16-bit view, int16 or uint16) crosses bit for bit into a
    bfloat16 tensor; any other is carried as float32."""
    device = resolve_device(device)
    fields = dict(static)
    for key in ("total_extent", "window_extent"):
        ext = fields[key]
        fields[key] = ext if isinstance(ext, Extent) else Extent(**ext)
    fields["projection"] = Projection(int(fields["projection"]))
    m = fields.get("metrics")
    if m is not None and not isinstance(m, CubemapMetrics):
        fields["metrics"] = CubemapMetrics(**m)
    coeff = np.asarray(coeff)
    if coeff.dtype.name == "bfloat16" or coeff.dtype in (np.int16,
                                                          np.uint16):
        bits = np.array(coeff).view(np.int16)     # a writable copy
        table = torch.from_numpy(bits).view(torch.bfloat16).to(device)
    else:
        table = torch.from_numpy(np.array(coeff, np.float32)).to(device)
    spl = S.Spline2D(coeff=table, pad=int(pad), degree=int(degree),
                     bcs=tuple(bcs), core_shape=tuple(core_shape),
                     spherical=bool(spherical))
    return FacetSource(static=SourceStatic(**fields), spl=spl)


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------

def _planar_transform(st: SourceStatic):
    """PTO planar transform in target->source direction, built from the
    static config (pto_planar, environment.h:259-284)."""
    if not (st.has_lcp or st.has_shift or st.has_shear):
        return None

    def f(px, py):
        if st.has_lcp:
            r = torch.sqrt(px * px + py * py) / st.s
            factor = L.lcp_scale(r, st.a, st.b, st.c)
            px, py = px * factor, py * factor
        if st.has_shift:
            px, py = px + st.h, py + st.v
        if st.has_shear:
            nx = px + py * st.shear_g
            ny = py + px * st.shear_t
            px, py = nx, ny
        return px, py
    return f


def _mount_planar(st: SourceStatic, ray):
    crd = geo.to_plane(st.projection)(*ray)
    pf = _planar_transform(st)
    if pf is not None:
        crd = pf(*crd)
    return crd


def _no_paint(st: SourceStatic):
    if st.kind == "paint":
        raise NotImplementedError(
            "paint (--mask_for) sources wait for the masking slice of "
            "the PyTorch port")


def _cubemap_pickup(st: SourceStatic, ray):
    """IR pixel coordinates of the rays (cubemap_view_t): dominant-axis
    face, in-face coordinates, biatan6 in-plane atan, section offset."""
    face, fx, fy = geo.ray_to_cubeface(*ray)
    if st.projection == Projection.BIATAN6:
        fx = (4.0 / math.pi) * torch.atan(fx)
        fy = (4.0 / math.pi) * torch.atan(fy)
    return st.metrics.get_pickup_coordinate_px(face, fx, fy)


def _all_true(ray):
    return torch.ones(ray[0].shape, dtype=torch.bool, device=ray[0].device)


def _window_mask(st: SourceStatic, crd, ray):
    we = st.window_extent
    mask = ((crd[0] >= we.x0) & (crd[0] <= we.x1)
            & (crd[1] >= we.y0) & (crd[1] <= we.y1))
    if st.projection == Projection.RECTILINEAR:
        mask = mask & (ray[2] > 0.0)
    return mask


def get_mask(src: FacetSource, ray):
    """Validity mask: does this ray hit the facet's data window?
    (mount_t::get_mask, environment.h:1156-1167; all-true for cubemaps
    and >=360-degree fisheyes, environment.h:1577,1751)."""
    st = src.static
    _no_paint(st)
    if st.kind == "cubemap" or st.full_fisheye:
        return _all_true(ray)
    return _window_mask(st, _mount_planar(st, ray), ray)


def _md_to_spline(st: SourceStatic, px, py):
    """model-space planar -> spline coordinates
    (source_t::md_to_spline, environment.h:988-1006)."""
    te = st.total_extent
    ix = (px - te.x0) / (te.x1 - te.x0) * st.total_width - 0.5
    iy = (py - te.y0) / (te.y1 - te.y0) * st.total_height - 0.5
    return ix - st.window_x_offset, iy - st.window_y_offset


def source_spline_coords(src: FacetSource, ray):
    """Continuous spline coordinates (core units, ungated) and the
    validity mask for the given rays - the coordinate half of
    lookup(). Cubemap sources give IR pixel coordinates and an
    all-true mask."""
    st = src.static
    _no_paint(st)
    if st.kind == "cubemap":
        cx, cy = _cubemap_pickup(st, ray)
        return cx, cy, _all_true(ray)
    crd = _mount_planar(st, ray)
    mask = _window_mask(st, crd, ray)
    sx, sy = _md_to_spline(st, *crd)
    return sx, sy, mask


def lookup(src: FacetSource, ray, nch_out: int, with_mask: bool = True):
    """Evaluate the facet at the given rays: returns (px, mask) where
    px has shape ray[0].shape + (nch_out,), misses painted to 0
    (associated alpha). This is the reference's environment::eval
    including channel adaptation and brighten."""
    st = src.static
    sx, sy, mask = source_spline_coords(src, ray)
    if st.kind == "cubemap":
        # IR pickups stay inside their section's support frame: no gate
        px = S.eval_spline(src.spl, sx, sy, apply_gate=False)
    else:
        px = S.eval_spline(src.spl, sx, sy)
        if with_mask:
            px = torch.where(mask[..., None], px, 0.0)

    if st.masked != -1:
        # alpha_masking_t (masking.h:93): paint masked * alpha
        alpha = px[..., -1:]
        paint = float(st.masked) * alpha
        px = torch.cat([paint.expand(alpha.shape[:-1]
                                     + (max(nch_out - 1, 1),)), alpha],
                       dim=-1)
        return px[..., :nch_out], mask

    px = repix(px, nch_out)
    if st.brighten != 1.0:
        px = apply_brighten(px, st.brighten)
    return px, mask


def repix(px, nch_out: int):
    """Channel-count adaptation (repix_t, environment.h:1205-1309).
    2- and 4-channel data carry associated alpha in the last channel."""
    nch_in = px.shape[-1]
    if nch_in == nch_out:
        return px
    one = torch.ones_like(px[..., :1])

    def deassoc(c, a):
        return torch.where(a == 0.0, 0.0,
                           c / torch.where(a == 0.0, 1.0, a))

    if nch_in == 1:
        g = px[..., :1]
        if nch_out == 2:
            return torch.cat([g, one], -1)
        if nch_out == 3:
            return torch.cat([g, g, g], -1)
        return torch.cat([g, g, g, one], -1)
    if nch_in == 2:
        g, a = px[..., :1], px[..., 1:2]
        if nch_out == 1:
            return deassoc(g, a)
        if nch_out == 3:
            gg = deassoc(g, a)
            return torch.cat([gg, gg, gg], -1)
        return torch.cat([g, g, g, a], -1)
    if nch_in == 3:
        grey = torch.mean(px, dim=-1, keepdim=True)
        if nch_out == 1:
            return grey
        if nch_out == 2:
            return torch.cat([grey, one], -1)
        return torch.cat([px, one], -1)
    # nch_in == 4
    a = px[..., 3:4]
    if nch_out == 1:
        return deassoc(torch.mean(px[..., :3], dim=-1, keepdim=True), a)
    if nch_out == 2:
        return torch.cat(
            [torch.mean(px[..., :3], dim=-1, keepdim=True), a], -1)
    return deassoc(px[..., :3], a)


def apply_brighten(px, brighten: float):
    """Multiply non-alpha channels (environment.h:1821-1842)."""
    nch = px.shape[-1]
    if nch in (2, 4):
        colour = px[..., :nch - 1] * brighten
        return torch.cat([colour, px[..., nch - 1:]], -1)
    return px * brighten


def apply_brighten_(px, brighten: float):
    """apply_brighten in place; returns ``px``."""
    (px[..., :-1] if px.shape[-1] in (2, 4) else px).mul_(brighten)
    return px


def apply_brighten_planar(px, brighten: float):
    """apply_brighten for channel-planes-first (C, H, W) data."""
    nch = px.shape[0]
    if nch in (2, 4):
        colour = px[:nch - 1] * brighten
        return torch.cat([colour, px[nch - 1:]], 0)
    return px * brighten
