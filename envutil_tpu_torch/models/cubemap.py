"""Construction of the cubemap internal representation (IR).

PyTorch counterpart of envutil_tpu/models/cubemap.py (reference:
cubemap.h:517-1277, metrics.h). The IR is a 1:6 vertical stripe of six
square 'sections', each a cube face image centred in a frame of
support pixels, so that any ray resolves with one spline evaluation
that never crosses a face boundary.

Construction (cubemap_t::load + fill_support, cubemap.h:819-946):

1. place the six face images into the stripe,
2. 'mirror around': 1-px edge replication around each face so the
   support fill never reads black (cubemap.h:607-659),
3. fill the support frames by re-projecting from the adjoining faces:
   frame pixel -> ray -> cube face -> bilinear pickup (cubemap.h:687-911),
4. prefilter each section separately with NATURAL boundaries
   (cubemap.h:921-946), batched over the six sections,
5. brace the whole stripe (REFLECT) for evaluation.

The JAX package's per-face section views (``section_splines``) exist
for the TPU fast path's forced-face passes; on the card the kernels
gather any IR address, so the port has no such views.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import geometry as geo
from ..core.facet import Facet
from ..core.metrics import CubemapMetrics, get_extent
from ..ops import spline as S
from ..runtime.platform import resolve_device
from .environment import FacetSource, SourceStatic


def _mirror_around(ir: torch.Tensor, m: CubemapMetrics) -> torch.Tensor:
    """1-px edge replication around each cube face inside its section
    (cubemap.h:607-659). ir is (6S, S, C)."""
    if m.left_frame_px == 0 and m.right_frame_px == 0:
        return ir
    s, f, lf = m.section_px, m.face_px, m.left_frame_px
    sec = ir.reshape(6, s, s, -1).clone()
    face = sec[:, lf:lf + f, lf:lf + f]
    lo, hi = (1 if m.left_frame_px else 0), (1 if m.right_frame_px else 0)
    framed = S.extend_axis(face, 1, lo, hi, S.CONSTANT)
    framed = S.extend_axis(framed, 2, lo, hi, S.CONSTANT)
    sec[:, lf - lo:lf + f + hi, lf - lo:lf + f + hi] = framed
    return sec.reshape(6 * s, s, -1)


def fill_support(ir: torch.Tensor, m: CubemapMetrics) -> torch.Tensor:
    """Populate the support frames by re-projecting content from the
    adjoining cube faces (cubemap.h:819-911), one section at a time;
    face-interior pixels keep their original values."""
    if m.left_frame_px == 0 and m.right_frame_px == 0:
        return ir
    ir = _mirror_around(ir, m)
    s, f, lf = m.section_px, m.face_px, m.left_frame_px

    # bilinear evaluator over the stripe with its 1-px mirrored frames
    ev = _ir_spline(ir, 1)

    # in-section pixel centres in model units relative to the section
    # centre (the reference's doubled-int linspace divided out)
    i = np.arange(s, dtype=np.float64)
    mm = torch.from_numpy(((i - (s - 1) / 2.0) * m.px_to_model)
                          .astype(np.float32)).to(ir.device)
    mx = mm[None, :].expand(s, s)
    my = mm[:, None].expand(s, s)

    inface = (torch.arange(s, device=ir.device) >= lf) \
        & (torch.arange(s, device=ir.device) < lf + f)
    keep = (inface[:, None] & inface[None, :])[..., None]
    sections = []
    for face in range(6):
        ray = geo.in_face_to_ray(
            torch.full((s, s), face, dtype=torch.int32, device=ir.device),
            mx, my)
        fv, fx, fy = geo.ray_to_cubeface(*ray)
        cx, cy = m.get_pickup_coordinate_px(fv, fx, fy)
        filled = S.eval_spline(ev, cx, cy, apply_gate=False)
        sections.append(torch.where(keep, ir[face * s:(face + 1) * s],
                                    filled))
    return torch.cat(sections, dim=0)


def _ir_spline(coeffs, degree):
    """The IR's braced spline (REFLECT on both axes)."""
    return S.make_spline_from_coeffs(coeffs, degree, (S.REFLECT, S.REFLECT))


def build_ir_spline(faces: torch.Tensor, m: CubemapMetrics,
                    spline_degree: int, prefilter_degree: int
                    ) -> S.Spline2D:
    """faces: (6, F, F, C) float32 in LEFT, RIGHT, TOP, BOTTOM, FRONT,
    BACK order -> braced spline over the (6S, S, C) IR stripe, on the
    faces' device."""
    six, f, _, c = faces.shape
    if six != 6 or f != m.face_px:
        raise ValueError(f"faces {tuple(faces.shape)} do not fit "
                         f"{m.face_px}-px cube faces")
    s, lf = m.section_px, m.left_frame_px
    ir = faces.new_zeros((6, s, s, c))
    ir[:, lf:lf + f, lf:lf + f] = faces
    ir = fill_support(ir.reshape(6 * s, s, c), m)
    if prefilter_degree > 1:
        sec = ir.reshape(6, s, s, c)
        sec = S.prefilter_axis(sec, 1, prefilter_degree, S.NATURAL)
        sec = S.prefilter_axis(sec, 2, prefilter_degree, S.NATURAL)
        ir = sec.reshape(6 * s, s, c)
    return _ir_spline(ir, spline_degree)


def cubemap_static(fct: Facet, nch: int, m: CubemapMetrics) -> SourceStatic:
    """The lookup configuration of a cubemap/biatan6 facet whose width
    is the face width."""
    extent = get_extent(fct.projection, fct.width, 6 * fct.width, fct.hfov)
    return SourceStatic(
        kind="cubemap", projection=fct.projection,
        total_extent=extent, window_extent=extent,
        total_width=fct.width, total_height=6 * fct.width,
        window_x_offset=0, window_y_offset=0,
        nch_native=nch, recip_step=1.0 / fct.step,
        brighten=fct.brighten, masked=fct.masked, metrics=m)


def make_cubemap_source(fct: Facet, faces: np.ndarray, spline_degree: int,
                        prefilter_degree: int, support_min: int,
                        tile_size: int, device=None) -> FacetSource:
    """Build a FacetSource for a cubemap/biatan6 facet from its six
    face images (the _environment cubemap path, environment.h:1559-1677),
    on ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    m = CubemapMetrics.create(fct.width, fct.hfov, support_min, tile_size)
    data = torch.from_numpy(np.require(faces, np.float32, ["C", "W"]))
    spl = build_ir_spline(data.to(device), m, spline_degree,
                          prefilter_degree)
    return FacetSource(static=cubemap_static(fct, faces.shape[-1], m),
                       spl=spl)
