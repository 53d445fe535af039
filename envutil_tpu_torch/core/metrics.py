"""Image metrics: extent / step / vfov, and cubemap IR metrics.

Host-side float64 helpers mirroring the reference's envutil_basic.cc
(get_vfov:50, get_step:112, get_extent:158) and metrics.h (metrics_t:60).
These run at configuration time; their outputs are baked into jitted
render functions as constants.
"""

from __future__ import annotations

import dataclasses
import math

from .conventions import Projection


@dataclasses.dataclass(frozen=True)
class Extent:
    """Extent of an image 'draped' onto its archetypal 2D manifold, in
    model space units (reference extent_type, envutil_basic.h:157-168)."""

    x0: float
    x1: float
    y0: float
    y1: float

    @property
    def width(self) -> float:
        return self.x1 - self.x0

    @property
    def height(self) -> float:
        return self.y1 - self.y0


def get_vfov(projection: Projection, width: int, height: int,
             hfov: float) -> float:
    """Vertical fov from horizontal fov under isotropic sampling
    (envutil_basic.cc:50-97). Note: the reference's CUBEMAP/BIATAN6 case
    falls through to the default and yields hfov - we reproduce that."""
    projection = Projection(projection)
    if projection == Projection.RECTILINEAR:
        return 2.0 * math.atan(height * math.tan(hfov / 2.0) / width)
    if projection == Projection.CYLINDRICAL:
        pixels_per_rad = width / hfov
        h_rad = height / pixels_per_rad
        return 2.0 * math.atan(h_rad / 2.0)
    if projection == Projection.STEREOGRAPHIC:
        w_rad = 2.0 * math.tan(hfov / 4.0)
        pixels_per_rad = width / w_rad
        h_rad = height / pixels_per_rad
        return 4.0 * math.atan(h_rad / 2.0)
    if projection in (Projection.SPHERICAL, Projection.FISHEYE):
        return hfov * height / width
    # CUBEMAP / BIATAN6 / default (reference case fall-through)
    return hfov


def get_step(projection: Projection, width: int, height: int,
             hfov: float) -> float:
    """Angular width of a central pixel in radians
    (envutil_basic.cc:112-145)."""
    projection = Projection(projection)
    if projection in (Projection.RECTILINEAR, Projection.CUBEMAP):
        return math.atan(2.0 * math.tan(hfov / 2.0) / width)
    if projection in (Projection.BIATAN6, Projection.SPHERICAL,
                      Projection.CYLINDRICAL, Projection.FISHEYE):
        return hfov / width
    if projection == Projection.STEREOGRAPHIC:
        return math.atan(4.0 * math.tan(hfov / 4.0) / width)
    return 0.0


def get_extent(projection: Projection, width: int, height: int,
               hfov: float) -> Extent:
    """Model-space extent of a centered image (envutil_basic.cc:158-226)."""
    projection = Projection(projection)
    alpha_x = -hfov / 2.0
    beta_x = hfov / 2.0
    beta_y = get_vfov(projection, width, height, hfov) / 2.0
    alpha_y = -beta_y

    if projection in (Projection.SPHERICAL, Projection.FISHEYE):
        return Extent(alpha_x, beta_x, alpha_y, beta_y)
    if projection == Projection.CYLINDRICAL:
        return Extent(alpha_x, beta_x, math.tan(alpha_y), math.tan(beta_y))
    if projection == Projection.RECTILINEAR:
        return Extent(math.tan(alpha_x), math.tan(beta_x),
                      math.tan(alpha_y), math.tan(beta_y))
    if projection == Projection.STEREOGRAPHIC:
        return Extent(2.0 * math.tan(alpha_x / 2.0),
                      2.0 * math.tan(beta_x / 2.0),
                      2.0 * math.tan(alpha_y / 2.0),
                      2.0 * math.tan(beta_y / 2.0))
    if projection in (Projection.CUBEMAP, Projection.BIATAN6):
        x0 = math.tan(alpha_x)
        x1 = math.tan(beta_x)
        return Extent(x0, x1, 6.0 * x0, 6.0 * x1)
    return Extent(0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class CubemapMetrics:
    """Geometry of the cubemap internal representation ('IR image'): six
    square sections stacked vertically, each = cube face + support frame.

    Mirrors the reference's metrics_t (metrics.h:60-483). All *_px are
    pixel units, *_md model-space units (IR draped at unit distance, a
    90-degree core has extent 2.0).
    """

    face_px: int
    face_fov: float
    support_min_px: int
    tile_px: int
    # derived:
    n_tiles: int = 0
    section_px: int = 0
    left_frame_px: int = 0
    right_frame_px: int = 0
    inherent_support_px: int = 0
    discrete90: bool = False
    model_to_px: float = 0.0
    px_to_model: float = 0.0
    section_md: float = 0.0
    refc_md: float = 0.0
    ref90_md: float = 0.0
    overscan_md: float = 0.0
    radius_md: float = 1.0

    @staticmethod
    def create(face_px: int, face_fov: float = math.pi / 2,
               support_min_px: int = 4, tile_px: int = 64
               ) -> "CubemapMetrics":
        """Reference: metrics_t::metrics_t, metrics.h:209-376."""
        assert face_fov >= math.pi / 2 - 1e-12, "cube face fov must be >= 90 deg"
        assert tile_px > 0 and (tile_px & (tile_px - 1)) == 0, \
            "tile size must be a power of two"

        overscan_md = 0.0
        radius_md = 1.0
        diameter_md = 2.0
        if face_fov > math.pi / 2:
            radius_md = math.tan(face_fov / 2.0)
            diameter_md = 2.0 * radius_md
            overscan_md = radius_md - 1.0

        model_to_px = float(face_px) / diameter_md
        px_to_model = diameter_md / float(face_px)

        px_overscan = model_to_px * overscan_md
        inherent_support_px = int(math.trunc(px_overscan))
        discrete90 = (px_overscan - math.trunc(px_overscan)) < 1e-7

        additional_support_px = 0
        if inherent_support_px < support_min_px:
            additional_support_px = support_min_px - inherent_support_px

        px_min = face_px + 2 * additional_support_px
        n_tiles = px_min // tile_px
        if n_tiles * tile_px < px_min:
            n_tiles += 1

        section_px = n_tiles * tile_px
        frame_total = section_px - face_px
        left_frame_px = frame_total // 2
        right_frame_px = frame_total - left_frame_px

        section_md = px_to_model * section_px
        refc_px = float(left_frame_px) + float(face_px) / 2.0
        refc_md = px_to_model * refc_px
        ref90_md = refc_md - 1.0

        return CubemapMetrics(
            face_px=face_px, face_fov=face_fov,
            support_min_px=support_min_px, tile_px=tile_px,
            n_tiles=n_tiles, section_px=section_px,
            left_frame_px=left_frame_px, right_frame_px=right_frame_px,
            inherent_support_px=inherent_support_px, discrete90=discrete90,
            model_to_px=model_to_px, px_to_model=px_to_model,
            section_md=section_md, refc_md=refc_md, ref90_md=ref90_md,
            overscan_md=overscan_md, radius_md=radius_md,
        )

    def get_pickup_coordinate_px(self, face, fx, fy):
        """in-face coordinate + face index -> pixel-unit coordinate into
        the IR image (continuous; (0,0) is the center of the upper-left
        pixel). Reference: metrics.h:396-440."""
        px = (fx + self.refc_md) * self.model_to_px - 0.5
        py = (fy + self.refc_md) * self.model_to_px \
            + face * self.section_px - 0.5
        return px, py
