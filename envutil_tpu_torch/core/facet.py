"""Facet specification: geometry + PTO attributes of one oriented
source image (or of the render target - the target inherits the same
base geometry, like the reference's `arguments : facet_base`).

Mirrors facet_base / facet_spec (envutil_basic.h:432-631) including
process_geometry's derived values (unit radius s, r_max, normalized
shift, cap_radius) and the has_* flags that gate optional pipeline
stages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from .conventions import Projection
from .metrics import Extent, get_extent, get_step


@dataclasses.dataclass
class PtoMask:
    """A polygonal PTO mask (k-line). variant 0 = exclude region."""
    image: int
    variant: int
    vx: List[float] = dataclasses.field(default_factory=list)
    vy: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Facet:
    # base geometry (facet_base, envutil_basic.h:432-458)
    projection: Projection = Projection.RECTILINEAR
    hfov: float = math.pi / 2          # radians
    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0
    width: int = 0
    height: int = 0
    window_width: int = 0
    window_height: int = 0
    window_x_offset: int = 0
    window_y_offset: int = 0
    extent: Extent = dataclasses.field(
        default_factory=lambda: Extent(0, 0, 0, 0))
    step: float = 0.0

    # PTO translation / reprojection plane
    tr_x: float = 0.0
    tr_y: float = 0.0
    tr_z: float = 0.0
    tp_y: float = 0.0
    tp_p: float = 0.0
    tp_r: float = 0.0

    # PTO planar transform parameters
    shear_g: float = 0.0
    shear_t: float = 0.0
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    h: float = 0.0   # shift, model units after process_geometry
    v: float = 0.0
    s: float = 1.0   # PTO unit radius in model units
    r_max: float = 1.0
    cap_radius: float = 0.0

    has_shift: bool = False
    has_lcp: bool = False
    has_shear: bool = False
    has_2d_tf: bool = False
    has_translation: bool = False

    # facet_spec additions (envutil_basic.h:460-631)
    facet_no: int = 0
    nchannels: int = 3
    filename: str = ""
    asset_key: str = ""
    colour_space: str = ""
    has_lens_crop: bool = False
    crop_x0: int = 0
    crop_x1: int = 0
    crop_y0: int = 0
    crop_y1: int = 0
    has_pto_mask: bool = False
    pto_masks: List[PtoMask] = dataclasses.field(default_factory=list)
    masked: int = -1     # -1 normal; 0/1 = paint black/white (--mask_for)
    brighten: float = 1.0
    # --twine_pyramid: number of 2x box-decimation levels applied to
    # this facet's pixel data at load (Args.twine_setup chooses the
    # level so the residual minification lands in [0.5, 1); the
    # geometry fields above are already the decimated ones)
    pyramid_level: int = 0

    @property
    def x0(self): return self.extent.x0

    @property
    def x1(self): return self.extent.x1

    @property
    def y0(self): return self.extent.y0

    @property
    def y1(self): return self.extent.y1

    def set_geometry(self, projection: Projection, width: int, height: int,
                     hfov: float) -> None:
        """Fill extent/step from projection + size + hfov."""
        self.projection = projection
        self.width = width
        self.height = height
        self.hfov = hfov
        self.extent = get_extent(projection, width, height, hfov)
        self.step = get_step(projection, width, height, hfov)
        if self.window_width == 0:
            self.window_width = width
            self.window_height = height

    def process_geometry(self) -> None:
        """Derive flags and normalized parameters from the raw PTO
        values (envutil_basic.h:499-543). PTO d/e (-> h/v) arrive in
        pixels and are converted to model units; g/t arrive already
        divided by height/width (done by the PTO parser)."""
        self.has_shift = self.h != 0.0 or self.v != 0.0
        self.has_lcp = self.a != 0.0 or self.b != 0.0 or self.c != 0.0
        self.has_shear = self.shear_g != 0.0 or self.shear_t != 0.0
        self.has_2d_tf = self.has_shift or self.has_lcp or self.has_shear
        self.has_translation = (self.tr_x != 0.0 or self.tr_y != 0.0
                                or self.tr_z != 0.0)

        dv = abs(self.extent.y1 - self.extent.y0) / 2.0
        dh = abs(self.extent.x1 - self.extent.x0) / 2.0
        self.s = dh if dh < dv else dv
        aspect = dh / dv if dh >= dv else dv / dh
        self.r_max = math.sqrt(1.0 + aspect * aspect)

        factor = abs(self.extent.x1 - self.extent.x0) / self.width
        self.h *= factor
        self.v *= factor

        # largest distance from center to a corner (in model units);
        # reproduces the reference's formula verbatim including its
        # mixing of squared x and linear y terms (envutil_basic.h:533-542)
        x0, x1 = self.extent.x0, self.extent.x1
        y0, y1 = self.extent.y0, self.extent.y1
        d1 = max(x0 * x0 + y0 + y0, x1 * x1 + y0 + y0,
                 x0 * x0 + y1 + y1, x1 * x1 + y1 + y1)
        self.cap_radius = math.sqrt(max(d1, 0.0))
