"""Core conventions: axes, projections, cube-face order.

The framework follows the reference's coordinate conventions so that
results are bit-comparable:

* 3D axes use lux "latin book order": x is RIGHT, y is DOWN, z is FORWARD
  (reference: envutil_basic.h:76).
* Cube faces are stored in openEXR order LEFT, RIGHT, TOP, BOTTOM, FRONT,
  BACK, with top/bottom oriented to align with the BACK face
  (reference: envutil_basic.h:56-64).
* Projections (reference: envutil_basic.h:99-121).

All angles are radians throughout the compute path; degrees only appear
at the CLI boundary.
"""

from __future__ import annotations

import enum

# 3D axis indices (envutil_basic.h:76)
RIGHT = 0
DOWN = 1
FORWARD = 2


class Projection(enum.IntEnum):
    """Projection codes, same order/values as the reference enum
    (envutil_basic.h:99-109)."""

    SPHERICAL = 0
    CYLINDRICAL = 1
    RECTILINEAR = 2
    STEREOGRAPHIC = 3
    FISHEYE = 4
    CUBEMAP = 5
    BIATAN6 = 6
    NONE = 7


PROJECTION_NAMES = {
    Projection.SPHERICAL: "spherical",
    Projection.CYLINDRICAL: "cylindrical",
    Projection.RECTILINEAR: "rectilinear",
    Projection.STEREOGRAPHIC: "stereographic",
    Projection.FISHEYE: "fisheye",
    Projection.CUBEMAP: "cubemap",
    Projection.BIATAN6: "biatan6",
    Projection.NONE: "unsupported",
}

PROJECTION_BY_NAME = {v: k for k, v in PROJECTION_NAMES.items()}


def parse_projection(name: str) -> Projection:
    try:
        return PROJECTION_BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown projection: {name!r}") from None


class Face(enum.IntEnum):
    """Cube face indices in openEXR vertical-stripe order
    (envutil_basic.h:56-64). The numbering is load-bearing: face >> 1
    yields the dominant axis (0=x, 1=y, 2=z) and face & 1 the sign."""

    LEFT = 0
    RIGHT = 1
    TOP = 2
    BOTTOM = 3
    FRONT = 4
    BACK = 5


# names used to expand a "%s" cubeface series (envutil_basic.h:265-356)
FACE_NAMES = ("left", "right", "top", "bottom", "front", "back")
