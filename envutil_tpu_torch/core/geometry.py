"""Projection math: 2D planar coordinates <-> 3D rays, cube-face logic.

PyTorch counterpart of envutil_tpu/core/geometry.py, itself the
equivalent of the reference's geometry.h (ll_to_ray_t geometry.h:152,
ray_to_ll_t:277, rect:328/363, cyl:389/417, ster:445/481, fish:513/539,
ir_to_ray_t:663, ba6_to_ray_t:860, ray_to_cubeface:1178,
ray_to_cubeface_fixed:1376, ray_to_ir_t:1460, ray_to_ba6_t:1532).

Every function works on tensors in structure-of-arrays form: a planar
coordinate is a pair ``(px, py)``, a ray a triple ``(x, y, z)``, each
component a tensor of any shape, on any device and of any floating
dtype (float32 on the render path, float64 in the property tests).
Face selection is a branchless ``torch.where`` cascade.

Axis convention: x=RIGHT, y=DOWN, z=FORWARD (see conventions.py).
"""

from __future__ import annotations

import math
from functools import partial

import torch

from .conventions import Face, Projection

Ray = tuple  # (x, y, z) tensors
Planar = tuple  # (px, py) tensors


# ---------------------------------------------------------------------------
# spherical (lat/lon)
# ---------------------------------------------------------------------------

def ll_to_ray(lon, lat) -> Ray:
    """lon/lat (radians) -> unit ray. Reference: geometry.h:152-261.

    lon 0 / lat 0 is straight ahead (0,0,1); lon grows to the right,
    lat grows downwards."""
    sinlat = torch.sin(lat)
    coslat = torch.cos(lat)
    return (torch.sin(lon) * coslat, sinlat, torch.cos(lon) * coslat)


def ray_to_ll(x, y, z) -> Planar:
    """ray -> lon/lat; accepts unnormalized rays. Reference: geometry.h:277-301."""
    s = torch.sqrt(x * x + z * z)
    return (torch.atan2(x, z), torch.atan2(y, s))


# ---------------------------------------------------------------------------
# rectilinear
# ---------------------------------------------------------------------------

def rect_to_ray(px, py) -> Ray:
    """planar (on plane at unit forward distance) -> ray (not normalized).
    Reference: geometry.h:362-386."""
    return (px, py, torch.ones_like(px))


def ray_to_rect(x, y, z) -> Planar:
    """ray -> planar by division by z. z==0 yields inf, back-hemisphere
    rays produce output (mirroring reference behavior, geometry.h:327-356)."""
    return (x / z, y / z)


# ---------------------------------------------------------------------------
# cylindrical
# ---------------------------------------------------------------------------

def cyl_to_ray(px, py) -> Ray:
    """planar (x = azimuth in radians, y = height on unit cylinder) -> ray
    (not normalized). Reference: geometry.h:416-442."""
    return (torch.sin(px), py, torch.cos(px))


def ray_to_cyl(x, y, z) -> Planar:
    """Reference: geometry.h:388-412."""
    s = torch.sqrt(x * x + z * z)
    return (torch.atan2(x, z), y / s)


# ---------------------------------------------------------------------------
# stereographic
# ---------------------------------------------------------------------------

def ster_to_ray(px, py) -> Ray:
    """Reference: geometry.h:480-510."""
    r = torch.sqrt(px * px + py * py)
    theta = 2.0 * torch.atan(r * 0.5)
    phi = torch.atan2(px, -py)
    sin_t = torch.sin(theta)
    return (sin_t * torch.sin(phi), -sin_t * torch.cos(phi), torch.cos(theta))


def ray_to_ster(x, y, z) -> Planar:
    """Reference: geometry.h:444-476. Normalizes, then projects from the
    point opposite the view center; z == -1 produces huge values."""
    rn = 1.0 / torch.sqrt(x * x + y * y + z * z)
    factor = 2.0 / (z * rn + 1.0)
    return (x * rn * factor, y * rn * factor)


# ---------------------------------------------------------------------------
# fisheye
# ---------------------------------------------------------------------------

def fish_to_ray(px, py) -> Ray:
    """Reference: geometry.h:538-567."""
    r = torch.sqrt(px * px + py * py)
    phi = torch.atan2(px, -py)
    sin_r = torch.sin(r)
    return (sin_r * torch.sin(phi), -sin_r * torch.cos(phi), torch.cos(r))


def ray_to_fish(x, y, z) -> Planar:
    """Reference: geometry.h:512-534."""
    s = torch.sqrt(x * x + y * y)
    r = (0.5 * math.pi) - torch.atan2(z, s)
    phi = torch.atan2(y, x)
    return (r * torch.cos(phi), r * torch.sin(phi))


# ---------------------------------------------------------------------------
# cube faces
# ---------------------------------------------------------------------------

def _safe(d):
    # guard the inactive divisions of a where() cascade against 0/0
    return torch.where(d == 0, torch.ones_like(d), d)


def _select(mask, a: int, b: int, like):
    return torch.where(mask, torch.full_like(like, a), torch.full_like(like, b))


def ray_to_cubeface(x, y, z):
    """Dominant-axis cube face selection + in-face coordinates.

    Returns (face, fx, fy) with face an int32 tensor in [0,5] (Face enum)
    and in-face coordinates in (-1,1) on the plane draped at unit
    distance. Branchless version of the reference's masked-SIMD cascade
    (geometry.h:1178-1289)."""
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    m1 = ax >= ay
    m2 = ax >= az
    m3 = ay >= az

    dom_x = m1 & m2
    dom_z = (~m2) & (~m3)
    # remaining lanes have dominant y: dom_y = (~m1) & m3

    iz = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    face = torch.where(
        dom_x,
        _select(x < 0, int(Face.LEFT), int(Face.RIGHT), iz),
        torch.where(
            dom_z,
            _select(z < 0, int(Face.BACK), int(Face.FRONT), iz),
            _select(y < 0, int(Face.TOP), int(Face.BOTTOM), iz),
        ),
    )
    fx = torch.where(
        dom_x,
        -z / _safe(x),
        torch.where(dom_z, x / _safe(z), -x / _safe(ay)),
    )
    fy = torch.where(
        dom_x,
        y / _safe(ax),
        torch.where(dom_z, y / _safe(az), z / _safe(y)),
    )
    return face, fx, fy


def ray_to_cubeface_fixed(x, y, z, face):
    """In-plane coordinates for a *given* face (used to keep derivative
    rays on the same face during twining). Reference: geometry.h:1376-1444."""
    dom = face >> 1
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    fx = torch.where(
        dom == 0,
        -z / _safe(x),
        torch.where(dom == 1, -x / _safe(ay), x / _safe(z)),
    )
    fy = torch.where(
        dom == 0,
        y / _safe(ax),
        torch.where(dom == 1, z / _safe(y), y / _safe(az)),
    )
    return fx, fy


def in_face_to_ray(face, fx, fy):
    """Per-face in-face planar -> ray, all faces branchless.

    Mirrors the case switch in ir_to_ray_t (geometry.h:722-772 and
    in_face_to_ray geometry.h:577-637, openEXR top/bottom orientation)."""
    one = torch.ones_like(fx)
    dom = face >> 1

    is_right = face == int(Face.RIGHT)
    is_bottom = face == int(Face.BOTTOM)
    is_front = face == int(Face.FRONT)

    x_dx = torch.where(is_right, one, -one)
    y_dx = fy
    z_dx = torch.where(is_right, -fx, fx)

    x_dy = -fx
    y_dy = torch.where(is_bottom, one, -one)
    z_dy = torch.where(is_bottom, fy, -fy)

    x_dz = torch.where(is_front, fx, -fx)
    y_dz = fy
    z_dz = torch.where(is_front, one, -one)

    x = torch.where(dom == 0, x_dx, torch.where(dom == 1, x_dy, x_dz))
    y = torch.where(dom == 0, y_dx, torch.where(dom == 1, y_dy, y_dz))
    z = torch.where(dom == 0, z_dx, torch.where(dom == 1, z_dy, z_dz))
    return (x, y, z)


# ---------------------------------------------------------------------------
# cubemap IR image (1:6 stripe) <-> ray
# ---------------------------------------------------------------------------

def ir_to_ray(px, py, section_md=2.0, refc_md=1.0, centered=True) -> Ray:
    """2D IR-image model-space coordinate -> ray.

    ``section_md`` is the width of one section in model-space units,
    ``refc_md`` the distance from a section's left/top edge to the cube
    face center. Reference: ir_to_ray_t, geometry.h:663-852."""
    if centered:
        px = px + refc_md
        py = py + 3.0 * section_md
    # truncation toward zero matches the C++ int() conversion
    section = torch.trunc(py / section_md).to(torch.int32)
    fy = py - section.to(py.dtype) * section_md - refc_md
    fx = px - refc_md
    return in_face_to_ray(section, fx, fy)


def ba6_to_ray(px, py, section_md=2.0, refc_md=1.0, centered=True) -> Ray:
    """Like ir_to_ray with the biatan6 in-plane transform
    tan(c * pi/4) applied to the in-face coordinate.
    Reference: ba6_to_ray_t, geometry.h:860-1056."""
    if centered:
        px = px + refc_md
        py = py + 3.0 * section_md
    section = torch.trunc(py / section_md).to(torch.int32)
    fy = py - section.to(py.dtype) * section_md - refc_md
    fx = px - refc_md
    fx = torch.tan(fx * (math.pi / 4.0))
    fy = torch.tan(fy * (math.pi / 4.0))
    return in_face_to_ray(section, fx, fy)


def ray_to_ir(x, y, z, section_md=2.0, refc_md=1.0, centered=True) -> Planar:
    """ray -> 2D IR model-space coordinate. Reference: ray_to_ir_t,
    geometry.h:1460-1528."""
    face, fx, fy = ray_to_cubeface(x, y, z)
    px = fx + refc_md
    py = fy + refc_md + face.to(fx.dtype) * section_md
    if centered:
        px = px - refc_md
        py = py - 3.0 * section_md
    return (px, py)


def ray_to_ba6(x, y, z, section_md=2.0, refc_md=1.0, centered=True) -> Planar:
    """Reference: ray_to_ba6_t, geometry.h:1532-1608."""
    face, fx, fy = ray_to_cubeface(x, y, z)
    fx = (4.0 / math.pi) * torch.atan(fx)
    fy = (4.0 / math.pi) * torch.atan(fy)
    px = fx + refc_md
    py = fy + refc_md + face.to(fx.dtype) * section_md
    if centered:
        px = px - refc_md
        py = py - 3.0 * section_md
    return (px, py)


# ---------------------------------------------------------------------------
# runtime dispatch (roll_out_23 / roll_out_32, geometry.h:1764-1834)
# ---------------------------------------------------------------------------

def to_ray(projection: Projection, section_md=2.0, refc_md=1.0):
    """Return the planar->ray function for ``projection``."""
    projection = Projection(projection)
    if projection == Projection.SPHERICAL:
        return ll_to_ray
    if projection == Projection.CYLINDRICAL:
        return cyl_to_ray
    if projection == Projection.RECTILINEAR:
        return rect_to_ray
    if projection == Projection.STEREOGRAPHIC:
        return ster_to_ray
    if projection == Projection.FISHEYE:
        return fish_to_ray
    if projection == Projection.CUBEMAP:
        return partial(ir_to_ray, section_md=section_md, refc_md=refc_md)
    if projection == Projection.BIATAN6:
        return partial(ba6_to_ray, section_md=section_md, refc_md=refc_md)
    raise ValueError(f"unhandled projection {projection}")


def to_plane(projection: Projection, section_md=2.0, refc_md=1.0):
    """Return the ray->planar function for ``projection``."""
    projection = Projection(projection)
    if projection == Projection.SPHERICAL:
        return ray_to_ll
    if projection == Projection.CYLINDRICAL:
        return ray_to_cyl
    if projection == Projection.RECTILINEAR:
        return ray_to_rect
    if projection == Projection.STEREOGRAPHIC:
        return ray_to_ster
    if projection == Projection.FISHEYE:
        return ray_to_fish
    if projection == Projection.CUBEMAP:
        return partial(ray_to_ir, section_md=section_md, refc_md=refc_md)
    if projection == Projection.BIATAN6:
        return partial(ray_to_ba6, section_md=section_md, refc_md=refc_md)
    raise ValueError(f"unhandled projection {projection}")


# ---------------------------------------------------------------------------
# small vector helpers
# ---------------------------------------------------------------------------

def normalize(x, y, z) -> Ray:
    n = torch.sqrt(x * x + y * y + z * z)
    return (x / n, y / n, z / n)


def apply_matrix(m, x, y, z) -> Ray:
    """Apply a host-side 3x3 matrix (numpy array or nested list) to a
    SoA ray: out = m @ [x, y, z]. The entries enter as Python floats,
    so the ray keeps its dtype."""
    m = [[float(v) for v in row] for row in m]
    return (
        m[0][0] * x + m[0][1] * y + m[0][2] * z,
        m[1][0] * x + m[1][1] * y + m[1][2] * z,
        m[2][0] * x + m[2][1] * y + m[2][2] * z,
    )
