"""B-spline resampling on the card: the two CUDA kernels, their
wrappers and their plain PyTorch versions.

``resample_inline`` is the counterpart of
envutil_tpu/ops/pallas_resample.py:resample_inline_into. Per output
pixel the coordinate chain (target axis features -> ray -> per-face
3x3 matrix -> source pickup -> spline coordinates) and the degree-n
b-spline evaluation run in one pass, so no coordinate plane ever goes
through device memory.

``resample_planar`` is the counterpart of resample_planar_into (with
a merge mask) and resample_planar (without one, over the whole frame):
the spline at precomputed padded coordinates (sx, sy).

Each wrapper launches its hand-written kernel (csrc/resample_inline.cu,
csrc/resample_planar.cu, built with nvcc at first use by ops/kernels.py)
for CUDA tensors, raises if it cannot, and takes its plain version
only for CPU tensors; ``<wrapper>.launches`` counts kernel launches.
The kernel source notes say what bounds each and what its design
leaves for later.

Operands of ``resample_inline`` (all float32, contiguous):

- ``out``: (H, W, C) output window, rewritten in place and returned.
- ``coeff``: (Hp, Wp, C) braced spline coefficients.
- ``xfeat``: (Fx, W) per-column features (affine: planar x; sph/cyl:
  sin and cos of the azimuth).
- ``yfeat``: (Fy, H) per-row features (affine: planar y shifted into
  the row's cube face; sph: sin and cos of the elevation; cyl: planar
  y).
- ``bmats``: (nf, 9) row-major ray matrices; for nf == 6 the face of
  absolute row r is ``r // face_rows`` and ``row0`` is the window's
  first absolute row.
- ``consts``: (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy,
  pad), the model->spline affine and the gates, as the JAX kernel
  takes them; for the cubemap/biatan6 source modes a twelfth entry,
  the IR rows per cube face (``section_px``), and gates "none".
- ``smode``: the source side, "sph" (full-spherical mount: lon/lat,
  gates) or "cubemap"/"biatan6" (IR pickup: dominant-axis face,
  in-face coordinates, biatan6 atan, section offset).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core import geometry as geo
from . import basis as _basis
from . import kernels as K
from . import spline as S

_TMODES = {"affine": 0, "sph": 1, "cyl": 2}
_SMODES = {"sph": 0, "cubemap": 1, "biatan6": 2}
_GATES = {"periodic": 0, "mirror": 1, "clamp": 2, "none": 3}
MAX_DEGREE = 7

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_INLINE = K.Library(
    "resample_inline.cu", "envutil_resample_inline",
    [_p] * 6 + [_ll] * 4 + [_i] * 7 + [_f, _f, _i] + [_f] * 8 + [_p])
_PLANAR = K.Library(
    "resample_planar.cu", "envutil_resample_planar",
    [_p] * 6 + [_ll] * 4 + [_i, _i, _p])
LIBRARIES = (_INLINE, _PLANAR)


def build():
    """Build (if needed, one nvcc per source in parallel) and load both
    kernel libraries; returns the wall seconds this took."""
    return K.build_all(LIBRARIES)


def _wmat(degree):
    return ctypes.cast((ctypes.c_float * ((degree + 1) ** 2))(
        *_basis.weight_matrix(degree).reshape(-1).tolist()), ctypes.c_void_p)


def _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode):
    if smode not in _SMODES:
        raise ValueError(f"unknown smode {smode!r}")
    if coeff.dtype != torch.float32:
        raise NotImplementedError(
            f"{coeff.dtype} coefficient tables wait for a later slice; "
            "the kernel takes float32")
    if tmode not in _TMODES:
        raise ValueError(f"unknown tmode {tmode!r}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside 0..{MAX_DEGREE}")
    if len(consts) != (11 if smode == "sph" else 12):
        raise ValueError("consts must be (kx, cx, ky, cy, gate_x, glx, "
                         "gux, gate_y, gly, guy, pad), plus section_px "
                         "for the cubemap/biatan6 source modes")
    h, w, nch = out.shape
    if coeff.dim() != 3 or coeff.shape[2] != nch:
        raise ValueError(f"coeff {tuple(coeff.shape)} does not match "
                         f"out {tuple(out.shape)}")
    if not 1 <= nch <= 4:
        raise ValueError(f"{nch} channels; the kernel takes 1..4")
    nfx, nfy = (1, 1) if tmode == "affine" else \
        ((2, 2) if tmode == "sph" else (2, 1))
    if tuple(xfeat.shape) != (nfx, w) or tuple(yfeat.shape) != (nfy, h):
        raise ValueError(
            f"features {tuple(xfeat.shape)}/{tuple(yfeat.shape)} do not "
            f"fit tmode {tmode!r} and out {tuple(out.shape)}")
    nf = bmats.shape[0]
    if bmats.shape != (nf, 9) or (nf == 6) != (face_rows > 0) \
            or nf not in (1, 6):
        raise ValueError("bmats must be (1, 9), or (6, 9) with "
                         "face_rows > 0")
    for t in (out, coeff, xfeat, yfeat, bmats):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != out.device:
            raise ValueError("operands must be contiguous float32 "
                             "tensors on one device")


def resample_inline(out, coeff, xfeat, yfeat, bmats, *, degree: int,
                    tmode: str, consts: tuple, row0: int = 0,
                    face_rows: int = 0, smode: str = "sph"):
    """Fill ``out`` with the b-spline resampled window (see the module
    docstring for the operands). CUDA tensors go through the kernel;
    CPU tensors through ``resample_inline_plain``."""
    _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode)
    if out.device.type == "cpu":
        return resample_inline_plain(out, coeff, xfeat, yfeat, bmats,
                                     degree=degree, tmode=tmode,
                                     consts=consts, row0=row0,
                                     face_rows=face_rows, smode=smode)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    fn = _INLINE.get()
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts[:11]
    section_px = consts[11] if smode != "sph" else 0.0
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = fn(
        out.data_ptr(), coeff.data_ptr(), xfeat.data_ptr(),
        yfeat.data_ptr(), bmats.data_ptr(), _wmat(degree), h, w, hp, wp,
        int(row0), int(face_rows), int(degree), int(nch), _TMODES[tmode],
        _SMODES[smode], _GATES[gate_x], glx, gux, _GATES[gate_y], gly, guy,
        kx, cx, ky, cy, pad, section_px, stream)
    if err != 0:
        raise RuntimeError(f"resample_inline kernel launch failed: CUDA "
                           f"error {err}")
    resample_inline.launches += 1
    return out


resample_inline.launches = 0


def inline_rays(xfeat, yfeat, bmats, *, tmode: str, row0: int = 0,
                face_rows: int = 0):
    """Unnormalized rays (rx, ry, rz), each (H, W), from the axis
    features and the per-face matrices - the kernel's target half."""
    h, w = yfeat.shape[1], xfeat.shape[1]
    if face_rows > 0:
        rows = torch.arange(row0, row0 + h, device=yfeat.device)
        face = torch.div(rows, face_rows, rounding_mode="floor")
        bm = bmats[face.clamp(0, 5)]
    else:
        bm = bmats[:1].expand(h, 9)
    m = [bm[:, k:k + 1] for k in range(9)]
    if tmode == "affine":
        a, b, c = xfeat[0][None, :], yfeat[0][:, None], None
    elif tmode == "sph":
        ct = yfeat[1][:, None]
        a, b, c = xfeat[0][None, :] * ct, yfeat[0][:, None], \
            xfeat[1][None, :] * ct
    else:
        a, b, c = xfeat[0][None, :], yfeat[0][:, None], xfeat[1][None, :]

    def row(k):
        r = m[3 * k] * a + m[3 * k + 1] * b
        r = r + m[3 * k + 2] if c is None else r + m[3 * k + 2] * c
        return r.expand(h, w)
    return row(0), row(1), row(2)


def inline_coords(xfeat, yfeat, bmats, *, tmode: str, consts: tuple,
                  row0: int = 0, face_rows: int = 0, smode: str = "sph"):
    """Padded spline coordinates (sx, sy) of every pixel of the window,
    as the kernel computes them."""
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts[:11]
    rx, ry, rz = inline_rays(xfeat, yfeat, bmats, tmode=tmode, row0=row0,
                             face_rows=face_rows)
    if smode == "sph":
        lon = torch.atan2(rx, rz)
        lat = torch.atan2(ry, torch.sqrt(rx * rx + rz * rz))
        sx = _gate(lon * kx + cx, gate_x, glx, gux) + pad
        sy = _gate(lat * ky + cy, gate_y, gly, guy) + pad
        return sx, sy
    face, fx, fy = geo.ray_to_cubeface(rx, ry, rz)
    if smode == "biatan6":
        fx = (4.0 / math.pi) * torch.atan(fx)
        fy = (4.0 / math.pi) * torch.atan(fy)
    sx = fx * kx + cx + pad
    sy = fy * ky + cy + face.to(fy.dtype) * consts[11] + pad
    return sx, sy


def _gate(v, mode: str, lower: float, upper: float):
    """The kernel's gate (ops/spline.gate with explicit bounds)."""
    if mode == "periodic":
        return lower + torch.remainder(v - lower, upper - lower)
    if mode == "mirror":
        period = 2.0 * (upper - lower)
        t = torch.remainder(v - lower, period)
        return lower + torch.minimum(t, period - t)
    return torch.clamp(v, lower, upper)


def resample_inline_plain(out, coeff, xfeat, yfeat, bmats, *, degree: int,
                          tmode: str, consts: tuple, row0: int = 0,
                          face_rows: int = 0, smode: str = "sph"):
    """The kernel's computation in plain PyTorch, with its signature:
    features -> ray -> ``torch.atan2`` -> gate -> ``eval_spline``
    (ungated) on the padded table. Runs on any device."""
    _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode)
    sx, sy = inline_coords(xfeat, yfeat, bmats, tmode=tmode,
                           consts=consts, row0=row0, face_rows=face_rows,
                           smode=smode)
    table = S.Spline2D(coeff=coeff, pad=0, degree=degree,
                       bcs=(S.CONSTANT, S.CONSTANT),
                       core_shape=tuple(coeff.shape[:2]))
    out.copy_(S.eval_spline(table, sx, sy, apply_gate=False))
    return out


def _check_planar(out, coeff, sx, sy, degree, merge_mask):
    if coeff.dtype != torch.float32:
        raise NotImplementedError(
            f"{coeff.dtype} coefficient tables wait for a later slice; "
            "the kernel takes float32")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside 0..{MAX_DEGREE}")
    if out.dim() != 3 or coeff.dim() != 3 or coeff.shape[2] != out.shape[2]:
        raise ValueError(f"coeff {tuple(coeff.shape)} does not match "
                         f"out {tuple(out.shape)}")
    if not 1 <= out.shape[2] <= 4:
        raise ValueError(f"{out.shape[2]} channels; the kernel takes 1..4")
    planes = (sx, sy) if merge_mask is None else (sx, sy, merge_mask)
    if any(tuple(t.shape) != tuple(out.shape[:2]) for t in planes):
        raise ValueError("sx, sy and merge_mask must be (H, W) like out")
    for t in (out, coeff) + planes:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != out.device:
            raise ValueError("operands must be contiguous float32 "
                             "tensors on one device")


def resample_planar(out, coeff, sx, sy, *, degree: int, merge_mask=None):
    """Evaluate the degree-``degree`` spline of the braced (Hp, Wp, C)
    table ``coeff`` at padded table coordinates ``sx``, ``sy`` (H, W)
    into ``out`` (H, W, C), in place, and return ``out``. With
    ``merge_mask`` (H, W), pixels whose mask is <= 0.5 keep the prior
    contents of ``out`` bit for bit; without it every pixel is written.
    CUDA tensors go through the kernel; CPU tensors through
    ``resample_planar_plain``."""
    _check_planar(out, coeff, sx, sy, degree, merge_mask)
    if out.device.type == "cpu":
        return resample_planar_plain(out, coeff, sx, sy, degree=degree,
                                     merge_mask=merge_mask)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    fn = _PLANAR.get()
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = fn(out.data_ptr(), coeff.data_ptr(), sx.data_ptr(),
             sy.data_ptr(),
             None if merge_mask is None else merge_mask.data_ptr(),
             _wmat(degree), h, w, hp, wp, int(degree), int(nch), stream)
    if err != 0:
        raise RuntimeError(f"resample_planar kernel launch failed: CUDA "
                           f"error {err}")
    resample_planar.launches += 1
    return out


resample_planar.launches = 0


def clamp_coords(s, extent: int, degree: int):
    """The kernel's float clamp of a coordinate plane to
    [-(n+1), extent + n]: NaN and -inf go to the lower bound, +inf to
    the upper, so no non-finite value reaches the integer split."""
    lo, hi = -(degree + 1.0), float(extent + degree)
    return torch.nan_to_num(s, nan=lo, posinf=hi, neginf=lo).clamp(lo, hi)


def resample_planar_plain(out, coeff, sx, sy, *, degree: int,
                          merge_mask=None):
    """The kernel's computation in plain PyTorch, with its signature:
    clamp the coordinates, ``eval_spline`` (ungated) on the padded
    table, overlay by the mask. Finite wherever the table is, whatever
    the coordinates. Runs on any device."""
    _check_planar(out, coeff, sx, sy, degree, merge_mask)
    hp, wp, _ = coeff.shape
    table = S.Spline2D(coeff=coeff, pad=0, degree=degree,
                       bcs=(S.CONSTANT, S.CONSTANT), core_shape=(hp, wp))
    val = S.eval_spline(table, clamp_coords(sx, wp, degree),
                        clamp_coords(sy, hp, degree), apply_gate=False)
    if merge_mask is None:
        out.copy_(val)
    else:
        keep = (merge_mask > 0.5)[..., None]
        out.copy_(torch.where(keep, val, out))
    return out
