"""B-spline resampling on the card: the four CUDA kernels, their
wrappers and their plain PyTorch versions.

``resample_inline`` is the counterpart of
envutil_tpu/ops/pallas_resample.py:resample_inline_into. Per output
pixel the coordinate chain (target axis features -> ray -> per-face
3x3 matrix -> source pickup -> spline coordinates) and the degree-n
b-spline evaluation run in one pass, so no coordinate plane ever goes
through device memory.

``resample_planar`` is the counterpart of resample_planar_into (with
a merge mask) and resample_planar (without one, over the whole frame):
the spline at precomputed padded coordinates (sx, sy), its planes
form. ``resample_planar_chain`` is its chain form: the coordinate
chain per pixel from the inline kernel's axis features (plus the
stereographic and fisheye target modes) and a ``ChainPickup`` (the IR
pickup, or the mount pickup of partial and PTO mounts with its window
test), then the spline, 0 where the ray misses the source, and on
request each pixel's voronoi score for a multi-facet synopsis.

``resample_inline_twined`` is the counterpart of
resample_inline_twined_into: the inline chain for the three rays of the
twining ninepack, differenced into derivative rays, and the weighted
sum of the spline over the spread's deflected taps. It linearises in ray
space, as the exact path (models/synopsis.twined) does, so the periodic
seam, the poles and cube edges are no special case.

``resample_twined`` is the counterpart of resample_twined_into (with a
merge mask, or with per-pixel tap weights in place of its champion
planes) and resample_twined (without either, over the whole frame): the
same weighted sum from the centre's padded coordinates and four
coordinate derivative planes, its planes form.
``resample_twined_chain`` is its chain form: the ninepack's three rays,
their pickups, the coordinate derivatives and each tap's validity per
pixel in the kernel, then the same sum.

Each wrapper launches its hand-written kernel (csrc/resample_*.cu,
built with nvcc at first use by ops/kernels.py) for CUDA tensors,
raises if it cannot, and takes its plain version only for CPU tensors;
``<wrapper>.launches`` counts kernel launches. A launch enters the card
``out`` lives on (``torch.cuda.device``), so that the launch, the
kernel's shared-memory attribute and the stream belong to that card
whichever card is current (a band of a ``--mesh`` frame on its own
card).
The kernel source notes say what bounds each and what its design
leaves for later.

The inline kernel stages each block's source window in shared memory:
a block reduces its pixels' spline supports to one bounding box of
table entries, copies the box if it fits ``window_bytes`` and reads its
taps from there; a block whose box does not fit (a pole, the periodic
seam, a cube-face edge) and any support outside its block's window
gather from global memory, bit-identically. ``window_bytes=0`` forces
that direct branch everywhere: a hook for tests and chip_smoke.py,
which hold the two branches against each other. ``window_model`` and
``window_holds`` say in plain PyTorch which blocks stage what. The
twined inline kernel is bound by its per-tap arithmetic and gathers
every tap from global memory (a window measured no gain there).

Every kernel takes its table ``coeff`` in float32 or bfloat16
(``--coeff bf16``, as the JAX kernels take it) and evaluates in float32:
each tap is converted where it is read, in the kernel and in its plain
version (``ops/spline.eval_spline``), so kernel and plain version agree
at bf16 as at float32. The other operands are float32 whatever the
table's type. A bf16 window of the inline kernel holds twice the
entries of a float32 one at the same budget (``window_model``'s
``entry_bytes``).

Operands of ``resample_inline`` (contiguous; float32 but for
``coeff``):

- ``out``: (H, W, C) output window, rewritten in place and returned.
- ``coeff``: (Hp, Wp, C) braced spline coefficients, float32 or
  bfloat16.
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

``resample_inline_twined`` takes the same operands with doubled feature
sets, ``xfeat`` (2 Fx, W) and ``yfeat`` (2 Fy, H): the centre's rows,
then those of the axis biased by ``stepper.DERIV_BIAS``. Its ``spread``
and that of ``resample_twined`` is a float32 tensor of ``n_taps``
(cx, cy, w) triplets, flat or (K, 3), with 1/DERIV_BIAS folded into the
offsets (``synopsis.scaled_spread``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..core import geometry as geo
from ..models import lens as _lens
from ..models import synopsis as SYN
from . import basis as _basis
from . import kernels as K
from . import spline as S

_TMODES = {"affine": 0, "sph": 1, "cyl": 2}
# the chain forms take two more target modes on affine features
_CHAIN_TMODES = dict(_TMODES, ster=3, fish=4)
_SMODES = {"sph": 0, "cubemap": 1, "biatan6": 2}
_CHAIN_SMODES = {"cubemap": 1, "biatan6": 2, "mount": 3}
_GATES = {"periodic": 0, "mirror": 1, "clamp": 2, "none": 3}
MAX_DEGREE = 7
# Shared memory, in bytes, that a block of the inline kernel may stage
# its source window in. The kernel's tile (TILE_INLINE output pixels, x
# by y) needs 8-25 KB at the magnifications the port's paths run; 32 KB
# leaves room for five blocks on an SM of the H100 (227 KB), and every
# block is launched with the whole budget, so a larger one costs blocks
# in flight.
WINDOW_BYTES = 32 * 1024
TILE_INLINE = (32, 16)

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# every entry point ends in (..., int coeff_bf16, void* stream)
_INLINE = K.Library("resample_inline.cu", {
    "envutil_resample_inline":
        [_p] * 6 + [_ll] * 4 + [_i] * 7 + [_f, _f, _i] + [_f] * 8
        + [_i, _i, _p]})
_PLANAR = K.Library("resample_planar.cu", {
    "envutil_resample_planar": [_p] * 6 + [_ll] * 4 + [_i, _i, _i, _p],
    "envutil_resample_planar_chain":
        [_p] * 9 + [_ll] * 4 + [_i] * 5 + [_f, _i, _p]})
_INLINE_TWINED = K.Library("resample_inline_twined.cu", {
    "envutil_resample_inline_twined":
        [_p] * 7 + [_ll] * 4 + [_i] * 9 + [_f, _f, _i] + [_f] * 8
        + [_i, _p]})
_TWINED = K.Library("resample_twined.cu", {
    "envutil_resample_twined": [_p] * 12 + [_ll] * 4 + [_i] * 4
    + [_f, _f, _i, _p],
    "envutil_resample_twined_chain":
        [_p] * 10 + [_ll] * 4 + [_i] * 8 + [_f, _i, _p]})
LIBRARIES = (_INLINE, _PLANAR, _INLINE_TWINED, _TWINED)


def build():
    """Build (if needed, one nvcc per source in parallel) and load the
    kernel libraries; returns the wall seconds this took."""
    return K.build_all(LIBRARIES)


def _bf16(coeff) -> int:
    """The entry points' ``coeff_bf16`` flag."""
    return int(coeff.dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _wmat(degree):
    return ctypes.cast((ctypes.c_float * ((degree + 1) ** 2))(
        *_basis.weight_matrix(degree).reshape(-1).tolist()), ctypes.c_void_p)


def _feature_rows(tmode):
    """(Fx, Fy): feature rows of one set of ``xfeat`` and ``yfeat``."""
    return {"sph": (2, 2), "cyl": (2, 1)}.get(tmode, (1, 1))


def _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode, sets: int = 1):
    if smode not in _SMODES:
        raise ValueError(f"unknown smode {smode!r}")
    _check_features(out, coeff, xfeat, yfeat, bmats, degree, tmode,
                    face_rows, sets, _TMODES)
    if len(consts) != (11 if smode == "sph" else 12):
        raise ValueError("consts must be (kx, cx, ky, cy, gate_x, glx, "
                         "gux, gate_y, gly, guy, pad), plus section_px "
                         "for the cubemap/biatan6 source modes")


def _check_table(out, coeff):
    if coeff.dtype not in S.COEFF_DTYPES.values() \
            or not coeff.is_contiguous() \
            or coeff.device != out.device:
        raise ValueError("coeff must be a contiguous float32 or bfloat16 "
                         "table on out's device")


def _check_features(out, coeff, xfeat, yfeat, bmats, degree, tmode,
                    face_rows, sets, tmodes):
    _check_table(out, coeff)
    if tmode not in tmodes:
        raise ValueError(f"unknown tmode {tmode!r}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside 0..{MAX_DEGREE}")
    h, w, nch = out.shape
    if coeff.dim() != 3 or coeff.shape[2] != nch:
        raise ValueError(f"coeff {tuple(coeff.shape)} does not match "
                         f"out {tuple(out.shape)}")
    if not 1 <= nch <= 4:
        raise ValueError(f"{nch} channels; the kernel takes 1..4")
    nfx, nfy = _feature_rows(tmode)
    if tuple(xfeat.shape) != (sets * nfx, w) \
            or tuple(yfeat.shape) != (sets * nfy, h):
        raise ValueError(
            f"features {tuple(xfeat.shape)}/{tuple(yfeat.shape)} do not "
            f"fit tmode {tmode!r} and out {tuple(out.shape)}")
    nf = bmats.shape[0]
    if bmats.shape != (nf, 9) or (nf == 6) != (face_rows > 0) \
            or nf not in (1, 6):
        raise ValueError("bmats must be (1, 9), or (6, 9) with "
                         "face_rows > 0")
    for t in (out, xfeat, yfeat, bmats):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != out.device:
            raise ValueError("operands must be contiguous float32 "
                             "tensors on one device")


def _check_budget(window_bytes):
    if window_bytes < 0 or window_bytes % 16:
        raise ValueError(f"window_bytes {window_bytes} must be a "
                         "non-negative multiple of 16")


def resample_inline(out, coeff, xfeat, yfeat, bmats, *, degree: int,
                    tmode: str, consts: tuple, row0: int = 0,
                    face_rows: int = 0, smode: str = "sph",
                    window_bytes: int = WINDOW_BYTES):
    """Fill ``out`` with the b-spline resampled window (see the module
    docstring for the operands). CUDA tensors go through the kernel;
    CPU tensors through ``resample_inline_plain``. ``window_bytes`` is
    the kernel's staging budget per block (a multiple of 16); 0 makes
    every block gather from global memory, which the tests use to hold
    the kernel's two branches against each other."""
    _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode)
    _check_budget(window_bytes)
    if out.device.type == "cpu":
        return resample_inline_plain(out, coeff, xfeat, yfeat, bmats,
                                     degree=degree, tmode=tmode,
                                     consts=consts, row0=row0,
                                     face_rows=face_rows, smode=smode)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    fn = _INLINE.get("envutil_resample_inline")
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts[:11]
    section_px = consts[11] if smode != "sph" else 0.0
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            out.data_ptr(), coeff.data_ptr(), xfeat.data_ptr(),
            yfeat.data_ptr(), bmats.data_ptr(), _wmat(degree), h, w, hp, wp,
            int(row0), int(face_rows), int(degree), int(nch), _TMODES[tmode],
            _SMODES[smode], _GATES[gate_x], glx, gux, _GATES[gate_y], gly, guy,
            kx, cx, ky, cy, pad, section_px, int(window_bytes), _bf16(coeff),
            stream)
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
    elif tmode in ("ster", "fish"):
        # the chain forms' planar targets: geometry.ster_to_ray /
        # fish_to_ray of the planar grid
        to_ray = geo.ster_to_ray if tmode == "ster" else geo.fish_to_ray
        a, b, c = to_ray(xfeat[0][None, :].expand(h, w),
                         yfeat[0][:, None].expand(h, w))
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
    rx, ry, rz = inline_rays(xfeat, yfeat, bmats, tmode=tmode, row0=row0,
                             face_rows=face_rows)
    return ray_coords(rx, ry, rz, consts=consts, smode=smode)


def ray_coords(rx, ry, rz, *, consts: tuple, smode: str = "sph"):
    """The kernel's source half: padded spline coordinates (sx, sy) of
    rays (which need not be normalised)."""
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts[:11]
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
    (ungated, each tap of a bf16 table upcast) on the padded table. Runs
    on any device."""
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


def support_bases(sx, sy, degree: int, hp: int, wp: int):
    """(bx, by, inside): the first table entry of each coordinate pair's
    (degree+1)^2 support, as the kernels split it (floor for odd
    degrees, round for even), and whether the support lies inside the
    (hp, wp) table. Only such a support is ever read from a staged
    window; the others go through the flat clamp of the direct
    gather."""
    shift = 0.0 if degree % 2 else 0.5
    bx = torch.floor(sx + shift).to(torch.int64) - degree // 2
    by = torch.floor(sy + shift).to(torch.int64) - degree // 2
    inside = (bx >= 0) & (bx + degree < wp) & (by >= 0) & (by + degree < hp)
    return bx, by, inside


def window_model(sx, sy, *, degree: int, table_shape, tile=TILE_INLINE,
                 window_bytes: int = WINDOW_BYTES, entry_bytes: int = 4):
    """The inline kernel's staged windows in plain PyTorch: for the
    padded coordinates ``sx``, ``sy`` (H, W) of a launch's pixels, the
    (Hp, Wp, C) ``table_shape``, the bytes of one table element
    (``entry_bytes``: 4 for float32, 2 for bfloat16; the window holds
    the table's elements as they are stored) and the ``tile`` = (x, y)
    of output pixels a block covers, one entry per block, (H/y, W/x)
    tensors: ``x0, x1, y0, y1`` the table entries of the block's window
    (the bounding box of its pixels' supports, clamped to the table),
    ``f0`` and ``span`` the first element and the elements of a staged
    row segment (starting at the aligned-down element and 16 bytes long
    in whole where the table's rows are a multiple of 16 bytes),
    ``pitch`` the elements between staged rows (the span padded to 16
    bytes more than a multiple of 128, against bank conflicts),
    ``bytes`` the window's size in shared memory, ``copied`` the bytes
    it copies, and ``staged`` whether the block stages it: some pixel's
    support lies in the table and the window fits ``window_bytes``. Used
    by chip_smoke.py's staging figures and the tests; no render path
    calls it."""
    hp, wp, nch = table_shape
    tw, th = tile
    h, w = sx.shape
    bx, by, inside = support_bases(sx, sy, degree, hp, wp)
    hb, wb = -(-h // th), -(-w // tw)
    big = 2 ** 31 - 1

    def over_tiles(v, fill, reduce):
        full = torch.full((hb * th, wb * tw), fill, dtype=torch.int64,
                          device=sx.device)
        full[:h, :w] = torch.where(inside, v, fill)
        return reduce(full.view(hb, th, wb, tw), dim=(1, 3))

    x0, x1 = over_tiles(bx, big, torch.amin), over_tiles(bx, -big, torch.amax)
    y0, y1 = over_tiles(by, big, torch.amin), over_tiles(by, -big, torch.amax)
    some = x1 >= x0
    x0, x1 = x0.clamp(min=0), (x1 + degree).clamp(max=wp - 1)
    y0, y1 = y0.clamp(min=0), (y1 + degree).clamp(max=hp - 1)
    if entry_bytes not in (2, 4):
        raise ValueError(f"entry_bytes {entry_bytes}: the tables are "
                         "float32 (4) or bfloat16 (2)")
    vec, banks = 16 // entry_bytes, 128 // entry_bytes
    f0, f1 = x0 * nch, (x1 + 1) * nch
    if (wp * nch) % vec == 0:
        f0, f1 = f0 // vec * vec, (f1 + vec - 1) // vec * vec
    span = f1 - f0
    pitch = span + ((vec - span) % banks)
    rows = y1 - y0 + 1
    size = torch.where(some, rows * pitch * entry_bytes, 0)
    staged = some & (size <= window_bytes) & (window_bytes > 0)
    return dict(x0=x0, x1=x1, y0=y0, y1=y1, f0=f0, span=span, pitch=pitch,
                bytes=size, copied=rows * span * entry_bytes, staged=staged)


def block_to_pixels(per_block, tile, h: int, w: int):
    """A per-block tensor of ``window_model`` spread over the (h, w)
    pixels of its blocks' tiles."""
    return per_block.repeat_interleave(tile[1], 0).repeat_interleave(
        tile[0], 1)[:h, :w]


def window_holds(win, sx, sy, *, degree: int, table_shape,
                 tile=TILE_INLINE):
    """(H, W) bool: whether each pixel's support lies in its block's
    staged window of ``window_model``; the kernel reads the others from
    global memory."""
    hp, wp, _ = table_shape
    h, w = sx.shape
    bx, by, inside = support_bases(sx, sy, degree, hp, wp)

    def px(name):
        return block_to_pixels(win[name], tile, h, w)
    return (px("staged") & inside & (bx >= px("x0"))
            & (bx + degree <= px("x1")) & (by >= px("y0"))
            & (by + degree <= px("y1")))


def _spread_taps(spread, n_taps, device):
    if spread.dtype != torch.float32 or spread.numel() != 3 * n_taps \
            or n_taps < 1 or not spread.is_contiguous() \
            or spread.device != device:
        raise ValueError("spread must hold n_taps >= 1 contiguous float32 "
                         "(cx, cy, w) triplets on the operands' device")


def resample_inline_twined(out, coeff, xfeat, yfeat, bmats, spread, *,
                           degree: int, n_taps: int, tmode: str,
                           consts: tuple, row0: int = 0, face_rows: int = 0,
                           smode: str = "sph", precise: bool = False):
    """Fill ``out`` with the twined window: per pixel the weighted sum of
    the spline over the spread's taps, each at the pickup of the ray
    p0 + cx du + cy dv (see the module docstring for the operands).
    ``precise`` takes the derivative rays in the centre ray's tangent
    plane (--twine_precise). CUDA tensors go through the kernel; CPU
    tensors through ``resample_inline_twined_plain``."""
    _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode, sets=2)
    _spread_taps(spread, n_taps, out.device)
    kw = dict(degree=degree, n_taps=n_taps, tmode=tmode, consts=consts,
              row0=row0, face_rows=face_rows, smode=smode, precise=precise)
    if out.device.type == "cpu":
        return resample_inline_twined_plain(out, coeff, xfeat, yfeat, bmats,
                                            spread, **kw)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    fn = _INLINE_TWINED.get("envutil_resample_inline_twined")
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts[:11]
    section_px = consts[11] if smode != "sph" else 0.0
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            out.data_ptr(), coeff.data_ptr(), xfeat.data_ptr(),
            yfeat.data_ptr(), bmats.data_ptr(), spread.data_ptr(),
            _wmat(degree), h, w, hp, wp, int(row0), int(face_rows),
            int(degree), int(nch), _TMODES[tmode], _SMODES[smode],
            int(n_taps), int(precise), _GATES[gate_x], glx, gux,
            _GATES[gate_y], gly, guy, kx, cx, ky, cy, pad, section_px,
            _bf16(coeff), stream)
    if err != 0:
        raise RuntimeError(f"resample_inline_twined kernel launch failed: "
                           f"CUDA error {err}")
    resample_inline_twined.launches += 1
    return out


resample_inline_twined.launches = 0


def inline_ninepack(xfeat, yfeat, bmats, *, tmode: str, row0: int = 0,
                    face_rows: int = 0):
    """The three normalised ray grids (p0, p10, p01) of the doubled
    feature sets, as the twined kernel computes them."""
    nfx, nfy = _feature_rows(tmode)
    kw = dict(tmode=tmode, row0=row0, face_rows=face_rows)
    return tuple(geo.normalize(*inline_rays(xf, yf, bmats, **kw))
                 for xf, yf in ((xfeat[:nfx], yfeat[:nfy]),
                                (xfeat[nfx:], yfeat[:nfy]),
                                (xfeat[:nfx], yfeat[nfy:])))


def inline_tap_rays(xfeat, yfeat, bmats, spread, *, tmode: str,
                    row0: int = 0, face_rows: int = 0,
                    precise: bool = False):
    """Per tap of the spread, (ray, w): every pixel's deflected ray
    p0 + cx du + cy dv, as the twined kernel computes it, and the tap's
    weight."""
    p0, p10, p01 = inline_ninepack(xfeat, yfeat, bmats, tmode=tmode,
                                   row0=row0, face_rows=face_rows)
    du, dv = SYN.derivative_rays(p0, p10, p01, precise)
    for cx, cy, w in spread.reshape(-1, 3).tolist():
        yield SYN.deflect(p0, du, dv, cx, cy), w


# The twined kernel's increment pickup (a spherical source, two or more
# taps): a tap's longitude and latitude are the centre ray's plus the
# angle of the tap's deflection, the atan of a ratio of cross and dot
# products, by an odd polynomial where the ratio's size is at most
# INCREMENT_TAU (float32-exact there: the first term left out, t^9/9,
# is below 3e-11 of t); every other tap takes the full pickup.
INCREMENT_TAU = 1.0 / 16.0
_ATAN_C3, _ATAN_C5, _ATAN_C7 = (float(torch.tensor(c, dtype=torch.float32))
                                for c in (-1.0 / 3.0, 1.0 / 5.0, -1.0 / 7.0))
_PI_F = float(torch.tensor(math.pi, dtype=torch.float32))


def atan_small(t):
    """atan(t) for |t| <= INCREMENT_TAU: t + t (s (c3 + s (c5 + s c7))),
    s = t^2, rounded step by step as the kernel rounds it."""
    s = t * t
    q = _ATAN_C3 + s * (_ATAN_C5 + s * _ATAN_C7)
    return t + t * (s * q)


def gate_in_range(v, mode: str, lower: float, upper: float):
    """(inside, value): where the twined kernel's gate takes its branch
    without a division (a periodic or mirror gate whose u = v - lower
    lies in [0, period): nothing wraps) and what it returns there,
    lower + u (mirror: lower + min(u, period - u)), ``_gate``'s value
    bit for bit. ``inside`` is all False for the other gates."""
    if mode not in ("periodic", "mirror"):
        return torch.zeros_like(v, dtype=torch.bool), v
    period = float(torch.tensor(upper, dtype=torch.float32)
                   - torch.tensor(lower, dtype=torch.float32))
    if mode == "mirror":
        period *= 2.0
    u = v - lower
    inside = (u >= 0) & (u < period)
    if mode == "mirror":
        u = torch.minimum(u, period - u)
    return inside, lower + u


def _gate_unwrapped(v, mode: str, lower: float, upper: float):
    inside, value = gate_in_range(v, mode, lower, upper)
    return torch.where(inside, value, _gate(v, mode, lower, upper))


def increment_coords(p0, d, *, consts: tuple):
    """The twined kernel's increment pickup of a tap's ray p0 + d, ``d``
    its deflection cx du + cy dv from the normalised centre ray ``p0``,
    for a spherical source, in float32 rounded step by step (the kernel
    fuses multiply-adds and takes approximate reciprocals: the two agree
    to a few ulp of the increments): (sx, sy, taken), the padded spline
    coordinates and the (H, W) plane of the pixels whose tap took the
    increment; the others hold ``ray_coords`` of the ray.

    Longitude: tan(lon - lon0) = (z0 dx - x0 dz) / (rho0^2 + x0 dx +
    z0 dz). Latitude, in the (rho, y) plane: drho = (2 (x0 dx + z0 dz) +
    dx^2 + dz^2) / (rho + rho0) and tan(lat - lat0) = (rho0 dy - y0 drho)
    / (rho0 rho + y0 y). No numerator subtracts two products of full
    rays, so none cancels. A tap whose dot product is <= 0 or whose
    tangent exceeds INCREMENT_TAU takes the full pickup: at or next to a
    pole, and for coarse output pixels."""
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts[:11]
    x0, y0, z0 = p0
    dx, dy, dz = d
    xk, yk, zk = x0 + dx, y0 + dy, z0 + dz
    rho2 = x0 * x0 + z0 * z0
    rho0 = torch.sqrt(rho2)
    lon0 = torch.atan2(x0, z0)
    lat0 = torch.atan2(y0, rho0)
    s = x0 * dx + z0 * dz
    dot = rho2 + s
    t = (z0 * dx - x0 * dz) * torch.reciprocal(dot)
    rho = torch.sqrt(xk * xk + zk * zk)
    drho = (2.0 * s + dx * dx + dz * dz) * torch.reciprocal(rho + rho0)
    dot_l = rho0 * rho + y0 * yk
    t_l = (rho0 * dy - y0 * drho) * torch.reciprocal(dot_l)
    taken = (dot > 0) & (dot_l > 0) & (t.abs() <= INCREMENT_TAU) \
        & (t_l.abs() <= INCREMENT_TAU)
    # lon0 + dlon may pass +-pi, where atan2 would have wrapped
    lon = lon0 + atan_small(t)
    lon = torch.where(lon > _PI_F, lon - 2.0 * _PI_F,
                      torch.where(lon < -_PI_F, lon + 2.0 * _PI_F, lon))
    lat = lat0 + atan_small(t_l)
    sx = _gate_unwrapped(lon * kx + cx, gate_x, glx, gux) + pad
    sy = _gate_unwrapped(lat * ky + cy, gate_y, gly, guy) + pad
    fx, fy = ray_coords(xk, yk, zk, consts=consts)
    return torch.where(taken, sx, fx), torch.where(taken, sy, fy), taken


def inline_tap_coords(xfeat, yfeat, bmats, spread, *, tmode: str,
                      consts: tuple, row0: int = 0, face_rows: int = 0,
                      smode: str = "sph", precise: bool = False):
    """Per tap of the spread, (sx, sy, w, taken): the padded spline
    coordinates of every pixel's deflected ray and the tap's weight, as
    the twined kernel computes them, and the (H, W) plane of the pixels
    whose tap took the increment pickup (``increment_coords``: a
    spherical source and two or more taps, the ray p0 + (cx du + cy dv)),
    None where the launch takes the full pickup of ``inline_tap_rays``'
    ray for every tap."""
    p0, p10, p01 = inline_ninepack(xfeat, yfeat, bmats, tmode=tmode,
                                   row0=row0, face_rows=face_rows)
    du, dv = SYN.derivative_rays(p0, p10, p01, precise)
    incremental = smode == "sph" and spread.numel() >= 6
    for cx, cy, w in spread.reshape(-1, 3).tolist():
        if incremental:
            d = tuple(cx * u + cy * v for u, v in zip(du, dv))
            sx, sy, taken = increment_coords(p0, d, consts=consts)
        else:
            (sx, sy), taken = ray_coords(*SYN.deflect(p0, du, dv, cx, cy),
                                         consts=consts, smode=smode), None
        yield sx, sy, w, taken


def resample_inline_twined_plain(out, coeff, xfeat, yfeat, bmats, spread, *,
                                 degree: int, n_taps: int, tmode: str,
                                 consts: tuple, row0: int = 0,
                                 face_rows: int = 0, smode: str = "sph",
                                 precise: bool = False):
    """The twined kernel's computation in plain PyTorch, with its
    signature: the three ``inline_rays`` grids normalised, the derivative
    rays, and per tap the deflected ray's pickup (``inline_tap_coords``:
    the increment from the centre ray's for a spherical source with two
    or more taps) and ``eval_spline`` (ungated, each tap of a bf16 table
    upcast) on the padded table. Runs on any device."""
    _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode, sets=2)
    _spread_taps(spread, n_taps, out.device)
    table = S.Spline2D(coeff=coeff, pad=0, degree=degree,
                       bcs=(S.CONSTANT, S.CONSTANT),
                       core_shape=tuple(coeff.shape[:2]))
    acc = None
    for sx, sy, w, _taken in inline_tap_coords(
            xfeat, yfeat, bmats, spread, tmode=tmode, consts=consts,
            row0=row0, face_rows=face_rows, smode=smode, precise=precise):
        term = w * S.eval_spline(table, sx, sy, apply_gate=False)
        acc = term if acc is None else acc + term
    out.copy_(acc)
    return out


def _check_planar(out, coeff, sx, sy, degree, merge_mask):
    _check_table(out, coeff)
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
    for t in (out,) + planes:
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
    fn = _PLANAR.get("envutil_resample_planar")
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(out.data_ptr(), coeff.data_ptr(), sx.data_ptr(),
                 sy.data_ptr(),
                 None if merge_mask is None else merge_mask.data_ptr(),
                 _wmat(degree), h, w, hp, wp, int(degree), int(nch),
                 _bf16(coeff), stream)
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
    clamp the coordinates, ``eval_spline`` (ungated, each tap of a bf16
    table upcast) on the padded table, overlay by the mask. Finite wherever the table is, whatever
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


def _check_twined(out, coeff, planes, spread, degree, n_taps, merge_mask,
                  tap_weights, wrap_x):
    _check_planar(out, coeff, planes[0], planes[1], degree, merge_mask)
    _spread_taps(spread, n_taps, out.device)
    for t in planes[2:]:
        if tuple(t.shape) != tuple(out.shape[:2]) \
                or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != out.device:
            raise ValueError("derivative planes must be contiguous float32 "
                             "(H, W) tensors on out's device")
    if tap_weights is not None:
        if merge_mask is not None:
            raise ValueError("merge_mask and tap_weights exclude each other")
        if tuple(tap_weights.shape) != (n_taps,) + tuple(out.shape[:2]) \
                or tap_weights.dtype not in (torch.float32, torch.uint8,
                                             torch.bool) \
                or not tap_weights.is_contiguous() \
                or tap_weights.device != out.device:
            raise ValueError("tap_weights must be contiguous (n_taps, H, W) "
                             "float32, uint8 or bool planes on out's device")
    if wrap_x is not None and not wrap_x[1] > 0:
        raise ValueError("wrap_x is (lower, period) with period > 0")


def resample_twined(out, coeff, sx, sy, dux, duy, dvx, dvy, spread, *,
                    degree: int, n_taps: int, merge_mask=None,
                    tap_weights=None, wrap_x=None):
    """Sum over the spread's taps of w_k times the degree-``degree``
    spline of the braced (Hp, Wp, C) table ``coeff`` at the padded
    coordinates (sx + cx_k dux + cy_k dvx, sy + cx_k duy + cy_k dvy),
    into ``out`` (H, W, C), in place; returns ``out``. All planes are
    (H, W) float32. With ``merge_mask``, pixels whose mask is <= 0.5
    keep the prior contents of ``out`` bit for bit. With ``tap_weights``
    (n_taps, H, W; float32, uint8 or bool) tap k's weight at a pixel is
    w_k * tap_weights[k]: a tap of weight 0 reads nothing and a pixel
    whose weights are all 0 is written 0. ``wrap_x`` = (lower, period),
    in padded coordinates, wraps each deflected x into
    [lower, lower + period) for horizontally periodic tables. CUDA
    tensors go through the kernel; CPU tensors through
    ``resample_twined_plain``."""
    planes = (sx, sy, dux, duy, dvx, dvy)
    _check_twined(out, coeff, planes, spread, degree, n_taps, merge_mask,
                  tap_weights, wrap_x)
    if out.device.type == "cpu":
        return resample_twined_plain(
            out, coeff, *planes, spread, degree=degree, n_taps=n_taps,
            merge_mask=merge_mask, tap_weights=tap_weights, wrap_x=wrap_x)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    fn = _TWINED.get("envutil_resample_twined")
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    lower, period = (0.0, 0.0) if wrap_x is None else wrap_x
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(out.data_ptr(), coeff.data_ptr(),
                 *(t.data_ptr() for t in planes), spread.data_ptr(),
                 None if merge_mask is None else merge_mask.data_ptr(),
                 None if tap_weights is None else tap_weights.data_ptr(),
                 _wmat(degree), h, w, hp, wp, int(degree), int(nch),
                 int(n_taps), int(tap_weights is not None
                     and tap_weights.dtype != torch.float32),
                 float(lower), float(period), _bf16(coeff), stream)
    if err != 0:
        raise RuntimeError(f"resample_twined kernel launch failed: CUDA "
                           f"error {err}")
    resample_twined.launches += 1
    return out


resample_twined.launches = 0


def twined_tap_coords(sx, sy, dux, duy, dvx, dvy, spread, hp: int, wp: int,
                      degree: int, wrap_x=None):
    """Per tap of the spread, (x, y, w): the deflected, wrapped and
    clamped padded coordinates the twined kernel evaluates, and the
    tap's weight."""
    for cx, cy, w in spread.reshape(-1, 3).tolist():
        x = sx + cx * dux + cy * dvx
        y = sy + cx * duy + cy * dvy
        if wrap_x is not None:
            x = wrap_x[0] + torch.remainder(x - wrap_x[0], wrap_x[1])
        yield clamp_coords(x, wp, degree), clamp_coords(y, hp, degree), w


def resample_twined_plain(out, coeff, sx, sy, dux, duy, dvx, dvy, spread, *,
                          degree: int, n_taps: int, merge_mask=None,
                          tap_weights=None, wrap_x=None):
    """The twined kernel's computation in plain PyTorch, with its
    signature: the tap loop over ``resample_planar_plain``'s pieces
    (deflect, wrap, clamp, ``eval_spline`` ungated on the padded table),
    the taps weighted per pixel by ``tap_weights``, the sum overlaid by
    the mask. Runs on any device."""
    planes = (sx, sy, dux, duy, dvx, dvy)
    _check_twined(out, coeff, planes, spread, degree, n_taps, merge_mask,
                  tap_weights, wrap_x)
    hp, wp, _ = coeff.shape
    table = S.Spline2D(coeff=coeff, pad=0, degree=degree,
                       bcs=(S.CONSTANT, S.CONSTANT), core_shape=(hp, wp))
    acc = None
    for k, (x, y, w) in enumerate(twined_tap_coords(
            *planes, spread, hp, wp, degree, wrap_x)):
        val = S.eval_spline(table, x, y, apply_gate=False)
        if tap_weights is None:
            term = w * val
        else:
            term = (w * tap_weights[k].to(torch.float32))[..., None] * val
        acc = term if acc is None else acc + term
    if merge_mask is None:
        out.copy_(acc)
    else:
        keep = (merge_mask > 0.5)[..., None]
        out.copy_(torch.where(keep, acc, out))
    return out


# ---------------------------------------------------------------------------
# the chain forms of the planar kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainPickup:
    """The source side of the chain forms (``ChainPickup`` in
    csrc/planar_chain.cuh). ``smode`` "cubemap"/"biatan6": the IR pickup
    of the inline kernel, (kx, cx, ky, cy) the in-face affine and
    ``section_px`` the IR rows per face. ``smode`` "mount": the ray goes
    through the ``projection``'s ``to_plane``, then the PTO ``lens``
    (s, a, b, c), ``shift`` (h, v) and ``shear`` (g, t) where given, is
    tested against the ``window`` extent (x0, x1, y0, y1; unbounded for
    a full fisheye; z > 0 as well for a rectilinear source), and maps to
    spline coordinates by (kx, cx, ky, cy) and the gates. ``period`` is
    the core width of a horizontally periodic mount (0 otherwise): the
    twined chain wraps its x derivatives and taps by it."""
    smode: str
    kx: float
    cx: float
    ky: float
    cy: float
    pad: float
    section_px: float = 0.0
    projection: int = 0
    gate_x: str = "none"
    glx: float = 0.0
    gux: float = 0.0
    gate_y: str = "none"
    gly: float = 0.0
    guy: float = 0.0
    window: tuple = (-math.inf, math.inf, -math.inf, math.inf)
    lens: tuple | None = None
    shift: tuple | None = None
    shear: tuple | None = None
    period: float = 0.0


@functools.lru_cache(maxsize=64)
def _pickup_arrays(p: ChainPickup):
    """(7 ints, 24 floats): the kernel's ChainPickup fields, as host
    arrays for the C entry points."""
    s, a, b, c = p.lens or (1.0, 0.0, 0.0, 0.0)
    h, v = p.shift or (0.0, 0.0)
    g, t = p.shear or (0.0, 0.0)
    ints = (_CHAIN_SMODES[p.smode], int(p.projection), _GATES[p.gate_x],
            _GATES[p.gate_y], int(p.lens is not None),
            int(p.shift is not None), int(p.shear is not None))
    floats = (p.kx, p.cx, p.ky, p.cy, p.pad, p.section_px, p.glx, p.gux,
              p.gly, p.guy, *p.window, s, a, b, c, 1.0 - (a + b + c), h, v,
              g, t, p.period)
    return ((ctypes.c_int * 7)(*ints),
            (ctypes.c_float * 24)(*(float(f) for f in floats)))


def chain_rays(xfeat, yfeat, bmats, *, tmode: str, row0: int = 0,
               face_rows: int = 0):
    """Normalised rays (rx, ry, rz), each (H, W), from one feature set:
    the chain forms' target half."""
    return geo.normalize(*inline_rays(xfeat, yfeat, bmats, tmode=tmode,
                                      row0=row0, face_rows=face_rows))


def mount_planar(pick: ChainPickup, x, y, z):
    """(px, py, hit): the mount pickup's model-space planar coordinates
    of rays (the source projection's ``to_plane``, then the PTO
    transform) and whether each ray falls into the facet's window."""
    px, py = geo.to_plane(pick.projection)(x, y, z)
    if pick.lens is not None:
        s, a, b, c = pick.lens
        f = _lens.lcp_scale(torch.sqrt(px * px + py * py) / s, a, b, c)
        px, py = px * f, py * f
    if pick.shift is not None:
        px, py = px + pick.shift[0], py + pick.shift[1]
    if pick.shear is not None:
        px, py = px + py * pick.shear[0], py + px * pick.shear[1]
    x0, x1, y0, y1 = pick.window
    hit = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
    if pick.projection == int(geo.Projection.RECTILINEAR):
        hit = hit & (z > 0.0)
    return px, py, hit


def chain_coords(pick: ChainPickup, rx, ry, rz):
    """The untwined chain's source half: the padded, gated spline
    coordinates (sx, sy) of rays and whether each hits the source."""
    if pick.smode != "mount":
        consts = (pick.kx, pick.cx, pick.ky, pick.cy, "none", 0.0, 0.0,
                  "none", 0.0, 0.0, pick.pad, pick.section_px)
        sx, sy = ray_coords(rx, ry, rz, consts=consts, smode=pick.smode)
        return sx, sy, torch.ones_like(rx, dtype=torch.bool)
    px, py, hit = mount_planar(pick, rx, ry, rz)
    sx = _gate(px * pick.kx + pick.cx, pick.gate_x, pick.glx, pick.gux)
    sy = _gate(py * pick.ky + pick.cy, pick.gate_y, pick.gly, pick.guy)
    return sx + pick.pad, sy + pick.pad, hit


def planar_chain_coords(xfeat, yfeat, bmats, *, tmode: str,
                        pick: ChainPickup, row0: int = 0,
                        face_rows: int = 0):
    """(sx, sy, mask), each (H, W): the padded spline coordinates and the
    validity of every pixel of the window as the planar chain kernel
    computes them; the counterpart of ``fastpath.coords``."""
    return chain_coords(pick, *chain_rays(xfeat, yfeat, bmats, tmode=tmode,
                                          row0=row0, face_rows=face_rows))


def _check_chain(out, coeff, xfeat, yfeat, bmats, degree, tmode, pick,
                 face_rows, sets):
    if not isinstance(pick, ChainPickup) or pick.smode not in _CHAIN_SMODES:
        raise ValueError("pick must be a ChainPickup with smode cubemap, "
                         "biatan6 or mount")
    _check_features(out, coeff, xfeat, yfeat, bmats, degree, tmode,
                    face_rows, sets, _CHAIN_TMODES)


def _check_score(out, score):
    if score is not None and (
            tuple(score.shape) != tuple(out.shape[:2])
            or score.dtype != torch.float32 or not score.is_contiguous()
            or score.device != out.device):
        raise ValueError("score must be a contiguous float32 (H, W) plane "
                         "on out's device")


def resample_planar_chain(out, coeff, xfeat, yfeat, bmats, *, degree: int,
                          tmode: str, pick: ChainPickup, row0: int = 0,
                          face_rows: int = 0, score=None,
                          recip_step: float = 1.0):
    """The chain form of the planar kernel: per pixel the target ray from
    the axis features (``tmode`` affine, sph or cyl as for
    ``resample_inline``, or ster / fish on planar features), its pickup
    by ``pick``, the gates, and the spline of the braced table, into
    ``out`` (H, W, C), in place; pixels whose ray misses the source are
    written 0. With ``score`` (H, W), each pixel's voronoi score is
    written there as well (``synopsis.facet_score``: the normalised ray's
    z times ``recip_step`` where the ray hits, ``synopsis.LOWEST`` where
    it misses); ``out`` is the same bit for bit with or without it.
    Returns ``out``. CUDA tensors go through the kernel; CPU tensors
    through ``resample_planar_chain_plain``."""
    _check_chain(out, coeff, xfeat, yfeat, bmats, degree, tmode, pick,
                 face_rows, 1)
    _check_score(out, score)
    kw = dict(degree=degree, tmode=tmode, pick=pick, row0=row0,
              face_rows=face_rows, score=score, recip_step=recip_step)
    if out.device.type == "cpu":
        return resample_planar_chain_plain(out, coeff, xfeat, yfeat, bmats,
                                           **kw)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    fn = _PLANAR.get("envutil_resample_planar_chain")
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    ints, floats = _pickup_arrays(pick)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(out.data_ptr(), None if score is None else score.data_ptr(),
                 coeff.data_ptr(), xfeat.data_ptr(), yfeat.data_ptr(),
                 bmats.data_ptr(), _wmat(degree), ints, floats, h, w, hp, wp,
                 int(row0), int(face_rows), int(degree), int(nch),
                 _CHAIN_TMODES[tmode], float(recip_step), _bf16(coeff), stream)
    if err != 0:
        raise RuntimeError(f"resample_planar_chain kernel launch failed: "
                           f"CUDA error {err}")
    resample_planar_chain.launches += 1
    return out


resample_planar_chain.launches = 0


def resample_planar_chain_plain(out, coeff, xfeat, yfeat, bmats, *,
                                degree: int, tmode: str, pick: ChainPickup,
                                row0: int = 0, face_rows: int = 0,
                                score=None, recip_step: float = 1.0):
    """The planar chain kernel's computation in plain PyTorch, with its
    signature: ``chain_rays`` and ``chain_coords``, the score from the
    ray's z where asked, then ``resample_planar_plain`` under the
    validity mask over a zero canvas. Runs on any device."""
    _check_chain(out, coeff, xfeat, yfeat, bmats, degree, tmode, pick,
                 face_rows, 1)
    _check_score(out, score)
    ray = chain_rays(xfeat, yfeat, bmats, tmode=tmode, row0=row0,
                     face_rows=face_rows)
    sx, sy, mask = chain_coords(pick, *ray)
    if score is not None:
        score.copy_(SYN.facet_score(ray[2], mask, recip_step))
    out.zero_()
    return resample_planar_plain(out, coeff, sx.contiguous(),
                                 sy.contiguous(), degree=degree,
                                 merge_mask=mask.to(torch.float32))


def twined_chain_operands(xfeat, yfeat, bmats, spread, *, tmode: str,
                          pick: ChainPickup, row0: int = 0,
                          face_rows: int = 0, precise: bool = False,
                          tap_valid: bool = False,
                          recip_step: float | None = None):
    """The operands that the twined chain kernel computes per pixel, as
    the dict of ``twined_ray_operands`` (with ``recip_step``, the one
    tap's score too): the kernel's three normalised ray grids from the
    doubled feature sets, through the kernel's source half."""
    nfx, nfy = _feature_rows(tmode)
    kw = dict(tmode=tmode, row0=row0, face_rows=face_rows)
    rays = [chain_rays(xf, yf, bmats, **kw)
            for xf, yf in ((xfeat[:nfx], yfeat[:nfy]),
                           (xfeat[nfx:], yfeat[:nfy]),
                           (xfeat[:nfx], yfeat[nfy:]))]
    return twined_ray_operands(*rays, spread, pick=pick, precise=precise,
                               tap_valid=tap_valid, recip_step=recip_step)


def twined_ray_operands(p0, p10, p01, spread, *, pick: ChainPickup,
                        precise: bool = False, tap_valid: bool = False,
                        recip_step: float | None = None):
    """The twined chain's source half from the ninepack's three
    normalised ray grids, as the planar twined kernel's operands (the
    twined chain kernel computes them per pixel; ``fastpath.twined_coords``
    passes them to the planes form): ``sx``, ``sy`` the centre's padded
    coordinates (ungated), ``dux``, ``duy``, ``dvx``, ``dvy`` the
    coordinate derivatives (wrapped by the period, 0 where not finite),
    ``tap_weights`` (K, H, W) uint8, each tap's deflected validity (with
    ``tap_valid``, else None), and ``wrap_x``. An IR source's three
    pickups are taken in the centre ray's face. ``score`` is None, or
    with ``recip_step`` (a one-tap spread only) the tap's voronoi score:
    ``synopsis.facet_score`` of its deflected ray (not renormalised, as
    ``synopsis.twined`` scores it) under the tap's validity."""
    du, dv = SYN.derivative_rays(p0, p10, p01, precise)
    if precise:
        p10 = tuple(a + b for a, b in zip(p0, du))
        p01 = tuple(a + b for a, b in zip(p0, dv))

    if pick.smode != "mount":
        face = geo.ray_to_cubeface(*p0)[0]

        def coords(ray):
            fx, fy = geo.ray_to_cubeface_fixed(*ray, face)
            if pick.smode == "biatan6":
                fx = (4.0 / math.pi) * torch.atan(fx)
                fy = (4.0 / math.pi) * torch.atan(fy)
            return (fx * pick.kx + pick.cx,
                    fy * pick.ky + pick.cy + face.to(fy.dtype)
                    * pick.section_px)
    else:
        def coords(ray):
            px, py, _hit = mount_planar(pick, *ray)
            return px * pick.kx + pick.cx, py * pick.ky + pick.cy

    x0, y0 = coords(p0)

    def derivative(ray):
        x, y = coords(ray)
        dx, dy = x - x0, y - y0
        if pick.period > 0:
            half = 0.5 * pick.period
            dx = torch.remainder(dx + half, pick.period) - half
        return (torch.nan_to_num(dx, 0.0, 0.0, 0.0).contiguous(),
                torch.nan_to_num(dy, 0.0, 0.0, 0.0).contiguous())

    dux, duy = derivative(p10)
    dvx, dvy = derivative(p01)
    tap_weights = score = None
    if tap_valid or recip_step is not None:
        taps = [SYN.deflect(p0, du, dv, cx, cy)
                for cx, cy, _w in spread.reshape(-1, 3).tolist()]
        hits = [mount_planar(pick, *ray)[2] if tap_valid
                else torch.ones_like(ray[2], dtype=torch.bool)
                for ray in taps]
        if tap_valid:
            tap_weights = torch.stack(hits).to(torch.uint8)
        if recip_step is not None:
            _one_tap(len(taps))
            score = SYN.facet_score(taps[0][2], hits[0], recip_step)
    return dict(sx=(x0 + pick.pad).contiguous(),
                sy=(y0 + pick.pad).contiguous(), dux=dux, duy=duy, dvx=dvx,
                dvy=dvy, tap_weights=tap_weights, score=score,
                wrap_x=((pick.pad - 0.5, pick.period) if pick.period > 0
                        else None))


def _one_tap(n_taps):
    if n_taps != 1:
        raise ValueError("a twined score is for one-tap spreads (a twined "
                         "stitch launches one tap at a time)")


def _check_twined_chain(out, coeff, xfeat, yfeat, bmats, spread, degree,
                        n_taps, tmode, pick, face_rows, tap_valid, score):
    _check_chain(out, coeff, xfeat, yfeat, bmats, degree, tmode, pick,
                 face_rows, 2)
    _spread_taps(spread, n_taps, out.device)
    if tap_valid and pick.smode != "mount":
        raise ValueError("tap_valid is for mount sources only")
    _check_score(out, score)
    if score is not None:
        _one_tap(n_taps)


def resample_twined_chain(out, coeff, xfeat, yfeat, bmats, spread, *,
                          degree: int, n_taps: int, tmode: str,
                          pick: ChainPickup, row0: int = 0,
                          face_rows: int = 0, precise: bool = False,
                          tap_valid: bool = False, score=None,
                          recip_step: float = 1.0):
    """The chain form of the planar twined kernel: per pixel the three
    rays of the ninepack from the doubled feature sets (as for
    ``resample_inline_twined``, plus the ster / fish modes), the
    derivative rays (``precise``: in the tangent plane), three pickups,
    the coordinate derivatives, and the weighted sum of the spline over
    the spread's taps deflected in coordinate space, each tap counted
    only where its deflected ray hits the source when ``tap_valid``;
    into ``out`` (H, W, C), in place, 0 where no tap counts. With
    ``score`` (H, W; a one-tap spread only) the tap's voronoi score is
    written there as well: the z of its deflected ray p0 + cx du + cy dv
    (not renormalised) times ``recip_step`` where the tap counts,
    ``synopsis.LOWEST`` where it misses; ``out`` is the same bit for bit
    with or without it. Returns ``out``. CUDA tensors go through the
    kernel; CPU tensors through ``resample_twined_chain_plain``."""
    _check_twined_chain(out, coeff, xfeat, yfeat, bmats, spread, degree,
                        n_taps, tmode, pick, face_rows, tap_valid, score)
    kw = dict(degree=degree, n_taps=n_taps, tmode=tmode, pick=pick,
              row0=row0, face_rows=face_rows, precise=precise,
              tap_valid=tap_valid, score=score, recip_step=recip_step)
    if out.device.type == "cpu":
        return resample_twined_chain_plain(out, coeff, xfeat, yfeat, bmats,
                                           spread, **kw)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    fn = _TWINED.get("envutil_resample_twined_chain")
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    ints, floats = _pickup_arrays(pick)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(out.data_ptr(), None if score is None else score.data_ptr(),
                 coeff.data_ptr(), xfeat.data_ptr(), yfeat.data_ptr(),
                 bmats.data_ptr(), spread.data_ptr(), _wmat(degree), ints,
                 floats, h, w, hp, wp, int(row0), int(face_rows), int(degree),
                 int(nch), _CHAIN_TMODES[tmode], int(n_taps), int(precise),
                 int(tap_valid), float(recip_step), _bf16(coeff), stream)
    if err != 0:
        raise RuntimeError(f"resample_twined_chain kernel launch failed: "
                           f"CUDA error {err}")
    resample_twined_chain.launches += 1
    return out


resample_twined_chain.launches = 0


def resample_twined_chain_plain(out, coeff, xfeat, yfeat, bmats, spread, *,
                                degree: int, n_taps: int, tmode: str,
                                pick: ChainPickup, row0: int = 0,
                                face_rows: int = 0, precise: bool = False,
                                tap_valid: bool = False, score=None,
                                recip_step: float = 1.0):
    """The twined chain kernel's computation in plain PyTorch, with its
    signature: ``twined_chain_operands`` (the score, where asked, by
    ``synopsis.facet_score`` of ``synopsis.deflect`` of the chain's
    rays), then ``resample_twined_plain`` on them. Runs on any
    device."""
    _check_twined_chain(out, coeff, xfeat, yfeat, bmats, spread, degree,
                        n_taps, tmode, pick, face_rows, tap_valid, score)
    ops = twined_chain_operands(
        xfeat, yfeat, bmats, spread, tmode=tmode, pick=pick, row0=row0,
        face_rows=face_rows, precise=precise, tap_valid=tap_valid,
        recip_step=None if score is None else recip_step)
    if score is not None:
        score.copy_(ops["score"])
    return resample_twined_plain(
        out, coeff, *(ops[k] for k in ("sx", "sy", "dux", "duy", "dvx",
                                       "dvy")),
        spread, degree=degree, n_taps=n_taps,
        tap_weights=ops["tap_weights"], wrap_x=ops["wrap_x"])
