"""Inline-coordinates b-spline resampling: the CUDA kernel, its wrapper
and its plain PyTorch version.

Counterpart of envutil_tpu/ops/pallas_resample.py:resample_inline_into.
Per output pixel the coordinate chain (target axis features -> ray ->
per-face 3x3 matrix -> lon/lat -> gates -> spline affine) and the
degree-n b-spline evaluation run in one pass, so no coordinate plane
ever goes through device memory.

``resample_inline`` launches the hand-written kernel
(csrc/resample_inline.cu, built with nvcc at first use) for CUDA
tensors and takes ``resample_inline_plain`` only for CPU tensors;
``resample_inline.launches`` counts kernel launches. The kernel source
note says what bounds it and what its design leaves for later.

Operands (all float32, contiguous):

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
  takes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

from . import basis as _basis
from . import spline as S

_TMODES = {"affine": 0, "sph": 1, "cyl": 2}
_GATES = {"periodic": 0, "mirror": 1, "clamp": 2}
MAX_DEGREE = 7

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "resample_inline.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class _Library:
    """The compiled kernel library, built on first use into
    ``_build/`` under a name keyed on a hash of the source."""

    lib = None
    build_seconds = 0.0
    build_log = ""

    @classmethod
    def get(cls):
        if cls.lib is None:
            cls.lib = cls._load()
        return cls.lib

    @staticmethod
    def _nvcc() -> str:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
        if not os.path.exists(path):
            raise RuntimeError(
                "nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                "the resample_inline kernel cannot be built")
        return path

    @classmethod
    def _load(cls):
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"resample_inline_{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [cls._nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True)
                cls.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building "
                        f"{SOURCE.name}:\n{cls.build_log}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            cls.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        fn = lib.envutil_resample_inline
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = [p, p, p, p, p, p, ll, ll, ll, ll, i, i, i, i, i,
                       i, f, f, i, f, f, f, f, f, f, f, p]
        fn.restype = ctypes.c_int
        return lib


def build():
    """Build (if needed) and load the kernel library; returns the
    seconds the build took in this process (0.0 if it was cached)."""
    _Library.get()
    return _Library.build_seconds


def build_log() -> str:
    """nvcc's output (register and spill counts) from this process's
    build, or '' when the library was already built."""
    return _Library.build_log


def _check(out, coeff, xfeat, yfeat, bmats, degree, tmode, consts,
           row0, face_rows, smode):
    if smode != "sph":
        raise NotImplementedError(
            f"smode={smode!r}: cubemap/biatan6 source modes wait for "
            "the cubemap-source slice of the PyTorch port")
    if coeff.dtype != torch.float32:
        raise NotImplementedError(
            f"{coeff.dtype} coefficient tables wait for a later slice; "
            "the kernel takes float32")
    if tmode not in _TMODES:
        raise ValueError(f"unknown tmode {tmode!r}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside 0..{MAX_DEGREE}")
    if len(consts) != 11:
        raise ValueError("consts must be (kx, cx, ky, cy, gate_x, glx, "
                         "gux, gate_y, gly, guy, pad)")
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
    lib = _Library.get()
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts
    wmat = (ctypes.c_float * ((degree + 1) ** 2))(
        *_basis.weight_matrix(degree).reshape(-1).tolist())
    h, w, nch = out.shape
    hp, wp, _ = coeff.shape
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.envutil_resample_inline(
        out.data_ptr(), coeff.data_ptr(), xfeat.data_ptr(),
        yfeat.data_ptr(), bmats.data_ptr(), ctypes.cast(wmat,
                                                        ctypes.c_void_p),
        h, w, hp, wp, int(row0), int(face_rows), int(degree), int(nch),
        _TMODES[tmode], _GATES[gate_x], glx, gux, _GATES[gate_y], gly,
        guy, kx, cx, ky, cy, pad, stream)
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
                  row0: int = 0, face_rows: int = 0):
    """Padded spline coordinates (sx, sy) of every pixel of the window,
    as the kernel computes them (smode "sph")."""
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad) = consts
    rx, ry, rz = inline_rays(xfeat, yfeat, bmats, tmode=tmode, row0=row0,
                             face_rows=face_rows)
    lon = torch.atan2(rx, rz)
    lat = torch.atan2(ry, torch.sqrt(rx * rx + rz * rz))
    sx = _gate(lon * kx + cx, gate_x, glx, gux) + pad
    sy = _gate(lat * ky + cy, gate_y, gly, guy) + pad
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
                           consts=consts, row0=row0, face_rows=face_rows)
    table = S.Spline2D(coeff=coeff, pad=0, degree=degree,
                       bcs=(S.CONSTANT, S.CONSTANT),
                       core_shape=tuple(coeff.shape[:2]))
    out.copy_(S.eval_spline(table, sx, sy, apply_gate=False))
    return out
