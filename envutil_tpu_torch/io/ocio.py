"""Minimal OpenColorIO config reader.

The reference delegates arbitrary colour spaces to OIIO's OCIO
integration: when the ``$OCIO`` environment variable points at a
config, facet/output colour space names are resolved through it
(envutil_main.cc:396-437, README.md:322-399). PyOpenColorIO is not
installable in this image, so this module parses the (YAML) config
directly and implements the algebraic transform subset that covers
matrix/primaries-based configs:

- ``MatrixTransform`` (matrix + offset, with direction=inverse)
- ``ExponentTransform``
- ``ExponentWithLinearTransform`` (the sRGB-style piecewise curve)
- ``RangeTransform`` (scale + offset form)
- ``CDLTransform`` (slope / offset / power / saturation)
- ``LogTransform`` / ``LogAffineTransform`` / ``LogCameraTransform``
  (the camera-log family: lin-side affine + log-side affine, with the
  linear segment below linSideBreak)
- ``GroupTransform`` (children applied in order)
- ``ColorSpaceTransform`` (src -> dst through the reference)
- ``BuiltinTransform`` for the ACES config registry styles: the
  camera "*_to_ACES2065-1" family (ARRI LogC3/LogC4, Sony S-Log3
  S-Gamut3/.Cine, Canon CLog2, Panasonic V-Log, RED Log3G10, the
  ACEScc/cct/cg trio), curve-only styles, the CIE-XYZ-D65 display
  hub, and the SDR ACES Output Transforms (RRT + 48-nit ODT,
  io/aces.py) - resolved through io/colour.py's derived-matrix
  spaces
- ``GradingPrimaryTransform`` (log / linear / video styles, RGBM
  controls, pivots, saturation, clamp) with exact inverses
- ``GradingRGBCurveTransform`` (monotone spline through the control
  points per channel + master, numeric inverse)
- ``GradingToneTransform`` (five smooth zone controls + s_contrast;
  documented-shape approximation, identity at defaults)
- ``FileTransform`` LUT files: .cube (1D and 3D), .spi1d, .spi3d -
  resolved against the config's ``search_path``; 1D inverse via the
  monotone table, 3D trilinear forward + Newton-refined numeric
  inverse

Unsupported kinds raise a specific error naming the colour space, so
the failure mode is loud and actionable rather than a silent
fallback.

Conversion model (OCIO v1 and v2 dialects): every colour space
declares ``to_reference``/``from_reference`` (v1) or
``to_scene_reference``/``from_scene_reference`` (v2) - one of the two
suffices, the other is the inverse. ``roles:`` and ``aliases`` are
resolved to canonical names.
"""

from __future__ import annotations

import math
import os
import re
from typing import Callable, Dict, List, Optional

import numpy as np

_F = Callable[[np.ndarray], np.ndarray]


class OcioError(ValueError):
    pass


def _chain(fns: List[_F]) -> _F:
    def f(a):
        for fn in fns:
            a = fn(a)
        return a
    return f


def _matrix_fn(spec: dict, invert: bool) -> _F:
    m = np.asarray(spec.get("matrix",
                            np.eye(4).ravel().tolist()),
                   np.float64).reshape(4, 4)
    off = np.asarray(spec.get("offset", [0, 0, 0, 0]),
                     np.float64)
    m3 = m[:3, :3]
    o3 = off[:3]
    if invert:
        mi = np.linalg.inv(m3)

        def f(a):
            return ((a - o3.astype(np.float32))
                    @ mi.T.astype(np.float32)).astype(np.float32)
        return f

    def f(a):
        return (a @ m3.T.astype(np.float32)
                + o3.astype(np.float32)).astype(np.float32)
    return f


def _exponent_fn(spec: dict, invert: bool) -> _F:
    g = np.asarray(spec.get("value", [1, 1, 1, 1]),
                   np.float64)[:3].astype(np.float32)
    e = (1.0 / g) if invert else g

    def f(a):
        return np.sign(a) * np.abs(a) ** e
    return f


def _exponent_linear_fn(spec: dict, invert: bool) -> _F:
    """ExponentWithLinearTransform (monCurve): linear segment below
    the break, power above - the sRGB/rec709 curve family. The spec's
    gamma/offset define the *decoding* (encoded -> linear) when the
    style is the usual 'curve forward' (OCIO's mirrored variants are
    not distinguished here)."""
    g = float(np.asarray(spec.get("gamma", [2.4] * 4),
                         np.float64).ravel()[0])
    o = float(np.asarray(spec.get("offset", [0.0] * 4),
                         np.float64).ravel()[0])
    # monCurve per OCIO: y = (x + o)/(1 + o)) ** g for x >= break,
    # y = x * s below, with break xb = o / (g - 1),
    # s = ((g - 1) / o) * ((o * g) / ((g - 1) * (1 + o))) ** g
    if o <= 0.0:
        return _exponent_fn({"value": [g] * 4}, invert)
    xb = o / (g - 1.0)
    s = (((g - 1.0) / o)
         * ((o * g) / ((g - 1.0) * (1.0 + o))) ** g)
    yb = xb * s

    def fwd(x):
        x = np.asarray(x, np.float32)
        hi = ((np.clip(x, xb, None) + o) / (1.0 + o)) ** g
        return np.where(x < xb, x * s, hi).astype(np.float32)

    def inv(y):
        y = np.asarray(y, np.float32)
        hi = (np.clip(y, yb, None) ** (1.0 / g)) * (1.0 + o) - o
        return np.where(y < yb, y / s, hi).astype(np.float32)

    return inv if invert else fwd


def _range_fn(spec: dict, invert: bool) -> _F:
    lo_in = float(spec.get("min_in_value", 0.0))
    hi_in = float(spec.get("max_in_value", 1.0))
    lo_out = float(spec.get("min_out_value", 0.0))
    hi_out = float(spec.get("max_out_value", 1.0))
    scale = (hi_out - lo_out) / (hi_in - lo_in)
    if invert:
        def f(a):
            return ((a - lo_out) / scale + lo_in).astype(np.float32)
        return f

    def f(a):
        return ((a - lo_in) * scale + lo_out).astype(np.float32)
    return f


_CDL_LUMA = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def _saturate(a: np.ndarray, sat: float) -> np.ndarray:
    luma = (a[..., :3] * _CDL_LUMA).sum(axis=-1, keepdims=True)
    return (luma + sat * (a - luma)).astype(np.float32)


def _cdl_fn(spec: dict, invert: bool) -> _F:
    sl = np.asarray(spec.get("slope", [1, 1, 1]), np.float32)
    of = np.asarray(spec.get("offset", [0, 0, 0]), np.float32)
    pw = np.asarray(spec.get("power", [1, 1, 1]), np.float32)
    sat = float(spec.get("sat", spec.get("saturation", 1.0)))
    if invert:
        def f(a):
            # ASC CDL inverse: un-saturate (Rec709 luma weights per
            # the CDL spec), then invert power / offset / slope
            if sat != 1.0:
                a = _saturate(a, 1.0 / sat)
            return ((np.clip(a, 0, None) ** (1.0 / pw) - of)
                    / sl).astype(np.float32)
        return f

    def f(a):
        out = (np.clip(a * sl + of, 0, None) ** pw).astype(np.float32)
        return _saturate(out, sat) if sat != 1.0 else out
    return f


def _log_affine_params(spec: dict):
    base = float(spec.get("base", 2.0))
    ls = np.asarray(spec.get("log_side_slope",
                             spec.get("logSideSlope", [1, 1, 1])),
                    np.float32)[:3]
    lo = np.asarray(spec.get("log_side_offset",
                             spec.get("logSideOffset", [0, 0, 0])),
                    np.float32)[:3]
    ns = np.asarray(spec.get("lin_side_slope",
                             spec.get("linSideSlope", [1, 1, 1])),
                    np.float32)[:3]
    no = np.asarray(spec.get("lin_side_offset",
                             spec.get("linSideOffset", [0, 0, 0])),
                    np.float32)[:3]
    return base, ls, lo, ns, no


def _log_affine_fn(spec: dict, invert: bool) -> _F:
    """LogAffineTransform: log = logSideSlope * log_base(linSideSlope
    * lin + linSideOffset) + logSideOffset (OCIO v2)."""
    base, ls, lo, ns, no = _log_affine_params(spec)
    lb = math.log(base)

    def lin_to_log(a):
        lin = np.maximum(a * ns + no, 1e-10)
        return (ls * (np.log(lin) / lb) + lo).astype(np.float32)

    def log_to_lin(a):
        return ((base ** ((a - lo) / ls) - no) / ns).astype(np.float32)

    # to_reference direction of a log space is log->lin ("forward"
    # per OCIO applies lin->log)
    return log_to_lin if invert else lin_to_log


def _log_camera_fn(spec: dict, invert: bool) -> _F:
    """LogCameraTransform: LogAffine plus a linear segment below
    linSideBreak with slope/intercept continuous at the break (the
    camera-log family: LogC, S-Log, etc., OCIO v2)."""
    base, ls, lo, ns, no = _log_affine_params(spec)
    lb = math.log(base)
    br = np.asarray(spec.get("lin_side_break",
                             spec.get("linSideBreak", [0, 0, 0])),
                    np.float32)[:3]
    # log value and derivative at the break
    log_br = ls * (np.log(np.maximum(ns * br + no, 1e-10)) / lb) + lo
    lslope = spec.get("linear_slope", spec.get("linearSlope"))
    if lslope is None:
        # continuous derivative at the break
        lin_slope = ls * ns / ((ns * br + no) * lb)
    else:
        lin_slope = np.asarray(lslope, np.float32)[:3] * np.ones(
            3, np.float32)
    lin_off = log_br - lin_slope * br

    def lin_to_log(a):
        lin = np.maximum(a * ns + no, 1e-10)
        logv = ls * (np.log(lin) / lb) + lo
        return np.where(a <= br, lin_slope * a + lin_off,
                        logv).astype(np.float32)

    def log_to_lin(a):
        lin = (base ** ((a - lo) / ls) - no) / ns
        seg = (a - lin_off) / lin_slope
        return np.where(a <= log_br, seg, lin).astype(np.float32)

    return log_to_lin if invert else lin_to_log


# -- BuiltinTransform styles -------------------------------------------
# The ACES OCIO configs (cg-config / studio-config) express nearly every
# colour space as BuiltinTransforms, so supporting the registry styles
# is what makes real-world $OCIO configs resolvable. Three families:
#
#  * "<camera>_to_ACES2065-1": camera-log decode + gamut->AP0 matrix.
#    Realized through io/colour.py's camera spaces (curves from the
#    vendor whitepapers, matrices derived from primaries; colour.py
#    uses Bradford adaptation where the official IDTs use CAT02 -
#    ~1e-3 of the gamut matrix, well under visible).
#  * "UTILITY - ACES-AP0/AP1_to_CIE-XYZ-D65_BFD" + "DISPLAY -
#    CIE-XYZ-D65_to_<display>": the display-pipeline hub.
#  * curve-only styles ("CURVE - ...-LOG_to_LINEAR").
#
# Styles not in the tables raise OcioError naming the style (loud, not
# silent). The ACES Output Transforms live in io/aces.py: SDR (RRT +
# 48-nit ODT, published CTL constants) and the SSTS-based HDR-VIDEO /
# HDR-CINEMA styles (reconstructed from the published SSTS algorithm;
# provenance + anchors documented in io/aces.py). ADX10/ADX16 (film
# densitometry) remain absent: their CID->relative-log-exposure table
# is published only as data (S-2014-006) unobtainable in this image.

# style -> colour.py space name; forward = that space -> ACES2065-1
_BUILTIN_TO_ACES = {
    "ACESCCT_TO_ACES2065-1": "acescct",
    "ACESCC_TO_ACES2065-1": "acescc",
    "ACESCG_TO_ACES2065-1": "acescg",
    "ARRI_ALEXA-LOGC-EI800-AWG_TO_ACES2065-1": "logc3",
    "ARRI_LOGC4_TO_ACES2065-1": "logc4",
    "SONY_SLOG3-SGAMUT3_TO_ACES2065-1": "slog3",
    "SONY_SLOG3-SGAMUT3.CINE_TO_ACES2065-1": "slog3.cine",
    "CANON_CLOG2-CGAMUT_TO_ACES2065-1": "clog2",
    "PANASONIC_VLOG-VGAMUT_TO_ACES2065-1": "vlog",
    "RED_LOG3G10-RWG_TO_ACES2065-1": "log3g10",
    "UTILITY - SRGB-TEXTURE_TO_ACES2065-1": "srgb",
    "UTILITY - LINEAR-SRGB_TO_ACES2065-1": "lin_srgb",
    "UTILITY - LINEAR-REC.709_TO_ACES2065-1": "lin_rec709",
    "UTILITY - LINEAR-REC.2020_TO_ACES2065-1": "lin_rec2020",
    "UTILITY - LINEAR-P3-D65_TO_ACES2065-1": "lin_p3d65",
}

# curve-only styles -> colour.py transfer name; forward = log -> linear
_BUILTIN_CURVES = {
    "CURVE - ACESCCT-LOG_TO_LINEAR": "acescct",
    "CURVE - ACESCC-LOG_TO_LINEAR": "acescc",
    "CURVE - ARRI_LOGC3-LOG_TO_LINEAR": "logc3",
    "CURVE - ARRI_LOGC4-LOG_TO_LINEAR": "logc4",
    "CURVE - SONY_SLOG3-LOG_TO_LINEAR": "slog3",
    "CURVE - CANON_CLOG2-LOG_TO_LINEAR": "clog2",
    "CURVE - PANASONIC_VLOG-LOG_TO_LINEAR": "vlog",
    "CURVE - RED_LOG3G10-LOG_TO_LINEAR": "log3g10",
}

# display hub: linear AP0/AP1 -> CIE XYZ (D65-adapted), and XYZ-D65 ->
# display encodings. gamut=None means XYZ itself.
_BUILTIN_XYZ_HUB = {
    "UTILITY - ACES-AP0_TO_CIE-XYZ-D65_BFD": ("ap0", None),
    "UTILITY - ACES-AP1_TO_CIE-XYZ-D65_BFD": ("ap1", None),
    "DISPLAY - CIE-XYZ-D65_TO_SRGB": (None, ("rec709", "srgb")),
    "DISPLAY - CIE-XYZ-D65_TO_REC.1886-REC.709": (None,
                                                  ("rec709", "g24")),
    "DISPLAY - CIE-XYZ-D65_TO_G2.2-REC.709": (None, ("rec709", "g22")),
    "DISPLAY - CIE-XYZ-D65_TO_DISPLAYP3": (None, ("p3d65", "srgb")),
    "DISPLAY - CIE-XYZ-D65_TO_G2.6-P3-D65": (None, ("p3d65", "g26")),
    "DISPLAY - CIE-XYZ-D65_TO_REC.2100-PQ": (None, ("rec2020", "pq")),
    "DISPLAY - CIE-XYZ-D65_TO_REC.2100-HLG": (None,
                                              ("rec2020", "hlg")),
    "DISPLAY - CIE-XYZ-D65_TO_ST2084-P3-D65": (None, ("p3d65", "pq")),
}

# SMPTE ST 2084 (PQ) constants; display linear 1.0 == 100 cd/m2 (the
# OCIO display-style convention), PQ codes absolute 0..10000 cd/m2
_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0


def _pq_encode(v):
    y = np.clip(np.asarray(v, np.float64) * 100.0 / 10000.0, 0.0, 1.0)
    ym = y ** _PQ_M1
    return (((_PQ_C1 + _PQ_C2 * ym) / (1.0 + _PQ_C3 * ym)) ** _PQ_M2
            ).astype(np.float32)


def _pq_decode(v):
    e = np.clip(np.asarray(v, np.float64), 0.0, 1.0) ** (1.0 / _PQ_M2)
    y = (np.maximum(e - _PQ_C1, 0.0) / (_PQ_C2 - _PQ_C3 * e)) \
        ** (1.0 / _PQ_M1)
    return (y * 10000.0 / 100.0).astype(np.float32)


# ITU-R BT.2100 HLG (scene-referred OETF form; display linear 1.0 maps
# to HLG signal 1.0)
_HLG_A = 0.17883277
_HLG_B = 1.0 - 4.0 * _HLG_A
_HLG_C = 0.5 - _HLG_A * math.log(4.0 * _HLG_A)


def _hlg_encode(v):
    v = np.clip(np.asarray(v, np.float64), 0.0, None)
    lo = np.sqrt(3.0 * v)
    hi = _HLG_A * np.log(np.maximum(12.0 * v - _HLG_B, 1e-10)) + _HLG_C
    return np.where(v <= 1.0 / 12.0, lo, hi).astype(np.float32)


def _hlg_decode(v):
    v = np.asarray(v, np.float64)
    lo = (v * v) / 3.0
    hi = (np.exp((v - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
    return np.where(v <= 0.5, lo, hi).astype(np.float32)

# legacy loose names kept from the first version of this module:
# decode-to-linear only (no reference-space hop)
_BUILTIN_STYLES = {
    "UTILITY - SRGB - TEXTURE": "sRGB",
    "SRGB - TEXTURE": "sRGB",
    "DISPLAY - SRGB": "sRGB",
    "CURVE - SRGB": "sRGB",
}


def _builtin_fn(style: str, inv: bool, name: str) -> _F:
    from . import colour as CL
    from . import imgio
    style = style.upper()
    space = _BUILTIN_TO_ACES.get(style)
    if space is not None:
        src, dst = (("aces2065-1", space) if inv
                    else (space, "aces2065-1"))
        return lambda a: CL.convert(a, src, dst)
    curve = _BUILTIN_CURVES.get(style)
    if curve is not None:
        dec, enc = CL._TRANSFERS[curve]
        fn = enc if inv else dec
        return lambda a: np.asarray(fn(np.asarray(a, np.float32)),
                                    np.float32)
    hub = _BUILTIN_XYZ_HUB.get(style)
    if hub is not None:
        gamut, display = hub
        if gamut is not None:
            # linear gamut RGB -> CIE XYZ adapted to D65
            prims, white = CL._PRIMARIES[gamut]
            m = CL.rgb_to_xyz_matrix(prims, white)
            if white != CL._D65:
                m = CL.bradford_adaptation(white, CL._D65) @ m
            if inv:
                m = np.linalg.inv(m)
            m = m.astype(np.float32)
            return lambda a: (a @ m.T).astype(np.float32)
        dgamut, transfer = display
        prims, white = CL._PRIMARIES[dgamut]
        minv = np.linalg.inv(CL.rgb_to_xyz_matrix(prims, white)
                             ).astype(np.float32)
        if transfer == "g26":
            enc = lambda v: np.sign(v) * np.abs(v) ** (1.0 / 2.6)
            dec = lambda v: np.sign(v) * np.abs(v) ** 2.6
        elif transfer == "pq":
            dec, enc = _pq_decode, _pq_encode
        elif transfer == "hlg":
            dec, enc = _hlg_decode, _hlg_encode
        else:
            dec, enc = CL._TRANSFERS[transfer]
        if inv:
            mfwd = np.linalg.inv(minv)
            return lambda a: (np.asarray(dec(np.asarray(a, np.float32)),
                                         np.float32) @ mfwd.T
                              ).astype(np.float32)
        return lambda a: np.asarray(
            enc((a @ minv.T).astype(np.float32)), np.float32)
    if style.startswith("ACES-OUTPUT - ACES2065-1_TO_CIE-XYZ-D65"):
        surround = ("dark" if "SDR-CINEMA" in style
                    else "dim" if "SDR-VIDEO" in style else None)
        if surround is not None:
            if inv:
                raise OcioError(
                    f"{name}: the ACES output transform is forward "
                    "only (tone mapping is not invertible here)")
            from . import aces as AC
            return lambda a: AC.output_transform_sdr(a, surround)
        m = re.search(r"HDR-(VIDEO|CINEMA)-(\d+)NIT-([\d.]+)NIT-"
                      r"(P3|REC2020)LIM", style)
        if m is not None:
            if inv:
                raise OcioError(
                    f"{name}: the ACES output transform is forward "
                    "only (tone mapping is not invertible here)")
            from . import aces as AC
            y_max = float(m.group(2))
            y_mid = float(m.group(3))
            lim = "p3d65" if m.group(4) == "P3" else "rec2020"
            return lambda a: AC.output_transform_hdr(
                a, y_min=0.0001, y_mid=y_mid, y_max=y_max,
                limit_primaries=lim)
    legacy = _BUILTIN_STYLES.get(style)
    if legacy is not None:
        if inv:
            return lambda a: imgio.linear_to_srgb(a)
        return lambda a: imgio.srgb_to_linear(a)
    raise OcioError(
        f"{name}: BuiltinTransform style {style!r} is not "
        "supported by the built-in OCIO subset")


def _read_lut_file(path: str):
    """Parse a LUT file into ``("1d", domain, (N, C) table)`` or
    ``("3d", domain, (N, N, N, 3) table)``. Supports .cube
    (LUT_1D_SIZE / LUT_3D_SIZE, DOMAIN_MIN/MAX; red fastest),
    .spi1d (From/Length/Components) and .spi3d (SPILUT; explicit
    i j k indices)."""
    ext = os.path.splitext(path)[1].lower()
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if ext == ".cube":
        n1 = n3 = 0
        dmin = np.zeros(3, np.float32)
        dmax = np.ones(3, np.float32)
        rows = []
        for ln in lines:
            u = ln.split()
            key = u[0].upper()
            if key == "LUT_1D_SIZE":
                n1 = int(u[1])
            elif key == "LUT_3D_SIZE":
                n3 = int(u[1])
            elif key == "DOMAIN_MIN":
                dmin = np.asarray([float(v) for v in u[1:4]],
                                  np.float32)
            elif key == "DOMAIN_MAX":
                dmax = np.asarray([float(v) for v in u[1:4]],
                                  np.float32)
            elif key in ("TITLE", "LUT_1D_INPUT_RANGE",
                         "LUT_3D_INPUT_RANGE"):
                if key.endswith("INPUT_RANGE"):
                    dmin = np.full(3, float(u[1]), np.float32)
                    dmax = np.full(3, float(u[2]), np.float32)
            else:
                rows.append([float(v) for v in u[:3]])
        tbl = np.asarray(rows, np.float32)
        if n3:
            if tbl.shape[0] != n3 ** 3:
                raise OcioError(f"{path}: expected {n3 ** 3} rows")
            # .cube stores red fastest: index order (b, g, r)
            return ("3d", (dmin, dmax),
                    tbl.reshape(n3, n3, n3, 3))
        if not n1:
            raise OcioError(f"{path}: no LUT_1D_SIZE/LUT_3D_SIZE")
        if tbl.shape[0] != n1:
            raise OcioError(f"{path}: expected {n1} rows")
        return ("1d", (dmin, dmax), tbl)
    if ext == ".spi1d":
        dmin = np.zeros(3, np.float32)
        dmax = np.ones(3, np.float32)
        rows = []
        in_body = False
        for ln in lines:
            low = ln.lower()
            if low.startswith("from:"):
                a, b = ln.split()[1:3]
                dmin = np.full(3, float(a), np.float32)
                dmax = np.full(3, float(b), np.float32)
            elif ln == "{":
                in_body = True
            elif ln == "}":
                in_body = False
            elif in_body:
                rows.append([float(v) for v in ln.split()])
        tbl = np.asarray(rows, np.float32)
        return ("1d", (dmin, dmax), tbl)
    if ext == ".spi3d":
        dims = None
        entries = []
        for ln in lines[1:]:  # skip "SPILUT 1.0"
            u = ln.split()
            if len(u) == 2:
                continue  # "3 3" components line
            if len(u) == 3 and dims is None:
                dims = (int(u[0]), int(u[1]), int(u[2]))
                continue
            if len(u) >= 6:
                entries.append([float(v) for v in u[:6]])
        if dims is None:
            raise OcioError(f"{path}: no dimensions line")
        tbl = np.zeros(dims + (3,), np.float32)
        for i, j, k, r, g, b in entries:
            tbl[int(i), int(j), int(k)] = (r, g, b)
        dmin = np.zeros(3, np.float32)
        dmax = np.ones(3, np.float32)
        # spi3d stores blue fastest with (r, g, b) indices: transpose
        # to the .cube convention (b, g, r) used by _lut3d_fn
        return ("3d", (dmin, dmax), tbl.transpose(2, 1, 0, 3))
    raise OcioError(f"{path}: unsupported LUT format {ext!r}")


def _lut1d_fn(domain, tbl: np.ndarray, invert: bool) -> _F:
    dmin, dmax = domain
    n, c = tbl.shape

    def fwd(a):
        out = np.empty_like(a, np.float32)
        for ch in range(a.shape[-1] if a.ndim else 1):
            col = tbl[:, min(ch, c - 1)]
            x = np.linspace(dmin[min(ch, 2)], dmax[min(ch, 2)], n)
            out[..., ch] = np.interp(a[..., ch], x, col)
        return out

    def inv(a):
        out = np.empty_like(a, np.float32)
        for ch in range(a.shape[-1] if a.ndim else 1):
            col = tbl[:, min(ch, c - 1)]
            x = np.linspace(dmin[min(ch, 2)], dmax[min(ch, 2)], n)
            if not (np.all(np.diff(col) >= 0)):
                raise OcioError("inverse Lut1D needs a monotonically "
                                "increasing table")
            out[..., ch] = np.interp(a[..., ch], col, x)
        return out

    return inv if invert else fwd


def _lut3d_inverse_fn(domain, tbl: np.ndarray) -> _F:
    """Inverse of a 3D LUT: coarse-grid nearest seed + damped Newton
    refinement on the trilinear forward (finite-difference Jacobian).
    Robust for the invertible (locally one-to-one) LUTs an inverse
    makes sense for; out-of-gamut queries converge to the nearest
    representable point. OCIO proper uses exact cell search - this is
    a numeric equivalent, accurate to ~1e-4 on smooth LUTs."""
    fwd = _lut3d_fn(domain, tbl, False)
    dmin, dmax = domain
    # coarse seed lattice in the input domain
    m = 17
    g = np.linspace(0.0, 1.0, m, dtype=np.float32)
    rr, gg, bb = np.meshgrid(g, g, g, indexing="ij")
    seeds_in = (np.stack([rr, gg, bb], -1).reshape(-1, 3)
                * (dmax - dmin) + dmin).astype(np.float32)
    seeds_out = fwd(seeds_in)
    eps = np.float32((dmax - dmin).max() * 1e-3)

    def _solve(flat):
        # nearest seed in output space
        d2 = ((flat[:, None, :] - seeds_out[None, :, :]) ** 2).sum(-1)
        x = seeds_in[np.argmin(d2, axis=1)].copy()
        for _ in range(8):
            r = fwd(x) - flat
            # finite-difference Jacobian columns
            jac = np.stack(
                [(fwd(x + eps * np.eye(3, dtype=np.float32)[k])
                  - fwd(x - eps * np.eye(3, dtype=np.float32)[k]))
                 / (2 * eps) for k in range(3)], axis=-1)
            try:
                step = np.linalg.solve(jac, r[..., None])[..., 0]
            except np.linalg.LinAlgError:
                step = r  # singular cell: gradient-ish fallback
            x = np.clip(x - 0.8 * step, dmin, dmax)
        return x

    def f(a):
        y = np.asarray(a, np.float32)
        flat = y.reshape(-1, 3)
        out = np.empty_like(flat)
        for i in range(0, flat.shape[0], 16384):
            out[i:i + 16384] = _solve(flat[i:i + 16384])
        return out.reshape(y.shape).astype(np.float32)
    return f


def _lut3d_fn(domain, tbl: np.ndarray, invert: bool) -> _F:
    if invert:
        return _lut3d_inverse_fn(domain, tbl)
    dmin, dmax = domain
    n = tbl.shape[0]

    def f(a):
        rgb = np.asarray(a, np.float32)
        t = (rgb - dmin) / np.maximum(dmax - dmin, 1e-20) * (n - 1)
        t = np.clip(t, 0.0, n - 1)
        i0 = np.minimum(t.astype(np.int32), n - 2)
        fr = t - i0
        r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
        fr_r = fr[..., 0:1]
        fr_g = fr[..., 1:2]
        fr_b = fr[..., 2:3]
        # table index order (b, g, r): trilinear blend
        out = np.zeros(rgb.shape, np.float32)
        for db in (0, 1):
            for dg in (0, 1):
                for dr in (0, 1):
                    w = ((fr_b if db else 1.0 - fr_b)
                         * (fr_g if dg else 1.0 - fr_g)
                         * (fr_r if dr else 1.0 - fr_r))
                    out += w * tbl[b0 + db, g0 + dg, r0 + dr]
        return out

    return f


# -- grading transforms (OCIO v2 dynamic grading family) ----------------
# Semantics follow the public OCIO v2 documentation of
# GradingPrimary/GradingRGBCurve/GradingTone. PyOpenColorIO cannot be
# installed in this image, so bit-exactness against the OCIO scalar
# kernels is unverifiable here; every control reduces to identity at
# its default, inverses round-trip, and the formulas are the documented
# ones (primary) or documented-shape monotone approximations (tone,
# curve interpolation uses monotone PCHIP where OCIO fits monotone
# B-splines).

def _rgbm(body: dict, key: str, default: float, mult: bool
          ) -> np.ndarray:
    """An RGBM grading control: per-channel rgb combined with a master
    (multiplicative for gain-like controls, additive for offset-like
    ones). Accepts {rgb: [...], master: m}, a flat [r,g,b,m] list, or
    a scalar."""
    v = body.get(key)
    if v is None:
        return np.full(3, default, np.float32)
    if isinstance(v, dict):
        rgb = np.asarray(v.get("rgb", [default] * 3),
                         np.float64)[:3]
        m = float(v.get("master", default))
    elif isinstance(v, (list, tuple)):
        u = list(v) + [default] * 4
        rgb = np.asarray(u[:3], np.float64)
        m = float(u[3])
    else:
        rgb = np.full(3, default, np.float64)
        m = float(v)
    out = rgb * m if mult else rgb + m
    return out.astype(np.float32)


_GRADE_LUMA = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def _grade_saturate(a: np.ndarray, sat: float) -> np.ndarray:
    if sat == 1.0:
        return a
    luma = (a[..., :3] * _GRADE_LUMA).sum(axis=-1, keepdims=True)
    return (luma + sat * (a - luma)).astype(np.float32)


def _clamp(a: np.ndarray, cb, cw) -> np.ndarray:
    if cb is None and cw is None:
        return np.asarray(a, np.float32)
    return np.clip(a, cb, cw).astype(np.float32)


def _grading_primary_fn(body: dict, invert: bool) -> _F:
    """GradingPrimaryTransform. Styles:
      log:    out = (in + brightness*6.25/1023 - P)*contrast + P with
              P = 0.5 + pivot/2, then gamma as a power between
              pivot black/white; brightness additive, contrast/gamma
              multiplicative RGBM.
      linear: out = in*2^exposure + offset, contrast as a signed power
              around 0.18*2^pivot.
      video:  lift/gamma/gain between pivot black/white plus offset.
    All styles end with saturation (Rec709 luma) and the optional
    clamp."""
    style = str(body.get("style", "log")).lower()
    sat = float(body.get("saturation", 1.0))
    clamp = body.get("clamp") or {}
    cb = clamp.get("black")
    cw = clamp.get("white")
    piv = body.get("pivot")
    if isinstance(piv, dict):
        p_c = float(piv.get("contrast", 0.18 if style == "linear"
                            else 0.0))
        p_b = float(piv.get("black", 0.0))
        p_w = float(piv.get("white", 1.0))
    else:
        p_c = float(piv) if piv is not None else (
            0.18 if style == "linear" else 0.0)
        p_b, p_w = 0.0, 1.0

    def _pow_signed(x, e):
        return np.sign(x) * np.abs(x) ** e

    if style == "linear":
        expo = _rgbm(body, "exposure", 0.0, mult=False)
        off = _rgbm(body, "offset", 0.0, mult=False)
        con = np.maximum(_rgbm(body, "contrast", 1.0, mult=True), 0.01)
        pivot = 0.18 * 2.0 ** p_c
        scale = (2.0 ** expo).astype(np.float32)

        def fwd(a):
            out = a * scale + off
            if np.any(con != 1.0):
                out = _pow_signed(out / pivot, con) * pivot
            out = _grade_saturate(out.astype(np.float32), sat)
            return _clamp(out, cb, cw)

        def inv(a):
            out = _grade_saturate(np.asarray(a, np.float32),
                                  1.0 / sat if sat != 0 else 1.0)
            if np.any(con != 1.0):
                out = _pow_signed(out / pivot, 1.0 / con) * pivot
            return ((out - off) / scale).astype(np.float32)

        return inv if invert else fwd

    if style == "video":
        lift = _rgbm(body, "lift", 0.0, mult=False)
        gain = np.maximum(_rgbm(body, "gain", 1.0, mult=True), 1e-4)
        gam = np.maximum(_rgbm(body, "gamma", 1.0, mult=True), 0.01)
        off = _rgbm(body, "offset", 0.0, mult=False)
        rng = p_w - p_b

        def fwd(a):
            n = (np.asarray(a, np.float32) - p_b) / rng
            n = n * gain + lift
            if np.any(gam != 1.0):
                n = _pow_signed(n, 1.0 / gam)
            out = n * rng + p_b + off
            out = _grade_saturate(out.astype(np.float32), sat)
            return _clamp(out, cb, cw)

        def inv(a):
            out = _grade_saturate(np.asarray(a, np.float32),
                                  1.0 / sat if sat != 0 else 1.0)
            n = (out - off - p_b) / rng
            if np.any(gam != 1.0):
                n = _pow_signed(n, gam)
            n = (n - lift) / gain
            return (n * rng + p_b).astype(np.float32)

        return inv if invert else fwd

    # log style (the default)
    bri = _rgbm(body, "brightness", 0.0, mult=False) * (6.25 / 1023.0)
    con = np.maximum(_rgbm(body, "contrast", 1.0, mult=True), 0.01)
    gam = np.maximum(_rgbm(body, "gamma", 1.0, mult=True), 0.01)
    pivot = 0.5 + p_c * 0.5
    rng = p_w - p_b

    def _pow_signed2(x, e):
        return np.sign(x) * np.abs(x) ** e

    def fwd(a):
        out = np.asarray(a, np.float32) + bri
        out = (out - pivot) * con + pivot
        if np.any(gam != 1.0):
            n = (out - p_b) / rng
            out = _pow_signed2(n, 1.0 / gam) * rng + p_b
        out = _grade_saturate(out.astype(np.float32), sat)
        return _clamp(out, cb, cw)

    def inv(a):
        out = _grade_saturate(np.asarray(a, np.float32),
                              1.0 / sat if sat != 0 else 1.0)
        if np.any(gam != 1.0):
            n = (out - p_b) / rng
            out = _pow_signed2(n, gam) * rng + p_b
        out = (out - pivot) / con + pivot
        return (out - bri).astype(np.float32)

    return inv if invert else fwd


def _pchip_fn(pts: np.ndarray):
    """Monotone piecewise-cubic through the control points with linear
    extension beyond the ends (scipy PCHIP; OCIO fits monotone
    B-splines - same knots, same monotonicity, C1)."""
    from scipy.interpolate import PchipInterpolator
    x, y = pts[:, 0], pts[:, 1]
    ip = PchipInterpolator(x, y, extrapolate=False)
    d = ip.derivative()
    s0 = float(d(x[0]))
    s1 = float(d(x[-1]))

    def f(v):
        v = np.asarray(v, np.float64)
        out = ip(np.clip(v, x[0], x[-1]))
        out = np.where(v < x[0], y[0] + (v - x[0]) * s0, out)
        out = np.where(v > x[-1], y[-1] + (v - x[-1]) * s1, out)
        return out.astype(np.float32)
    return f


def _curve_from_spec(spec) -> Optional[np.ndarray]:
    if spec is None:
        return None
    if isinstance(spec, dict):
        cp = spec.get("control_points")
    else:
        cp = spec
    if cp is None:
        return None
    pts = np.asarray(cp, np.float64).reshape(-1, 2)
    if pts.shape[0] < 2:
        return None
    order = np.argsort(pts[:, 0])
    return pts[order]


def _invert_monotone(fn, lo: float = -4.0, hi: float = 16.0,
                     n: int = 8192):
    """Numeric inverse of a monotone-increasing scalar curve via a
    dense sample + linear interp (the grading curves are monotone by
    construction)."""
    xs = np.linspace(lo, hi, n)
    ys = fn(xs)
    if not np.all(np.diff(ys) >= -1e-7):
        raise OcioError("inverse grading curve needs a monotonically "
                        "increasing forward curve")
    ys = np.maximum.accumulate(ys)

    def f(v):
        return np.interp(np.asarray(v, np.float32), ys,
                         xs).astype(np.float32)
    return f


def _grading_rgbcurve_fn(body: dict, invert: bool) -> _F:
    """GradingRGBCurveTransform: per-channel red/green/blue curves then
    a master curve on all channels, each a monotone spline through its
    control points."""
    curves = {k: _curve_from_spec(body.get(k))
              for k in ("red", "green", "blue", "master")}
    fns = {k: (_pchip_fn(p) if p is not None else None)
           for k, p in curves.items()}
    if invert:
        fns = {k: (_invert_monotone(f) if f is not None else None)
               for k, f in fns.items()}

    chan = [fns["red"], fns["green"], fns["blue"]]
    master = fns["master"]

    def fwd(a):
        out = np.array(a, np.float32, copy=True)
        for c, f in enumerate(chan):
            if f is not None:
                out[..., c] = f(out[..., c])
        if master is not None:
            out = master(out)
        return np.asarray(out, np.float32)

    def inv(a):
        out = np.array(a, np.float32, copy=True)
        if master is not None:
            out = master(out)  # already inverted above
        for c, f in enumerate(chan):
            if f is not None:
                out[..., c] = f(out[..., c])
        return np.asarray(out, np.float32)

    return inv if invert else fwd


def _zone_w(x, start: float, width: float, kind: str) -> np.ndarray:
    """Smooth zone weight: 1 inside the zone, cubic fade across
    [start, start+width] (lows fade out upward, highs fade in upward,
    mids are a raised bump around the center)."""
    if kind == "low":
        t = np.clip((x - start) / max(width, 1e-6), 0.0, 1.0)
        return 1.0 - t * t * (3.0 - 2.0 * t)
    if kind == "high":
        t = np.clip((x - start) / max(width, 1e-6), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)
    # mid bump centered on start with half-width width
    t = np.clip(np.abs(x - start) / max(width, 1e-6), 0.0, 1.0)
    return 1.0 - t * t * (3.0 - 2.0 * t)


def _tone_zone(body: dict, key: str, d_start: float, d_width: float,
               kind: str):
    v = body.get(key)
    if v is None:
        return None
    if isinstance(v, dict):
        rgb = np.asarray(v.get("rgb", [1.0] * 3), np.float64)[:3]
        m = float(v.get("master", 1.0))
        start = float(v.get("start", v.get("center", d_start)))
        width = float(v.get("width", d_width))
    else:
        rgb = np.full(3, 1.0, np.float64)
        m = float(v)
        start, width = d_start, d_width
    g = (rgb * m).astype(np.float32)
    if np.all(g == 1.0):
        return None
    return (g, start, width, kind)


def _grading_tone_fn(body: dict, invert: bool) -> _F:
    """GradingToneTransform: five zone controls (blacks / shadows /
    midtones / highlights / whites, RGBM each with start/width or
    center/width) plus s_contrast. Implemented as smooth zone-weighted
    gains around the documented default zone layout and a weighted
    mid-pivot contrast - identity at defaults, monotone for the
    documented value range (0.1..1.9), inverses via dense numeric
    inversion per channel. The OCIO scalar kernel's exact spline knots
    are not replicated (see module docstring)."""
    zones = [z for z in (
        _tone_zone(body, "blacks", 0.0, 0.4, "low"),
        _tone_zone(body, "shadows", 0.2, 0.5, "low"),
        _tone_zone(body, "midtones", 0.4, 0.4, "mid"),
        _tone_zone(body, "highlights", 0.3, 0.5, "high"),
        _tone_zone(body, "whites", 0.5, 0.5, "high"),
    ) if z is not None]
    sc = float(body.get("s_contrast", 1.0))

    def fwd(a):
        out = np.asarray(a, np.float32)
        for g, start, width, kind in zones:
            w = _zone_w(out, start, width, kind)
            # zone gain blended to identity outside the zone; lows
            # apply (1 + (g-1)*w) as a slope on (x - zone floor) so
            # black stays pinned only for the high zones
            out = out * (1.0 + w * (g - 1.0) * 0.5) \
                + w * (g - 1.0) * 0.05 * (1.0 if kind == "low" else 0.0)
        if sc != 1.0:
            pivot = 0.4
            w = np.exp(-((out - pivot) ** 2) / (2 * 0.16))
            out = out + (sc - 1.0) * (out - pivot) * w * 0.5
        return out.astype(np.float32)

    if not invert:
        return fwd

    # per-channel numeric inverse (tone ops are per-channel monotone)
    def inv(a):
        a = np.asarray(a, np.float32)
        out = np.empty_like(a)
        for c in range(a.shape[-1]):
            ch_fwd = lambda x: fwd(
                np.repeat(np.asarray(x, np.float32)[..., None], 3,
                          axis=-1))[..., c]
            out[..., c] = _invert_monotone(ch_fwd)(a[..., c])
        return out

    return inv


class OcioConfig:
    """Parsed subset of an OCIO YAML config."""

    def __init__(self, doc: dict, path: str = "<config>"):
        self.path = path
        base = os.path.dirname(os.path.abspath(path))
        sp = doc.get("search_path") or "."
        if isinstance(sp, str):
            sp = sp.split(":")
        self.search_dirs = [os.path.join(base, str(p)) for p in sp]
        self.search_dirs.append(base)
        self._luts: Dict[str, tuple] = {}
        self.roles: Dict[str, str] = {
            str(k).lower(): str(v)
            for k, v in (doc.get("roles") or {}).items()}
        self.spaces: Dict[str, dict] = {}
        self.aliases: Dict[str, str] = {}
        for cs in doc.get("colorspaces") or []:
            if isinstance(cs, dict) and "!<ColorSpace>" in cs:
                cs = cs["!<ColorSpace>"] or {}
            name = str(cs.get("name", ""))
            if not name:
                continue
            self.spaces[name] = cs
            self.aliases[name.lower()] = name
            for al in cs.get("aliases") or []:
                self.aliases[str(al).lower()] = name

    # -- name resolution ------------------------------------------
    def resolve(self, name: str) -> Optional[str]:
        if name in self.spaces:
            return name
        low = name.lower()
        if low in self.aliases:
            return self.aliases[low]
        if low in self.roles:
            return self.resolve(self.roles[low])
        return None

    # -- transform compilation ------------------------------------
    def _compile(self, spec, invert: bool, name: str) -> _F:
        if spec is None:
            return lambda a: a
        if isinstance(spec, list):
            fns = [self._compile(s, invert, name) for s in spec]
            if invert:
                fns = fns[::-1]
            return _chain(fns)
        if not isinstance(spec, dict):
            raise OcioError(f"{name}: unsupported transform {spec!r}")
        if len(spec) == 1 and next(iter(spec)).startswith("!<"):
            tag = next(iter(spec))
            body = spec[tag] or {}
            kind = tag[2:-1]
        else:
            kind = str(spec.get("transform", ""))
            body = spec
        body = dict(body)
        dir_inv = str(body.get("direction", "forward")) == "inverse"
        inv = invert != dir_inv
        if kind == "GroupTransform":
            children = body.get("children") or []
            fns = [self._compile(c, invert, name) for c in children]
            if invert:
                fns = fns[::-1]
            return _chain(fns)
        if kind == "MatrixTransform":
            return _matrix_fn(body, inv)
        if kind == "ExponentTransform":
            return _exponent_fn(body, inv)
        if kind == "ExponentWithLinearTransform":
            return _exponent_linear_fn(body, inv)
        if kind == "RangeTransform":
            return _range_fn(body, inv)
        if kind == "CDLTransform":
            return _cdl_fn(body, inv)
        if kind == "LogAffineTransform":
            return _log_affine_fn(body, inv)
        if kind == "LogCameraTransform":
            return _log_camera_fn(body, inv)
        if kind == "LogTransform":
            base = float(body.get("base", 2.0))
            return _log_affine_fn({"base": base}, inv)
        if kind == "ColorSpaceTransform":
            src = self.resolve(str(body.get("src", "")))
            dst = self.resolve(str(body.get("dst", "")))
            if src is None or dst is None:
                raise OcioError(f"{name}: ColorSpaceTransform with "
                                f"unknown spaces {body!r}")
            if inv:
                src, dst = dst, src
            return lambda a: self.apply(a, src, dst)
        if kind == "FileTransform":
            fname = str(body.get("src", ""))
            lut = self._luts.get(fname)
            if lut is None:
                for d in self.search_dirs:
                    cand = os.path.join(d, fname)
                    if os.path.exists(cand):
                        lut = self._luts[fname] = _read_lut_file(cand)
                        break
                else:
                    raise OcioError(f"{name}: LUT file {fname!r} not "
                                    f"found under {self.search_dirs}")
            kind_l, domain, tbl = lut
            if kind_l == "1d":
                return _lut1d_fn(domain, tbl, inv)
            return _lut3d_fn(domain, tbl, inv)
        if kind == "BuiltinTransform":
            return _builtin_fn(str(body.get("style", "")), inv, name)
        if kind == "GradingPrimaryTransform":
            return _grading_primary_fn(body, inv)
        if kind == "GradingRGBCurveTransform":
            return _grading_rgbcurve_fn(body, inv)
        if kind == "GradingToneTransform":
            return _grading_tone_fn(body, inv)
        raise OcioError(
            f"{name}: transform {kind!r} is not supported by the "
            "built-in OCIO subset")

    def to_reference(self, name: str) -> _F:
        cs = self.spaces[name]
        spec = (cs.get("to_reference")
                or cs.get("to_scene_reference"))
        if spec is not None:
            return self._compile(spec, False, name)
        spec = (cs.get("from_reference")
                or cs.get("from_scene_reference"))
        if spec is not None:
            return self._compile(spec, True, name)
        return lambda a: a  # the reference space itself

    def from_reference(self, name: str) -> _F:
        cs = self.spaces[name]
        spec = (cs.get("from_reference")
                or cs.get("from_scene_reference"))
        if spec is not None:
            return self._compile(spec, False, name)
        spec = (cs.get("to_reference")
                or cs.get("to_scene_reference"))
        if spec is not None:
            return self._compile(spec, True, name)
        return lambda a: a

    def apply(self, arr: np.ndarray, src: str, dst: str) -> np.ndarray:
        out = np.asarray(arr, np.float32)
        if src != dst:
            out = self.to_reference(src)(out)
            out = self.from_reference(dst)(out)
        return np.asarray(out, np.float32)


def _load_yaml(text: str) -> dict:
    """PyYAML with OCIO's custom ``!<Type>`` tags mapped to
    ``{"!<Type>": value}`` wrappers (safe_load rejects unknown
    tags)."""
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    def _tagged(loader, tag_suffix, node):
        # ``!<Name>`` is YAML verbatim-tag syntax: the parsed tag is
        # the bare Name; re-wrap it in the OCIO spelling
        if isinstance(node, yaml.MappingNode):
            val = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            val = loader.construct_sequence(node, deep=True)
        else:
            val = loader.construct_scalar(node)
            if val == "":
                val = {}
        tag = tag_suffix.lstrip("!")
        return {f"!<{tag}>": val}

    yaml.add_multi_constructor(None, _tagged, Loader=_Loader)
    return yaml.load(text, Loader=_Loader)


_CACHE: Dict[str, Optional[OcioConfig]] = {}


def active_config() -> Optional[OcioConfig]:
    """The config named by $OCIO, parsed once (None if unset/bad)."""
    path = os.environ.get("OCIO", "")
    if not path:
        return None
    if path not in _CACHE:
        try:
            with open(path) as f:
                doc = _load_yaml(f.read())
            _CACHE[path] = OcioConfig(doc, path)
        except Exception as e:  # bad config: remember the failure
            import sys
            print(f"warning: cannot parse OCIO config {path}: {e}",
                  file=sys.stderr)
            _CACHE[path] = None
    return _CACHE[path]


def convert(arr: np.ndarray, src: str, dst: str
            ) -> Optional[np.ndarray]:
    """Convert through the active $OCIO config; None if there is no
    config or it does not know both spaces. Raises OcioError when the
    spaces are known but use unsupported transform kinds."""
    cfg = active_config()
    if cfg is None:
        return None
    s = cfg.resolve(src)
    d = cfg.resolve(dst)
    if s is None or d is None:
        return None
    return cfg.apply(arr, s, d)
