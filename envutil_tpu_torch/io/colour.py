"""Built-in colour space conversions.

The reference delegates colour management to OpenImageIO/OCIO
(README.md:322-399: in/working/output colour spaces, default working
space scene_linear). PyOpenColorIO is optional here; this module
provides the standard RGB colour spaces self-contained so the common
conversions work everywhere: matrices are *derived* from primaries and
white points (not hard-coded), with Bradford chromatic adaptation
between white points, plus the standard transfer functions.

Space names follow OCIO/ACES conventions with the aliases the
reference's ecosystems (lux, hugin) use. A space is (primaries, white,
transfer): conversion = decode -> RGB-to-XYZ -> adapt white -> XYZ-to-
RGB -> encode.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

# chromaticities (x, y) and white points
_D65 = (0.3127, 0.3290)
_D60 = (0.32168, 0.33767)  # ACES white

_PRIMARIES = {
    "rec709": (((0.64, 0.33), (0.30, 0.60), (0.15, 0.06)), _D65),
    "rec2020": (((0.708, 0.292), (0.170, 0.797), (0.131, 0.046)), _D65),
    "p3d65": (((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)), _D65),
    "ap1": (((0.713, 0.293), (0.165, 0.830), (0.128, 0.044)), _D60),
    "ap0": (((0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.0770)), _D60),
    # camera-native gamuts (vendor whitepaper chromaticities); these
    # back the camera-log spaces below and the OCIO BuiltinTransform
    # camera styles in io/ocio.py
    "awg3": (((0.6840, 0.3130), (0.2210, 0.8480),
              (0.0861, -0.1020)), _D65),
    "awg4": (((0.7347, 0.2653), (0.1424, 0.8576),
              (0.0991, -0.0308)), _D65),
    "sgamut3": (((0.730, 0.280), (0.140, 0.855),
                 (0.100, -0.050)), _D65),
    "sgamut3cine": (((0.766, 0.275), (0.225, 0.800),
                     (0.089, -0.087)), _D65),
    "cgamut": (((0.740, 0.270), (0.170, 1.140),
                (0.080, -0.100)), _D65),
    "rwg": (((0.780308, 0.304253), (0.121595, 1.493994),
             (0.095612, -0.084589)), _D65),
    "vgamut": (((0.730, 0.280), (0.165, 0.840),
                (0.100, -0.030)), _D65),
}

# Bradford cone-response matrix (the standard CAT02 predecessor used
# by ICC/OCIO for white adaptation)
_BRADFORD = np.array([[0.8951, 0.2664, -0.1614],
                      [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]])


def _xy_to_xyz(xy) -> np.ndarray:
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def rgb_to_xyz_matrix(prims, white) -> np.ndarray:
    """Derive the RGB->XYZ matrix from primaries + white (the standard
    construction: scale primary columns so white maps to the white
    point's XYZ)."""
    cols = np.stack([_xy_to_xyz(p) / _xy_to_xyz(p)[1] for p in prims],
                    axis=1)
    # solve for the per-primary scales
    s = np.linalg.solve(cols, _xy_to_xyz(white))
    return cols * s[None, :]


def bradford_adaptation(src_white, dst_white) -> np.ndarray:
    """XYZ-to-XYZ Bradford chromatic adaptation matrix."""
    sw = _BRADFORD @ _xy_to_xyz(src_white)
    dw = _BRADFORD @ _xy_to_xyz(dst_white)
    return np.linalg.inv(_BRADFORD) @ np.diag(dw / sw) @ _BRADFORD


# -- transfer functions ------------------------------------------------

def _srgb_decode(v):
    return np.where(v <= 0.04045, v / 12.92,
                    ((np.abs(v) + 0.055) / 1.055) ** 2.4 * np.sign(v))


def _srgb_encode(v):
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.clip(v, 0, None) ** (1.0 / 2.4) - 0.055)


def _g22_decode(v):
    return np.sign(v) * np.abs(v) ** 2.2


def _g22_encode(v):
    return np.sign(v) * np.abs(v) ** (1.0 / 2.2)


def _rec709_decode(v):
    # BT.709 camera OETF inverse
    return np.where(v < 0.081, v / 4.5,
                    ((np.abs(v) + 0.099) / 1.099) ** (1.0 / 0.45))


def _rec709_encode(v):
    return np.where(v < 0.018, 4.5 * v,
                    1.099 * np.clip(v, 0, None) ** 0.45 - 0.099)


# -- camera log transfer functions -------------------------------------
# Each pair is (decode: log-encoded -> scene-linear, encode: inverse),
# with the vendor whitepaper constants. Anchors used by the tests:
# S-Log3(0.18) = 420/1023, LogC3(0.18) = 0.391007, Log3G10(0.18) = 1/3,
# V-Log(0.18) = 0.4233, ACEScct(0.18) = 0.41359.

def _acescc_encode(v):
    v = np.asarray(v, np.float32)
    lo = (np.log2(np.float32(2.0 ** -16)
                  + np.clip(v, 0, None) * 0.5) + 9.72) / 17.52
    hi = (np.log2(np.maximum(v, np.float32(2.0 ** -15))) + 9.72) / 17.52
    return np.where(v < 2.0 ** -15, lo, hi).astype(np.float32)


def _acescc_decode(v):
    v = np.asarray(v, np.float32)
    yb = (9.72 - 15.0) / 17.52
    p = np.exp2(v * 17.52 - 9.72)
    return np.where(v <= yb, (p - 2.0 ** -16) * 2.0,
                    p).astype(np.float32)


_ACESCCT_XB = 0.0078125
_ACESCCT_YB = 0.155251141552511
_ACESCCT_S = 10.5402377416545
_ACESCCT_O = 0.0729055341958355


def _acescct_encode(v):
    v = np.asarray(v, np.float32)
    hi = (np.log2(np.maximum(v, np.float32(_ACESCCT_XB))) + 9.72) / 17.52
    return np.where(v <= _ACESCCT_XB,
                    v * _ACESCCT_S + _ACESCCT_O, hi).astype(np.float32)


def _acescct_decode(v):
    v = np.asarray(v, np.float32)
    return np.where(v <= _ACESCCT_YB, (v - _ACESCCT_O) / _ACESCCT_S,
                    np.exp2(v * 17.52 - 9.72)).astype(np.float32)


# ARRI LogC3 (EI 800, ALEXA v3 whitepaper)
_LOGC3 = dict(cut=0.010591, a=5.555556, b=0.052272, c=0.247190,
              d=0.385537, e=5.367655, f=0.092809)


def _logc3_encode(v):
    p = _LOGC3
    v = np.asarray(v, np.float32)
    hi = p["c"] * np.log10(np.maximum(p["a"] * v + p["b"], 1e-10)) \
        + p["d"]
    return np.where(v > p["cut"], hi,
                    p["e"] * v + p["f"]).astype(np.float32)


def _logc3_decode(v):
    p = _LOGC3
    v = np.asarray(v, np.float32)
    ycut = p["e"] * p["cut"] + p["f"]
    hi = (10.0 ** ((v - p["d"]) / p["c"]) - p["b"]) / p["a"]
    return np.where(v > ycut, hi, (v - p["f"]) / p["e"]
                    ).astype(np.float32)


# ARRI LogC4 (whitepaper closed form)
_LC4_A = (2.0 ** 18 - 16.0) / 117.45
_LC4_B = (1023.0 - 95.0) / 1023.0
_LC4_C = 95.0 / 1023.0
_LC4_S = (7.0 * math.log(2.0)
          * 2.0 ** (7.0 - 14.0 * _LC4_C / _LC4_B)) / (_LC4_A * _LC4_B)
_LC4_T = (2.0 ** (14.0 * (-_LC4_C / _LC4_B) + 6.0) - 64.0) / _LC4_A


def _logc4_encode(v):
    v = np.asarray(v, np.float32)
    hi = (np.log2(np.maximum(_LC4_A * v + 64.0, 1e-10)) - 6.0) \
        / 14.0 * _LC4_B + _LC4_C
    return np.where(v < _LC4_T, (v - _LC4_T) / _LC4_S,
                    hi).astype(np.float32)


def _logc4_decode(v):
    v = np.asarray(v, np.float32)
    hi = (np.exp2(14.0 * (v - _LC4_C) / _LC4_B + 6.0) - 64.0) / _LC4_A
    return np.where(v < 0.0, v * _LC4_S + _LC4_T, hi).astype(np.float32)


# Sony S-Log3 (Sony technical summary)
_SL3_YB = 171.2102946929 / 1023.0


def _slog3_encode(v):
    v = np.asarray(v, np.float32)
    hi = (420.0 + np.log10(np.maximum(v + 0.01125, 1e-10)
                           / (0.18 + 0.01125)) * 261.5) / 1023.0
    lo = (v * (171.2102946929 - 95.0) / 0.01125 + 95.0) / 1023.0
    return np.where(v >= 0.01125, hi, lo).astype(np.float32)


def _slog3_decode(v):
    v = np.asarray(v, np.float32)
    hi = 10.0 ** ((v * 1023.0 - 420.0) / 261.5) * (0.18 + 0.01125) \
        - 0.01125
    lo = (v * 1023.0 - 95.0) * 0.01125 / (171.2102946929 - 95.0)
    return np.where(v >= _SL3_YB, hi, lo).astype(np.float32)


# RED Log3G10 (v2 constants)
_L3G = dict(a=0.224282, b=155.975327, c=0.01, g=15.1927)


def _log3g10_encode(v):
    p = _L3G
    v = np.asarray(v, np.float32) + p["c"]
    return np.where(v < 0.0, v * p["g"],
                    p["a"] * np.log10(np.clip(v, 0, None) * p["b"]
                                      + 1.0)).astype(np.float32)


def _log3g10_decode(v):
    p = _L3G
    v = np.asarray(v, np.float32)
    hi = (10.0 ** (v / p["a"]) - 1.0) / p["b"]
    return (np.where(v < 0.0, v / p["g"], hi)
            - p["c"]).astype(np.float32)


# Panasonic V-Log (V-Log/V-Gamut reference manual)
def _vlog_encode(v):
    v = np.asarray(v, np.float32)
    hi = 0.241514 * np.log10(np.maximum(v + 0.00873, 1e-10)) + 0.598206
    return np.where(v < 0.01, 5.6 * v + 0.125, hi).astype(np.float32)


def _vlog_decode(v):
    v = np.asarray(v, np.float32)
    hi = 10.0 ** ((v - 0.598206) / 0.241514) - 0.00873
    return np.where(v < 0.181, (v - 0.125) / 5.6, hi).astype(np.float32)


# Canon Log 2 (Canon whitepaper; mirrored negative branch)
_CL2 = dict(a=87.09937546, c=0.24136077, b=0.092864125)


def _clog2_encode(v):
    p = _CL2
    v = np.asarray(v, np.float32)
    pos = p["c"] * np.log10(np.clip(v, 0, None) * p["a"] + 1.0) + p["b"]
    neg = -p["c"] * np.log10(1.0 - np.clip(v, None, 0) * p["a"]) \
        + p["b"]
    return np.where(v < 0.0, neg, pos).astype(np.float32)


def _clog2_decode(v):
    p = _CL2
    v = np.asarray(v, np.float32)
    pos = (10.0 ** (np.clip(v - p["b"], 0, None) / p["c"]) - 1.0) \
        / p["a"]
    neg = (1.0 - 10.0 ** (-np.clip(v - p["b"], None, 0) / p["c"])) \
        / p["a"]
    return np.where(v < p["b"], neg, pos).astype(np.float32)


_IDENT = (None, None)
_TRANSFERS = {
    "linear": _IDENT,
    "srgb": (_srgb_decode, _srgb_encode),
    "g22": (_g22_decode, _g22_encode),
    "rec709": (_rec709_decode, _rec709_encode),
    "g24": (lambda v: np.sign(v) * np.abs(v) ** 2.4,
            lambda v: np.sign(v) * np.abs(v) ** (1.0 / 2.4)),
    "acescc": (_acescc_decode, _acescc_encode),
    "acescct": (_acescct_decode, _acescct_encode),
    "logc3": (_logc3_decode, _logc3_encode),
    "logc4": (_logc4_decode, _logc4_encode),
    "slog3": (_slog3_decode, _slog3_encode),
    "log3g10": (_log3g10_decode, _log3g10_encode),
    "vlog": (_vlog_decode, _vlog_encode),
    "clog2": (_clog2_decode, _clog2_encode),
}


class Space:
    def __init__(self, gamut: str, transfer: str):
        self.gamut = gamut
        self.transfer = transfer


# canonical name -> Space; aliases lower-cased
_SPACES: Dict[str, Space] = {
    "scene_linear": Space("rec709", "linear"),
    "linear": Space("rec709", "linear"),
    "lin_rec709": Space("rec709", "linear"),
    "lin_srgb": Space("rec709", "linear"),
    "srgb": Space("rec709", "srgb"),
    "srgb_texture": Space("rec709", "srgb"),
    "g22_rec709": Space("rec709", "g22"),
    "gamma2.2": Space("rec709", "g22"),
    "rec709": Space("rec709", "rec709"),
    "bt.709": Space("rec709", "rec709"),
    "lin_rec2020": Space("rec2020", "linear"),
    "lin_p3d65": Space("p3d65", "linear"),
    "lin_displayp3": Space("p3d65", "linear"),
    "acescg": Space("ap1", "linear"),
    "lin_ap1": Space("ap1", "linear"),
    "aces2065-1": Space("ap0", "linear"),
    "aces": Space("ap0", "linear"),
    "lin_ap0": Space("ap0", "linear"),
    "rec1886": Space("rec709", "g24"),
    "rec.1886": Space("rec709", "g24"),
    # camera-native log spaces (curve + gamut per the vendor specs);
    # aliases follow the ACES/OCIO config naming habits
    "acescct": Space("ap1", "acescct"),
    "acescc": Space("ap1", "acescc"),
    "logc3": Space("awg3", "logc3"),
    "arri logc3 (ei800)": Space("awg3", "logc3"),
    "alexa logc ei800": Space("awg3", "logc3"),
    "logc4": Space("awg4", "logc4"),
    "arri logc4": Space("awg4", "logc4"),
    "slog3": Space("sgamut3", "slog3"),
    "s-log3 s-gamut3": Space("sgamut3", "slog3"),
    "slog3.cine": Space("sgamut3cine", "slog3"),
    "s-log3 s-gamut3.cine": Space("sgamut3cine", "slog3"),
    "log3g10": Space("rwg", "log3g10"),
    "red log3g10": Space("rwg", "log3g10"),
    "vlog": Space("vgamut", "vlog"),
    "v-log": Space("vgamut", "vlog"),
    "clog2": Space("cgamut", "clog2"),
    "canon clog2": Space("cgamut", "clog2"),
    "lin_awg3": Space("awg3", "linear"),
    "lin_awg4": Space("awg4", "linear"),
    "lin_sgamut3": Space("sgamut3", "linear"),
    "lin_sgamut3cine": Space("sgamut3cine", "linear"),
    "lin_cgamut": Space("cgamut", "linear"),
    "lin_rwg": Space("rwg", "linear"),
    "lin_vgamut": Space("vgamut", "linear"),
}


def find_space(name: str) -> Space | None:
    return _SPACES.get(name.strip().lower())


def known(name: str) -> bool:
    return find_space(name) is not None


def conversion_matrix(src: Space, dst: Space) -> np.ndarray:
    """Linear-RGB to linear-RGB gamut matrix (with white adaptation)."""
    sp, sw = _PRIMARIES[src.gamut]
    dp, dw = _PRIMARIES[dst.gamut]
    m = rgb_to_xyz_matrix(sp, sw)
    if sw != dw:
        m = bradford_adaptation(sw, dw) @ m
    return np.linalg.inv(rgb_to_xyz_matrix(dp, dw)) @ m


def convert(arr: np.ndarray, src_name: str, dst_name: str
            ) -> np.ndarray:
    """Convert (..., 3) float RGB between two known spaces."""
    src = find_space(src_name)
    dst = find_space(dst_name)
    if src is None or dst is None:
        raise KeyError(src_name if src is None else dst_name)
    out = np.asarray(arr, np.float32)
    dec = _TRANSFERS[src.transfer][0]
    if dec is not None:
        out = dec(out)
    if src.gamut != dst.gamut:
        m = conversion_matrix(src, dst).astype(np.float32)
        out = out @ m.T
    enc = _TRANSFERS[dst.transfer][1]
    if enc is not None:
        out = enc(out)
    return np.asarray(out, np.float32)
