"""ACES 1.x Output Transforms (SDR: RRT + ODT; HDR: SSTS), scene to
display.

The reference reaches tone-mapped ACES output through OIIO/OCIO when
the user's $OCIO config provides display views (README.md:322-399);
the ACES studio configs express those views as BuiltinTransform styles
``ACES-OUTPUT - ACES2065-1_to_CIE-XYZ-D65 - SDR-VIDEO_1.0`` /
``SDR-CINEMA_1.0`` followed by a ``DISPLAY - CIE-XYZ-D65_to_*``
encode. This module implements those two styles from the published
ACES 1.x CTL algorithm (RRT.ctl + the SDR ODTs + Tonescales.ctl):

- RRT sweeteners: glow module (yc-based, sigmoid-shaped by
  saturation), red modifier (cubic-basis hue window around 0 deg),
  AP1 global desaturation (factor 0.96)
- the segmented log-log tonescale splines (c5 for the RRC, c9 with
  the 48-nit knots for the SDR ODT)
- ODT finish: 0.02..48 cd/m2 range to display-linear CV, dim-surround
  compensation for VIDEO (gamma 0.9811 on yc; CINEMA is the dark
  reference surround - no adjustment), ODT desaturation 0.93, then
  AP1 -> CIE XYZ with a D60 -> D65 Bradford adaptation so the result
  composes with the DISPLAY encode styles in io/ocio.py.

The ACES 1.1 HDR Output Transforms (``HDR-VIDEO-*nit`` /
``HDR-CINEMA-108nit`` styles) are implemented below via the SSTS
(Single Stage Tone Scale) with the same RRT sweeteners; see the SSTS
section for its reconstruction provenance.

Forward only (the tone mapping intentionally crushes information; the
configs use these styles forward for display views). All constants are
the published CTL values; exactness versus OCIO's implementation is
unverifiable in this image (no PyOpenColorIO) - the tests pin the
documented anchors (18% grey to ~0.10 display linear / 15 cd/m2 on the
1000-nit HDR transform, monotone tonescales, neutrality preservation)
and the spline constants are cross-checked against the curve's own
geometric invariants (knot continuity, the 1.55 mid slope).
"""

from __future__ import annotations

import numpy as np

from . import colour as CL

# -- segmented spline tonescales (Tonescales.ctl) -----------------------

_M = 0.5 * np.array([[1.0, -2.0, 1.0],
                     [-2.0, 2.0, 0.0],
                     [1.0, 1.0, 0.0]])

# RRC (c5): minPoint, midPoint, maxPoint in (linear in, linear out).
# Constant integrity is verifiable from the curve's own geometry: a
# quadratic B-spline with N segments passes through (c[N]+c[N+1])/2 at
# its last knot with slope (c[N+1]-c[N])/knot_width. With N=3, the low
# half must end at log10(4.8) = 0.68124 with slope exactly 1.55 (the
# published mid slope, also the SSTS MID_PT slope) and the high half
# must start there with the same slope and end at log10(10000) = 4
# with slope 0 - all four hold for these values.
_C5_LO = np.array([-4.0, -4.0, -3.1573765773, -0.4852499958,
                   1.8477324706, 1.8477324706])
_C5_HI = np.array([-0.7185482425, 2.0810307172, 3.6681241237,
                   4.0, 4.0, 4.0])
_C5_MIN = (0.18 * 2.0 ** -15, 0.0001)
_C5_MID = (0.18, 4.8)
_C5_MAX = (0.18 * 2.0 ** 18, 10000.0)

# 48-nit ODT spline (c9)
_C9_LO = np.array([-1.6989700043, -1.6989700043, -1.4779000000,
                   -1.2291000000, -0.8648000000, -0.4480000000,
                   0.0051800000, 0.4511080334, 0.9113744414,
                   0.9113744414])
_C9_HI = np.array([0.5154386965, 0.8470437783, 1.1358000000,
                   1.3802000000, 1.5197000000, 1.5985000000,
                   1.6467000000, 1.6746091357, 1.6878733390,
                   1.6878733390])


def _segmented_spline(x, coefs_lo, coefs_hi, pmin, pmid, pmax,
                      slope_lo=0.0, slope_hi=0.0):
    """The CTL segmented_spline_c5/c9_fwd: quadratic B-spline in
    log10-log10 space between the knot points, linear extension with
    the given slopes outside.

    Segment count: the CTL evaluates N_KNOTS - 1 segments from
    N_KNOTS + 2 coefficients (segment j reads coefs[j..j+2]; the last
    coefficient is a spare duplicate), so n = len(coefs) - 3. Getting
    this wrong misplaces every interior knot and breaks C0 continuity
    at the mid point - e.g. c5 would evaluate to 2.79 instead of 4.8
    just below 0.18."""
    n_lo = len(coefs_lo) - 3
    n_hi = len(coefs_hi) - 3
    lx = np.log10(np.maximum(np.asarray(x, np.float64), 1e-10))
    lmin, lmid, lmax = (np.log10(pmin[0]), np.log10(pmid[0]),
                        np.log10(pmax[0]))

    def seg(lx, l0, l1, coefs, n):
        t = np.clip((lx - l0) / (l1 - l0) * n, 0.0, n - 1e-9)
        j = t.astype(np.int64)
        f = t - j
        cf = np.stack([np.take(coefs, j), np.take(coefs, j + 1),
                       np.take(coefs, j + 2)], axis=-1)
        mono = np.stack([f * f, f, np.ones_like(f)], axis=-1)
        return (mono * (cf @ _M.T)).sum(-1)

    lo_line = lx * slope_lo + (np.log10(pmin[1]) - slope_lo * lmin)
    hi_line = lx * slope_hi + (np.log10(pmax[1]) - slope_hi * lmax)
    ly = np.where(
        lx <= lmin, lo_line,
        np.where(lx < lmid, seg(lx, lmin, lmid, coefs_lo, n_lo),
                 np.where(lx < lmax, seg(lx, lmid, lmax, coefs_hi,
                                         n_hi),
                          hi_line)))
    return 10.0 ** ly


def rrc_tonescale(x):
    """segmented_spline_c5_fwd: the Reference Rendering Curve."""
    return _segmented_spline(x, _C5_LO, _C5_HI, _C5_MIN, _C5_MID,
                             _C5_MAX)


def odt48_tonescale(x):
    """segmented_spline_c9_fwd with the 48-nit ODT knots (the SDR
    video/cinema ODTs)."""
    pmin = (rrc_tonescale(0.18 * 2.0 ** -6.5), 0.02)
    pmid = (rrc_tonescale(0.18), 4.8)
    pmax = (rrc_tonescale(0.18 * 2.0 ** 6.5), 48.0)
    return _segmented_spline(x, _C9_LO, _C9_HI, pmin, pmid, pmax)


# -- RRT sweeteners (RRT.ctl) -------------------------------------------

def _rgb_2_saturation(rgb):
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    return (np.maximum(mx, 1e-10) - np.maximum(mn, 1e-10)) \
        / np.maximum(mx, 1e-2)


def _rgb_2_yc(rgb, radius_weight=1.75):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    chroma = np.sqrt(np.maximum(
        b * (b - g) + g * (g - r) + r * (r - b), 0.0))
    return (b + g + r + radius_weight * chroma) / 3.0


def _sigmoid_shaper(x):
    t = np.maximum(1.0 - np.abs(x / 2.0), 0.0)
    y = 1.0 + np.sign(x) * (1.0 - t * t)
    return y / 2.0


def _glow_fwd(yc_in, glow_gain_in, glow_mid):
    out = np.where(
        yc_in <= 2.0 / 3.0 * glow_mid, glow_gain_in,
        np.where(yc_in >= 2.0 * glow_mid, 0.0,
                 glow_gain_in * (glow_mid / np.maximum(yc_in, 1e-10)
                                 - 0.5)))
    return out


def _rgb_2_hue(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    flat = (r == g) & (g == b)
    hue = np.degrees(np.arctan2(np.sqrt(3.0) * (g - b),
                                2.0 * r - g - b))
    hue = np.where(flat, 0.0, hue)
    return np.where(hue < 0.0, hue + 360.0, hue)


def _center_hue(hue, center):
    c = hue - center
    c = np.where(c < -180.0, c + 360.0, c)
    return np.where(c > 180.0, c - 360.0, c)


def _cubic_basis_shaper(x, w):
    """The CTL cubic_basis_shaper: normalized cubic B-spline bump of
    full width w centered on 0."""
    m = np.array([[-1.0, 3.0, -3.0, 1.0],
                  [3.0, -6.0, 3.0, 0.0],
                  [-3.0, 0.0, 3.0, 0.0],
                  [1.0, 4.0, 1.0, 0.0]]) / 6.0
    knots = np.linspace(-w / 2.0, w / 2.0, 5)
    t = np.clip(x, knots[0], knots[-1])
    j = np.clip(((t - knots[0]) / (w / 4.0)).astype(np.int64), 0, 3)
    f = (t - knots[j]) / (w / 4.0)
    mono = np.stack([f ** 3, f ** 2, f, np.ones_like(f)], axis=-1)
    # coefficient vectors per span for the single centered bump
    cf = np.zeros(x.shape + (4,))
    coef = np.array([[0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 1.0, 0.0],
                     [0.0, 1.0, 0.0, 0.0],
                     [1.0, 0.0, 0.0, 0.0]])
    cf = coef[j]
    y = (mono * (cf @ m.T)).sum(-1) * 3.0 / 2.0
    return np.where(np.abs(x) > w / 2.0, 0.0, y)


_RRT_GLOW_GAIN = 0.05
_RRT_GLOW_MID = 0.08
_RRT_RED_SCALE = 0.82
_RRT_RED_PIVOT = 0.03
_RRT_RED_WIDTH = 135.0
_RRT_SAT = 0.96
_ODT_SAT = 0.93
_DIM_GAMMA = 0.9811

# AP1 luminance weights (the CTL RGB_2_Y for AP1)
_AP1_Y = np.array([0.2722287168, 0.6740817658, 0.0536895174])


def _ap0_to_ap1():
    return CL.conversion_matrix(CL.find_space("aces"),
                                CL.find_space("acescg"))


def _desat(rgb, weights, factor):
    y = (rgb * weights).sum(-1, keepdims=True)
    return y + factor * (rgb - y)


def rrt(aces):
    """The Reference Rendering Transform: ACES2065-1 (AP0, scene
    linear) -> OCES (AP0, display-intent linear). RRT.ctl semantics."""
    aces = np.asarray(aces, np.float64)
    # glow module
    sat = _rgb_2_saturation(aces)
    yc = _rgb_2_yc(aces)
    s = _sigmoid_shaper((sat - 0.4) / 0.2)
    added_glow = 1.0 + _glow_fwd(yc, _RRT_GLOW_GAIN * s,
                                 _RRT_GLOW_MID)
    aces = aces * added_glow[..., None]
    # red modifier
    hue = _rgb_2_hue(aces)
    centered = _center_hue(hue, 0.0)
    hue_w = _cubic_basis_shaper(centered, _RRT_RED_WIDTH)
    r = aces[..., 0]
    aces = aces.copy()
    aces[..., 0] = r + hue_w * sat * (_RRT_RED_PIVOT - r) \
        * (1.0 - _RRT_RED_SCALE)
    # to AP1, clamp, global desaturation
    aces = np.maximum(aces, 0.0)
    rgb_pre = np.maximum(aces @ _ap0_to_ap1().T, 0.0)
    rgb_pre = _desat(rgb_pre, _AP1_Y, _RRT_SAT)
    # tonescale per channel, back to AP0
    rgb_post = rrc_tonescale(rgb_pre)
    return rgb_post @ np.linalg.inv(_ap0_to_ap1()).T


# -- SSTS: the ACES 1.1+ Single Stage Tone Scale (SSTS.ctl) -------------
#
# The HDR Output Transforms (ACES 1.1) replace the fixed c5+c9 spline
# pair with one parameterized tone scale built from three anchor points
# (min, mid, max luminance). RECONSTRUCTION PROVENANCE: implemented
# from the published SSTS algorithm structure; the hardcoded CTL
# constants reproduced below are the SDR/RRT stop ranges
# (-6.5/+6.5, -15/+18), the luminance bounds (0.02/48, 0.0001/10000),
# the mid point (0.18 -> 4.8 cd/m2, slope 1.55) and the bend
# percentages (0.35 low, 0.89-0.90 high). Exactness versus a real OCIO
# build is unverifiable in this image (no PyOpenColorIO, no network);
# the tests pin the structural invariants (anchor points hit exactly,
# monotonicity, continuity) AND an independent anchor: the SSTS
# evaluated at the SDR parameters (0.02..48 nits) must track the
# legacy c9(c5(x)) composite it was designed to replace.

_SSTS_MIN_STOP_SDR = -6.5
_SSTS_MAX_STOP_SDR = 6.5
_SSTS_MIN_STOP_RRT = -15.0
_SSTS_MAX_STOP_RRT = 18.0
_SSTS_MIN_LUM_SDR = 0.02
_SSTS_MAX_LUM_SDR = 48.0
_SSTS_MIN_LUM_RRT = 0.0001
_SSTS_MAX_LUM_RRT = 10000.0
# bend percentage of the mid-segment spline knot, interpolated in
# stops-from-mid-grey (bendsLow / bendsHigh in SSTS.ctl)
_SSTS_BEND_LOW = ((_SSTS_MIN_STOP_RRT, 0.18),
                  (_SSTS_MIN_STOP_SDR, 0.35))
_SSTS_BEND_HIGH = ((_SSTS_MAX_STOP_SDR, 0.89),
                   (_SSTS_MAX_STOP_RRT, 0.90))


def _interp1(table, x):
    (x0, y0), (x1, y1) = table
    t = (np.clip(x, min(x0, x1), max(x0, x1)) - x0) / (x1 - x0)
    return y0 + t * (y1 - y0)


def _lookup_aces_min(min_lum):
    stops = _interp1(((np.log10(_SSTS_MIN_LUM_RRT), _SSTS_MIN_STOP_RRT),
                      (np.log10(_SSTS_MIN_LUM_SDR), _SSTS_MIN_STOP_SDR)),
                     np.log10(min_lum))
    return 0.18 * 2.0 ** stops


def _lookup_aces_max(max_lum):
    stops = _interp1(((np.log10(_SSTS_MAX_LUM_SDR), _SSTS_MAX_STOP_SDR),
                      (np.log10(_SSTS_MAX_LUM_RRT), _SSTS_MAX_STOP_RRT)),
                     np.log10(max_lum))
    return 0.18 * 2.0 ** stops


def _ssts_coefs(p0, p1, bend_table, bend_arg):
    """Quadratic B-spline coefficients (log10-log10 space) for one
    half of the tone scale, from anchor (x0, y0, slope0) to
    (x1, y1, slope1) over 3 equal knot spans; the middle coefficient
    bends by the interpolated percentage of the log-range."""
    (x0, y0, s0), (x1, y1, s1) = p0, p1
    lx0, ly0, lx1, ly1 = np.log10(x0), np.log10(y0), np.log10(x1), \
        np.log10(y1)
    inc = (lx1 - lx0) / 3.0
    c = np.empty(6)
    c[0] = s0 * (lx0 - 0.5 * inc) + (ly0 - s0 * lx0)
    c[1] = s0 * (lx0 + 0.5 * inc) + (ly0 - s0 * lx0)
    c[3] = s1 * (lx1 - 0.5 * inc) + (ly1 - s1 * lx1)
    c[4] = s1 * (lx1 + 0.5 * inc) + (ly1 - s1 * lx1)
    pct = _interp1(bend_table, bend_arg)
    c[2] = ly0 + pct * (ly1 - ly0)
    c[5] = c[4]
    return c


class SstsParams:
    """One SSTS instance: anchor points (in unshifted scene space),
    spline coefficients, and the exp-shift that aligns scene 0.18 with
    the requested mid luminance. ``__call__`` maps scene-linear values
    to display luminance in cd/m2."""

    def __init__(self, min_lum, mid_lum, max_lum):
        min_x = _lookup_aces_min(min_lum)
        max_x = _lookup_aces_max(max_lum)
        self.pmin = (min_x, min_lum, 0.0)
        self.pmid = (0.18, 4.8, 1.55)
        self.pmax = (max_x, max_lum, 0.0)
        self.c_lo = _ssts_coefs(self.pmin, self.pmid, _SSTS_BEND_LOW,
                                np.log2(min_x / 0.18))
        self.c_hi = _ssts_coefs(self.pmid, self.pmax, _SSTS_BEND_HIGH,
                                np.log2(max_x / 0.18))
        # expShift: scale the input so the requested mid luminance
        # lands exactly on scene 0.18 (outputTransform aligns Y_MID
        # with mid grey through the inverse of the unshifted curve)
        self.x_scale = 1.0
        self.x_scale = self._inverse(mid_lum) / 0.18
        self.min_lum, self.mid_lum, self.max_lum = (min_lum, mid_lum,
                                                    max_lum)

    def __call__(self, x):
        x = np.asarray(x, np.float64) * self.x_scale
        lx = np.log10(np.maximum(x, 1e-10))
        (x0, y0, s0) = self.pmin
        (x1, y1, s1) = self.pmid
        (x2, y2, s2) = self.pmax
        lx0, lx1, lx2 = np.log10(x0), np.log10(x1), np.log10(x2)

        def seg(lxv, l0, l1, coefs):
            t = np.clip((lxv - l0) / (l1 - l0) * 3.0, 0.0, 3.0 - 1e-9)
            j = t.astype(np.int64)
            f = t - j
            cf = np.stack([np.take(coefs, j), np.take(coefs, j + 1),
                           np.take(coefs, j + 2)], axis=-1)
            mono = np.stack([f * f, f, np.ones_like(f)], axis=-1)
            return (mono * (cf @ _M.T)).sum(-1)

        lo_line = lx * s0 + (np.log10(y0) - s0 * lx0)
        hi_line = lx * s2 + (np.log10(y2) - s2 * lx2)
        ly = np.where(
            lx <= lx0, lo_line,
            np.where(lx < lx1, seg(lx, lx0, lx1, self.c_lo),
                     np.where(lx < lx2, seg(lx, lx1, lx2, self.c_hi),
                              hi_line)))
        return 10.0 ** ly

    def _inverse(self, y):
        """Scalar inverse by bisection in log-x space (monotone curve;
        used once per transform construction to align mid grey)."""
        lo = np.log10(self.pmin[0]) - 1.0
        hi = np.log10(self.pmax[0]) + 1.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if float(self(10.0 ** mid)) < y:
                lo = mid
            else:
                hi = mid
        return 10.0 ** (0.5 * (lo + hi))


def ssts(x, min_lum=0.0001, mid_lum=15.0, max_lum=1000.0):
    """Single Stage Tone Scale: scene-linear AP1 channel value to
    display luminance in cd/m2."""
    return SstsParams(min_lum, mid_lum, max_lum)(x)


def output_transform_hdr(aces, y_min=0.0001, y_mid=15.0, y_max=1000.0,
                         limit_primaries="p3d65"):
    """ACES2065-1 -> CIE XYZ (D65-adapted) display-linear for the HDR
    output transforms (the ``ACES-OUTPUT - ACES2065-1_to_CIE-XYZ-D65 -
    HDR-VIDEO-*`` builtin styles): RRT sweeteners (glow, red modifier,
    AP1 desaturation) + SSTS tone scale + luminance-to-linCV +
    limiting-gamut clamp. No dim-surround or ODT desaturation step
    (the HDR transforms target the reference dark/dim PQ monitor
    directly). The returned XYZ follows the display-hub convention of
    io/ocio.py (1.0 == 100 cd/m2), so composing with ``DISPLAY -
    CIE-XYZ-D65_to_ST2084-*`` / ``REC.2100-PQ`` reproduces the intended
    absolute luminance on the PQ signal."""
    aces = np.asarray(aces, np.float64)
    tone = SstsParams(y_min, y_mid, y_max)
    # RRT sweeteners (shared with the SDR path)
    sat = _rgb_2_saturation(aces)
    yc = _rgb_2_yc(aces)
    s = _sigmoid_shaper((sat - 0.4) / 0.2)
    added_glow = 1.0 + _glow_fwd(yc, _RRT_GLOW_GAIN * s, _RRT_GLOW_MID)
    aces = aces * added_glow[..., None]
    hue = _rgb_2_hue(aces)
    centered = _center_hue(hue, 0.0)
    hue_w = _cubic_basis_shaper(centered, _RRT_RED_WIDTH)
    r = aces[..., 0]
    aces = aces.copy()
    aces[..., 0] = r + hue_w * sat * (_RRT_RED_PIVOT - r) \
        * (1.0 - _RRT_RED_SCALE)
    aces = np.maximum(aces, 0.0)
    rgb_pre = np.maximum(aces @ _ap0_to_ap1().T, 0.0)
    rgb_pre = _desat(rgb_pre, _AP1_Y, _RRT_SAT)
    # tone scale to absolute luminance, then normalized linear CV
    # (Y_2_linCV), limiting-gamut clamp, back to absolute cd/m2 and
    # the 100-nit-normalized XYZ hub
    rgb_post = tone(rgb_pre)
    cv = (rgb_post - y_min) / (y_max - y_min)
    prims, white = CL._PRIMARIES["ap1"]
    ap1_to_xyz = CL.bradford_adaptation(white, CL._D65) \
        @ CL.rgb_to_xyz_matrix(prims, white)
    lprims, lwhite = CL._PRIMARIES[limit_primaries]
    lim_to_xyz = CL.rgb_to_xyz_matrix(lprims, lwhite)
    if lwhite != CL._D65:
        lim_to_xyz = CL.bradford_adaptation(lwhite, CL._D65) \
            @ lim_to_xyz
    xyz_to_lim = np.linalg.inv(lim_to_xyz)
    lim = np.clip((cv @ ap1_to_xyz.T) @ xyz_to_lim.T, 0.0, 1.0)
    y_abs = lim * (y_max - y_min) + y_min
    xyz = (y_abs @ lim_to_xyz.T) / 100.0
    return xyz.astype(np.float32)


def output_transform_sdr(aces, surround="dim"):
    """ACES2065-1 -> CIE XYZ (D65-adapted) display-linear, the
    ``ACES-OUTPUT - ACES2065-1_to_CIE-XYZ-D65 - SDR-VIDEO_1.0``
    (surround='dim') / ``SDR-CINEMA_1.0`` (surround='dark') builtin
    styles: RRT + the 48-nit ODT, normalized to 0..1 display CV,
    ending at XYZ so a ``DISPLAY - CIE-XYZ-D65_to_*`` style finishes
    the chain."""
    oces = rrt(aces)
    rgb_pre = np.maximum(oces @ _ap0_to_ap1().T, 0.0)
    rgb_post = odt48_tonescale(rgb_pre)
    # luminance range to display-linear code values
    cv = (rgb_post - 0.02) / (48.0 - 0.02)
    if surround == "dim":
        # darkSurround_to_dimSurround: Y -> Y^gamma at constant
        # chromaticity (the CTL goes through xyY; scaling the CV
        # vector by Y^(gamma-1) is the same map)
        y = np.maximum((cv * _AP1_Y).sum(-1), 1e-10)
        cv = cv * (y ** (_DIM_GAMMA - 1.0))[..., None]
    cv = _desat(cv, _AP1_Y, _ODT_SAT)
    cv = np.clip(cv, 0.0, 1.0)
    # AP1 (D60) -> XYZ -> D65
    prims, white = CL._PRIMARIES["ap1"]
    m = CL.bradford_adaptation(white, CL._D65) \
        @ CL.rgb_to_xyz_matrix(prims, white)
    return (cv @ m.T).astype(np.float32)
