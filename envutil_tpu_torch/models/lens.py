"""PTO lens correction: the panotools a/b/c radial polynomial, its
inverse (LUT-spline approximation), and the combined planar transform
(lens polynomial + shift + shear).

Counterpart of envutil_tpu/models/lens.py (lens_correction.h:
eu_polynomial:85, lcp:224, inverse_lcp:273-404; pto_planar,
environment.h:240-318). The forward polynomial runs inline in the
pixel pipeline. The inverse is precomputed on the host in float64
(Newton iteration sampled over nonlinearly spaced knots), stored as a
small cubic spline LUT of radius *scaling factors*, and evaluated with
``ops/spline.eval_spline`` on the device of the radii it is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import spline as S


def lcp_scale(r, a: float, b: float, c: float):
    """Radial scaling factor a r^3 + b r^2 + c r + d with
    d = 1 - (a+b+c), applied to radii in unit-radius units
    (lens_correction.h:224-235). Horner form."""
    d = 1.0 - (a + b + c)
    return ((a * r + b) * r + c) * r + d


def _poly4(r, a, b, c):
    """The scaled-radius polynomial p(r) = r * lcp_scale(r) - a 4th
    degree polynomial through the origin (lens_correction.h:277-283)."""
    d = 1.0 - (a + b + c)
    return (((a * r + b) * r + c) * r + d) * r


def _poly4_deriv(r, a, b, c):
    d = 1.0 - (a + b + c)
    return ((4 * a * r + 3 * b) * r + 2 * c) * r + d


@dataclasses.dataclass
class InverseLcp:
    """Inverse radial scaling: for an lcp-scaled radius rr, a factor f
    such that rr * f is the unscaled radius. Host-side construction
    mirrors lens_correction.h:322-380: knots at notch_i = (i/(nk-1))^2 *
    rr_max, values (r_i / rr_i) - 1 stored in a cubic NATURAL spline,
    built on the CPU and copied once to each device it is called on."""

    spl: S.Spline2D
    rr_max: float
    nk: int
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def create(a: float, b: float, c: float, r_max: float,
               sz: int = 32) -> "InverseLcp":
        nk = sz + 4
        r_hi = r_max * ((sz + 3.0) / sz)
        rr_max = float(_poly4(r_hi, a, b, c))
        knots = np.empty(nk, np.float64)
        for i in range(nk):
            notch = (i / (nk - 1)) ** 2 * rr_max
            if notch == 0.0:
                knots[i] = 1.0 / _poly4_deriv(0.0, a, b, c) - 1.0
                continue
            # Newton iteration, start on the chord (lens_correction.h:350-358)
            out = i * r_hi / sz
            last_diff = np.inf
            for _ in range(32):
                diff = notch - _poly4(out, a, b, c)
                if diff == last_diff or abs(diff) < 1e-14 * max(1.0, notch):
                    break
                last_diff = diff
                out = out + diff / _poly4_deriv(out, a, b, c)
            knots[i] = (out / notch) - 1.0
        img = torch.from_numpy(knots.reshape(1, nk, 1).astype(np.float32))
        spl = S.make_spline(img, 3, bcs=(S.NATURAL, S.NATURAL))
        return InverseLcp(spl=spl, rr_max=rr_max, nk=nk)

    def _spline_on(self, device) -> S.Spline2D:
        spl = self._on.get(device)
        if spl is None:
            spl = dataclasses.replace(self.spl,
                                      coeff=self.spl.coeff.to(device))
            self._on[device] = spl
        return spl

    def __call__(self, rr):
        """Scaling factor for lcp-scaled radii rr (unit-radius units)
        (lens_correction.h:394-403), on rr's device."""
        u = torch.sqrt(torch.clamp(rr, min=0.0) / self.rr_max) \
            * (self.nk - 1)
        v = S.eval_spline(self._spline_on(u.device), u,
                          torch.zeros_like(u))[..., 0]
        return v + 1.0


def pto_planar_forward(facet):
    """Planar transform target->source model coordinates: lens
    polynomial, then shift, then shear (environment.h:259-284).
    ``facet`` provides a,b,c, s (unit radius), h, v (already in model
    units), shear_g, shear_t and the has_* flags. Returns a function
    (px, py) -> (px, py) of tensors."""
    def f(px, py):
        if facet.has_lcp:
            r = torch.sqrt(px * px + py * py) / facet.s
            factor = lcp_scale(r, facet.a, facet.b, facet.c)
            px = px * factor
            py = py * factor
        if facet.has_shift:
            px = px + facet.h
            py = py + facet.v
        if facet.has_shear:
            nx = px + py * facet.shear_g
            ny = py + px * facet.shear_t
            px, py = nx, ny
        return px, py
    return f


def pto_planar_inverse(facet, inv: "InverseLcp | None" = None):
    """Exact inverse of pto_planar_forward: un-shear, un-shift, inverse
    lens polynomial (environment.h:286-307; shear inverse adapted from
    panotools math.c, same as the reference)."""
    if inv is None and facet.has_lcp:
        # sz=100 knots like the reference's pto_planar (environment.h:251)
        inv = InverseLcp.create(facet.a, facet.b, facet.c, facet.r_max,
                                sz=100)

    def f(px, py):
        if facet.has_shear:
            py = (py - facet.shear_t * px) \
                / (1.0 - facet.shear_t * facet.shear_g)
            px = px - facet.shear_g * py
        if facet.has_shift:
            px = px - facet.h
            py = py - facet.v
        if facet.has_lcp:
            r = torch.sqrt(px * px + py * py) / facet.s
            factor = inv(r)
            px = px * factor
            py = py * factor
        return px, py
    return f
