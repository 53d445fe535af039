"""Synopsis under twining: the weighted sum over a spread of deflected
rays.

PyTorch counterpart of envutil_tpu/models/synopsis.py's ``twined`` and
``_tangential_basis`` (the reference's synopsis_t wrapper,
envutil_payload.cc:587-691, and twining.h:152-263). Twining is a loop
over the spread coefficients: each tap deflects every facet's ray along
the differenced derivative rays and feeds the plain synopsis; the
weighted taps accumulate into the result.

Only the solo synopsis (one facet) is driven through it so far: the
multi-facet synopses (voronoi, voronoi_plus, hdr_merge) wait for the
multi-facet slice. ``derivative_rays`` and ``deflect`` are also what the
inline twined kernel's plain version and the planar twined route use,
so all of them linearise exactly as the exact path does.
"""

from __future__ import annotations

from .stepper import DERIV_BIAS


def _tangential_basis(p0, p10, p01):
    """--twine_precise derivative basis (twining.h:152-263): instead of
    plain differencing, draw a line through the neighbour ray point with
    the pickup ray as direction and take its closest point to the
    pickup: the orthogonal projection of the neighbour onto the pickup's
    tangent plane (for unit pickup rays). The reference assigns
    Imath::Line3's ``dir`` member the unnormalised pickup ray and uses
    closestPointTo's ``pos + dir * ((q - pos) . dir)`` verbatim, so this
    replicates exactly that formula (rays from the steppers are
    normalised, making it the textbook projection)."""
    def proj(pn):
        # t = (p0 - pn) . p0 ;  d = pn + t * p0 - p0
        t = sum((a - b) * a for a, b in zip(p0, pn))
        return tuple(b + t * a - a for a, b in zip(p0, pn))
    return proj(p10), proj(p01)


def derivative_rays(p0, p10, p01, precise: bool = False):
    """(du, dv): the derivative rays of one ninepack, by plain
    differencing or, with ``precise``, in the pickup's tangent plane."""
    if precise:
        return _tangential_basis(p0, p10, p01)
    return (tuple(a - b for a, b in zip(p10, p0)),
            tuple(a - b for a, b in zip(p01, p0)))


def deflect(p0, du, dv, cx: float, cy: float):
    """The tap's ray p0 + cx du + cy dv (not normalised)."""
    return tuple(p + cx * u + cy * v for p, u, v in zip(p0, du, dv))


def scaled_spread(spread, bias: float = 1.0 / DERIV_BIAS):
    """The spread with the derivative grids' bias folded into the
    offsets: ((cx / DERIV_BIAS, cy / DERIV_BIAS, w), ...)."""
    return tuple((float(cx) * bias, float(cy) * bias, float(w))
                 for cx, cy, w in spread)


def twined(syn, sources, ninepacks, nch: int, spread,
           bias: float = 1.0 / DERIV_BIAS, precise: bool = False):
    """Apply a synopsis through a twining spread: ``ninepacks`` are
    (p0, p10, p01) ray triples per facet; each spread coefficient
    (cx, cy, w) deflects every facet's rays by cx*du + cy*dv (du, dv
    differenced and scaled back up by ``bias`` = 1/DERIV_BIAS,
    envutil_payload.cc:611-691). ``precise`` selects the tangent-plane
    derivative basis (--twine_precise)."""
    derivs = [(p0,) + derivative_rays(p0, p10, p01, precise)
              for p0, p10, p01 in ninepacks]
    out = None
    for cx, cy, w in scaled_spread(spread, bias):
        rays = [deflect(p0, du, dv, cx, cy) for p0, du, dv in derivs]
        term = w * syn(sources, rays, nch)
        out = term if out is None else out + term
    return out
