"""Synopsis: composing pixels from several facets, and twining.

PyTorch counterpart of envutil_tpu/models/synopsis.py (the reference's
synopsis-forming objects, envutil_payload.cc):

* ``voronoi``: opaque panorama. The facet whose normalised facet-CS ray
  has the largest z * recip_step wins (the 'champion' criterion,
  _voronoi_syn:762-957).
* ``voronoi_plus``: facets with alpha. All facets are ordered per pixel
  by that score and composited front to back with associated alpha
  (_voronoi_syn_plus:964-1233).
* ``hdr_merge``: exposure fusion with triangular quality weights, the
  max of R, G, B as grey, the darkest facet ruling the highlights and the
  brightest the shadows (_hdr_merge_syn:1325-1623).

The JAX package selects the champion with a where-cascade over the
facet axis because a gather is slow on the TPU; here ``torch.argmax``
and ``torch.gather`` select it. Ties resolve as in the JAX package:
``argmax`` takes the first maximum and the depth order is a stable sort.
The ``*_stack`` forms take stacked per-facet pixels and scores, as the
card path (runtime/fastpath.multi_frame) produces them, and
``twined_stack`` sums that path's combines over the taps of a twined
stitch.

Twining (the synopsis_t wrapper, envutil_payload.cc:587-691, and
twining.h:152-263) is a loop over the spread coefficients: each tap
deflects every facet's ray along the differenced derivative rays and
feeds the plain synopsis; the weighted taps accumulate into the result.
``derivative_rays`` and ``deflect`` are also what the twined kernels'
plain versions use, so all of them linearise as the exact path does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import environment as E
from .stepper import DERIV_BIAS

# the score of a ray that misses its facet: below every real score
LOWEST = float(np.finfo(np.float32).min)


def facet_score(z, mask, recip_step: float):
    """The voronoi score of rays whose normalised facet-CS z is ``z``:
    z * recip_step where ``mask`` holds, LOWEST elsewhere."""
    return torch.where(mask, z * recip_step, LOWEST)


def _eval_all(sources, rays, nch: int):
    """Evaluate every facet at its rays; returns stacked pixels
    (NF, ..., C), masks (NF, ...) and scores (NF, ...)."""
    pxs, masks, scores = [], [], []
    for src, ray in zip(sources, rays):
        px, mask = E.lookup(src, ray, nch)
        pxs.append(px)
        masks.append(mask)
        scores.append(facet_score(ray[2], mask, src.static.recip_step))
    return torch.stack(pxs), torch.stack(masks), torch.stack(scores)


def voronoi_stack(px, mask, score):
    """Champion select from stacks: px (NF, ..., C), mask and score
    (NF, ...); 0 where no facet is valid. ``mask`` None means valid where
    the score is above LOWEST (``facet_score``'s planes), which the best
    score's pass decides along with the champion."""
    best, champion = torch.max(score, dim=0, keepdim=True)
    valid = best[0] > LOWEST if mask is None else mask.any(dim=0)
    sel = torch.gather(px, 0, champion[..., None].expand(
        (1,) + px.shape[1:]))[0]
    return torch.where(valid[..., None], sel, 0.0)


def depth_order(score):
    """(NF, ...) int64: per pixel the facets in descending score order,
    ties in facet order (``argsort(-score)``, stable, as the JAX package
    sorts). Formed from each facet's rank, the count of facets ahead of
    it, and one scatter: a sort along the short facet axis is far
    slower on the card."""
    nf = score.shape[0]
    rank = torch.zeros(score.shape, dtype=torch.int64, device=score.device)
    for f in range(nf):
        for g in range(nf):
            if g != f:
                ahead = score[g] >= score[f] if g < f else \
                    score[g] > score[f]
                rank[f] += ahead
    facet = torch.arange(nf, device=score.device).view(
        (nf,) + (1,) * (score.dim() - 1)).expand(score.shape)
    return torch.empty_like(rank).scatter_(0, rank, facet)


def voronoi_plus_stack(px, mask, score):
    """Front-to-back associated-alpha compositing of the facets in
    descending score order, from stacks as for ``voronoi_stack``."""
    order = depth_order(score)
    layers = torch.gather(px, 0, order[..., None].expand(px.shape))
    valid = torch.gather(score, 0, order) > LOWEST if mask is None \
        else torch.gather(mask, 0, order)
    acc = torch.where(valid[0][..., None], layers[0], 0.0)
    for layer, vld in zip(layers[1:], valid[1:]):
        contrib = torch.where(vld[..., None], layer, 0.0)
        acc = acc + (1.0 - acc[..., -1:]) * contrib
    return acc


def voronoi(sources, rays, nch: int):
    return voronoi_stack(*_eval_all(sources, rays, nch))


def voronoi_plus(sources, rays, nch: int):
    return voronoi_plus_stack(*_eval_all(sources, rays, nch))


def _grey_project(px):
    """max of R, G, B (envutil_payload.cc:1457-1463)."""
    return torch.amax(px, dim=-1)


def _quality(grey, optimum: float, kind: str):
    """Triangular quality, boosted for long exposures by /optimum^2; the
    brightest facet rules the shadows (kind 'low'), the darkest the
    highlights (kind 'high') (envutil_payload.cc:1390-1445)."""
    grey_is_large = grey > optimum
    distance = torch.abs(optimum - grey)
    if kind == "low":
        distance = torch.where(grey_is_large, distance, 0.0)
    elif kind == "high":
        distance = torch.where(grey_is_large, 0.0, distance)
    return (optimum - distance) / (optimum * optimum)


def hdr_kinds(brightens):
    """Per bracket, its quality kind and optimum: the bracket brightened
    least (the brightest exposure) rules the shadows ('low'), the one
    brightened most (the darkest exposure) the highlights ('high'); the
    optimum is half the brighten factor."""
    lo_i = int(np.argmin(brightens))
    hi_i = int(np.argmax(brightens))
    return [("low" if i == lo_i else ("high" if i == hi_i else "mid"),
             0.5 * b) for i, b in enumerate(brightens)]


def hdr_qualities(px_list, brightens, nch: int):
    """Each bracket's quality weight per pixel (times its alpha for 2
    and 4 channels)."""
    out = []
    for px, (kind, optimum) in zip(px_list, hdr_kinds(brightens)):
        if nch in (2, 4):
            out.append(px[..., -1] * _quality(
                _grey_project(px[..., :nch - 1]), optimum, kind))
        else:
            out.append(_quality(_grey_project(px), optimum, kind))
    return out


def hdr_merge_stack(px_list, brightens, nch: int):
    """Exposure fusion from per-facet pixels (each (..., C)) and their
    brighten factors (host floats)."""
    has_alpha = nch in (2, 4)
    acc = qsum = alpha_max = None
    for px, q in zip(px_list, hdr_qualities(px_list, brightens, nch)):
        if has_alpha:
            alpha = px[..., -1]
            live = alpha > 1e-6
            colour = torch.where(
                live[..., None],
                px[..., :nch - 1] / torch.where(live, alpha, 1.0)[..., None],
                0.0)
            contrib = colour * q[..., None]
            alpha_max = alpha if alpha_max is None else \
                torch.maximum(alpha_max, alpha)
        else:
            contrib = px * q[..., None]
        acc = contrib if acc is None else acc + contrib
        qsum = q if qsum is None else qsum + q
    good = (qsum > 0.0)[..., None]
    colour = torch.where(good, acc / torch.where(good, qsum[..., None], 1.0),
                         0.0)
    if has_alpha:
        colour = colour * alpha_max[..., None]
        return torch.cat([colour, alpha_max[..., None]], -1)
    return colour


def hdr_merge(sources, rays, nch: int):
    px_list = [E.lookup(src, ray, nch)[0] for src, ray in zip(sources, rays)]
    return hdr_merge_stack(px_list, [s.static.brighten for s in sources],
                           nch)


SYNOPSES = {
    "voronoi": voronoi,
    "voronoi_plus": voronoi_plus,
    "hdr_merge": hdr_merge,
}


def pick_synopsis(name: str, nch: int):
    """panorama -> voronoi (opaque) or voronoi_plus (alpha), matching
    roll_out (envutil_payload.cc:2298-2320)."""
    if name == "hdr_merge":
        return hdr_merge
    if name == "panorama":
        return voronoi if nch in (1, 3) else voronoi_plus
    raise ValueError(f"unknown synopsis {name!r}")


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


def twined_stack(acc, term, w: float):
    """Fold one tap's synopsis ``term`` into the running sum ``acc`` of a
    twined stitch (None before the first tap): ``acc + w * term``, in
    place (``term`` itself scaled for the first tap), the sum that
    ``twined`` forms over the taps; the card route
    (runtime/fastpath.multi_frame) combines its stacks once a tap."""
    if acc is None:
        return term.mul_(w)
    return acc.add_(term, alpha=w)


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
