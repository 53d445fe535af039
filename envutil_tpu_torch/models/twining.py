"""Twining filter setup: 'inlined oversampling with subsequent
weighted averaging' (twining.h, README).

The kernel ('spread') is a small list of (dx, dy, weight) taps in units
of one output pixel step. This module ports the host-side
parameterization logic verbatim semantics:

* make_spread: box or truncated-gaussian grids with thresholding
  (envutil_main.cc:1253-1355),
* read_twf_file: user-provided kernels scaled by twine_width
  (envutil_main.cc:1360-1403),
* auto_twine: automatic twine factor / width from the
  magnification between source and target resolution
  (arguments::twine_setup, envutil_main.cc:1405-1616).

The application of the spread is fused into the render (see
synopsis.twined).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

Spread = List[Tuple[float, float, float]]


def make_spread(w: int = 2, h: int = 0, d: float = 1.0,
                sigma: float = 0.0, threshold: float = 0.0,
                verbose: bool = False) -> Spread:
    """Build a w*h tap grid spanning one output pixel, optionally
    weighted by a truncated gaussian and thresholded
    (envutil_main.cc:1253-1355)."""
    if w <= 2:
        w = 2
    if h <= 0:
        h = w
    wgt = 1.0 / (w * h)
    x0 = -(w - 1.0) / (2.0 * w)
    dx = 1.0 / w
    y0 = -(h - 1.0) / (2.0 * h)
    dy = 1.0 / h
    sigma = sigma * (-x0)
    trg = []
    total = 0.0
    for y in range(h):
        for x in range(w):
            wf = 1.0
            if sigma > 0.0:
                wx = (x0 + x * dx) / sigma
                wy = (y0 + y * dy) / sigma
                wf = math.exp(-math.sqrt(wx * wx + wy * wy))
            tap = (d * (x0 + x * dx), d * (y0 + y * dy), wf * wgt)
            trg.append(tap)
            total += wf * wgt

    if sigma != 0.0:
        renorm = False
        th_sum = 0.0
        normed = []
        for (tx, ty, tw) in trg:
            tw = tw / total
            if tw >= threshold:
                th_sum += tw
            else:
                renorm = True
                tw = 0.0
            normed.append((tx, ty, tw))
        trg = normed
        if renorm:
            trg = [(tx, ty, tw / th_sum) for (tx, ty, tw) in trg
                   if tw > 0.0]
            if verbose:
                print(f"twining filter taps after thresholding: {len(trg)}")
    elif verbose:
        print("using box filter for twining")
    return trg


def read_twf_file(path: str, twine_width: float,
                  normalize: bool = False,
                  verbose: bool = False) -> Spread:
    """Read a user twining kernel: lines of 'dx dy weight'
    (envutil_main.cc:1360-1403)."""
    taps = []
    total = 0.0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            tx, ty, tw = float(parts[0]), float(parts[1]), float(parts[2])
            taps.append((tx, ty, tw))
            total += tw
    out = []
    for (tx, ty, tw) in taps:
        if normalize:
            tw = tw / total
        out.append((tx * twine_width, ty * twine_width, tw))
    if verbose:
        print(f"twf file {path}: {len(out)} taps, weight sum "
              f"{1.0 if normalize else total}")
    return out


def auto_twine(target_step: float, smallest_facet_step: float,
               spline_degree: int, nfacets: int,
               twine_max: int = 8,
               verbose: bool = False) -> Tuple[int, float]:
    """Automatic twine factor and width from the magnification
    mag = smallest facet step / target step
    (envutil_main.cc:1441-1557). Returns (twine, twine_width)."""
    mag = smallest_facet_step / target_step
    if mag > 1.0:
        if spline_degree > 1:
            if nfacets > 1:
                twine = 3
            elif mag < 2.0:
                twine = 2
            else:
                twine = 1
            twine_width = 1.0
        else:
            twine = min(5, int(1.0 + mag))
            twine_width = mag
    else:
        twine = int(1.0 + 1.0 / mag)
        twine = min(twine_max, twine)
        twine_width = 1.0
    if verbose:
        print(f"automatic twining for magnification {mag}: twine {twine}"
              f" twine_width {twine_width}")
    return twine, twine_width
