"""Whether the frames the window produced are right.

The frames kept from the window (one enqueued at a time drawn from the
seed, and the last) are compared, block by block of rows, with the
reference (``reference/exact.py``) worked out in float64 from the same
images. Per pixel and channel the gap is ``|frame - reference|`` less the
reference's slack (0 but where a window edge or a voronoi tie is within
rounding); a frame of the wrong shape, or a value that is not finite,
reads the gap ``NONFINITE`` (a finite number, so that the result line
stays JSON). Two numbers are compared, each with the limit
that ``limits/<cell>.json`` sets for the cell:

* ``max_gap``: the widest gap of any pixel and channel, which a fault in
  one place (a block, a tap, a champion, a pixel) shows;
* ``rms_gap``: the root mean square of the gap over the frame, which a
  table held at lower precision shows.

Each is the worse of the frames compared.
"""

from __future__ import annotations

import math
import time

import torch

from .reference import exact

# float64 intermediates of the reference per block, in pixels x facets x
# taps
BLOCK_BUDGET = 1 << 24
# the gap of a frame of the wrong shape or of a value that is not finite
NONFINITE = 1e30


def compare(config, traffic, images, frames, limits, device):
    """(checks, failed, work): each compared number with its limit,
    how many of the frames exceed a limit, and the reference's work
    counts."""
    t0 = time.perf_counter()
    ref = exact.Reference(config, traffic, images, device)
    j = ref.job
    taps = 1 if j.spread is None else len(j.spread)
    rows = max(1, BLOCK_BUDGET // (j.width * len(ref.facets) * taps))
    want = (j.height, j.width, j.channels)
    stats = [dict(max=0.0, sq=0.0, n=0) for _ in frames]
    ambiguous = 0
    for y0 in range(0, j.height, rows):
        y1 = min(j.height, y0 + rows)
        value, slack, amb = ref.rows(y0, y1)
        ambiguous += int(amb.sum())
        for st, f in zip(stats, frames):
            if tuple(f.shape) != want:
                st["max"] = NONFINITE
                continue
            block = f[y0:y1].to(torch.float64)
            gap = ((block - value).abs() - slack).clamp_(min=0.0)
            gap = torch.where(torch.isfinite(block), gap, NONFINITE)
            st["max"] = max(st["max"], float(gap.max()))
            st["sq"] += float((gap * gap).sum())
            st["n"] += gap.numel()
    per_frame = [dict(max_gap=s["max"],
                      rms_gap=min(NONFINITE, math.sqrt(s["sq"] / s["n"]))
                      if s["n"] and s["max"] < NONFINITE else NONFINITE)
                 for s in stats]
    checks = {k: dict(value=max(p[k] for p in per_frame),
                      limit=float(limits[k]))
              for k in ("max_gap", "rms_gap")}
    failed = sum(any(p[k] > checks[k]["limit"] for k in checks)
                 for p in per_frame)
    ref.work.update(ambiguous_px=ambiguous, frames_compared=len(frames),
                    reference_s=time.perf_counter() - t0)
    return checks, failed, ref.work
