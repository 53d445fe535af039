"""The least time of one frame's work on one NVIDIA H100 SXM, counted from
the job and not from any kernel, so that it reads the same whatever
implements the frame.

``work`` comes from the reference (reference/exact.py) as it makes the
frame: the table entries that the taps reaching the frame read, marked
once per facet; the pixels; per facet the pixel-taps it gives the frame
(its champion taps). The bytes are those entries read once at the
table's element size and each output byte written once. The operations
are, per pixel, one target ray and its normalisation (and, twined, the
two derivative rays' differences and each tap's deflection; for a
stitch, each facet's score at each tap), and per pixel-tap that reaches
the frame its rotation into the facet, its pickup (with the lens
polynomial where the facet has one), the spline and, twined, the
weighted sum. Nothing a frame can do without is counted, so the share
of this time in a frame's device time cannot pass 100%.

The arithmetic per step is frozen from the port's bring-up check
(chip_smoke.py ``touched_bytes``, ``spline_flops``, ``inline_bound``,
``mode_bound``): the same constants, fed with the reference's own
coordinates.
"""

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
F32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores
# a target ray from its pixel, by projection (affine rectilinear and
# cube faces, spherical from host sin/cos tables)
TARGET_FLOPS = {"rectilinear": 15, "cubemap": 15, "spherical": 17,
                "cylindrical": 15, "stereographic": 143, "fisheye": 121}
# a ray's planar coordinates on a mounted source, by projection
MOUNT_FLOPS = {"spherical": 45, "cylindrical": 25, "rectilinear": 2,
               "stereographic": 12, "fisheye": 45}
NORMALISE = 12
ROTATE = 15
LENS = 12
TO_PIXELS = 4
DEFLECT = 12
SCORE = 5


def spline_flops(n, nch):
    """Two (n+1)-row Horner sets of n FMAs, (n+1)^2 x C tap FMAs and
    (n+1) x C row FMAs, 2 flops an FMA."""
    return 2 * (n + 1) * n * 2 + (n + 1) ** 2 * nch * 2 + (n + 1) * nch * 2


def count(work):
    nch, taps, n = work["channels"], work["taps"], work["degree"]
    table = sum(int(t.sum()) for t in work["touched"]) * nch \
        * work["entry_bytes"]
    out = work["pixels"] * nch * 4
    per_px = TARGET_FLOPS[work["target"]] + NORMALISE
    if taps > 1:
        per_px += 2 * 6 + taps * DEFLECT
    if work["facets"] > 1:
        per_px += taps * work["facets"] * SCORE
    flops = work["pixels"] * per_px
    for live, src, lens in zip(work["live_taps"], work["sources"],
                               work["lenses"]):
        per_tap = ROTATE + MOUNT_FLOPS[src] + LENS * lens + TO_PIXELS \
            + spline_flops(n, nch) + (2 * nch if taps > 1 else 0)
        flops += live * per_tap
    bytes_ms = (table + out) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return dict(least_ms=max(bytes_ms, ops_ms),
                by="bytes" if bytes_ms >= ops_ms else "operations",
                table_bytes=table, out_bytes=out, flops=flops,
                bytes_ms=bytes_ms, ops_ms=ops_ms)
