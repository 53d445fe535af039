#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout (one nvcc
per source, started together), holds each kernel against its plain
PyTorch version on the card, drives the port's paths through its user
entry point ``render_frame`` at full size, checks each result, and times
the kernels, their plain versions and the steady-state frames with CUDA
events. The paths:

- main path: an 8192x4096 RGB equirect of ramps (x, y, x*y), degree-3
  prefilter and b-spline -> 2048x12288 cubemap (resample_inline, sph);
- config 2r: that cubemap frame as a 6x2048 cubemap source -> 8192x4096
  equirect (resample_inline, cubemap source mode);
- configs 3 and 3b: a seeded-noise biatan6 source (1024-px faces, fov
  100) -> 1920x1152 stereographic (hfov 150, yaw 35, pitch 20) and
  fisheye (hfov 170, yaw -25, pitch 15) (resample_planar);
- a partial lens-corrected facet (1536x1152 rectilinear, hfov 72,
  a, b, c = 0.01, -0.02, 0.005) -> 4096x2048 equirect, and a small
  translated facet (resample_planar with the validity mask).

Every phase runs; any failure raises and the script exits non-zero. It
exits non-zero without a result when no CUDA card is available. The
second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

# kernel vs plain version, both on the card with the same float32
# formulas: nvcc contracts multiply-adds into FMAs (gate affine, Horner
# weights, tap sums) where the plain version rounds each step, and
# atan2f may differ from torch.atan2 by an ulp or two. Both move the
# spline coordinates by ~1e-5 px; times the spline gradient of the
# uniform-noise test sources (prefiltered coefficients reach ~+-3) that
# is ~1e-4, so 1e-3 holds with margin while any indexing or weighting
# fault shows as O(0.1..1).
KERNEL_BOUND = 1e-3
# degree 0 is nearest-neighbour and jumps at cell boundaries: a pixel
# whose coordinate lies within this many px of a boundary may pick the
# other cell under the ulp-level differences above, and is excluded
DEG0_BOUNDARY_PX = 1e-3
# cube faces: where the two largest ray components agree to this
# relative margin, an ulp decides the face, and the two faces' pickups
# agree only to the bilinear reprojection that filled the support
# frames (O(0.1) on noise); such pixels are excluded and counted
FACE_EDGE_REL = 1e-5
# main path: the port's exact path on the card (stepper rays,
# normalisation, ray_to_ll, gates, eval_spline) computes the same
# coordinates in a different float32 order; on the smooth ramp fixture
# that is ~1e-6, but the horizontal ramp wraps from 1 to 0 at the
# periodic seam, where the spline's gradient is O(1) per px
MAIN_BOUND = 1e-3
# the new paths against the exact path: the fast routes pad and gate
# the coordinates in float (sx + pad, the mirror gate of the JAX
# _coords) or form the IR pickup as one affine, where the exact path
# adds the pad after the integer split and uses the metrics' form.
# Coordinates reach 6 x 2304 IR rows (config 2r), where a float32 ulp
# is 1e-3 px; a few ulps times the spline gradient of uniform noise
# (<= ~4 per px) or of the ramp's seam step stay below 5e-3, while an
# off-by-one pickup shows as O(0.5)
PATH_BOUND = 5e-3
# front-face centre against the ramp fixture's analytic value
LANDMARK_BOUND = 1e-3
# config 2r's round trip: the equirect's centre after equirect ->
# cubemap -> equirect (two degree-3 resamplings of a linear ramp)
ROUNDTRIP_BOUND = 1e-3
# degree-1 planar kernel vs bilinear grid_sample on the same table:
# grid_sample takes coordinates normalised to [-1, 1] and scales them
# back, which at IR row ~6900 loses ~4e-4 px in float32; times the
# noise table's gradient that stays below 1e-2
LIBRARY_BOUND = 1e-2

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def smi_now():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def events_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` calls, each timed
    with a pair of CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def make_facet(projection, w, h, hfov, **kw):
    from envutil_tpu_torch.core.facet import Facet
    from envutil_tpu_torch.core.metrics import get_step
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(projection, w, h, hfov)
    f.step = get_step(projection, w, h, hfov)
    for k, v in kw.items():
        setattr(f, k, v)
    f.process_geometry()
    return f


def make_args(fct, projection, w, h, hfov_deg, degree, ypr=(0, 0, 0),
              nch=3):
    from envutil_tpu_torch.core.metrics import get_extent
    from envutil_tpu_torch.runtime.args import Args
    a = Args()
    a.projection = projection
    a.width, a.height = w, h
    a.hfov = math.radians(hfov_deg)
    a.extent = get_extent(projection, w, h, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / w
    a.yaw, a.pitch, a.roll = (math.radians(v) for v in ypr)
    a.spline_degree = a.prefilter_degree = degree
    a.twine = 0
    a.synopsis = "panorama"
    a.nchannels = nch
    a.facets = [fct]
    a.solo = 0
    return a


def plan_for(fct, projection, w, h, hfov_deg, degree, ypr=(0, 0, 0), nch=3):
    from envutil_tpu_torch.runtime.render import build_plan
    return build_plan(make_args(fct, projection, w, h, hfov_deg, degree, ypr,
                                nch), [fct])


def near_face_edge(rx, ry, rz):
    """Pixels whose two largest ray components agree to FACE_EDGE_REL."""
    import torch
    a = torch.stack([rx.abs(), ry.abs(), rz.abs()])
    top2 = torch.topk(a, 2, dim=0).values
    return (top2[0] - top2[1]) <= FACE_EDGE_REL * top2[0]


def near_cell_edge(s):
    import torch
    f = torch.remainder(s + 0.5, 1.0)
    return (f < DEG0_BOUNDARY_PX) | (f > 1.0 - DEG0_BOUNDARY_PX)


def inline_kw(ops, degree):
    return dict(degree=degree, tmode=ops["tmode"], consts=ops["consts"],
                row0=ops["row0"], face_rows=ops["face_rows"],
                smode=ops["smode"])


def kernel_vs_plain(plan, src, degree):
    """Launch the inline kernel and its plain version on the same
    operands; returns (max abs difference over the compared pixels,
    pixels excluded at cube-face edges, kernel output, plain output)."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    coeff = src.spl.coeff
    y0, y1, x0, x1 = FP.frame_window(plan)
    shape = (y1 - y0, x1 - x0, coeff.shape[-1])
    kw = inline_kw(ops, degree)
    args = (coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
    out_k = R.resample_inline(torch.empty(shape, device=coeff.device),
                              *args, **kw)
    out_p = R.resample_inline_plain(
        torch.empty(shape, device=coeff.device), *args, **kw)
    torch.cuda.synchronize()
    diff = (out_k - out_p).abs()
    skip = torch.zeros(shape[:2], dtype=torch.bool, device=coeff.device)
    if degree == 0:
        sx, sy = R.inline_coords(*args[1:], tmode=kw["tmode"],
                                 consts=kw["consts"], row0=kw["row0"],
                                 face_rows=kw["face_rows"],
                                 smode=kw["smode"])
        skip |= near_cell_edge(sx) | near_cell_edge(sy)
    n_edge = 0
    if kw["smode"] != "sph":
        edge = near_face_edge(*R.inline_rays(
            *args[1:], tmode=kw["tmode"], row0=kw["row0"],
            face_rows=kw["face_rows"]))
        n_edge = int(edge.sum())
        skip |= edge
    diff = torch.where(skip[..., None], 0.0, diff)
    check(bool(torch.isfinite(out_k).all()), "kernel output not finite")
    return float(diff.max()), n_edge, out_k, out_p


def phase_small_inline():
    """Inline kernel against plain version at small shapes: degrees x
    channel counts on full-spherical mounts (cubemap target) and on
    cubemap and biatan6 IR sources (every target mode), plus every
    target mode on a mount."""
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    rng = np.random.default_rng(7)
    worst = 0.0
    fct = make_facet(P.SPHERICAL, 256, 128, 2 * math.pi)
    cases = [(d, c, P.CUBEMAP, 64, 384, 90, (0, 0, 0))
             for d in (0, 1, 2, 3, 5) for c in (1, 3, 4)]
    cases += [(3, 3, P.RECTILINEAR, 96, 64, 75, (30, 10, 5)),
              (3, 3, P.SPHERICAL, 128, 64, 360, (20, -30, 10)),
              (3, 3, P.CYLINDRICAL, 128, 64, 200, (10, 5, 0)),
              (3, 3, P.BIATAN6, 32, 192, 90, (5, 5, 5))]
    for degree, nch, proj, w, h, hfov, ypr in cases:
        img = rng.uniform(0, 1, (128, 256, nch)).astype(np.float32)
        src = E.make_mount_source(fct, img, degree, degree, device="cuda")
        err = kernel_vs_plain(plan_for(fct, proj, w, h, hfov, degree, ypr,
                                       nch), src, degree)[0]
        print(f"inline vs plain: sph source, degree {degree} C {nch} "
              f"{proj.name.lower()} {w}x{h}: max abs diff {err:.3e} "
              f"(bound {KERNEL_BOUND:g})", flush=True)
        check(err <= KERNEL_BOUND, f"inline kernel disagrees: {err}")
        worst = max(worst, err)

    targets = [(P.CUBEMAP, 48, 288, 90, (10, -20, 5)),
               (P.RECTILINEAR, 96, 64, 75, (30, 10, 5)),
               (P.SPHERICAL, 128, 64, 360, (20, -30, 10)),
               (P.CYLINDRICAL, 128, 64, 200, (10, 5, 0)),
               (P.BIATAN6, 32, 192, 90, (5, 5, 5))]
    n_cases = n_edge = 0
    for kind, fov in ((P.CUBEMAP, 90), (P.BIATAN6, 100)):
        cfct = make_facet(kind, 32, 192, math.radians(fov))
        for degree in (0, 1, 3, 5):
            for nch in (1, 3, 4):
                faces = rng.uniform(0, 1, (6, 32, 32, nch)).astype(
                    np.float32)
                src = CBM.make_cubemap_source(cfct, faces, degree, degree,
                                              8, 16, device="cuda")
                for proj, w, h, hfov, ypr in targets:
                    err, edge = kernel_vs_plain(
                        plan_for(cfct, proj, w, h, hfov, degree, ypr, nch),
                        src, degree)[:2]
                    check(err <= KERNEL_BOUND,
                          f"inline kernel ({kind.name.lower()} source, "
                          f"degree {degree}, C {nch}, "
                          f"{proj.name.lower()}) disagrees: {err}")
                    worst = max(worst, err)
                    n_cases += 1
                    n_edge += edge
        print(f"inline vs plain: {kind.name.lower()} source, degrees "
              f"0/1/3/5 x C 1/3/4 x 5 target modes: worst so far "
              f"{worst:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    print(f"inline vs plain: {n_cases} IR cases, {n_edge} pixels within "
          f"{FACE_EDGE_REL:g} of a face edge excluded; worst {worst:.3e}",
          flush=True)
    return worst


def phase_small_planar():
    """Planar kernel against plain version: degrees 0-7 x 1/3/4
    channels, with and without a merge mask, over a NaN sentinel, with
    NaN/inf coordinates where the mask is 0."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    rng = np.random.default_rng(8)
    h, w = 40, 56
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)
    sx = rng.uniform(-3, 83, (h, w)).astype(np.float32)
    sy = rng.uniform(-3, 73, (h, w)).astype(np.float32)
    bad = np.array([np.nan, np.inf, -np.inf, 3e38], np.float32)
    off = mask <= 0.5
    sx[off] = bad[rng.integers(0, 4, int(off.sum()))]
    sy[off] = bad[rng.integers(0, 4, int(off.sum()))]
    dev = [torch.from_numpy(a).cuda() for a in (sx, sy, mask)]
    keep = dev[2] <= 0.5
    worst = 0.0
    for degree in range(8):
        for nch in (1, 3, 4):
            table = torch.from_numpy(rng.uniform(
                -1, 1, (70, 80, nch)).astype(np.float32)).cuda()
            for m in (None, dev[2]):
                nan = torch.full((h, w, nch), float("nan"), device="cuda")
                k = R.resample_planar(nan.clone(), table, dev[0], dev[1],
                                      degree=degree, merge_mask=m)
                p = R.resample_planar_plain(nan.clone(), table, dev[0],
                                            dev[1], degree=degree,
                                            merge_mask=m)
                torch.cuda.synchronize()
                if m is None:
                    check(bool(torch.isfinite(k).all()),
                          "planar kernel not finite on non-finite coords")
                else:
                    check(bool(k[keep].isnan().all())
                          and bool(torch.isfinite(k[~keep]).all()),
                          "planar kernel touched a pixel its mask keeps")
                err = float((k - p).nan_to_num().abs().max())
                check(err <= KERNEL_BOUND and torch.equal(k.isnan(),
                                                          p.isnan()),
                      f"planar kernel disagrees (degree {degree}, C {nch},"
                      f" mask {m is not None}): {err}")
                worst = max(worst, err)
    print(f"planar vs plain: degrees 0-7 x C 1/3/4 x (mask, no mask), NaN "
          f"sentinel kept under the mask: max abs diff {worst:.3e} (bound "
          f"{KERNEL_BOUND:g})", flush=True)
    return worst


def ramp_fixture(w=8192, h=4096):
    """bench.py's fixture: RGB ramps (x, y, x*y) over the equirect."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32),
                         indexing="ij")
    return np.stack([xx, yy, (xx * yy)], axis=-1)


def touched_bytes(coeff, sx, sy, n):
    """Bytes of the coefficient table that the frame's taps read, for
    padded coordinates (sx, sy) of the pixels evaluated: every entry
    that some pixel's (n+1)^2 window covers, counted once."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    hp, wp, nch = coeff.shape
    shift = 0.0 if n % 2 else 0.5
    bx = torch.floor(R.clamp_coords(sx, wp, n) + shift).to(torch.int64) \
        - n // 2
    by = torch.floor(R.clamp_coords(sy, hp, n) + shift).to(torch.int64) \
        - n // 2
    touched = torch.zeros(hp * wp, dtype=torch.bool, device=coeff.device)
    for j in range(n + 1):
        for k in range(n + 1):
            idx = ((by + j) * wp + bx + k).clamp_(0, hp * wp - 1)
            touched[idx.reshape(-1)] = True
    return int(touched.sum()) * nch * 4


def spline_flops(n, nch):
    """Flops per pixel of the spline part: two (n+1)-row Horner sets of
    n FMAs, (n+1)^2 x C tap FMAs and (n+1) x C row FMAs (2 flops an
    FMA)."""
    return 2 * (n + 1) * n * 2 + (n + 1) ** 2 * nch * 2 + (n + 1) * nch * 2


def inline_bound(plan, src, n_px):
    """(bound ms, 'bytes'/'operations', bytes ms, ops ms, touched
    bytes) of one inline launch over the plan's frame."""
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    n = src.spl.degree
    nch = src.spl.coeff.shape[-1]
    sx, sy = R.inline_coords(ops["xfeat"], ops["yfeat"], ops["bmats"],
                             tmode=ops["tmode"], consts=ops["consts"],
                             row0=ops["row0"], face_rows=ops["face_rows"],
                             smode=ops["smode"])
    table = touched_bytes(src.spl.coeff, sx, sy, n)
    del sx, sy
    feat = sum(ops[k].numel() * 4 for k in ("xfeat", "yfeat", "bmats"))
    bytes_ms = (table + n_px * nch * 4 + feat) / HBM_BYTES_PER_S * 1e3
    # per pixel: 9 mul + 6 add for the ray; sph: ~20 flops per atan2
    # (x2), the sqrt and 2 gate affines; cubemap: the face cascade, 2
    # divisions and 2 affines; biatan6: 2 atans more
    src_flops = {"sph": 53, "cubemap": 20, "biatan6": 60}[ops["smode"]]
    ops_ms = n_px * (15 + src_flops + spline_flops(n, nch)) / F32_FLOPS * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, table


def planar_bound(coeff, sx, sy, n, mask):
    """(bound ms, 'bytes'/'operations', bytes ms, ops ms, touched bytes)
    of one planar launch. With a mask, the work depends on it: the
    whole mask plane is read, and only covered pixels read their sx/sy,
    gather their taps and write their output."""
    nch = coeff.shape[-1]
    if mask is not None:
        sx, sy = sx[mask], sy[mask]
    n_px = sx.numel()
    table = touched_bytes(coeff, sx, sy, n)
    planes = 2 * n_px * 4 + (0 if mask is None else mask.numel() * 4)
    bytes_ms = (table + n_px * nch * 4 + planes) / HBM_BYTES_PER_S * 1e3
    ops_ms = n_px * spline_flops(n, nch) / F32_FLOPS * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, table


def band_errors(plan, src, frame, bands, ir_edges):
    """Max abs difference of ``frame`` against the port's exact path on
    the card over row bands; with ``ir_edges``, pixels whose exact ray
    sits within FACE_EDGE_REL of a cube-face edge are excluded (and
    counted)."""
    import torch
    from envutil_tpu_torch.models import stepper as ST
    from envutil_tpu_torch.runtime import render as RD
    worst, n_edge = 0.0, 0
    w = frame.shape[1]
    for r0, r1 in bands:
        win = (r0, r1, 0, w)
        exact = RD._render_window(plan, [src], win)
        diff = (torch.from_numpy(frame[r0:r1]).cuda() - exact).abs()
        if ir_edges:
            ray = ST.target_rays(plan.projection, plan.width, plan.height,
                                 plan.extent, basis=plan.bases[0],
                                 normalize=True,
                                 planar_to_ray=plan.planar_to_ray[0],
                                 window=win, device="cuda")
            edge = near_face_edge(*ray)
            n_edge += int(edge.sum())
            diff = torch.where(edge[..., None], 0.0, diff)
        worst = max(worst, float(diff.max()))
    return worst, n_edge


def render(plan, src, name, want_inline, want_planar):
    """render_frame with the launch counts set to 0 just before and read
    just after; checks the route and returns (frame, ms, launches)."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import render as RD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    R.resample_inline.launches = 0
    R.resample_planar.launches = 0
    t0 = time.perf_counter()
    frame = RD.render_frame(plan, [src], device="cuda")
    ms = (time.perf_counter() - t0) * 1000.0
    n = {"resample_inline": R.resample_inline.launches,
         "resample_planar": R.resample_planar.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: render_frame {frame.shape} in {ms:.1f} ms (first call,"
          f" host copy included); launches {n}; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    check(n["resample_inline"] == want_inline
          and n["resample_planar"] == want_planar,
          f"{name}: launches {n}, expected inline {want_inline}, planar "
          f"{want_planar}")
    check(frame.shape == (plan.height, plan.width, plan.nchannels),
          f"{name}: frame shape {frame.shape}")
    check(bool(np.isfinite(frame).all()), f"{name}: frame not finite")
    return frame, ms, n


def time_inline(plan, src, name):
    """Steady-state frame, kernel alone (median of 20) and plain version
    (median of 3) of an inline-kernel path."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    kw = inline_kw(ops, src.spl.degree)
    args = (src.spl.coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
    buf = torch.empty((plan.height, plan.width, src.spl.coeff.shape[-1]),
                      device="cuda")
    for _ in range(3):
        R.resample_inline(buf, *args, **kw)
    kernel_ms = events_ms(lambda: R.resample_inline(buf, *args, **kw), 20)
    plain_ms = events_ms(lambda: R.resample_inline_plain(buf, *args, **kw),
                         3)
    frame_ms = events_ms(lambda: FP.fused_frame(plan, src, out=buf), 20)
    n_px = plan.height * plan.width
    print(f"{name}: steady-state frame (fused_frame into one reused "
          f"buffer, median of 20) {frame_ms:.4f} ms = "
          f"{n_px / 1e3 / frame_ms:.1f} Mpix/s; kernel alone "
          f"{kernel_ms:.4f} ms; plain version {plain_ms:.3f} ms; "
          f"clocks/power/temp after: {smi_now()}", flush=True)
    bound = inline_bound(plan, src, n_px)
    print(f"{name}: bound {bound[0]:.4f} ms by {bound[1]} (table bytes "
          f"touched {bound[4] / 1e6:.1f} MB of "
          f"{src.spl.coeff.numel() * 4 / 1e6:.1f} MB; bytes "
          f"{bound[2]:.4f} ms at 3.35 TB/s, operations {bound[3]:.4f} ms at "
          f"67 TFLOP/s)", flush=True)
    return dict(frame_ms=frame_ms, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


def time_planar(plan, src, name):
    """Steady-state frame, coordinate pass alone and kernel alone
    (median of 20), plain version (median of 3) of a planar path."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    window = FP.frame_window(plan)
    sx, sy, mask = FP.coords(plan, window, src)
    masked = src.static.kind != "cubemap"
    m = mask.to(torch.float32) if masked else None
    coeff, n = src.spl.coeff, src.spl.degree
    buf = torch.zeros((plan.height, plan.width, coeff.shape[-1]),
                      device="cuda")
    for _ in range(3):
        FP.planar_frame(plan, src, out=buf)
    frame_ms = events_ms(lambda: FP.planar_frame(plan, src, out=buf), 20)
    coords_ms = events_ms(lambda: FP.coords(plan, window, src), 20)
    kernel_ms = events_ms(lambda: R.resample_planar(
        buf, coeff, sx, sy, degree=n, merge_mask=m), 20)
    plain_ms = events_ms(lambda: R.resample_planar_plain(
        buf, coeff, sx, sy, degree=n, merge_mask=m), 3)
    nan = torch.full(buf.shape, float("nan"), device="cuda")
    k = R.resample_planar(nan.clone(), coeff, sx, sy, degree=n,
                          merge_mask=m)
    p = R.resample_planar_plain(nan.clone(), coeff, sx, sy, degree=n,
                                merge_mask=m)
    err = float((k - p).nan_to_num().abs().max())
    print(f"{name}: planar vs plain at full shape: max abs diff {err:.3e} "
          f"(bound {KERNEL_BOUND:g})", flush=True)
    check(err <= KERNEL_BOUND and torch.equal(k.isnan(), p.isnan()),
          f"planar kernel disagrees at {name}")
    del nan, k, p
    n_px = plan.height * plan.width
    print(f"{name}: steady-state frame (planar_frame into one reused "
          f"buffer, median of 20) {frame_ms:.4f} ms = "
          f"{n_px / 1e3 / frame_ms:.1f} Mpix/s; coordinate pass alone "
          f"{coords_ms:.4f} ms ({100 * coords_ms / frame_ms:.1f}% of the "
          f"frame); kernel alone {kernel_ms:.4f} ms; plain version "
          f"{plain_ms:.3f} ms; clocks/power/temp after: {smi_now()}",
          flush=True)
    bound = planar_bound(coeff, sx, sy, n, mask if masked else None)
    what = (f"the mask plane and sx/sy/output at the {int(mask.sum())} "
            f"covered px" if masked else "sx/sy planes, output")
    print(f"{name}: bound {bound[0]:.4f} ms by {bound[1]} (table bytes "
          f"touched {bound[4] / 1e6:.1f} MB of {coeff.numel() * 4 / 1e6:.1f}"
          f" MB, {what}; bytes {bound[2]:.4f} ms, operations "
          f"{bound[3]:.4f} ms)", flush=True)
    return dict(frame_ms=frame_ms, coords_ms=coords_ms, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                max_abs_err=err, sx=sx, sy=sy)


def library_bilinear(src, sx, sy):
    """K2 at degree 1 on the IR table against one PyTorch call that
    computes the same function, bilinear ``grid_sample``
    (align_corners=True, border padding) on the table read as an
    image; returns a record of K2 at degree 1 beside that call."""
    import torch
    import torch.nn.functional as F
    from envutil_tpu_torch.ops import resample as R
    coeff = src.spl.coeff
    hp, wp, nch = coeff.shape
    image = coeff.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([2.0 * sx / (wp - 1) - 1.0,
                        2.0 * sy / (hp - 1) - 1.0], dim=-1)[None]
    out = torch.empty(sx.shape + (nch,), device="cuda")

    def lib():
        return F.grid_sample(image, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
    R.resample_planar(out, coeff, sx, sy, degree=1)
    diff = float((lib()[0].permute(1, 2, 0) - out).abs().max())
    k_ms = events_ms(lambda: R.resample_planar(out, coeff, sx, sy,
                                               degree=1), 20)
    l_ms = events_ms(lib, 20)
    bound = planar_bound(coeff, sx, sy, 1, None)
    return dict(ms=k_ms, library_ms=l_ms, max_abs_err_vs_library=diff,
                bound_ms=bound[0], bound_by=bound[1])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import kernels as K
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.ops import spline as S
    from envutil_tpu_torch.runtime import render as RD

    # ---- 1. card, versions, build -------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    nvcc = subprocess.run([K.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}", flush=True)
    build_s = R.build()
    for lib in R.LIBRARIES:
        log = lib.build_log.splitlines()
        regs = [int(line.split("Used ")[1].split(" registers")[0])
                for line in log if "Used " in line and " registers" in line]
        spills = [line for line in log if "spill" in line and
                  "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"build {lib.source.name}: "
              f"{len(regs)} instantiations, registers "
              f"{min(regs) if regs else '?'}..{max(regs) if regs else '?'}"
              f", spill lines: {len(spills)}", flush=True)
    print(f"kernel build, both sources in parallel: {build_s:.1f} s wall",
          flush=True)
    print('kernels: ["resample_inline", "resample_planar"]', flush=True)

    # ---- 2. kernels against plain versions at small shapes ------------
    worst_inline = phase_small_inline()
    worst_planar = phase_small_planar()

    # ---- 3. main path at full width -----------------------------------
    w, h = 8192, 4096
    img = ramp_fixture(w, h)
    fct = make_facet(P.SPHERICAL, w, h, 2 * math.pi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src = E.make_mount_source(fct, img, 3, 3, device="cuda")
    torch.cuda.synchronize()
    source_ms = (time.perf_counter() - t0) * 1000.0
    dev_img = torch.from_numpy(img).cuda()
    prefilter_ms = events_ms(
        lambda: S.make_spline(dev_img, 3, 3, bcs=(S.REFLECT, S.PERIODIC),
                              spherical=True), 3)
    del dev_img
    print(f"source: {w}x{h} RGB, table {tuple(src.spl.coeff.shape)}; "
          f"make_mount_source {source_ms:.1f} ms (host copy included), "
          f"prefilter alone {prefilter_ms:.3f} ms (median of 3)",
          flush=True)

    fw = 2048
    plan = plan_for(fct, P.CUBEMAP, fw, 6 * fw, 90, 3)
    frame, _ms, main_n = render(plan, src, "main path", 1, 0)

    # bands of every face against the port's exact path on the card
    bands = [(f * fw + r0, f * fw + r1) for f in range(6)
             for r0, r1 in ((0, 8), (fw // 2 - 4, fw // 2 + 4),
                            (fw - 8, fw))]
    worst_band = band_errors(plan, src, frame, bands, False)[0]
    print(f"main path vs exact path, 18 bands of 8 rows over 6 faces: max "
          f"abs diff {worst_band:.3e} (bound {MAIN_BOUND:g})", flush=True)
    check(worst_band <= MAIN_BOUND, "frame disagrees with exact path")

    # landmark: the front face's centre samples lon=0, lat=0; the ramp
    # fixture holds (x, y, x*y) there with x = 4095.5/8191, y = 0.5
    c = 4 * fw + fw // 2
    centre = frame[c - 1:c + 1, fw // 2 - 1:fw // 2 + 1].mean(axis=(0, 1))
    want = np.array([4095.5 / 8191, 2047.5 / 4095,
                     4095.5 / 8191 * 2047.5 / 4095])
    lm_err = float(np.abs(centre - want).max())
    print(f"landmark front-face centre {centre.tolist()} vs "
          f"{want.tolist()}: {lm_err:.2e} (bound {LANDMARK_BOUND:g})",
          flush=True)
    check(lm_err <= LANDMARK_BOUND, "front-face centre misses lon=0,lat=0")

    err_main, _e, out_k, out_p = kernel_vs_plain(plan, src, 3)
    del out_k, out_p
    print(f"inline vs plain at main-path shape: max abs diff "
          f"{err_main:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    check(err_main <= KERNEL_BOUND, "kernel disagrees at main-path shape")
    t_main = time_inline(plan, src, "main path")
    del src
    torch.cuda.empty_cache()

    # ---- 4. config 2r: the cubemap frame back to an 8K equirect -------
    cfct = make_facet(P.CUBEMAP, fw, 6 * fw, math.pi / 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csrc = CBM.make_cubemap_source(cfct, frame.reshape(6, fw, fw, 3), 3, 3,
                                   128, 64, device="cuda")
    torch.cuda.synchronize()
    ir_ms = (time.perf_counter() - t0) * 1000.0
    print(f"2r source: 6x{fw} cubemap, IR table "
          f"{tuple(csrc.spl.coeff.shape)} "
          f"({csrc.spl.coeff.numel() * 4 / 1e6:.1f} MB); "
          f"make_cubemap_source {ir_ms:.1f} ms (host copy, support fill, "
          f"prefilter)", flush=True)
    plan2r = plan_for(cfct, P.SPHERICAL, w, h, 360, 3)
    back, _ms, r2_n = render(plan2r, csrc, "config 2r", 1, 0)
    bands2r = [(r, r + 8) for r in (0, h // 4, h // 2 - 4, 3 * h // 4,
                                    h - 8)]
    err2r, edge2r = band_errors(plan2r, csrc, back, bands2r, True)
    print(f"config 2r vs exact path, 5 bands of 8 rows: max abs diff "
          f"{err2r:.3e} ({edge2r} px at cube-face edges excluded; bound "
          f"{PATH_BOUND:g})", flush=True)
    check(err2r <= PATH_BOUND, "config 2r disagrees with exact path")
    centre = back[h // 2 - 1:h // 2 + 1, w // 2 - 1:w // 2 + 1].mean(
        axis=(0, 1))
    rt_err = float(np.abs(centre - want).max())
    print(f"config 2r round trip: equirect centre {centre.tolist()} vs the "
          f"ramp's {want.tolist()}: {rt_err:.2e} (bound "
          f"{ROUNDTRIP_BOUND:g})", flush=True)
    check(rt_err <= ROUNDTRIP_BOUND, "config 2r round trip misses the ramp")
    del frame, back
    err2r_k, edge2r_k, out_k, out_p = kernel_vs_plain(plan2r, csrc, 3)
    del out_k, out_p
    print(f"inline vs plain at config 2r: max abs diff {err2r_k:.3e} "
          f"({edge2r_k} px at cube-face edges excluded; bound "
          f"{KERNEL_BOUND:g})", flush=True)
    check(err2r_k <= KERNEL_BOUND, "inline kernel disagrees at config 2r")
    t_2r = time_inline(plan2r, csrc, "config 2r")
    del csrc
    torch.cuda.empty_cache()

    # ---- 5. configs 3 and 3b: biatan6 -> stereographic / fisheye ------
    rng = np.random.default_rng(3)
    bfct = make_facet(P.BIATAN6, 1024, 6144, math.radians(100))
    faces = rng.uniform(0, 1, (6, 1024, 1024, 3)).astype(np.float32)
    bsrc = CBM.make_cubemap_source(bfct, faces, 3, 3, 128, 64,
                                   device="cuda")
    print(f"3/3b source: biatan6 6x1024 (fov 100), IR table "
          f"{tuple(bsrc.spl.coeff.shape)}", flush=True)
    t_planar, planar_n = {}, {}
    for name, proj, hfov, ypr in (("config 3", P.STEREOGRAPHIC, 150,
                                   (35, 20, 0)),
                                  ("config 3b", P.FISHEYE, 170,
                                   (-25, 15, 0))):
        p3 = plan_for(bfct, proj, 1920, 1152, hfov, 3, ypr)
        out3, _ms, n3 = render(p3, bsrc, name, 0, 1)
        planar_n[name] = n3["resample_planar"]
        err3, _e = band_errors(p3, bsrc, out3, [(0, 8), (572, 580),
                                                (1144, 1152)], False)
        print(f"{name} vs exact path, 3 bands of 8 rows: max abs diff "
              f"{err3:.3e} (bound {PATH_BOUND:g})", flush=True)
        check(err3 <= PATH_BOUND, f"{name} disagrees with exact path")
        t_planar[name] = time_planar(p3, bsrc, name)
        sx, sy = t_planar[name].pop("sx"), t_planar[name].pop("sy")
        if name == "config 3":
            deg1 = library_bilinear(bsrc, sx, sy)
            print(f"config 3 at degree 1: resample_planar {deg1['ms']:.4f} "
                  f"ms, grid_sample (bilinear, align_corners, border) "
                  f"{deg1['library_ms']:.4f} ms (median of 20 each); bound "
                  f"{deg1['bound_ms']:.4f} ms by {deg1['bound_by']}; max abs "
                  f"diff {deg1['max_abs_err_vs_library']:.3e} (bound "
                  f"{LIBRARY_BOUND:g})", flush=True)
            check(deg1["max_abs_err_vs_library"] <= LIBRARY_BOUND,
                  "degree-1 planar kernel differs from grid_sample")
        del sx, sy
    del bsrc
    torch.cuda.empty_cache()

    # ---- 6. a partial lens-corrected facet and a translated facet -----
    lf = make_facet(P.RECTILINEAR, 1536, 1152, math.radians(72),
                    a=0.01, b=-0.02, c=0.005)
    limg = rng.uniform(0, 1, (1152, 1536, 3)).astype(np.float32)
    lsrc = E.make_mount_source(lf, limg, 3, 3, device="cuda")
    p5 = plan_for(lf, P.SPHERICAL, 4096, 2048, 360, 3)
    out5, _ms, n5 = render(p5, lsrc, "lens facet", 0, 1)
    planar_n["lens facet"] = n5["resample_planar"]
    covered = float((out5 != 0).any(axis=-1).mean())
    err5, _e = band_errors(p5, lsrc, out5, [(704, 712), (1020, 1028),
                                            (1336, 1344)], False)
    print(f"lens facet: {100 * covered:.1f}% of the equirect covered; vs "
          f"exact path, 3 bands of 8 rows: max abs diff {err5:.3e} (bound "
          f"{PATH_BOUND:g})", flush=True)
    check(0.02 < covered < 0.5, "lens facet coverage implausible")
    check(err5 <= PATH_BOUND, "lens facet disagrees with exact path")
    t_planar["lens facet"] = time_planar(p5, lsrc, "lens facet")
    t_planar["lens facet"].pop("sx")
    t_planar["lens facet"].pop("sy")

    tf = make_facet(P.RECTILINEAR, 640, 480, math.radians(80),
                    tr_x=0.2, tr_y=-0.1, tr_z=0.15, yaw=math.radians(10))
    tsrc = E.make_mount_source(tf, limg[:480, :640], 3, 3, device="cuda")
    pt = plan_for(tf, P.RECTILINEAR, 1024, 768, 100, 3, (5, 0, 0))
    check(pt.planar_to_ray[0] is not None, "translated facet not generic")
    outt, _ms, nt = render(pt, tsrc, "translated facet", 0, 1)
    planar_n["translated facet"] = nt["resample_planar"]
    covered = float((outt != 0).any(axis=-1).mean())
    errt, _e = band_errors(pt, tsrc, outt, [(0, 8), (380, 388),
                                            (760, 768)], False)
    print(f"translated facet: {100 * covered:.1f}% of the view covered; vs"
          f" exact path, 3 bands of 8 rows: max abs diff {errt:.3e} (bound "
          f"{PATH_BOUND:g})", flush=True)
    check(0.05 < covered < 0.95, "translated facet coverage implausible")
    check(errt <= PATH_BOUND, "translated facet disagrees with exact path")
    del lsrc, tsrc

    # ---- 7. the record ------------------------------------------------
    t3 = t_planar["config 3"]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [
        {"name": "resample_inline", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/resample_inline.cu",
         "replaces": "envutil_tpu/ops/pallas_resample.py:1385",
         "launches": main_n["resample_inline"], "max_abs_err": err_main,
         "ms": t_main["ms"], "plain_ms": t_main["plain_ms"],
         "bound_ms": t_main["bound_ms"], "bound_by": t_main["bound_by"],
         "library_ms": None,
         "small_case_max_abs_err": worst_inline,
         "frame_ms": t_main["frame_ms"], "prefilter_ms": prefilter_ms,
         "config_2r": dict(t_2r, launches=r2_n["resample_inline"],
                           max_abs_err=err2r_k)},
        {"name": "resample_planar", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/resample_planar.cu",
         "replaces": "envutil_tpu/ops/pallas_resample.py:1070 (K2), "
                     "envutil_tpu/ops/pallas_resample.py:822 (K5)",
         "launches": planar_n["config 3"],
         "max_abs_err": t3["max_abs_err"],
         "ms": t3["ms"], "plain_ms": t3["plain_ms"],
         "bound_ms": t3["bound_ms"], "bound_by": t3["bound_by"],
         "library_ms": None,
         "degree1": dict(deg1, library="grid_sample bilinear"),
         "small_case_max_abs_err": worst_planar,
         "launches_by_path": planar_n,
         "paths": t_planar}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
