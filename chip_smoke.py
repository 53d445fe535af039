#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, renders the
main path (8192x4096 RGB equirect, degree-3 prefilter and b-spline ->
2048x12288 cubemap) through the port's user entry points, checks the
result, and times the kernel, its plain version and the steady-state
frame with CUDA events. Every phase runs; any failure raises and the
script exits non-zero. It exits non-zero without a result when no CUDA
card is available.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

# kernel vs plain version, both on the card with the same float32
# formulas: nvcc contracts multiply-adds into FMAs (ray matrix, gate
# affine, Horner weights, tap sums) where the plain version rounds each
# step, and atan2f may differ from torch.atan2 by an ulp or two. Both
# move the spline coordinates by ~1e-5 px; times the spline gradient of
# the uniform-noise test sources (prefiltered coefficients reach ~+-3)
# that is ~1e-4, so 1e-3 holds with margin while any indexing or
# weighting fault shows as O(0.1..1).
KERNEL_BOUND = 1e-3
# degree 0 is nearest-neighbour and jumps at cell boundaries: a pixel
# whose coordinate lies within this many px of a boundary may pick the
# other cell under the ulp-level differences above, and is excluded
DEG0_BOUNDARY_PX = 1e-3
# main path: the port's exact path on the card (stepper rays,
# normalisation, ray_to_ll, gates, eval_spline) computes the same
# coordinates in a different float32 order; on the smooth ramp fixture
# that is ~1e-6, but the horizontal ramp wraps from 1 to 0 at the
# periodic seam, where the spline's gradient is O(1) per px
MAIN_BOUND = 1e-3
# front-face centre against the ramp fixture's analytic value
LANDMARK_BOUND = 1e-3

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


def make_facet(projection, w, h, hfov):
    from envutil_tpu_torch.core.facet import Facet
    from envutil_tpu_torch.core.metrics import get_step
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(projection, w, h, hfov)
    f.step = get_step(projection, w, h, hfov)
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


def kernel_vs_plain(plan, src, degree):
    """Launch the kernel and its plain version on the same operands;
    returns (max abs difference, kernel output)."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    coeff = src.spl.coeff
    y0, y1, x0, x1 = FP.frame_window(plan)
    shape = (y1 - y0, x1 - x0, coeff.shape[-1])
    kw = dict(degree=degree, tmode=ops["tmode"], consts=ops["consts"],
              row0=ops["row0"], face_rows=ops["face_rows"])
    args = (coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
    out_k = R.resample_inline(torch.empty(shape, device=coeff.device),
                              *args, **kw)
    out_p = R.resample_inline_plain(
        torch.empty(shape, device=coeff.device), *args, **kw)
    torch.cuda.synchronize()
    diff = (out_k - out_p).abs()
    if degree == 0:
        sx, sy = R.inline_coords(ops["xfeat"], ops["yfeat"],
                                 ops["bmats"], tmode=ops["tmode"],
                                 consts=ops["consts"], row0=ops["row0"],
                                 face_rows=ops["face_rows"])

        def near(s):
            f = torch.remainder(s + 0.5, 1.0)
            return (f < DEG0_BOUNDARY_PX) | (f > 1.0 - DEG0_BOUNDARY_PX)
        diff = torch.where((near(sx) | near(sy))[..., None], 0.0, diff)
    check(bool(torch.isfinite(out_k).all()), "kernel output not finite")
    return float(diff.max()), out_k, out_p


def phase_small_cases():
    """Kernel against plain version at small shapes: degrees x channel
    counts on a cubemap target, and every target mode."""
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.runtime.render import build_plan
    rng = np.random.default_rng(7)
    fct = make_facet(P.SPHERICAL, 256, 128, 2 * math.pi)
    cases = [(d, c, P.CUBEMAP, 64, 384, 90, (0, 0, 0))
             for d in (0, 1, 2, 3, 5) for c in (1, 3, 4)]
    cases += [(3, 3, P.RECTILINEAR, 96, 64, 75, (30, 10, 5)),
              (3, 3, P.SPHERICAL, 128, 64, 360, (20, -30, 10)),
              (3, 3, P.CYLINDRICAL, 128, 64, 200, (10, 5, 0)),
              (3, 3, P.BIATAN6, 32, 192, 90, (5, 5, 5))]
    worst = 0.0
    for degree, nch, proj, w, h, hfov, ypr in cases:
        img = rng.uniform(0, 1, (128, 256, nch)).astype(np.float32)
        src = E.make_mount_source(fct, img, degree, degree, device="cuda")
        plan = build_plan(make_args(fct, proj, w, h, hfov, degree, ypr,
                                    nch), [fct])
        err = kernel_vs_plain(plan, src, degree)[0]
        print(f"kernel vs plain: degree {degree} C {nch} "
              f"{proj.name.lower()} {w}x{h}: max abs diff {err:.3e} "
              f"(bound {KERNEL_BOUND:g})", flush=True)
        check(err <= KERNEL_BOUND, f"kernel disagrees with plain: {err}")
        worst = max(worst, err)
    return worst


def ramp_fixture(w=8192, h=4096):
    """bench.py's fixture: RGB ramps (x, y, x*y) over the equirect."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32),
                         indexing="ij")
    return np.stack([xx, yy, (xx * yy)], axis=-1)


def touched_table_bytes(plan, src):
    """Bytes of the coefficient table that the frame's taps read:
    every entry that some pixel's (n+1)^2 window covers, counted
    once."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    n = src.spl.degree
    hp, wp, nch = src.spl.coeff.shape
    sx, sy = R.inline_coords(ops["xfeat"], ops["yfeat"], ops["bmats"],
                             tmode=ops["tmode"], consts=ops["consts"],
                             row0=ops["row0"], face_rows=ops["face_rows"])
    shift = 0.0 if n % 2 else 0.5
    bx = torch.floor(sx + shift).to(torch.int64) - n // 2
    by = torch.floor(sy + shift).to(torch.int64) - n // 2
    del sx, sy
    touched = torch.zeros(hp * wp, dtype=torch.bool, device=bx.device)
    for j in range(n + 1):
        for k in range(n + 1):
            idx = ((by + j) * wp + bx + k).clamp_(0, hp * wp - 1)
            touched[idx.reshape(-1)] = True
    return int(touched.sum()) * nch * 4, hp * wp * nch * 4


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.ops import spline as S
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime import render as RD

    # ---- 1. card, versions, build -------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    nvcc = subprocess.run([R._Library._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}", flush=True)
    build_s = R.build()
    regs = [int(line.split("Used ")[1].split(" registers")[0])
            for line in R.build_log().splitlines()
            if "Used " in line and " registers" in line]
    spills = [line for line in R.build_log().splitlines() if "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    print(f"kernel build: {build_s:.1f} s; {len(regs)} instantiations, "
          f"registers {min(regs) if regs else '?'}..{max(regs) if regs else '?'}"
          f", spill lines: {len(spills)}", flush=True)
    print('kernels: ["resample_inline"]', flush=True)

    # ---- 2. kernel against plain version at small shapes --------------
    worst_small = phase_small_cases()

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
    plan = RD.build_plan(make_args(fct, P.CUBEMAP, fw, 6 * fw, 90, 3),
                         [fct])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    R.resample_inline.launches = 0
    t0 = time.perf_counter()
    frame = RD.render_frame(plan, [src], device="cuda")
    render_ms = (time.perf_counter() - t0) * 1000.0
    launches = R.resample_inline.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"render_frame: {frame.shape} in {render_ms:.1f} ms (first "
          f"call, host copy included); resample_inline launches {launches}"
          f"; peak device memory {peak / 2**20:.1f} MiB", flush=True)
    check(launches > 0, "the main path did not launch resample_inline")
    check(frame.shape == (6 * fw, fw, 3), f"frame shape {frame.shape}")
    check(bool(np.isfinite(frame).all()), "frame not finite")

    # bands of every face against the port's exact path on the card
    worst_band = 0.0
    for f in range(6):
        for r0, r1 in ((0, 8), (fw // 2 - 4, fw // 2 + 4), (fw - 8, fw)):
            win = (f * fw + r0, f * fw + r1, 0, fw)
            exact = RD._render_window(plan, [src], win).cpu().numpy()
            err = float(np.abs(frame[win[0]:win[1]] - exact).max())
            worst_band = max(worst_band, err)
    print(f"frame vs exact path, 18 bands of 8 rows over 6 faces: max abs "
          f"diff {worst_band:.3e} (bound {MAIN_BOUND:g})", flush=True)
    check(worst_band <= MAIN_BOUND, f"frame disagrees with exact path")

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

    # ---- 4. timing ----------------------------------------------------
    err_main, out_k, out_p = kernel_vs_plain(plan, src, 3)
    del out_k, out_p
    print(f"kernel vs plain at main-path shape: max abs diff "
          f"{err_main:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    check(err_main <= KERNEL_BOUND, "kernel disagrees at main-path shape")

    ops = FP.frame_operands(plan, src)
    kw = dict(degree=3, tmode=ops["tmode"], consts=ops["consts"],
              row0=ops["row0"], face_rows=ops["face_rows"])
    args = (src.spl.coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
    buf = torch.empty((6 * fw, fw, 3), device="cuda")
    for _ in range(3):
        R.resample_inline(buf, *args, **kw)
    kernel_ms = events_ms(lambda: R.resample_inline(buf, *args, **kw), 20)
    plain_ms = events_ms(lambda: R.resample_inline_plain(buf, *args, **kw),
                         3)
    frame_ms = events_ms(lambda: FP.fused_frame(plan, src, out=buf), 20)
    n_px = 6 * fw * fw
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"steady-state frame (fused_frame into one reused buffer, median "
          f"of 20): {frame_ms:.4f} ms = {n_px / 1e3 / frame_ms:.1f} Mpix/s;"
          f" kernel alone {kernel_ms:.4f} ms; plain version "
          f"{plain_ms:.3f} ms; clocks/power/temp after: {smi}", flush=True)

    table_bytes, full_table = touched_table_bytes(plan, src)
    feat_bytes = sum(t.numel() * 4 for t in args[1:])
    out_bytes = n_px * 3 * 4
    bytes_ms = (table_bytes + out_bytes + feat_bytes) / HBM_BYTES_PER_S * 1e3
    # per pixel: 9 mul + 6 add for the ray, ~20 flops per atan2 (x2)
    # and the sqrt, 2 gate affines, 2 x (n+1) Horner rows of n FMAs,
    # (n+1)^2 x C tap FMAs and (n+1) x C row FMAs (an FMA is 2 flops)
    n = 3
    flops_px = (15 + 45 + 8 + 2 * (n + 1) * n * 2
                + (n + 1) ** 2 * 3 * 2 + (n + 1) * 3 * 2)
    ops_ms = n_px * flops_px / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"bound: table bytes touched {table_bytes / 1e6:.1f} MB of "
          f"{full_table / 1e6:.1f} MB, output {out_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms at 3.35 TB/s; {flops_px} flop/px -> "
          f"{ops_ms:.4f} ms at 67 TFLOP/s", flush=True)

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "resample_inline", "route": "cuda",
        "source": "envutil_tpu_torch/csrc/resample_inline.cu",
        "replaces": "envutil_tpu/ops/pallas_resample.py:1385",
        "launches": launches, "max_abs_err": err_main,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "small_case_max_abs_err": worst_small,
        "frame_ms": frame_ms, "prefilter_ms": prefilter_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
