#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [PARENT_ROOT]

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
  fisheye (hfov 170, yaw -25, pitch 15) (resample_planar_chain);
- a partial lens-corrected facet (1536x1152 rectilinear, hfov 72,
  a, b, c = 0.01, -0.02, 0.005) -> 4096x2048 equirect
  (resample_planar_chain), and a translated facet -> 1024x768, untwined
  and --twine 2 (the planes forms: resample_planar with the validity
  mask, resample_twined with per-pixel tap weights, each also held
  against its plain version and timed on those operands);
- twined, config 4: the 8K ramp equirect at degree 1 -> 2048x1280
  rectilinear, hfov 100, automatic twine (4 taps), the same view at
  pitch 80, yaw 180 (it holds a pole and the periodic seam), and the
  16384x8192 equirect -> the same view (16 taps)
  (resample_inline_twined);
- twined, config 3: a smooth biatan6 source -> 1920x1152 stereographic,
  --twine 2, and the lens facet -> 4096x2048 equirect, --twine 2
  (resample_twined_chain);
- untwined stitches of benchmarks.py, each -> a 4096x2048 equirect:
  config 5 (three 2048x1536 rectilinear facets, voronoi), the same
  facets with alpha (voronoi_plus), config 5b (six 1536x1152
  lens-corrected facets, voronoi) and config 5c (three 4096x2048
  brackets, hdr_merge; resample_inline) and config 5d (six 1536x1152
  rectilinear facets, yaw 60 i), each checked against the exact path.
  A voronoi stitch renders through the voronoi route
  (fastpath.voronoi_frame: the champion planes built once per plan by
  the champion pass, csrc/champion.cu, then one launch per facet,
  resample_planar_chain in its champion mode, into one frame); the
  others through the stack route (fastpath.multi_frame: one launch per
  facet into a pixel stack, resample_planar_chain with its score
  output, and the synopsis of the stacks), timed per facet, combine and
  frame; the stack route is timed on the voronoi stitches too, as the
  reference of ``champion_path``;
- twined stitches: config 5d at 2x2 taps (the 4-tap twine its comment in
  benchmarks.py names) and at 2x1 (what its twine=1 gives) through the
  voronoi route (one launch per facet of resample_twined_chain in its
  tapsel mode, each tap counted where the facet champions it, added
  into the frame), config 5 with alpha and config 5c at 2x2 through the
  stack route once per tap of the spread (one one-tap launch per facet
  and tap, the twined chain form with its score for voronoi_plus,
  resample_inline_twined for hdr_merge brackets, then that tap's
  combine, summed by weight), each against the exact path with the
  launches counted; config 5d at one tap off the pixel centre; the
  lens and translated facets stitched under twining (the translated
  facet through the twined planes form with its champion planes as tap
  weights); and a twined stereographic view of the pole of an 8192x4096
  smooth sphere (the twined chain form), held against the exact path
  below 80 degrees of latitude and reported above;
- PTO jobs: ``--single 0`` on config 5b (facet 0's 1536x1152 lens
  geometry re-created from all six facets through the inverse lens LUT:
  the coordinate pass and one resample_planar launch a facet, the
  amplify of facet 0's brighten 2); config 5b's facets with a 5% lens
  crop each and exclude polygons on facets 1 and 3 (alpha synthesized
  on the host, four channels, voronoi_plus through resample_planar_chain);
  ``--mask_for 1 --nchannels 1`` on config 5 (paint sources, the exact
  route, held to the kernels' champion); and config 5d's facets ->
  512x256 under ``--twine 2 --twine_precise`` (the exact route, beside
  the twined chain route it replaced, whose deviation is reported).

Then the image I/O and serving surfaces on config 2's source, each
through the entry point a user calls (``surface_phases``): the CLI's
main-path job and the same job written in ACEScg, two lines streamed
through '-', seven requests to ``serve.render_loop`` in a thread (four
1920x1080 views, a refined 960x540 view through the inline twined
kernel, a missing file answered with an error, one more view), four
visor frames over shared memory with a full queue and a bad job, and
``render_to_store`` of the cubemap in 512-row strips; every frame equal
to ``render_frame`` of the same job on the card (serve and visor: its
``to_screen``), bit for bit. The script needs no OpenEXR and no
imageio: the EXR shim's C ABI is stood in for by ``MemoryExr``, and the
source's table is built with the loader's ``_build`` into the asset
cache.

Then --mesh and --shard_table through ``render_frame(mesh_n=4,
devices=[cuda:0] * 4)`` (``mesh_phases``: four bands on this card, so
that every band decomposition, band launch and ring hand-over runs on a
one-card machine; over all cards as well where there are two or more):
the main path, configs 3, 4 twined, 5, 5d twined at 2x2 taps (both
on the voronoi route, each band with its own champion planes) and the
degree-9 view, each frame bit-equal to the one-device frame with its
launches counted and no kernel operands, block lists or champion
planes built by its second and third frames, its time beside the
one-device frame's; --shard_table on the main path and config 5
against ``fastpath.exact_frame`` (rtol = atol = 4e-7); and
``mesh_n=7`` on the 12288-row stripe, which falls back to one device
with its message.

Both chain forms' score outputs are held against their plain versions
over every small chain case (the twined one at one tap), with the
pixels required bit-equal to the launch without it.

The voronoi route: every small chain case, untwined and twined, also
runs as the one facet of a voronoi stitch (``champion_case``): the
champion kernel's planes against its plain version's (equal away from
window and face edges), the champion lists against theirs, and the
chain form's champion mode (untwined) or tapsel mode (twined, 1 and 3
channels) on those planes against its plain version, float32 and bf16
tables. At full size (``champion_path``: configs 5, 5b, 5d, 5d at 2x2,
2x1 and one tap, config 5 on bf16 tables, the lens and translated
stitch untwined and twined) the champion planes are held against the
first-wins argmax of the stack route's one-tap scores and against the
plain pass (equal but at near-tied scores, counted per tap), the frame
against the stack route (1e-5, window-edge and near-tied pixels
excluded and counted) and the exact path (5e-3, ``stitch_errors``),
with F launches a frame, one champion pass per plan and none in later
frames, no call of the stack route; then timed: the frame single and
in bursts in turns against the stack route, each facet's launch and
its plain version beside its bound, the champion pass and its plain
version beside its bound, the first ``render_frame`` and the peak
device memory of a frame of each route.

The compact grid: the chain forms launch over a block list, the 32x8
blocks their rays can reach, which a coverage pass (chain_blocks,
csrc/chain_blocks.cu) builds once per plan. Every small chain case whose
source does not cover every ray holds the coverage kernel's list
against its plain version (the blocks that differ counted) and its
launch on that list against the full-window launch. At full size
(``compact_path``: configs 5, 5b, 5 with alpha, 5d, the lens facet
untwined and twined, the lens and translated stitch untwined and
twined, 5d at 2x2, 2x1 and one tap, 5 with alpha twined and 5b with
crops) every launch of the frame on its list is held bit for bit
against the same kernel over the whole window, pixels and score, and
the frame against the frame with every launch over the whole window
(``full_window``); the two are timed in turns, launches and frames,
single and in bursts, beside the share of blocks listed per facet, the
coverage pass's time against its plain version and bound, and the
first ``render_frame``. The --mesh frames of configs 5 and 5d twined
are held to their full-window frames as well, and launch nothing in
the bands their facets do not reach.

bf16 tables (--coeff bf16): every small phase runs its cases again on
bfloat16 tables (each kernel against its plain version on the same
table, the inline kernel's two branches bit-equal), and the main path,
config 3 (the planar chain kernel), config 3 twined (the twined chain
kernel), the translated facet untwined and twined (the planes forms),
config 5 (a stitch) and config 4b (the 16384x8192 equirect's bf16
table, 0.81 GB, through the inline twined kernel with 16 taps, held to
40 dB against its float32 frame) render at full size on bf16 tables,
each against the exact path on the same table. A degree-9 job (config
3's view at a reduced size) renders through the exact-path route on the
card and is held against the CPU's exact path.

The inline kernel (resample_inline) stages each block's source window
in shared memory and gathers from global memory where a window does not
fit; every comparison of it with its plain version runs both branches
(the default window budget, a small one, and 0, which forces the direct
gather everywhere) and requires the outputs to be bit-equal, and its
full-size paths time the default budget beside the direct branch in the
same run. What share of blocks and pixels stage is printed on a line of
its own as the plain window model's reckoning (ops/resample.
window_model), not as a reading of the kernel.

The inline twined kernel takes a spherical source's taps as increments
from the centre ray's pickup where two or more taps are summed: each of
its paths prints the share of pixel-taps that take the increment (as
its plain version counts them), its operations counted for the
increment beside the count with the full pickup for every tap (the
bound takes the cheaper), and the kernel's registers and spills. Given
a parent checkout (``PARENT_ROOT``, e.g. an unpacked ``git archive`` of
the parent commit), its K4 is built from that checkout's source beside
this one's and each K4 path (config 4, pole and seam, 16K, 4b, and the
one-tap launches of config 5c twined) times the two in turns on the
same operands (``k4_turns``); without one those lines say so.

Every phase runs; any failure raises and the script exits non-zero. It
exits non-zero without a result when no CUDA card is available. It
prints its own command time (the build included) before the record. The
second-to-last line is the kernels' JSON record (each kernel with its
launches on the --mesh cases under ``mesh``); the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import re
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

# the twined inline route against the exact path: both linearise in ray
# space from the same three ray grids, so only float32 order differs, as
# for PATH_BOUND; the 16K table's coordinates reach 16392, where a
# float32 ulp is 2e-3 px and the ramp's seam step has gradient ~1 per px
TWINED_INLINE_BOUND = 5e-3
# the twined planar route against the exact path: the kernel deflects
# in coordinate space (its operands are coordinate derivative planes)
# where the exact path deflects the ray, so the taps sit a second-order
# term apart: half the tap offset squared times the mapping's curvature,
# ~1e-4 source px at these sizes, times the source's gradient (uniform
# noise: up to ~4 per px). Taps of a cubemap source that cross a face
# edge read the centre face's support frame, which the IR build filled
# by bilinear reprojection, where the exact path reads the other face;
# config 3 twined therefore runs on a smooth source.
TWINED_PLANAR_BOUND = 5e-3
# pixels within this many degrees of a cube-face edge or of a pole, or
# this many pixels of the periodic seam, form the named regions whose
# error is reported on its own
REGION_DEG = 1.0

# a window budget that only some blocks of the small cases fit, so that
# one launch takes both branches
SMALL_BUDGET = 4096

# a bf16 frame against the float32 frame of the same job: the JAX
# package's bar for --coeff bf16 (tests/test_modes.py)
BF16_DB = 40.0
# the card's exact-path route against the CPU's exact path: the same
# float32 formulas, but the card's atan2/sqrt/division and PyTorch's CPU
# kernels may differ by an ulp, which moves coordinates by ~1e-5 px
# (times the noise's gradient), and sums in another order; an indexing
# or weighting fault shows as O(0.1..1)
EXACT_BOUND = 1e-3

T_START = time.perf_counter()

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


def with_coeff(src, coeff_dtype):
    """``src`` with its table in the storage dtype ``coeff_dtype`` ("f32"
    or "bf16"), rounded from its float32 build as the loader rounds it
    (ops/spline.storage_spline)."""
    import dataclasses
    from envutil_tpu_torch.ops import spline as S
    return dataclasses.replace(src, spl=S.storage_spline(src.spl,
                                                         coeff_dtype))


def psnr(a, b):
    """PSNR in dB of two host frames with values in [0, 1]."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * math.log10(1.0 / mse) if mse > 0 else 999.0


def dtype_turns(name, launch, burst=20):
    """One kernel of a path on its float32 and its bf16 table, timed in
    turns (f32, bf16, bf16, f32): ``launch(coeff_dtype)`` launches it
    once. Each turn times single launches between two events (median of
    20), which holds the wrapper's host time, and bursts of ``burst``
    launches between two events (median of 5, per launch), which hides
    it. Returns {dtype: {"ms": ..., "burst_ms": ...}}, each the mean of
    its two turns."""
    for _ in range(3):
        launch("f32")
        launch("bf16")
    single = {"f32": [], "bf16": []}
    bursts = {"f32": [], "bf16": []}
    for d in ("f32", "bf16", "bf16", "f32"):
        single[d].append(events_ms(lambda: launch(d), 20))

        def many():
            for _ in range(burst):
                launch(d)
        bursts[d].append(events_ms(many, 5) / burst)
    out = {d: dict(ms=float(np.mean(single[d])),
                   burst_ms=float(np.mean(bursts[d]))) for d in single}
    print(f"{name}: float32 and bf16 tables in turns (f32, bf16, bf16, f32):"
          f" single launches {single['f32'][0]:.4f}, {single['bf16'][0]:.4f},"
          f" {single['bf16'][1]:.4f}, {single['f32'][1]:.4f} ms; bursts of "
          f"{burst}, per launch {bursts['f32'][0]:.4f}, "
          f"{bursts['bf16'][0]:.4f}, {bursts['bf16'][1]:.4f}, "
          f"{bursts['f32'][1]:.4f} ms; bf16 / f32: single "
          f"{out['bf16']['ms'] / out['f32']['ms']:.3f}, burst "
          f"{out['bf16']['burst_ms'] / out['f32']['burst_ms']:.3f}; "
          f"clocks/power/temp after: {smi_now()}", flush=True)
    return out


# The parent checkout's inline twined kernel (``python3 chip_smoke.py
# PARENT_ROOT``): built from that checkout's own source and headers into
# this checkout's build directory, launched through this checkout's
# wrapper (the C entry point is the same), so that K4's times before and
# after a change are taken in turns on the same operands in one run.
PARENT = {}


def parent_k4_library(root):
    """K4's library as the checkout at ``root`` builds it."""
    import pathlib
    from envutil_tpu_torch.ops import kernels as K
    from envutil_tpu_torch.ops import resample as R
    lib = K.Library(R._INLINE_TWINED.source.name, R._INLINE_TWINED.symbols)
    lib.source = (pathlib.Path(root).resolve() / "envutil_tpu_torch" / "csrc"
                  / lib.source.name)
    if not lib.source.exists():
        raise SystemExit(f"chip_smoke: no {lib.source}")
    return lib


def with_k4_library(lib, fn):
    """``fn()`` with the inline twined wrapper launching ``lib``."""
    from envutil_tpu_torch.ops import resample as R
    saved, R._INLINE_TWINED = R._INLINE_TWINED, lib
    try:
        return fn()
    finally:
        R._INLINE_TWINED = saved


def k4_turns(name, launch, out, burst=20):
    """K4 of the parent checkout (before) and of this one (after) on the
    same operands, in turns (before, after, after, before): bursts of
    ``burst`` launches between two events (median of 5, per launch),
    after single launches (median of 20) of each; ``launch()`` launches
    K4 once into ``out``. Also the two outputs' largest difference.
    Returns a record, or None without a parent checkout."""
    import torch
    lib = PARENT.get("k4")
    if lib is None:
        print(f"{name}: K4 before/after: not measured (no parent checkout "
              f"given: python3 chip_smoke.py PARENT_ROOT)", flush=True)
        return None

    def before():
        with_k4_library(lib, launch)
    before()
    torch.cuda.synchronize()
    old = out.clone()
    launch()
    torch.cuda.synchronize()
    diff = float((out - old).abs().max())
    del old
    rec = dict(zip(("before", "after"),
                   ab_turns(before, launch, burst=burst)))
    single = {k: rec[k].pop("turns") for k in rec}
    bursts = {k: rec[k].pop("burst_turns") for k in rec}
    rec["after_vs_before_max_abs"] = diff
    print(f"{name}: K4 before (parent checkout) and after, in turns (before,"
          f" after, after, before): single launches "
          f"{single['before'][0]:.4f}, {single['after'][0]:.4f}, "
          f"{single['after'][1]:.4f}, {single['before'][1]:.4f} ms; bursts "
          f"of {burst}, per launch {bursts['before'][0]:.4f}, "
          f"{bursts['after'][0]:.4f}, {bursts['after'][1]:.4f}, "
          f"{bursts['before'][1]:.4f} ms; after / before: single "
          f"{rec['after']['ms'] / rec['before']['ms']:.3f}, burst "
          f"{rec['after']['burst_ms'] / rec['before']['burst_ms']:.3f}; "
          f"outputs differ by {diff:.3e}; clocks/power/temp after: "
          f"{smi_now()}", flush=True)
    return rec


def share_text(share):
    return ("every tap through the full pickup" if share is None else
            f"{100 * share:.3f}% of pixel-taps through the increment (the "
            f"plain version's count)")


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
              nch=3, twine=0):
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
    if isinstance(twine, int) and twine:
        # -1: automatic, from the magnification; n > 0: an n x n box
        a.twine = twine
        a.twine_setup()
    elif twine:
        a.twine, a.twine_spread = 1, list(twine)   # the taps themselves
    return a


def plan_for(fct, projection, w, h, hfov_deg, degree, ypr=(0, 0, 0), nch=3,
             twine=0):
    from envutil_tpu_torch.runtime.render import build_plan
    return build_plan(make_args(fct, projection, w, h, hfov_deg, degree, ypr,
                                nch, twine), [fct])


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


def staged_equals_direct(launch, direct, budgets, what):
    """Run ``launch(window_bytes)`` at each staging budget and require
    the output to equal ``direct`` (the budget-0 output) bit for bit;
    returns the output at the first budget."""
    import torch
    first = None
    for budget in budgets:
        out = launch(budget)
        torch.cuda.synchronize()
        check(bool(torch.equal(out, direct)),
              f"{what}: the staged branch (window budget {budget}) and the "
              f"direct branch differ: max abs "
              f"{float((out - direct).abs().max()):.3e}")
        first = out if first is None else first
    return first


def kernel_vs_plain(plan, src, degree, budgets=None):
    """Launch the inline kernel on both its branches (staged at each of
    ``budgets``, default the wrapper's and SMALL_BUDGET; direct at 0),
    require them bit-equal, and launch its plain version on the same
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

    def launch(budget):
        return R.resample_inline(torch.empty(shape, device=coeff.device),
                                 *args, window_bytes=budget, **kw)
    out_k = staged_equals_direct(
        launch, launch(0), budgets or (R.WINDOW_BYTES, SMALL_BUDGET),
        "resample_inline")
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


def window_model_text(coeff, degree, sx, sy):
    """What the plain model of the staged window (ops/resample.
    window_model) reckons for one inline launch at the wrapper's budget:
    the share of blocks and of pixels that stage, the bytes the staged
    windows copy in total beside the table bytes under those blocks'
    supports counted once (the halo's cost), and the mean window. The
    kernel reports nothing of this itself."""
    from envutil_tpu_torch.ops import resample as R
    tile = R.TILE_INLINE
    win = R.window_model(sx, sy, degree=degree,
                         table_shape=tuple(coeff.shape),
                         entry_bytes=coeff.element_size())
    staged = win["staged"]
    px = R.block_to_pixels(staged, tile, *sx.shape)
    touched = touched_bytes(coeff, sx[px], sy[px], degree)
    mean_kb = (float(win["bytes"][staged].float().mean()) / 1024
               if bool(staged.any()) else 0.0)
    return (f"{100 * float(staged.float().mean()):.2f}% of {staged.numel()} "
            f"blocks ({tile[0]}x{tile[1]} px) and "
            f"{100 * float(px.float().mean()):.2f}% of pixels stage at "
            f"{R.WINDOW_BYTES} bytes; staged windows copy "
            f"{float(win['copied'][staged].sum()) / 1e6:.1f} MB for "
            f"{touched / 1e6:.1f} MB of table under those blocks' taps "
            f"(mean window {mean_kb:.1f} KB)")


def phase_small_inline(coeff_dtype="f32"):
    """Inline kernel, on both its branches, against plain version at
    small shapes, on tables of ``coeff_dtype``: degrees x channel counts
    on full-spherical mounts (cubemap target) and on cubemap and biatan6
    IR sources (every target mode, across cube-face edges), every target
    mode on a mount, and the cases that force the blocks a staged window
    cannot hold."""
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import resample as R
    rng = np.random.default_rng(7)
    worst = 0.0
    fct = make_facet(P.SPHERICAL, 256, 128, 2 * math.pi)
    cases = [(d, c, P.CUBEMAP, 64, 384, 90, (0, 0, 0))
             for d in (0, 1, 2, 3, 5) for c in (1, 3, 4)]
    cases += [(3, 3, P.RECTILINEAR, 96, 64, 75, (30, 10, 5)),
              (3, 3, P.SPHERICAL, 128, 64, 360, (20, -30, 10)),
              (3, 3, P.CYLINDRICAL, 128, 64, 200, (10, 5, 0)),
              (3, 3, P.BIATAN6, 32, 192, 90, (5, 5, 5))]
    # the blocks the staged window cannot hold or holds only in part: a
    # pole inside a block and a block across the periodic seam (the
    # pitched full sphere; widths that are no multiple of the 32-pixel
    # tile nor of four floats, so the scalar store route runs too),
    # degree 7 and two channels
    cases += [(3, 3, P.SPHERICAL, 128, 64, 360, (160, -80, 10)),
              (3, 3, P.SPHERICAL, 131, 61, 360, (-170, 85, 0)),
              (3, 1, P.RECTILINEAR, 97, 67, 110, (180, 88, 0)),
              (7, 3, P.CUBEMAP, 64, 384, 90, (0, 0, 0)),
              (7, 4, P.SPHERICAL, 131, 61, 360, (160, -80, 10)),
              (7, 1, P.RECTILINEAR, 96, 64, 75, (30, 10, 5)),
              (0, 2, P.SPHERICAL, 128, 64, 360, (160, -80, 10)),
              (3, 2, P.CUBEMAP, 64, 384, 90, (0, 0, 0)),
              (5, 2, P.RECTILINEAR, 97, 67, 110, (180, 88, 0))]
    for degree, nch, proj, w, h, hfov, ypr in cases:
        img = rng.uniform(0, 1, (128, 256, nch)).astype(np.float32)
        src = with_coeff(E.make_mount_source(fct, img, degree, degree,
                                             device="cuda"), coeff_dtype)
        err = kernel_vs_plain(plan_for(fct, proj, w, h, hfov, degree, ypr,
                                       nch), src, degree)[0]
        print(f"inline vs plain ({coeff_dtype}): sph source, degree "
              f"{degree} C {nch} "
              f"{proj.name.lower()} {w}x{h}: max abs diff {err:.3e} "
              f"(bound {KERNEL_BOUND:g})", flush=True)
        check(err <= KERNEL_BOUND, f"inline kernel disagrees: {err}")
        worst = max(worst, err)

    # source tables whose rows are no multiple of four floats (the
    # 4-byte copy route) and a table narrower than a block's window (the
    # window is clamped to the table)
    for sw, sh, nch, degree, proj, w, h, hfov, ypr in (
            (250, 125, 3, 3, P.SPHERICAL, 128, 64, 360, (160, -80, 10)),
            (250, 125, 3, 3, P.CUBEMAP, 61, 366, 90, (0, 0, 0)),
            (250, 125, 1, 2, P.RECTILINEAR, 97, 67, 110, (180, 88, 0)),
            (254, 127, 2, 1, P.CYLINDRICAL, 128, 64, 200, (10, 5, 0)),
            (16, 8, 3, 3, P.SPHERICAL, 128, 64, 360, (20, -30, 10)),
            (16, 8, 4, 1, P.RECTILINEAR, 96, 64, 75, (30, 10, 5))):
        ofct = make_facet(P.SPHERICAL, sw, sh, 2 * math.pi)
        img = rng.uniform(0, 1, (sh, sw, nch)).astype(np.float32)
        src = with_coeff(E.make_mount_source(ofct, img, degree, degree,
                                             device="cuda"), coeff_dtype)
        err = kernel_vs_plain(plan_for(ofct, proj, w, h, hfov, degree, ypr,
                                       nch), src, degree,
                              (R.WINDOW_BYTES, SMALL_BUDGET, 1024))[0]
        print(f"inline vs plain ({coeff_dtype}): {sw}x{sh} sph source (table "
              f"{tuple(src.spl.coeff.shape)}), degree {degree} C {nch} "
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
                src = with_coeff(CBM.make_cubemap_source(
                    cfct, faces, degree, degree, 8, 16, device="cuda"),
                    coeff_dtype)
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
        print(f"inline vs plain ({coeff_dtype}): {kind.name.lower()} source, "
              f"degrees "
              f"0/1/3/5 x C 1/3/4 x 5 target modes: worst so far "
              f"{worst:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    print(f"inline vs plain ({coeff_dtype}): {n_cases} IR cases, {n_edge} "
          f"pixels within "
          f"{FACE_EDGE_REL:g} of a face edge excluded; worst {worst:.3e}",
          flush=True)
    return worst


def phase_small_planar(coeff_dtype="f32"):
    """Planar kernel against plain version on tables of
    ``coeff_dtype``: degrees 0-7 x 1/3/4 channels, with and without a
    merge mask, over a NaN sentinel, with NaN/inf coordinates where the
    mask is 0."""
    from envutil_tpu_torch.ops import spline as S
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
                -1, 1, (70, 80, nch)).astype(np.float32)).cuda().to(
                    S.COEFF_DTYPES[coeff_dtype])
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
    print(f"planar vs plain ({coeff_dtype}): degrees 0-7 x C 1/3/4 x (mask, "
          f"no mask), NaN "
          f"sentinel kept under the mask: max abs diff {worst:.3e} (bound "
          f"{KERNEL_BOUND:g})", flush=True)
    return worst


def ramp_fixture(w=8192, h=4096):
    """bench.py's fixture: RGB ramps (x, y, x*y) over the equirect."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32),
                         indexing="ij")
    return np.stack([xx, yy, (xx * yy)], axis=-1)


def touched_bytes(coeff, sx, sy, n, more=()):
    """Bytes of the coefficient table that the frame's taps read (at the
    table's element size: 4 bytes float32, 2 bfloat16), for
    padded coordinates (sx, sy) of the pixels evaluated (and the further
    (sx, sy) pairs of ``more``, one per twining tap): every entry that
    some (n+1)^2 window covers, counted once."""
    import itertools
    import torch
    from envutil_tpu_torch.ops import resample as R
    hp, wp, nch = coeff.shape
    shift = 0.0 if n % 2 else 0.5
    touched = torch.zeros(hp * wp, dtype=torch.bool, device=coeff.device)
    for px, py in itertools.chain([(sx, sy)], more):
        bx = torch.floor(R.clamp_coords(px, wp, n) + shift).to(torch.int64) \
            - n // 2
        by = torch.floor(R.clamp_coords(py, hp, n) + shift).to(torch.int64) \
            - n // 2
        for j in range(n + 1):
            for k in range(n + 1):
                idx = ((by + j) * wp + bx + k).clamp_(0, hp * wp - 1)
                touched[idx.reshape(-1)] = True
    return int(touched.sum()) * nch * coeff.element_size()


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


WRAPPERS = ("resample_inline", "resample_planar", "resample_planar_chain",
            "resample_inline_twined", "resample_twined",
            "resample_twined_chain", "chain_blocks", "champion_planes",
            "champion_lists")
# the launches of the chain forms' champion modes (the voronoi route),
# counted within their wrappers' launches
MODES = {"resample_planar_chain:champion": ("resample_planar_chain",
                                            "champion_launches"),
         "resample_twined_chain:tapsel": ("resample_twined_chain",
                                          "tapsel_launches")}


COUNTERS = WRAPPERS + tuple(MODES) + ("exact_frame", "multi_frame")


@contextlib.contextmanager
def counting_stack_frames():
    """``fastpath.multi_frame`` counted (``.calls``) while the block is
    active: the voronoi route must not call it."""
    from envutil_tpu_torch.runtime import fastpath as FP
    stack = FP.multi_frame

    def counted(*a, **kw):
        counted.calls += 1
        return stack(*a, **kw)
    counted.calls = 0
    FP.multi_frame = counted
    try:
        yield counted
    finally:
        FP.multi_frame = stack


def launch_counts(fn):
    """Every wrapper's launch count, its champion modes' (MODES) and
    ``exact_frame``'s set to 0, ``fn()`` run (``fastpath.multi_frame``'s
    calls counted as "multi_frame") and the card synchronised: (its
    result, {counter: launches} of the counters that moved)."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    counters = {wrapper: getattr(R, wrapper) for wrapper in WRAPPERS}
    counters["exact_frame"] = FP.exact_frame
    torch.cuda.synchronize()
    for counter in counters.values():
        counter.launches = 0
    for wrapper, attr in MODES.values():
        setattr(getattr(R, wrapper), attr, 0)
    with counting_stack_frames() as stack:
        out = fn()
    torch.cuda.synchronize()
    moved = {k: c.launches for k, c in counters.items() if c.launches}
    moved.update({mode: getattr(getattr(R, wrapper), attr)
                  for mode, (wrapper, attr) in MODES.items()
                  if getattr(getattr(R, wrapper), attr)})
    if stack.calls:
        moved["multi_frame"] = stack.calls
    return out, moved


def render(plan, src, name, want_inline=0, want_planar=0, want=None,
           amplify=None):
    """render_frame of ``src`` (a source, or a list of them for a stitch;
    ``amplify`` as a ``--single`` job passes it) with every wrapper's
    launch count, and the exact-path route's count
    (``fastpath.exact_frame``), set to 0 just before and read just after;
    checks that exactly the expected kernels were launched (``want`` maps
    wrappers to counts where it is given) and returns (frame, ms,
    launches)."""
    import torch
    from envutil_tpu_torch.runtime import render as RD
    expect = dict.fromkeys(COUNTERS, 0)
    expect.update(want or {"resample_inline": want_inline,
                           "resample_planar": want_planar})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame, moved = launch_counts(lambda: RD.render_frame(
        plan, src if isinstance(src, list) else [src], amplify=amplify,
        device="cuda"))
    ms = (time.perf_counter() - t0) * 1000.0
    n = dict(dict.fromkeys(expect, 0), **moved)
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: render_frame {frame.shape} in {ms:.1f} ms (first call,"
          f" host copy included); launches {n}; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    check(n == expect, f"{name}: launches {n}, expected {expect}")
    check(frame.shape == (plan.height, plan.width, plan.nchannels),
          f"{name}: frame shape {frame.shape}")
    check(bool(np.isfinite(frame).all()), f"{name}: frame not finite")
    return frame, ms, n


def time_inline(plan, src, name):
    """Steady-state frame, kernel alone on its staged and on its direct
    branch (median of 20 each, in turns: staged, direct, direct,
    staged) and plain version (median of 3) of an inline-kernel path;
    prints the plain window model's reckoning of what stages."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    kw = inline_kw(ops, src.spl.degree)
    args = (src.spl.coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
    buf = torch.empty((plan.height, plan.width, src.spl.coeff.shape[-1]),
                      device="cuda")

    def staged():
        R.resample_inline(buf, *args, **kw)

    def direct():
        R.resample_inline(buf, *args, window_bytes=0, **kw)
    for _ in range(3):
        staged()
        direct()
    turns = [events_ms(f, 20) for f in (staged, direct, direct, staged)]
    kernel_ms = (turns[0] + turns[3]) / 2
    direct_ms = (turns[1] + turns[2]) / 2
    plain_ms = events_ms(lambda: R.resample_inline_plain(buf, *args, **kw),
                         3)
    frame_ms = events_ms(lambda: FP.fused_frame(plan, src, out=buf), 20)
    n_px = plan.height * plan.width
    print(f"{name}: steady-state frame (fused_frame into one reused "
          f"buffer, median of 20) {frame_ms:.4f} ms = "
          f"{n_px / 1e3 / frame_ms:.1f} Mpix/s; kernel alone "
          f"{kernel_ms:.4f} ms staged ({turns[0]:.4f}, {turns[3]:.4f}), "
          f"{direct_ms:.4f} ms direct ({turns[1]:.4f}, {turns[2]:.4f}); "
          f"plain version {plain_ms:.3f} ms; "
          f"clocks/power/temp after: {smi_now()}", flush=True)
    bound = inline_bound(plan, src, n_px)
    print(f"{name}: bound {bound[0]:.4f} ms by {bound[1]} (table bytes "
          f"touched {bound[4] / 1e6:.1f} MB of "
          f"{src.spl.coeff.numel() * src.spl.coeff.element_size() / 1e6:.1f}"
          f" MB; bytes "
          f"{bound[2]:.4f} ms at 3.35 TB/s, operations {bound[3]:.4f} ms at "
          f"67 TFLOP/s)", flush=True)
    sx, sy = R.inline_coords(*args[1:], tmode=kw["tmode"],
                             consts=kw["consts"], row0=kw["row0"],
                             face_rows=kw["face_rows"], smode=kw["smode"])
    print(f"{name}: by the plain window model (not read from the kernel): "
          f"{window_model_text(src.spl.coeff, src.spl.degree, sx, sy)}",
          flush=True)
    return dict(frame_ms=frame_ms, ms=kernel_ms, direct_ms=direct_ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])


# Rough float operations of the coordinate chain per ray, counting an
# atan2, atan, sin or cos as 20 and a square root or a division as 1,
# as inline_bound does: the target modes (ray from the features,
# rotation; the normalisation, 12, is added where it runs), the IR
# pickups (face cascade, in-face division, affine; biatan6 two atans
# more) and the mount pickup (to_plane by projection code, then the
# PTO terms, the window test, affine and gates)
TARGET_FLOPS = {"affine": 15, "sph": 17, "cyl": 15, "ster": 143,
                "fish": 121}
IR_FLOPS = {"cubemap": 20, "biatan6": 60}
MOUNT_FLOPS = {0: 45, 1: 25, 2: 2, 3: 12, 4: 45}


def pickup_flops(pick):
    if pick.smode != "mount":
        return IR_FLOPS[pick.smode]
    return MOUNT_FLOPS[pick.projection] + 15 + \
        12 * (pick.lens is not None) + 2 * (pick.shift is not None) + \
        4 * (pick.shear is not None)


def chain_bound(plan, src, ops):
    """(bound ms, 'bytes'/'operations', bytes ms, ops ms, touched bytes)
    of one planar frame, counted the same whatever implements it: the
    table entries that some tap of a covered pixel reads, counted once,
    plus the output; the chain's operations for every pixel plus the
    spline's for the covered ones."""
    from envutil_tpu_torch.ops import resample as R
    coeff, n = src.spl.coeff, src.spl.degree
    nch = coeff.shape[-1]
    sx, sy, mask = R.planar_chain_coords(*(ops[k] for k in (
        "xfeat", "yfeat", "bmats")), **{k: ops[k] for k in (
            "tmode", "pick", "row0", "face_rows")})
    n_px = sx.numel()
    table = touched_bytes(coeff, sx[mask], sy[mask], n)
    bytes_ms = (table + n_px * nch * 4) / HBM_BYTES_PER_S * 1e3
    chain = TARGET_FLOPS[ops["tmode"]] + 12 + pickup_flops(ops["pick"])
    ops_ms = (n_px * chain + int(mask.sum()) * spline_flops(n, nch)) \
        / F32_FLOPS * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, table


def time_planar(plan, src, name, peak_mib):
    """A planar path through the chain form (one launch of the planar
    chain kernel): the frame and the kernel alone (median of 20 each),
    the plain version (median of 3), the kernel against its plain
    version at full shape, and the bound. Returns them as a record, with
    the chain's coordinates (sx, sy) of the frame."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    coeff = src.spl.coeff
    buf = torch.zeros((plan.height, plan.width, coeff.shape[-1]),
                      device="cuda")
    ops = FP.chain_operands(plan, src)
    ctens = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]

    def chain_frame():
        FP.planar_frame(plan, src, out=buf)

    def chain_kernel():
        R.resample_planar_chain(buf, coeff, *ctens, **ops)
    for _ in range(3):
        chain_frame()
        chain_kernel()
    frame_ms = events_ms(chain_frame, 20)
    kernel_ms = events_ms(chain_kernel, 20)
    plain_ms = events_ms(lambda: R.resample_planar_chain_plain(
        buf, coeff, *ctens, **ops), 3)
    err, n_edge, n_flip = chain_vs_plain(plan, src)[:3]
    print(f"{name}: at full shape, planar chain vs plain {err:.3e} ({n_edge}"
          f" px at a window or face edge excluded, {n_flip} flipped) (bound "
          f"{KERNEL_BOUND:g})", flush=True)
    check(err <= KERNEL_BOUND, f"planar chain kernel disagrees at {name}")
    n_px = plan.height * plan.width
    full = dict(ops, xfeat=ctens[0], yfeat=ctens[1], bmats=ctens[2])
    bound = chain_bound(plan, src, full)
    print(f"{name}: frame (planar_frame into one reused buffer, median of "
          f"20) {frame_ms:.4f} ms = {n_px / 1e3 / frame_ms:.1f} Mpix/s; "
          f"kernel alone {kernel_ms:.4f} ms; plain version {plain_ms:.3f} "
          f"ms; bound {bound[0]:.4f} ms by {bound[1]} (table bytes touched "
          f"{bound[4] / 1e6:.1f} MB, output; bytes {bound[2]:.4f} ms, "
          f"operations {bound[3]:.4f} ms): kernel "
          f"{100 * bound[0] / kernel_ms:.0f}%, frame "
          f"{100 * bound[0] / frame_ms:.0f}%; clocks/power/temp after: "
          f"{smi_now()}", flush=True)
    sx, sy, _mask = R.planar_chain_coords(*ctens, **{
        k: ops[k] for k in ("tmode", "pick", "row0", "face_rows")})
    return dict(frame_ms=frame_ms, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], max_abs_err=err,
                edge_px=n_edge, peak_mib=peak_mib, sx=sx, sy=sy)


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


# ---------------------------------------------------------------- twining

def small_spreads():
    """1, 4 and 9 taps: the centre alone, the 2x2 box, and a 3x3
    gaussian whose weights differ."""
    from envutil_tpu_torch.models import twining
    return {1: [(0.0, 0.0, 1.0)], 4: twining.make_spread(2),
            9: twining.make_spread(3, 3, 1.2, 0.8)}


def twined_inline_operands(plan, src):
    """(tensors (xfeat, yfeat, bmats, spread), keywords) of one inline
    twined launch over the plan's frame."""
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats", "spread")]
    return tensors, ops


def twined_kernel_vs_plain(plan, src):
    """Launch the inline twined kernel and its plain version on the same
    operands; returns (max abs difference over the compared pixels,
    pixels excluded because a tap's ray lies at a cube-face edge, plain
    output)."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    tensors, kw = twined_inline_operands(plan, src)
    coeff = src.spl.coeff
    y0, y1, x0, x1 = FP.frame_window(plan)
    shape = (y1 - y0, x1 - x0, coeff.shape[-1])
    out_k = R.resample_inline_twined(
        torch.empty(shape, device="cuda"), coeff, *tensors, **kw)
    out_p = R.resample_inline_twined_plain(
        torch.empty(shape, device="cuda"), coeff, *tensors, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()),
          "inline twined kernel output not finite")
    skip = torch.zeros(shape[:2], dtype=torch.bool, device="cuda")
    edge = torch.zeros_like(skip)
    if kw["degree"] == 0 or kw["smode"] != "sph":
        for ray, _w in R.inline_tap_rays(
                *tensors, tmode=kw["tmode"], row0=kw["row0"],
                face_rows=kw["face_rows"], precise=kw["precise"]):
            if kw["smode"] != "sph":
                edge |= near_face_edge(*ray)
            if kw["degree"] == 0:
                sx, sy = R.ray_coords(*ray, consts=kw["consts"],
                                      smode=kw["smode"])
                skip |= near_cell_edge(sx) | near_cell_edge(sy)
    diff = torch.where((skip | edge)[..., None], 0.0, (out_k - out_p).abs())
    return float(diff.max()), int(edge.sum()), out_p


def phase_small_inline_twined(coeff_dtype="f32", build=None):
    """Inline twined kernel against its plain version at small shapes,
    on tables of ``coeff_dtype``: {sph, cubemap, biatan6 sources} x {affine, sph, cyl targets} x
    degrees {0, 1, 3} x channels {1, 3, 4} x taps {1, 4, 9} x precise
    {off, on}. The spherical target is pitched so that it holds a pole
    and the seam of the sph source. Prints the share of the sph
    source's pixel-taps that took the increment pickup and, from
    ``build`` (``build_report``), the kernel's registers and spills."""
    import dataclasses
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    rng = np.random.default_rng(17)
    targets = [(P.RECTILINEAR, 96, 64, 100, (175, 70, 5)),
               (P.SPHERICAL, 128, 64, 360, (20, -80, 10)),
               (P.CYLINDRICAL, 128, 64, 200, (170, 5, 0))]
    mfct = make_facet(P.SPHERICAL, 256, 128, 2 * math.pi)
    sources = [("sph", mfct, None)]
    for kind, fov in ((P.CUBEMAP, 90), (P.BIATAN6, 100)):
        sources.append((kind.name.lower(), make_facet(
            kind, 32, 192, math.radians(fov)), kind))
    worst, n_cases, n_edge, shares = 0.0, 0, 0, {}
    for sname, fct, kind in sources:
        for degree in (0, 1, 3):
            for nch in (1, 3, 4):
                if kind is None:
                    img = rng.uniform(0, 1, (128, 256, nch)).astype(
                        np.float32)
                    src = E.make_mount_source(fct, img, degree, degree,
                                              device="cuda")
                else:
                    faces = rng.uniform(0, 1, (6, 32, 32, nch)).astype(
                        np.float32)
                    src = CBM.make_cubemap_source(fct, faces, degree, degree,
                                                  8, 16, device="cuda")
                src = with_coeff(src, coeff_dtype)
                for proj, w, h, hfov, ypr in targets:
                    for taps, spread in small_spreads().items():
                        base = plan_for(fct, proj, w, h, hfov, degree, ypr,
                                        nch, twine=spread)
                        for precise in (False, True):
                            plan = dataclasses.replace(
                                base, twine_precise=precise)
                            err, edge, _p = twined_kernel_vs_plain(plan,
                                                                   src)
                            check(err <= KERNEL_BOUND,
                                  f"inline twined kernel ({sname} source, "
                                  f"degree {degree}, C {nch}, "
                                  f"{proj.name.lower()}, {taps} taps, precise"
                                  f" {precise}) disagrees: {err}")
                            worst = max(worst, err)
                            n_cases += 1
                            n_edge += edge
                            if kind is None and taps > 1 and degree == 1 \
                                    and nch == 3:
                                shares[proj.name.lower()] = \
                                    inline_twined_bound(plan, src)[7]
        print(f"inline twined vs plain ({coeff_dtype}): {sname} source, "
              f"degrees 0/1/3 x C "
              f"1/3/4 x 3 target modes x taps 1/4/9 x precise off/on: worst "
              f"so far {worst:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    print(f"inline twined vs plain ({coeff_dtype}): {n_cases} cases, "
          f"{n_edge} pixels with a"
          f" tap within {FACE_EDGE_REL:g} of a face edge excluded; worst "
          f"{worst:.3e}", flush=True)
    print(f"inline twined ({coeff_dtype}), sph source, degree 1, 3 channels,"
          f" last of 4 and 9 taps: pixel-taps through the increment (the "
          f"plain version's count) by target " + ", ".join(f"{k} {100 * v:.2f}%"
                                 for k, v in shares.items()), flush=True)
    for kernel, e in (build or {}).items():
        if kernel.startswith("resample_inline_twined_kernel"):
            print(f"inline twined ({coeff_dtype}): {kernel} registers "
                  f"{e['registers']} (bf16 {e['registers_bf16']}), "
                  f"{e['spilling']} of {e['instantiations']} "
                  f"instantiations spill (most {e['worst_spill_bytes']} "
                  f"bytes), stack frame up to {e['stack_bytes']} bytes",
                  flush=True)
    return worst


def phase_small_twined(coeff_dtype="f32"):
    """Planar twined kernel against its plain version on tables of
    ``coeff_dtype``: degrees {0, 1, 3}
    x 1/3/4 channels x taps {1, 4, 9} x {no mask, merge mask, 8-bit tap
    weights, float tap weights, periodic wrap}, over a NaN sentinel, with
    NaN/inf in all six planes where the mask (or every tap weight) is
    0."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.ops import spline as S
    rng = np.random.default_rng(18)
    h, w = 40, 56
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)
    off = mask <= 0.5
    # no huge finite value here: the kernel's fused multiply-add would
    # keep cx * 3e38 + s finite where the plain version's product is inf
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    planes = [rng.uniform(-3, 83, (h, w)), rng.uniform(-3, 73, (h, w))] + \
        [rng.uniform(-0.6, 0.6, (h, w)) for _ in range(4)]
    clean = [torch.from_numpy(a.astype(np.float32)).cuda() for a in planes]
    dirty = []
    for a in planes:
        a = a.astype(np.float32)
        a[off] = bad[rng.integers(0, 3, int(off.sum()))]
        dirty.append(torch.from_numpy(a).cuda())
    dmask = torch.from_numpy(mask).cuda()
    keep = dmask <= 0.5
    worst = 0.0
    for degree in (0, 1, 3):
        for nch in (1, 3, 4):
            table = torch.from_numpy(rng.uniform(
                -1, 1, (70, 80, nch)).astype(np.float32)).cuda().to(
                    S.COEFF_DTYPES[coeff_dtype])
            for taps, spread in small_spreads().items():
                sp = torch.tensor(SYN.scaled_spread(spread),
                                  dtype=torch.float32, device="cuda")
                live = torch.from_numpy(
                    rng.uniform(size=(taps, h, w)) < 0.7).cuda() & ~keep
                frac = torch.from_numpy(rng.uniform(
                    0.1, 1.0, (taps, h, w)).astype(np.float32)).cuda() * live
                forms = [("no mask", dirty, {}),
                         ("mask", dirty, dict(merge_mask=dmask)),
                         ("u8 weights", dirty,
                          dict(tap_weights=live.to(torch.uint8))),
                         ("f32 weights", dirty, dict(tap_weights=frac)),
                         ("wrap", clean, dict(wrap_x=(9.5, 60.0)))]
                for form, pl, extra in forms:
                    kw = dict(degree=degree, n_taps=taps, **extra)
                    nan = torch.full((h, w, nch), float("nan"),
                                     device="cuda")
                    k = R.resample_twined(nan.clone(), table, *pl, sp, **kw)
                    p = R.resample_twined_plain(nan.clone(), table, *pl, sp,
                                                **kw)
                    torch.cuda.synchronize()
                    if form == "mask":
                        check(bool(k[keep].isnan().all())
                              and bool(torch.isfinite(k[~keep]).all()),
                              "twined kernel touched a pixel its mask keeps")
                    else:
                        check(bool(torch.isfinite(k).all()),
                              f"twined kernel not finite ({form})")
                    if "tap_weights" in extra:
                        check(bool((k[keep] == 0).all()), "a pixel whose "
                              "tap weights are all 0 is not 0")
                    skip = torch.zeros((h, w), dtype=torch.bool,
                                       device="cuda")
                    if degree == 0:
                        for x, y, _w in R.twined_tap_coords(
                                *pl, sp, 70, 80, 0, extra.get("wrap_x")):
                            skip |= near_cell_edge(x) | near_cell_edge(y)
                    diff = torch.where(skip[..., None], 0.0,
                                       (k - p).nan_to_num().abs())
                    err = float(diff.max())
                    check(err <= KERNEL_BOUND
                          and torch.equal(k.isnan(), p.isnan()),
                          f"twined kernel disagrees (degree {degree}, C "
                          f"{nch}, {taps} taps, {form}): {err}")
                    worst = max(worst, err)
    print(f"twined vs plain ({coeff_dtype}): degrees 0/1/3 x C 1/3/4 x taps "
          f"1/4/9 x (no "
          f"mask, mask, u8 and f32 tap weights, periodic wrap), NaN "
          f"sentinel kept under the mask, 0 where all weights are 0: max "
          f"abs diff {worst:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    return worst


# ------------------------------------------------------- chain forms

# a planar coordinate within this many model units of a facet's window
# edge (or a rectilinear source's z within it of 0) may fall on the
# other side under an ulp of a transcendental: the chain forms then
# write 0 where the plain version writes a value, or the reverse. Such
# pixels are excluded from kernel-vs-plain checks and counted
WINDOW_EDGE = 1e-5

# the planar chain kernel's score (z of the normalised ray, times
# recip_step) against its plain version, in units of z: the ray is
# rounded step by step in the plain version's order, so only the
# target modes' transcendentals (an ulp or two) move it, ~1e-7 of z; a
# wrong ray or a misplaced score shows as O(0.01..1)
SCORE_BOUND = 1e-5

# the targets of the chain forms' small cases: every target mode, views
# that hold a pole, the periodic seam of a full sphere and cube-face
# edges of IR sources
CHAIN_TARGETS = [("rectilinear", 64, 48, 100, (175, 70, 5)),
                 ("spherical", 96, 48, 360, (20, -80, 10)),
                 ("cylindrical", 96, 48, 200, (170, 5, 0)),
                 ("stereographic", 64, 48, 150, (35, 20, 0)),
                 ("fisheye", 64, 64, 170, (-25, 15, 0)),
                 ("cubemap", 16, 96, 90, (10, -20, 5)),
                 ("biatan6", 16, 96, 90, (5, 5, 5))]

# the sources: every source mode, the five mount projections, partial
# facets (window edges) with the PTO lens polynomial, shift and shear,
# a full sphere and a full fisheye
CHAIN_SOURCES = [("full sphere", "spherical", 256, 128, 360, {}),
                 ("partial sphere", "spherical", 128, 64, 200,
                  dict(yaw=0.5)),
                 ("cylinder, shear", "cylindrical", 128, 64, 200,
                  dict(shear_g=0.01, shear_t=-0.02, yaw=-0.4)),
                 ("rectilinear, lens", "rectilinear", 96, 72, 80,
                  dict(a=0.01, b=-0.02, c=0.005, yaw=0.3, pitch=0.2)),
                 ("stereographic, shift", "stereographic", 96, 96, 160,
                  dict(h=3.0, v=-2.0, roll=0.3)),
                 ("full fisheye", "fisheye", 96, 96, 360, dict(pitch=0.3)),
                 ("fisheye, lens, shift, shear", "fisheye", 96, 96, 180,
                  dict(a=-0.01, b=0.02, c=-0.01, h=2.0, v=1.0,
                       shear_g=0.01, shear_t=0.01, yaw=2.0)),
                 ("cubemap", "cubemap", 32, 192, 90, {}),
                 ("biatan6", "biatan6", 32, 192, 100, {})]


def chain_source(name, kind, w, h, hfov, kw, degree, nch, rng):
    """(facet, source on the card) of one CHAIN_SOURCES entry."""
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    proj = P[kind.upper()]
    fct = make_facet(proj, w, h, math.radians(hfov))
    for k, v in kw.items():
        setattr(fct, k, v)
    fct.process_geometry()
    if proj in (P.CUBEMAP, P.BIATAN6):
        faces = rng.uniform(0, 1, (6, w, w, nch)).astype(np.float32)
        return fct, CBM.make_cubemap_source(fct, faces, degree, degree, 8,
                                            16, device="cuda")
    img = rng.uniform(0, 1, (h, w, nch)).astype(np.float32)
    return fct, E.make_mount_source(fct, img, degree, degree, device="cuda")


def chain_edges(ops, spread=None):
    """(H, W) pixels where an ulp may decide what a chain form picks: a
    mount's planar coordinate (of the centre ray; twined with per-tap
    validity, of any tap's deflected ray) within WINDOW_EDGE of the
    window's edge, or an IR source's centre ray within FACE_EDGE_REL of
    a cube-face edge."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    pick = ops["pick"]
    nfx, nfy = R._feature_rows(ops["tmode"])
    xf, yf, bm = ops["xfeat"], ops["yfeat"], ops["bmats"]
    kw = dict(tmode=ops["tmode"], row0=ops["row0"],
              face_rows=ops["face_rows"])
    p0 = R.chain_rays(xf[:nfx], yf[:nfy], bm, **kw)
    if pick.smode != "mount":
        return near_face_edge(*p0)
    rays = [p0]
    if spread is not None:
        if not ops["tap_valid"]:
            return torch.zeros_like(p0[0], dtype=torch.bool)
        du, dv = SYN.derivative_rays(
            p0, R.chain_rays(xf[nfx:], yf[:nfy], bm, **kw),
            R.chain_rays(xf[:nfx], yf[nfy:], bm, **kw), ops["precise"])
        rays = [SYN.deflect(p0, du, dv, cx, cy)
                for cx, cy, _w in spread.reshape(-1, 3).tolist()]
    edge = torch.zeros_like(p0[0], dtype=torch.bool)
    x0, x1, y0, y1 = pick.window
    for ray in rays:
        px, py, _hit = R.mount_planar(pick, *ray)
        for v, e in ((px, x0), (px, x1), (py, y0), (py, y1)):
            edge |= (v - e).abs() <= WINDOW_EDGE
        if pick.projection == 2:       # rectilinear: z > 0
            edge |= ray[2].abs() <= WINDOW_EDGE
    return edge


def chain_vs_plain(plan, src):
    """Launch the job's chain form (planar, or twined for a twined plan)
    and its plain version on the same operands; returns (max abs
    difference over the compared pixels, pixels excluded at window or
    face edges, of which the two disagreed on coverage, kernel output,
    plain output)."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.chain_operands(plan, src)
    coeff = src.spl.coeff
    shape = (plan.height, plan.width, coeff.shape[-1])
    args = [coeff] + [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
    spread = ops.get("spread")
    edge = chain_edges(dict(ops, xfeat=args[1], yfeat=args[2],
                            bmats=args[3]), spread)
    if spread is None:
        kernel, plain = R.resample_planar_chain, R.resample_planar_chain_plain
    else:
        args.append(ops.pop("spread"))
        kernel, plain = R.resample_twined_chain, R.resample_twined_chain_plain
    nan = torch.full(shape, float("nan"), device="cuda")
    out_k = kernel(nan.clone(), *args, **ops)
    out_p = plain(nan.clone(), *args, **ops)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "chain kernel output not finite")
    skip, hit = chain_skip(src, args, ops, spread, edge)
    missed = ~hit & ~edge
    check(not bool(((out_k != 0).any(dim=-1) & missed).any())
          and not bool(((out_p != 0).any(dim=-1) & missed).any()),
          "a chain form or its plain version paints a pixel whose ray "
          "misses the source, away from a window or face edge")
    flip = (out_k == 0).all(dim=-1) != (out_p == 0).all(dim=-1)
    diff = torch.where(skip[..., None], 0.0, (out_k - out_p).abs())
    return float(diff.max()), int(edge.sum()), int(flip.sum()), out_k, out_p


def chain_skip(src, args, ops, spread, edge):
    """(skip, hit), (H, W) each, of a chain launch's comparison with its
    plain version (``args``: the table, the features and, twined, the
    spread; ``ops`` its keywords): ``edge`` and, at degree 0, the pixels
    whose (any tap's) coordinate lies near a cell edge; and the plain
    chain's coverage (untwined: the ray's window test; twined: any
    tap's), not the output's zeros: a covered pixel whose support lies
    in an alpha-0 region of the source (a lens crop, an exclude polygon)
    holds only the prefilter's tail there and may round to exactly 0 in
    one evaluation order and not in the other."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    coeff = src.spl.coeff
    skip = edge.clone()
    if spread is None:
        sx, sy, hit = R.planar_chain_coords(*args[1:4], **{
            k: ops[k] for k in ("tmode", "pick", "row0", "face_rows")})
        if src.spl.degree == 0:
            skip |= near_cell_edge(sx) | near_cell_edge(sy)
        return skip, hit
    tw = R.twined_chain_operands(*args[1:5], **{
        k: ops[k] for k in ("tmode", "pick", "row0", "face_rows",
                            "precise", "tap_valid")})
    hit = torch.ones(edge.shape, dtype=torch.bool, device=coeff.device) \
        if tw["tap_weights"] is None else tw["tap_weights"].bool().any(0)
    if src.spl.degree == 0:
        for x, y, _w in R.twined_tap_coords(
                *(tw[k] for k in ("sx", "sy", "dux", "duy", "dvx", "dvy")),
                args[4], coeff.shape[0], coeff.shape[1], 0, tw["wrap_x"]):
            skip |= near_cell_edge(x) | near_cell_edge(y)
    return skip, hit


def champion_case(plan, src):
    """One small chain case as the one facet of a voronoi stitch: the
    champion kernel's planes (facet 0, over the case's coverage list)
    against its plain version's, equal away from window and face edges
    and their best scores within SCORE_BOUND of z; the champion lists
    (kernel, plain) equal; and the chain form's champion mode (untwined)
    or tapsel mode (twined, 1 and 3 channels) on the kernel's planes and
    list, with brighten 1.5 and, twined, adding, against its plain
    version on the same planes over a canvas of 0.25: within
    KERNEL_BOUND over the champion pixels (``chain_skip`` excluded), and
    0.25 untouched elsewhere in both. Returns (pixels whose champion
    differs away from the edges, best-score error in units of z, mode
    error or None)."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.chain_operands(plan, src)
    feats = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
    spread = ops.pop("spread", None)
    twined = spread is not None
    y0, y1, x0, x1 = FP.frame_window(plan)
    shape = (len(plan.spread) if twined else 1, y1 - y0, x1 - x0)
    rs = src.static.recip_step
    ckw = dict(facet=0, tmode=ops["tmode"], pick=ops["pick"],
               row0=ops["row0"], face_rows=ops["face_rows"], recip_step=rs,
               blocks=FP.block_list(plan, src))
    if twined:
        ckw.update({k: ops[k] for k in ("n_taps", "precise", "tap_valid")},
                   spread=spread)
    planes = []
    for fn in (R.champion_planes, R.champion_planes_plain):
        best = torch.full(shape, SYN.LOWEST, device="cuda")
        champ = torch.full(shape, R.NO_CHAMPION, dtype=torch.uint8,
                           device="cuda")
        fn(best, champ, *feats, **ckw)
        planes.append((best, champ))
    torch.cuda.synchronize()
    edge = chain_edges(dict(ops, xfeat=feats[0], yfeat=feats[1],
                            bmats=feats[2]), spread)
    (bk, ck), (bp, cp) = planes
    differ = int(((ck != cp) & ~edge).sum())
    both = (ck != R.NO_CHAMPION) & (cp != R.NO_CHAMPION)
    best_err = float((bk - bp)[both].abs().max()) / rs if bool(both.any()) \
        else 0.0
    lst = R.champion_lists(ck, 1)[0]
    check(torch.equal(lst, R.champion_lists_plain(ck, 1)[0]),
          "the champion lists differ from their plain version's")
    nch = src.spl.coeff.shape[-1]
    if twined and nch not in (1, 3):
        return differ, best_err, None
    args = [src.spl.coeff] + feats + ([spread] if twined else [])
    mkw = dict(ops, blocks=lst, champ=ck, facet=0, scale=1.5)
    if twined:
        mkw.update(tap_valid=False, accumulate=True)
        forms = R.resample_twined_chain, R.resample_twined_chain_plain
    else:
        forms = R.resample_planar_chain, R.resample_planar_chain_plain
    outs = [torch.full(shape[1:] + (nch,), 0.25, device="cuda")
            for _ in forms]
    for form, out in zip(forms, outs):
        form(out, *args, **mkw)
    torch.cuda.synchronize()
    own = (ck == 0).any(0)
    check(bool((outs[0][~own] == 0.25).all())
          and bool((outs[1][~own] == 0.25).all()),
          f"{forms[0].__name__}'s champion mode writes a pixel the facet "
          f"does not champion")
    skip, _hit = chain_skip(src, args, dict(ops, tap_valid=ops.get(
        "tap_valid", False)), spread, edge)
    diff = torch.where((own & ~skip)[..., None], (outs[0] - outs[1]).abs(),
                       0.0)
    return differ, best_err, float(diff.max())


def chain_score_vs_plain(plan, src):
    """Launch a chain form (the planar one, or the twined one for a
    one-tap twined plan) with and without its score output and its plain
    version with it, on the same operands; requires the kernel's pixels
    bit-equal with and without the score, its score LOWEST exactly where
    the plain version's is (away from window and face edges, of the
    tap's deflected ray when twined); returns the max abs score
    difference over the pixels both score, in units of the source's
    recip_step (so of z), and their count."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.chain_operands(plan, src)
    coeff = src.spl.coeff
    shape = (plan.height, plan.width, coeff.shape[-1])
    args = [coeff] + [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
    spread = ops.pop("spread", None)
    edge = chain_edges(dict(ops, xfeat=args[1], yfeat=args[2],
                            bmats=args[3]), spread)
    if spread is None:
        kernel, plain = R.resample_planar_chain, R.resample_planar_chain_plain
    else:
        args.append(spread)
        kernel, plain = R.resample_twined_chain, R.resample_twined_chain_plain
    rs = src.static.recip_step
    nan = torch.full(shape, float("nan"), device="cuda")
    bare = kernel(nan.clone(), *args, **ops)
    sk = torch.full(shape[:2], float("nan"), device="cuda")
    sp = sk.clone()
    with_score = kernel(nan.clone(), *args, score=sk, recip_step=rs, **ops)
    plain(nan.clone(), *args, score=sp, recip_step=rs, **ops)
    torch.cuda.synchronize()
    what = kernel.__name__
    check(bool(torch.equal(bare, with_score)), f"{what}'s pixels differ "
          f"with and without the score output")
    miss_k, miss_p = sk == SYN.LOWEST, sp == SYN.LOWEST
    check(not bool(((miss_k != miss_p) & ~edge).any()), f"{what}'s score "
          f"misses where its plain version's does not")
    both = ~miss_k & ~miss_p
    check(bool(torch.isfinite(sk[both]).all()), "score not finite")
    err = float((sk - sp)[both].abs().max()) / rs if bool(both.any()) \
        else 0.0
    return err, int(both.sum())


def phase_small_combine():
    """The synopsis combines on the card against the same functions on
    the CPU, on stacks with tied scores (three-way ties, pixels no facet
    covers): the champion and the depth order must resolve ties alike
    (the first maximum, a stable order), so voronoi and voronoi_plus
    must be bit-equal. hdr_merge on brackets whose quality weights are
    all positive (brighten factors of 2 to 4 on values in [0, 1]) within
    1e-5 of its largest value: PyTorch divides by a scalar on the card
    as a multiplication by its reciprocal, an ulp from the CPU's
    quotient, and the merge sums and divides a few such values."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    rng = np.random.default_rng(29)
    for nf in (2, 3, 6):
        score = rng.integers(0, 3, (nf, 40, 56)).astype(np.float32)
        score[:, :3] = 2.0
        score[:, 5] = SYN.LOWEST
        px = rng.uniform(0, 1, (nf, 40, 56, 4)).astype(np.float32)
        cpu = [torch.from_numpy(a) for a in (px, score > SYN.LOWEST, score)]
        gpu = [t.cuda() for t in cpu]
        for fn in (SYN.voronoi_stack, SYN.voronoi_plus_stack):
            for mask in (1, None):
                want = fn(cpu[0], cpu[1] if mask else None, cpu[2])
                got = fn(gpu[0], gpu[1] if mask else None, gpu[2]).cpu()
                check(bool(torch.equal(got, want)), f"{fn.__name__} on the "
                      f"card differs from the CPU's with ties ({nf} facets)")
        brightens = list(rng.uniform(2.0, 4.0, nf))
        want = SYN.hdr_merge_stack(list(cpu[0][..., :3]), brightens, 3)
        got = SYN.hdr_merge_stack(list(gpu[0][..., :3]), brightens, 3).cpu()
        err = float((got - want).abs().max()) / float(want.abs().max())
        check(err <= 1e-5, f"hdr_merge_stack on the card differs: {err}")
    print(f"synopsis combines on the card vs the CPU, 2/3/6 facets with tied "
          f"scores: voronoi and voronoi_plus bit-equal; hdr_merge "
          f"{err:.3e} of its largest value (bound 1e-5)", flush=True)


def phase_small_chain(coeff_dtype="f32"):
    """Both chain forms against their plain versions at small shapes,
    on tables of ``coeff_dtype``:
    every source of CHAIN_SOURCES (the three source modes, the five mount
    projections, partial, lens, shift, shear, full sphere and fisheye)
    to every target of CHAIN_TARGETS (the five target modes, a pole, the
    seam, cube-face edges, window edges), degrees 0-7 and 1-4 channels
    in turn, each untwined and twined (1, 4 and 9 taps, --twine_precise
    off and on in turn), and each chain form's score output: the planar
    one's, and the twined one's at one tap off the pixel centre (a
    twined stitch's launch)."""
    import dataclasses
    from envutil_tpu_torch.core.conventions import Projection as P
    rng = np.random.default_rng(27)
    spreads = list(small_spreads().values())
    one_taps = [[(0.25, 0.0, 1.0)], [(-0.125, 0.375, 1.0)],
                [(0.5, -0.25, 1.0)]]
    from envutil_tpu_torch.runtime import fastpath as FP
    worst = {"planar": 0.0, "twined": 0.0, "score": 0.0,
             "twined score": 0.0, "champion differing px": 0,
             "champion score": 0.0, "champion mode": 0.0,
             "tapsel mode": 0.0, "champion cases": 0, "tapsel cases": 0}
    edges = {"planar": [0, 0], "twined": [0, 0]}
    # the coverage pass: cases, blocks differing from the plain version's,
    # blocks listed, blocks of the windows
    cover = [0, 0, 0, 0]
    i = 0
    for sname, kind, sw, sh, shfov, kw in CHAIN_SOURCES:
        for tname, w, h, hfov, ypr in CHAIN_TARGETS:
            degree, nch = i % 8, 1 + (i // 8) % 4
            fct, src = chain_source(sname, kind, sw, sh, shfov, kw, degree,
                                    nch, rng)
            src = with_coeff(src, coeff_dtype)
            proj = P[tname.upper()]
            plan = plan_for(fct, proj, w, h, hfov, degree, ypr, nch)
            tplan = dataclasses.replace(
                plan_for(fct, proj, w, h, hfov, degree, ypr, nch,
                         twine=spreads[i % 3]), twine_precise=bool(i // 3 % 2))
            for form, p in (("planar", plan), ("twined", tplan)):
                check(p.planar_to_ray[0] is None, "a generic chain")
                err, n_edge, n_flip = chain_vs_plain(p, src)[:3]
                check(err <= KERNEL_BOUND,
                      f"{form} chain kernel ({sname} -> {tname}, degree "
                      f"{degree}, C {nch}) disagrees: {err}")
                worst[form] = max(worst[form], err)
                edges[form][0] += n_edge
                edges[form][1] += n_flip
                if not FP._covers_every_ray(src):
                    cover = [a + b for a, b in zip(
                        cover, (1,) + cover_case(
                            p, src, f"{form} {sname} -> {tname}, "
                            f"{coeff_dtype}"))]
                differ, best_err, mode_err = champion_case(p, src)
                what = f"({form}, {sname} -> {tname}, degree {degree}, " \
                    f"C {nch}, {coeff_dtype})"
                check(differ == 0, f"the champion kernel's planes differ "
                      f"from the plain version's at {differ} px {what}")
                check(best_err <= SCORE_BOUND, f"the champion kernel's "
                      f"scores differ by {best_err} {what}")
                worst["champion score"] = max(worst["champion score"],
                                              best_err)
                if mode_err is not None:
                    mode = "tapsel" if form == "twined" else "champion"
                    check(mode_err <= KERNEL_BOUND, f"the {mode} mode "
                          f"disagrees with its plain version: {mode_err} "
                          f"{what}")
                    worst[f"{mode} mode"] = max(worst[f"{mode} mode"],
                                                mode_err)
                    worst[f"{mode} cases"] += 1
            err = chain_score_vs_plain(plan, src)[0]
            check(err <= SCORE_BOUND, f"planar chain kernel's score "
                  f"({sname} -> {tname}) disagrees: {err}")
            worst["score"] = max(worst["score"], err)
            oplan = dataclasses.replace(
                plan_for(fct, proj, w, h, hfov, degree, ypr, nch,
                         twine=one_taps[i % 3]), twine_precise=bool(i % 2))
            err = chain_score_vs_plain(oplan, src)[0]
            check(err <= SCORE_BOUND, f"twined chain kernel's score "
                  f"({sname} -> {tname}) disagrees: {err}")
            worst["twined score"] = max(worst["twined score"], err)
            i += 1
        print(f"chain forms vs plain ({coeff_dtype}): {sname} source x "
              f"{len(CHAIN_TARGETS)} "
              f"targets: worst so far planar {worst['planar']:.3e}, twined "
              f"{worst['twined']:.3e} (bound {KERNEL_BOUND:g}), planar "
              f"score {worst['score']:.3e} of z, twined score at one tap "
              f"{worst['twined score']:.3e} of z (bound {SCORE_BOUND:g}); "
              f"pixels bit-equal with and without the score; champion "
              f"planes equal to plain away from edges, scores "
              f"{worst['champion score']:.3e} of z; champion mode "
              f"{worst['champion mode']:.3e}, tapsel mode "
              f"{worst['tapsel mode']:.3e} (bound {KERNEL_BOUND:g})",
              flush=True)
    for form in edges:
        print(f"{form} chain vs plain ({coeff_dtype}): {i} cases, worst "
              f"{worst[form]:.3e} "
              f"(bound {KERNEL_BOUND:g}); {edges[form][0]} px at a window "
              f"or face edge excluded, {edges[form][1]} of them with the "
              f"coverage flipped", flush=True)
    print(f"champion pass vs plain ({coeff_dtype}): {2 * i} cases "
          f"(untwined and twined), planes equal away from window and face "
          f"edges, best scores within {worst['champion score']:.3e} of z "
          f"(bound {SCORE_BOUND:g}), lists equal; champion mode vs plain "
          f"{worst['champion mode']:.3e} over {worst['champion cases']} "
          f"cases, tapsel mode {worst['tapsel mode']:.3e} over "
          f"{worst['tapsel cases']} (1 and 3 channels; bound "
          f"{KERNEL_BOUND:g}), untouched pixels kept", flush=True)
    print(f"coverage pass vs plain ({coeff_dtype}): {cover[0]} cases "
          f"(untwined and twined, partial sources), {cover[1]} blocks in one "
          f"list and not the other (none allowed), {cover[2]} of {cover[3]} "
          f"blocks listed; every launch on the kernel's list bit-equal to the full-window "
          f"launch, nothing written outside it", flush=True)
    worst["cover cases"], worst["cover differing blocks"] = cover[:2]
    return worst, edges


def frame_errors(plan, src, frame, extra=None, chunk=128):
    """Max abs difference of ``frame`` against the port's exact path on
    the card over the whole frame (rendered in row chunks), overall and
    over named regions of it: within REGION_DEG of a pole or of the
    periodic seam (spherical sources), within REGION_DEG of a cube-face
    edge (cubemap sources), and the boolean (H, W) planes of ``extra``.
    Returns {region: (max abs diff, pixels)}."""
    import torch
    from envutil_tpu_torch.core import geometry as geo
    from envutil_tpu_torch.models import stepper as ST
    from envutil_tpu_torch.runtime import render as RD
    h, w = frame.shape[:2]
    diff = torch.empty((h, w), device="cuda")
    for r0 in range(0, h, chunk):
        r1 = min(r0 + chunk, h)
        exact = RD._render_window(plan, [src], (r0, r1, 0, w))
        diff[r0:r1] = (torch.from_numpy(frame[r0:r1]).cuda()
                       - exact).abs().amax(dim=-1)
    ray = ST.target_rays(plan.projection, plan.width, plan.height,
                         plan.extent, basis=plan.bases[0], normalize=True,
                         planar_to_ray=plan.planar_to_ray[0], device="cuda")
    near = math.radians(REGION_DEG)
    regions = {"all": torch.ones_like(diff, dtype=torch.bool)}
    if src.static.kind == "cubemap":
        a = torch.stack([r.abs() for r in ray])
        top2 = torch.topk(a, 2, dim=0).values
        regions["face edges"] = (top2[0] - top2[1]) <= math.tan(near) * top2[0]
    elif src.spl.spherical:
        lon, lat = geo.ray_to_ll(*ray)
        regions["poles"] = lat.abs() >= math.pi / 2 - near
        regions["seam"] = lon.abs() >= math.pi - near
    regions.update(extra or {})
    return {k: (float(diff[m].max()) if bool(m.any()) else 0.0, int(m.sum()))
            for k, m in regions.items()}


def errors_text(errs):
    return "; ".join(f"{k}: {v[0]:.3e} over {v[1]} px"
                     for k, v in errs.items())


def twined_inline_path(name, plan, src, reference=None):
    """One twined frame through render_frame and the inline twined
    kernel: launches, the whole frame against the exact path, the kernel
    against its plain version at this shape, the timings and the bound;
    with ``reference`` (the host frame of the same job on a float32
    table) the frame's PSNR against it, held to BF16_DB."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    taps = len(plan.spread)
    frame, _ms, n = render(plan, src, name,
                           want={"resample_inline_twined": 1})
    peak = torch.cuda.max_memory_allocated()
    errs = frame_errors(plan, src, frame)
    print(f"{name} ({taps} taps) vs exact path, whole frame: "
          f"{errors_text(errs)} (bound {TWINED_INLINE_BOUND:g})", flush=True)
    check(max(v[0] for v in errs.values()) <= TWINED_INLINE_BOUND,
          f"{name} disagrees with the exact path")
    db = None
    if reference is not None:
        db = psnr(frame, reference)
        print(f"{name}: frame vs the float32 table's frame {db:.2f} dB "
              f"(bound >= {BF16_DB:g})", flush=True)
        check(db >= BF16_DB, f"{name}: {db:.2f} dB against float32")
    del frame
    err_k, _edge, _p = twined_kernel_vs_plain(plan, src)
    print(f"{name}: inline twined vs plain at full shape: max abs diff "
          f"{err_k:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    check(err_k <= KERNEL_BOUND, f"inline twined kernel disagrees at {name}")

    tensors, kw = twined_inline_operands(plan, src)
    coeff, nch = src.spl.coeff, src.spl.coeff.shape[-1]
    buf = torch.empty((plan.height, plan.width, nch), device="cuda")
    for _ in range(3):
        R.resample_inline_twined(buf, coeff, *tensors, **kw)
    kernel_ms = events_ms(lambda: R.resample_inline_twined(
        buf, coeff, *tensors, **kw), 20)
    plain_ms = events_ms(lambda: R.resample_inline_twined_plain(
        buf, coeff, *tensors, **kw), 3)
    frame_ms = events_ms(lambda: FP.fused_frame(plan, src, out=buf), 20)
    n_px = plan.height * plan.width
    bound, by, bytes_ms, ops_ms, table, inc_ms, full_ms, share = \
        inline_twined_bound(plan, src)
    print(f"{name}: steady-state frame (fused_frame into one reused buffer,"
          f" median of 20) {frame_ms:.4f} ms = {n_px / 1e3 / frame_ms:.1f} "
          f"Mpix/s; kernel alone {kernel_ms:.4f} ms; plain version "
          f"{plain_ms:.3f} ms; bound {bound:.4f} ms by {by} "
          f"(table bytes under all taps {table / 1e6:.1f} MB of "
          f"{coeff.numel() * coeff.element_size() / 1e6:.1f} MB; bytes "
          f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms, the cheaper of "
          f"{full_ms:.4f} ms with the full pickup for every tap and "
          + ("no increment" if inc_ms is None else
             f"{inc_ms:.4f} ms as the kernel takes the pickup") + "); "
          f"{share_text(share)}; peak device memory of the first "
          f"frame {peak / 2**20:.1f} MiB; clocks/power/temp after: "
          f"{smi_now()}", flush=True)
    turns = k4_turns(name, lambda: R.resample_inline_twined(
        buf, coeff, *tensors, **kw), buf)
    rec = dict(taps=taps, launches=n["resample_inline_twined"],
               max_abs_err=err_k, ms=kernel_ms, plain_ms=plain_ms,
               frame_ms=frame_ms, bound_ms=bound, bound_by=by,
               ops_ms=ops_ms, increment_ops_ms=inc_ms,
               full_pickup_ops_ms=full_ms,
               increment_share=share, before_after=turns,
               peak_mib=peak / 2**20,
               vs_exact={k: v[0] for k, v in errs.items()},
               region_px={k: v[1] for k, v in errs.items()})
    if db is not None:
        rec["psnr_vs_f32_db"] = db
    return rec


# Rough float operations of the twined inline kernel's increment pickup
# (ops/resample.increment_coords), counted as inline_bound counts (an
# atan2 20, a square root or a reciprocal 1): per pixel the centre's
# pickup (rho0^2 3, its root, two atan2); per tap up to the tests the
# deflection 3, the longitude's dot and cross products 7 and its
# reciprocal and product 2, rho 4, drho 8, the latitude's dot and cross
# products 6 and its reciprocal and product 2 (32); then two small
# atans (8 each), the sums with lon0 and lat0 2, two gate affines 4, two
# unwrapped gates 4 and the pad 2 (60 in all). A tap that falls back
# pays the 32 and the full pickup.
CENTRE_FLOPS = 44
INCREMENT_TEST_FLOPS = 32
INCREMENT_FLOPS = 60


def inline_twined_bound(plan, src):
    """(bound ms, 'bytes'/'operations', bytes ms, ops ms, touched bytes,
    the increment's ops ms, the full pickup's ops ms, the share of
    pixel-taps through the increment) of one inline twined launch over
    the plan's frame: the table entries under all taps, counted once,
    the output and the features; per pixel three rays, their
    normalisation and differencing, per tap the deflection, the pickup,
    the spline and the weighted sum. The pickup is counted two ways, as
    the kernel takes it (the increment where the plain version's taps
    take it, with the centre's pickup per pixel, the full pickup where
    they fall back; None for one tap or a cube source) and with the full
    pickup for every tap; the bound takes the cheaper, as both compute
    the same function. The share is the plain version's
    (``inline_tap_coords``), None where every tap takes the full
    pickup."""
    from envutil_tpu_torch.ops import resample as R
    tensors, kw = twined_inline_operands(plan, src)
    coeff, n_deg, nch = src.spl.coeff, src.spl.degree, src.spl.coeff.shape[-1]
    n_px = plan.height * plan.width
    coords, taken = [], []
    for sx, sy, _w, plane in R.inline_tap_coords(
            *tensors, tmode=kw["tmode"], consts=kw["consts"],
            row0=kw["row0"], face_rows=kw["face_rows"], smode=kw["smode"],
            precise=kw["precise"]):
        coords.append((sx, sy))
        taken.append(None if plane is None else int(plane.sum()))
    table = touched_bytes(coeff, *coords[0], n_deg, coords[1:])
    del coords
    feat = sum(t.numel() * 4 for t in tensors)
    bytes_ms = (table + n_px * nch * 4 + feat) / HBM_BYTES_PER_S * 1e3
    # per pixel: three rays (15 flops each), their normalisation (12
    # each) and differencing (6); per tap: the deflection (12), the
    # pickup, the spline and the weighted sum
    src_flops = {"sph": 53, "cubemap": 20, "biatan6": 60}[kw["smode"]]
    n_taps = kw["n_taps"]
    per_px = 3 * 27 + 6
    per_tap = 12 + spline_flops(n_deg, nch) + 2 * nch
    full_ms = n_px * (per_px + n_taps * (per_tap + src_flops)) \
        / F32_FLOPS * 1e3
    inc_ms, share = None, None
    if taken[0] is not None:
        n_taken = sum(taken)
        n_fall = n_px * n_taps - n_taken
        share = n_taken / (n_px * n_taps)
        inc_ms = (n_px * (per_px + CENTRE_FLOPS + n_taps * per_tap)
                  + n_taken * INCREMENT_FLOPS
                  + n_fall * (INCREMENT_TEST_FLOPS + src_flops)) \
            / F32_FLOPS * 1e3
    ops_ms = full_ms if inc_ms is None else min(full_ms, inc_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return (max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, table, inc_ms,
            full_ms, share)


def live_tap_table(coeff, n, ops, spread):
    """(table bytes, live pixel-taps) of a twined frame at degree ``n``
    from its operands (the dict of ``twined_coords``): the table entries
    under the taps whose weight is not 0, counted once, and how many
    such taps there are."""
    from envutil_tpu_torch.ops import resample as R
    hp, wp, _ = coeff.shape
    tapw = ops["tap_weights"]
    coords, pairs = [], 0
    for i, (x, y, _w) in enumerate(R.twined_tap_coords(
            *(ops[k] for k in ("sx", "sy", "dux", "duy", "dvx", "dvy")),
            spread, hp, wp, n, ops["wrap_x"])):
        if tapw is not None:
            x, y = x[tapw[i] > 0], y[tapw[i] > 0]
        coords.append((x, y))
        pairs += x.numel()
    return touched_bytes(coeff, *coords[0], n, coords[1:]), pairs


def twined_chain_bound(plan, src, ops):
    """(bound ms, 'bytes'/'operations', bytes ms, ops ms, touched bytes,
    live pixel-taps) of one twined planar frame, counted the same
    whatever implements it: the table entries under all live taps,
    counted once, plus the output; the chain's operations for every
    pixel (three rays and pickups, the derivatives, each tap's validity
    test where the source does not cover every ray) plus the deflection
    and the spline of every live tap."""
    from envutil_tpu_torch.ops import resample as R
    coeff, n = src.spl.coeff, src.spl.degree
    nch = coeff.shape[-1]
    kw = {k: ops[k] for k in ("tmode", "pick", "row0", "face_rows",
                              "precise", "tap_valid")}
    tw = R.twined_chain_operands(*(ops[k] for k in (
        "xfeat", "yfeat", "bmats", "spread")), **kw)
    taps = ops["n_taps"]
    table, pairs = live_tap_table(coeff, n, tw, ops["spread"])
    n_px = tw["sx"].numel()
    bytes_ms = (table + n_px * nch * 4) / HBM_BYTES_PER_S * 1e3
    pick = ops["pick"]
    per_px = 3 * (TARGET_FLOPS[kw["tmode"]] + 12 + pickup_flops(pick)) + \
        (21 if kw["precise"] else 6) + 8
    if kw["tap_valid"]:
        per_px += taps * (12 + pickup_flops(pick))
    ops_ms = (n_px * per_px + pairs * (4 + spline_flops(n, nch) + 2 * nch)) \
        / F32_FLOPS * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, table, pairs


def twined_planar_path(name, plan, src):
    """One twined frame through render_frame and the twined chain
    kernel: launches, the whole frame against the exact path, the kernel
    against its plain version at this shape, the frame and the kernel
    alone timed (median of 10 and 20), the plain version (median of 3)
    and the bound."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    taps = len(plan.spread)
    listed = not FP._covers_every_ray(src)
    frame, first_ms, n = render(plan, src, name,
                                want={"resample_twined_chain": 1,
                                      "chain_blocks": int(listed)})
    peak = torch.cuda.max_memory_allocated()
    ops = FP.chain_operands(plan, src)
    ctens = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats", "spread")]
    full = dict(ops, xfeat=ctens[0], yfeat=ctens[1], bmats=ctens[2],
                spread=ctens[3])
    tapw = R.twined_chain_operands(*ctens, **{
        k: ops[k] for k in ("tmode", "pick", "row0", "face_rows", "precise",
                            "tap_valid")})["tap_weights"]
    extra, covered = {}, None
    if tapw is not None:
        count = tapw.sum(dim=0)
        extra["facet edge (taps differ)"] = (count > 0) & (count < taps)
        covered = float((count > 0).float().mean())
        del count
    del tapw
    errs = frame_errors(plan, src, frame, extra)
    print(f"{name} ({taps} taps"
          + ("" if covered is None else f", {100 * covered:.1f}% covered")
          + f") through the chain form vs exact path, whole frame: "
          f"{errors_text(errs)} (bound {TWINED_PLANAR_BOUND:g})", flush=True)
    check(max(v[0] for v in errs.values()) <= TWINED_PLANAR_BOUND,
          f"{name} disagrees with the exact path")
    err, n_edge, n_flip = chain_vs_plain(plan, src)[:3]
    print(f"{name}: at full shape, twined chain vs plain {err:.3e} ({n_edge} "
          f"px at a window or face edge excluded, {n_flip} flipped) (bound "
          f"{KERNEL_BOUND:g})", flush=True)
    check(err <= KERNEL_BOUND, f"twined chain kernel disagrees at {name}")

    coeff, nch = src.spl.coeff, src.spl.coeff.shape[-1]
    buf = torch.empty((plan.height, plan.width, nch), device="cuda")

    def chain_frame():
        FP.planar_frame(plan, src, out=buf)

    def chain_kernel():
        R.resample_twined_chain(buf, coeff, *ctens, **ops)
    for _ in range(2):
        chain_frame()
        chain_kernel()
    frame_ms = events_ms(chain_frame, 10)
    kernel_ms = events_ms(chain_kernel, 20)
    plain_ms = events_ms(lambda: R.resample_twined_chain_plain(
        buf, coeff, *ctens, **ops), 3)
    bound = twined_chain_bound(plan, src, full)
    n_px = plan.height * plan.width
    print(f"{name}: frame (planar_frame into one reused buffer, median of "
          f"10) {frame_ms:.4f} ms = {n_px / 1e3 / frame_ms:.1f} Mpix/s; "
          f"kernel alone (median of 20) {kernel_ms:.4f} ms; plain version "
          f"{plain_ms:.3f} ms; peak device memory of the first frame "
          f"{peak / 2**20:.1f} MiB; clocks/power/temp after: {smi_now()}",
          flush=True)
    print(f"{name}: bound {bound[0]:.4f} ms by {bound[1]} (table bytes under "
          f"all live taps {bound[4] / 1e6:.1f} MB, {bound[5]} live "
          f"pixel-taps, output; bytes {bound[2]:.4f} ms, operations "
          f"{bound[3]:.4f} ms): kernel {100 * bound[0] / kernel_ms:.0f}%, "
          f"frame {100 * bound[0] / frame_ms:.0f}%", flush=True)
    compact = None
    if listed and "bf16" not in name:
        compact = compact_path(name, plan, [src], first_ms)
    return dict(taps=taps, launches=n["resample_twined_chain"],
                compact=compact,
                max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                frame_ms=frame_ms, bound_ms=bound[0], bound_by=bound[1],
                edge_px=n_edge, peak_mib=peak / 2**20, covered=covered,
                vs_exact={k: v[0] for k, v in errs.items()},
                region_px={k: v[1] for k, v in errs.items()})


def planes_bound(plan, src, pops, sp):
    """(bound ms, 'bytes'/'operations') of the planar twined kernel
    alone: the common bound's table and output bytes plus the six planes
    it reads at every pixel with a live tap and its tap-weight planes,
    against the operations of its live taps."""
    coeff, n_deg = src.spl.coeff, src.spl.degree
    nch = coeff.shape[-1]
    tapw = pops["tap_weights"]
    table, pairs = live_tap_table(coeff, n_deg, pops, sp)
    n_px = pops["sx"].numel()
    n_live = n_px if tapw is None else int((tapw.sum(dim=0) > 0).sum())
    moved = table + n_px * nch * 4 + n_live * 6 * 4 + \
        (0 if tapw is None else tapw.numel() * tapw.element_size())
    ops_ms = pairs * (8 + spline_flops(n_deg, nch) + 2 * nch) \
        / F32_FLOPS * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def planes_at_path(plan, src, name):
    """The planes form's kernel on the operands its own path gives it (a
    plan with a generic chain): ``coords`` and the planar kernel through
    the merge mask, or, twined, ``twined_coords`` and the planar twined
    kernel with its tap weights. The kernel against its plain version,
    the kernel timed alone (median of 20) and the plain version (median
    of 3), and the bound; returns them as a record."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    window = FP.frame_window(plan)
    coeff, n = src.spl.coeff, src.spl.degree
    shape = (plan.height, plan.width, coeff.shape[-1])
    if plan.spread is None:
        sx, sy, mask, _z = FP.coords(plan, window, src)
        args = (coeff, sx, sy)
        kw = dict(degree=n, merge_mask=mask.to(torch.float32))
        kernel, plain = R.resample_planar, R.resample_planar_plain
        bound = planar_bound(coeff, sx, sy, n, mask)
    else:
        pops = FP.twined_coords(plan, window, src)
        sp = torch.tensor(SYN.scaled_spread(plan.spread), dtype=torch.float32,
                          device="cuda")
        args = (coeff, *(pops[k] for k in ("sx", "sy", "dux", "duy", "dvx",
                                           "dvy")), sp)
        kw = dict(degree=n, n_taps=len(plan.spread),
                  tap_weights=pops["tap_weights"], wrap_x=pops["wrap_x"])
        kernel, plain = R.resample_twined, R.resample_twined_plain
        bound = planes_bound(plan, src, pops, sp)
    nan = torch.full(shape, float("nan"), device="cuda")
    k = kernel(nan.clone(), *args, **kw)
    p = plain(nan.clone(), *args, **kw)
    err = float((k - p).nan_to_num().abs().max())
    check(err <= KERNEL_BOUND and torch.equal(k.isnan(), p.isnan()),
          f"{kernel.__name__} disagrees with its plain version at {name}")
    del nan, k, p
    buf = torch.empty(shape, device="cuda")
    for _ in range(3):
        kernel(buf, *args, **kw)
    ms = events_ms(lambda: kernel(buf, *args, **kw), 20)
    plain_ms = events_ms(lambda: plain(buf, *args, **kw), 3)
    print(f"{name}: {kernel.__name__} on its own path's operands vs plain "
          f"{err:.3e} (bound {KERNEL_BOUND:g}); kernel alone {ms:.4f} ms "
          f"(median of 20), plain version {plain_ms:.3f} ms; its bound "
          f"{bound[0]:.4f} ms by {bound[1]}; clocks/power/temp after: "
          f"{smi_now()}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


def planes_turns(plan, src, src_b, name):
    """``dtype_turns`` of the planes form on its own path's operands (as
    ``planes_at_path`` builds them) over ``src``'s float32 table and
    ``src_b``'s bf16 one."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    window = FP.frame_window(plan)
    tables = {"f32": src.spl.coeff, "bf16": src_b.spl.coeff}
    buf = torch.empty((plan.height, plan.width, src.spl.coeff.shape[-1]),
                      device="cuda")
    n = src.spl.degree
    if plan.spread is None:
        sx, sy, mask, _z = FP.coords(plan, window, src)
        mask = mask.to(torch.float32)
        return dtype_turns(f"{name} (K2 planes)", lambda d: R.resample_planar(
            buf, tables[d], sx, sy, degree=n, merge_mask=mask))
    pops = FP.twined_coords(plan, window, src)
    sp = torch.tensor(SYN.scaled_spread(plan.spread), dtype=torch.float32,
                      device="cuda")
    planes = [pops[k] for k in ("sx", "sy", "dux", "duy", "dvx", "dvy")]
    return dtype_turns(f"{name} (K3 planes)", lambda d: R.resample_twined(
        buf, tables[d], *planes, sp, degree=n, n_taps=len(plan.spread),
        tap_weights=pops["tap_weights"], wrap_x=pops["wrap_x"]))


# ---------------------------------------------------------------- stitches

# the pole view's regions: within and outside this many degrees of
# latitude (the CPU tests hold the planar twined route to 5e-3 below it)
POLE_LAT = 80

# a pixel whose two best voronoi scores lie within this relative margin
# may take the other champion under an ulp of its rays (the chain forms
# each ray from the axis features, the exact path takes the stepper's
# grid): such pixels are excluded from the stitches' checks and counted
FLIP_REL = 1e-6


def pto_cuts(i, w, h):
    """The facet ``i`` of config 5b's PTO masking (the pto_alpha phase): a
    rectangular lens crop inset 5% on every facet and, on facets 1 and 3,
    a 4-vertex k-line exclude polygon over a corner region."""
    from envutil_tpu_torch.core.facet import PtoMask
    kw = dict(has_lens_crop=True, crop_x0=int(0.05 * w),
              crop_x1=int(0.95 * w), crop_y0=int(0.05 * h),
              crop_y1=int(0.95 * h))
    if i in (1, 3):
        kw.update(has_pto_mask=True, pto_masks=[PtoMask(
            i, 0, [0.10 * w, 0.35 * w, 0.30 * w, 0.08 * w],
            [0.12 * h, 0.10 * h, 0.40 * h, 0.45 * h])])
    return kw


# ------------------------------------------------ the compact grid

# the compact-grid records by job (``compact_path``)
COMPACT = {}


@contextlib.contextmanager
def full_window():
    """Every chain launch over its whole window while the block is
    active: ``fastpath.block_list`` answers None, as it does for a source
    that covers every ray; and the voronoi route's champion planes are
    built anew at every frame (``fastpath._build_champions``, kept
    nowhere), their pass over the whole windows. The comparison and
    timing of the compact grid against full-window launches use it; the
    program has no such switch."""
    from envutil_tpu_torch.runtime import fastpath as FP
    listed, kept = FP.block_list, FP.champion_planes

    def fresh(plan, sources):
        return FP._build_champions(plan, sources)
    fresh.builds = kept.builds
    FP.block_list = lambda plan, src: None
    FP.champion_planes = fresh
    try:
        yield
    finally:
        FP.block_list, FP.champion_planes = listed, kept


def ab_turns(fa, fb, single=20, bursts=5, burst=20):
    """``fa`` and ``fb`` timed in turns (a, b, b, a): single calls between
    two events (median of ``single``) and bursts of ``burst`` calls
    between two events (median of ``bursts``, per call). Returns
    ({"ms", "burst_ms", "turns", "burst_turns"} of a, of b): the mean of
    its two turns, and the two turns in order."""
    for _ in range(2):
        fa()
        fb()
    got = {"a": ([], []), "b": ([], [])}
    for k, f in (("a", fa), ("b", fb), ("b", fb), ("a", fa)):
        got[k][0].append(events_ms(f, single))

        def many(f=f):
            for _ in range(burst):
                f()
        got[k][1].append(events_ms(many, bursts) / burst)
    return tuple(dict(ms=float(np.mean(got[k][0])),
                      burst_ms=float(np.mean(got[k][1])), turns=got[k][0],
                      burst_turns=got[k][1]) for k in "ab")


def cover_lists(fplan, src, what):
    """The coverage pass of a facet plan's chain launches on the card
    (``fastpath.cover_operands``, as ``fastpath.block_list`` takes them)
    against its plain version: the two lists must hold the same blocks
    (every measured case has; a wider list would pass the launch check
    unseen). Returns (features, keywords, the kernel's list, the plain
    version's, the blocks in one list and not the other)."""
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    feats, kw = FP.cover_operands(fplan, src)
    got = R.chain_blocks(*feats, **kw)
    want = R.chain_blocks_plain(*feats, **kw)
    differ = len(set(got.tolist()) ^ set(want.tolist()))
    check(differ == 0, f"{what}: the coverage kernel's block list differs "
          f"from its plain version's in {differ} blocks ({got.numel()} "
          f"against {want.numel()} listed)")
    return feats, kw, got, want, differ


def cover_bound(feats, kw):
    """(bound ms, 'bytes'/'operations') of one coverage pass, counted
    from this run's data: per pixel the chain the kernel runs (untwined:
    one ray, its normalisation and the pickup with its window test;
    twined: three rays, the derivative rays, and the deflection and
    window test of each tap up to the first that passes, the plain
    version's taps); bytes: the features read and the flags and the
    list written once."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    h, w = feats[1].shape[1], feats[0].shape[1]
    nby, nbx = R.block_grid(h, w)
    chain = TARGET_FLOPS[kw["tmode"]] + 12
    test = pickup_flops(kw["pick"])
    if "spread" not in kw:
        ops = h * w * (chain + test)
    else:
        tw = R.twined_chain_operands(*feats, kw["spread"], **{
            k: kw[k] for k in ("tmode", "pick", "row0", "face_rows",
                               "precise")}, tap_valid=True)["tap_weights"]
        hit = tw.bool()
        first = torch.where(hit.any(0), hit.to(torch.uint8).argmax(0) + 1,
                            kw["n_taps"])
        ops = h * w * (3 * chain + (21 if kw["precise"] else 6)) \
            + int(first.sum()) * (12 + test)
    moved = sum(t.numel() * 4 for t in feats) + nby * nbx * (1 + 4)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def cover_device_ms(feats, kw, burst=20):
    """The coverage pass's three kernels without the wrapper: its C
    entry point called ``burst`` times between two events, the count
    never read back (median of 5, per pass), which leaves the card's
    own time."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    fn = R._BLOCKS.get("envutil_chain_blocks")
    h, w = feats[1].shape[1], feats[0].shape[1]
    nby, nbx = R.block_grid(h, w)
    n = nby * nbx
    flags = torch.empty(2 * n, dtype=torch.uint8, device="cuda")
    listed = torch.empty(n + 1, dtype=torch.int32, device="cuda")
    ints, floats = R._pickup_arrays(kw["pick"])
    spread = kw.get("spread")
    args = (flags.data_ptr(), listed.data_ptr(), listed[n:].data_ptr(),
            *(f.data_ptr() for f in feats),
            None if spread is None else spread.data_ptr(), ints, floats, h,
            w, int(kw["row0"]), int(kw["face_rows"]),
            R._CHAIN_TMODES[kw["tmode"]], int(kw.get("n_taps", 0)),
            int(kw.get("precise", False)),
            torch.cuda.current_stream().cuda_stream)

    def passes():
        for _ in range(burst):
            check(fn(*args) == 0, "the coverage pass failed to launch")
    passes()
    return events_ms(passes, 5) / burst


def cover_vs_plain(fplan, src, what):
    """The coverage pass of one facet's chain launches on the card: the
    kernel's list against its plain version (``cover_lists``), its time
    as a plan builds it (median of 10, the wrapper and the count's read
    back included), its kernels' time in bursts (``cover_device_ms``),
    the plain version's time (median of 3), and its bound. Returns the
    record."""
    from envutil_tpu_torch.ops import resample as R
    feats, kw, got, want, differ = cover_lists(fplan, src, what)
    ms = events_ms(lambda: R.chain_blocks(*feats, **kw), 10)
    plain_ms = events_ms(lambda: R.chain_blocks_plain(*feats, **kw), 3)
    bound, by = cover_bound(feats, kw)
    return dict(blocks=got.numel(), plain_blocks=want.numel(),
                differing_blocks=differ, max_abs_err=float(differ > 0),
                ms=ms, device_ms=cover_device_ms(feats, kw),
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                twined="spread" in kw)


def listed_vs_full(fplan, src, scored, h, w, blocks=None):
    """One chain launch of a facet plan on its block list (``blocks``,
    by default ``fastpath.block_list``'s), after the fill with 0 (and
    LOWEST), against the same kernel over the whole window on a NaN
    canvas: pixels and score required bit-equal, and no pixel outside
    the list written as other than 0 by the full-window launch. Returns
    (listed launch, full-window launch) as callables on their own
    buffers, for timing."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    coeff = src.spl.coeff
    twined = fplan.spread is not None
    kernel = R.resample_twined_chain if twined else R.resample_planar_chain
    ops = FP.chain_operands(fplan, src)
    tens = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")
            + (("spread",) if twined else ())]
    if blocks is None:
        blocks = FP.block_list(fplan, src)
    shape = (h, w, coeff.shape[-1])
    full = torch.full(shape, float("nan"), device="cuda")
    fsc = torch.full(shape[:2], float("nan"), device="cuda") \
        if scored else None
    lst = torch.zeros(shape, device="cuda")
    lsc = torch.full(shape[:2], SYN.LOWEST, device="cuda") \
        if scored else None
    rs = src.static.recip_step

    def listed():
        kernel(lst, coeff, *tens, score=lsc, recip_step=rs, blocks=blocks,
               **ops)

    def whole():
        kernel(full, coeff, *tens, score=fsc, recip_step=rs, **ops)
    listed()
    whole()
    torch.cuda.synchronize()
    if blocks is not None:
        outside = ~R.block_pixels(blocks, h, w)
        check(not bool((full[outside] != 0).any()), f"{kernel.__name__} "
              f"writes a pixel outside its block list")
    check(torch.equal(lst, full), f"{kernel.__name__} on its block list "
          f"differs from the full-window launch")
    check(not scored or torch.equal(lsc, fsc), f"{kernel.__name__}'s score "
          f"on its block list differs from the full-window launch's")
    return listed, whole


def cover_case(plan, src, what):
    """A small chain job's coverage pass on the card against its plain
    version (``cover_lists``) and its launch on the kernel's list against
    the full-window launch (``listed_vs_full``): returns (the blocks in
    one list and not the other, the kernel's listed blocks, the window's
    blocks)."""
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    got, differ = cover_lists(plan, src, what)[2::2]
    y0, y1, x0, x1 = FP.frame_window(plan)
    h, w = y1 - y0, x1 - x0
    listed_vs_full(plan, src, False, h, w, blocks=got)
    nby, nbx = R.block_grid(h, w)
    return differ, got.numel(), nby * nbx


def compact_path(name, plan, sources, first_ms=None):
    """The compact grid of one job whose block lists its first
    render_frame built: per facet with a list, the share of blocks
    listed, the coverage kernel against its plain version
    (``cover_vs_plain``), every launch of the frame (every tap's, for a
    twined stitch) on its list against the full-window launch of the
    same kernel, bit for bit (``listed_vs_full``), and the first tap's
    launch timed listed against full-window in turns (single and bursts
    of 20); then the frame (``multi_frame``, or ``planar_frame`` into one
    reused buffer) on the lists against the full-window frame
    (``full_window``), bit for bit, and the two timed in turns (single,
    median of 10; bursts of 5 frames, median of 3). Records and returns
    them in COMPACT[name]."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    stitch = len(sources) > 1
    if not stitch:
        taps = [[plan]]
    elif plan.spread is None:
        taps = [FP.facet_plans(plan)]
    else:
        taps = [one for _w, one in FP.tap_plans(plan)]
    scored = stitch and plan.synopsis != "hdr_merge"
    y0, y1, x0, x1 = FP.frame_window(plan)
    h, w = y1 - y0, x1 - x0
    nby, nbx = R.block_grid(h, w)
    facets = []
    for fi, src in enumerate(sources):
        fplan = taps[0][fi]
        if FP.route(fplan, src, scored) != "chain" \
                or FP.block_list(fplan, src) is None:
            facets.append(None)
            continue
        cover = cover_vs_plain(fplan, src, f"{name}, facet {fi}")
        timed = None
        for fplans in taps:
            pair = listed_vs_full(fplans[fi], src, scored, h, w)
            timed = timed or pair
        listed, whole = ab_turns(*timed)
        rec = dict(blocks=cover["blocks"], total=nby * nbx,
                   share=cover["blocks"] / (nby * nbx), cover=cover,
                   launch_ms=listed["ms"], launch_burst_ms=listed["burst_ms"],
                   full_ms=whole["ms"], full_burst_ms=whole["burst_ms"],
                   burst_ratio=listed["burst_ms"] / whole["burst_ms"],
                   launches_bit_equal=len(taps))
        facets.append(rec)
        print(f"{name}: compact grid, facet {fi}: {rec['blocks']} of "
              f"{rec['total']} blocks listed ({100 * rec['share']:.2f}%); "
              f"coverage pass {cover['ms']:.4f} ms with its read back, its "
              f"kernels in bursts {cover['device_ms']:.4f} ms (plain "
              f"{cover['plain_ms']:.3f} ms; bound {cover['bound_ms']:.4f} ms "
              f"by {cover['bound_by']}), {cover['differing_blocks']} blocks "
              f"differ from the plain version's ({cover['plain_blocks']}; "
              f"none allowed); "
              f"the first tap's launch listed / full window: single "
              f"{listed['ms']:.4f} / {whole['ms']:.4f} ms, bursts of 20 "
              f"{listed['burst_ms']:.4f} / {whole['burst_ms']:.4f} ms (x"
              f"{rec['burst_ratio']:.3f}); {len(taps)} launch"
              f"{'es' if len(taps) > 1 else ''} on the list bit-equal to "
              f"the full-window launch", flush=True)
    check(any(f is not None for f in facets), f"{name}: no block list")
    if stitch:
        def frame():
            return FP.multi_frame(plan, sources)
    else:
        buf = torch.empty((h, w, sources[0].spl.coeff.shape[-1]),
                          device="cuda")

        def frame():
            return FP.planar_frame(plan, sources[0], out=buf)

    def whole_frame():
        with full_window():
            return frame()
    got = frame().clone()
    want = whole_frame().clone()
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{name}: the frame on the block lists "
          f"differs from the full-window frame")
    fl, ff = ab_turns(frame, whole_frame, single=10, bursts=3, burst=5)
    out = dict(facets=facets, first_ms=first_ms, frame_ms=fl["ms"],
               frame_burst_ms=fl["burst_ms"], full_frame_ms=ff["ms"],
               full_frame_burst_ms=ff["burst_ms"],
               frame_burst_ratio=fl["burst_ms"] / ff["burst_ms"],
               frame_bit_equal=True)
    print(f"{name}: compact grid, frame on the lists / full window (bit-"
          f"equal): single {fl['ms']:.4f} / {ff['ms']:.4f} ms, bursts of 5 "
          f"{fl['burst_ms']:.4f} / {ff['burst_ms']:.4f} ms (x"
          f"{out['frame_burst_ratio']:.3f}); first render_frame "
          + ("-" if first_ms is None else f"{first_ms:.1f}")
          + f" ms; clocks/power/temp after: {smi_now()}", flush=True)
    COMPACT[name] = out
    return out


def stitch_config(name, rng, builds=None):
    """(facets, sources on the card, synopsis, channels) of a stitch of
    benchmarks.py at full size, its images seeded noise: config 5 (three
    2048x1536 rectilinear facets, hfov 65, yaws -40/0/40; with
    ``name`` "config 5, 4 channels" the same facets with associated
    alpha), config 5b (six 1536x1152 rectilinear facets, hfov 72, yaw
    60 i, lens a, b, c = 0.01, -0.02, 0.005; "config 5b, alpha" with the
    lens crops and exclude polygons of ``pto_cuts``, whose alpha
    ``make_mount_source`` synthesizes: 4 channels), config 5d (the same
    six facets without the lens; twined by its plan) or config 5c (three
    4096x2048 full-spherical brackets, exposure 2^eev for eev -2/0/2,
    brighten 2^-eev, hdr_merge); degree 3. ``builds``, a list, receives
    per facet the host-clock ms of ``make_mount_source`` (its host copy
    and prefilter synchronised) and, for masked facets, of
    ``synthesize_alpha`` alone on the same image."""
    import torch
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import environment as E
    if name == "config 5c":
        specs = [(P.SPHERICAL, 4096, 2048, 360.0, {}, eev)
                 for eev in (-2.0, 0.0, 2.0)]
    elif name.startswith("config 5b"):
        specs = [(P.RECTILINEAR, 1536, 1152, 72.0,
                  dict(yaw=math.radians(60.0 * i), a=0.01, b=-0.02,
                       c=0.005, **(pto_cuts(i, 1536, 1152)
                                   if name.endswith("alpha") else {})),
                  0.0) for i in range(6)]
    elif name == "config 5d":
        specs = [(P.RECTILINEAR, 1536, 1152, 72.0,
                  dict(yaw=math.radians(60.0 * i)), 0.0) for i in range(6)]
    else:
        specs = [(P.RECTILINEAR, 2048, 1536, 65.0,
                  dict(yaw=math.radians(y)), 0.0) for y in (-40.0, 0.0, 40.0)]
    nch = 4 if name.endswith("4 channels") else 3
    facets, sources = [], []
    for i, (proj, w, h, hfov, kw, eev) in enumerate(specs):
        fct = make_facet(proj, w, h, math.radians(hfov), facet_no=i,
                         brighten=2.0 ** -eev, **kw)
        img = rng.random((h, w, nch), dtype=np.float32) * np.float32(
            2.0 ** eev)
        if nch == 4:
            img[..., 3] = 0.3 + 0.7 * rng.random((h, w), dtype=np.float32)
            img[..., :3] *= img[..., 3:]
        facets.append(fct)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sources.append(E.make_mount_source(fct, img, 3, 3, device="cuda"))
        torch.cuda.synchronize()
        rec = dict(build_ms=(time.perf_counter() - t0) * 1e3)
        if fct.has_lens_crop or fct.has_pto_mask:
            # the synthesis alone (median of 3), and the rest of the build
            # on its 4-channel result (the host copy and the prefilter)
            synth = []
            for _ in range(3):
                t0 = time.perf_counter()
                rgba = E.synthesize_alpha(img, fct)
                synth.append((time.perf_counter() - t0) * 1e3)
            bare = make_facet(proj, w, h, math.radians(hfov))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            E.make_mount_source(bare, rgba, 3, 3, device="cuda")
            torch.cuda.synchronize()
            rec.update(synth_ms=float(np.median(synth)),
                       rest_ms=(time.perf_counter() - t0) * 1e3)
            rec["synth_share"] = rec["synth_ms"] / (rec["synth_ms"]
                                                    + rec["rest_ms"])
        if builds is not None:
            builds.append(rec)
    nch = sources[0].spl.coeff.shape[-1]
    return facets, sources, "hdr_merge" if name == "config 5c" \
        else "panorama", nch


def stitch_plan(facets, synopsis, nch, twine=0):
    """The stitch's plan: a 4096x2048 equirect of all facets, twined for
    ``twine`` n > 0 as twine_setup twines it: make_spread(n, n), an n x n
    box for n >= 2, 2 x 1 taps for n = 1."""
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.runtime.render import build_plan
    a = make_args(facets[0], P.SPHERICAL, 4096, 2048, 360, 3, nch=nch,
                  twine=twine)
    a.facets, a.solo, a.synopsis = facets, -1, synopsis
    return build_plan(a, facets)


def hdr_condition(px_list, brightens, out):
    """(H, W) first-order amplification of an hdr_merge frame's pixels by
    differences in its brackets' pixels: max over channels of
    sum_j (|q_j| + (|px_j| + |out|) / optimum_j^2) / |sum_j q_j|, the
    quality weights q_j of 1- or 3-channel brackets (slope at most
    1/optimum^2 in the grey value) and the merged ``out``."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    qs = SYN.hdr_qualities(px_list, brightens, out.shape[-1])
    num = torch.zeros_like(out)
    for px, q, (_kind, opt) in zip(px_list, qs, SYN.hdr_kinds(brightens)):
        num += q.abs()[..., None] + (px.abs() + out.abs()) / (opt * opt)
    return (num / sum(qs).abs()[..., None]).amax(dim=-1)


def stitch_errors(plan, sources, frame, stack, score, chunk=128,
                  amplify=None, skipped=None):
    """A stitch's ``frame`` and its facets' slots against the port's
    exact path on the card, in row chunks: each facet rendered into its
    slot of ``stack`` (and ``score``, None for hdr_merge) as
    ``fastpath.multi_frame`` renders it (``facet_into``; for a twined
    stitch tap by tap, through the one-tap plans) and held against the
    facet's lookup at the same rays (a twined tap's deflected rays), and
    the frame against the exact synopsis. Excluded: pixels whose planar
    coordinate in some facet (at some tap) lies within WINDOW_EDGE of
    its window's edge; voronoi pixels whose two best scores (at some
    tap) lie within FLIP_REL of each other; hdr_merge pixels where the
    merge (of some tap) amplifies the slots' own difference from the
    lookups past PATH_BOUND (``hdr_condition`` times that difference: a
    quality sum near 0). Returns (frame max abs diff, slot max abs diff,
    window-edge px, champion-flip or ill-conditioned px); ``stack`` and
    ``score`` hold the last tap's slots. ``amplify`` (a ``--single``
    job's) brightens the exact frame as ``render_frame`` brightens it.
    ``skipped``, a list, receives the (H, W) plane of the excluded
    pixels."""
    import torch
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.models import stepper as ST
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime import render as RD
    h, w = frame.shape[:2]
    nch = plan.nchannels
    brightens = [s.static.brighten for s in sources]
    if plan.spread is None:
        taps = [(None, FP.facet_plans(plan))]
    else:
        taps = list(zip(SYN.scaled_spread(plan.spread),
                        (fplans for _w, fplans in FP.tap_plans(plan))))
    edge = torch.zeros((h, w), dtype=torch.bool, device="cuda")
    other = torch.zeros_like(edge)
    worst_slot = 0.0
    for tap, fplans in taps:
        for fi, (fplan, src) in enumerate(zip(fplans, sources)):
            FP.facet_into(fplan, src, stack[fi],
                          None if score is None else score[fi])
        for r0 in range(0, h, chunk):
            r1 = min(r0 + chunk, h)
            geom = dict(normalize=True, window=(r0, r1, 0, w), device="cuda")
            scores, lookups = [], []
            slot_diff = torch.zeros((r1 - r0, w), device="cuda")
            for fi, (src, b, p2r) in enumerate(zip(sources, plan.bases,
                                                   plan.planar_to_ray)):
                if tap is None:
                    ray = ST.target_rays(plan.projection, plan.width,
                                         plan.height, plan.extent, basis=b,
                                         planar_to_ray=p2r, **geom)
                else:
                    p = ST.target_ninepack(plan.projection, plan.width,
                                           plan.height, plan.extent, basis=b,
                                           planar_to_ray=p2r, **geom)
                    ray = SYN.deflect(p[0], *SYN.derivative_rays(
                        *p, plan.twine_precise), tap[0], tap[1])
                pick = FP._pickup(src)
                px, py, hit = R.mount_planar(pick, *ray)
                x0, x1, y0, y1 = pick.window
                for v, e in ((px, x0), (px, x1), (py, y0), (py, y1)):
                    edge[r0:r1] |= (v - e).abs() <= WINDOW_EDGE
                if pick.projection == 2:       # rectilinear: z > 0
                    edge[r0:r1] |= ray[2].abs() <= WINDOW_EDGE
                scores.append(SYN.facet_score(ray[2], hit,
                                              src.static.recip_step))
                lookups.append(E.lookup(src, ray, nch)[0])
                slot_diff = torch.maximum(slot_diff, (
                    stack[fi, r0:r1] - lookups[-1]).abs().amax(dim=-1))
            if plan.synopsis == "hdr_merge":
                merged = SYN.hdr_merge_stack(lookups, brightens, nch)
                other[r0:r1] |= hdr_condition(lookups, brightens, merged) \
                    * slot_diff > PATH_BOUND
            else:
                top2 = torch.topk(torch.stack(scores), 2, dim=0).values
                other[r0:r1] |= (top2[1] > SYN.LOWEST) & (
                    (top2[0] - top2[1]).abs() <= FLIP_REL * top2[0].abs())
            worst_slot = max(worst_slot, float(torch.where(
                edge[r0:r1], 0.0, slot_diff).max()))
    worst = 0.0
    for r0 in range(0, h, chunk):
        r1 = min(r0 + chunk, h)
        exact = RD._render_window(plan, sources, (r0, r1, 0, w))
        if amplify is not None:
            exact = E.apply_brighten(exact, amplify)
        diff = (torch.from_numpy(frame[r0:r1]).cuda() - exact).abs().amax(
            dim=-1)
        worst = max(worst, float(torch.where(edge[r0:r1] | other[r0:r1],
                                             0.0, diff).max()))
    if skipped is not None:
        skipped.append(edge | other)
    return worst, worst_slot, int(edge.sum()), int((other & ~edge).sum())


def facet_kernel(fplan, src, out, score):
    """A callable that launches one facet's kernel of a stitch (of one
    tap, for a twined stitch's one-tap plan), alone, as
    ``fastpath.facet_into`` launches it (``out`` holds the source's
    channels; a chain form on the plan's block list, the compact grid);
    and the launch's bound (bound ms, by, bytes, ops ms), that of the
    same function with every pixel of the slot written."""
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    coeff = src.spl.coeff
    n_px = out.shape[0] * out.shape[1]
    twined = fplan.spread is not None
    if score is None and FP.inline_mode(fplan, src) is not None:
        ops = FP.frame_operands(fplan, src)
        tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
        if twined:
            tensors.append(ops.pop("spread"))
            b = inline_twined_bound(fplan, src)
            return (lambda: R.resample_inline_twined(out, coeff, *tensors,
                                                     **ops),
                    (b[0], b[1], b[4] + n_px * coeff.shape[-1] * 4, b[3]))
        b = inline_bound(fplan, src, n_px)
        return (lambda: R.resample_inline(out, coeff, *tensors, **ops),
                (b[0], b[1], b[4] + n_px * coeff.shape[-1] * 4, b[3]))
    ops = FP.chain_operands(fplan, src)
    if twined:
        b = twined_chain_bound(fplan, src, ops)
    else:
        b = chain_bound(fplan, src, ops)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")
               + (("spread",) if twined else ())]
    kernel = R.resample_twined_chain if twined else R.resample_planar_chain
    blocks = FP.block_list(fplan, src)
    moved = b[4] + n_px * coeff.shape[-1] * 4 + (0 if score is None
                                                  else n_px * 4)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (lambda: kernel(out, coeff, *tensors, score=score,
                           recip_step=src.static.recip_step, blocks=blocks,
                           **ops),
            (max(bytes_ms, b[3]), "bytes" if bytes_ms >= b[3]
             else "operations", moved, b[3]))


def facet_vs_plain(fplan, src, scored):
    """One facet of a stitch at the stitch's shape (of one tap, for a
    twined stitch's one-tap plan): the kernel that ``fastpath.launch``
    takes for it against its plain version on the same operands
    (``kernel_vs_plain`` for the inline kernel, both of its branches;
    ``twined_kernel_vs_plain`` for the inline twined kernel;
    ``chain_vs_plain`` for a chain form, and with ``scored`` its score
    by ``chain_score_vs_plain``, pixels bit-equal with and without it).
    The pixels are held to KERNEL_BOUND in units of the facet's largest
    value where that exceeds 1: float rounding scales with the values,
    and config 5c's brightest bracket reaches 4. Checks each against its
    bound; returns a dict of the errors, that scale and the window- or
    face-edge pixels excluded."""
    from envutil_tpu_torch.runtime import fastpath as FP
    twined = fplan.spread is not None
    if not scored and FP.inline_mode(fplan, src) is not None:
        if twined:
            err, n_edge, plain = twined_kernel_vs_plain(fplan, src)
            rec = dict(kernel="resample_inline_twined", edge_px=n_edge)
        else:
            err, n_edge, _k, plain = kernel_vs_plain(fplan, src,
                                                     src.spl.degree)
            rec = dict(kernel="resample_inline", edge_px=n_edge)
    else:
        err, n_edge, n_flip, _k, plain = chain_vs_plain(fplan, src)
        rec = dict(kernel="resample_twined_chain" if twined
                   else "resample_planar_chain", edge_px=n_edge,
                   coverage_flips=n_flip)
        if scored:
            rec["score_err"], rec["scored_px"] = chain_score_vs_plain(fplan,
                                                                      src)
            check(rec["score_err"] <= SCORE_BOUND, f"{rec['kernel']}'s "
                  f"score disagrees with its plain version at a stitch's "
                  f"shape: {rec['score_err']}")
    rec.update(max_abs_err=err, scale=max(1.0, float(plain.abs().max())))
    check(err <= KERNEL_BOUND * rec["scale"], f"{rec['kernel']} disagrees "
          f"with its plain version at a stitch's shape: {err} (values up to "
          f"{rec['scale']:.3f})")
    return rec


# ---- the voronoi route: champion planes, champion and tapsel modes ------

# the voronoi route's frame against the stack route's (multi_frame) on the
# card: the same champions from the same scores and the same spline at
# the same coordinates; the stack route brightens each tap's value and
# then sums, this route sums and then brightens, a few ulps apart
STACK_BOUND = 1e-5
# the champion planes, kernel against plain version (or against the
# argmax of the stack route's one-tap scores): two facets' scores within
# this relative margin may swap the champion under an ulp of a ray (the
# plain version's transcendentals are PyTorch's on the card); such
# pixels are counted, and held to TIE_SHARE of a tap's pixels
TIE_REL = 1e-6
TIE_SHARE = 1e-3
# per stitch name, the record of champion_path
CHAMPION = {}


def tap_scores(plan, sources):
    """(K, F, H, W) float32: the voronoi scores that the stack route's
    launches write (``fastpath.launch`` with a score plane; per tap of a
    twined stitch, its one-tap plans), on the card."""
    import torch
    from envutil_tpu_torch.runtime import fastpath as FP
    taps = [FP.facet_plans(plan)] if plan.spread is None else \
        [one for _w, one in FP.tap_plans(plan)]
    y0, y1, x0, x1 = FP.frame_window(plan)
    out = torch.empty((len(taps), len(sources), y1 - y0, x1 - x0),
                      device="cuda")
    for k, fplans in enumerate(taps):
        for f, (fp, src) in enumerate(zip(fplans, sources)):
            buf = torch.empty((y1 - y0, x1 - x0, src.spl.coeff.shape[-1]),
                              device="cuda")
            FP.launch(fp, src, buf, out[k, f])
    return out


def first_wins(scores):
    """(K, H, W) uint8: per tap and pixel the first facet of the largest
    score (``NO_CHAMPION`` where every score is LOWEST), computed
    without torch.max's tie order; and the (K, H, W) near-tie mask, the
    two best scores within TIE_REL of each other."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    best = scores.amax(dim=1, keepdim=True)
    idx = torch.arange(scores.shape[1], device=scores.device).view(
        1, -1, 1, 1)
    first = torch.where(scores == best, idx, scores.shape[1]).amin(dim=1)
    first = torch.where(best[:, 0] > SYN.LOWEST, first, R.NO_CHAMPION)
    top2 = torch.topk(scores, min(2, scores.shape[1]), dim=1).values
    tie = (top2[:, -1] > SYN.LOWEST) & (
        (top2[:, 0] - top2[:, -1]).abs() <= TIE_REL * top2[:, 0].abs())
    return first.to(torch.uint8), tie


@contextlib.contextmanager
def plain_champions():
    """The champion pass on its plain versions while the block is active
    (the comparison in the script only; the program has no such
    switch)."""
    from envutil_tpu_torch.ops import resample as R
    real = R.champion_planes, R.champion_lists
    R.champion_planes, R.champion_lists = (R.champion_planes_plain,
                                           R.champion_lists_plain)
    try:
        yield
    finally:
        R.champion_planes, R.champion_lists = real


def champion_bound(plan, sources, champs):
    """(bound ms, by, bytes, ops ms) of the champion pass of a stitch,
    counted from this run's data: per facet on the kernel route, over
    the pixels of its coverage list (the whole window where it has
    none), the chain (untwined: one ray, its normalisation and the
    pickup; twined: three rays, the derivative rays) and K deflections
    and window tests; bytes: the champion planes written once and the
    features read."""
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    k, h, w = champs.planes.shape
    ops, moved = 0, champs.planes.numel()
    for fp, src in zip(FP.facet_plans(plan), sources):
        if FP.route(fp, src, True) == "planes":
            continue
        cops = FP.chain_operands(fp, src)
        blocks = FP.block_list(fp, src)
        n_px = h * w if blocks is None else blocks.numel() * 256
        chain = TARGET_FLOPS[cops["tmode"]] + 12
        test = pickup_flops(cops["pick"])
        if plan.spread is None:
            ops += n_px * (chain + test)
        else:
            ops += n_px * (3 * chain + (21 if plan.twine_precise else 6)
                           + k * (12 + test))
        moved += sum(cops[t].numel() * 4 for t in ("xfeat", "yfeat",
                                                   "bmats"))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", moved, ops_ms)


def mode_bound(fplan, src, champs, facet):
    """(bound ms, by, bytes, ops ms) of one facet's launch on the voronoi
    route, counted from this run's data whatever implements it: the
    table entries under the taps the facet champions, counted once, the
    champion bytes of its listed pixels read and its champion pixels
    written (twined: read and written, the launch adds); operations: the
    chain of every champion pixel (twined: three rays and pickups and the
    derivatives) and the spline (and deflection) of every champion tap.
    A translated facet's planes form reads its operand planes and mask
    over the window as well."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    coeff, n = src.spl.coeff, src.spl.degree
    nch = coeff.shape[-1]
    own = champs.planes == facet
    px = own.any(0)
    n_own = int(px.sum())
    listed = champs.lists[facet].numel() * 256 * champs.planes.shape[0]
    planes = FP.route(fplan, src, True) == "planes"
    window = FP.frame_window(fplan)
    if fplan.spread is None:
        if planes:
            sx, sy, _m, _z = FP.coords(fplan, window, src)
        else:
            cops = FP.chain_operands(fplan, src)
            sx, sy, _m = R.planar_chain_coords(*(cops[k] for k in (
                "xfeat", "yfeat", "bmats")), **{k: cops[k] for k in (
                    "tmode", "pick", "row0", "face_rows")})
        table = touched_bytes(coeff, sx[px], sy[px], n)
        pairs, extra = n_own, (3 * sx.numel() * 4 if planes else listed)
        per_px = 0 if planes else TARGET_FLOPS[
            cops["tmode"]] + 12 + pickup_flops(cops["pick"])
        spline = spline_flops(n, nch)
        out_bytes = n_own * nch * 4
    else:
        if planes:
            tw = FP.twined_coords(fplan, window, src, tap_valid=False)
            per_px = 0
            extra = 6 * tw["sx"].numel() * 4 + own.numel()
        else:
            cops = FP.chain_operands(fplan, src)
            tw = R.twined_chain_operands(*(cops[k] for k in (
                "xfeat", "yfeat", "bmats", "spread")), **{
                    k: cops[k] for k in ("tmode", "pick", "row0",
                                         "face_rows", "precise")})
            per_px = 3 * (TARGET_FLOPS[cops["tmode"]] + 12
                          + pickup_flops(cops["pick"])) \
                + (21 if fplan.twine_precise else 6) + 8
            extra = listed
        spread = FP._spread_tensor(fplan.spread, coeff.device)
        table, pairs = live_tap_table(coeff, n, dict(
            tw, tap_weights=own.to(torch.uint8)), spread)
        spline = 4 + spline_flops(n, nch) + 2 * nch
        out_bytes = 2 * n_own * nch * 4
    moved = table + out_bytes + extra
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = (n_own * per_px + pairs * spline) / F32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", moved, ops_ms)


def mode_plain(fplan, src, frame, champs, facet):
    """A callable that runs one facet's launch on the voronoi route as
    the kernels' plain versions do it, on the same operands, into
    ``frame``."""
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    if FP.route(fplan, src, True) == "planes":
        return None
    ops = FP.chain_operands(fplan, src)
    args = [src.spl.coeff] + [ops.pop(k) for k in ("xfeat", "yfeat",
                                                    "bmats")]
    kw = dict(ops, blocks=champs.lists[facet], champ=champs.planes,
              facet=facet, scale=src.static.brighten)
    if fplan.spread is None:
        return lambda: R.resample_planar_chain_plain(frame, *args, **kw)
    args.append(kw.pop("spread"))
    kw.update(tap_valid=False, accumulate=True)
    return lambda: R.resample_twined_chain_plain(frame, *args, **kw)


def champion_path(name, plan, sources, frame, first_ms, skip, first_peak):
    """The voronoi route of one stitch at full size, after its first
    ``render_frame`` (``frame``, the host frame; ``first_ms``; its peak
    device memory ``first_peak`` in MiB), held and timed:

    - the champion planes the first frame built against the first-wins
      argmax of the stack route's one-tap scores (``tap_scores``; the
      same device functions score both) and against the champion pass's
      plain versions on the card: equal but at near-tied scores, counted
      per tap (TIE_SHARE); the champion lists against the plain
      version's, equal; torch.max's index (the stack route's
      ``voronoi_stack``) the first maximum on this card too;
    - the frame against the stack route (``multi_frame``) at STACK_BOUND,
      ``skip`` (window-edge and near-tied pixels of ``stitch_errors``)
      excluded and counted, and its max over every pixel beside it
      (untwined with brighten 1: bit-equal); a second frame builds no
      champion planes and makes F launches; the frame with the champion
      pass over full windows (``full_window``) bit-equal;
    - CUDA-event times: the frame single (median of 10) and in bursts of
      10 (median of 3) in turns against the stack route (``ab_turns``),
      each facet's launch (median of 10) and its plain version (median
      of 3) beside its bound (``mode_bound``), the champion pass as a
      plan builds it (the count read back included; median of 5) and its
      plain version (median of 3) beside its bound, and the lists alone;
      the peak device memory of a frame of each route (the champion
      planes kept per plan, the stack route's stacks per frame).

    Records and returns the record in CHAMPION[name]."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    champs = FP.champion_planes(plan, sources)
    k, h, w = champs.planes.shape
    n_f = len(sources)
    scores = tap_scores(plan, sources)
    want, tie = first_wins(scores)
    _best, by_max = torch.max(scores, dim=1)
    owned = want != R.NO_CHAMPION
    max_first = bool(torch.equal(by_max.to(torch.uint8)[owned], want[owned]))
    check(max_first, f"{name}: torch.max's champion is not the first "
          f"maximum on this card")
    vs_stack = champs.planes != want
    del scores, _best, by_max
    with plain_champions():
        plain = FP._build_champions(plan, sources)
    vs_plain = champs.planes != plain.planes
    torch.cuda.synchronize()
    # the kernels score by the same device functions, rounded step by
    # step: their planes equal the argmax but at ties; the plain version
    # may also flip a pixel at a window edge (``skip``)
    untied = (int((vs_stack & ~tie).sum()),
              int((vs_plain & ~tie & ~skip).sum()))
    tied = [int(t) for t in (vs_plain & (tie | skip)).sum(dim=(1, 2))]
    check(untied == (0, 0), f"{name}: the champion planes differ from the "
          f"stack route's argmax at {untied[0]} and from the plain "
          f"version's at {untied[1]} pixels whose scores are not tied, "
          f"away from window edges")
    check(max(tied) <= TIE_SHARE * h * w, f"{name}: {tied} near-tied or "
          f"window-edge pixels per tap with another champion in the plain "
          f"version")
    lists_equal = all(torch.equal(a, b) for a, b in zip(champs.lists,
                                                        plain.lists))
    check(lists_equal or bool(vs_plain.any()), f"{name}: the champion "
          f"lists differ from the plain version's on equal planes")
    del plain, vs_stack, vs_plain
    # the frame against the stack route's
    got = torch.from_numpy(frame).cuda()
    stack = FP.multi_frame(plan, sources)
    diff = (got - stack).abs().amax(dim=-1)
    all_err = float(diff.max())
    err = float(torch.where(skip, 0.0, diff).max())
    n_skip = int(skip.sum())
    bit_equal = bool(torch.equal(got, stack))
    check(err <= STACK_BOUND, f"{name}: the voronoi route's frame differs "
          f"from the stack route's by {err:.3e}")
    if plan.spread is None and all(s.static.brighten == 1.0
                                   for s in sources):
        check(bit_equal, f"{name}: untwined, the voronoi route's frame is "
              f"not bit-equal to the stack route's")
    del stack
    again, n2 = launch_counts(lambda: FP.voronoi_frame(plan, sources))
    check(torch.equal(again, got), f"{name}: a second frame differs")
    check(not any(c in n2 for c in ("champion_planes", "champion_lists",
                                    "chain_blocks", "multi_frame"))
          and sum(n2.get(c, 0) for c in ("resample_planar_chain",
                                         "resample_twined_chain",
                                         "resample_planar",
                                         "resample_twined")) == n_f,
          f"{name}: a second frame's launches {n2}")
    with full_window():
        full = FP.voronoi_frame(plan, sources)
    check(torch.equal(full, got), f"{name}: the frame with the champion "
          f"pass over full windows differs")
    del again, full
    # times
    fl, fs = ab_turns(lambda: FP.voronoi_frame(plan, sources),
                      lambda: FP.multi_frame(plan, sources), single=10,
                      bursts=3, burst=10)
    scratch = torch.zeros((h, w, plan.nchannels), device="cuda")
    facets = []
    for fi, (fp, src) in enumerate(zip(FP.facet_plans(plan), sources)):
        what = FP.champion_launch(fp, src, scratch, champs, fi)
        rec = dict(kernel=what, blocks=champs.lists[fi].numel(),
                   ms=events_ms(lambda fp=fp, s=src, i=fi:
                                FP.champion_launch(fp, s, scratch, champs,
                                                   i), 10))
        plain_launch = mode_plain(fp, src, scratch, champs, fi)
        rec["plain_ms"] = None if plain_launch is None else \
            events_ms(plain_launch, 3)
        b = mode_bound(fp, src, champs, fi)
        rec.update(bound_ms=b[0], bound_by=b[1])
        facets.append(rec)
    del scratch
    pass_ms = events_ms(lambda: FP._build_champions(plan, sources), 5)
    with plain_champions():
        pass_plain_ms = events_ms(lambda: FP._build_champions(plan,
                                                              sources), 3)
    lists_ms = events_ms(lambda: R.champion_lists(champs.planes, n_f), 10)
    lists_plain_ms = events_ms(lambda: R.champion_lists_plain(
        champs.planes, n_f), 3)
    pbound = champion_bound(plan, sources, champs)
    lbound = champs.planes.numel() / HBM_BYTES_PER_S * 1e3
    peaks = []
    for frame_fn in (lambda: FP.voronoi_frame(plan, sources),
                     lambda: FP.multi_frame(plan, sources)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        frame_fn()
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
    planes_mib = champs.planes.numel() / 2**20
    rec = dict(facets=n_f, taps=k, launches_per_frame=n_f,
               first_ms=first_ms, first_peak_mib=first_peak,
               frame_ms=fl["ms"], frame_burst_ms=fl["burst_ms"],
               stack_frame_ms=fs["ms"], stack_frame_burst_ms=fs["burst_ms"],
               frame_turns=fl["turns"], stack_turns=fs["turns"],
               max_abs_err_vs_stack=err, max_abs_err_vs_stack_all_px=all_err,
               bit_equal_to_stack=bit_equal, excluded_px=n_skip,
               champion_differs_untied_px=list(untied),
               champion_differs_tied_px_per_tap=tied,
               torch_max_first=max_first, lists_equal=lists_equal,
               launches=facets, pass_ms=pass_ms, pass_plain_ms=pass_plain_ms,
               pass_bound_ms=pbound[0], pass_bound_by=pbound[1],
               lists_ms=lists_ms, lists_plain_ms=lists_plain_ms,
               lists_bound_ms=lbound, frame_peak_mib=peaks[0],
               stack_frame_peak_mib=peaks[1], planes_mib=planes_mib)
    shape = tuple(champs.planes.shape)
    print(f"{name}: voronoi route (champion planes {shape} uint8, "
          f"{planes_mib:.1f} MiB kept per plan): "
          f"{n_f} launches a frame, the champion pass once per plan; "
          f"planes vs the stack route's first-wins argmax and vs the plain "
          f"pass: {untied} px differ at untied scores away from window "
          f"edges, {tied} near-tied or window-edge px per tap differ from "
          f"the plain pass (bound "
          f"{int(TIE_SHARE * h * w)}); torch.max takes the first maximum: "
          f"{max_first}; lists equal to the plain version's: {lists_equal}; "
          f"frame vs the stack route {err:.3e} (bound {STACK_BOUND:g}; "
          f"{n_skip} window-edge or near-tied px excluded; all px "
          f"{all_err:.3e}; bit-equal {bit_equal}); the frame with the pass "
          f"over full windows bit-equal", flush=True)
    print(f"{name}: voronoi route frame single {fl['ms']:.4f} ms / bursts "
          f"{fl['burst_ms']:.4f} ms vs the stack route {fs['ms']:.4f} / "
          f"{fs['burst_ms']:.4f} ms (x{fl['burst_ms'] / fs['burst_ms']:.3f}"
          f" in bursts); per facet launch " + ", ".join(
              f"{f['ms']:.4f}" for f in facets) + " ms (plain " + ", ".join(
              "-" if f["plain_ms"] is None else f"{f['plain_ms']:.3f}"
              for f in facets) + " ms; bounds " + ", ".join(
              f"{f['bound_ms']:.4f} {f['bound_by']}" for f in facets)
          + f"); champion pass {pass_ms:.4f} ms with its read back (plain "
          f"{pass_plain_ms:.3f} ms; bound {pbound[0]:.4f} ms by "
          f"{pbound[1]}), lists alone {lists_ms:.4f} ms (plain "
          f"{lists_plain_ms:.3f}; bound {lbound:.4f} by bytes); first "
          f"render_frame {first_ms:.1f} ms (peak {first_peak:.1f} MiB); "
          f"peak device memory of a frame {peaks[0]:.1f} MiB vs the stack "
          f"route's {peaks[1]:.1f} MiB; clocks/power/temp after: "
          f"{smi_now()}", flush=True)
    CHAMPION[name] = rec
    return rec


def voronoi_want(plan, sources):
    """The launches of a voronoi stitch's first frame on its route: per
    facet one launch of its kernel in its champion (or tapsel) mode, one
    coverage pass and one champion kernel launch per facet on the chain
    forms, one champion lists launch; nothing of the stack route."""
    from envutil_tpu_torch.runtime import fastpath as FP
    twined = plan.spread is not None
    want = {"champion_lists": 1}
    for fp, src in zip(FP.facet_plans(plan), sources):
        how = FP.route(fp, src, True)
        if how == "planes":
            kernel = "resample_twined" if twined else "resample_planar"
        else:
            kernel = ("resample_twined_chain:tapsel" if twined
                      else "resample_planar_chain:champion")
            want[kernel.split(":")[0]] = want.get(kernel.split(":")[0], 0) + 1
            want["champion_planes"] = want.get("champion_planes", 0) + 1
            if not FP._covers_every_ray(src):
                want["chain_blocks"] = want.get("chain_blocks", 0) + 1
        want[kernel] = want.get(kernel, 0) + 1
    return want


def stitch_path(name, rng, coeff_dtype="f32", twine=0):
    """One stitch of benchmarks.py at full size, its tables of
    ``coeff_dtype``, twined for ``twine`` n > 0 (``stitch_plan``),
    through render_frame and multi_frame: the launches per form
    (twined: one a facet and tap), the frame against the exact path
    (window-edge and champion-flip pixels excluded and counted), each
    facet's kernel (and score) against its plain version at the
    stitch's shape (``facet_vs_plain``; twined, the first tap's), the
    peak device memory of the first frame, and CUDA-event timings
    (median of 10 each) of every facet's kernel alone, of every facet
    into its slot (``facet_into``: the kernel and the channel
    adaptation and brighten), of the synopsis combine on the stacks and
    of the whole frame, each beside its bound; twined, the kernels and
    the combine of one tap, the combine's share of the frame counting
    every tap's."""
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.runtime import fastpath as FP
    builds = []
    facets, sources, synopsis, nch = stitch_config(name, rng, builds)
    sources = [with_coeff(s, coeff_dtype) for s in sources]
    if all("synth_ms" in b for b in builds):
        print(f"{name}: per facet, make_mount_source (host clock, "
              f"synchronised) " + ", ".join(
                  f"{b['build_ms']:.1f}" for b in builds) + " ms; "
              "synthesize_alpha alone (host numpy, median of 3) " + ", ".join(
                  f"{b['synth_ms']:.1f}" for b in builds) + " ms, the rest of "
              "the build (host copy, prefilter) " + ", ".join(
                  f"{b['rest_ms']:.1f}" for b in builds) + " ms: the "
              "synthesis " + ", ".join(
                  f"{100 * b['synth_share']:.0f}%" for b in builds)
              + " of the source build", flush=True)
    if coeff_dtype != "f32":
        name = f"{name}, {coeff_dtype}"
    plan = stitch_plan(facets, synopsis, nch, twine)
    n_f, n_px = len(sources), plan.height * plan.width
    n_t = 1 if plan.spread is None else len(plan.spread)
    if n_t > 1:
        name = f"{name}, twined ({n_t} taps)"
    hdr = synopsis == "hdr_merge"
    kernel = ("resample_inline" if hdr else "resample_planar_chain") \
        if plan.spread is None else \
        ("resample_inline_twined" if hdr else "resample_twined_chain")
    # a facet on the chain forms (every facet of these stitches but
    # hdr_merge's) gets its block list from one coverage pass at the
    # first frame; a voronoi stitch takes the voronoi route (one launch a
    # facet, after the champion pass), the others the stack route
    routed = FP.champion_route(plan, sources) is None
    want = voronoi_want(plan, sources) if routed else {
        kernel: n_f * n_t, "chain_blocks": 0 if hdr else n_f,
        "multi_frame": 1}
    frame, first_ms, n = render(plan, sources, name, want=want)
    peak = torch.cuda.max_memory_allocated() / 2**20
    covered = float((frame != 0).any(axis=-1).mean())
    stack = torch.empty((n_f, plan.height, plan.width, nch), device="cuda")
    score = None if hdr else torch.empty((n_f, plan.height, plan.width),
                                         device="cuda")
    skipped = []
    err, err_slot, n_edge, n_other = stitch_errors(plan, sources, frame,
                                                   stack, score,
                                                   skipped=skipped)
    routed_rec = None
    if routed:
        routed_rec = champion_path(name, plan, sources, frame, first_ms,
                                   skipped[0], peak)
    del skipped
    fplans = FP.facet_plans(plan) if plan.spread is None \
        else FP.tap_plans(plan)[0][1]
    vs_plain = [facet_vs_plain(fp, s, not hdr)
                for fp, s in zip(fplans, sources)]
    print(f"{name}: each facet's kernel vs its plain version at this shape"
          + ("" if n_t == 1 else " (the first tap's launches)") + ": "
          + "; ".join(
              f"{v['kernel']} {v['max_abs_err']:.3e}"
              + (f", score {v['score_err']:.3e} of z over {v['scored_px']} px"
                 if "score_err" in v else "")
              + f", {v['edge_px']} edge px excluded, values up to "
              f"{v['scale']:.3f}" for v in vs_plain)
          + f" (bounds {KERNEL_BOUND:g} times those values where above 1, "
          f"score {SCORE_BOUND:g})", flush=True)
    other = "where the merge's quality sum nearly cancels" if hdr \
        else "at a near-tied champion"
    print(f"{name}: {n_f}-facet {synopsis} ({nch} channels), "
          f"{100 * covered:.2f}% of the equirect not 0; vs exact path, whole "
          f"frame: max abs diff {err:.3e}, facets' slots vs their lookups "
          f"{err_slot:.3e} (bound {PATH_BOUND:g}); {n_edge} px at a window "
          f"edge and {n_other} {other} excluded"
          + ("" if n_t == 1 else " (at any tap)"), flush=True)
    check(err <= PATH_BOUND and err_slot <= PATH_BOUND,
          f"{name} disagrees with the exact path")
    check(hdr or n_edge + n_other <= 1e-3 * n_px * n_t,
          f"{name}: too many pixels excluded")
    check(covered > 0.0, f"{name}: the frame is empty")
    del frame
    kernels, into = [], []
    for fi, (fplan, src) in enumerate(zip(fplans, sources)):
        sc = None if score is None else score[fi]
        kernels.append(facet_kernel(fplan, src, stack[fi], sc))
        into.append(lambda fp=fplan, s=src, o=stack[fi], c=sc:
                    FP.facet_into(fp, s, o, c))
    if hdr:
        brightens = [s.static.brighten for s in sources]

        def combine():
            SYN.hdr_merge_stack(list(stack), brightens, nch)
    else:
        comb = SYN.voronoi_stack if nch in (1, 3) else SYN.voronoi_plus_stack

        def combine():
            comb(stack, None, score)

    def whole():
        FP.multi_frame(plan, sources)
    for f in [k for k, _b in kernels] + into + [combine, whole]:
        f()
    turns = None
    if kernel == "resample_inline_twined":
        # the first facet's one-tap K4 launch, before and after
        turns = k4_turns(f"{name}, facet 0's one-tap launch",
                         kernels[0][0], stack[0])
    kernel_ms = [events_ms(k, 10) for k, _b in kernels]
    into_ms = [events_ms(f, 10) for f in into]
    combine_ms = events_ms(combine, 10)
    frame_ms = events_ms(whole, 10)
    k_bounds = [b for _k, b in kernels]
    out_bytes = n_px * nch * 4
    stack_bytes = n_f * n_px * nch * 4 + (0 if hdr else n_f * n_px * 4)
    combine_bound = (stack_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    frame_bytes = n_t * (sum(b[2] for b in k_bounds) + stack_bytes
                         + out_bytes)
    frame_ops = n_t * sum(b[3] for b in k_bounds)
    frame_bound = max(frame_bytes / HBM_BYTES_PER_S * 1e3, frame_ops)
    share = n_t * combine_ms / frame_ms
    tap = "" if n_t == 1 else " (one tap)"
    print(f"{name}: per-facet kernels alone{tap} "
          f"{', '.join(f'{t:.4f}' for t in kernel_ms)} ms (sum "
          f"{sum(kernel_ms):.4f}; bounds "
          f"{', '.join(f'{b[0]:.4f} {b[1]}' for b in k_bounds)}); facets "
          f"into their slots{tap} {', '.join(f'{t:.4f}' for t in into_ms)} "
          f"ms (sum {sum(into_ms):.4f}); combine{tap} {combine_ms:.4f} ms "
          f"(bound {combine_bound:.4f} ms by bytes: the stacks read, the "
          f"frame written); frame (multi_frame, stacks allocated per frame"
          + ("" if n_t == 1 else f", {n_f * n_t} launches and {n_t} "
             f"combines") + f") {frame_ms:.4f} ms = "
          f"{n_px / 1e3 / frame_ms:.1f} Mpix/s, bound "
          f"{frame_bound:.4f} ms (table entries read once"
          + ("" if n_t == 1 else " a tap") + ", the stacks written and "
          f"read, the output; the kernels' operations); the combine"
          + ("" if n_t == 1 else "s") + f" {100 * share:.0f}% of the "
          f"frame; peak device memory of the first frame {peak:.1f} MiB "
          f"(stacks {stack_bytes / 2**20:.1f} MiB); clocks/power/temp "
          f"after: {smi_now()}", flush=True)
    compact = None
    if not hdr and coeff_dtype == "f32":
        compact = compact_path(name, plan, sources, first_ms)
    return dict(facets=n_f, taps=n_t, synopsis=synopsis, channels=nch,
                compact=compact, voronoi_route=routed_rec,
                launches=n, first_ms=first_ms, max_abs_err=err,
                slot_max_abs_err=err_slot, edge_px=n_edge,
                excluded_px=n_other, covered=covered, vs_plain=vs_plain,
                kernel_ms=kernel_ms,
                kernel_bound_ms=[b[0] for b in k_bounds],
                kernel_bound_by=[b[1] for b in k_bounds], into_ms=into_ms,
                combine_ms=combine_ms, combine_bound_ms=combine_bound,
                frame_ms=frame_ms, frame_bound_ms=frame_bound,
                combine_share=share, peak_mib=peak,
                stack_mib=stack_bytes / 2**20, builds=builds,
                k4_before_after=turns)


def one_tap_stitch(rng):
    """Config 5d with a one-tap spread off the pixel centre, (0.25, 0):
    the kernels' operands fold 1/DERIV_BIAS in once, so that tap's ray
    is the derivative grid's own ray and deflecting in coordinate space
    (the twined chain form) and in ray space (the exact path) agree;
    through render_frame (6 launches of the twined chain form) against
    the exact path, and against the untwined stitch, from which the tap
    moved by a quarter of a pixel. Returns the record."""
    import dataclasses
    import torch
    from envutil_tpu_torch.runtime import render as RD
    facets, sources, synopsis, nch = stitch_config("config 5d", rng)
    plan = dataclasses.replace(stitch_plan(facets, synopsis, nch),
                               spread=((0.25, 0.0, 1.0),))
    name = "config 5d, one tap at (0.25, 0)"
    frame, first_ms, n = render(plan, sources, name,
                                want=voronoi_want(plan, sources))
    peak = torch.cuda.max_memory_allocated() / 2**20
    stack = torch.empty((len(sources), plan.height, plan.width, nch),
                        device="cuda")
    score = torch.empty(stack.shape[:3], device="cuda")
    skipped = []
    err, err_slot, n_edge, n_other = stitch_errors(plan, sources, frame,
                                                   stack, score,
                                                   skipped=skipped)
    del stack, score
    routed = champion_path(name, plan, sources, frame, first_ms, skipped[0],
                           peak)
    untwined = RD.render_frame(dataclasses.replace(plan, spread=None),
                               sources, device="cuda")
    moved = float(np.abs(frame - untwined).max())
    print(f"{name}: vs exact path, whole frame: max abs diff {err:.3e}, "
          f"slots {err_slot:.3e} (bound {PATH_BOUND:g}); {n_edge} px at a "
          f"window edge and {n_other} at a near-tied champion excluded; "
          f"the untwined frame differs by up to {moved:.3f}", flush=True)
    check(err <= PATH_BOUND and err_slot <= PATH_BOUND,
          f"{name} disagrees with the exact path")
    check(moved > 0.1, f"{name}: the tap did not move")
    return dict(launches=n, max_abs_err=err, slot_max_abs_err=err_slot,
                edge_px=n_edge, excluded_px=n_other, voronoi_route=routed,
                max_abs_diff_vs_untwined=moved,
                compact=compact_path(name, plan, sources, first_ms))


def pole_view_path(fct, src):
    """A twined stereographic view of the pole of a full-spherical source
    (``src``, an 8192x4096 equirect of ``smooth_environment``): 1920x1152,
    hfov 150, pitch 90, --twine 2, through render_frame and the twined
    chain form (the planar twined route, which deflects in coordinate
    space, where longitude is no linear function of the view near the
    pole), against the exact path on the card, within and outside
    POLE_LAT degrees of latitude. Below it is held to
    TWINED_PLANAR_BOUND; above it is reported, and flagged as the fault
    of ROADMAP Queue 3 where it exceeds that bound. The kernel against
    its plain version at this shape, and the kernel timed alone (median
    of 20). Returns the record."""
    import torch
    from envutil_tpu_torch.core import geometry as geo
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import stepper as ST
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    name = "pole view (stereographic, pitch 90, twined)"
    plan = plan_for(fct, P.STEREOGRAPHIC, 1920, 1152, 150, 3, (0, 90, 0),
                    twine=2)
    frame, _ms, n = render(plan, src, name,
                           want={"resample_twined_chain": 1})
    ray = ST.target_rays(plan.projection, plan.width, plan.height,
                         plan.extent, basis=plan.bases[0], normalize=True,
                         device="cuda")
    lat = geo.ray_to_ll(*ray)[1].abs()
    near = lat >= math.radians(POLE_LAT)
    above_k, below_k = (f"{w} {POLE_LAT} deg of latitude"
                        for w in ("above", "below"))
    errs = frame_errors(plan, src, frame, {above_k: near, below_k: ~near})
    above, below = errs[above_k][0], errs[below_k][0]
    fault = above > TWINED_PLANAR_BOUND
    print(f"{name} ({len(plan.spread)} taps) vs exact path, whole frame: "
          f"{errors_text(errs)} (bound {TWINED_PLANAR_BOUND:g} below "
          f"{POLE_LAT} deg"
          + (f"; above {POLE_LAT} deg it is exceeded: the fault of ROADMAP "
             f"Queue 3" if fault else ", held above as well") + ")",
          flush=True)
    check(below <= TWINED_PLANAR_BOUND, f"{name} disagrees with the exact "
          f"path below {POLE_LAT} degrees of latitude")
    check(bool(near.any()) and bool((~near).any()),
          f"{name} does not hold both regions")
    err, n_edge, _n_flip = chain_vs_plain(plan, src)[:3]
    check(err <= KERNEL_BOUND, f"twined chain kernel disagrees at {name}")
    ops = FP.chain_operands(plan, src)
    ctens = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats", "spread")]
    buf = torch.empty((plan.height, plan.width, 3), device="cuda")
    R.resample_twined_chain(buf, src.spl.coeff, *ctens, **ops)
    kernel_ms = events_ms(lambda: R.resample_twined_chain(
        buf, src.spl.coeff, *ctens, **ops), 20)
    print(f"{name}: twined chain vs plain at full shape {err:.3e} (bound "
          f"{KERNEL_BOUND:g}); kernel alone (median of 20) {kernel_ms:.4f} "
          f"ms; clocks/power/temp after: {smi_now()}", flush=True)
    return dict(launches=n["resample_twined_chain"], taps=len(plan.spread),
                vs_exact={k: v[0] for k, v in errs.items()},
                region_px={k: v[1] for k, v in errs.items()},
                fault_above=fault, max_abs_err=err, ms=kernel_ms)


def exact_route_path(rng):
    """A job of a degree above the kernels' range: config 3's view at a
    reduced size (a biatan6 noise source of 256-px faces, fov 100, at
    degree 9 -> 480x288 stereographic, hfov 150, yaw 35, pitch 20)
    through render_frame on the card, which takes the exact-path route
    (``fastpath.exact_frame``, counted once, no kernel launched), held
    against the CPU's exact path on the same table; the route's frame
    timed (median of 3). Returns its record."""
    import dataclasses
    import torch
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime import render as RD
    fct = make_facet(P.BIATAN6, 256, 1536, math.radians(100))
    faces = rng.uniform(0, 1, (6, 256, 256, 3)).astype(np.float32)
    src = CBM.make_cubemap_source(fct, faces, 9, 9, 32, 64, device="cuda")
    plan = plan_for(fct, P.STEREOGRAPHIC, 480, 288, 150, 9, (35, 20, 0))
    frame, first_ms, n = render(plan, src, "degree-9 job",
                                want={"exact_frame": 1})
    cpu = dataclasses.replace(src, spl=dataclasses.replace(
        src.spl, coeff=src.spl.coeff.cpu()))
    want = RD.render_frame(plan, [cpu], device="cpu")
    err = float(np.abs(frame - want).max())
    ms = events_ms(lambda: FP.exact_frame(plan, [src]), 3)
    print(f"degree-9 job (biatan6 256-px faces -> 480x288 stereographic) "
          f"through the exact-path route on the card: launches {n}; vs the "
          f"CPU's exact path: max abs diff {err:.3e} (bound "
          f"{EXACT_BOUND:g}); frame {ms:.3f} ms (median of 3), first "
          f"render_frame {first_ms:.1f} ms", flush=True)
    check(err <= EXACT_BOUND, "the exact-path route on the card disagrees "
          "with the CPU's exact path")
    return dict(degree=9, launches=n["exact_frame"], max_abs_err_vs_cpu=err,
                frame_ms=ms, first_ms=first_ms)


# the target geometry a --single job takes from its facet (runtime/args.py)
SINGLE_FIELDS = ("projection", "hfov", "yaw", "pitch", "roll", "width",
                 "height", "window_width", "window_height", "window_x_offset",
                 "window_y_offset", "extent", "step", "tr_x", "tr_y", "tr_z",
                 "tp_y", "tp_p", "tp_r", "shear_g", "shear_t", "s", "a", "b",
                 "c", "h", "v", "r_max", "cap_radius", "has_shift", "has_lcp",
                 "has_shear", "has_2d_tf", "has_translation")


def single_path(rng):
    """``--single 0`` on config 5b: facet 0 (1536x1152, hfov 72, the lens)
    re-created at its own geometry from all six facets, facet 0 at
    brighten 2 so that the amplify of 1/2 runs. Every facet takes a
    generic chain through the inverse lens LUT, so each renders by the
    PyTorch coordinate pass (``fastpath.coords``) and one launch of the
    planar kernel's planes form (6 a frame, counted); the frame against
    the exact path (window-edge and near-tie pixels excluded and
    counted), each facet's kernel against its plain version on its own
    operands (``planes_at_path``), CUDA-event timings of the frame
    (``multi_frame``, median of 10), of each facet's coordinate pass
    (median of 10) and kernel (median of 20), the kernels' bounds, and
    the first frame's peak device memory. Returns the record."""
    import dataclasses
    import torch
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime.render import build_plan
    name = "single (--single 0 of config 5b)"
    facets, sources, synopsis, nch = stitch_config("config 5b", rng)
    facets[0].brighten = 2.0
    sources[0] = dataclasses.replace(sources[0], static=dataclasses.replace(
        sources[0].static, brighten=2.0))
    f0 = facets[0]
    a = make_args(f0, P.RECTILINEAR, f0.width, f0.height, 72, 3)
    for field in SINGLE_FIELDS:
        setattr(a, field, getattr(f0, field))
    a.facets, a.solo, a.synopsis, a.single = facets, -1, synopsis, 0
    plan = build_plan(a, facets)
    check(all(p is not None for p in plan.planar_to_ray),
          f"{name}: a facet without a generic chain")
    n_f = len(sources)
    # the voronoi route: a planes launch for each facet that champions
    # some pixel of facet 0's view (the planes counted on a copy of the
    # plan, so that the render builds its own)
    owners = sum(lst.numel() > 0 for lst in FP._build_champions(
        dataclasses.replace(plan), sources).lists)
    frame, first_ms, n = render(plan, sources, name,
                                want={"resample_planar": owners,
                                      "champion_lists": 1}, amplify=0.5)
    peak = torch.cuda.max_memory_allocated() / 2**20
    stack = torch.empty((n_f, plan.height, plan.width, nch), device="cuda")
    score = torch.empty((n_f, plan.height, plan.width), device="cuda")
    err, err_slot, n_edge, n_other = stitch_errors(plan, sources, frame,
                                                   stack, score, amplify=0.5)
    covered = float((frame != 0).any(axis=-1).mean())
    print(f"{name}: {n_f}-facet voronoi into facet 0's 1536x1152 lens "
          f"geometry, {100 * covered:.2f}% not 0; vs exact path, whole "
          f"frame: max abs diff {err:.3e}, slots {err_slot:.3e} (bound "
          f"{PATH_BOUND:g}); {n_edge} px at a window edge and {n_other} at "
          f"a near-tied champion excluded", flush=True)
    check(err <= PATH_BOUND and err_slot <= PATH_BOUND,
          f"{name} disagrees with the exact path")
    check(n_edge + n_other <= 1e-3 * plan.height * plan.width,
          f"{name}: too many pixels excluded")
    check(covered > 0.9, f"{name}: facet 0's view is not covered")
    del frame, stack, score
    window = FP.frame_window(plan)
    kernels, coords_ms = [], []
    for fi, (fplan, src) in enumerate(zip(FP.facet_plans(plan), sources)):
        kernels.append(planes_at_path(fplan, src, f"{name}, facet {fi}"))
        FP.coords(fplan, window, src)
        coords_ms.append(events_ms(lambda fp=fplan, sr=src: FP.coords(
            fp, window, sr), 10))
    fl, fs = ab_turns(lambda: FP.voronoi_frame(plan, sources),
                      lambda: FP.multi_frame(plan, sources), single=10,
                      bursts=3, burst=5)
    frame_ms = fl["ms"]
    print(f"{name}: frame (voronoi_frame: {owners} coordinate passes and "
          f"planes launches, the champion planes as merge masks) "
          f"{frame_ms:.4f} ms, bursts {fl['burst_ms']:.4f} ms, in turns with "
          f"the stack route (multi_frame, 6 of each, stacks allocated per "
          f"frame) {fs['ms']:.4f} ms, bursts {fs['burst_ms']:.4f} ms; "
          f"coordinate pass with the inverse lens LUT per facet "
          + ", ".join(f"{t:.4f}" for t in coords_ms) + " ms; kernel alone "
          + ", ".join(f"{k['ms']:.4f}" for k in kernels) + " ms (bounds "
          + ", ".join(f"{k['bound_ms']:.4f} {k['bound_by']}"
                      for k in kernels) + "); peak device memory of the "
          f"first frame {peak:.1f} MiB; clocks/power/temp after: "
          f"{smi_now()}", flush=True)
    return dict(launches=n["resample_planar"], first_ms=first_ms,
                max_abs_err=err, slot_max_abs_err=err_slot, edge_px=n_edge,
                excluded_px=n_other, covered=covered, frame_ms=frame_ms,
                frame_burst_ms=fl["burst_ms"], stack_frame_ms=fs["ms"],
                stack_frame_burst_ms=fs["burst_ms"],
                coords_ms=coords_ms, kernels=kernels, peak_mib=peak)


def window_edges(plan, sources, chunk=128):
    """(H, W) pixels of an untwined stitch whose planar coordinate in some
    facet lies within WINDOW_EDGE of its window's edge (or, rectilinear,
    whose ray grazes the facet's plane), from the exact path's rays."""
    import torch
    from envutil_tpu_torch.models import stepper as ST
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    h, w = plan.height, plan.width
    edge = torch.zeros((h, w), dtype=torch.bool, device="cuda")
    for r0 in range(0, h, chunk):
        r1 = min(r0 + chunk, h)
        for src, b, p2r in zip(sources, plan.bases, plan.planar_to_ray):
            ray = ST.target_rays(plan.projection, plan.width, plan.height,
                                 plan.extent, basis=b, planar_to_ray=p2r,
                                 normalize=True, window=(r0, r1, 0, w),
                                 device="cuda")
            pick = FP._pickup(src)
            px, py, _hit = R.mount_planar(pick, *ray)
            x0, x1, y0, y1 = pick.window
            for v, e in ((px, x0), (px, x1), (py, y0), (py, y1)):
                edge[r0:r1] |= (v - e).abs() <= WINDOW_EDGE
            if pick.projection == 2:       # rectilinear: z > 0
                edge[r0:r1] |= ray[2].abs() <= WINDOW_EDGE
    return edge


def mask_for_path(rng):
    """``--mask_for 1 --nchannels 1`` on config 5's three 2048x1536
    facets -> 4096x2048 equirect: paint sources (no table), so
    render_frame takes ``fastpath.exact_frame`` (one launch, counted) and
    no kernel. The mask is held to the champion of config 5's untwined
    stitch as the kernels score it (the planar chain form's score planes
    of the same facets, on their noise tables): 1 exactly where facet 1
    wins, 0 elsewhere, pixels at a near-tied champion or a window edge
    excluded and counted. The exact route's frame timed (median of 3).
    Returns the record."""
    import dataclasses
    import torch
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.runtime import fastpath as FP
    name = "mask_for (--mask_for 1 --nchannels 1, config 5)"
    facets, sources, synopsis, nch = stitch_config("config 5", rng)
    plan3 = stitch_plan(facets, synopsis, nch)
    n_f, h, w = len(sources), plan3.height, plan3.width
    slot = torch.empty((h, w, nch), device="cuda")
    score = torch.empty((n_f, h, w), device="cuda")
    for fi, (fplan, src) in enumerate(zip(FP.facet_plans(plan3), sources)):
        FP.facet_into(fplan, src, slot, score[fi])
    top2 = torch.topk(score, 2, dim=0)
    champ, best, second = top2.indices[0], top2.values[0], top2.values[1]
    want = ((best > SYN.LOWEST) & (champ == 1)).to(torch.float32)
    tie = (second > SYN.LOWEST) & ((best - second).abs()
                                   <= FLIP_REL * best.abs())
    edge = window_edges(plan3, sources)
    del slot, score, sources
    torch.cuda.empty_cache()
    masked = [dataclasses.replace(f, masked=1 if i == 1 else 0)
              for i, f in enumerate(facets)]
    paints = [E.make_paint_source(f) for f in masked]
    plan = stitch_plan(masked, synopsis, 1)
    frame, first_ms, n = render(plan, paints, name, want={"exact_frame": 1})
    got = torch.from_numpy(frame[..., 0]).cuda()
    wrong = (got != want) & ~(tie | edge)
    n_tie, n_edge = int((tie & ~edge).sum()), int(edge.sum())
    share = float(want.mean())
    ms = events_ms(lambda: FP.exact_frame(plan, paints, "cuda"), 3)
    print(f"{name}: the mask vs the kernels' champion of config 5: "
          f"{int(wrong.sum())} px differ; {n_edge} px at a window edge and "
          f"{n_tie} at a near-tied champion excluded; facet 1 wins "
          f"{100 * share:.2f}% of the equirect; exact route's frame "
          f"{ms:.3f} ms (median of 3), first render_frame {first_ms:.1f} ms; "
          f"clocks/power/temp after: {smi_now()}", flush=True)
    check(int(wrong.sum()) == 0, f"{name}: the mask misses the champion")
    check(set(np.unique(frame).tolist()) <= {0.0, 1.0},
          f"{name}: the mask is not 0/1")
    check(n_edge + n_tie <= 1e-3 * h * w, f"{name}: too many pixels excluded")
    check(0.0 < share < 0.5, f"{name}: facet 1 wins {share:.3f}")
    return dict(launches=n["exact_frame"], kernel_launches=sum(
        v for k, v in n.items() if k != "exact_frame"), frame_ms=ms,
        first_ms=first_ms, wrong_px=int(wrong.sum()), edge_px=n_edge,
        tie_px=n_tie, facet_1_share=share)


def precise_path(rng):
    """Config 5d's six facets (config 5b's without the lens) -> a 512x256
    equirect (0.70-degree pixels) at ``--twine 2 --twine_precise``:
    render_frame takes ``fastpath.exact_frame`` (one launch, no twined
    kernel), where the port launched the twined chain form before. That
    route (``multi_frame``: per tap one one-tap twined chain launch a
    facet, 24 a frame) is launched directly on the same view and held
    against the exact frame: its deviation, the fault this route moved
    away from, whole frame and with window-edge and near-tie pixels
    excluded; both routes timed (median of 5). Returns the record."""
    import torch
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime.render import build_plan
    name = "precise (config 5d -> 512x256, --twine 2 --twine_precise)"
    facets, sources, synopsis, nch = stitch_config("config 5d", rng)
    a = make_args(facets[0], P.SPHERICAL, 512, 256, 360, 3, twine=2)
    a.facets, a.solo, a.synopsis, a.twine_precise = facets, -1, synopsis, True
    plan = build_plan(a, facets)
    check(plan.twine_precise and len(plan.spread) == 4,
          f"{name}: not a precise 4-tap plan")
    frame, first_ms, n = render(plan, sources, name, want={"exact_frame": 1})
    R.resample_twined_chain.launches = 0
    old = FP.multi_frame(plan, sources)
    old_n = R.resample_twined_chain.launches
    old = old.cpu().numpy()
    raw = float(np.abs(old - frame).max())
    stack = torch.empty((len(sources), plan.height, plan.width, nch),
                        device="cuda")
    score = torch.empty(stack.shape[:3], device="cuda")
    err, _slot, n_edge, n_other = stitch_errors(plan, sources, old, stack,
                                                score)
    exact_ms = events_ms(lambda: FP.exact_frame(plan, sources), 5)
    old_ms = events_ms(lambda: FP.multi_frame(plan, sources), 5)
    print(f"{name}: render_frame launches {n}; the twined chain route "
          f"({old_n} one-tap launches) vs the exact frame: max abs diff "
          f"{raw:.3e} over the whole frame, {err:.3e} with {n_edge} "
          f"window-edge and {n_other} near-tie px excluded (the card's path "
          f"bound {PATH_BOUND:g}); exact route {exact_ms:.3f} ms, the twined "
          f"chain route {old_ms:.3f} ms (medians of 5); clocks/power/temp "
          f"after: {smi_now()}", flush=True)
    check(old_n == len(sources) * len(plan.spread),
          f"{name}: the twined chain route launched {old_n} times")
    return dict(launches=n["exact_frame"], kernel_launches=sum(
        v for k, v in n.items() if k != "exact_frame"), first_ms=first_ms,
        old_route_launches=old_n, old_route_max_abs_diff=raw,
        old_route_max_abs_diff_excluded=err, edge_px=n_edge,
        excluded_px=n_other, exact_ms=exact_ms, old_route_ms=old_ms)


# ------------------------------------------------ image I/O and serving

# config 2 (benchmarks.py's main path): the source, the CLI's cubemap face
# width, the serve and visor views, the refined (twined) view and the rows
# of render_to_store's strips
SURF_SOURCE = (8192, 4096)
SURF_CUBE = 2048
SURF_VIEW = (1920, 1080)
SURF_REFINE = (960, 540)
SURF_STRIP = 512


class MemoryExr:
    """A stand-in for the EXR shim's C ABI (``imgio._LIB``), so that the
    script runs where OpenEXR's headers and libraries are missing (there
    ``io/native/envio.cc`` cannot be built) and ``imageio`` too (there no
    image file can be read or written). ``envio_write_exr`` keeps each
    file's pixels and attributes in ``files``, as the shim would write
    them after ``save_image``'s colour conversion; the header and
    attribute probes answer from them, so ``parse_args`` gleans a facet's
    size, Projection and Hfov as from a file; a pixel read raises: the
    phases take their source from the asset cache, and EXR pixels are
    read and written by the CPU tests (tests/test_torch_exr.py)."""

    def __init__(self):
        self.files = {}

    def envio_write_exr(self, path, data, w, h, c, snames, svals, ns,
                        fnames, fvals, nf):
        px = np.ctypeslib.as_array(data, shape=(h * w * c,))
        attrs = {snames[i].decode(): svals[i].decode() for i in range(ns)}
        attrs.update({fnames[i].decode(): float(fvals[i])
                      for i in range(nf)})
        self.files[path.decode()] = (px.reshape(h, w, c).copy(), attrs)
        return 0

    def envio_read_exr_header(self, path, w, h, c):
        if path.decode() not in self.files:
            return -1
        h._obj.value, w._obj.value, c._obj.value = \
            self.files[path.decode()][0].shape
        return 0

    def _attr(self, path, name, kind):
        attrs = self.files.get(path.decode(), (None, {}))[1]
        v = attrs.get(name.decode())
        return v if isinstance(v, kind) else None

    def envio_read_exr_string_attr(self, path, name, out):
        v = self._attr(path, name, str)
        if v is None:
            return -1
        out._obj.value = v.encode()
        return 0

    def envio_read_exr_float_attr(self, path, name, out):
        v = self._attr(path, name, float)
        if v is None:
            return -1
        out._obj.value = v
        return 0

    def envio_read_exr(self, path, *_):
        raise RuntimeError(f"chip_smoke: {path.decode()}: no EXR pixel "
                           "read on the card; sources come from the asset "
                           "cache")


class WallTimes:
    """Within a ``with`` block, each (module, name) of ``targets`` is
    wrapped so that its calls add their wall seconds to ``self.s[name]``
    (``functools.wraps`` keeps attributes such as ``render_frame.last_ms``
    readable)."""

    def __init__(self, *targets):
        self.targets = targets
        self.s = {name: 0.0 for _m, name in targets}

    def _wrap(self, fn, name):
        import functools

        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[name] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
        for m, n, fn in self.saved:
            setattr(m, n, self._wrap(fn, n))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def wait_for(cond, what, timeout=30.0):
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"timed out: {what}")
        time.sleep(0.01)


def surface_launches(rec, wrapper):
    """``wrapper``'s launches in each phase of ``surface_phases``' record."""
    return {"cli_exr": sum(s["launches"].get(wrapper, 0)
                           for s in rec["cli_exr"]["splits"]),
            "stream": rec["stream"]["launches"].get(wrapper, 0),
            "serve": sum(r["launches"].get(wrapper, 0) for r in rec["serve"]),
            "visor": rec["visor"]["launches"].get(wrapper, 0),
            "render_to_store": rec["render_to_store"]["launches"].get(
                wrapper, 0)}


def surface_phases():
    """The image I/O and serving surfaces on config 2's source (an
    8192x4096 RGB ramp equirect, degree 3), each through the entry point
    a user calls, on the card, with the EXR stand-in ``MemoryExr`` and the
    source's table built on the card by the loader's own ``_build`` into
    the asset cache under ``load_source``'s key, as a first request
    builds it:

    - cli_exr: ``cli.main`` on the main path (-> 2048x12288 cubemap) and
      the same job written in ACEScg; the frames equal ``render_frame``
      of the same plan (and ``colour.convert`` of it) bit for bit; the
      job's wall time split into parse (the header probe included),
      source (the cache hit), render and save;
    - stream: two argument lines through '-' (the cubemap and a
      1920x1080 view);
    - serve: ``serve.render_loop`` in a thread on a socket in a
      temporary directory, six requests and one after the bad sixth,
      each frame equal to ``to_screen(render_frame(...))``, with its
      launches, cache hits and times;
    - visor: ``VisorServer`` with ``visor.card_render_fn`` over shared
      memory, four serve views (three rendered ahead of a consumer that
      reads none: the full queue), a bad job, one more frame;
    - render_to_store: the cubemap in 512-row strips into a TileStore,
      bit-equal to the whole frame.

    Returns the record."""
    import io
    import os
    import shutil
    import socket
    import struct
    import tempfile
    import threading

    import torch
    from envutil_tpu_torch.io import colour as CL
    from envutil_tpu_torch.io import imgio
    from envutil_tpu_torch.io.tiles import TileStore, render_to_store
    from envutil_tpu_torch.runtime import assets, cli, loader, serve, visor
    from envutil_tpu_torch.runtime import render as RD
    from envutil_tpu_torch.runtime.args import parse_args

    exr = MemoryExr()
    imgio._LIB = exr
    tmp = tempfile.mkdtemp(prefix="eu")
    w, h = SURF_SOURCE
    fw = SURF_CUBE
    vw, vh = SURF_VIEW
    img = ramp_fixture(w, h)
    imgio.save_image("env.exr", img, projection_name="spherical",
                     hfov_deg=360.0)
    base = ["--input", "env.exr", "--degree", "3"]
    cube = base + ["--twine", "0", "--projection", "cubemap", "--width",
                   str(fw), "--output", "cm.exr"]
    rec = {}

    def job(argv):
        """(plan, sources) of an argument list; the sources are found in
        the asset cache."""
        a = parse_args(argv)
        a.twine_setup()
        plan = RD.build_plan(a, a.facets)
        return plan, [loader.load_source(a.facets[i], a, "cuda")
                      for i in plan.facet_indices]

    # the table, built on the card and cached as a first request does
    args = parse_args(cube)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src = loader._build(args.facets[0], args, img, "cuda")
    torch.cuda.synchronize()
    rec["source_build_ms"] = (time.perf_counter() - t0) * 1000.0
    assets.cache.add(loader.cache_keys(args.facets[0], args, "cuda")[1],
                     src.spl)
    del img, src
    # the header probe reads the shape: keep it without the pixels
    exr.files["env.exr"] = (np.broadcast_to(np.float32(0), (h, w, 3)),
                            exr.files["env.exr"][1])

    # ---- cli_exr ----
    plan, srcs = job(cube)
    ref = RD.render_frame(plan, srcs, device="cuda")
    splits = []
    for argv, name in ((cube, "cm.exr"),
                       (cube[:-1] + ["cm_aces.exr", "--output_colour_space",
                                     "ACEScg"], "cm_aces.exr")):
        with WallTimes((cli, "parse_args"), (loader, "load_source"),
                       (cli, "render_frame"), (imgio, "save_image")) as wt:
            t0 = time.perf_counter()
            rc, n = launch_counts(lambda: cli.main(list(argv)))
            job_s = time.perf_counter() - t0
        split = dict(job_ms=job_s * 1000.0, **{
            k: v * 1000.0 for k, v in wt.s.items()})
        split["other_ms"] = split["job_ms"] - sum(
            v for k, v in split.items() if k != "job_ms")
        splits.append(dict(split, launches=n))
        px, attrs = exr.files[name]
        print(f"cli_exr {name}: rc {rc}, launches {n}; wall clock "
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
              + f" ms; attributes {attrs}", flush=True)
        check(rc == 0 and n == {"resample_inline": 1},
              f"cli_exr {name}: rc {rc}, launches {n}")
        check(attrs["Projection"] == "cubemap" and attrs["Hfov"] == 90.0,
              f"cli_exr {name}: attributes {attrs}")
        want = ref if name == "cm.exr" else \
            CL.convert(ref, "scene_linear", "ACEScg")
        check(px.shape == want.shape and np.array_equal(px, want),
              f"cli_exr {name}: the frame differs from render_frame's "
              f"(max abs {float(np.abs(px - want).max()):.3e})")
    rec["cli_exr"] = dict(splits=splits, image_read="none on the card "
                          "(no OpenEXR): the table comes from the cache")

    # ---- stream ----
    lines = (f"--projection cubemap --width {fw} --output st_cm.exr\n"
             f"--width {vw} --height {vh} --hfov 65 --yaw 30 "
             f"--output st_view.exr\n")
    stdin = sys.stdin
    sys.stdin = io.StringIO(lines)
    try:
        t0 = time.perf_counter()
        rc, n = launch_counts(lambda: cli.main(base + ["--twine", "0", "-"]))
        stream_ms = (time.perf_counter() - t0) * 1000.0
    finally:
        sys.stdin = stdin
    vplan, vsrcs = job(base + ["--twine", "0", "--width", str(vw),
                               "--height", str(vh), "--hfov", "65",
                               "--yaw", "30", "--output", "x.exr"])
    view = RD.render_frame(vplan, vsrcs, device="cuda")
    print(f"stream: rc {rc}, 2 lines in {stream_ms:.1f} ms, launches {n}",
          flush=True)
    check(rc == 0 and n == {"resample_inline": 2}, f"stream: launches {n}")
    for name, want in (("st_cm.exr", ref), ("st_view.exr", view)):
        check(np.array_equal(exr.files[name][0], want),
              f"stream: {name} differs from render_frame's")
    rec["stream"] = dict(ms=stream_ms, launches=n)

    # ---- serve ----
    cache_log = {"found": 0, "missed": 0, "built": 0}
    find, build = assets.cache.find, loader._build

    def counted_find(key):
        hit = find(key)
        cache_log["found" if hit is not None else "missed"] += 1
        return hit

    def counted_build(*a, **kw):
        cache_log["built"] += 1
        return build(*a, **kw)
    assets.cache.find, loader._build = counted_find, counted_build

    view_spec = dict(args=base, width=vw, height=vh, hfov=65.0)
    specs = [dict(view_spec, yaw=0.0), dict(view_spec, yaw=90.0),
             dict(view_spec, yaw=180.0), dict(view_spec, pitch=80.0),
             dict(view_spec, refine=True, width=SURF_REFINE[0],
                  height=SURF_REFINE[1], hfov=120.0),
             dict(view_spec, args=["--input", "missing.exr", "--degree",
                                   "3"]),
             dict(view_spec, yaw=0.0)]
    wants = [{"resample_inline": 1}] * 4 + [{"resample_inline_twined": 1},
                                            {}, {"resample_inline": 1}]
    sock_path = os.path.join(tmp, "s")
    server = threading.Thread(target=serve.render_loop,
                              args=(sock_path, "cuda"), daemon=True)
    server.start()
    wait_for(lambda: os.path.exists(sock_path), "serve socket")
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(120.0)
    conn.connect(sock_path)

    def ask(spec):
        data = json.dumps(spec).encode()
        conn.sendall(struct.pack("<I", len(data)) + data)
        (size,) = struct.unpack("<I", serve.recv_exact(conn, 4))
        hdr = json.loads(serve.recv_exact(conn, size).decode())
        if "width" not in hdr or "error" in hdr:
            return hdr, None
        payload = serve.recv_exact(conn, hdr["width"] * hdr["height"] * 4)
        return hdr, np.frombuffer(payload, np.uint32).reshape(
            hdr["height"], hdr["width"])

    serve_rec, frames = [], []
    try:
        for i, (spec, want) in enumerate(zip(specs, wants), 1):
            for k in cache_log:
                cache_log[k] = 0
            t0 = time.perf_counter()
            (hdr, frame), n = launch_counts(
                lambda: ask(dict(spec, serial_no=i)))
            rtt_ms = (time.perf_counter() - t0) * 1000.0
            cache = dict(cache_log)
            entry = dict(request=i, launches=n, round_trip_ms=rtt_ms,
                         cache=cache)
            if frame is None:
                entry["error"] = hdr.get("error")
                check(i == 6 and "error" in hdr,
                      f"serve request {i}: {hdr}")
            else:
                plan_i, srcs_i = job(serve.job_argv(spec))
                img_i = RD.render_frame(plan_i, srcs_i, device="cuda")
                t0 = time.perf_counter()
                screen = serve.to_screen(img_i)
                entry.update(t_render_ms=hdr["t_render"],
                             to_screen_ms=(time.perf_counter() - t0) * 1e3,
                             taps=len(plan_i.spread or ((0, 0, 1),)))
                if plan_i.spread is not None:
                    entry["increment_share"] = inline_twined_bound(
                        plan_i, srcs_i[0])[7]
                check(hdr["serial_no"] == i and np.array_equal(frame, screen),
                      f"serve request {i}: the frame differs from "
                      "to_screen(render_frame(...))")
                check(cache == {"found": 1, "missed": 0, "built": 0},
                      f"serve request {i}: cache {cache}")
            frames.append(frame)
            print(f"serve request {i} ({json.dumps(spec)}): "
                  f"{json.dumps(entry)}", flush=True)
            check(n == want, f"serve request {i}: launches {n}, want {want}")
            serve_rec.append(entry)
        check(np.array_equal(frames[6], frames[0]),
              "serve: the request after the bad job differs from request 1")
        check(ask({"serial_no": 0})[0] == {"serial_no": 0},
              "serve: no shutdown answer")
    finally:
        conn.close()
    server.join(timeout=30)
    check(not server.is_alive(), "serve: the loop did not end")
    rec["serve"] = serve_rec

    # ---- visor ----
    rendered = []

    def render_fn(spec):
        rendered.append(spec["serial_no"])
        return visor.card_render_fn(spec, "cuda")
    vsock = os.path.join(tmp, "v")
    srv = visor.VisorServer(render_fn, vsock, width=vw, height=vh,
                            shm_prefix=f"eutorch_smoke_{os.getpid()}")
    vthread = threading.Thread(target=srv.serve_forever, daemon=True)
    vthread.start()
    wait_for(lambda: os.path.exists(vsock), "visor socket")
    client = visor.VisorClient(vsock, timeout=120.0)
    try:
        def visor_frames():
            for spec in specs[:4]:
                client.submit(spec)
            wait_for(lambda: len(rendered) >= visor.FRAME_QUEUE_DEPTH,
                     "visor: frames rendered ahead", 120.0)
            time.sleep(0.5)
            ahead = len(rendered)
            got = [client.next_frame() for _ in specs[:4]]
            return ahead, got
        (ahead, got), n = launch_counts(visor_frames)
        print(f"visor: {ahead} of 4 frames rendered before the client read "
              f"one (queue depth {visor.FRAME_QUEUE_DEPTH}); launches {n}; "
              + "; ".join(visor.print_timing(hdr) for hdr, _px in got),
              flush=True)
        check(ahead == visor.FRAME_QUEUE_DEPTH, f"visor: {ahead} ahead")
        check(n == {"resample_inline": 4}, f"visor: launches {n}")
        for i, (hdr, px) in enumerate(got):
            check(np.array_equal(px, frames[i]),
                  f"visor: frame {i + 1} differs from the serve frame")
        client.submit(specs[5])
        try:
            client.next_frame()
            check(False, "visor: the bad job was not refused")
        except RuntimeError as e:
            bad = str(e)
        client.submit(specs[1])
        hdr, px = client.next_frame()
        check(np.array_equal(px, frames[1]),
              "visor: the frame after the bad job differs")
        print(f"visor: bad job answered ({bad}); the next frame served",
              flush=True)
        client.shutdown()
    finally:
        client.close()
    vthread.join(timeout=30)
    check(not vthread.is_alive(), "visor: the server did not end")
    rec["visor"] = dict(ahead=ahead, launches=n, timing=[
        {k: v for k, v in hdr.items() if k.startswith("t_")}
        for hdr, _px in got])
    assets.cache.find, loader._build = find, build

    # ---- render_to_store ----
    store_dir = os.path.join(tmp, "rts")
    store = TileStore(store_dir, "w", shape=ref.shape,
                      tile_shape=(SURF_STRIP, fw), max_resident=4)
    t0 = time.perf_counter()
    _, n = launch_counts(lambda: render_to_store(
        plan, srcs, store, strip_rows=SURF_STRIP, device="cuda"))
    store.close()
    rts_ms = (time.perf_counter() - t0) * 1000.0
    back = TileStore(store_dir, "r").read_window(0, ref.shape[0], 0, fw)
    n_strips = -(-ref.shape[0] // SURF_STRIP)
    diff = float(np.abs(back - ref).max())
    print(f"render_to_store: {n_strips} strips of {SURF_STRIP} rows in "
          f"{rts_ms:.1f} ms (tile files written and flushed), launches {n};"
          f" vs the whole frame max abs diff {diff:.3e} (bit-equal "
          f"required)", flush=True)
    check(n == {"resample_inline": n_strips},
          f"render_to_store: launches {n}")
    check(np.array_equal(back, ref), "render_to_store differs from the "
          "whole frame")
    rec["render_to_store"] = dict(strips=n_strips, ms=rts_ms, launches=n,
                                  max_abs_diff=diff)

    shutil.rmtree(tmp)
    imgio._LIB = None
    assets.cache.clear()
    return rec


MESH_N = 4
# --shard_table frame vs the exact path on the same card and tables,
# rtol = atol: the JAX package's own bound for its ring
# (tests/test_parallel.py; MULTICHIP_r05.json read 2.4e-7 and 1.8e-7).
# The ring sums the same taps in the same order as eval_spline, each an
# eager PyTorch operation on the card in both
RING_BOUND = 4e-7


def host_ms(fn, reps=3):
    """Median host-clock milliseconds of ``fn`` (a call of
    ``render_frame``, which ends in the frame's copy to the host) over
    ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(times))


def mesh_frames(name, plan, sources, want, devices):
    """One job through ``render_frame(mesh_n=MESH_N, devices=devices)``
    (the --mesh path) beside the same job on one device: the mesh
    frame's launches (counts set to 0 just before, read just after;
    ``want`` maps counters to launches), the frame bit-equal to the
    one-device frame, the kernel operands built by its second and third
    frames (0 required), the frame times (host clock, the copy to the
    host included, median of 3) and the peak device memory of each.
    Returns the record."""
    import torch
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime import render as RD

    def one():
        return RD.render_frame(plan, sources, device="cuda")

    def meshed():
        return RD.render_frame(plan, sources, device="cuda", mesh_n=MESH_N,
                               devices=devices)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    single = one()
    single_peak = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame, moved = launch_counts(meshed)
    first_ms = (time.perf_counter() - t0) * 1000.0
    mesh_peak = torch.cuda.max_memory_allocated() / 2**20
    expect = dict.fromkeys(COUNTERS, 0)
    n = dict(expect, **moved)
    expect.update(want)
    check(n == expect, f"mesh {name}: launches {n}, expected {expect}")
    check(bool(np.isfinite(frame).all()), f"mesh {name}: frame not finite")
    check(np.array_equal(frame, single), f"mesh {name}: the --mesh "
          f"{MESH_N} frame differs from the one-device frame (max abs diff "
          f"{float(np.abs(frame - single).max()):.3e})")
    builds, lists = [], []
    for _ in range(2):
        before = FP._operands.builds
        listed = FP.block_list.builds
        champions = FP.champion_planes.builds
        again = meshed()
        builds.append(FP._operands.builds - before)
        lists.append(FP.block_list.builds - listed
                     + FP.champion_planes.builds - champions)
        check(np.array_equal(again, single),
              f"mesh {name}: a later --mesh frame differs")
    check(builds == [0, 0] and lists == [0, 0], f"mesh {name}: steady-state "
          f"frames built {builds} operand sets and {lists} block lists and "
          f"champion planes")
    compact = bool(n.get("chain_blocks"))
    if compact:
        # the compact grid: the same frames with every chain launch over
        # its band's whole window
        with full_window():
            check(np.array_equal(meshed(), frame) and np.array_equal(
                one(), single), f"mesh {name}: the frames on the block "
                f"lists differ from the full-window frames")
    rec = dict(launches={k: v for k, v in n.items() if v},
               devices=[str(d) for d in devices[:MESH_N]],
               bit_equal=True, operand_builds_frames_2_3=builds,
               list_builds_frames_2_3=lists,
               bit_equal_to_full_window=compact or None,
               first_ms=first_ms, ms=host_ms(meshed), single_ms=host_ms(one),
               peak_mib=mesh_peak, single_peak_mib=single_peak,
               split=mesh_split(plan, sources, devices),
               single_split=mesh_split(plan, sources, devices[:1]))
    print(f"mesh: {name}, --mesh {MESH_N} on {rec['devices']}: launches "
          f"{rec['launches']}; bit-equal to the one-device frame"
          + ("" if not compact else " and, both, to their full-window "
             "frames") + f"; operand and block-list builds of frames 2 and "
          f"3: {builds}, {lists}; frame {rec['ms']:.3f} ms vs "
          f"one device {rec['single_ms']:.3f} ms (host clock, copy to the "
          f"host included, median of 3; first {first_ms:.1f} ms); split "
          f"(enqueue, device, copy to the host) {rec['split']} vs one device "
          f"{rec['single_split']} ms; peak device memory {mesh_peak:.1f} vs "
          f"{single_peak:.1f} MiB", flush=True)
    return rec


def mesh_split(plan, sources, devices, reps=3):
    """Where a kernel-route frame of ``plan`` over ``len(devices)`` bands
    spends its time, timed inside the band loop the --mesh path runs
    (``fastpath.render_fast_mesh``'s ``split``; one band is the
    one-device frame): host-clock ms to enqueue every band, then until
    the card has finished, then to copy the bands into the host frame;
    medians of ``reps``."""
    import torch
    from envutil_tpu_torch.parallel import mesh as PM
    from envutil_tpu_torch.runtime import fastpath as FP
    mesh = PM.make_mesh(devices)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        split = []
        FP.render_fast_mesh(plan, sources, mesh, split=split)
        times.append(split)
    return [round(float(v), 3) for v in np.median(times, axis=0)]


def ring_frames(name, plan, sources, devices):
    """The same job through ``render_frame(mesh_n=MESH_N,
    shard_table=True)``: the tables in row bands over the devices, the
    frame from the ring, held to ``fastpath.exact_frame`` on the same
    card and tables (RING_BOUND, rtol = atol); no kernel and no exact
    route launched; its time (host clock, median of 3) beside the
    replicated --mesh frame's, and its peak device memory. Returns the
    record."""
    import torch
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime import render as RD

    def ringed():
        return RD.render_frame(plan, sources, device="cuda", mesh_n=MESH_N,
                               shard_table=True, devices=devices)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame, moved = launch_counts(ringed)
    first_ms = (time.perf_counter() - t0) * 1000.0
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(not moved, f"ring {name}: launches {moved}, expected none")
    ref = FP.exact_frame(plan, sources).cpu().numpy()
    diff = np.abs(frame - ref)
    err = float(diff.max())
    check(bool((diff <= RING_BOUND + RING_BOUND * np.abs(ref)).all()),
          f"ring {name}: {err:.3e} from exact_frame (rtol = atol = "
          f"{RING_BOUND:g})")
    rec = dict(max_abs_err_vs_exact=err, bound=RING_BOUND,
               bit_equal=bool(err == 0.0), first_ms=first_ms,
               ms=host_ms(ringed), replicated_ms=host_ms(
                   lambda: RD.render_frame(plan, sources, device="cuda",
                                           mesh_n=MESH_N, devices=devices)),
               peak_mib=peak)
    print(f"mesh: {name}, --mesh {MESH_N} --shard_table: vs exact_frame max "
          f"abs diff {err:.3e} (rtol = atol = {RING_BOUND:g}); frame "
          f"{rec['ms']:.3f} ms vs replicated {rec['replicated_ms']:.3f} ms "
          f"(host clock, median of 3; first {first_ms:.1f} ms); peak device "
          f"memory {peak:.1f} MiB", flush=True)
    return rec


def mesh_phases():
    """--mesh and --shard_table through ``render_frame``, the entry point
    the CLI calls, with ``devices=[cuda:0] * MESH_N``: every band of a
    frame on this card, so that each band decomposition, each band's
    launches and the ring's hand-overs of table bands run here (a
    one-card machine cannot show cross-card overlap or peer copies).
    With two cards or more, the main path also runs over all of them.
    Cases:

    - main path (8192x4096 ramps -> 2048x12288 cubemap): 4 launches of
      resample_inline, then --shard_table, and ``mesh_n=7`` (12288 rows
      do not divide by 7: the message, one device, the same frame);
    - config 3 (biatan6 noise -> 1920x1152 stereographic): 4 launches of
      resample_planar_chain;
    - config 4 twined (the 8K ramps at degree 1 -> 2048x1280, 4 taps):
      4 launches of resample_inline_twined;
    - config 5 (voronoi of three facets -> 4096x2048, the voronoi
      route): a block list per band and facet (12 coverage passes),
      champion planes per band (6 champion launches, 4 lists) and 6
      launches of resample_planar_chain in its champion mode (the
      facets reach the middle two bands only), then --shard_table;
    - config 5d twined at 2x2 taps: 24 coverage passes, 12 champion
      launches and 4 lists, and 12 launches of resample_twined_chain in
      its tapsel mode (the middle two bands);
    - the degree-9 view: 4 bands of the exact route (``exact_frame``).

    Each --mesh frame is bit-equal to the one-device frame, a frame on
    block lists (5, 5d) to the same frame over the full windows, and its
    second and third frames build no kernel operands, no block list and
    no champion planes.
    Returns the record."""
    import contextlib
    import io
    import torch
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.runtime import render as RD

    devices = [torch.device("cuda", 0)] * MESH_N
    rec = {}
    # ---- the main path, --shard_table, the fallback, all cards ---------
    w, h = 8192, 4096
    img = ramp_fixture(w, h)
    fct = make_facet(P.SPHERICAL, w, h, 2 * math.pi)
    src = E.make_mount_source(fct, img, 3, 3, device="cuda")
    plan = plan_for(fct, P.CUBEMAP, 2048, 6 * 2048, 90, 3)
    rec["main path"] = mesh_frames("main path", plan, [src],
                                   {"resample_inline": MESH_N}, devices)
    rec["main path, --shard_table"] = ring_frames("main path", plan, [src],
                                                  devices)
    said = io.StringIO()
    single = RD.render_frame(plan, [src], device="cuda")
    with contextlib.redirect_stdout(said):
        fallback, moved = launch_counts(lambda: RD.render_frame(
            plan, [src], device="cuda", mesh_n=7, devices=[devices[0]] * 7))
    message = said.getvalue().strip()
    check(message == "--mesh 7: output height 12288 not divisible by 7; "
          "rendering on one", f"mesh fallback said {message!r}")
    check(moved == {"resample_inline": 1}, f"mesh fallback launches {moved}")
    check(np.array_equal(fallback, single),
          "the --mesh 7 fallback differs from the one-device frame")
    rec["main path, --mesh 7"] = dict(message=message, launches=moved,
                                      bit_equal=True)
    print(f"mesh: main path, --mesh 7: {message!r}; launches {moved}; "
          f"bit-equal to the one-device frame", flush=True)
    del single, fallback
    cards = torch.cuda.device_count()
    if cards >= 2:
        frame, moved = launch_counts(lambda: RD.render_frame(
            plan, [src], device="cuda", mesh_n=cards))
        check(moved == {"resample_inline": cards}
              and np.array_equal(frame, RD.render_frame(plan, [src],
                                                        device="cuda")),
              f"--mesh {cards} over the cards: launches {moved}")
        rec[f"main path over {cards} cards"] = dict(launches=moved,
                                                    bit_equal=True)
        print(f"mesh: main path over {cards} cards: launches {moved}; "
              f"bit-equal", flush=True)
    del src
    torch.cuda.empty_cache()
    src1 = E.make_mount_source(fct, img, 1, 1, device="cuda")
    del img
    plan4 = plan_for(fct, P.RECTILINEAR, 2048, 1280, 100, 1, twine=-1)
    rec["config 4 twined"] = mesh_frames(
        "config 4 twined", plan4, [src1], {"resample_inline_twined": MESH_N},
        devices)
    del src1
    torch.cuda.empty_cache()
    # ---- config 3 -------------------------------------------------------
    rng = np.random.default_rng(3)
    bfct = make_facet(P.BIATAN6, 1024, 6144, math.radians(100))
    faces = rng.uniform(0, 1, (6, 1024, 1024, 3)).astype(np.float32)
    bsrc = CBM.make_cubemap_source(bfct, faces, 3, 3, 128, 64, device="cuda")
    p3 = plan_for(bfct, P.STEREOGRAPHIC, 1920, 1152, 150, 3, (35, 20, 0))
    rec["config 3"] = mesh_frames("config 3", p3, [bsrc],
                                  {"resample_planar_chain": MESH_N}, devices)
    del bsrc
    torch.cuda.empty_cache()
    # ---- config 5 and config 5d twined ----------------------------------
    facets, sources, synopsis, nch = stitch_config(
        "config 5", np.random.default_rng(5))
    p5 = stitch_plan(facets, synopsis, nch)
    # the facets reach latitudes within 26 degrees: of the four bands of
    # 512 rows (90..45, 45..0, 0..-45, -45..-90 degrees) only the middle
    # two, so the outer bands' lists are empty and launch nothing
    rec["config 5"] = mesh_frames("config 5", p5, sources,
                                  {"resample_planar_chain": 3 * 2,
                                   "resample_planar_chain:champion": 3 * 2,
                                   "champion_planes": 3 * 2,
                                   "champion_lists": MESH_N,
                                   "chain_blocks": 3 * MESH_N}, devices)
    rec["config 5, --shard_table"] = ring_frames("config 5", p5, sources,
                                                 devices)
    del sources
    torch.cuda.empty_cache()
    facets, sources, synopsis, nch = stitch_config(
        "config 5d", np.random.default_rng(5))
    p5d = stitch_plan(facets, synopsis, nch, twine=2)
    check(len(p5d.spread) == 4, f"config 5d spread {p5d.spread}")
    # within 29 degrees of latitude: the middle two bands, as config 5
    rec["config 5d twined"] = mesh_frames(
        "config 5d twined (2x2 taps)", p5d, sources,
        {"resample_twined_chain": 6 * 2, "resample_twined_chain:tapsel": 6 * 2,
         "champion_planes": 6 * 2, "champion_lists": MESH_N,
         "chain_blocks": 6 * MESH_N}, devices)
    del sources
    torch.cuda.empty_cache()
    # ---- degree 9 on the exact route ------------------------------------
    dfct = make_facet(P.BIATAN6, 256, 1536, math.radians(100))
    dfaces = np.random.default_rng(9).uniform(
        0, 1, (6, 256, 256, 3)).astype(np.float32)
    dsrc = CBM.make_cubemap_source(dfct, dfaces, 9, 9, 32, 64, device="cuda")
    p9 = plan_for(dfct, P.STEREOGRAPHIC, 480, 288, 150, 9, (35, 20, 0))
    rec["degree 9"] = mesh_frames("degree 9 (exact route)", p9, [dsrc],
                                  {"exact_frame": MESH_N}, devices)
    del dsrc
    torch.cuda.empty_cache()
    return rec


def mesh_launches(rec, counter):
    """{case: launches of ``counter``} over the --mesh cases that launch
    it."""
    return {case: r["launches"][counter] for case, r in rec.items()
            if counter in r.get("launches", {})}


def smooth_environment(ray):
    """A smooth, seamless RGB function of the unit ray: low and medium
    frequencies with gradients of a few per radian."""
    import torch
    x, y, z = ray
    return torch.stack([0.5 + 0.3 * x + 0.2 * torch.sin(5.0 * y + 2.0 * z),
                        0.5 + 0.3 * y + 0.2 * torch.cos(4.0 * z - 3.0 * x),
                        0.5 + 0.3 * z + 0.2 * torch.sin(6.0 * x * y)], dim=-1)


def build_report():
    """Per kernel of each built source, from nvcc's -Xptxas -v log: the
    instantiations, their registers and the spills, the float32 and the
    bf16 instantiations apart; printed one line a kernel and returned as
    {kernel: {...}}."""
    from envutil_tpu_torch.ops import resample as R
    report = {}
    libs = [(lib, "") for lib in R.LIBRARIES] + \
        [(lib, " (parent)") for lib in PARENT.values()]
    for lib, suffix in libs:
        entry = None
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                name = re.search(r"([a-z_]+_kernel)[IE]", line)
                # template arguments: the ints, then the table's type
                # (f, or 13__nv_bfloat16)
                args = re.search(r"kernelI((?:Li\d+E)+)(\w+?)E", line)
                entry = report.setdefault(
                    (name.group(1) if name else line) + suffix,
                    dict(source=lib.source.name, regs=[], spills=[],
                         regs_bf16=[], stack=[0]))
                bf16 = bool(args) and "bfloat16" in args.group(2)
                targs = "<" + ", ".join(re.findall(
                    r"Li(\d+)E", args.group(1) if args else "")
                    + ["bf16" if bf16 else "f32"]) + ">"
            elif entry is not None and "Used " in line \
                    and " registers" in line:
                regs = int(line.split("Used ")[1].split(" registers")[0])
                entry["regs"].append(regs)
                if targs.endswith("bf16>"):
                    entry["regs_bf16"].append(regs)
            elif entry is not None and "bytes stack frame" in line:
                entry["stack"].append(int(
                    line.split(" bytes stack frame")[0].split()[-1]))
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if entry is not None and spill and spill.group(0) != \
                    "0 bytes spill stores, 0 bytes spill loads":
                entry["spills"].append((int(spill.group(1)), targs))
    for kernel, e in report.items():
        worst = max(e["spills"], default=(0, "-"))
        n_bf16 = sum(t.endswith("bf16>") for _b, t in e["spills"])
        print(f"build {e['source']}: {kernel}: {len(e['regs'])} "
              f"instantiations ({len(e['regs_bf16'])} bf16), registers "
              f"{min(e['regs'], default='?')}..{max(e['regs'], default='?')}"
              f" (bf16 {min(e['regs_bf16'], default='?')}.."
              f"{max(e['regs_bf16'], default='?')}), {len(e['spills'])} of "
              f"them spill ({len(e['spills']) - n_bf16} float32, {n_bf16} "
              f"bf16); most: {worst[0]} bytes of spill stores at {worst[1]}",
              flush=True)
    return {k: dict(source=e["source"], instantiations=len(e["regs"]),
                    registers=[min(e["regs"], default=None),
                               max(e["regs"], default=None)],
                    registers_bf16=[min(e["regs_bf16"], default=None),
                                    max(e["regs_bf16"], default=None)],
                    spilling=len(e["spills"]),
                    spilling_bf16=sum(t.endswith("bf16>")
                                      for _b, t in e["spills"]),
                    stack_bytes=max(e["stack"]),
                    worst_spill_bytes=max(e["spills"], default=(0, ""))[0])
            for k, e in report.items()}


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
    from envutil_tpu_torch.runtime import fastpath as FP
    from envutil_tpu_torch.runtime import render as RD

    # ---- 1. card, versions, build -------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    nvcc = subprocess.run([K.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}", flush=True)
    if len(sys.argv) > 1:
        # K4 of a parent checkout, built beside this checkout's kernels
        PARENT["k4"] = parent_k4_library(sys.argv[1])
        PARENT["k4"].start()
    build_s = R.build()
    for lib in PARENT.values():
        lib.load()
    build = build_report()
    print(f"kernel build, {len(R.LIBRARIES)} sources in parallel: "
          f"{build_s:.1f} s wall", flush=True)
    print(f"kernels: {json.dumps(list(WRAPPERS))}", flush=True)

    # ---- 2. kernels against plain versions at small shapes ------------
    worst_inline = phase_small_inline()
    worst_planar = phase_small_planar()
    worst_inline_twined = phase_small_inline_twined(build=build)
    worst_twined = phase_small_twined()
    worst_chain, chain_edge_px = phase_small_chain()
    phase_small_combine()
    # the same cases on bf16 tables
    small_bf16 = {"resample_inline": phase_small_inline("bf16"),
                  "resample_planar": phase_small_planar("bf16"),
                  "resample_inline_twined": phase_small_inline_twined("bf16"),
                  "resample_twined": phase_small_twined("bf16")}
    chain_bf16 = phase_small_chain("bf16")[0]
    small_bf16["resample_planar_chain"] = chain_bf16["planar"]
    small_bf16["resample_twined_chain"] = chain_bf16["twined"]
    # each kernel's bf16 record: its times and bound on a bf16 table at
    # full size, the error against its plain version there and the path
    t_bf16 = {}

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

    # ---- 3a. the main path on a bf16 table ----------------------------
    srcb = with_coeff(src, "bf16")
    frame_b, _ms, main_b_n = render(plan, srcb, "main path, bf16", 1, 0)
    band_b = band_errors(plan, srcb, frame_b, bands, False)[0]
    db_main = psnr(frame_b, frame)
    print(f"main path, bf16 (table {tuple(srcb.spl.coeff.shape)} "
          f"{srcb.spl.coeff.dtype}, "
          f"{srcb.spl.coeff.numel() * 2 / 1e6:.1f} MB) vs exact path on the "
          f"same table, 18 bands: max abs diff {band_b:.3e} (bound "
          f"{MAIN_BOUND:g}); vs the float32 frame {db_main:.2f} dB",
          flush=True)
    check(band_b <= MAIN_BOUND, "bf16 frame disagrees with exact path")
    check(db_main >= BF16_DB, f"bf16 main path {db_main:.2f} dB")
    del frame_b
    err_b, _e, out_k, out_p = kernel_vs_plain(plan, srcb, 3)
    del out_k, out_p
    print(f"inline vs plain at main-path shape, bf16: max abs diff "
          f"{err_b:.3e} (bound {KERNEL_BOUND:g})", flush=True)
    check(err_b <= KERNEL_BOUND, "kernel disagrees at main-path shape, bf16")
    ops = FP.frame_operands(plan, src)
    kw = inline_kw(ops, 3)
    tens = [ops[k] for k in ("xfeat", "yfeat", "bmats")]
    buf = torch.empty((plan.height, plan.width, 3), device="cuda")
    tables = {"f32": src.spl.coeff, "bf16": srcb.spl.coeff}
    turns = dtype_turns("main path (K1 staged)", lambda d: R.resample_inline(
        buf, tables[d], *tens, **kw))
    turns_direct = dtype_turns(
        "main path (K1 direct)", lambda d: R.resample_inline(
            buf, tables[d], *tens, window_bytes=0, **kw))
    t_bf16["resample_inline"] = dict(
        time_inline(plan, srcb, "main path, bf16"), max_abs_err=err_b,
        path="main path", launches=main_b_n["resample_inline"],
        vs_exact=band_b, psnr_vs_f32_db=db_main, turns=turns,
        turns_direct=turns_direct)
    del src, srcb, tables, buf
    torch.cuda.empty_cache()

    # ---- 3b. config 4 twined: 8K -> 2048x1280, automatic twine --------
    src1 = E.make_mount_source(fct, img, 1, 1, device="cuda")
    del img
    plan4 = plan_for(fct, P.RECTILINEAR, 2048, 1280, 100, 1, twine=-1)
    check(len(plan4.spread) == 4, f"config 4 spread {plan4.spread}")
    t_twined = {"config 4": twined_inline_path("config 4", plan4, src1)}
    plan4p = plan_for(fct, P.RECTILINEAR, 2048, 1280, 100, 1, (180, 80, 0),
                      twine=-1)
    t_twined["pole and seam"] = twined_inline_path(
        "pole-and-seam view (pitch 80, yaw 180)", plan4p, src1)
    for region in ("poles", "seam"):
        check(t_twined["pole and seam"]["region_px"][region] > 0,
              f"the pole-and-seam view holds no pixel of the {region}")
    del src1
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
        out3, _ms, n3 = render(p3, bsrc, name,
                               want={"resample_planar_chain": 1})
        peak = torch.cuda.max_memory_allocated() / 2**20
        planar_n[name] = n3["resample_planar_chain"]
        err3, _e = band_errors(p3, bsrc, out3, [(0, 8), (572, 580),
                                                (1144, 1152)], False)
        print(f"{name} through the chain form vs exact path, 3 bands of 8 "
              f"rows: max abs diff {err3:.3e} (bound {PATH_BOUND:g})",
              flush=True)
        check(err3 <= PATH_BOUND, f"{name} disagrees with exact path")
        t_planar[name] = time_planar(p3, bsrc, name, peak)
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
        if name == "config 3":
            # the planar chain kernel on the bf16 table
            bsrc_b = with_coeff(bsrc, "bf16")
            out3b, _ms, n3b = render(p3, bsrc_b, "config 3, bf16",
                                     want={"resample_planar_chain": 1})
            peak = torch.cuda.max_memory_allocated() / 2**20
            err3b, _e = band_errors(p3, bsrc_b, out3b, [(0, 8), (572, 580),
                                                        (1144, 1152)], False)
            print(f"config 3, bf16 through the chain form vs exact path on "
                  f"the same table, 3 bands of 8 rows: max abs diff "
                  f"{err3b:.3e} (bound {PATH_BOUND:g})", flush=True)
            check(err3b <= PATH_BOUND, "config 3, bf16 disagrees with exact "
                  "path")
            rec = time_planar(p3, bsrc_b, "config 3, bf16", peak)
            del rec["sx"], rec["sy"], out3b
            cops = FP.chain_operands(p3, bsrc)
            ctens = [cops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
            buf = torch.empty((p3.height, p3.width, 3), device="cuda")
            tables = {"f32": bsrc.spl.coeff, "bf16": bsrc_b.spl.coeff}
            rec["turns"] = dtype_turns(
                "config 3 (K2 chain)", lambda d: R.resample_planar_chain(
                    buf, tables[d], *ctens, **cops))
            del bsrc_b, tables, buf
            t_bf16["resample_planar_chain"] = dict(
                rec, path="config 3", launches=n3b["resample_planar_chain"],
                vs_exact=err3b)
    del bsrc
    torch.cuda.empty_cache()

    # ---- 5b. config 3 twined: smooth biatan6 -> stereographic ---------
    # a smooth source, so that the error along cube-face edges (taps
    # that read the centre face's support frame) measures the route and
    # not the bilinear support fill of uniform noise
    from envutil_tpu_torch.core.metrics import get_extent
    from envutil_tpu_torch.models import stepper as ST
    ext = get_extent(P.BIATAN6, 1024, 6144, math.radians(100))
    sfaces = smooth_environment(ST.target_rays(
        P.BIATAN6, 1024, 6144, ext, device="cuda")).cpu().numpy()
    ssrc = CBM.make_cubemap_source(bfct, sfaces.reshape(6, 1024, 1024, 3),
                                   3, 3, 128, 64, device="cuda")
    del sfaces
    plan3t = plan_for(bfct, P.STEREOGRAPHIC, 1920, 1152, 150, 3, (35, 20, 0),
                      twine=2)
    t_twined["config 3"] = twined_planar_path("config 3 twined", plan3t, ssrc)
    check(t_twined["config 3"]["region_px"]["face edges"] > 0,
          "config 3 twined crosses no cube-face edge")
    ssrc_b = with_coeff(ssrc, "bf16")
    t_bf16["resample_twined_chain"] = dict(twined_planar_path(
        "config 3 twined, bf16", plan3t, ssrc_b), path="config 3 twined")
    cops = FP.chain_operands(plan3t, ssrc)
    ctens = [cops.pop(k) for k in ("xfeat", "yfeat", "bmats", "spread")]
    buf = torch.empty((plan3t.height, plan3t.width, 3), device="cuda")
    tables = {"f32": ssrc.spl.coeff, "bf16": ssrc_b.spl.coeff}
    t_bf16["resample_twined_chain"]["turns"] = dtype_turns(
        "config 3 twined (K3 chain)", lambda d: R.resample_twined_chain(
            buf, tables[d], *ctens, **cops))
    del ssrc, ssrc_b, tables, buf
    torch.cuda.empty_cache()

    # ---- 6. a partial lens-corrected facet and a translated facet -----
    lf = make_facet(P.RECTILINEAR, 1536, 1152, math.radians(72),
                    a=0.01, b=-0.02, c=0.005)
    limg = rng.uniform(0, 1, (1152, 1536, 3)).astype(np.float32)
    lsrc = E.make_mount_source(lf, limg, 3, 3, device="cuda")
    p5 = plan_for(lf, P.SPHERICAL, 4096, 2048, 360, 3)
    out5, first5_ms, n5 = render(p5, lsrc, "lens facet",
                                 want={"resample_planar_chain": 1,
                                       "chain_blocks": 1})
    peak = torch.cuda.max_memory_allocated() / 2**20
    planar_n["lens facet"] = n5["resample_planar_chain"]
    covered = float((out5 != 0).any(axis=-1).mean())
    err5, _e = band_errors(p5, lsrc, out5, [(704, 712), (1020, 1028),
                                            (1336, 1344)], False)
    print(f"lens facet through the chain form: {100 * covered:.1f}% of the "
          f"equirect covered; vs exact path, 3 bands of 8 rows: max abs diff "
          f"{err5:.3e} (bound {PATH_BOUND:g})", flush=True)
    check(0.02 < covered < 0.5, "lens facet coverage implausible")
    check(err5 <= PATH_BOUND, "lens facet disagrees with exact path")
    t_planar["lens facet"] = time_planar(p5, lsrc, "lens facet", peak)
    t_planar["lens facet"].pop("sx")
    t_planar["lens facet"].pop("sy")
    t_planar["lens facet"]["compact"] = compact_path("lens facet", p5,
                                                     [lsrc], first5_ms)
    p5t = plan_for(lf, P.SPHERICAL, 4096, 2048, 360, 3, twine=2)
    t_twined["lens facet"] = twined_planar_path("lens facet twined", p5t,
                                                lsrc)
    check(0.02 < t_twined["lens facet"]["covered"] < 0.5
          and t_twined["lens facet"]["region_px"][
              "facet edge (taps differ)"] > 0,
          "lens facet twined: coverage or facet edge implausible")

    # a translated facet has a generic chain: it stays on the planes
    # forms, untwined and twined
    tf = make_facet(P.RECTILINEAR, 640, 480, math.radians(80),
                    tr_x=0.2, tr_y=-0.1, tr_z=0.15, yaw=math.radians(10))
    tsrc = E.make_mount_source(tf, limg[:480, :640], 3, 3, device="cuda")
    t_translated = {}
    for twine, want, bound in ((0, "resample_planar", PATH_BOUND),
                               (2, "resample_twined", TWINED_PLANAR_BOUND)):
        pt = plan_for(tf, P.RECTILINEAR, 1024, 768, 100, 3, (5, 0, 0),
                      twine=twine)
        check(pt.planar_to_ray[0] is not None, "translated facet not generic")
        for coeff_dtype in ("f32", "bf16"):
            name = "translated facet" + (" twined" if twine else "") + (
                ", bf16" if coeff_dtype == "bf16" else "")
            tsrc_d = with_coeff(tsrc, coeff_dtype)
            outt, _ms, nt = render(pt, tsrc_d, name, want={want: 1})
            covered = float((outt != 0).any(axis=-1).mean())
            errt = max(v[0] for v in frame_errors(pt, tsrc_d, outt).values())
            print(f"{name} through the planes form: {100 * covered:.1f}% of "
                  f"the view covered; vs exact path, whole frame: max abs "
                  f"diff {errt:.3e} (bound {bound:g})", flush=True)
            check(0.05 < covered < 0.95, f"{name} coverage implausible")
            check(errt <= bound, f"{name} disagrees with exact path")
            rec = planes_at_path(pt, tsrc_d, name)
            if coeff_dtype == "f32":
                planar_n[name] = nt[want]
                t_translated[name] = rec
            else:
                rec["turns"] = planes_turns(pt, tsrc, tsrc_d, name[:-6])
                t_bf16[want] = dict(rec, path=name[:-len(", bf16")],
                                    launches=nt[want], vs_exact=errt)

    # the two facets stitched into the translated facet's view: the
    # lens facet through the chain form with its score, the translated
    # facet through the coordinate pass and the planes form, its score
    # from the pass's z
    sa = make_args(lf, P.RECTILINEAR, 1024, 768, 100, 3, (5, 0, 0))
    sa.facets, sa.solo = [lf, tf], -1
    ps = RD.build_plan(sa, [lf, tf])
    outs, first_ls_ms, ns = render(ps, [lsrc, tsrc],
                                   "lens and translated stitch",
                                   want=voronoi_want(ps, [lsrc, tsrc]))
    peak_ls = torch.cuda.max_memory_allocated() / 2**20
    stack = torch.empty((2, 768, 1024, 3), device="cuda")
    score = torch.empty((2, 768, 1024), device="cuda")
    skipped = []
    err_ls, err_lslot, edge_ls, flip_ls = stitch_errors(
        ps, [lsrc, tsrc], outs, stack, score, skipped=skipped)
    share = float((score[1] > score[0]).float().mean())
    print(f"lens and translated stitch (voronoi, 1024x768): the translated "
          f"facet wins {100 * share:.1f}% of the view; vs exact path, whole "
          f"frame: max abs diff {err_ls:.3e}, slots {err_lslot:.3e} (bound "
          f"{PATH_BOUND:g}); {edge_ls} px at a window edge and {flip_ls} at a "
          f"near-tied champion excluded", flush=True)
    check(err_ls <= PATH_BOUND and err_lslot <= PATH_BOUND,
          "the lens and translated stitch disagrees with the exact path")
    check(0.05 < share < 0.95, "the translated facet wins no share")
    planar_n["lens and translated stitch"] = ns["resample_planar_chain"]
    champion_path("lens and translated stitch", ps, [lsrc, tsrc], outs,
                  first_ls_ms, skipped[0], peak_ls)
    compact_path("lens and translated stitch", ps, [lsrc, tsrc],
                 first_ls_ms)
    # the same stitch twined (--twine 2): per tap one one-tap launch of
    # the twined chain form with its score for the lens facet and, for
    # the translated facet, the coordinate pass and the twined planes
    # form, its score from the pass's deflected rays
    sa = make_args(lf, P.RECTILINEAR, 1024, 768, 100, 3, (5, 0, 0), twine=2)
    sa.facets, sa.solo = [lf, tf], -1
    pst = RD.build_plan(sa, [lf, tf])
    outs, first_lst_ms, nst = render(
        pst, [lsrc, tsrc], "lens and translated stitch, twined (4 taps)",
        want=voronoi_want(pst, [lsrc, tsrc]))
    peak_lst = torch.cuda.max_memory_allocated() / 2**20
    skipped = []
    errs_t = stitch_errors(pst, [lsrc, tsrc], outs, stack, score,
                           skipped=skipped)
    print(f"lens and translated stitch, twined (4 taps): vs exact path, "
          f"whole frame: max abs diff {errs_t[0]:.3e}, slots {errs_t[1]:.3e}"
          f" (bound {TWINED_PLANAR_BOUND:g}); {errs_t[2]} px at a window edge"
          f" and {errs_t[3]} at a near-tied champion (at any tap) excluded",
          flush=True)
    check(errs_t[0] <= TWINED_PLANAR_BOUND
          and errs_t[1] <= TWINED_PLANAR_BOUND,
          "the twined lens and translated stitch disagrees with the exact "
          "path")
    t_lens_translated_twined = dict(
        launches={k: v for k, v in nst.items() if v}, max_abs_err=errs_t[0],
        slot_max_abs_err=errs_t[1], edge_px=errs_t[2],
        excluded_px=errs_t[3], voronoi_route=champion_path(
            "lens and translated stitch, twined (4 taps)", pst,
            [lsrc, tsrc], outs, first_lst_ms, skipped[0], peak_lst),
        compact=compact_path("lens and translated stitch, twined", pst,
                             [lsrc, tsrc], first_lst_ms))
    del lsrc, tsrc, stack, score, outs
    torch.cuda.empty_cache()

    # ---- 6b. the 16K / 16-tap job (config 4b's geometry, float32) -----
    w16, h16 = 16384, 8192
    fct16 = make_facet(P.SPHERICAL, w16, h16, 2 * math.pi)
    src16 = E.make_mount_source(fct16, ramp_fixture(w16, h16), 1, 1,
                                device="cuda")
    print(f"16K source: {w16}x{h16} RGB, table "
          f"{tuple(src16.spl.coeff.shape)} "
          f"({src16.spl.coeff.numel() * 4 / 1e9:.2f} GB, float32)",
          flush=True)
    plan16 = plan_for(fct16, P.RECTILINEAR, 2048, 1280, 100, 1, twine=-1)
    check(len(plan16.spread) == 16, f"16K spread has {len(plan16.spread)}")
    t_twined["16K"] = twined_inline_path("16K job", plan16, src16)
    frame16 = RD.render_frame(plan16, [src16], device="cuda")

    # ---- 6c. config 4b as benchmarks.py defines it: the bf16 table ----
    # rounded from the float32 build as the loader does, the float32
    # table dropped as the copy replaces it
    src16_b = with_coeff(src16, "bf16")
    tens16, kw16 = twined_inline_operands(plan16, src16)
    buf16 = torch.empty((plan16.height, plan16.width, 3), device="cuda")
    tables = {"f32": src16.spl.coeff, "bf16": src16_b.spl.coeff}
    turns16 = dtype_turns("16K (K4, 16 taps)", lambda d:
                          R.resample_inline_twined(buf16, tables[d], *tens16,
                                                   **kw16))
    del tables, buf16
    src16 = src16_b
    del src16_b
    torch.cuda.empty_cache()
    table16 = src16.spl.coeff
    print(f"config 4b source: {w16}x{h16} RGB, table {tuple(table16.shape)} "
          f"{table16.dtype} ({table16.numel() * table16.element_size() / 1e9:.2f}"
          f" GB); device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(table16.dtype == torch.bfloat16, "config 4b's table is not bf16")
    t_bf16["resample_inline_twined"] = dict(twined_inline_path(
        "config 4b (16K, bf16)", plan16, src16, reference=frame16),
        path="config 4b (16K, 16 taps)", turns=turns16,
        table_gb=table16.numel() * table16.element_size() / 1e9)
    del src16, table16, frame16
    torch.cuda.empty_cache()

    # ---- 6d. degree 9: the exact-path route on the card ---------------
    t_exact = exact_route_path(np.random.default_rng(9))
    torch.cuda.empty_cache()

    # ---- 6e. untwined stitches of benchmarks.py at full size ----------
    t_stitch = {}
    for name in ("config 5", "config 5b", "config 5c",
                 "config 5, 4 channels", "config 5d"):
        t_stitch[name] = stitch_path(name, np.random.default_rng(5))
        torch.cuda.empty_cache()
    t_stitch_bf16 = stitch_path("config 5", np.random.default_rng(5), "bf16")
    torch.cuda.empty_cache()
    for name, t in t_stitch.items():
        if t["synopsis"] != "hdr_merge":
            planar_n[name] = t["launches"]["resample_planar_chain"]

    # ---- 6f. twined stitches at full size: per tap, one one-tap launch
    # per facet and the combine of that tap. --twine 2 is the 2x2 box
    # (4 taps) that config 5d's comment in benchmarks.py names; its code
    # passes twine=1, which make_spread(1, 1) (in both packages) turns
    # into 2x1 taps: that runs too --------------------------------------
    t_twined_stitch = {}
    for name, twine in (("config 5d", 2), ("config 5d", 1),
                        ("config 5, 4 channels", 2), ("config 5c", 2)):
        t_twined_stitch[f"{name}, twine {twine}"] = stitch_path(
            name, np.random.default_rng(5), twine=twine)
        torch.cuda.empty_cache()
    t_one_tap = one_tap_stitch(np.random.default_rng(5))
    torch.cuda.empty_cache()

    # ---- 6g. a twined view of a full sphere's pole --------------------
    pfct = make_facet(P.SPHERICAL, 8192, 4096, 2 * math.pi)
    peq = smooth_environment(ST.target_rays(
        P.SPHERICAL, 8192, 4096, get_extent(P.SPHERICAL, 8192, 4096,
                                            2 * math.pi), device="cuda"))
    psrc = E.make_mount_source(pfct, peq.cpu().numpy(), 3, 3, device="cuda")
    del peq
    t_pole = pole_view_path(pfct, psrc)
    del psrc
    torch.cuda.empty_cache()

    # ---- 6h. PTO jobs: --single on a lens-corrected facet, alpha
    # synthesis of lens crops and exclude masks, --mask_for, and a
    # --twine_precise stitch on the exact route --------------------------
    t_single = single_path(np.random.default_rng(5))
    torch.cuda.empty_cache()
    t_alpha = stitch_path("config 5b, alpha", np.random.default_rng(5))
    torch.cuda.empty_cache()
    t_mask = mask_for_path(np.random.default_rng(5))
    torch.cuda.empty_cache()
    t_precise = precise_path(np.random.default_rng(5))
    torch.cuda.empty_cache()

    # ---- 6i. image I/O and serving surfaces on config 2's source: the
    # CLI with EXR output, streaming, serve, visor, render_to_store -------
    t_surfaces = surface_phases()
    torch.cuda.empty_cache()

    # ---- 6j. --mesh and --shard_table over four bands on this card ----
    t_mesh = mesh_phases()
    torch.cuda.empty_cache()

    # ---- 7. the record ------------------------------------------------
    t3 = t_planar["config 3"]
    t4, t3t = t_twined["config 4"], t_twined["config 3"]
    for k, v in small_bf16.items():
        t_bf16[k]["small_case_max_abs_err"] = v
    t_bf16["resample_planar_chain"]["stitch"] = dict(t_stitch_bf16,
                                                     path="config 5")
    print(f"exact route: {json.dumps(t_exact)}", flush=True)
    print(f"twined stitches: {json.dumps(t_twined_stitch)}", flush=True)
    print(f"mask_for: {json.dumps(t_mask)}", flush=True)
    print(f"precise: {json.dumps(t_precise)}", flush=True)
    print(f"surfaces: {json.dumps(t_surfaces)}", flush=True)
    print(f"mesh: {json.dumps(t_mesh)}", flush=True)
    print(f"compact: {json.dumps(COMPACT)}", flush=True)
    print(f"voronoi route: {json.dumps(CHAMPION)}", flush=True)
    # the voronoi route's kernels, measured on config 5 (the champion
    # mode) and config 5d at 2x2 taps (the tapsel mode, the champion
    # pass and its lists)
    r5d = t_twined_stitch["config 5d, twine 2"]
    vr5, vr5d = t_stitch["config 5"]["voronoi_route"], r5d["voronoi_route"]
    # the compact grid: the coverage pass of every job with block lists,
    # and the listed launches' times against the full window's per job
    covers = {job: [f["cover"] for f in rec["facets"] if f is not None]
              for job, rec in COMPACT.items()}
    cover5d = covers["config 5d, twined (4 taps)"][0]

    def compact_of(kernel):
        twined = kernel == "resample_twined_chain"
        return {job: dict(
            launch_ms=[f and f["launch_ms"] for f in rec["facets"]],
            full_ms=[f and f["full_ms"] for f in rec["facets"]],
            launch_burst_ms=[f and f["launch_burst_ms"]
                             for f in rec["facets"]],
            full_burst_ms=[f and f["full_burst_ms"] for f in rec["facets"]],
            share=[f and f["share"] for f in rec["facets"]],
            frame_burst_ms=rec["frame_burst_ms"],
            full_frame_burst_ms=rec["full_frame_burst_ms"])
            for job, rec in COMPACT.items()
            if any(f is not None and f["cover"]["twined"] == twined
                   for f in rec["facets"])}
    print(f"command time: {time.perf_counter() - T_START:.1f} s, the "
          f"kernel build included", flush=True)

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [
        {"name": "resample_inline", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/resample_inline.cu",
         "replaces": "envutil_tpu/ops/pallas_resample.py:1385",
         "launches": main_n["resample_inline"], "max_abs_err": err_main,
         "ms": t_main["ms"], "plain_ms": t_main["plain_ms"],
         "bound_ms": t_main["bound_ms"], "bound_by": t_main["bound_by"],
         "library_ms": None,
         "direct_ms": t_main["direct_ms"],
         "small_case_max_abs_err": worst_inline,
         "frame_ms": t_main["frame_ms"], "prefilter_ms": prefilter_ms,
         "build": build.get("resample_inline_kernel"),
         "config_2r": dict(t_2r, launches=r2_n["resample_inline"],
                           max_abs_err=err2r_k),
         "bf16": t_bf16["resample_inline"],
         "stitches": {k: t for k, t in t_stitch.items()
                      if t["synopsis"] == "hdr_merge"},
         # launches on the image I/O and serving surfaces
         "surfaces": surface_launches(t_surfaces, "resample_inline"),
         # launches of the --mesh frames (MESH_N bands on this card)
         "mesh": mesh_launches(t_mesh, "resample_inline")},
        # the planes form: launched and measured on the translated
        # facet's operands; config 3's coordinates beside them
        dict(t_translated["translated facet"],
             name="resample_planar", route="cuda",
             source="envutil_tpu_torch/csrc/resample_planar.cu",
             replaces="envutil_tpu/ops/pallas_resample.py:1070 (K2), "
                      "envutil_tpu/ops/pallas_resample.py:822 (K5)",
             form="planes", launches=planar_n["translated facet"],
             path="translated facet", library_ms=None,
             # --single 0 of config 5b: one planes launch a facet
             single=t_single,
             degree1=dict(deg1, library="grid_sample bilinear"),
             small_case_max_abs_err=worst_planar,
             bf16=t_bf16["resample_planar"],
             build=build.get("resample_planar_kernel"),
             mesh=mesh_launches(t_mesh, "resample_planar")),
        {"name": "resample_planar_chain", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/resample_planar.cu",
         "replaces": "envutil_tpu/ops/pallas_resample.py:1070 (K2), "
                     "envutil_tpu/ops/pallas_resample.py:822 (K5)",
         "form": "chain", "launches": planar_n["config 3"],
         "max_abs_err": t3["max_abs_err"], "ms": t3["ms"],
         "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
         "bound_by": t3["bound_by"], "library_ms": None,
         "small_case_max_abs_err": worst_chain["planar"],
         "small_case_edge_px": chain_edge_px["planar"],
         "build": build.get("resample_planar_chain_kernel"),
         "small_case_score_max_abs_err_of_z": worst_chain["score"],
         "launches_by_path": planar_n,
         "paths": t_planar,
         "bf16": t_bf16["resample_planar_chain"],
         "stitches": {k: t for k, t in t_stitch.items()
                      if t["synopsis"] != "hdr_merge"},
         "pto_alpha": t_alpha,
         "compact": compact_of("resample_planar_chain"),
         "mesh": mesh_launches(t_mesh, "resample_planar_chain")},
        dict({k: t4[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by")},
             name="resample_inline_twined", route="cuda",
             source="envutil_tpu_torch/csrc/resample_inline_twined.cu",
             replaces="envutil_tpu/ops/pallas_resample.py:1536",
             library_ms=None,   # no PyTorch call sums a b-spline over
             # deflected taps
             small_case_max_abs_err=worst_inline_twined,
             build=build.get("resample_inline_twined_kernel"),
             bf16=t_bf16["resample_inline_twined"],
             paths={k: t_twined[k] for k in ("config 4", "pole and seam",
                                             "16K")},
             stitches={k: t for k, t in t_twined_stitch.items()
                       if t["synopsis"] == "hdr_merge"},
             surfaces=surface_launches(t_surfaces,
                                       "resample_inline_twined"),
             mesh=mesh_launches(t_mesh, "resample_inline_twined")),
        # the planes form: launched and measured on the translated facet
        # twined's operands; config 3 twined's planes beside them
        dict(t_translated["translated facet twined"],
             name="resample_twined", route="cuda",
             source="envutil_tpu_torch/csrc/resample_twined.cu",
             replaces="envutil_tpu/ops/pallas_resample.py:1736 (K3), "
                      "envutil_tpu/ops/pallas_resample.py:2033 (K6)",
             form="planes", launches=planar_n["translated facet twined"],
             path="translated facet twined", library_ms=None,
             small_case_max_abs_err=worst_twined,
             build=build.get("resample_twined_kernel"),
             bf16=t_bf16["resample_twined"],
             lens_and_translated_stitch_twined=t_lens_translated_twined,
             mesh=mesh_launches(t_mesh, "resample_twined")),
        dict({k: t3t[k] for k in ("launches", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by")},
             name="resample_twined_chain", route="cuda",
             source="envutil_tpu_torch/csrc/resample_twined.cu",
             replaces="envutil_tpu/ops/pallas_resample.py:1736 (K3), "
                      "envutil_tpu/ops/pallas_resample.py:2033 (K6)",
             form="chain", library_ms=None,   # as above
             small_case_max_abs_err=worst_chain["twined"],
             small_case_edge_px=chain_edge_px["twined"],
             small_case_score_max_abs_err_of_z=worst_chain["twined score"],
             build=build.get("resample_twined_chain_kernel"),
             bf16=t_bf16["resample_twined_chain"],
             paths={k: t_twined[k] for k in ("config 3", "lens facet")},
             # per frame F x K one-tap launches, each with its score:
             # the one-tap launch's time and bound per facet
             stitches={k: t for k, t in t_twined_stitch.items()
                       if t["synopsis"] != "hdr_merge"},
             one_tap_stitch=t_one_tap, pole_view=t_pole,
             # --twine_precise jobs left this form for the exact route:
             # the form's deviation on a precise job, and its time
             precise_job=t_precise,
             compact=compact_of("resample_twined_chain"),
             mesh=mesh_launches(t_mesh, "resample_twined_chain")),
        # the coverage pass of the compact grid: launched and measured on
        # config 5d twined's first facet (its four taps' union); every
        # job's passes beside it
        {"name": "chain_blocks", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/chain_blocks.cu",
         "replaces": "envutil_tpu/runtime/fastpath.py:1040 (plan_passes' "
                     "per-tile coverage, ZERO_PASS: the tiles of "
                     "envutil_tpu/ops/pallas_resample.py:1148 and :1930)",
         "launches": t_twined_stitch["config 5d, twine 2"]["launches"][
             "chain_blocks"],
         "max_abs_err": max(c["max_abs_err"] for cs in covers.values()
                            for c in cs),
         "differing_blocks": sum(c["differing_blocks"]
                                 for cs in covers.values() for c in cs),
         "ms": cover5d["ms"], "plain_ms": cover5d["plain_ms"],
         "bound_ms": cover5d["bound_ms"], "bound_by": cover5d["bound_by"],
         "library_ms": None,   # no PyTorch call lists a chain's blocks
         "path": "config 5d twined (2x2 taps), facet 0", "jobs": covers,
         "build": build.get("chain_cover_kernel"),
         "mesh": mesh_launches(t_mesh, "chain_blocks")},
        # the champion pass of the voronoi route: its time as a plan
        # builds it (its kernel a facet, the lists and the count's read
        # back), on config 5d at 2x2 taps; the planes' agreement with
        # the plain pass and with the stack route's argmax on every
        # voronoi stitch under "jobs"
        {"name": "champion", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/champion.cu",
         "replaces": "envutil_tpu/runtime/fastpath.py:2978 (_pertap_build's "
                     "champion stack, XLA, the champ operand of "
                     "envutil_tpu/ops/pallas_resample.py:1751)",
         "launches": r5d["launches"]["champion_planes"],
         "max_abs_err": max(worst_chain["champion score"],
                            chain_bf16["champion score"]),
         "differing_untied_px": sum(sum(r["champion_differs_untied_px"])
                                    for r in CHAMPION.values()),
         "differing_tied_px": sum(sum(r["champion_differs_tied_px_per_tap"])
                                  for r in CHAMPION.values()),
         "ms": vr5d["pass_ms"], "plain_ms": vr5d["pass_plain_ms"],
         "bound_ms": vr5d["pass_bound_ms"],
         "bound_by": vr5d["pass_bound_by"],
         "library_ms": None,   # no PyTorch call takes a first-wins argmax
         # over facets' chains
         "path": "config 5d twined (2x2 taps)",
         "jobs": {k: {f: r[f] for f in ("pass_ms", "pass_plain_ms",
                                        "pass_bound_ms", "planes_mib",
                                        "champion_differs_untied_px",
                                        "champion_differs_tied_px_per_tap")}
                  for k, r in CHAMPION.items()},
         "build": build.get("champion_kernel"),
         "mesh": mesh_launches(t_mesh, "champion_planes")},
        {"name": "champion_lists", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/champion.cu",
         "replaces": "envutil_tpu/ops/pallas_resample.py:1060 (_emit_rows_zero"
                     ", the tapsel kernel's skip of row blocks no tap "
                     "champions, :1904)",
         "launches": r5d["launches"]["champion_lists"],
         "max_abs_err": float(not all(r["lists_equal"]
                                      for r in CHAMPION.values())),
         "ms": vr5d["lists_ms"], "plain_ms": vr5d["lists_plain_ms"],
         "bound_ms": vr5d["lists_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "path": "config 5d twined (2x2 taps)",
         "build": build.get("champion_flags_kernel"),
         "mesh": mesh_launches(t_mesh, "champion_lists")},
        # the chain forms' modes on the voronoi route: a facet's launch
        # (facet 0) on config 5 (champion mode) and config 5d at 2x2
        # taps (tapsel mode), every stitch's launches under "stitches"
        {"name": "resample_planar_chain:champion", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/resample_planar.cu",
         "replaces": "envutil_tpu/ops/pallas_resample.py:1070 (K2's "
                     "merge-mask overlay, merge=True; resample_planar_into "
                     ":1148)",
         "launches": t_stitch["config 5"]["launches"][
             "resample_planar_chain:champion"],
         "max_abs_err": worst_chain["champion mode"],
         "ms": vr5["launches"][0]["ms"],
         "plain_ms": vr5["launches"][0]["plain_ms"],
         "bound_ms": vr5["launches"][0]["bound_ms"],
         "bound_by": vr5["launches"][0]["bound_by"], "library_ms": None,
         "path": "config 5, facet 0",
         "small_case_max_abs_err": worst_chain["champion mode"],
         "bf16": {"small_case_max_abs_err": chain_bf16["champion mode"],
                  "stitch": t_stitch_bf16["voronoi_route"]},
         "stitches": {k: r["launches"] for k, r in CHAMPION.items()
                      if r["taps"] == 1},
         "mesh": mesh_launches(t_mesh, "resample_planar_chain:champion")},
        {"name": "resample_twined_chain:tapsel", "route": "cuda",
         "source": "envutil_tpu_torch/csrc/resample_twined.cu",
         "replaces": "envutil_tpu/ops/pallas_resample.py:1751 (K3's "
                     "champion-routed tap weights, champ; "
                     "resample_twined_into :1930)",
         "launches": r5d["launches"]["resample_twined_chain:tapsel"],
         "max_abs_err": worst_chain["tapsel mode"],
         "ms": vr5d["launches"][0]["ms"],
         "plain_ms": vr5d["launches"][0]["plain_ms"],
         "bound_ms": vr5d["launches"][0]["bound_ms"],
         "bound_by": vr5d["launches"][0]["bound_by"], "library_ms": None,
         "path": "config 5d twined (2x2 taps), facet 0",
         "small_case_max_abs_err": worst_chain["tapsel mode"],
         "bf16": {"small_case_max_abs_err": chain_bf16["tapsel mode"]},
         "stitches": {k: r["launches"] for k, r in CHAMPION.items()
                      if r["taps"] > 1},
         "build": build.get("resample_twined_chain_kernel"),
         "mesh": mesh_launches(t_mesh, "resample_twined_chain:tapsel")},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
