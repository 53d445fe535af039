"""Twined stitches on the port's card route, on the CPU: a stitch of
several facets under a twining spread through ``fastpath.multi_frame``
(per tap of the spread, one one-tap launch per facet into the stacks,
run here as the kernels' plain versions, then the synopsis of the
stacks, summed over the taps with their weights) against the JAX
package's ``render_frame`` (its exact graph on the CPU) and the port's
exact path, for voronoi, voronoi_plus (alpha), hdr_merge and
``--twine_precise``; the twined chain form's score output; and a
two-facet CLI job whose twine ``twine_setup`` chooses.

Tables are built by the JAX package and carried over as numpy
(tests/test_torch_synopsis.py ``_stitch``), three facets of 64x48 into a
96x48 equirect or a rectilinear view, 4 and 9 taps, degree 1 and 3.

Tolerances, each with its reason:

- the port's exact path against the JAX package: 1e-5, as for the
  untwined stitches (the same rays deflected the same way).
- the card route through the twined chain form (and the planes form of
  a translated facet) against the exact path: ROUTE_TOL, 2e-2. The
  kernel deflects each tap in coordinate space, the exact path the ray,
  a second-order term in the tap offset (tests/test_torch_twining.py:
  1e-2 for partial facets where a target pixel spans 1-3 degrees). A
  pixel of the 96x48 equirect spans 3.75 degrees, and the term grows
  with the square of the offset: (3.75 / 3)^2 x 1e-2 = 1.6e-2. A wrong
  champion, tap, weight or a spread bias applied twice shows as
  O(0.1..1) on these noise facets.
- at a tap of offset (0.25, 0), scaled by 1/DERIV_BIAS to 1, the tap's
  ray is the derivative grid's own ray and its coordinates that grid
  ray's pickup, so both deflections agree: ROUTE_TOL_AT_GRID, 5e-5, the
  untwined stitches' route bound (tests/test_torch_synopsis.py).
- full-spherical brackets through the inline twined kernel (K4), which
  deflects the ray as the exact path does: 1e-5 against JAX.
- scores: 1e-6 relative (z of a float32 ray in another order), as
  tests/test_torch_synopsis.py.
- Excluded and counted, per tap (at that tap's deflected rays): pixels
  whose two best scores lie within SCORE_REL of each other, and pixels
  whose planar coordinate in some facet lies within EDGE of its
  window's edge; an ulp decides those. Near a pole of the equirect many
  pixels share almost one ray, so each tap adds its own few: the count
  is held to MAX_EXCLUDED_PX a tap.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from test_torch_synopsis import (CASES, EDGE, JAX_TOL, MAX_EXCLUDED_PX,
                                 SCORE_REL, SCORE_TOL, _stitch)

from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import stepper as ST
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.models import twining
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import cli
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import (build_plan, render_exact,
                                              render_frame)

torch.set_num_threads(1)

ROUTE_TOL = 2e-2
ROUTE_TOL_AT_GRID = 5e-5


def _spread(twine):
    return [list(t) for t in twining.make_spread(twine)]


def _excluded(plan, sources):
    """(H, W) pixels excluded from the frame comparisons: at some tap,
    near-tied voronoi scores (not for hdr_merge) or a window edge of
    some facet, from the port's exact deflected rays."""
    packs = [ST.target_ninepack(plan.projection, plan.width, plan.height,
                                plan.extent, basis=b, normalize=True,
                                planar_to_ray=p)
             for b, p in zip(plan.bases, plan.planar_to_ray)]
    derivs = [(p[0],) + SYN.derivative_rays(*p, plan.twine_precise)
              for p in packs]
    out = torch.zeros((plan.height, plan.width), dtype=torch.bool)
    for cx, cy, _w in SYN.scaled_spread(plan.spread):
        scores = []
        for src, (p0, du, dv) in zip(sources, derivs):
            ray = SYN.deflect(p0, du, dv, cx, cy)
            pick = FP._pickup(src)
            px, py, hit = R.mount_planar(pick, *ray)
            if pick.smode == "mount" and not FP._covers_every_ray(src):
                x0, x1, y0, y1 = pick.window
                for v, e in ((px, x0), (px, x1), (py, y0), (py, y1)):
                    out |= (v - e).abs() <= EDGE
                if pick.projection == int(TP.RECTILINEAR):
                    out |= ray[2].abs() <= EDGE
            else:
                hit = torch.ones_like(hit)
            scores.append(SYN.facet_score(ray[2], hit, src.static.recip_step))
        if plan.synopsis != "hdr_merge":
            top2 = torch.topk(torch.stack(scores), 2, dim=0).values
            out |= (top2[1] > SYN.LOWEST) & (
                (top2[0] - top2[1]).abs() <= SCORE_REL * top2[0].abs())
    return out


def _max_diff(got, want, keep):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max(
        axis=-1)[keep].max())


# (CASES entry or dict, twine, --twine_precise, the route's bound against
# the exact path, the kernel each facet takes, whether to render the JAX
# frame too: the 4-tap voronoi stitch of degree 3 is held against it in
# tests/test_torch_synopsis.py, and the exact path deflects the 9 taps as
# it deflects 4)
DEG1 = dict(CASES["voronoi, 3 rectilinear facets"], degree=1)
STITCHES = {
    "voronoi, 9 taps, degree 1": (DEG1, 3, False, ROUTE_TOL,
                                  "resample_twined_chain", False),
    "voronoi_plus, 4 channels, 4 taps": (
        "voronoi_plus, 4 channels", 2, False, ROUTE_TOL,
        "resample_twined_chain", True),
    "hdr_merge, full-spherical brackets, 4 taps": (
        "hdr_merge, 3 full-spherical brackets", 2, False, JAX_TOL,
        "resample_inline_twined", True),
    "voronoi, lens and translated facets, twine_precise": (
        "voronoi, 2 lens facets and a translated facet", 2, True, ROUTE_TOL,
        None, True),
}


@pytest.mark.parametrize("name", list(STITCHES))
def test_twined_stitch_route_matches_jax(name):
    """A twined stitch through ``multi_frame`` (the card route: per tap,
    one one-tap launch per facet, as plain versions here, then the
    combine, summed over the taps) against the port's exact path and
    the JAX ``render_frame``; the launches per tap and facet: F x K, each
    facet's kernel as ``launch`` chooses it (the twined chain form with
    its score for voronoi, the inline twined kernel for full-spherical
    hdr_merge brackets, the planes form for a translated facet)."""
    case, twine, precise, tol, kernel, with_jax = STITCHES[name]
    spread = _spread(twine)
    jsrcs, tsrcs, jplan, tplan = _stitch(case, spread, precise, with_jax)
    assert tplan.twine_precise == precise and len(tplan.spread) == twine ** 2
    exact = render_frame(tplan, tsrcs, device="cpu")
    skip = _excluded(tplan, tsrcs).numpy()
    n_skip = int(skip.sum())
    print(f"{name}: {n_skip} px excluded (near-tied scores, window edges)")
    assert n_skip <= MAX_EXCLUDED_PX * len(spread)
    log = []
    fast = FP.multi_frame(tplan, tsrcs, device="cpu", log=log)
    err = _max_diff(fast, exact, ~skip)
    print(f"{name}: multi_frame vs exact path {err:.3e} (bound {tol:g})")
    assert err <= tol
    if with_jax:
        want = np.asarray(jrender_frame(jplan, jsrcs))
        assert _max_diff(exact, want, ~skip) <= JAX_TOL
        assert _max_diff(fast, want, ~skip) <= tol + JAX_TOL
    assert len(log) == len(tsrcs) * twine ** 2
    if kernel is not None:
        assert set(log) == {kernel}
    else:
        assert log[:3] == ["resample_twined_chain"] * 2 + [
            "resample_twined after the coordinate pass"]
    assert (np.asarray(fast) != 0).any(axis=-1).mean() > 0.1


def test_one_tap_stitch_applies_the_spread_bias_once():
    """A one-tap spread off the pixel centre, (0.25, 0): ``tap_plans``
    keeps the plan's own offsets with weight 1 (its plans share their
    facet's operands), and the kernels' operands
    fold 1/DERIV_BIAS in once, so the tap's ray is p0 + (p10 - p0), the
    derivative grid's own ray, where deflecting in coordinate space and
    in ray space agree: the card route renders what the exact path
    renders to ROUTE_TOL_AT_GRID, and the tap moved off the untwined
    stitch by a quarter of a pixel. Scaled twice (or not at all) the
    tap would sit four times as far off (or four times as near)."""
    spread = [[0.25, 0.0, 1.0]]
    _j, tsrcs, _jp, tplan = _stitch("voronoi, 3 rectilinear facets", spread,
                                    jax=False)
    taps = FP.tap_plans(tplan)
    assert [w for w, _p in taps] == [1.0]
    assert all(p.spread == ((0.25, 0.0, 1.0),) for p in taps[0][1])
    # the one-tap plans share their facet's kernel operands
    one, facet = taps[0][1][0], FP.facet_plans(tplan)[0]
    assert FP.frame_operands(one, tsrcs[0])["xfeat"] is \
        FP.frame_operands(facet, tsrcs[0])["xfeat"]
    exact = render_exact(tplan, tsrcs).numpy()
    skip = _excluded(tplan, tsrcs).numpy()
    fast = FP.multi_frame(tplan, tsrcs).numpy()
    assert _max_diff(fast, exact, ~skip) <= ROUTE_TOL_AT_GRID
    untwined = dataclasses.replace(tplan, spread=None)
    assert _max_diff(FP.multi_frame(untwined, tsrcs), exact, ~skip) > 0.1


def test_twined_chain_score_matches_deflected_rays():
    """The twined chain form's score output (plain version) at one tap
    off the centre, for a partial facet (each tap's window test), a full
    sphere and a cubemap source: ``synopsis.facet_score`` of the exact
    path's deflected ray (the stepper's ninepack, not renormalised) under
    the lookup's mask; pixels the same with and without the score; the
    score refused for a spread of more than one tap."""
    from envutil_tpu_torch.models import cubemap as CBM
    from test_torch_render import port_args, port_facet
    rng = np.random.default_rng(41)
    rect = port_facet(TP.RECTILINEAR, 64, 48, math.radians(70))
    rect.yaw = 0.4
    rect.process_geometry()
    sphere = port_facet(TP.SPHERICAL, 128, 64, 2 * math.pi)
    cube = port_facet(TP.CUBEMAP, 16, 96, math.pi / 2)
    sources = [
        (rect, TE.make_mount_source(rect, rng.uniform(
            0, 1, (48, 64, 3)).astype(np.float32), 3, 3, device="cpu")),
        (sphere, TE.make_mount_source(sphere, rng.uniform(
            0, 1, (64, 128, 3)).astype(np.float32), 1, 1, device="cpu")),
        (cube, CBM.make_cubemap_source(cube, rng.uniform(
            0, 1, (6, 16, 16, 3)).astype(np.float32), 3, 3, 8, 16,
            device="cpu"))]
    for fct, src in sources:
        a = port_args(TP.SPHERICAL, 96, 48, 360.0, [fct], src.spl.degree,
                      twine_spread=[[0.5, -0.25, 1.0]])
        plan = build_plan(a, [fct])
        ops = FP.chain_operands(plan, src)
        args = [src.spl.coeff] + [ops.pop(k) for k in (
            "xfeat", "yfeat", "bmats", "spread")]
        score = torch.full((48, 96), float("nan"))
        rs = src.static.recip_step
        scored = R.resample_twined_chain(torch.empty((48, 96, 3)), *args,
                                         score=score, recip_step=rs, **ops)
        bare = R.resample_twined_chain(torch.empty((48, 96, 3)), *args, **ops)
        assert torch.equal(scored, bare)
        p0, p10, p01 = ST.target_ninepack(plan.projection, 96, 48,
                                          plan.extent, basis=plan.bases[0])
        (cx, cy, _w), = SYN.scaled_spread(plan.spread)
        ray = SYN.deflect(p0, *SYN.derivative_rays(p0, p10, p01), cx, cy)
        want = SYN.facet_score(ray[2], TE.lookup(src, ray, 3)[1], rs)
        miss = want == SYN.LOWEST
        assert torch.equal(score == SYN.LOWEST, miss), fct.projection
        assert miss.any() == (fct is rect)
        torch.testing.assert_close(score[~miss], want[~miss], rtol=SCORE_TOL,
                                   atol=0)
        # the raw deflected ray: its length differs from 1
        norm = torch.sqrt(sum(c * c for c in ray))
        assert float((norm - 1).abs().max()) > 1e-4
        with pytest.raises(ValueError, match="one-tap"):
            R.resample_twined_chain(
                torch.empty((48, 96, 3)), *args[:4],
                torch.tensor([[0.0, 0.0, 0.5], [0.1, 0.0, 0.5]]), score=score,
                **dict(ops, n_taps=2))


def test_cli_stitch_twines_by_default(tmp_path, monkeypatch):
    """A two-facet job through the port's CLI with ``--twine`` unset:
    ``twine_setup`` twines the stitch (a slight magnification at degree
    1: a 2x2 box), the CLI writes what the JAX CLI writes, and the card
    route (``render_fast`` on CPU tensors: ``multi_frame``'s plain
    versions) renders the same job instead of refusing it."""
    from envutil_tpu.runtime import assets as jassets
    from envutil_tpu.runtime import cli as jcli
    from envutil_tpu_torch.runtime import assets as tassets
    from envutil_tpu_torch.runtime.args import parse_args
    from envutil_tpu_torch.runtime.loader import load_source
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    rng = np.random.default_rng(43)
    facets = []
    for i, yaw in enumerate((-25, 25)):
        path = tmp_path / f"f{i}.tif"
        imgio.save_image(str(path), rng.uniform(0, 1, (48, 64, 3)).astype(
            np.float32))
        facets += ["--facet", str(path), "rectilinear", "70", str(yaw), "0",
                   "0"]
    job = facets + ["--projection", "rectilinear", "--hfov", "60",
                    "--width", "64", "--height", "48", "--degree", "1"]
    outs = []
    for tag, main, cache in (("t", cli.main, tassets),
                             ("j", jcli.main, jassets)):
        out = tmp_path / f"stitch_{tag}.tif"
        assert main(job + ["--output", str(out)]) == 0
        cache.cache.clear()
        outs.append(imgio.read_image(str(out)))
    got, want = outs
    assert got.shape == want.shape == (48, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    args = parse_args(job + ["--output", "x.tif"])
    args.twine_setup()
    plan = build_plan(args, args.facets)
    assert len(args.facets) == 2 and len(plan.spread) == 4
    sources = [load_source(f, args, "cpu") for f in args.facets]
    assert FP.uncovered(plan, sources) is None
    skip = _excluded(plan, sources).numpy()
    assert int(skip.sum()) <= MAX_EXCLUDED_PX * len(plan.spread)
    assert _max_diff(FP.render_fast(plan, sources), got, ~skip) <= ROUTE_TOL
    assert (got != 0).any(axis=-1).all()
