"""The voronoi route on the CPU (``fastpath.voronoi_frame``: the
champion planes built once per plan by the champion pass, then one
launch per facet into one frame, the chain forms' champion and tapsel
modes or the planes forms with the champion planes, each as its plain
version here): against the JAX package's ``render_frame`` and against
the stack route (``fastpath.multi_frame``, one launch per facet and tap
into a pixel stack, then the combine), with the launches and the builds
counted; the champion planes against the first-wins argmax of the
stack route's one-tap scores; and, on a card, the champion kernels and
the new kernel modes against their plain versions.

Stitches as tests/test_torch_synopsis.py ``_stitch`` builds them (three
64x48 facets into a 96x48 equirect, tables from the JAX package), or,
without JAX, as tests/test_torch_compact.py builds its geometries. JAX
is imported inside the tests that hold the route against it, so that
the card test runs where JAX is not installed (``python3 -m pytest
--noconftest -p no:cacheprovider tests/test_torch_champion.py -m
cuda``).

Tolerances, each with its reason:

- the route against JAX ``render_frame``: untwined JAX_TOL (1e-5), as
  tests/test_torch_synopsis.py; twined ROUTE_TOL + JAX_TOL (2e-2 +
  1e-5), tests/test_torch_twined_stitch.py's bound of the twined chain
  form, which deflects each tap in coordinate space where the JAX graph
  deflects the ray. Near-tied champions and window edges are excluded
  and counted there, as in those files.
- the route against ``multi_frame``: STACK_TOL, 1e-5, with nothing
  excluded. Both take each pixel's (each tap's) champion from the same
  scores by the same first-wins rule and evaluate the same spline at
  the same coordinates; the stack route brightens each tap's value and
  sums, this route sums and brightens, a few float32 ulps apart.
  Untwined, with nothing summed, the frames are bit-equal.
- the champion planes against the argmax of the one-tap scores, and a
  block that one facet champions at every pixel and tap against that
  facet's own launch times its brighten: bit for bit (the same scores,
  the same arithmetic).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import cubemap as CBM
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.models import twining
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.parallel import mesh as PM
from envutil_tpu_torch.runtime import fastpath as FP

from test_torch_compact import BOX2, facet, plan_of, source

torch.set_num_threads(1)

JAX_TOL = 1e-5
ROUTE_TOL = 2e-2
STACK_TOL = 1e-5
MAX_EXCLUDED_PX = 24


def _spread(twine):
    return [list(t) for t in twining.make_spread(twine)]


def _route(plan, sources):
    """``voronoi_frame`` of a stitch: (frame, its launches' kernel names,
    the champion planes' builds by the first frame); a second frame
    builds nothing and equals the first."""
    built = FP.champion_planes.builds
    log = []
    frame = FP.voronoi_frame(plan, sources, log=log)
    built = FP.champion_planes.builds - built
    before = FP.champion_planes.builds
    again = FP.voronoi_frame(plan, sources)
    assert FP.champion_planes.builds == before
    assert torch.equal(frame, again)
    return frame, log, built


def _stack_diff(plan, sources, frame):
    return float((frame - FP.multi_frame(plan, sources)).abs().max())


# (tests/test_torch_synopsis.py CASES entry, twine, degree or None, the
# kernels of the facets' launches)
ROUTES = {
    "untwined": ("voronoi, 3 rectilinear facets", 0, None,
                 ["resample_planar_chain"] * 3),
    "4 taps, degree 3": ("voronoi, 3 rectilinear facets", 2, None,
                         ["resample_twined_chain"] * 3),
    "9 taps, degree 1": ("voronoi, 3 rectilinear facets", 3, 1,
                         ["resample_twined_chain"] * 3),
    "lens and translated facets, 4 taps": (
        "voronoi, 2 lens facets and a translated facet", 2, None,
        ["resample_twined_chain"] * 2
        + ["resample_twined after the coordinate pass"]),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_voronoi_route_matches_jax_and_the_stack_route(name):
    """``voronoi_frame`` against the JAX ``render_frame`` (untwined 1e-5,
    twined the twined chain form's route bound) and against
    ``multi_frame`` (STACK_TOL; untwined bit for bit): F launches a
    frame, each facet's kernel in its champion or tapsel mode (the
    translated facet's planes form with its champion planes), the
    champion planes built by the first frame and by no later one, and
    ``stitch_frame`` taking this route."""
    import test_torch_synopsis as TSYN
    import test_torch_twined_stitch as TS
    from envutil_tpu.runtime.render import render_frame as jrender_frame
    case, twine, degree, kernels = ROUTES[name]
    c = dict(TSYN.CASES[case])
    if degree is not None:
        c["degree"] = degree
    spread = _spread(twine) if twine else None
    jsrcs, tsrcs, jplan, tplan = TSYN._stitch(c, spread)
    assert FP.champion_route(tplan, tsrcs) is None
    assert FP.exact_route(tplan, tsrcs) is None
    frame, log, built = _route(tplan, tsrcs)
    assert log == kernels and built == 1
    assert torch.equal(FP.stitch_frame(tplan, tsrcs), frame)
    diff = _stack_diff(tplan, tsrcs, frame)
    print(f"{name}: vs multi_frame {diff:.3e}")
    assert diff <= STACK_TOL and (twine or diff == 0.0)
    skip = (TS._excluded if twine else TSYN._excluded)(tplan, tsrcs).numpy()
    assert int(skip.sum()) <= MAX_EXCLUDED_PX * max(1, twine * twine)
    want = np.asarray(jrender_frame(jplan, jsrcs))
    err = float(np.abs(frame.numpy() - want).max(axis=-1)[~skip].max())
    tol = ROUTE_TOL + JAX_TOL if twine else JAX_TOL
    print(f"{name}: vs JAX {err:.3e} (bound {tol:g}), "
          f"{int(skip.sum())} px excluded")
    assert err <= tol
    assert (frame != 0).any(dim=-1).float().mean() > 0.1


def test_cube_source_stitch_takes_the_route():
    """A stitch of a cubemap source (the sources the JAX package leaves
    off its tapsel route for a Mosaic reason) and a partial facet,
    untwined and at 2x2 taps: the route against ``multi_frame`` within
    STACK_TOL (untwined bit for bit), the cube facet launched over the
    whole window (its source covers every ray: no coverage list, no
    tap test) on its champion list."""
    rng = np.random.default_rng(5)
    cube = facet(TP.CUBEMAP, 16, 96, 90.0, no=0)
    csrc = CBM.make_cubemap_source(cube, rng.uniform(
        0, 1, (6, 16, 16, 3)).astype(np.float32), 3, 3, 8, 16, device="cpu")
    csrc = dataclasses.replace(csrc, static=dataclasses.replace(
        csrc.static, brighten=0.5))
    rect = facet(TP.RECTILINEAR, 64, 48, 70.0, no=1, yaw=0.5)
    srcs = [csrc, source(rect)]
    for spread in (None, BOX2):
        plan = plan_of([cube, rect], TP.SPHERICAL, 96, 48, 360.0,
                       spread=spread)
        assert FP.block_list(FP.facet_plans(plan)[0], csrc) is None
        frame, log, built = _route(plan, srcs)
        assert built == 1 and None not in log
        champs = FP.champion_planes(plan, srcs)
        owned = [(champs.planes == f).any() for f in range(2)]
        assert all(bool(o) for o in owned)
        diff = _stack_diff(plan, srcs, frame)
        print(f"cube stitch, spread {spread is not None}: vs multi_frame "
              f"{diff:.3e}")
        assert diff <= STACK_TOL and (spread or diff == 0.0)


def _one_tap_scores(plan, sources):
    """(K, F, H, W): the voronoi scores the stack route's one-tap
    launches write (``fastpath.launch`` with a score plane)."""
    taps = [FP.facet_plans(plan)] if plan.spread is None else \
        [one for _w, one in FP.tap_plans(plan)]
    y0, y1, x0, x1 = FP.frame_window(plan)
    out = []
    for fplans in taps:
        per = []
        for fp, src in zip(fplans, sources):
            score = torch.empty((y1 - y0, x1 - x0))
            FP.launch(fp, src, torch.empty((y1 - y0, x1 - x0, 3)), score)
            per.append(score)
        out.append(torch.stack(per))
    return torch.stack(out)


def test_champion_planes_are_the_first_wins_argmax():
    """The champion planes (the champion pass's plain version, over each
    facet's coverage list) against numpy's argmax (the first of equal
    maxima) over the facets of the one-tap scores of the stack route,
    NO_CHAMPION where every score is LOWEST, untwined and at 2x2 taps;
    a facet repeated at the end ties with its first copy wherever it
    covers and never wins; ``torch.max``, the stack route's
    ``voronoi_stack``, takes the first maximum as well; and the champion
    lists are the blocks of each facet's champions."""
    fs = [facet(TP.RECTILINEAR, 64, 48, 70.0, no=i, yaw=y)
          for i, y in enumerate((-0.6, 0.0, 0.6))]
    fs.append(facet(TP.RECTILINEAR, 64, 48, 70.0, no=3, yaw=0.0))
    srcs = [source(f) for f in fs[:3]]
    srcs.append(srcs[1])
    for spread in (None, BOX2):
        plan = plan_of(fs, TP.SPHERICAL, 96, 48, 360.0, spread=spread)
        champs = FP.champion_planes(plan, srcs)
        scores = _one_tap_scores(plan, srcs).numpy()
        want = np.where(scores.max(axis=1) > SYN.LOWEST,
                        np.argmax(scores, axis=1), R.NO_CHAMPION)
        np.testing.assert_array_equal(champs.planes.numpy(), want)
        tied = scores[:, 3] == scores[:, 1]
        assert tied[scores[:, 1] > SYN.LOWEST].all()
        assert not (champs.planes == 3).any()
        _best, first = torch.max(torch.from_numpy(scores), dim=1)
        owned = scores.max(axis=1) > SYN.LOWEST
        np.testing.assert_array_equal(first.numpy()[owned], want[owned])
        nby, nbx = R.block_grid(48, 96)
        for f, blocks in enumerate(champs.lists):
            grid = torch.zeros((nby * 8, nbx * 32), dtype=torch.bool)
            grid[:48, :96] = torch.from_numpy(want == f).any(0)
            flags = grid.view(nby, 8, nbx, 32).any(3).any(1).reshape(-1)
            assert torch.equal(blocks.long(), torch.nonzero(flags)[:, 0])
        assert champs.lists[3].numel() == 0


def test_single_champion_blocks_equal_the_facets_own_launch():
    """In every 32x8 block where one facet champions every pixel at every
    tap, the twined frame (brightens 1.5, 1, 0.75) is bit-equal to that
    facet's own twined chain launch (``fastpath.chain_launch``, each tap
    tested against the window) times its brighten: its tapsel launch
    sums the same taps with the same weights."""
    fs = [facet(TP.RECTILINEAR, 64, 48, 70.0, no=i, yaw=y)
          for i, y in enumerate((-0.6, 0.0, 0.6))]
    srcs = [source(f) for f in fs]
    srcs = [dataclasses.replace(s, static=dataclasses.replace(
        s.static, brighten=b)) for s, b in zip(srcs, (1.5, 1.0, 0.75))]
    plan = plan_of(fs, TP.SPHERICAL, 384, 192, 360.0, spread=BOX2)
    frame = FP.voronoi_frame(plan, srcs)
    planes = FP.champion_planes(plan, srcs).planes
    h, w = frame.shape[:2]
    nby, nbx = R.block_grid(h, w)
    checked = 0
    for f, (fp, src) in enumerate(zip(FP.facet_plans(plan), srcs)):
        own = torch.empty_like(frame)
        FP.chain_launch(fp, src, own)
        own = own * src.static.brighten
        for b in range(nby * nbx):
            y, x = divmod(b, nbx)
            cell = (slice(8 * y, 8 * y + 8), slice(32 * x, 32 * x + 32))
            if bool((planes[(slice(None),) + cell] == f).all()):
                assert torch.equal(frame[cell], own[cell]), (f, b)
                checked += 1
    print(f"{checked} blocks championed by one facet at every tap")
    assert checked >= 3


def test_launches_and_builds_per_frame_and_band():
    """The launches and the builds: a frame makes F launches
    (``frame_tensor``'s log through ``stitch_frame``) and builds its
    champion planes once (``champion_planes.builds``), a plan made anew
    builds them anew; ``--mesh 4`` over CPU slots builds one set per
    band plan (each band a plan of its own), its
    frame bit-equal to the one-device frame, and builds nothing at its
    second frame; the verbose lines name the champion pass and each
    facet's mode and list; and voronoi_plus keeps the stack route."""
    import contextlib
    import io
    fs = [facet(TP.RECTILINEAR, 64, 48, 70.0, no=i, yaw=y)
          for i, y in enumerate((-0.6, 0.0, 0.6))]
    srcs = [source(f) for f in fs]
    plan = plan_of(fs, TP.SPHERICAL, 96, 48, 360.0, spread=BOX2)
    said = io.StringIO()
    built = FP.champion_planes.builds
    with contextlib.redirect_stdout(said):
        one = FP.render_fast(plan, srcs, verbose=True)
    assert FP.champion_planes.builds == built + 1
    text = said.getvalue()
    assert "champion pass: 3 facets x 4 taps" in text
    assert text.count("resample_twined_chain in its tapsel mode over") == 3
    assert "3 launches into one 48x96 frame, no stack, no combine" in text
    fresh = dataclasses.replace(plan)
    log = []
    assert torch.equal(FP.stitch_frame(fresh, srcs, log=log),
                       torch.from_numpy(one))
    assert len(log) == 3 and FP.champion_planes.builds == built + 2
    mesh = PM.make_mesh(["cpu"] * 4)
    before = FP.champion_planes.builds
    np.testing.assert_array_equal(FP.render_fast_mesh(plan, srcs, mesh),
                                  one)
    assert FP.champion_planes.builds == before + 4
    FP.render_fast_mesh(plan, srcs, mesh)
    assert FP.champion_planes.builds == before + 4
    alpha = dataclasses.replace(plan, nchannels=4)
    assert "no voronoi" in FP.champion_route(alpha, srcs)


@pytest.mark.cuda
def test_champion_kernels_match_plain_on_card():
    """On a card: the champion kernel's planes and lists against their
    plain versions (equal: the same scores by the same rounded steps;
    the plain version's transcendentals on the card are PyTorch's, so a
    pixel whose two best scores lie within 1e-6 relative may differ, and
    none does on these facets), and the chain forms' champion and tapsel
    modes against their plain versions on the same planes (within 1e-5:
    the kernels contract multiply-adds), float32 and bf16 tables
    (needs a CUDA card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    fs = [facet(TP.RECTILINEAR, 64, 48, 70.0, no=i, yaw=y, a=0.01,
                b=-0.02, c=0.005) for i, y in enumerate((-0.6, 0.0, 0.6))]
    for spread in (None, BOX2):
        plan = plan_of(fs, TP.SPHERICAL, 96, 48, 360.0, spread=spread)
        srcs = [source(f, "cuda") for f in fs]
        launches = R.champion_planes.launches
        champs = FP.champion_planes(plan, srcs)
        assert R.champion_planes.launches == launches + 3
        real = R.champion_planes, R.champion_lists
        R.champion_planes, R.champion_lists = (R.champion_planes_plain,
                                               R.champion_lists_plain)
        try:
            plain = FP.champion_planes(dataclasses.replace(plan), srcs)
        finally:
            R.champion_planes, R.champion_lists = real
        assert torch.equal(champs.planes, plain.planes)
        for a, b in zip(champs.lists, plain.lists):
            assert torch.equal(a, b)
        for dtype in (torch.float32, torch.bfloat16):
            for fi, (fp, src) in enumerate(zip(FP.facet_plans(plan), srcs)):
                src = dataclasses.replace(src, spl=dataclasses.replace(
                    src.spl, coeff=src.spl.coeff.to(dtype)))
                ops = FP.chain_operands(fp, src)
                args = [src.spl.coeff] + [ops.pop(k) for k in (
                    "xfeat", "yfeat", "bmats")]
                kw = dict(ops, blocks=champs.lists[fi], champ=champs.planes,
                          facet=fi, scale=1.5)
                if spread is None:
                    forms = (R.resample_planar_chain,
                             R.resample_planar_chain_plain)
                else:
                    args.append(kw.pop("spread"))
                    kw.update(tap_valid=False, accumulate=True)
                    forms = (R.resample_twined_chain,
                             R.resample_twined_chain_plain)
                got, want = (torch.full((48, 96, 3), 0.25, device="cuda")
                             for _ in forms)
                forms[0](got, *args, **kw)
                forms[1](want, *args, **kw)
                torch.cuda.synchronize()
                assert float((got - want).abs().max()) <= 1e-5, (fi, dtype)
