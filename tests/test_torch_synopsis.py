"""The port's multi-facet synopses (``models/synopsis``: voronoi,
voronoi_plus, hdr_merge) on the CPU: stitches rendered by the port's
``render_frame(device="cpu")`` (the exact path) against the JAX
package's ``render_frame``, and by ``fastpath.multi_frame`` (the card
route: one kernel launch per facet, run here as the kernels' plain
versions, and the combine of the stacks) against the port's exact path.

Every table is built by the JAX package and carried over as numpy
(``source_from_arrays``), so a comparison of frames is not also one of
prefilters.

Tolerances, each with its reason:

- frames against the JAX package: 1e-5, as the single-facet slices
  (tests/test_torch_render.py).
- frames of the card route against the port's exact path: 5e-5. The
  chain forms each ray from the axis features and one rotation where
  the exact path takes the stepper's grid, ~1e-6 px apart; times the
  spline gradient of the seeded-noise facets (prefiltered coefficients
  reach ~+-3) that is a few 1e-6 to 1e-5, while a wrong champion or
  pickup shows as O(0.1).
- In both, two kinds of pixel are excluded and counted, and their
  count is held to a few per frame: a pixel whose two best voronoi
  scores lie within SCORE_REL of each other, where an ulp of the ray
  decides the champion (the JAX reference carries float64 after the
  basis rotation under the tests' x64 mode, and the chain forms each
  ray from the axis features); and a pixel whose planar coordinate in some facet lies within EDGE
  model units of that facet's window edge, where an ulp decides whether
  the facet covers it (as tests/test_torch_planar_chain.py).
- twined stitch on the exact path: 1e-5 as well; the exact path
  deflects the same rays in both packages. Its card route deflects in
  coordinate space: tests/test_torch_twined_stitch.py states that bound.
- score planes: 1e-6 (relative to scores of order recip_step): z of a
  normalised float32 ray in another order times recip_step.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_golden_oracle import make_args, make_facet, synthetic_equirect
from test_torch_render import port_args, port_facet

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.models import environment as JE
from envutil_tpu.models import stepper as JST
from envutil_tpu.models import synopsis as JSYN
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import stepper as ST
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

JAX_TOL = 1e-5
ROUTE_TOL = 5e-5
SCORE_TOL = 1e-6
SCORE_REL = 1e-6
EDGE = 1e-5
MAX_EXCLUDED_PX = 24

# facet: (projection, w, h, hfov in degrees, attributes); "sphere" is
# the golden fixture's full equirect; brightens default to 1
LENS = dict(a=0.01, b=-0.02, c=0.005)
CASES = {
    "voronoi, 3 rectilinear facets": dict(
        facets=[(JP.RECTILINEAR, 64, 48, 70.0, dict(yaw=math.radians(y)))
                for y in (-40.0, 0.0, 40.0)],
        target=(TP.SPHERICAL, 96, 48, 360.0, (0.0, 0.0, 0.0)), degree=3),
    "voronoi, 2 lens facets and a translated facet": dict(
        facets=[(JP.RECTILINEAR, 64, 48, 72.0,
                 dict(LENS, yaw=math.radians(y))) for y in (-35.0, 35.0)]
        + [(JP.RECTILINEAR, 64, 48, 72.0,
            dict(tr_x=0.15, tr_y=-0.05, tr_z=0.1, pitch=math.radians(10)))],
        target=(TP.RECTILINEAR, 96, 48, 140.0, (0.0, 5.0, 0.0)), degree=1),
    "voronoi_plus, 4 channels": dict(
        facets=[(JP.RECTILINEAR, 64, 48, 80.0, dict(yaw=math.radians(y)))
                for y in (-30.0, 0.0, 30.0)],
        target=(TP.SPHERICAL, 96, 48, 360.0, (0.0, 0.0, 0.0)), degree=3,
        nch=4),
    "hdr_merge, 3 full-spherical brackets": dict(
        facets=["sphere"] * 3, brightens=(2.0, 1.0, 1.5),
        target=(TP.RECTILINEAR, 96, 48, 100.0, (30.0, 10.0, 0.0)),
        degree=3, synopsis="hdr_merge"),
    "hdr_merge, 3 partial brackets": dict(
        facets=[(JP.RECTILINEAR, 64, 48, 72.0, dict(yaw=0.3))] * 3,
        brightens=(1.5, 1.0, 2.0),
        target=(TP.RECTILINEAR, 96, 48, 110.0, (10.0, 0.0, 0.0)),
        degree=1, synopsis="hdr_merge"),
}


def _crossover(jsrc):
    spl = jsrc.spl
    return TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(jsrc.static), spl.pad,
        spl.degree, spl.bcs, spl.core_shape, spl.spherical, device="cpu")


def _stitch(case, spread=None, precise=False, jax=True):
    """(JAX sources, port sources, JAX plan, port plan) of a CASES
    entry (or of such a dict), twined by ``spread`` (``precise``:
    --twine_precise) where given; the images are seeded noise (facets)
    or the golden fixture (spheres), each bracket scaled by 1/brighten
    and brightened back. Without ``jax`` the port builds its sources
    from the same images and the JAX entries are None."""
    c = CASES[case] if isinstance(case, str) else case
    rng = np.random.default_rng(21)
    nch, degree = c.get("nch", 3), c["degree"]
    brightens = c.get("brightens", (1.0,) * len(c["facets"]))
    jfs, tfs, jsrcs = [], [], []
    for i, (spec, b) in enumerate(zip(c["facets"], brightens)):
        if spec == "sphere":
            spec = (JP.SPHERICAL, 256, 128, 360.0, {})
            img = synthetic_equirect()
        else:
            img = rng.uniform(0, 1, (spec[2], spec[1], nch)).astype(
                np.float32)
            if nch == 4:     # associated alpha
                img[..., 3] = rng.uniform(0.3, 1.0, img.shape[:2])
                img[..., :3] *= img[..., 3:]
        proj, w, h, hfov, kw = spec
        jf = make_facet(proj, w, h, math.radians(hfov), no=i, **kw)
        tf = port_facet(TP(int(proj)), w, h, math.radians(hfov))
        tf.facet_no = i
        for k, v in kw.items():
            setattr(tf, k, v)
        tf.process_geometry()
        make = JE.make_mount_source if jax else functools.partial(
            TE.make_mount_source, device="cpu")
        src = make(jf if jax else tf, img / b, degree, degree)
        src.static = dataclasses.replace(src.static, brighten=b)
        jfs.append(jf)
        tfs.append(tf)
        jsrcs.append(src)
    tproj, w, h, hfov, ypr = c["target"]
    synopsis = c.get("synopsis", "panorama")
    jargs = make_args(JP(int(tproj)), w, h, hfov, jfs, degree=degree,
                      yaw=ypr[0], pitch=ypr[1], roll=ypr[2],
                      synopsis=synopsis, twine_spread=spread)
    targs = port_args(tproj, w, h, hfov, tfs, degree, *ypr,
                      twine_spread=spread)
    for a in (jargs, targs):
        a.nchannels, a.synopsis, a.solo = nch, synopsis, -1
        a.twine_precise = precise
    if not jax:
        return None, jsrcs, None, build_plan(targs, tfs)
    return (jsrcs, [_crossover(s) for s in jsrcs], jbuild_plan(jargs, jfs),
            build_plan(targs, tfs))


def _excluded(plan, sources):
    """(H, W) pixels excluded from the frame comparisons: near-tied
    voronoi scores (not for hdr_merge) and window edges, from the port's
    exact rays."""
    rays = [ST.target_rays(plan.projection, plan.width, plan.height,
                           plan.extent, basis=b, planar_to_ray=p)
            for b, p in zip(plan.bases, plan.planar_to_ray)]
    out = torch.zeros((plan.height, plan.width), dtype=torch.bool)
    scores = []
    for src, ray in zip(sources, rays):
        pick = FP._pickup(src)
        px, py, hit = R.mount_planar(pick, *ray)
        x0, x1, y0, y1 = pick.window
        for v, e in ((px, x0), (px, x1), (py, y0), (py, y1)):
            out |= (v - e).abs() <= EDGE
        if pick.projection == int(TP.RECTILINEAR):
            out |= ray[2].abs() <= EDGE
        scores.append(SYN.facet_score(ray[2], hit, src.static.recip_step))
    if plan.synopsis != "hdr_merge":
        top2 = torch.topk(torch.stack(scores), 2, dim=0).values
        live = top2[1] > SYN.LOWEST
        out |= live & ((top2[0] - top2[1]).abs()
                       <= SCORE_REL * top2[0].abs())
    return out


def _assert_close(got, want, keep, what, tol=JAX_TOL):
    diff = np.abs(got - want).max(axis=-1)
    err = float(diff[keep].max())
    assert err <= tol, f"{what}: {err:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_stitch_matches_jax(case):
    """The stitch through the port's exact path against the JAX exact
    path, and through ``multi_frame`` (the card route's kernels as their
    plain versions, then the combine) against the port's exact path."""
    jsrcs, tsrcs, jplan, tplan = _stitch(case)
    want = np.asarray(jrender_frame(jplan, jsrcs))
    got = render_frame(tplan, tsrcs, device="cpu")
    assert got.shape == want.shape == (tplan.height, tplan.width,
                                       tplan.nchannels)
    skip = _excluded(tplan, tsrcs).numpy()
    n_skip = int(skip.sum())
    print(f"{case}: {n_skip} px excluded (near-tied scores, window edges)")
    assert n_skip <= MAX_EXCLUDED_PX
    _assert_close(got, want, ~skip, f"{case} vs JAX")
    log = []
    fast = FP.multi_frame(tplan, tsrcs, device="cpu", log=log).numpy()
    _assert_close(fast, got, ~skip, f"{case}: multi_frame vs exact path",
                  ROUTE_TOL)
    if tplan.synopsis == "hdr_merge":
        full = tsrcs[0].spl.spherical
        assert log == ["resample_inline" if full
                       else "resample_planar_chain"] * 3
    else:
        assert all(w.startswith("resample_planar") for w in log)
    covered = (got != 0).any(axis=-1).mean()
    assert 0.1 < covered, f"{case}: the stitch covers {covered:.0%}"


def test_twined_stitch_exact_path_matches_jax():
    """A twined voronoi stitch (2x2 box) on the exact path: every tap's
    rays through the synopsis, as the JAX package twines it; the card
    route (``render_fast``: one one-tap launch of the twined chain form
    per facet and tap, as plain versions here) renders it too, within
    the bound of its coordinate-space deflection
    (tests/test_torch_twined_stitch.py, which holds the route over the
    synopses)."""
    from test_torch_twined_stitch import ROUTE_TOL as TWINED_ROUTE_TOL
    spread = [[-0.25, -0.25, 0.25], [0.25, -0.25, 0.25],
              [-0.25, 0.25, 0.25], [0.25, 0.25, 0.25]]
    jsrcs, tsrcs, jplan, tplan = _stitch("voronoi, 3 rectilinear facets",
                                         spread)
    want = np.asarray(jrender_frame(jplan, jsrcs))
    got = render_frame(tplan, tsrcs, device="cpu")
    skip = _excluded(tplan, tsrcs).numpy()
    assert int(skip.sum()) <= MAX_EXCLUDED_PX
    _assert_close(got, want, ~skip, "twined stitch vs JAX")
    assert FP.uncovered(tplan, tsrcs) is None
    _assert_close(FP.render_fast(tplan, tsrcs), got, ~skip,
                  "twined stitch through the card route vs the exact path",
                  TWINED_ROUTE_TOL)


def test_multi_frame_stacks_match_jax_combine_inputs():
    """The card route's per-facet slots and score planes (``facet_into``
    with a score: the planar chain form's score output for the lens
    facets, the coordinate pass's z for the translated facet) against
    the inputs of the JAX ``_combine_stack`` for the same rays (pixels,
    masks and scores of ``synopsis._eval_all``), and the port's combine
    of the stacks against the JAX ``voronoi_stack`` of those inputs."""
    jsrcs, tsrcs, jplan, tplan = _stitch(
        "voronoi, 2 lens facets and a translated facet")
    h, w = tplan.height, tplan.width
    jrays = [JST.target_rays(jplan.projection, w, h, jplan.extent, basis=b,
                             normalize=True, planar_to_ray=p)
             for b, p in zip(jplan.bases, jplan.planar_to_ray)]
    jpx, jmask, jscore = (np.asarray(a) for a in JSYN._eval_all(
        jsrcs, jrays, tplan.nchannels))
    skip = _excluded(tplan, tsrcs)
    stack = torch.empty((3, h, w, 3))
    score = torch.empty((3, h, w))
    for fi, (fplan, src) in enumerate(zip(FP.facet_plans(tplan), tsrcs)):
        FP.facet_into(fplan, src, stack[fi], score[fi])
        assert (fplan.planar_to_ray[0] is None) == (fi < 2)
        keep = (~skip).numpy()
        assert np.array_equal((score[fi] > SYN.LOWEST).numpy()[keep],
                              jmask[fi][keep])
        live = keep & jmask[fi]
        assert live.mean() > 0.05
        np.testing.assert_allclose(score[fi].numpy()[live],
                                   jscore[fi][live], rtol=SCORE_TOL, atol=0)
        assert (score[fi].numpy()[~jmask[fi] & keep] == SYN.LOWEST).all()
        np.testing.assert_allclose(stack[fi].numpy()[keep], jpx[fi][keep],
                                   rtol=0, atol=ROUTE_TOL)
    got = SYN.voronoi_stack(stack, None, score).numpy()
    want = np.asarray(JSYN.voronoi_stack(jnp.asarray(jpx),
                                         jnp.asarray(jmask),
                                         jnp.asarray(jscore)))
    _assert_close(got, want, (~skip).numpy(), "combine vs JAX voronoi_stack",
                  ROUTE_TOL)
    # the planar chain form's pixels do not depend on the score output
    fplan, src = FP.facet_plans(tplan)[0], tsrcs[0]
    bare = torch.empty((h, w, 3))
    FP.chain_launch(fplan, src, bare)
    assert torch.equal(bare, stack[0])


def test_ties_resolve_as_in_jax():
    """Equal scores: ``torch.argmax`` and ``torch.max`` take the first
    maximum, as ``jnp.argmax`` does, and the depth order of voronoi_plus
    is that of a stable sort; both combines equal the JAX ones bit for
    bit, with the masks given and derived from the scores."""
    rng = np.random.default_rng(5)
    score = rng.integers(0, 3, (4, 6, 7)).astype(np.float32)
    score[1, :2] = score[2, :2] = score[0, :2] = 2.0   # three-way ties
    score[:, 5, 6] = SYN.LOWEST                         # no facet valid
    mask = score > SYN.LOWEST
    px = rng.uniform(0, 1, (4, 6, 7, 4)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (px, mask, score)]
    j = [jnp.asarray(a) for a in (px, mask, score)]
    champion = torch.argmax(t[2], dim=0)
    np.testing.assert_array_equal(champion.numpy(),
                                  np.asarray(jnp.argmax(j[2], axis=0)))
    assert (champion[:2] == 0).all()
    assert torch.equal(torch.max(t[2], dim=0).indices, champion)
    np.testing.assert_array_equal(
        SYN.depth_order(t[2]).numpy(),
        torch.argsort(-t[2], dim=0, stable=True).numpy())
    for port, ref in ((SYN.voronoi_stack, JSYN.voronoi_stack),
                      (SYN.voronoi_plus_stack, JSYN.voronoi_plus_stack)):
        want = np.asarray(ref(*j))
        np.testing.assert_array_equal(port(*t).numpy(), want)
        # the card route's form: validity from the scores themselves
        np.testing.assert_array_equal(port(t[0], None, t[2]).numpy(), want)
