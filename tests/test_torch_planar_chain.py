"""The chain forms of the port's planar kernels (``resample_planar_chain``,
``resample_twined_chain``): the coordinate chain that each computes per
pixel, run as its plain version on the CPU, against the exact path's
coordinates of the same rays (the stepper's rays and
``environment.source_spline_coords``, computed here as the planes forms'
coordinate pass computed them for every plan) and against the JAX
``_coords``; and ``planar_frame`` through the chain forms against the
JAX ``render_frame``.

Every table is built by the JAX package and carried over as numpy
(``source_from_arrays``), so a comparison of frames is not also one of
prefilters.

Tolerances, each with its reason:

- coordinates: 2e-3 px, as ``test_coords_match_jax_coords`` in
  tests/test_torch_planar.py. The chain forms a ray from the axis
  features and one matrix (the inline kernel's target half) and maps
  model coordinates to the spline by one affine, where the coordinate
  pass takes the stepper's rays and ``_md_to_spline``; the JAX reference
  evaluates the source projection in float64. On coordinates up to a
  few hundred px these orders move them by ~1e-4 px; a convention slip
  shows as >= 0.5 px.
- validity masks: equal, except where a pixel's planar coordinate lies
  within 1e-5 model units of the window's edge (EDGE), where float32
  order decides the side; such pixels are counted, and held to a few
  per frame. IR pickups whose ray lies within 1e-5 (relative) of a cube
  face edge may take the other face and are excluded and counted the
  same way.
- whole frames against the JAX package: 1e-5 untwined, as
  tests/test_torch_planar.py; twined, the chain deflects in coordinate
  space where the exact path deflects the ray, and a full sphere seen
  through a fisheye lens is held to 5e-3, as
  ``test_planar_twined_full_sphere_route`` in
  tests/test_torch_twining.py.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import oracle as O
from test_golden_oracle import make_args, make_facet, synthetic_equirect
from test_torch_render import port_args, port_facet

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.models import cubemap as JCBM
from envutil_tpu.models import environment as JE
from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core import geometry as geo
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import stepper as ST
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.ops import spline as S
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import build_plan

torch.set_num_threads(1)

COORD_TOL = 2e-3
EDGE = 1e-5
MAX_EDGE_PX = 8
JAX_TOL = 1e-5
TWINED_SPHERE_TOL = 5e-3
BOX2 = O.make_spread(2, 2, 1.0)
BOX3 = O.make_spread(3, 3, 1.0)

# (source, target): a mount source is (projection, w, h, hfov in
# degrees, facet attributes); "biatan6" is an IR source of 64-px faces.
# The seven targets and the five mount projections each appear, with
# the lens polynomial, shift, shear, partial facets and a full fisheye.
COORD_CASES = {
    "rect-lens>spherical": (
        (JP.RECTILINEAR, 64, 48, 72.0, dict(a=0.01, b=-0.02, c=0.005,
                                            yaw=0.35, pitch=0.1)),
        (TP.SPHERICAL, 96, 48, 360.0, (0.0, 0.0, 0.0))),
    "ster-shift>cylindrical": (
        (JP.STEREOGRAPHIC, 64, 64, 160.0, dict(h=3.0, v=-2.0, yaw=0.3)),
        (TP.CYLINDRICAL, 64, 48, 200.0, (30.0, 10.0, 0.0))),
    "cyl-shear>rectilinear": (
        (JP.CYLINDRICAL, 96, 48, 200.0, dict(shear_g=0.01, shear_t=-0.02,
                                             yaw=0.8)),
        (TP.RECTILINEAR, 64, 48, 100.0, (60.0, 5.0, 0.0))),
    "fullfish>stereographic": (
        (JP.FISHEYE, 64, 64, 360.0, dict(pitch=0.2)),
        (TP.STEREOGRAPHIC, 64, 48, 150.0, (35.0, 20.0, 0.0))),
    "sph-partial>fisheye": (
        (JP.SPHERICAL, 96, 64, 200.0, dict(yaw=-0.5)),
        (TP.FISHEYE, 48, 48, 170.0, (80.0, 0.0, 0.0))),
    "fish-lens>cubemap": (
        (JP.FISHEYE, 64, 64, 180.0, dict(a=-0.01, b=0.02, c=-0.01,
                                         roll=0.2)),
        (TP.CUBEMAP, 16, 96, 90.0, (10.0, -5.0, 0.0))),
    "biatan6>biatan6": ("biatan6", (TP.BIATAN6, 16, 96, 90.0,
                                    (5.0, 5.0, 5.0))),
}


def _crossover(jsrc):
    spl = jsrc.spl
    return TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(jsrc.static), spl.pad,
        spl.degree, spl.bcs, spl.core_shape, spl.spherical, device="cpu")


def _job(source, target, degree=3, nch=3, spread=None, precise=False):
    """(JAX source, port source, JAX plan, port plan) of one job; the
    port's table is the JAX one."""
    rng = np.random.default_rng(11)
    if source == "biatan6":
        geom, kw = (JP.BIATAN6, 64, 384, math.radians(100)), {}
        faces = rng.uniform(0, 1, (6, 64, 64, nch)).astype(np.float32)
        jsrc = JCBM.make_cubemap_source(make_facet(*geom), faces, degree,
                                        degree, support_min=8, tile_size=64)
    elif source == "sphere":
        geom, kw = (JP.SPHERICAL, 256, 128, 2 * math.pi), {}
        jsrc = JE.make_mount_source(make_facet(*geom), synthetic_equirect(),
                                    degree, degree)
    else:
        proj, w, h, hfov, kw = source
        geom = (proj, w, h, math.radians(hfov))
    jf, tf = make_facet(*geom), port_facet(TP(int(geom[0])), *geom[1:])
    for f in (jf, tf):
        for k, v in kw.items():
            setattr(f, k, v)
        f.process_geometry()
    if source not in ("biatan6", "sphere"):
        img = rng.uniform(0, 1, (geom[2], geom[1], nch)).astype(np.float32)
        jsrc = JE.make_mount_source(jf, img, degree, degree)
    tproj, w, h, hfov, ypr = target
    jargs = make_args(JP(int(tproj)), w, h, hfov, [jf], degree=degree,
                      yaw=ypr[0], pitch=ypr[1], roll=ypr[2])
    targs = port_args(tproj, w, h, hfov, [tf], degree, *ypr)
    for a in (jargs, targs):
        a.nchannels = nch
        if spread is not None:
            a.twine, a.twine_spread = 1, list(spread)
            a.twine_precise = precise
    return jsrc, _crossover(jsrc), jbuild_plan(jargs, [jf]), \
        build_plan(targs, [tf])


def _near_window_edge(pick, ray):
    """Pixels whose mount planar coordinate lies within EDGE of the
    window's edge (or, for a rectilinear source, whose z is within EDGE
    of 0)."""
    px, py, _hit = R.mount_planar(pick, *ray)
    x0, x1, y0, y1 = pick.window
    near = torch.zeros_like(px, dtype=torch.bool)
    for v, e in ((px, x0), (px, x1), (py, y0), (py, y1)):
        near |= (v - e).abs() <= EDGE
    if pick.projection == int(TP.RECTILINEAR):
        near |= ray[2].abs() <= EDGE
    return near


def _near_face_edge(ray):
    a = torch.stack([r.abs() for r in ray])
    top2 = torch.topk(a, 2, dim=0).values
    return (top2[0] - top2[1]) <= EDGE * top2[0]


def _exact_rays(plan, window, bias=(0.0, 0.0)):
    return ST.target_rays(plan.projection, plan.width, plan.height,
                          plan.extent, basis=plan.bases[0], bias=bias,
                          window=window)


def _exact_coords(plan, window, src):
    """The exact path's padded, gated coordinates and validity of the
    plan's rays: the stepper's rays, ``source_spline_coords``, the gates
    and the pad."""
    spl = src.spl
    sx, sy, mask = TE.source_spline_coords(src, _exact_rays(plan, window))
    h, w = spl.core_shape
    return (S.gate(sx, spl.bcs[1], w) + spl.pad,
            S.gate(sy, spl.bcs[0], h) + spl.pad, mask)


def _exact_twined_operands(plan, window, src):
    """The twined planes form's operands from the exact path's rays and
    pickups: the stepper's ninepack and derivative rays; an IR source's
    three pickups in the centre ray's face (past its edge they run on
    into the section's support frame); x derivatives wrapped by a
    periodic source's width; non-finite derivatives 0; the ungated,
    padded centre; for a source that does not cover every ray, each
    tap's deflected validity."""
    spl, st = src.spl, src.static
    pad, w = spl.pad, spl.core_shape[1]
    p0, p10, p01 = ST.target_ninepack(
        plan.projection, plan.width, plan.height, plan.extent,
        basis=plan.bases[0], window=window)
    du, dv = SYN.derivative_rays(p0, p10, p01, plan.twine_precise)
    if plan.twine_precise:
        p10 = tuple(a + b for a, b in zip(p0, du))
        p01 = tuple(a + b for a, b in zip(p0, dv))
    if st.kind == "cubemap":
        face = geo.ray_to_cubeface(*p0)[0]

        def pickup(ray):
            fx, fy = geo.ray_to_cubeface_fixed(*ray, face)
            if st.projection == TP.BIATAN6:
                fx = (4.0 / math.pi) * torch.atan(fx)
                fy = (4.0 / math.pi) * torch.atan(fy)
            return st.metrics.get_pickup_coordinate_px(face, fx, fy)
    else:
        def pickup(ray):
            return TE.source_spline_coords(src, ray)[:2]
    x0, y0 = pickup(p0)
    periodic = st.kind != "cubemap" and spl.bcs[1] == S.PERIODIC

    def derivative(ray):
        x, y = pickup(ray)
        dx, dy = x - x0, y - y0
        if periodic:
            dx = torch.remainder(dx + 0.5 * w, float(w)) - 0.5 * w
        return (torch.nan_to_num(dx, 0.0, 0.0, 0.0),
                torch.nan_to_num(dy, 0.0, 0.0, 0.0))

    dux, duy = derivative(p10)
    dvx, dvy = derivative(p01)
    tap_weights = None
    if not FP._covers_every_ray(src):
        tap_weights = torch.stack([
            TE.source_spline_coords(src, SYN.deflect(p0, du, dv, cx, cy))[2]
            for cx, cy, _w in SYN.scaled_spread(plan.spread)]
        ).to(torch.uint8)
    return dict(sx=x0 + pad, sy=y0 + pad, dux=dux, duy=duy, dvx=dvx,
                dvy=dvy, tap_weights=tap_weights,
                wrap_x=(pad - 0.5, float(w)) if periodic else None)


@pytest.mark.parametrize("case", sorted(COORD_CASES))
def test_chain_coords_match_coords_and_jax(case):
    """The planar chain's coordinates and validity (``planar_chain_coords``
    from ``chain_operands``) against the exact path's coordinates of the
    stepper's rays and against the JAX ``_coords``, as
    ``test_coords_match_jax_coords`` runs it."""
    source, target = COORD_CASES[case]
    jsrc, tsrc, jplan, tplan = _job(source, target)
    h, w = tplan.height, tplan.width
    window = (0, h, 0, w)
    ops = FP.chain_operands(tplan, tsrc)
    pick = ops["pick"]
    sx, sy, mask = R.planar_chain_coords(
        ops["xfeat"], ops["yfeat"], ops["bmats"], tmode=ops["tmode"],
        pick=pick, row0=ops["row0"], face_rows=ops["face_rows"])
    psx, psy, pmask = _exact_coords(tplan, window, tsrc)
    jsx, jsy, jmask, _z = JFP._coords(JFP._geom_static(jplan), window,
                                      "orig", jsrc, 0, (0.0, 0.0),
                                      JFP._basis_arg(jplan, 0))
    jsx, jsy, jmask = (torch.from_numpy(np.array(a)) for a in
                       (jsx, jsy, jmask))
    ray = _exact_rays(tplan, window)
    edge = _near_face_edge(ray) if pick.smode != "mount" \
        else _near_window_edge(pick, ray)
    for name, (ox, oy, om) in (("the exact path", (psx, psy, pmask)),
                               ("JAX _coords", (jsx, jsy, jmask))):
        differ = mask != om
        assert not bool((differ & ~edge).any()), \
            f"{case}: masks differ from {name} away from a window edge"
        assert int(differ.sum()) <= MAX_EDGE_PX
        both = mask & om & ~edge
        assert bool(both.any())
        for a, b in ((sx, ox), (sy, oy)):
            err = float((a[both] - b[both].to(a.dtype)).abs().max())
            assert err <= COORD_TOL, f"{case} vs {name}: {err} px"
    if pick.smode == "mount" and case != "fullfish>stereographic":
        assert 0.02 < float(mask.float().mean()) < 0.98, \
            f"{case}: the facet covers part of the view"
    print(f"{case}: {int(edge.sum())} px at a window or face edge")


TWINED_CASES = {
    "biatan6>stereographic": ("biatan6", (TP.STEREOGRAPHIC, 48, 32, 150.0,
                                          (35.0, 20.0, 0.0)), BOX3, False),
    "sphere>fisheye-precise": ("sphere", (TP.FISHEYE, 48, 48, 120.0,
                                          (170.0, 10.0, 0.0)), BOX2, True),
    "rect-lens>spherical": (COORD_CASES["rect-lens>spherical"][0],
                            COORD_CASES["rect-lens>spherical"][1], BOX3,
                            False),
    "fullfish>stereographic": (COORD_CASES["fullfish>stereographic"][0],
                               COORD_CASES["fullfish>stereographic"][1],
                               BOX2, False),
}


@pytest.mark.parametrize("case", sorted(TWINED_CASES))
def test_twined_chain_operands_match_twined_coords(case):
    """Every operand the twined chain computes per pixel
    (``twined_chain_operands``: centre coordinates, coordinate
    derivatives, per-tap validity, wrap) against the same operands from
    the exact path's rays and pickups (forced-face pickups of a cubemap
    source, the periodic wrap of a full sphere under --twine_precise, the
    tap validity of a lens-corrected partial facet, none for a full
    fisheye)."""
    source, target, spread, precise = TWINED_CASES[case]
    _jsrc, tsrc, _jplan, tplan = _job(source, target, spread=spread,
                                      precise=precise)
    h, w = tplan.height, tplan.width
    window = (0, h, 0, w)
    ops = FP.chain_operands(tplan, tsrc)
    got = R.twined_chain_operands(
        ops["xfeat"], ops["yfeat"], ops["bmats"], ops["spread"],
        tmode=ops["tmode"], pick=ops["pick"], row0=ops["row0"],
        face_rows=ops["face_rows"], precise=precise,
        tap_valid=ops["tap_valid"])
    want = _exact_twined_operands(tplan, window, tsrc)
    assert got["wrap_x"] == want["wrap_x"]
    assert (got["tap_weights"] is None) == (want["tap_weights"] is None) \
        == (source in ("biatan6", "sphere") or case.startswith("fullfish"))
    p0, p10, p01 = ST.target_ninepack(
        tplan.projection, w, h, tplan.extent, basis=tplan.bases[0],
        window=window)
    compare = torch.ones((h, w), dtype=torch.bool)
    if source == "biatan6":
        compare = ~(_near_face_edge(p0) | _near_face_edge(p10)
                    | _near_face_edge(p01))
    if want["tap_weights"] is not None:
        du, dv = SYN.derivative_rays(p0, p10, p01, precise)
        edge = torch.zeros((len(spread), h, w), dtype=torch.bool)
        for k, (cx, cy, _w) in enumerate(SYN.scaled_spread(spread)):
            edge[k] = _near_window_edge(ops["pick"],
                                        SYN.deflect(p0, du, dv, cx, cy))
        differ = got["tap_weights"] != want["tap_weights"]
        assert not bool((differ & ~edge).any())
        assert int(differ.sum()) <= MAX_EDGE_PX
        compare = (want["tap_weights"].sum(dim=0) > 0) \
            & ~edge.any(dim=0)
    assert bool(compare.any())
    for k in ("sx", "sy", "dux", "duy", "dvx", "dvy"):
        err = float((got[k] - want[k])[compare].abs().max())
        assert err <= COORD_TOL, f"{case}: {k} differs by {err} px"


FRAME_CASES = {
    "fullfish-shift-shear>stereographic, degree 1, 4 channels": (
        (JP.FISHEYE, 64, 64, 360.0, dict(h=2.0, v=1.0, shear_g=0.01,
                                         shear_t=0.02, yaw=0.4)),
        (TP.STEREOGRAPHIC, 48, 32, 140.0, (20.0, 10.0, 0.0)), 1, 4, None,
        JAX_TOL),
    "sphere>fisheye twined, precise": (
        "sphere", (TP.FISHEYE, 48, 48, 120.0, (170.0, 10.0, 0.0)), 3, 3,
        BOX2, TWINED_SPHERE_TOL),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_chain_frame_matches_jax(case):
    """``planar_frame`` through a chain form (its plain version on the
    CPU) against the JAX ``render_frame`` of the same job."""
    source, target, degree, nch, spread, tol = FRAME_CASES[case]
    jsrc, tsrc, jplan, tplan = _job(source, target, degree, nch, spread,
                                    precise=spread is not None)
    assert tplan.planar_to_ray[0] is None and \
        FP.inline_mode(tplan, tsrc) is None
    want = np.asarray(jrender_frame(jplan, [jsrc]))
    got = FP.planar_frame(tplan, tsrc, device="cpu").numpy()
    assert got.shape == want.shape == (tplan.height, tplan.width, nch)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert 0.0 < float((got != 0).any(axis=-1).mean())


@pytest.mark.cuda
def test_chain_kernels_match_plain_on_card():
    """The two chain kernels against their plain versions on the card,
    with their launch counts: a partial lens facet to a stereographic
    view, a full fisheye to a cubemap view, a biatan6 source to a fisheye
    view, untwined and twined (needs a CUDA card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    for source, target in (COORD_CASES["rect-lens>spherical"],
                           COORD_CASES["fish-lens>cubemap"],
                           ("biatan6", (TP.FISHEYE, 48, 48, 170.0,
                                        (10.0, 20.0, 0.0)))):
        for spread in (None, BOX3):
            _jsrc, tsrc, _jplan, tplan = _job(source, target, spread=spread)
            spl = tsrc.spl
            src = dataclasses.replace(tsrc, spl=dataclasses.replace(
                spl, coeff=spl.coeff.cuda()))
            ops = FP.chain_operands(tplan, src)
            args = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
            shape = (tplan.height, tplan.width, spl.coeff.shape[-1])
            out = torch.full(shape, float("nan"), device="cuda")
            if spread is None:
                wrapper = R.resample_planar_chain
                plain = R.resample_planar_chain_plain
            else:
                args.append(ops.pop("spread"))
                wrapper = R.resample_twined_chain
                plain = R.resample_twined_chain_plain
            before = wrapper.launches
            k = wrapper(out.clone(), src.spl.coeff, *args, **ops)
            p = plain(out.clone(), src.spl.coeff, *args, **ops)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert bool(torch.isfinite(k).all())
            assert float((k - p).abs().max()) <= 1e-3
