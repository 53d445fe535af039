"""Twined routes of the port held to JAX and to the port's exact path: a
partial lens facet through the chain form, the inline twined route
(K4's plain version) at poles, seam and cube rows, the planar twined
route on a cubemap source and on a full sphere. The helpers and the
bounds are test_torch_twining's.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_render import port_args, port_facet

from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core import geometry as geo
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import stepper as ST
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import build_plan, render_frame

from test_torch_twining import (
    BOX2, BOX3, INLINE_ROUTES, INLINE_ROUTE_TOL, JAX_TOL, PLANAR_ROUTE_TOL,
    POLAR_TOL, _cubemap_sources, _twined_args, _twined_operands, env,
    facet_job,
)


def test_twined_facet_matches_jax_and_route(facet_job):
    """The partial and the translated facet twined: the exact path
    against the JAX package (each tap masked by its own deflected
    validity), and ``planar_frame`` (the coordinate pass at three grids,
    per-tap validity planes and the planar twined kernel's plain version)
    against the exact path."""
    want = np.asarray(jrender_frame(facet_job["jplan"], [facet_job["jsrc"]]))
    plan, src = facet_job["tplan"], facet_job["tsrc"]
    got = render_frame(plan, [src], device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    covered = (got != 0).any(axis=-1).mean()
    assert 0.02 < covered < 0.98, "the facet covers part of the view"

    ops = _twined_operands(plan, src)
    count = ops["tap_weights"].sum(dim=0)
    assert ops["tap_weights"].dtype == torch.uint8 and ops["wrap_x"] is None
    assert int(((count > 0) & (count < 9)).sum()) > 0, \
        "some pixels at the facet's edge have valid and invalid taps"
    buf = torch.full(got.shape, float("nan"))
    fast = FP.planar_frame(plan, src, out=buf, device="cpu")
    assert fast is buf
    np.testing.assert_allclose(fast.numpy(), got, rtol=0,
                               atol=PLANAR_ROUTE_TOL[facet_job["kind"]])
    # where no tap is valid both are exactly 0
    none = (count == 0).numpy()
    assert not got[none].any() and not fast.numpy()[none].any()
    with pytest.raises(ValueError, match="planar_frame"):
        FP.fused_frame(plan, src)


@pytest.mark.parametrize("name,proj,w,h,hfov,ypr,precise", INLINE_ROUTES,
                         ids=[c[0] for c in INLINE_ROUTES])
def test_inline_twined_route_matches_exact_path(env, name, proj, w, h, hfov,
                                                ypr, precise):
    """``fused_frame`` twined (the inline twined kernel's plain version)
    against the port's exact path, seam, pole and cube rows included:
    both deflect the ray, so nothing is special there."""
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    src = TE.make_mount_source(tf, env, 3, 3, device="cpu")
    plan = build_plan(_twined_args(port_args, proj, w, h, hfov, [tf], 3,
                                   *ypr, spread=BOX3, precise=precise), [tf])
    want = render_frame(plan, [src], device="cpu")
    if name.startswith("pole"):
        ray = ST.target_rays(plan.projection, w, h, plan.extent,
                             basis=plan.bases[0])
        lon, lat = geo.ray_to_ll(*ray)
        assert float(lat.abs().max()) > math.radians(87)
        assert float(lon.abs().max()) > math.radians(179)
    buf = torch.full((h, w, 3), float("nan"))
    got = FP.fused_frame(plan, src, out=buf, device="cpu")
    assert got is buf
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=INLINE_ROUTE_TOL)


def test_planar_twined_cubemap_route_matches_exact_path(env):
    """A biatan6 source seen stereographically across cube edges,
    twined: ``planar_frame`` (whole-frame form, every pickup of a pixel
    in its centre's face) against the exact path."""
    _jc, _jsrc, tc, tsrc = _cubemap_sources(env, "biatan6", jax=False)
    plan = build_plan(_twined_args(
        port_args, TP.STEREOGRAPHIC, 96, 64, 150.0, [tc], 3, 25.0, -15.0,
        10.0, spread=BOX2, precise=False), [tc])
    want = render_frame(plan, [tsrc], device="cpu")
    ops = _twined_operands(plan, tsrc)
    assert ops["tap_weights"] is None and ops["wrap_x"] is None
    # the derivative planes never jump by a section of the IR
    for k in ("dux", "duy", "dvx", "dvy"):
        assert float(ops[k].abs().max()) < 8.0
    face = geo.ray_to_cubeface(*ST.target_rays(
        plan.projection, 96, 64, plan.extent, basis=plan.bases[0]))[0]
    assert len(torch.unique(face)) >= 3, "the view crosses cube edges"
    got = FP.planar_frame(plan, tsrc, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PLANAR_ROUTE_TOL["cubemap"])


def test_planar_twined_full_sphere_route(env):
    """A full sphere seen stereographically with the pole and the seam
    in view: the planar twined route wraps derivatives and taps by the
    period, so the seam is no special case; near the pole the
    coordinate-space deflection differs from the exact path's and only
    finiteness is held there."""
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    src = TE.make_mount_source(tf, env, 3, 3, device="cpu")
    plan = build_plan(_twined_args(
        port_args, TP.STEREOGRAPHIC, 64, 48, 200.0, [tf], 3, 170.0, 60.0,
        0.0, spread=BOX2, precise=False), [tf])
    want = render_frame(plan, [src], device="cpu")
    ops = _twined_operands(plan, src)
    assert ops["tap_weights"] is None and ops["wrap_x"] == (src.spl.pad - 0.5,
                                                           256.0)
    assert float(ops["dux"].abs().max()) <= 128.0
    got = FP.planar_frame(plan, src, device="cpu").numpy()
    assert np.isfinite(got).all()
    lon, lat = geo.ray_to_ll(*ST.target_rays(
        plan.projection, 64, 48, plan.extent, basis=plan.bases[0]))
    away = (lat.abs() < math.radians(80)).numpy()
    seam = away & (lon.abs() > math.radians(175)).numpy()
    assert seam.sum() > 20 and (~away).sum() > 0
    np.testing.assert_allclose(got[away], want[away], rtol=0, atol=POLAR_TOL)
