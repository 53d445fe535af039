"""The port's slice as a whole on the CPU: ``render_frame(device="cpu")``
of envutil_tpu_torch against the JAX package's ``render_frame`` (its
exact XLA path on the CPU) and against the float64 oracle
(tests/oracle.py), for golden-oracle configs 1 and 2.

Tolerance against JAX: both packages prefilter in float32 (sums in
another order, ~1e-7 relative) and the port keeps float32 coordinates
where the JAX reference, under the tests' x64 mode, carries float64
after the host basis rotation; on the smooth synthetic equirect both
move pixel values by ~1e-6, so 1e-5 holds with margin. Against the
oracle the bar is BASELINE.md's 50 dB.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import oracle as O
from test_golden_oracle import (GOLDEN_DB, fw_render, make_args,
                                make_facet, synthetic_equirect)

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.models import environment as JE
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.core.facet import Facet
from envutil_tpu_torch.core.metrics import get_extent, get_step
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.args import Args
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

JAX_TOL = 1e-5


def port_facet(projection, w, h, hfov):
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(projection, w, h, hfov)
    f.step = get_step(projection, w, h, hfov)
    f.process_geometry()
    return f


def port_stripe(projection, env, width=64, degree=3):
    """A ``width``-px cubemap or biatan6 stripe (6 width x width faces) of
    the full-spherical equirect ``env``, rendered at ``degree`` by the
    port's exact path on the CPU: the faces from which the IR tests
    build both packages' sources (they differ from the JAX package's
    render of the same stripe by ~1e-6)."""
    h, w = env.shape[:2]
    tf = port_facet(TP.SPHERICAL, w, h, 2 * math.pi)
    src = TE.make_mount_source(tf, env, degree, degree, device="cpu")
    plan = build_plan(port_args(projection, width, 6 * width, 90.0, [tf],
                                degree), [tf])
    return render_frame(plan, [src], device="cpu")


def port_args(projection, w, h, hfov_deg, facets, degree, yaw=0.0,
              pitch=0.0, roll=0.0, twine_spread=None):
    a = Args()
    a.projection = projection
    a.width, a.height = w, h
    a.hfov = math.radians(hfov_deg)
    a.extent = get_extent(projection, w, h, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / w
    a.yaw, a.pitch, a.roll = (math.radians(v) for v in (yaw, pitch, roll))
    a.spline_degree = a.prefilter_degree = degree
    a.twine = 0
    a.synopsis = "panorama"
    a.nchannels = 3
    a.facets = facets
    a.solo = 0
    if twine_spread:
        a.twine = 1
        a.twine_spread = twine_spread
    return a


@pytest.fixture(scope="module")
def env():
    return synthetic_equirect()


@pytest.fixture(scope="module")
def oracle_sources(env):
    return {d: O.MountFacet(O.SPHERICAL, 256, 128, 2 * math.pi, env,
                            degree=d) for d in (1, 3)}


CONFIGS = [
    # golden config 1: lat/lon -> rectilinear, degrees 1 and 3
    ("rect-deg1", TP.RECTILINEAR, 96, 64, 75.0, 1, (30.0, 10.0, 5.0)),
    ("rect-deg3", TP.RECTILINEAR, 96, 64, 75.0, 3, (30.0, 10.0, 5.0)),
    # golden config 2: equirect -> cubemap, degree 3 + prefilter
    ("cubemap-deg3", TP.CUBEMAP, 64, 384, 90.0, 3, (0.0, 0.0, 0.0)),
]


@pytest.mark.parametrize("name,proj,w,h,hfov,degree,ypr", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_render_matches_jax_and_oracle(env, oracle_sources, name, proj, w,
                                       h, hfov, degree, ypr):
    jf = make_facet(JP.SPHERICAL, 256, 128, 2 * math.pi)
    jargs = make_args(JP(int(proj)), w, h, hfov, [jf], degree=degree,
                      yaw=ypr[0], pitch=ypr[1], roll=ypr[2])
    want = fw_render(jargs, [JE.make_mount_source(jf, env, degree, degree)])

    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    src = TE.make_mount_source(tf, env, degree, degree, device="cpu")
    plan = build_plan(port_args(proj, w, h, hfov, [tf], degree, *ypr), [tf])
    got = render_frame(plan, [src], device="cpu")
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)

    t = dict(projection=O.CUBEMAP if proj == TP.CUBEMAP else O.RECTILINEAR,
             width=w, height=h, hfov=math.radians(hfov),
             yaw=math.radians(ypr[0]), pitch=math.radians(ypr[1]),
             roll=math.radians(ypr[2]))
    p = O.psnr(got, O.render(t, [oracle_sources[degree]]))
    assert p > GOLDEN_DB, f"{name}: {p:.1f} dB"

    # the CUDA route's kernel chain, run here as its plain version: one
    # fused frame over the whole window, rewriting a caller-held buffer
    buf = torch.full((h, w, 3), float("nan"))
    fast = FP.fused_frame(plan, src, out=buf, device="cpu")
    assert fast is buf
    np.testing.assert_allclose(fast.numpy(), got, rtol=0, atol=JAX_TOL)


def test_uncovered_jobs_raise(env):
    """No plain path stands in for a kernel: jobs the port has no kernel
    for (--mask_for paint) raise NotImplementedError naming the later
    slice; a bf16 table is covered and renders what the float32 table it
    upcasts to renders. A twined single-facet job is covered: a one-tap
    spread at the pixel centre renders what the untwined job renders, on
    the exact path and on the kernel route. So are an untwined and a
    twined stitch, on the kernel route (``render_fast`` runs the
    kernels' plain versions on CPU tensors)."""
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    src = TE.make_mount_source(tf, env, 3, 3, device="cpu")
    twined = build_plan(port_args(TP.RECTILINEAR, 32, 32, 60.0, [tf], 3,
                                  twine_spread=[[0.0, 0.0, 1.0]]), [tf])
    plain = build_plan(port_args(TP.RECTILINEAR, 32, 32, 60.0, [tf], 3),
                       [tf])
    assert FP.uncovered(twined, [src]) is None
    want = render_frame(plain, [src], device="cpu")
    np.testing.assert_allclose(render_frame(twined, [src], device="cpu"),
                               want, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(
        FP.fused_frame(twined, src, device="cpu").numpy(), want, rtol=0,
        atol=JAX_TOL)
    tf2 = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    tf2.yaw = math.radians(90.0)
    tf2.process_geometry()

    def stitch(spread=None):
        a = port_args(TP.RECTILINEAR, 32, 32, 60.0, [tf, tf2], 3,
                      twine_spread=spread)
        a.solo = -1
        return build_plan(a, [tf, tf2])
    untwined, twined2 = stitch(), stitch([[0.0, 0.0, 1.0]])
    assert FP.uncovered(untwined, [src, src]) is None
    want = render_frame(untwined, [src, src], device="cpu")
    np.testing.assert_allclose(FP.render_fast(untwined, [src, src]), want,
                               rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(render_frame(twined2, [src, src],
                                            device="cpu"),
                               want, rtol=0, atol=JAX_TOL)
    assert FP.uncovered(twined2, [src, src]) is None
    np.testing.assert_allclose(FP.render_fast(twined2, [src, src]), want,
                               rtol=0, atol=JAX_TOL)
    plan = build_plan(port_args(TP.FISHEYE, 32, 32, 120.0, [tf], 3), [tf])
    bf16 = TE.FacetSource(static=src.static, spl=dataclasses.replace(
        src.spl, coeff=src.spl.coeff.to(torch.bfloat16)))
    upcast = TE.FacetSource(static=src.static, spl=dataclasses.replace(
        src.spl, coeff=bf16.spl.coeff.float()))
    assert FP.uncovered(plan, [bf16]) is None
    torch.testing.assert_close(FP.planar_frame(plan, bf16),
                               FP.planar_frame(plan, upcast), rtol=0, atol=0)
    painted = TE.FacetSource(
        static=dataclasses.replace(src.static, masked=1), spl=src.spl)
    with pytest.raises(NotImplementedError, match="mask_for"):
        FP.render_fast(plan, [painted])


def test_fisheye_and_partial_mount_render(env):
    """A fisheye target and a partial mount, which the inline kernel does
    not cover, render through ``planar_frame`` (the planar kernel's
    plain version on the CPU) as ``render_frame`` does; ``fused_frame``
    refuses them."""
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    src = TE.make_mount_source(tf, env, 3, 3, device="cpu")
    fish = build_plan(port_args(TP.FISHEYE, 32, 32, 120.0, [tf], 3), [tf])
    pf = port_facet(TP.SPHERICAL, 128, 64, math.radians(200))
    partial = TE.make_mount_source(pf, env[:64, :128], 3, 3, device="cpu")
    rect = build_plan(port_args(TP.RECTILINEAR, 32, 32, 60.0, [pf], 3,
                                yaw=80.0), [pf])
    for plan, source in ((fish, src), (rect, partial)):
        want = render_frame(plan, [source], device="cpu")
        assert np.isfinite(want).all()
        got = FP.planar_frame(plan, source, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_TOL)
        with pytest.raises(ValueError, match="planar_frame"):
            FP.fused_frame(plan, source)
    # the view at yaw 80 reaches past the partial facet's 200 degrees
    assert 0 < int((want == 0).all(axis=-1).sum()) < want.shape[0] * \
        want.shape[1]
