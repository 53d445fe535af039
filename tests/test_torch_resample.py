"""The port's inline-coordinates resampler (envutil_tpu_torch.ops.resample
and runtime/fastpath.py) against the JAX package, on one table.

The JAX package builds the source (prefilter included); its table and
static fields cross over through ``environment.source_from_arrays``, so
these tests hold the kernel's plain version and the lookup apart from
the prefilter. The CUDA kernel itself runs only on a card
(``test_kernel_matches_plain_on_card``); chip_smoke.py drives it at full
size.

Tolerance: both sides evaluate float32 coordinate chains in different
orders (the JAX kernel's polynomial atan2 is within ~2 ulp of XLA's;
``_coords`` even carries float64 after the host basis rotation). That
moves spline coordinates by ~1e-5 px; times the spline gradient of the
uniform-noise source (prefiltered coefficients reach ~+-3) it stays
below 1e-3, while an indexing or weighting fault shows as O(0.1..1).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.core.facet import Facet as JFacet
from envutil_tpu.core.metrics import get_extent as jget_extent
from envutil_tpu.core.metrics import get_step as jget_step
from envutil_tpu.models import environment as JE
from envutil_tpu.ops import pallas_resample as PR
from envutil_tpu.ops import spline as JS
from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu.runtime.args import Args as JArgs
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.core.facet import Facet as TFacet
from envutil_tpu_torch.core.metrics import get_extent, get_step
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.args import Args
from envutil_tpu_torch.runtime.render import build_plan

torch.set_num_threads(1)

TOL = 1e-3


def _facets(proj, w, h, hfov, yaw=0.0):
    out = []
    for F, gs in ((JFacet, jget_step), (TFacet, get_step)):
        f = F(facet_no=0, nchannels=3)
        f.set_geometry(proj, w, h, hfov)
        f.step = gs(proj, w, h, hfov)
        f.yaw = yaw
        f.process_geometry()
        out.append(f)
    return out


def _args(A, P, ge, fct, proj, w, h, hfov_deg, ypr, degree=3):
    a = A()
    a.projection = P(int(proj))
    a.width, a.height = w, h
    a.hfov = math.radians(hfov_deg)
    a.extent = ge(a.projection, w, h, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / w
    a.yaw, a.pitch, a.roll = (math.radians(v) for v in ypr)
    a.spline_degree = a.prefilter_degree = degree
    a.twine = 0
    a.synopsis = "panorama"
    a.nchannels = 3
    a.facets = [fct]
    a.solo = 0
    return a


def _plans(jf, tf, proj, w, h, hfov, ypr):
    jplan = jbuild_plan(_args(JArgs, JP, jget_extent, jf, proj, w, h, hfov,
                              ypr), [jf])
    tplan = build_plan(_args(Args, TP, get_extent, tf, proj, w, h, hfov,
                             ypr), [tf])
    return jplan, tplan


def _crossover(jsrc):
    spl = jsrc.spl
    return TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(jsrc.static), spl.pad,
        spl.degree, spl.bcs, spl.core_shape, spl.spherical, device="cpu")


@pytest.fixture(scope="module")
def sphere():
    """A 256x128 full-spherical noise source (yawed 25 degrees), built
    by the JAX package and carried into the port."""
    img = np.random.default_rng(3).uniform(0, 1, (128, 256, 3)).astype(
        np.float32)
    jf, tf = _facets(JP.SPHERICAL, 256, 128, 2 * math.pi,
                     yaw=math.radians(25))
    jsrc = JE.make_mount_source(jf, img, 3, 3)
    return jf, tf, jsrc, _crossover(jsrc)


def _plain(tplan, tsrc):
    ops = FP.frame_operands(tplan, tsrc)
    y0, y1, x0, x1 = FP.frame_window(tplan)
    out = torch.empty((y1 - y0, x1 - x0, 3))
    R.resample_inline_plain(
        out, tsrc.spl.coeff, ops["xfeat"], ops["yfeat"], ops["bmats"],
        degree=ops["degree"], tmode=ops["tmode"], consts=ops["consts"],
        row0=ops["row0"], face_rows=ops["face_rows"])
    return out.numpy()


def test_plain_matches_jax_inline_kernel(sphere):
    """128x768 cubemap, degree 3: the plain version against the JAX
    inline kernel in interpret mode, on the tiles its pass covers."""
    jf, tf, jsrc, tsrc = sphere
    jplan, tplan = _plans(jf, tf, JP.CUBEMAP, 128, 768, 90, (0, 0, 0))
    window = (0, 768, 0, 128)
    geom = JFP._geom_static(jplan)
    passes, _assigned = JFP.plan_passes(jplan, jsrc, window,
                                        JFP.DEFAULT_CLASSES)
    st = jsrc.static
    statics = (st.total_extent.x0, st.total_extent.x1, st.total_extent.y0,
               st.total_extent.y1, st.total_width, st.total_height,
               st.window_x_offset, st.window_y_offset)
    spl = jsrc.spl
    # the port's host-side setup equals the JAX one (features without the
    # TPU's (8, 128) replication)
    tmode, xfeat, yfeat, P, consts = JFP._inline_setup(
        geom, window, "orig", spl.core_shape, spl.pad, tuple(spl.bcs),
        statics)
    t_setup = FP.inline_setup(tplan, window, spl.core_shape, spl.pad,
                              tuple(spl.bcs), statics)
    assert t_setup[0] == tmode and t_setup[4] == consts
    np.testing.assert_array_equal(t_setup[1], xfeat[:, 0, :])
    np.testing.assert_array_equal(t_setup[2], yfeat[:, :, 0])
    np.testing.assert_array_equal(t_setup[3], P)

    plain = _plain(tplan, tsrc)
    bm = np.einsum("ij,fjk->fik",
                   np.asarray(jplan.bases[0], np.float32), P).reshape(-1, 9)
    coeffp = jnp.moveaxis(spl.coeff, -1, 0)
    tested = 0
    for name, wc, _box, tiles, merge in passes:
        if not JFP._inline_eligible(jplan, jsrc, 0, name, None, merge):
            continue
        faces = np.clip(tiles[:, 2] * PR.TILE_H // 128, 0,
                        5).astype(np.int32)
        out = PR.resample_inline_into(
            jnp.zeros((3, 768, 128), jnp.float32), coeffp,
            jnp.asarray(tiles), jnp.asarray(faces), jnp.asarray(xfeat),
            jnp.asarray(yfeat), jnp.asarray(bm), jnp.float32(0),
            degree=3, tmode=tmode, consts=consts, wc=wc, interpret=True)
        out = np.moveaxis(np.asarray(out), 0, -1)
        for row in np.asarray(tiles):
            sl = np.s_[row[2] * PR.TILE_H:(row[2] + 1) * PR.TILE_H,
                       row[3] * PR.TILE_W:(row[3] + 1) * PR.TILE_W]
            np.testing.assert_allclose(plain[sl], out[sl], rtol=0, atol=TOL)
            tested += 1
    assert tested >= 3, "the JAX pass covered too few tiles"


@pytest.mark.parametrize("proj,w,h,hfov,ypr", [
    (TP.CUBEMAP, 64, 384, 90, (10, -20, 5)),
    (TP.RECTILINEAR, 96, 64, 75, (30, 10, 5)),
    (TP.SPHERICAL, 128, 64, 360, (20, -30, 10)),
    (TP.CYLINDRICAL, 128, 64, 200, (10, 5, 0)),
], ids=["cubemap-affine", "rect-affine", "spherical-sph", "cyl-cyl"])
def test_plain_matches_jax_coords(sphere, proj, w, h, hfov, ypr):
    """Every pixel: the plain version against the JAX coordinate pass
    (``_coords``) + ``eval_spline`` on the same padded table."""
    jf, tf, jsrc, tsrc = sphere
    jplan, tplan = _plans(jf, tf, proj, w, h, hfov, ypr)
    window = (0, h, 0, w)
    sx, sy, _m, _z = JFP._coords(JFP._geom_static(jplan), window, "orig",
                                 jsrc, 0, (0.0, 0.0),
                                 JFP._basis_arg(jplan, 0))
    spl = jsrc.spl
    table = JS.Spline2D(coeff=spl.coeff, pad=0, degree=spl.degree,
                        bcs=(JS.CONSTANT, JS.CONSTANT),
                        core_shape=spl.coeff.shape[:2])
    want = np.asarray(JS.eval_spline(table, sx, sy, apply_gate=False))
    got = _plain(tplan, tsrc)
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("proj,w,h,hfov", [
    (TP.SPHERICAL, 256, 128, 2 * math.pi),
    (TP.SPHERICAL, 144, 96, math.radians(200)),
    (TP.RECTILINEAR, 96, 64, math.radians(80)),
], ids=["full-sphere", "partial-sphere", "rectilinear"])
def test_source_from_arrays_lookup(proj, w, h, hfov):
    """The JAX table carried over gives the same lookup, mask included,
    at float64 rays (float32 coefficients, float64 arithmetic)."""
    img = np.random.default_rng(w).uniform(0, 1, (h, w, 3)).astype(
        np.float32)
    jf, tf = _facets(proj, w, h, hfov)
    jsrc = JE.make_mount_source(jf, img, 3, 3)
    tsrc = _crossover(jsrc)
    assert tsrc.static == TE.mount_static(tf, 3)
    ray = np.random.default_rng(1).normal(size=(3, 2000))
    ray[2] += 0.8
    jpx, jmask = JE.lookup(jsrc, tuple(ray), 3)
    tpx, tmask = TE.lookup(tsrc, tuple(torch.from_numpy(r) for r in ray), 3)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    if hfov < 2 * math.pi:
        assert 0 < int(tmask.sum()) < ray.shape[1]
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=0,
                               atol=1e-12)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(sphere):
    """The CUDA kernel against its plain version on the card, for every
    target mode (needs a CUDA card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    _jf, tf, jsrc, _tsrc = sphere
    spl = jsrc.spl
    src = TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(jsrc.static), spl.pad,
        spl.degree, spl.bcs, spl.core_shape, spl.spherical, device="cuda")
    for proj, w, h, hfov in ((TP.CUBEMAP, 64, 384, 90),
                             (TP.RECTILINEAR, 96, 64, 75),
                             (TP.SPHERICAL, 128, 64, 360),
                             (TP.CYLINDRICAL, 128, 64, 200)):
        plan = build_plan(_args(Args, TP, get_extent, tf, proj, w, h, hfov,
                                (10, 5, 0)), [tf])
        ops = FP.frame_operands(plan, src)
        kw = dict(degree=3, tmode=ops["tmode"], consts=ops["consts"],
                  row0=ops["row0"], face_rows=ops["face_rows"])
        args = (src.spl.coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
        before = R.resample_inline.launches
        out_k = R.resample_inline(torch.empty((h, w, 3), device="cuda"),
                                  *args, **kw)
        out_p = R.resample_inline_plain(
            torch.empty((h, w, 3), device="cuda"), *args, **kw)
        torch.cuda.synchronize()
        assert R.resample_inline.launches == before + 1
        assert float((out_k - out_p).abs().max()) <= TOL
