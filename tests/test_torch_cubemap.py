"""Cubemap and biatan6 IR sources in the port (envutil_tpu_torch.models.
cubemap, the cubemap branches of models/environment.py and the inline
kernel's IR source modes) against the JAX package, on the CPU.

Inputs come from the golden-oracle fixture (a smooth synthetic
equirect, rendered to a 64-px cubemap or biatan6 stripe by the port);
both packages then build the IR from the same faces.

Tolerances, each with its reason:

- IR tables: 1e-5. Both prefilter in float32 with sums in another
  order (~1e-7 relative on coefficients up to ~1); an indexing fault in
  the support fill shows as O(0.1).
- Renders against the JAX package: 1e-5, as for mount sources. The
  port keeps float32 rays where the JAX reference, under the tests' x64
  mode, carries float64; on the smooth fixture that moves pixel values
  by ~2e-6.
- The fast routes (``fused_frame``, ``planar_frame``) against
  ``render_frame``: 5e-5. The inline kernel forms the IR pickup as one
  affine (fx * k + c) where the exact path uses
  ``get_pickup_coordinate_px``'s (fx + refc) * k; IR rows reach 6 x 128
  px, where a float32 ulp is 6e-5 px, and a few ulps times the fixture's
  gradient give ~6e-6.
- The inline kernel's plain version against the JAX inline kernel in
  interpret mode: 1e-3, as for the sph source mode (the JAX kernel's
  polynomial atan2 and float32 chain; an indexing fault shows as O(0.1)).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle as O
from test_golden_oracle import (GOLDEN_DB, fw_render, make_args,
                                make_facet, synthetic_equirect)
from test_torch_render import port_args, port_facet, port_stripe

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.models import cubemap as JCBM
from envutil_tpu.models import environment as JE
from envutil_tpu.ops import pallas_resample as PR
from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import cubemap as TCBM
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

TABLE_TOL = 1e-5
JAX_TOL = 1e-5
FAST_TOL = 5e-5
KERNEL_TOL = 1e-3

KINDS = {"cubemap": (JP.CUBEMAP, TP.CUBEMAP, O.CUBEMAP),
         "biatan6": (JP.BIATAN6, TP.BIATAN6, O.BIATAN6)}


@pytest.fixture(scope="module", params=sorted(KINDS))
def ir(request):
    """A 64-px cubemap or biatan6 stripe of the golden fixture (rendered
    by the port) and the IR sources both packages build from it (degree
    3, support_min 8, tile 64, as tests/test_golden_oracle.py)."""
    jproj, tproj, oproj = KINDS[request.param]
    stripe = port_stripe(tproj, synthetic_equirect())
    faces = stripe.reshape(6, 64, 64, 3)
    jc = make_facet(jproj, 64, 384, math.pi / 2)
    jsrc = JCBM.make_cubemap_source(jc, faces, 3, 3, support_min=8,
                                    tile_size=64)
    tc = port_facet(tproj, 64, 384, math.pi / 2)
    tsrc = TCBM.make_cubemap_source(tc, faces, 3, 3, 8, 64, device="cpu")
    return dict(kind=request.param, jproj=jproj, tproj=tproj, oproj=oproj,
                stripe=stripe, jc=jc, tc=tc, jsrc=jsrc, tsrc=tsrc)


def _crossover(jsrc):
    spl = jsrc.spl
    return TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(jsrc.static), spl.pad,
        spl.degree, spl.bcs, spl.core_shape, spl.spherical, device="cpu")


def test_ir_table_matches_jax(ir):
    """The port's IR table equals the JAX one, and the JAX table crosses
    over through ``source_from_arrays`` with equal statics and lookups."""
    jspl, tspl = ir["jsrc"].spl, ir["tsrc"].spl
    assert tuple(tspl.coeff.shape) == tuple(jspl.coeff.shape) \
        == (6 * 128 + 8, 128 + 8, 3)
    assert (tspl.pad, tspl.degree, tspl.bcs, tuple(tspl.core_shape)) == \
        (jspl.pad, jspl.degree, tuple(jspl.bcs), tuple(jspl.core_shape))
    np.testing.assert_allclose(tspl.coeff.numpy(), np.asarray(jspl.coeff),
                               rtol=0, atol=TABLE_TOL)
    cross = _crossover(ir["jsrc"])
    assert cross.static == ir["tsrc"].static
    ray = np.random.default_rng(2).normal(size=(3, 3000))
    jpx, jmask = JE.lookup(ir["jsrc"], tuple(ray), 3)
    tpx, tmask = TE.lookup(cross, tuple(torch.from_numpy(r) for r in ray), 3)
    assert bool(tmask.all()) and bool(np.asarray(jmask).all())
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=0,
                               atol=1e-12)


def _targets(kind):
    if kind == "cubemap":   # golden config 2r: cubemap -> equirect
        return [(TP.SPHERICAL, O.SPHERICAL, 256, 128, 360.0, (0, 0, 0))]
    # golden config 3/3b: biatan6 -> stereographic / fisheye
    return [(p, o, 96, 64, 120.0, (25.0, -15.0, 10.0))
            for p, o in ((TP.STEREOGRAPHIC, O.STEREOGRAPHIC),
                         (TP.FISHEYE, O.FISHEYE))]


def test_golden_render_matches_jax_and_oracle(ir):
    """Golden configs 2r (cubemap) and 3/3b (biatan6): the port's
    ``render_frame`` on the CPU against the JAX package and the float64
    oracle; the fast route (``fused_frame`` for the inline target,
    ``planar_frame`` for the others) against ``render_frame``."""
    ocf = O.CubemapFacet(ir["oproj"], 64, math.pi / 2,
                         ir["stripe"].reshape(384, 64, 3), degree=3)
    for proj, oproj, w, h, hfov, ypr in _targets(ir["kind"]):
        want = fw_render(make_args(JP(int(proj)), w, h, hfov, [ir["jc"]],
                                   degree=3, yaw=ypr[0], pitch=ypr[1],
                                   roll=ypr[2]), [ir["jsrc"]])
        plan = build_plan(port_args(proj, w, h, hfov, [ir["tc"]], 3, *ypr),
                          [ir["tc"]])
        got = render_frame(plan, [ir["tsrc"]], device="cpu")
        assert got.shape == want.shape == (h, w, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
        t = dict(projection=oproj, width=w, height=h,
                 hfov=math.radians(hfov), yaw=math.radians(ypr[0]),
                 pitch=math.radians(ypr[1]), roll=math.radians(ypr[2]))
        p = O.psnr(got, O.render(t, [ocf]))
        assert p > GOLDEN_DB, f"{ir['kind']} -> {proj.name}: {p:.1f} dB"

        inline = FP.inline_mode(plan, ir["tsrc"])
        assert inline == (ir["kind"] if proj == TP.SPHERICAL else None)
        route = FP.fused_frame if inline else FP.planar_frame
        buf = torch.full((h, w, 3), float("nan"))
        fast = route(plan, ir["tsrc"], out=buf, device="cpu")
        assert fast is buf
        np.testing.assert_allclose(fast.numpy(), got, rtol=0, atol=FAST_TOL)


def _jplan(jc, proj, w, h, hfov):
    a = make_args(proj, w, h, hfov, [jc], degree=3)
    return jbuild_plan(a, [jc])


# one 128x128 tile of a 1024x512 equirect per source kind (interpret
# mode is slow): the cubemap's at the back face, at the left edge
# (lon -180 to -135),
# the biatan6's at the front face
WINDOWS = {"cubemap": (192, 320, 0, 128), "biatan6": (192, 320, 448, 576)}


def test_inline_plain_matches_jax_inline_kernel(ir):
    """The inline kernel's plain version in the IR source mode against
    the JAX inline kernel (interpret mode) on a 128x128 tile of a
    1024x512 equirect that the JAX planner gives to an inline pass."""
    jc, tc, jsrc, tsrc = ir["jc"], ir["tc"], ir["jsrc"], ir["tsrc"]
    window = WINDOWS[ir["kind"]]
    jplan = _jplan(jc, JP.SPHERICAL, 1024, 512, 360.0)
    tplan = build_plan(port_args(TP.SPHERICAL, 1024, 512, 360.0, [tc], 3),
                       [tc])
    m = jsrc.static.metrics
    statics = (m.refc_md, m.model_to_px, m.section_px)
    spl = jsrc.spl
    tmode, xfeat, yfeat, P, consts = JFP._inline_setup(
        JFP._geom_static(jplan), window, "orig", spl.core_shape, spl.pad,
        tuple(spl.bcs), statics, smode=ir["kind"])
    t_setup = FP.inline_setup(tplan, window, tuple(spl.core_shape), spl.pad,
                              tuple(spl.bcs), statics, ir["kind"])
    assert t_setup[0] == tmode and t_setup[4] == consts
    np.testing.assert_array_equal(t_setup[1], xfeat[:, 0, :])
    np.testing.assert_array_equal(t_setup[2], yfeat[:, :, 0])

    passes, _assigned = JFP.plan_passes(jplan, jsrc, window,
                                        JFP.DEFAULT_CLASSES)
    bm = np.einsum("ij,fjk->fik", np.asarray(jplan.bases[0], np.float32),
                   P).reshape(-1, 9)
    ops = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
           for a in (t_setup[1], t_setup[2], bm)]
    y0, y1, x0, x1 = window
    plain = R.resample_inline_plain(
        torch.empty((y1 - y0, x1 - x0, 3)), tsrc.spl.coeff, *ops, degree=3,
        tmode=tmode, consts=consts, row0=y0, smode=ir["kind"]).numpy()
    tested = 0
    for name, wc, _box, tiles, merge in passes:
        if JFP._inline_eligible(jplan, jsrc, 0, name, None,
                                merge) != ir["kind"]:
            continue
        out = PR.resample_inline_into(
            jnp.zeros((3, y1 - y0, x1 - x0), jnp.float32),
            jnp.moveaxis(spl.coeff, -1, 0), jnp.asarray(tiles),
            jnp.zeros(len(tiles), jnp.int32), jnp.asarray(xfeat),
            jnp.asarray(yfeat), jnp.asarray(bm), jnp.float32(0), degree=3,
            tmode=tmode, consts=consts, smode=ir["kind"], wc=wc,
            interpret=True)
        out = np.moveaxis(np.asarray(out), 0, -1)
        np.testing.assert_allclose(plain, out, rtol=0, atol=KERNEL_TOL)
        tested += len(tiles)
    assert tested == 1, "the JAX planner gave the tile no inline pass"


@pytest.mark.cuda
def test_ir_kernel_matches_plain_on_card(ir):
    """The inline kernel in the IR source modes against its plain
    version on the card, for every target mode (needs a CUDA card and
    nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    spl = ir["jsrc"].spl
    src = TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(ir["jsrc"].static),
        spl.pad, spl.degree, spl.bcs, spl.core_shape, False, device="cuda")
    for proj, w, h, hfov in ((TP.CUBEMAP, 64, 384, 90),
                             (TP.RECTILINEAR, 96, 64, 75),
                             (TP.SPHERICAL, 128, 64, 360),
                             (TP.CYLINDRICAL, 128, 64, 200)):
        plan = build_plan(port_args(proj, w, h, hfov, [ir["tc"]], 3,
                                    10, 5, 0), [ir["tc"]])
        ops = FP.frame_operands(plan, src)
        kw = dict(degree=3, tmode=ops["tmode"], consts=ops["consts"],
                  row0=ops["row0"], face_rows=ops["face_rows"],
                  smode=ops["smode"])
        args = (src.spl.coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
        before = R.resample_inline.launches
        out_k = R.resample_inline(torch.empty((h, w, 3), device="cuda"),
                                  *args, **kw)
        out_p = R.resample_inline_plain(
            torch.empty((h, w, 3), device="cuda"), *args, **kw)
        torch.cuda.synchronize()
        assert R.resample_inline.launches == before + 1
        assert float((out_k - out_p).abs().max()) <= KERNEL_TOL
