"""Single-facet twining in the port against the JAX package, on the CPU:
the ninepack, the exact twined path, the two twined kernels' plain
versions (``resample_inline_twined``, ``resample_twined``) against the
JAX kernels in interpret mode, the twined kernel routes against the
exact path, and ``--twine_pyramid``.

Inputs are the golden-oracle fixture (a smooth synthetic equirect) or
seeded numpy noise; the same arrays go through both packages.

Tolerances, each with its reason:

- ninepack rays: 2e-6. Both packages take the axes from float64 numpy,
  cast once to float32; the JAX reference rotates in float64 under the
  tests' x64 mode where the port stays float32.
- twined renders against the JAX package: 1e-5, as for the untwined
  golden tests (float32 sums of K taps in the same order); against the
  float64 oracle BASELINE.md's 50 dB.
- ``resample_inline_twined_plain`` against the JAX inline twined kernel
  in interpret mode: 3e-3, the JAX test's own bound on this fixture. The
  two linearise differently on purpose: the JAX kernel differences
  gated spline coordinates, the port the rays (as the exact path does);
  on a 1024-px noise source viewed at about one source px per output px
  the second-order term stays below 1e-3.
- ``resample_inline_twined_plain`` (through ``fused_frame``) against the
  port's exact path: 5e-6 on a frame that holds a pole and the periodic
  seam: the same rays, deflected the same way.
- ``resample_twined_plain`` against the JAX planar twined kernels: 5e-5,
  the JAX package's own bound against its tap loop; pixels a merge mask
  keeps are compared bit for bit.
- ``planar_frame`` twined against the exact path: the kernel deflects in
  coordinate space (its operands are coordinate derivative planes), the
  exact path in ray space, so they differ by a second-order term that
  shrinks with the square of the pixel size. At these tiny rasters (a
  pixel spans 1-3 degrees): 2e-3 for a cubemap source seen through a
  stereographic lens, 1e-2 for the lens-corrected and translated facets.
  chip_smoke.py holds the same routes to 5e-3 at full size. A full
  sphere seen stereographically deviates more within a few degrees of a
  pole, where longitude is no linear function of anything: 5e-3 below
  80 degrees of latitude, and finite everywhere.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle as O
from test_golden_oracle import (GOLDEN_DB, fw_render, make_args, make_facet,
                                synthetic_equirect)
from test_torch_planar import _sources as facet_sources
from test_torch_render import port_args, port_facet, port_stripe

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.core.metrics import get_extent as jget_extent
from envutil_tpu.models import cubemap as JCBM
from envutil_tpu.models import environment as JE
from envutil_tpu.models import stepper as JST
from envutil_tpu.ops import pallas_resample as PR
from envutil_tpu.ops import spline as JS
from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu.runtime import loader as JLD
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core import geometry as geo
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.core.metrics import get_extent
from envutil_tpu_torch.core.rotation import rotation_rpy
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.models import cubemap as TCBM
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import stepper as ST
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import cli
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime import loader as LD
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

RAY_TOL = 2e-6
JAX_TOL = 1e-5
INLINE_KERNEL_TOL = 3e-3
INLINE_ROUTE_TOL = 5e-6
PLANAR_KERNEL_TOL = 5e-5
PLANAR_ROUTE_TOL = {"cubemap": 2e-3, "lens": 1e-2, "translated": 1e-2}
POLAR_TOL = 5e-3

BOX2 = O.make_spread(2, 2, 1.0)
BOX3 = O.make_spread(3, 3, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


@pytest.fixture(scope="module")
def env():
    return synthetic_equirect()


# ------------------------------------------------------------ (a) ninepack

NINEPACKS = [("rectilinear", TP.RECTILINEAR, 48, 32, 75.0),
             ("spherical", TP.SPHERICAL, 64, 32, 360.0),
             ("cubemap", TP.CUBEMAP, 16, 96, 90.0),
             ("stereographic", TP.STEREOGRAPHIC, 48, 32, 150.0)]


@pytest.mark.parametrize("name,proj,w,h,hfov", NINEPACKS,
                         ids=[c[0] for c in NINEPACKS])
def test_ninepack_matches_jax(name, proj, w, h, hfov):
    """``target_ninepack`` against the JAX one under a rotation and a
    window: three grids, the biased ones DERIV_BIAS of a step away, and
    for the cubemap target all three on the face of the integer row."""
    assert ST.DERIV_BIAS == JST.DERIV_BIAS
    basis = rotation_rpy(math.radians(5), math.radians(10), math.radians(30))
    window = (4, h - 3, 2, w - 5)
    want = JST.target_ninepack(
        JP(int(proj)), w, h, jget_extent(JP(int(proj)), w, h,
                                         math.radians(hfov)),
        basis=basis, window=window)
    got = ST.target_ninepack(proj, w, h,
                             get_extent(proj, w, h, math.radians(hfov)),
                             basis=basis, window=window)
    for grid_w, grid_g in zip(want, got):
        for a, b in zip(grid_w, grid_g):
            assert tuple(b.shape) == (h - 7, w - 7)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=RAY_TOL)
    # the biased grids differ from the centre, each along its own axis
    assert float((got[1][0] - got[0][0]).abs().max()) > 1e-4
    assert float((got[2][1] - got[0][1]).abs().max()) > 1e-4


# ------------------------------------------------- (b) the exact twined path

def _twined_args(make, *a, spread, precise, **kw):
    args = make(*a, **kw)
    args.twine, args.twine_spread = 1, list(spread)
    args.twine_precise = precise
    return args


MOUNT_CASES = [("2x2", BOX2, False), ("2x2-precise", BOX2, True),
               ("3x3", BOX3, False), ("3x3-precise", BOX3, True)]


@pytest.mark.parametrize("name,spread,precise", MOUNT_CASES,
                         ids=[c[0] for c in MOUNT_CASES])
def test_twined_mount_matches_jax_and_oracle(env, name, spread, precise):
    """A full-spherical mount rendered twined to a rectilinear view:
    the port's ``render_frame`` on the CPU against the JAX package and
    the float64 oracle; ``--twine_precise`` is not inert."""
    proj, w, h, hfov, ypr = TP.RECTILINEAR, 48, 32, 70.0, (40.0, 25.0, 0.0)
    jf = make_facet(JP.SPHERICAL, 256, 128, 2 * math.pi)
    jargs = _twined_args(make_args, JP(int(proj)), w, h, hfov, [jf],
                         degree=1, yaw=ypr[0], pitch=ypr[1], spread=spread,
                         precise=precise)
    want = fw_render(jargs, [JE.make_mount_source(jf, env, 1, 1)])
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    src = TE.make_mount_source(tf, env, 1, 1, device="cpu")
    targs = _twined_args(port_args, proj, w, h, hfov, [tf], 1, *ypr,
                         spread=spread, precise=precise)
    plan = build_plan(targs, [tf])
    assert plan.spread == tuple(tuple(t) for t in spread)
    assert plan.twine_precise is precise
    got = render_frame(plan, [src], device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    ofct = O.MountFacet(O.SPHERICAL, 256, 128, 2 * math.pi, env, degree=1)
    t = dict(projection=O.RECTILINEAR, width=w, height=h,
             hfov=math.radians(hfov), yaw=math.radians(ypr[0]),
             pitch=math.radians(ypr[1]))
    p = O.psnr(got, O.render(t, [ofct], spread=spread,
                             twine_precise=precise))
    assert p > GOLDEN_DB, f"{name}: {p:.1f} dB"
    other = render_frame(dataclasses.replace(plan,
                                             twine_precise=not precise),
                         [src], device="cpu")
    assert not np.array_equal(got, other)


def _cubemap_sources(env, kind="cubemap", jax=True):
    """(JAX facet, JAX source, port facet, port source) of a 64-px
    cubemap or biatan6 stripe of ``env``, both sources built from the
    same faces; without ``jax`` the JAX entries are None."""
    jproj, tproj = (JP.CUBEMAP, TP.CUBEMAP) if kind == "cubemap" \
        else (JP.BIATAN6, TP.BIATAN6)
    faces = port_stripe(tproj, env).reshape(6, 64, 64, 3)
    jc = jsrc = None
    if jax:
        jc = make_facet(jproj, 64, 384, math.pi / 2)
        jsrc = JCBM.make_cubemap_source(jc, faces, 3, 3, support_min=8,
                                        tile_size=64)
    tc = port_facet(tproj, 64, 384, math.pi / 2)
    tsrc = TCBM.make_cubemap_source(tc, faces, 3, 3, 8, 64, device="cpu")
    return jc, jsrc, tc, tsrc


def test_twined_cubemap_source_matches_jax(env):
    """A cubemap source rendered twined to a rectilinear view that
    crosses cube edges: the exact path against the JAX package, and the
    inline twined route (its plain version) against the exact path."""
    jc, jsrc, tc, tsrc = _cubemap_sources(env)
    proj, w, h, hfov, ypr = TP.RECTILINEAR, 48, 32, 100.0, (40.0, 30.0, 0.0)
    jargs = _twined_args(make_args, JP(int(proj)), w, h, hfov, [jc],
                         degree=3, yaw=ypr[0], pitch=ypr[1], spread=BOX3,
                         precise=False)
    want = fw_render(jargs, [jsrc])
    plan = build_plan(_twined_args(port_args, proj, w, h, hfov, [tc], 3,
                                   *ypr, spread=BOX3, precise=False), [tc])
    got = render_frame(plan, [tsrc], device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    assert FP.inline_mode(plan, tsrc) == "cubemap"
    fast = FP.fused_frame(plan, tsrc, device="cpu")
    np.testing.assert_allclose(fast.numpy(), got, rtol=0,
                               atol=INLINE_ROUTE_TOL)


def _twined_operands(plan, src):
    """The planar twined kernel's operands of a twined plan over its
    frame: ``fastpath.twined_coords`` for a generic chain (a translated
    facet), the twined chain form's plain operands otherwise."""
    if plan.planar_to_ray[0] is not None:
        return FP.twined_coords(plan, FP.frame_window(plan), src)
    ops = FP.chain_operands(plan, src)
    return R.twined_chain_operands(
        ops["xfeat"], ops["yfeat"], ops["bmats"], ops["spread"],
        tmode=ops["tmode"], pick=ops["pick"], row0=ops["row0"],
        face_rows=ops["face_rows"], precise=ops["precise"],
        tap_valid=ops["tap_valid"])


@pytest.fixture(scope="module", params=["lens", "translated"])
def facet_job(request):
    """A partial lens-corrected facet and a translated facet (the
    fixtures of test_torch_planar.py) under a 3x3 spread."""
    jf, tf, jsrc, tsrc, (proj, w, h, hfov, ypr) = facet_sources(
        request.param)
    jargs = _twined_args(make_args, JP(int(proj)), w, h, hfov, [jf],
                         degree=3, yaw=ypr[0], pitch=ypr[1], roll=ypr[2],
                         spread=BOX3, precise=False)
    targs = _twined_args(port_args, proj, w, h, hfov, [tf], 3, *ypr,
                         spread=BOX3, precise=False)
    return dict(kind=request.param, jplan=jbuild_plan(jargs, [jf]),
                jsrc=jsrc, tplan=build_plan(targs, [tf]), tsrc=tsrc)


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


# ------------------------------------ (c) the inline twined kernel's plain

@pytest.fixture(scope="module")
def noise_mount():
    """The fixture of the JAX package's inline twined kernel test: a
    1024x512 noise equirect at degree 1, yawed 15 degrees, viewed at
    256x128 px, hfov 100, through a 2x2 box."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (512, 1024, 3)).astype(np.float32)
    jf = make_facet(JP.SPHERICAL, 1024, 512, 2 * math.pi,
                    yaw=math.radians(15))
    jsrc = JE.make_mount_source(jf, img, 1, 1)
    tf = port_facet(TP.SPHERICAL, 1024, 512, 2 * math.pi)
    tf.yaw = math.radians(15)
    tf.process_geometry()
    spl = jsrc.spl
    tsrc = TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(jsrc.static), spl.pad,
        spl.degree, spl.bcs, spl.core_shape, spl.spherical, device="cpu")
    spread = [(-0.25, -0.25, 0.25), (0.25, -0.25, 0.25),
              (-0.25, 0.25, 0.25), (0.25, 0.25, 0.25)]
    jargs = _twined_args(make_args, JP.RECTILINEAR, 256, 128, 100.0, [jf],
                         degree=1, spread=spread, precise=False)
    targs = _twined_args(port_args, TP.RECTILINEAR, 256, 128, 100.0, [tf], 1,
                         spread=spread, precise=False)
    return dict(jsrc=jsrc, tsrc=tsrc, jplan=jbuild_plan(jargs, [jf]),
                tplan=build_plan(targs, [tf]))


def test_inline_twined_plain_matches_jax_kernel(noise_mount):
    """``resample_inline_twined`` on the CPU (its plain version) against
    the JAX ``resample_inline_twined_into`` in interpret mode, one tile of
    the JAX planner's first pass."""
    jplan, jsrc = noise_mount["jplan"], noise_mount["jsrc"]
    window = (0, 128, 0, 256)
    spread = SYN.scaled_spread(jplan.spread)
    passes, assigned = JFP.plan_passes(jplan, jsrc, window,
                                       JFP.DEFAULT_CLASSES, spread=spread)
    assert (assigned >= 0).all()
    name, wc, _box, tiles, merge = passes[0]
    assert JFP._inline_eligible(jplan, jsrc, 0, name, spread, merge) == "sph"
    assert name == "orig", "the tile reads the source itself"
    tiles = np.asarray(tiles)[:1]
    spl = jsrc.spl
    stt = jsrc.static
    statics = (stt.total_extent.x0, stt.total_extent.x1, stt.total_extent.y0,
               stt.total_extent.y1, stt.total_width, stt.total_height,
               stt.window_x_offset, stt.window_y_offset)
    tmode, xfeat, yfeat, P, consts = JFP._inline_setup(
        JFP._geom_static(jplan), window, name, spl.core_shape, spl.pad,
        tuple(spl.bcs), statics, twined=True)
    bm = np.einsum("ij,fjk->fik", np.asarray(jplan.bases[0], np.float32),
                   P).reshape(-1, 9)
    coeffp = jnp.moveaxis(spl.coeff, -1, 0)
    want = PR.resample_inline_twined_into(
        jnp.zeros((3, 128, 256), jnp.float32), coeffp, jnp.asarray(tiles),
        jnp.zeros(1, jnp.int32), jnp.asarray(xfeat), jnp.asarray(yfeat),
        jnp.asarray(bm), jnp.asarray(np.asarray(spread, np.float32).ravel()),
        jnp.float32(0), degree=1, n_taps=4, tmode=tmode, consts=consts,
        wc=wc, interpret=True)
    want = np.moveaxis(np.asarray(want), 0, -1)

    tplan, tsrc = noise_mount["tplan"], noise_mount["tsrc"]
    ops = FP.frame_operands(tplan, tsrc)
    # both packages build the same doubled feature sets and constants
    np.testing.assert_array_equal(ops["xfeat"].numpy(), xfeat[:, 0, :])
    np.testing.assert_array_equal(ops["yfeat"].numpy(), yfeat[:, :, 0])
    assert ops["consts"] == consts and ops["tmode"] == tmode
    assert ops["n_taps"] == 4 and ops["precise"] is False
    np.testing.assert_allclose(ops["spread"].numpy(), np.asarray(spread))
    got = FP.fused_frame(tplan, tsrc, device="cpu").numpy()
    r, c = int(tiles[0, 2]) * PR.TILE_H, int(tiles[0, 3]) * PR.TILE_W
    sl = np.s_[r:r + PR.TILE_H, c:c + PR.TILE_W]
    np.testing.assert_allclose(got[sl], want[sl], rtol=0,
                               atol=INLINE_KERNEL_TOL)


INLINE_ROUTES = [
    # a spherical target pitched onto the pole, the seam through it
    ("pole-and-seam", TP.SPHERICAL, 96, 48, 360.0, (170.0, 80.0, 0.0), False),
    ("pole-and-seam-precise", TP.SPHERICAL, 96, 48, 360.0,
     (170.0, 80.0, 0.0), True),
    ("cubemap-target", TP.CUBEMAP, 24, 144, 90.0, (10.0, 0.0, 0.0), False),
    ("cylindrical", TP.CYLINDRICAL, 64, 32, 200.0, (175.0, 5.0, 0.0), False),
]


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


# ------------------------------------ (d) the planar twined kernel's plain

def _warp(degree=3, h=128, w=128, n_taps=4):
    """A noise table built by the JAX package, a gently warped field of
    padded coordinates inside it, constant derivative planes and a 2x2
    spread, as the JAX package's kernel tests use; one 128x128 tile."""
    rng = np.random.default_rng(11)
    img = jnp.asarray(rng.uniform(0, 1, (200, 240, 3)), jnp.float32)
    spl = JS.make_spline(img, degree, bcs=(JS.MIRROR, JS.MIRROR))
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = (40 + 0.9 * jj + 3 * np.sin(ii / 60)).astype(np.float32) + spl.pad
    py = (30 + 0.8 * ii + 2 * np.sin(jj / 70)).astype(np.float32) + spl.pad
    d = [np.full((h, w), v, np.float32) for v in (0.9, 0.2, -0.2, 0.8)]
    spread = np.asarray([(cx, cy, 0.1 + 0.1 * k) for k, (cx, cy) in enumerate(
        ((-0.5, -0.5), (0.5, -0.5), (-0.5, 0.5), (0.5, 0.5)))], np.float32)
    coeffp = jnp.moveaxis(spl.coeff, -1, 0)
    mx = 0.5 * abs(d[0]) + 0.5 * abs(d[2])
    my = 0.5 * abs(d[1]) + 0.5 * abs(d[3])
    stats = [np.asarray(s) for s in PR.tile_stats_range(
        jnp.asarray(px - mx), jnp.asarray(px + mx), jnp.asarray(py - my),
        jnp.asarray(py + my))]
    origins, fast = PR.classify_tiles(stats, coeffp.shape[1],
                                      coeffp.shape[2], degree, PR.ALIGNED)
    assert fast.all()
    tiles = np.array([[0, 0, 0, 0, origins[0, 0], origins[0, 1]]], np.int32)
    tiles = np.concatenate([tiles, PR.row_block_origins(
        stats, tiles, degree, PR.ALIGNED)], axis=1)
    return dict(spl=spl, coeffp=coeffp, planes=[px, py] + d, spread=spread,
                tiles=tiles, origins=origins, rng=rng, degree=degree)


def _jax_planes(f):
    return [jnp.asarray(a) for a in f["planes"]]


def _port_twined(f, out, **kw):
    return R.resample_twined(
        out, _t(f["spl"].coeff), *(_t(a) for a in f["planes"]),
        _t(f["spread"]), degree=f["degree"], n_taps=len(f["spread"]), **kw)


def test_twined_plain_matches_jax_merge_kernel():
    """K3 with a merge mask against the JAX
    ``resample_twined_into(..., merge_mask=...)``: kept pixels bit for
    bit, the others to the kernel tolerance."""
    f = _warp()
    mask = (f["rng"].uniform(size=(128, 128)) < 0.6).astype(np.float32)
    prior = f["rng"].uniform(2, 3, (3, 128, 128)).astype(np.float32)
    want = PR.resample_twined_into(
        jnp.asarray(prior), f["coeffp"], *_jax_planes(f),
        jnp.asarray(f["tiles"]), jnp.asarray(f["spread"].ravel()),
        degree=3, n_taps=4, wc=PR.ALIGNED, interpret=True,
        merge_mask=jnp.asarray(mask))
    want = np.moveaxis(np.asarray(want), 0, -1)
    out = _t(np.moveaxis(prior, 0, -1))
    got = _port_twined(f, out, merge_mask=_t(mask))
    assert got is out
    keep = mask <= 0.5
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    np.testing.assert_allclose(got.numpy()[~keep], want[~keep], rtol=0,
                               atol=PLANAR_KERNEL_TOL)


def test_twined_plain_matches_jax_champion_kernel():
    """K3 with per-pixel tap weights against the JAX kernel's
    champion-routed form: ``tap_weights = (champ == fi)``, for both
    facet ids of a seam-like champion field; 0 where no tap is the
    facet's."""
    f = _warp()
    ii, jj = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    champ = np.zeros((4, 128, 128), np.int32)
    for k in range(4):
        champ[k] = np.where(jj < 50 + 0.4 * ii + 7 * k, 0, 1)
        champ[k][(ii > 100 + 5 * k) & (jj > 100)] = -1
    for fi in (0, 1):
        flat = np.concatenate([f["spread"].ravel(),
                               np.asarray([fi], np.float32)])
        want = PR.resample_twined_into(
            jnp.zeros((3, 128, 128), jnp.float32), f["coeffp"],
            *_jax_planes(f), jnp.asarray(f["tiles"]), jnp.asarray(flat),
            degree=3, n_taps=4, wc=PR.ALIGNED, interpret=True,
            champ=jnp.asarray(champ))
        want = np.moveaxis(np.asarray(want), 0, -1)
        weights = torch.from_numpy(champ == fi)
        for tw in (weights, weights.to(torch.uint8),
                   weights.to(torch.float32)):
            got = _port_twined(f, torch.full((128, 128, 3), float("nan")),
                               tap_weights=tw).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=PLANAR_KERNEL_TOL)
        none = ~(champ == fi).any(axis=0)
        assert none.any() and not got[none].any()


def test_twined_plain_matches_jax_whole_frame_kernel():
    """K6: the plain version without a mask against the JAX
    ``resample_twined`` over the whole frame."""
    f = _warp()
    want = PR.resample_twined(
        f["coeffp"], *_jax_planes(f), jnp.asarray(f["origins"]),
        jnp.asarray(f["spread"].ravel()), degree=3, n_taps=4, cmax_x=0.5,
        cmax_y=0.5, wc=PR.ALIGNED, interpret=True)
    want = np.moveaxis(np.asarray(want), 0, -1)
    got = _port_twined(f, torch.full((128, 128, 3), float("nan"))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANAR_KERNEL_TOL)


def test_twined_contract_nonfinite_wrap_and_checks():
    """The wrapper's contract: NaN/inf planes stay harmless (clamped
    without a mask, untouched under one, unread under zero weights); a
    deflected x is wrapped by ``wrap_x``; bad operands raise; a bfloat16
    table renders what the float32 table it upcasts to renders."""
    rng = np.random.default_rng(12)
    table = _t(rng.uniform(-1, 1, (40, 72, 2)))
    h, w = 16, 24
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)
    planes = [rng.uniform(8, 60, (h, w)), rng.uniform(8, 30, (h, w))] + \
        [rng.uniform(-0.5, 0.5, (h, w)) for _ in range(4)]
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    dirty = []
    for a in planes:
        a = a.astype(np.float32)
        a[mask <= 0.5] = bad[rng.integers(0, 3, int((mask <= 0.5).sum()))]
        dirty.append(_t(a))
    spread = _t(SYN.scaled_spread(BOX2))
    kw = dict(degree=3, n_taps=4)
    full = R.resample_twined(torch.empty(h, w, 2), table, *dirty, spread,
                             **kw)
    assert bool(torch.isfinite(full).all())
    nan = torch.full((h, w, 2), float("nan"))
    kept = R.resample_twined(nan.clone(), table, *dirty, spread,
                             merge_mask=_t(mask), **kw)
    on = torch.from_numpy(mask > 0.5)
    assert bool(kept[~on].isnan().all())
    torch.testing.assert_close(kept[on], full[on], rtol=0, atol=0)
    live = torch.from_numpy(rng.uniform(size=(4, h, w)) < 0.6) & on
    weighted = R.resample_twined(nan.clone(), table, *dirty, spread,
                                 tap_weights=live, **kw)
    assert bool(torch.isfinite(weighted).all())
    assert not bool(weighted[~live.any(dim=0)].any())

    # periodic wrap: shifting the centre by one period changes nothing
    clean = [_t(a) for a in planes]
    period = (4.5, 60.0)
    a = R.resample_twined(torch.empty(h, w, 2), table, *clean, spread,
                          wrap_x=period, **kw)
    shifted = [clean[0] + 60.0] + clean[1:]
    b = R.resample_twined(torch.empty(h, w, 2), table, *shifted, spread,
                          wrap_x=period, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=2e-5)

    with pytest.raises(ValueError, match="exclude each other"):
        R.resample_twined(nan, table, *clean, spread, merge_mask=_t(mask),
                          tap_weights=live, **kw)
    with pytest.raises(ValueError, match="triplets"):
        R.resample_twined(nan, table, *clean, spread[:3], **kw)
    half = table.to(torch.bfloat16)
    torch.testing.assert_close(
        R.resample_twined(nan.clone(), half, *clean, spread, **kw),
        R.resample_twined(nan.clone(), half.float(), *clean, spread, **kw),
        rtol=0, atol=0)


# ----------------------------------------------- (e) the planar twined route

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


# ------------------------------------------------------- (f) twine_pyramid

def test_decimate_matches_jax():
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (64, 128, 3)).astype(np.float32)
    for level in (1, 2, 3):
        got = LD._decimate(img, level)
        assert got.shape == (64 >> level, 128 >> level, 3)
        np.testing.assert_array_equal(got, JLD._decimate(img, level))
    with pytest.raises(ValueError, match="divide"):
        LD._decimate(img[:63], 1)


def _cli_pair(tmp_path, monkeypatch, extra, name):
    """Run the same job through both CLIs on the CPU; returns (port
    image, JAX image)."""
    from envutil_tpu.runtime import assets as jassets
    from envutil_tpu.runtime import cli as jcli
    from envutil_tpu_torch.runtime import assets as tassets
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    src_path = tmp_path / "env.tif"
    if not src_path.exists():
        imgio.save_image(str(src_path), synthetic_equirect(512, 256))
    outs = []
    for tag, main, cache in (("t", cli.main, tassets), ("j", jcli.main,
                                                        jassets)):
        out = tmp_path / f"{name}_{tag}.tif"
        assert main(["--facet", str(src_path), "spherical", "360", "20", "0",
                     "0", "--projection", "rectilinear", "--hfov", "90",
                     "--width", "64", "--height", "48", "--degree", "1",
                     "--output", str(out)] + list(extra)) == 0
        cache.cache.clear()
        outs.append(imgio.read_image(str(out)))
    return outs


CLI_JOBS = [
    ("automatic", []),
    ("pyramid", ["--twine_pyramid"]),
    ("explicit", ["--twine", "3", "--twine_width", "1.5", "--twine_sigma",
                  "0.7", "--twine_threshold", "0.02", "--twine_precise"]),
]


@pytest.mark.parametrize("name,extra", CLI_JOBS, ids=[c[0] for c in CLI_JOBS])
def test_cli_twined_job_matches_jax_cli(tmp_path, monkeypatch, name, extra):
    """A downscale through the port's CLI without ``--twine 0`` (the
    automatic twine), with ``--twine_pyramid`` (the facet decimated at
    load) and with explicit twine options, against the JAX CLI."""
    got, want = _cli_pair(tmp_path, monkeypatch, extra, name)
    assert got.shape == want.shape == (48, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)


def test_cli_pyramid_decimates_and_twf_file_is_read(tmp_path, monkeypatch):
    """``--twine_pyramid`` really decimates (the facet's geometry and the
    cached asset shrink, the twine drops to 2x2 or fewer taps), and a
    ``--twf_file`` reaches ``twining.read_twf_file``."""
    from envutil_tpu_torch.runtime.args import parse_args
    src_path = tmp_path / "env.tif"
    imgio.save_image(str(src_path), synthetic_equirect(512, 256))
    base = ["--facet", str(src_path), "spherical", "360", "20", "0", "0",
            "--projection", "rectilinear", "--hfov", "90", "--width", "64",
            "--height", "48", "--degree", "1", "--output", "x.tif"]
    plain = parse_args(base)
    plain.twine_setup()
    pyr = parse_args(base + ["--twine_pyramid"])
    pyr.twine_setup()
    assert pyr.facets[0].pyramid_level >= 1
    assert pyr.facets[0].width == 512 >> pyr.facets[0].pyramid_level
    assert len(pyr.twine_spread) <= 4 < len(plain.twine_spread)
    src = LD.load_source(pyr.facets[0], pyr, "cpu")
    assert tuple(src.spl.core_shape) == (pyr.facets[0].height,
                                         pyr.facets[0].width)
    full = LD.load_source(plain.facets[0], plain, "cpu")
    assert tuple(full.spl.core_shape) == (256, 512), \
        "the asset cache keys on the pyramid level"

    twf = tmp_path / "k.twf"
    twf.write_text("-0.25 0 0.25\n0 0 0.5\n0.25 0 0.25\n")
    args = parse_args(base + ["--twf_file", str(twf), "--twine_width", "2"])
    args.twine_setup()
    assert args.twine_spread == [(-0.5, 0.0, 0.25), (0.0, 0.0, 0.5),
                                 (0.5, 0.0, 0.25)]
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    out = tmp_path / "twf.tif"
    assert cli.main(base[:-1] + [str(out), "--twf_file", str(twf),
                                 "--twine_width", "2"]) == 0
    lib = render_frame(build_plan(args, args.facets),
                       [LD.load_source(args.facets[0], args, "cpu")],
                       device="cpu")
    np.testing.assert_array_equal(imgio.read_image(str(out)), lib)


# ------------------------------------------------------------------ card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")


@pytest.mark.cuda
def test_inline_twined_kernel_matches_plain_on_card():
    """The inline twined kernel against its plain version on the card
    (needs a CUDA card and nvcc): a full sphere to a pitched spherical
    target, degrees 1 and 3, with and without --twine_precise."""
    _cuda_or_skip()
    env = synthetic_equirect()
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    for degree in (1, 3):
        src = TE.make_mount_source(tf, env, degree, degree, device="cuda")
        for precise in (False, True):
            plan = build_plan(_twined_args(
                port_args, TP.SPHERICAL, 96, 48, 360.0, [tf], degree, 170.0,
                80.0, 0.0, spread=BOX3, precise=precise), [tf])
            ops = FP.frame_operands(plan, src)
            tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats",
                                            "spread")]
            before = R.resample_inline_twined.launches
            k = R.resample_inline_twined(
                torch.empty(48, 96, 3, device="cuda"), src.spl.coeff,
                *tensors, **ops)
            p = R.resample_inline_twined_plain(
                torch.empty(48, 96, 3, device="cuda"), src.spl.coeff,
                *tensors, **ops)
            torch.cuda.synchronize()
            assert R.resample_inline_twined.launches == before + 1
            assert float((k - p).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_twined_kernel_matches_plain_on_card():
    """The planar twined kernel against its plain version on the card
    (needs a CUDA card and nvcc): no mask, merge mask, tap weights."""
    _cuda_or_skip()
    f = _warp()
    rng = np.random.default_rng(14)
    mask = torch.from_numpy((rng.uniform(size=(128, 128)) < 0.5).astype(
        np.float32)).cuda()
    live = torch.from_numpy(rng.uniform(size=(4, 128, 128)) < 0.6).cuda()
    args = [_t(f["spl"].coeff).cuda()] + [_t(a).cuda() for a in f["planes"]] \
        + [_t(f["spread"]).cuda()]
    for extra in ({}, dict(merge_mask=mask),
                  dict(tap_weights=live.to(torch.uint8))):
        nan = torch.full((128, 128, 3), float("nan"), device="cuda")
        before = R.resample_twined.launches
        k = R.resample_twined(nan.clone(), *args, degree=3, n_taps=4, **extra)
        p = R.resample_twined_plain(nan.clone(), *args, degree=3, n_taps=4,
                                    **extra)
        torch.cuda.synchronize()
        assert R.resample_twined.launches == before + 1
        assert torch.equal(k.isnan(), p.isnan())
        assert float((k - p).nan_to_num().abs().max()) <= 1e-5
