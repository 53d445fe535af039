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
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.core.metrics import get_extent
from envutil_tpu_torch.core.rotation import rotation_rpy
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.models import cubemap as TCBM
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import stepper as ST
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import cli
from envutil_tpu_torch.runtime import fastpath as FP
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


INLINE_ROUTES = [
    # a spherical target pitched onto the pole, the seam through it
    ("pole-and-seam", TP.SPHERICAL, 96, 48, 360.0, (170.0, 80.0, 0.0), False),
    ("pole-and-seam-precise", TP.SPHERICAL, 96, 48, 360.0,
     (170.0, 80.0, 0.0), True),
    ("cubemap-target", TP.CUBEMAP, 24, 144, 90.0, (10.0, 0.0, 0.0), False),
    ("cylindrical", TP.CYLINDRICAL, 64, 32, 200.0, (175.0, 5.0, 0.0), False),
]


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


# ----------------------------------------------- (e) the planar twined route


# ------------------------------------------------------- (f) twine_pyramid


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


# ------------------------------------------------------------------ card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
