"""The port's planar-coordinates resampler (``resample_planar``, the
counterpart of the JAX kernels resample_planar_into and resample_planar)
and its render routes (``planar_frame``: the chain form, or
``fastpath.coords`` and the planes form for a translated facet) against
the JAX package, on the CPU.

The kernel's plain version is held against the JAX kernels in
interpret mode on identical padded coordinate planes and one table
(built by the JAX package, carried over as numpy). The coordinate pass
is held against the JAX ``_coords`` for a partial lens-corrected
rectilinear facet and a translated facet, and their renders against
the JAX ``render_frame``.

Tolerances, each with its reason:

- plain version vs the JAX kernels: 5e-5, the bound the JAX package's
  own kernel tests use against ``eval_spline`` (float32 sums of up to
  (n+1)^2 taps in another order); pixels a merge mask keeps are
  compared bit for bit.
- coordinates vs ``_coords``: 2e-3 px. The JAX reference rotates in
  float32 but evaluates the lens polynomial and the source projection
  on float64 (tests' x64 mode) where the port stays float32; on
  coordinates up to ~100 px a float32 chain of ~20 operations moves
  them by ~1e-4 px. A convention slip shows as >= 0.5 px.
- renders vs the JAX package: 1e-5 on the smooth golden fixture, as
  for the other slices; ``planar_frame`` vs ``render_frame``: 1e-5
  (the same coordinates, gated and padded, evaluated on the padded
  table).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_golden_oracle import (fw_render, make_args, make_facet,
                                synthetic_equirect)
from test_torch_render import port_args, port_facet

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.models import environment as JE
from envutil_tpu.ops import pallas_resample as PR
from envutil_tpu.ops import spline as JS
from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.ops import spline as S
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

KERNEL_TOL = 5e-5
COORD_TOL = 2e-3
JAX_TOL = 1e-5


def _planes(degree, nch=3, h=128, w=128, src=(160, 200)):
    """A noise table built by the JAX package (MIRROR, degree n) and a
    gently warped field of padded coordinates inside it, as the JAX
    package's kernel tests use."""
    rng = np.random.default_rng(5 + degree)
    img = jnp.asarray(rng.uniform(0, 1, src + (nch,)), jnp.float32)
    spl = JS.make_spline(img, degree, bcs=(JS.MIRROR, JS.MIRROR))
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = (30 + 0.9 * jj + 3 * np.sin(ii / 60)).astype(np.float32)
    sy = (10 + 0.8 * ii + 2 * np.sin(jj / 70)).astype(np.float32)
    return spl, sx + spl.pad, sy + spl.pad, rng


def _jax_tile(spl, px, py, degree):
    """The JAX planner's origin for the one 128x128 tile (TIGHT class,
    the smallest window, to keep interpret mode short)."""
    coeffp = jnp.moveaxis(spl.coeff, -1, 0)
    stats = [np.asarray(s) for s in PR.tile_stats(jnp.asarray(px),
                                                  jnp.asarray(py))]
    origins, fast = PR.classify_tiles(stats, coeffp.shape[1],
                                      coeffp.shape[2], degree, PR.TIGHT)
    assert fast.all()
    return coeffp, origins


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def test_k2_plain_matches_jax_merge_kernel():
    """K2: the plain version with a merge mask against the JAX
    ``resample_planar_into(..., merge_mask=...)`` (degree 3)."""
    degree = 3
    spl, px, py, rng = _planes(degree)
    coeffp, origins = _jax_tile(spl, px, py, degree)
    tiles = np.array([[0, 0, 0, 0, origins[0, 0], origins[0, 1]]], np.int32)
    mask = (rng.uniform(size=px.shape) < 0.6).astype(np.float32)
    prior = rng.uniform(2, 3, (3,) + px.shape).astype(np.float32)
    want = PR.resample_planar_into(
        jnp.asarray(prior), coeffp, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(tiles), degree=degree, wc=PR.TIGHT, interpret=True,
        merge_mask=jnp.asarray(mask))
    want = np.moveaxis(np.asarray(want), 0, -1)
    out = _t(np.moveaxis(prior, 0, -1))
    got = R.resample_planar(out, _t(spl.coeff), _t(px), _t(py),
                            degree=degree, merge_mask=_t(mask))
    assert got is out
    keep = mask <= 0.5
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    np.testing.assert_allclose(got.numpy()[~keep], want[~keep], rtol=0,
                               atol=KERNEL_TOL)


def test_k5_plain_matches_jax_kernel():
    """K5: the plain version without a mask against the JAX
    ``resample_planar`` over the whole frame (degree 1)."""
    degree = 1
    spl, px, py, _rng = _planes(degree)
    coeffp, origins = _jax_tile(spl, px, py, degree)
    want = PR.resample_planar(coeffp, jnp.asarray(px), jnp.asarray(py),
                              jnp.asarray(origins), degree=degree,
                              wc=PR.TIGHT, interpret=True)
    want = np.moveaxis(np.asarray(want), 0, -1)
    got = R.resample_planar(torch.full(want.shape, float("nan")),
                            _t(spl.coeff), _t(px), _t(py), degree=degree)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KERNEL_TOL)


@pytest.mark.parametrize("degree", range(8))
def test_plain_matches_jax_eval_spline(degree):
    """Every degree the kernel instantiates: the plain version against
    the JAX ``eval_spline`` on the same table and coordinates."""
    spl, px, py, _rng = _planes(degree, nch=4, h=24, w=40, src=(48, 80))
    want = np.asarray(JS.eval_spline(spl, jnp.asarray(px - spl.pad),
                                     jnp.asarray(py - spl.pad),
                                     apply_gate=False))
    got = R.resample_planar(torch.empty(want.shape), _t(spl.coeff), _t(px),
                            _t(py), degree=degree)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KERNEL_TOL)


def _nonfinite_planes(rng, shape, mask):
    """Coordinate planes with NaN and +-inf where the mask is 0, as
    grazing and backward rays of a partial facet give them."""
    sx = rng.uniform(5, 60, shape).astype(np.float32)
    sy = rng.uniform(5, 60, shape).astype(np.float32)
    bad = np.array([np.nan, np.inf, -np.inf, 3e38], np.float32)
    off = mask <= 0.5
    sx[off] = bad[rng.integers(0, 4, int(off.sum()))]
    sy[off] = bad[rng.integers(0, 4, int(off.sum()))]
    return sx, sy


def test_merge_mask_leaves_out_untouched_and_nonfinite_coords():
    """The merge-mask contract: where the mask is <= 0.5, ``out`` keeps
    its NaN sentinel bit for bit, whatever the coordinates there (NaN,
    +-inf); covered pixels equal ``eval_spline``. Without a mask the
    same non-finite coordinates give finite values (clamped, never
    converted to an integer)."""
    rng = np.random.default_rng(9)
    table = _t(rng.uniform(-1, 1, (70, 80, 3)))
    mask = (rng.uniform(size=(32, 48)) < 0.5).astype(np.float32)
    sx, sy = _nonfinite_planes(rng, mask.shape, mask)
    out = torch.full((32, 48, 3), float("nan"))
    R.resample_planar(out, table, _t(sx), _t(sy), degree=3,
                      merge_mask=_t(mask))
    keep = torch.from_numpy(mask <= 0.5)
    sentinel = torch.full((1,), float("nan")).view(torch.int32)
    assert bool((out[keep].view(torch.int32) == sentinel).all())
    spl = S.Spline2D(coeff=table, pad=0, degree=3,
                     bcs=(S.CONSTANT, S.CONSTANT), core_shape=(70, 80))
    on = ~keep
    want = S.eval_spline(spl, _t(sx)[on], _t(sy)[on], apply_gate=False)
    torch.testing.assert_close(out[on], want, rtol=0, atol=1e-6)
    full = R.resample_planar(torch.empty((32, 48, 3)), table, _t(sx),
                             _t(sy), degree=3)
    assert bool(torch.isfinite(full).all())


# ---------------------------------------------------------------- route

def _sources(kind):
    """(JAX facet, port facet, JAX source, port source, target) for a
    partial lens-corrected facet or a translated facet, the image a
    rectilinear view of the golden fixture rendered by the JAX package."""
    env = synthetic_equirect()
    jf0 = make_facet(JP.SPHERICAL, 256, 128, 2 * math.pi)
    img = fw_render(make_args(JP.RECTILINEAR, 96, 72, 72.0, [jf0], degree=3,
                              yaw=20.0, pitch=5.0),
                    [JE.make_mount_source(jf0, env, 3, 3)])
    if kind == "lens":
        kw = dict(a=0.01, b=-0.02, c=0.005, yaw=math.radians(20),
                  pitch=math.radians(5))
        target = (TP.SPHERICAL, 192, 96, 360.0, (0.0, 0.0, 0.0))
    else:
        kw = dict(tr_x=0.15, tr_y=-0.05, tr_z=0.1, yaw=math.radians(20),
                  pitch=math.radians(5))
        target = (TP.RECTILINEAR, 80, 64, 90.0, (15.0, 5.0, 0.0))
    jf = make_facet(JP.RECTILINEAR, 96, 72, math.radians(72), **kw)
    tf = port_facet(TP.RECTILINEAR, 96, 72, math.radians(72))
    for k, v in kw.items():
        setattr(tf, k, v)
    tf.process_geometry()
    jsrc = JE.make_mount_source(jf, img, 3, 3)
    tsrc = TE.make_mount_source(tf, img, 3, 3, device="cpu")
    return jf, tf, jsrc, tsrc, target


@pytest.fixture(scope="module", params=["lens", "translated"])
def facet_job(request):
    jf, tf, jsrc, tsrc, (proj, w, h, hfov, ypr) = _sources(request.param)
    jplan = jbuild_plan(make_args(JP(int(proj)), w, h, hfov, [jf], degree=3,
                                  yaw=ypr[0], pitch=ypr[1], roll=ypr[2]),
                        [jf])
    tplan = build_plan(port_args(proj, w, h, hfov, [tf], 3, *ypr), [tf])
    return dict(kind=request.param, jf=jf, tf=tf, jsrc=jsrc, tsrc=tsrc,
                jplan=jplan, tplan=tplan, shape=(h, w))


def test_coords_match_jax_coords(facet_job):
    """The port's coordinates against the JAX ``_coords`` ("orig"): the
    same validity mask and, where it holds, the same padded coordinates.
    The translated facet's come from ``fastpath.coords`` (its generic
    chain), the lens facet's from the planar chain form's plain chain
    (``planar_chain_coords``); for the translated facet the z of the
    facet-CS ray as well."""
    jplan, tplan = facet_job["jplan"], facet_job["tplan"]
    h, w = facet_job["shape"]
    window = (0, h, 0, w)
    jsx, jsy, jmask, jz = JFP._coords(JFP._geom_static(jplan), window,
                                      "orig", facet_job["jsrc"], 0,
                                      (0.0, 0.0), JFP._basis_arg(jplan, 0))
    if facet_job["kind"] == "translated":
        assert tplan.bases[0] is None and tplan.planar_to_ray[0] is not None
        sx, sy, mask, z = FP.coords(tplan, window, facet_job["tsrc"])
        np.testing.assert_allclose(z.numpy()[np.asarray(jmask)],
                                   np.asarray(jz)[np.asarray(jmask)],
                                   rtol=0, atol=1e-6)
    else:
        assert tplan.planar_to_ray[0] is None
        ops = FP.chain_operands(tplan, facet_job["tsrc"])
        sx, sy, mask = R.planar_chain_coords(
            ops["xfeat"], ops["yfeat"], ops["bmats"], tmode=ops["tmode"],
            pick=ops["pick"], row0=ops["row0"], face_rows=ops["face_rows"])
    jmask = np.asarray(jmask)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert 0.02 < jmask.mean() < 0.98, "the facet covers part of the view"
    np.testing.assert_allclose(sx.numpy()[jmask], np.asarray(jsx)[jmask],
                               rtol=0, atol=COORD_TOL)
    np.testing.assert_allclose(sy.numpy()[jmask], np.asarray(jsy)[jmask],
                               rtol=0, atol=COORD_TOL)


def test_render_matches_jax(facet_job):
    """The job's ``render_frame`` on the CPU against the JAX package, and
    ``planar_frame`` (the CUDA route's chain, run as its plain version)
    against ``render_frame``: misses are 0 in both."""
    want = np.asarray(jrender_frame(facet_job["jplan"], [facet_job["jsrc"]]))
    got = render_frame(facet_job["tplan"], [facet_job["tsrc"]], device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    assert FP.inline_mode(facet_job["tplan"], facet_job["tsrc"]) is None
    buf = torch.full(got.shape, float("nan"))
    fast = FP.planar_frame(facet_job["tplan"], facet_job["tsrc"], out=buf,
                           device="cpu")
    assert fast is buf
    np.testing.assert_allclose(fast.numpy(), got, rtol=0, atol=JAX_TOL)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The planar kernel against its plain version on the card: degrees
    0-7, 1/3/4 channels, with and without a merge mask, NaN sentinel
    and non-finite coordinates where the mask is 0 (needs a CUDA card
    and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    rng = np.random.default_rng(4)
    mask = (rng.uniform(size=(40, 56)) < 0.5).astype(np.float32)
    sx, sy = _nonfinite_planes(rng, mask.shape, mask)
    for degree in range(8):
        for nch in (1, 3, 4):
            table = _t(rng.uniform(-1, 1, (70, 80, nch))).cuda()
            for m in (None, _t(mask).cuda()):
                args = (table, _t(sx).cuda(), _t(sy).cuda())
                nan = torch.full((40, 56, nch), float("nan"), device="cuda")
                before = R.resample_planar.launches
                k = R.resample_planar(nan.clone(), *args, degree=degree,
                                      merge_mask=m)
                p = R.resample_planar_plain(nan.clone(), *args,
                                            degree=degree, merge_mask=m)
                torch.cuda.synchronize()
                assert R.resample_planar.launches == before + 1
                assert torch.equal(k.isnan(), p.isnan())
                assert float((k - p).nan_to_num().abs().max()) <= 1e-5
