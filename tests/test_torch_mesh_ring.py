"""``--shard_table`` in the port on the CPU (parallel/mesh.py): facet
tables in row bands over N CPU slots, evaluated by passing the bands
round a ring, against the port's replicated evaluation and the JAX
package's ring on its eight virtual CPU devices (tests/conftest.py).

Tolerances, each with its reason:

- the ring against the port's ``eval_spline`` and exact path:
  rtol = atol = 4e-7, the JAX package's own bound for its ring
  (tests/test_parallel.py): the same taps, weights and summation order;
  on the CPU the port's two are bit-equal.
- ``ring_spline_eval`` against the JAX ring on float32 coordinates:
  1e-6, the float32 evaluation of the same taps in two libraries.
- ``ring_sharded_render`` against the JAX ring render: 2e-5, where the
  port's one-device frames are held to 1e-5 of the JAX package
  (tests/test_torch_synopsis.py, whose exclusions of near-tied
  champions and window edges apply). The jobs are tests/test_parallel.py's
  at degree 3: seeded noise prefiltered to coefficients of +-3 whose
  spline changes by up to ~2 a source pixel, read at spline coordinates
  up to ~200, where a float32 coordinate's ulp is 1.5e-5 px. The port's
  one-device frame of the same jobs sits 1.32e-5 (solo) and 1.06e-5
  (voronoi) from the JAX frame, its ring frame is equal to it, and the
  JAX package's own ring and one-device frames are equal: the gap is
  the float32 coordinates' (the JAX reference runs float64 under the
  tests' x64 mode), not the ring's. tests/test_torch_mesh.py's jobs
  show it at degree 1 too: 1.08e-5 for the voronoi stitch of the same
  80x112 facets.
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_synopsis import (MAX_EXCLUDED_PX, _assert_close,
                                 _excluded, _stitch)

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.ops import spline as JS
from envutil_tpu.parallel import mesh as JM
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.ops import spline as S
from envutil_tpu_torch.parallel import mesh as PM
from envutil_tpu_torch.runtime.render import render_exact, render_frame

torch.set_num_threads(1)

RING_TOL = 4e-7
RING_JAX_TOL = 1e-6
RENDER_JAX_TOL = 2e-5
# the measured gap of the port's one-device frame to the JAX frame on
# these jobs (1.32e-5 at most, above), held so that the wider
# RENDER_JAX_TOL of the mesh and ring frames stays tied to it
ONE_DEVICE_JAX_GAP = 1.5e-5
RNG_SEED = 9


def _coords(h=64, w=128):
    """Float32 coordinates wandering over the whole table, out-of-range
    values for the gates included (tests/test_parallel.py)."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = (-20 + 1.3 * jj + 9 * np.sin(ii / 9)).astype(np.float32)
    y = (-5 + 1.6 * ii + 7 * np.cos(jj / 13)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("degree", [1, 3])
def test_ring_spline_eval_matches_eval_spline_and_jax(degree):
    img = np.random.default_rng(RNG_SEED).uniform(
        0, 1, (94, 130, 3)).astype(np.float32)
    jspl = JS.make_spline(jnp.asarray(img), degree,
                          bcs=(JS.MIRROR, JS.PERIODIC))
    spl = S.Spline2D(coeff=torch.from_numpy(np.array(jspl.coeff)),
                     pad=jspl.pad, degree=degree, bcs=tuple(jspl.bcs),
                     core_shape=tuple(jspl.core_shape))
    x, y = _coords()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    mesh = PM.make_mesh(["cpu"] * 8)
    sharded = PM.shard_spline_rows(spl, mesh)
    # the table's 94 + 2 pad rows padded to 8 bands
    assert len(sharded.bands) == 8 and sharded.rows == spl.coeff.shape[0]
    assert sharded.bands[0].shape[0] * 8 >= sharded.rows
    out = PM.ring_spline_eval(sharded, tx, ty, mesh)
    ref = S.eval_spline(spl, tx, ty)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RING_TOL,
                               atol=RING_TOL)

    jmesh = JM.make_mesh(jax.devices()[:8])
    want = JM.ring_spline_eval(JM.shard_spline_rows(jspl, jmesh),
                               jnp.asarray(x), jnp.asarray(y), jmesh)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=0, atol=RING_JAX_TOL)
    with pytest.raises(ValueError, match="divide the mesh axis"):
        PM.ring_spline_eval(sharded, tx[:60], ty[:60], mesh)


SOLO = dict(facets=[(JP.SPHERICAL, 192, 96, 360.0, {})],
            target=(TP.RECTILINEAR, 64, 64, 80.0, (30.0, 0.0, 0.0)),
            degree=3)
TWO = dict(facets=[(JP.RECTILINEAR, 112, 80, 70.0, dict(yaw=math.radians(y)))
                   for y in (-15.0, 15.0)],
           target=(TP.RECTILINEAR, 64, 64, 60.0, (0.0, 0.0, 0.0)), degree=3)


@pytest.mark.parametrize("case", ["solo", "voronoi"])
def test_ring_sharded_render_matches_exact_path_and_jax(case):
    """A frame from ring-sharded tables (tests/test_parallel.py's solo
    job and two-facet voronoi) against the port's exact path and the
    JAX package's ring render on its eight devices."""
    jsrcs, tsrcs, jplan, tplan = _stitch(SOLO if case == "solo" else TWO)
    mesh = PM.make_mesh(["cpu"] * 8)
    sharded = PM.shard_sources(tsrcs, mesh)
    assert all(len(s.spl.bands) == 8 for s in sharded)
    assert PM.shard_sources(tsrcs, mesh)[0].spl is sharded[0].spl
    out = PM.ring_sharded_render(tplan, sharded, mesh).numpy()
    single = render_exact(tplan, tsrcs).numpy()
    np.testing.assert_allclose(out, single, rtol=RING_TOL, atol=RING_TOL)

    jmesh = JM.make_mesh(jax.devices()[:8])
    jsharded = JM.shard_sources(jsrcs, jmesh)
    want = np.asarray(JM.ring_sharded_render(jplan, jsharded, jmesh)(
        jsharded), np.float32)
    skip = _excluded(tplan, tsrcs).numpy() if len(tsrcs) > 1 else \
        np.zeros(out.shape[:2], bool)
    assert int(skip.sum()) <= MAX_EXCLUDED_PX
    _assert_close(out, want, ~skip, f"{case}: ring vs JAX ring",
                  RENDER_JAX_TOL)
    _assert_close(single, want, ~skip, f"{case}: one device vs JAX ring",
                  ONE_DEVICE_JAX_GAP)


def test_render_frame_shard_table_option():
    """``render_frame(mesh_n=4, shard_table=True)``, the --shard_table
    path, against the one-device frame; an hdr_merge stitch through
    the ring as well; a twined job is not eligible."""
    _j, tsrcs, _jp, tplan = _stitch(SOLO, jax=False)
    single = render_frame(tplan, tsrcs, device="cpu")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        ringed = render_frame(tplan, tsrcs, device="cpu", mesh_n=4,
                              shard_table=True, verbose=True)
    assert "4 devices, ring-sharded tables" in said.getvalue()
    np.testing.assert_allclose(ringed, single, rtol=RING_TOL, atol=RING_TOL)
    hdr = dict(SOLO, facets=SOLO["facets"] * 3, brightens=(2.0, 1.0, 1.5),
               synopsis="hdr_merge")
    _j, tsrcs, _jp, tplan = _stitch(hdr, jax=False)
    np.testing.assert_allclose(
        render_frame(tplan, tsrcs, device="cpu", mesh_n=4, shard_table=True),
        render_frame(tplan, tsrcs, device="cpu"), rtol=RING_TOL,
        atol=RING_TOL)
    _j, tsrcs, _jp, twined = _stitch(TWO, [[0.0, 0.0, 1.0]], jax=False)
    assert not PM.shard_table_eligible(twined, tsrcs)
    assert PM.shard_table_eligible(tplan, tsrcs)
