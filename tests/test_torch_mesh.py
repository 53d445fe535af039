"""``--mesh N`` in the port on the CPU (parallel/mesh.py,
runtime/render.render_frame(mesh_n=...)): the frame's output rows in N
bands, band k on the k-th of N CPU slots, against the port's
one-device frame and the JAX package's ``render_frame``.

The jobs are those of tests/test_parallel.py at its sizes (seeded
noise sources of 64x128 and 80x112, 64x64 views, degree 3): a single
full-spherical facet, a voronoi stitch of two rectilinear facets, an
hdr_merge stitch of three full-spherical brackets and the voronoi
stitch twined (2x2 taps, degree 1). Each job is rendered three ways on
the port:

- ``render_frame(mesh_n=4)`` on the CPU: the exact path per band
  (``mesh.sharded_render``); bit-equal to the one-device frame, since
  every pixel is computed from its absolute coordinates;
- ``fastpath.render_fast_mesh`` over four CPU slots: each band through
  the card route (the kernels' plain versions here); bit-equal to
  ``fastpath.render_fast`` of the whole frame;
- against the JAX package's one-device ``render_frame``: 2e-5
  (tests/test_torch_mesh_ring.py says why it is wider than the 1e-5 of
  tests/test_torch_synopsis.py, whose exclusions of near-tied champions
  and window edges apply: the float32 coordinates at these sources'
  pixel sizes, in the one-device frame alike).

Nothing here calls a JAX Pallas kernel or JAX ``render_fast_mesh``.
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

from test_torch_mesh_ring import ONE_DEVICE_JAX_GAP, RENDER_JAX_TOL
from test_torch_synopsis import (MAX_EXCLUDED_PX, _assert_close, _excluded,
                                 _stitch)

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.parallel import mesh as PM
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import render_frame

torch.set_num_threads(1)

SPREAD = [[-0.25, -0.25, 0.25], [0.25, -0.25, 0.25],
          [-0.25, 0.25, 0.25], [0.25, 0.25, 0.25]]
TWO_FACETS = [(JP.RECTILINEAR, 112, 80, 70.0, dict(yaw=math.radians(y)))
              for y in (-15.0, 15.0)]
VIEW = (TP.RECTILINEAR, 64, 64, 60.0, (0.0, 0.0, 0.0))
CASES = {
    "solo": (dict(facets=[(JP.SPHERICAL, 128, 64, 360.0, {})],
                  target=(TP.RECTILINEAR, 64, 64, 80.0, (30.0, 0.0, 0.0)),
                  degree=3), None),
    "voronoi": (dict(facets=TWO_FACETS, target=VIEW, degree=3), None),
    "hdr_merge": (dict(facets=[(JP.SPHERICAL, 128, 64, 360.0, {})] * 3,
                       brightens=(2.0, 1.0, 1.5), synopsis="hdr_merge",
                       target=(TP.RECTILINEAR, 64, 64, 100.0,
                               (-20.0, 10.0, 0.0)), degree=3), None),
    "voronoi twined": (dict(facets=TWO_FACETS, target=VIEW, degree=1),
                       SPREAD),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_frame_bit_equal_and_matches_jax(case):
    spec, spread = CASES[case]
    jsrcs, tsrcs, jplan, tplan = _stitch(spec, spread)
    single = render_frame(tplan, tsrcs, device="cpu")
    meshed = render_frame(tplan, tsrcs, device="cpu", mesh_n=4)
    np.testing.assert_array_equal(meshed, single)
    want = np.asarray(jrender_frame(jplan, jsrcs))
    skip = _excluded(tplan, tsrcs).numpy() if len(tsrcs) > 1 else \
        np.zeros(single.shape[:2], bool)
    assert int(skip.sum()) <= MAX_EXCLUDED_PX
    _assert_close(meshed, want, ~skip, f"{case}: --mesh 4 vs JAX",
                  RENDER_JAX_TOL)
    _assert_close(single, want, ~skip, f"{case}: one device vs JAX",
                  ONE_DEVICE_JAX_GAP)
    assert float((meshed != 0).any(axis=-1).mean()) > 0.5

    # the card route band by band (plain versions on the CPU slots)
    mesh = PM.make_mesh(["cpu"] * 4)
    np.testing.assert_array_equal(FP.render_fast_mesh(tplan, tsrcs, mesh),
                                  FP.render_fast(tplan, tsrcs))


def test_mesh_fallback_when_the_height_does_not_divide():
    """``mesh_n=7`` on 64 rows renders on one device, with the JAX
    package's message; so does ``mesh_n=4`` with three devices named,
    and ``shard_table`` on a twined job takes the replicated tables."""
    _j, tsrcs, _jp, tplan = _stitch(*CASES["voronoi twined"], jax=False)
    single = render_frame(tplan, tsrcs, device="cpu")
    for kw, message in (
            (dict(mesh_n=7), "--mesh 7: output height 64 not divisible "
                             "by 7; rendering on one\n"),
            (dict(mesh_n=4, devices=["cpu"] * 3),
             "--mesh 4: only 3 device(s) available; rendering on one\n"),
            (dict(mesh_n=4, shard_table=True),
             "--shard_table: job not eligible (twining or masking); "
             "rendering with replicated tables\n")):
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            img = render_frame(tplan, tsrcs, device="cpu", **kw)
        assert said.getvalue() == message
        np.testing.assert_array_equal(img, single)
    with pytest.raises(ValueError, match="not all of the render's type"):
        render_frame(tplan, tsrcs, device="cpu", mesh_n=2,
                     devices=["cpu", "meta"])
