"""The chain forms' compact grid against the JAX package, on the CPU:
the pixels of each facet's block list (``fastpath.block_list``) hold
every pixel of the JAX ``_coords`` validity mask, the coverage from
which the JAX planner lists a facet's tiles (``plan_passes`` marks every
tile without a hit ``ZERO_PASS``), on a small config-5-like stitch; and
the stitch on the lists (the kernels' plain versions; a voronoi stitch
through ``fastpath.voronoi_frame``, whose champion pass runs over the
lists, and through ``fastpath.multi_frame``) is bit-equal to itself on
full-window launches and agrees with the JAX ``render_frame``,
untwined and twined at 2x2 taps.

Tables are built by the JAX package and carried over as numpy
(tests/test_torch_synopsis.py ``_stitch``): three 64x48 rectilinear
facets, hfov 65, yaws -40/0/40 (config 5's layout) into a 192x96
equirect, where each facet's list holds a part of the 12 x 6 blocks.

Tolerances, each with its reason:

- block lists and full-window launches: bit for bit (the same
  arithmetic on the same pixels, and the fill where a ray misses).
- the JAX mask inside the listed pixels: exact; the JAX chain runs in
  float64 (the tests' x64) where the port's runs in float32, so the two
  masks may differ at a window's edge, inside the list's margin of one
  block.
- untwined frames against JAX: 1e-5, as tests/test_torch_synopsis.py,
  near-tied champions and window edges excluded and counted.
- twined frames against JAX: the twined chain form's route bound of
  tests/test_torch_twined_stitch.py (ROUTE_TOL, 2e-2, plus 1e-5): the
  kernel deflects each tap in coordinate space and the JAX exact graph
  the ray, a second-order term in the tap offset at 1.9-degree pixels;
  the compact grid moves no pixel, which the bit-equality above holds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_twined_stitch as TS
from test_torch_synopsis import (CASES, JAX_TOL, MAX_EXCLUDED_PX, _excluded,
                                 _stitch)
from test_torch_twined_stitch import ROUTE_TOL

from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP

torch.set_num_threads(1)

CONFIG5 = dict(CASES["voronoi, 3 rectilinear facets"],
               facets=[(f[0], 64, 48, 65.0, f[4]) for f in
                       CASES["voronoi, 3 rectilinear facets"]["facets"]],
               target=(CASES["voronoi, 3 rectilinear facets"]["target"][0],
                       192, 96, 360.0, (0.0, 0.0, 0.0)))
BOX2 = [[-0.25, -0.25, 0.25], [0.25, -0.25, 0.25], [-0.25, 0.25, 0.25],
        [0.25, 0.25, 0.25]]


def test_lists_hold_the_jax_coverage():
    """Each facet's listed pixels hold every pixel of the JAX ``_coords``
    mask of that facet (``plan_passes``' coverage), and the lists are
    compact: each holds less than the window."""
    jsrcs, tsrcs, jplan, tplan = _stitch(CONFIG5)
    window = (0, tplan.height, 0, tplan.width)
    nby, nbx = R.block_grid(tplan.height, tplan.width)
    for fi, (fplan, src) in enumerate(zip(FP.facet_plans(tplan), tsrcs)):
        _sx, _sy, jmask, _z = JFP._coords(
            JFP._geom_static(jplan), window, "orig", jsrcs[fi], fi,
            (0.0, 0.0), JFP._basis_arg(jplan, fi))
        jmask = torch.from_numpy(np.array(jmask))
        blocks = FP.block_list(fplan, src)
        assert blocks is not None and blocks.numel() < nby * nbx
        listed = R.block_pixels(blocks, tplan.height, tplan.width)
        assert bool(jmask.any())
        assert not bool((jmask & ~listed).any()), f"facet {fi}"
        print(f"facet {fi}: {blocks.numel()} of {nby * nbx} blocks listed, "
              f"{int(jmask.sum())} px of the JAX mask inside")


@pytest.mark.parametrize("twined", [False, True])
def test_multi_frame_on_lists(twined, monkeypatch):
    """The voronoi stitch through ``stitch_frame`` (``voronoi_frame``: one
    launch a facet, the champion pass over each facet's block list) and
    through ``multi_frame`` (a twined stitch: F x K one-tap launches on F
    lists), each against itself with full-window launches
    (``block_list`` answering None; the voronoi route's champion pass
    then runs over every block, on a plan made anew), bit for bit, and
    against the JAX ``render_frame`` (1e-5 untwined; twined, the twined
    chain form's route bound)."""
    spread = BOX2 if twined else None
    jsrcs, tsrcs, jplan, tplan = _stitch(CONFIG5, spread)
    builds = FP.block_list.builds
    log = []
    listed = FP.stitch_frame(tplan, tsrcs, log=log).numpy()
    assert FP.block_list.builds == builds + len(tsrcs)
    kernel = "resample_twined_chain" if twined else "resample_planar_chain"
    assert log == [kernel] * len(tsrcs)
    stack_log = []
    stacked = FP.multi_frame(tplan, tsrcs, log=stack_log).numpy()
    assert stack_log == [kernel] * (len(tsrcs) * (4 if twined else 1))
    fplans = FP.facet_plans(tplan) if not twined \
        else FP.tap_plans(tplan)[0][1]
    assert all(FP.blocks_text(fp, s, kernel).startswith(" over ")
               and " of " in FP.blocks_text(fp, s, kernel)
               for fp, s in zip(fplans, tsrcs))
    with monkeypatch.context() as m:
        m.setattr(FP, "block_list", lambda plan, src: None)
        full = FP.stitch_frame(dataclasses.replace(tplan), tsrcs).numpy()
        full_stacked = FP.multi_frame(tplan, tsrcs).numpy()
    np.testing.assert_array_equal(listed, full)
    np.testing.assert_array_equal(stacked, full_stacked)
    assert float(np.abs(listed - stacked).max()) <= JAX_TOL
    want = np.asarray(jrender_frame(jplan, jsrcs))
    skip = (TS._excluded if twined else _excluded)(tplan, tsrcs).numpy()
    n_skip = int(skip.sum())
    assert n_skip <= MAX_EXCLUDED_PX * (4 if twined else 1)
    err = float(np.abs(listed - want).max(axis=-1)[~skip].max())
    tol = ROUTE_TOL + JAX_TOL if twined else JAX_TOL
    print(f"twined {twined}: listed frame vs JAX {err:.3e} (bound {tol:g}),"
          f" {n_skip} px excluded")
    assert err <= tol
    assert (listed != 0).any(axis=-1).mean() > 0.1
