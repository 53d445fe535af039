"""The twined chain form's operands against the exact path's pickups,
and `planar_frame` through the chain forms against JAX `render_frame`.
The helpers and the bounds are test_torch_planar_chain's.
"""

import numpy as np
import pytest
import torch

from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.models import stepper as ST
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP

from test_torch_planar_chain import (
    COORD_TOL, FRAME_CASES, MAX_EDGE_PX, TWINED_CASES,
    _exact_twined_operands, _job, _near_face_edge, _near_window_edge,
)


@pytest.mark.parametrize("case", sorted(TWINED_CASES))
def test_twined_chain_operands_match_twined_coords(case):
    """Every operand the twined chain computes per pixel
    (``twined_chain_operands``: centre coordinates, coordinate
    derivatives, per-tap validity, wrap) against the same operands from
    the exact path's rays and pickups (forced-face pickups of a cubemap
    source, the periodic wrap of a full sphere under --twine_precise, the
    tap validity of a lens-corrected partial facet, none for a full
    fisheye)."""
    source, target, spread, precise = TWINED_CASES[case]
    _jsrc, tsrc, _jplan, tplan = _job(source, target, spread=spread,
                                      precise=precise)
    h, w = tplan.height, tplan.width
    window = (0, h, 0, w)
    ops = FP.chain_operands(tplan, tsrc)
    got = R.twined_chain_operands(
        ops["xfeat"], ops["yfeat"], ops["bmats"], ops["spread"],
        tmode=ops["tmode"], pick=ops["pick"], row0=ops["row0"],
        face_rows=ops["face_rows"], precise=precise,
        tap_valid=ops["tap_valid"])
    want = _exact_twined_operands(tplan, window, tsrc)
    assert got["wrap_x"] == want["wrap_x"]
    assert (got["tap_weights"] is None) == (want["tap_weights"] is None) \
        == (source in ("biatan6", "sphere") or case.startswith("fullfish"))
    p0, p10, p01 = ST.target_ninepack(
        tplan.projection, w, h, tplan.extent, basis=tplan.bases[0],
        window=window)
    compare = torch.ones((h, w), dtype=torch.bool)
    if source == "biatan6":
        compare = ~(_near_face_edge(p0) | _near_face_edge(p10)
                    | _near_face_edge(p01))
    if want["tap_weights"] is not None:
        du, dv = SYN.derivative_rays(p0, p10, p01, precise)
        edge = torch.zeros((len(spread), h, w), dtype=torch.bool)
        for k, (cx, cy, _w) in enumerate(SYN.scaled_spread(spread)):
            edge[k] = _near_window_edge(ops["pick"],
                                        SYN.deflect(p0, du, dv, cx, cy))
        differ = got["tap_weights"] != want["tap_weights"]
        assert not bool((differ & ~edge).any())
        assert int(differ.sum()) <= MAX_EDGE_PX
        compare = (want["tap_weights"].sum(dim=0) > 0) \
            & ~edge.any(dim=0)
    assert bool(compare.any())
    for k in ("sx", "sy", "dux", "duy", "dvx", "dvy"):
        err = float((got[k] - want[k])[compare].abs().max())
        assert err <= COORD_TOL, f"{case}: {k} differs by {err} px"


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_chain_frame_matches_jax(case):
    """``planar_frame`` through a chain form (its plain version on the
    CPU) against the JAX ``render_frame`` of the same job."""
    source, target, degree, nch, spread, tol = FRAME_CASES[case]
    jsrc, tsrc, jplan, tplan = _job(source, target, degree, nch, spread,
                                    precise=spread is not None)
    assert tplan.planar_to_ray[0] is None and \
        FP.inline_mode(tplan, tsrc) is None
    want = np.asarray(jrender_frame(jplan, [jsrc]))
    got = FP.planar_frame(tplan, tsrc, device="cpu").numpy()
    assert got.shape == want.shape == (tplan.height, tplan.width, nch)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert 0.0 < float((got != 0).any(axis=-1).mean())
