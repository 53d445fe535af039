"""The frame's least time against counts made by hand, and the count
never above what the frame needs."""

import pytest
import torch

from benchmark.reference import exact
from benchmark.tests import tiny
from benchmark import job as J
from benchmark import harness as H


def test_spline_flops_by_hand():
    fr = H.module("counts", "frame_roofline")
    # degree 3, 3 channels: 2*4*3*2 + 16*3*2 + 4*3*2
    assert fr.spline_flops(3, 3) == 48 + 96 + 24
    assert fr.spline_flops(1, 1) == 8 + 8 + 4


def test_count_by_hand():
    fr = H.module("counts", "frame_roofline")
    touched = [torch.zeros(100, dtype=torch.bool) for _ in range(2)]
    touched[0][:10] = True
    touched[1][:5] = True
    work = dict(pixels=1000, taps=1, facets=2, live_taps=[300, 200],
                degree=3, channels=3, target="spherical",
                sources=["rectilinear", "rectilinear"], lenses=[True, False],
                entry_bytes=4, touched=touched)
    c = fr.count(work)
    assert c["table_bytes"] == 15 * 3 * 4
    assert c["out_bytes"] == 1000 * 3 * 4
    per_px = 17 + 12 + 1 * 2 * 5
    per_tap = 15 + 2 + 4 + 168
    assert c["flops"] == 1000 * per_px + 300 * (per_tap + 12) \
        + 200 * per_tap
    assert c["least_ms"] == max(c["bytes_ms"], c["ops_ms"])


@pytest.mark.parametrize("cell", ["eq_tiny.cube", "ring_tiny.pano"])
def test_reference_work(cell):
    cfg_name, traffic_name, _m, _r = tiny.CELLS[cell]
    config, traffic = tiny.CONFIGS[cfg_name], tiny.TRAFFIC[traffic_name]
    images = J.make_images(config, 99, "cpu")
    ref = exact.Reference(config, traffic, images, "cpu")
    ref.rows(0, traffic["height"] // 2)
    ref.rows(traffic["height"] // 2, traffic["height"])
    w = ref.work
    n_px = traffic["width"] * traffic["height"]
    assert w["pixels"] == n_px
    assert sum(w["live_taps"]) <= n_px
    for t, f in zip(w["touched"], ref.facets):
        # no more entries than the braced table holds
        assert int(t.sum()) <= f.table.coeff.shape[0] * f.table.coeff.shape[1]
    if len(ref.facets) == 1:
        # a full sphere: every pixel is the facet's
        assert w["live_taps"] == [n_px]
    else:
        assert 0 < sum(w["live_taps"]) < n_px
