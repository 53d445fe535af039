"""The reference against the port's exact path on the CPU (a float32
frozen copy of the same mathematics) at a tiny size, on every job shape
of the cells: a cubemap and a twined view of an equirect, a voronoi
stitch of lens-corrected facets untwined and twined."""

import pytest
import torch

from benchmark import job as J
from benchmark.reference import exact
from benchmark.tests import tiny
from envutil_tpu_torch.runtime import render


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_reference_matches_exact_path(cell):
    cfg_name, traffic_name, _mx, _rms = tiny.CELLS[cell]
    config, traffic = tiny.CONFIGS[cfg_name], tiny.TRAFFIC[traffic_name]
    images = J.make_images(config, 271828182845904, "cpu")
    _args, sources, plan, _ms = J.build(config, traffic, images, "cpu")
    ex = render.render_exact(plan, sources, device="cpu").double()
    ref = exact.Reference(config, traffic, images, "cpu")
    assert (ref.job.spread is None) == (plan.spread is None)
    if plan.spread is not None:
        assert len(ref.job.spread) == len(plan.spread)
    value, slack, ambiguous = ref.rows(0, traffic["height"])
    gap = ((ex - value).abs() - slack).clamp(min=0.0)
    # float32 chains against float64: a few 1e-6 at this size
    assert float(gap.max()) < 2e-5
    assert int(ambiguous.sum()) < 1e-3 * ambiguous.numel()
    # the decisions within rounding are few, and take their slack
    assert float(slack.max()) == 0.0 or int(ambiguous.sum()) > 0


def test_images_follow_the_seed():
    config = tiny.CONFIGS["ring_tiny"]
    a = J.make_images(config, 2 ** 62 + 11, "cpu")
    b = J.make_images(config, 2 ** 62 + 11, "cpu")
    c = J.make_images(config, 2 ** 62 + 12, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    assert abs(float(a[0].mean()) - 0.5) < 0.05
    assert abs(float(a[0].std()) - 0.25) < 0.05


def test_argv_parses_as_the_command_line():
    from envutil_tpu_torch.core.conventions import Projection
    config = tiny.CONFIGS["ring_tiny"]
    images = J.make_images(config, 5, "cpu")
    args, sources, plan, _ms = J.build(config, tiny.TRAFFIC["pano2_tiny"],
                                       images, "cpu")
    assert len(sources) == 6 and plan.spread is not None
    assert len(plan.spread) == 4
    assert all(f.has_lcp and f.a == 0.01 for f in args.facets)
    assert args.projection == Projection.SPHERICAL
    assert abs(args.facets[2].yaw - torch.pi * 2 / 3) < 1e-12
