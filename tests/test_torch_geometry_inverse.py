"""The port's ray -> planar maps against the reference's truth tables.
"""

import numpy as np
import pytest

from envutil_tpu_torch.core import geometry as TG
from envutil_tpu_torch.core.conventions import Projection as TP

from test_torch_geometry import (
    TRUTH, _t,
)


@pytest.mark.parametrize("key,proj", [
    ("ray_to_ll", TP.SPHERICAL), ("ray_to_rect", TP.RECTILINEAR),
    ("ray_to_ster", TP.STEREOGRAPHIC), ("ray_to_fish", TP.FISHEYE)])
def test_ray_to_planar_truth(key, proj):
    for case in TRUTH[key]:
        got = TG.to_plane(proj)(*(_t([v]) for v in case["ray"]))
        np.testing.assert_allclose(np.concatenate([g.numpy() for g in got]),
                                   case["p"], rtol=0, atol=1e-13)
