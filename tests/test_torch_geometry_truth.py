"""The port's planar -> ray maps and the stepper's axes against the
reference's truth tables (tests/data), as test_torch_geometry holds
the JAX package's.
"""

import numpy as np
import pytest

from envutil_tpu.models import stepper as JST
from envutil_tpu_torch.core import geometry as TG
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import stepper as TST

from test_torch_geometry import (
    TRUTH, _t,
)


@pytest.mark.parametrize("key,proj", [
    ("ll_to_ray", TP.SPHERICAL), ("rect_to_ray", TP.RECTILINEAR),
    ("cyl_to_ray", TP.CYLINDRICAL), ("ster_to_ray", TP.STEREOGRAPHIC),
    ("fish_to_ray", TP.FISHEYE), ("ir_to_ray", TP.CUBEMAP),
    ("ba6_to_ray", TP.BIATAN6)])
def test_planar_to_ray_truth(key, proj):
    for case in TRUTH[key]:
        px, py = case["p"]
        got = TG.to_ray(proj)(_t([px]), _t([py]))
        np.testing.assert_allclose(np.concatenate([g.numpy() for g in got]),
                                   case["ray"], rtol=0, atol=1e-13)


def test_stepper_axis_truth():
    for case in TRUTH["stepper_axis"]:
        got = TST.planar_axis(case["n"], case["a0"], case["a1"],
                              case["bias"], dtype=np.float64)
        want = JST.planar_axis(case["n"], case["a0"], case["a1"],
                               case["bias"], dtype=np.float64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got[np.asarray(case["idx"], int)],
                                   case["values"], rtol=0, atol=1e-13)
