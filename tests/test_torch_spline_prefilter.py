"""The port's b-spline prefilter against the JAX package's, degrees 0-7
(relative bound PREFILTER_REL of test_torch_spline).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envutil_tpu.ops import spline as JS
from envutil_tpu_torch.ops import spline as TS

from test_torch_spline import (
    _close_prefiltered, _img,
)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 5])
def test_prefilter(degree):
    a = _img(degree + 2)
    bcs = (TS.REFLECT, TS.PERIODIC)
    want = np.asarray(JS.prefilter(jnp.asarray(a), degree, bcs))
    got = TS.prefilter(torch.from_numpy(a), degree, bcs).numpy()
    _close_prefiltered(got, want)
