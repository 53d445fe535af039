"""The port's b-spline stack (envutil_tpu_torch.ops.spline) against the
JAX package's, on seeded numpy inputs.

Tolerances: extension, brace and gather steps move values unchanged, so
they are bit-equal. The prefilter is a float32 convolution of up to 65
taps per axis in both packages, summed in another order: 1e-6 of the
largest coefficient (a few float32 ulps; high degrees amplify the noise
inputs to coefficients of order 10). Evaluation and gates run in
float64 here, so they agree to 1e-12 (the gates' floor-mods are the
same operation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envutil_tpu.ops import spline as JS
from envutil_tpu_torch.ops import spline as TS

torch.set_num_threads(1)

BCS = [TS.MIRROR, TS.REFLECT, TS.PERIODIC, TS.NATURAL, TS.CONSTANT,
       TS.ZEROPAD]
PREFILTER_REL = 1e-6


def _close_prefiltered(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PREFILTER_REL * np.abs(want).max())


def _img(seed, h=24, w=48, c=3):
    return np.random.default_rng(seed).uniform(-1, 1, (h, w, c)).astype(
        np.float32)


@pytest.mark.parametrize("bc", BCS)
def test_extend_axis(bc):
    a = _img(1)
    for axis in (0, 1):
        want = np.asarray(JS.extend_axis(jnp.asarray(a), axis, 5, 3, bc))
        got = TS.extend_axis(torch.from_numpy(a), axis, 5, 3, bc).numpy()
        np.testing.assert_array_equal(got, want)
