"""The port's spherical prefilter and brace, and the coordinate gates,
against the JAX package's.
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


@pytest.mark.parametrize("degree", [1, 2, 3, 5])
def test_spherical_prefilter_and_brace(degree):
    a = _img(degree + 20, h=16, w=32)
    jc = JS.spherical_prefilter(jnp.asarray(a), degree)
    tc = TS.spherical_prefilter(torch.from_numpy(a), degree)
    _close_prefiltered(tc.numpy(), np.asarray(jc))
    # brace the same coefficients in both packages: the over-the-pole
    # rows (0..3 and H-4..H-1 of the core and the frame beyond) must be
    # identical, not just close
    pad = 4
    jb = np.asarray(JS.spherical_brace(jnp.asarray(tc.numpy()), pad, pad))
    tb = TS.spherical_brace(tc, pad, pad).numpy()
    np.testing.assert_array_equal(tb, jb)
    h = a.shape[0]
    pole_rows = list(range(0, 2 * pad)) + list(range(h, h + 2 * pad))
    np.testing.assert_array_equal(tb[pole_rows], jb[pole_rows])
    # row -1-k of column x is row k of column x + W/2
    w = a.shape[1]
    core = tc.numpy()
    np.testing.assert_array_equal(tb[pad - 1, pad:pad + w],
                                  np.roll(core, w // 2, axis=1)[0])


@pytest.mark.parametrize("bc", [TS.MIRROR, TS.REFLECT, TS.PERIODIC,
                                TS.CONSTANT])
def test_gate(bc):
    c = np.random.default_rng(3).uniform(-70, 90, 4001)
    c[:6] = [-0.5, 0.0, 15.5, 16.0, -16.0, -31.25]
    for n in (1, 16, 17):
        want = np.asarray(JS.gate(jnp.asarray(c), bc, n))
        got = TS.gate(torch.from_numpy(c), bc, n).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
