"""The port's spline evaluation against the JAX package's, degrees 0-7.
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
def test_eval_spline(degree):
    a = _img(degree + 40, h=16, w=32)
    jspl = JS.make_spline(jnp.asarray(a), degree, degree, spherical=True)
    tspl = TS.make_spline(torch.from_numpy(a), degree, degree,
                          spherical=True)
    _close_prefiltered(tspl.coeff.numpy(), np.asarray(jspl.coeff))
    assert (tspl.pad, tspl.bcs, tspl.core_shape) == \
        (jspl.pad, jspl.bcs, tuple(jspl.core_shape))
    # evaluate one table in both packages, at float64 coordinates that
    # cover the pole rows, the seam and out-of-range values the gates
    # fold back
    coeff = np.asarray(jspl.coeff, np.float64)
    jspl64 = JS.Spline2D(jnp.asarray(coeff), jspl.pad, degree, jspl.bcs,
                         jspl.core_shape, True)
    tspl64 = TS.Spline2D(torch.from_numpy(coeff), tspl.pad, degree,
                         tspl.bcs, tspl.core_shape, True)
    rng = np.random.default_rng(degree)
    x = rng.uniform(-40, 72, 600)
    y = np.concatenate([rng.uniform(-0.5, 3.5, 200),
                        rng.uniform(11.5, 15.5, 200),
                        rng.uniform(-20, 36, 200)])
    want = np.asarray(JS.eval_spline(jspl64, jnp.asarray(x), jnp.asarray(y)))
    got = TS.eval_spline(tspl64, torch.from_numpy(x),
                         torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # ungated coordinates off the table clamp the flat index like
    # take(mode="clip") instead of raising
    far = np.asarray([-1e4, 1e4])
    want = np.asarray(JS.eval_spline(jspl64, jnp.asarray(far),
                                     jnp.asarray(far), apply_gate=False))
    got = TS.eval_spline(tspl64, torch.from_numpy(far),
                         torch.from_numpy(far), apply_gate=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
