"""The planar kernels' plain version against JAX `eval_spline` at every
degree 0-7 (KERNEL_TOL of test_torch_planar).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envutil_tpu.ops import spline as JS
from envutil_tpu_torch.ops import resample as R

from test_torch_planar import (
    KERNEL_TOL, _planes, _t,
)


@pytest.mark.parametrize("degree", range(8))
def test_plain_matches_jax_eval_spline(degree):
    """Every degree the kernel instantiates: the plain version against
    the JAX ``eval_spline`` on the same table and coordinates."""
    spl, px, py, _rng = _planes(degree, nch=4, h=24, w=40, src=(48, 80))
    want = np.asarray(JS.eval_spline(spl, jnp.asarray(px - spl.pad),
                                     jnp.asarray(py - spl.pad),
                                     apply_gate=False))
    got = R.resample_planar(torch.empty(want.shape), _t(spl.coeff), _t(px),
                            _t(py), degree=degree)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KERNEL_TOL)
