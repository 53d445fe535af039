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


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 5])
def test_prefilter(degree):
    a = _img(degree + 2)
    bcs = (TS.REFLECT, TS.PERIODIC)
    want = np.asarray(JS.prefilter(jnp.asarray(a), degree, bcs))
    got = TS.prefilter(torch.from_numpy(a), degree, bcs).numpy()
    _close_prefiltered(got, want)


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
