"""Cardinal B-spline basis machinery (host-side, numpy float64).

Provides, for any spline degree:

* basis function values (Cox-de Boor recursion),
* the prefilter poles (for reference / tests; the device prefilter uses
  the truncated inverse impulse response instead, see below),
* the truncated impulse response of the *inverse* spline filter, and
* the (n+1)x(n+1) polynomial weight matrix used for evaluation.

The reference implements prefiltering as a forward/backward recursive
(IIR) filter per pole (zimt/prefilter.h:133, zimt/recursive.h:918, pole
constants zimt/poles.h). A sequential recurrence is a poor fit for the
TPU; but since all poles satisfy |z| < 1, the inverse filter's impulse
response decays geometrically and can be truncated to float32 accuracy
after a few dozen taps. Prefiltering then becomes a separable FIR
convolution over a boundary-extended signal - mathematically identical
to the IIR-with-boundary-init formulation (the reference itself
truncates its boundary horizon at 1e-4, zimt/recursive.h; we truncate
at 1e-12).

Everything here runs once per (degree) at configuration time in float64
and is baked into jitted code as constants.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _bspline_knots(degree: int) -> np.ndarray:
    return np.arange(degree + 2, dtype=np.float64)


def bspline_basis(degree: int, x) -> np.ndarray:
    """Value of the centered cardinal B-spline of given degree at x
    (vectorized, float64). Support is [-(degree+1)/2, (degree+1)/2]."""
    x = np.asarray(x, dtype=np.float64)
    t = x + (degree + 1) / 2.0  # shift to knots 0 .. degree+1
    # Cox-de Boor over uniform integer knots
    # N_{i,1}(t) = 1 on [i, i+1)
    n_fns = degree + 1
    vals = np.stack([((t >= i) & (t < i + 1)).astype(np.float64)
                     for i in range(n_fns + degree)], axis=0)
    for p in range(1, degree + 1):
        new_vals = []
        for i in range(len(vals) - 1):
            left = (t - i) / p * vals[i]
            right = ((i + 1 + p) - t) / p * vals[i + 1]
            new_vals.append(left + right)
        vals = np.stack(new_vals, axis=0)
    return vals[0]


@functools.lru_cache(maxsize=None)
def integer_basis_values(degree: int) -> np.ndarray:
    """b_k = B_degree(k) for k = -m..m, m = degree//2. These are the taps
    of the (symmetric) direct spline filter."""
    m = degree // 2
    k = np.arange(-m, m + 1, dtype=np.float64)
    return bspline_basis(degree, k)


@functools.lru_cache(maxsize=None)
def poles(degree: int) -> tuple:
    """Prefilter poles: the roots, inside the unit circle, of the
    z-transform of the sampled basis. Matches the classic Unser tables
    (and zimt/poles.h) to float64 accuracy."""
    if degree < 2:
        return ()
    b = integer_basis_values(degree)
    # polynomial sum b_k z^(k+m); np.roots wants descending coefficients
    roots = np.roots(b[::-1])
    inside = sorted((r.real for r in roots if abs(r) < 1.0 and
                     abs(r.imag) < 1e-12))
    return tuple(inside)


@functools.lru_cache(maxsize=None)
def inverse_kernel(degree: int, tol: float = 1e-12) -> np.ndarray:
    """Truncated impulse response h of the inverse spline filter,
    symmetric, as a float64 array of odd length 2K+1 with h[K] the
    center tap. Convolving the (boundary-extended) signal with h yields
    the spline coefficients: sum_k B(k) * h[n-k] = delta[n] up to tol."""
    if degree < 2:
        return np.array([1.0])
    b = integer_basis_values(degree)
    m = degree // 2
    n_fft = 8192
    w = np.fft.rfftfreq(n_fft) * 2.0 * np.pi
    # symbol B(e^{iw}) = b_0 + 2 sum_{k=1..m} b_k cos(kw)  (symmetric)
    symbol = np.full_like(w, b[m])
    for k in range(1, m + 1):
        symbol += 2.0 * b[m + k] * np.cos(k * w)
    h_full = np.fft.irfft(1.0 / symbol, n=n_fft)
    # h_full[0] is the center tap; find the truncation width
    peak = abs(h_full[0])
    k_max = 1
    for k in range(1, n_fft // 2):
        if abs(h_full[k]) > tol * peak:
            k_max = k
    kernel = np.concatenate([h_full[k_max:0:-1], h_full[:k_max + 1]])
    return kernel


@functools.lru_cache(maxsize=None)
def weight_matrix(degree: int) -> np.ndarray:
    """Polynomial weight matrix M of shape (degree+1, degree+1):

        w_j(t) = sum_k M[j, k] * t**k,  j = 0..degree

    where w_j is the weight of coefficient ``select - degree//2 + j``
    for the in-cell fraction t (t in [0,1) for odd degrees, [-0.5,0.5)
    for even degrees - see split()). Equivalent to the weight-matrix
    approach of zimt/basis.h:411."""
    n = degree
    if n == 0:
        return np.array([[1.0]])
    # valid t range
    lo, hi = (0.0, 1.0) if n % 2 else (-0.5, 0.5)
    # sample strictly inside the range (single polynomial piece)
    ts = lo + (hi - lo) * (np.arange(1, n + 2, dtype=np.float64)) / (n + 2)
    m = np.empty((n + 1, n + 1))
    vander = np.vander(ts, n + 1, increasing=True)  # (n+1, n+1)
    for j in range(n + 1):
        wj = bspline_basis(n, ts + (n // 2) - j)
        m[j] = np.linalg.solve(vander, wj)
    return m


def eval_half_width(degree: int) -> int:
    """Number of coefficients needed on each side beyond the core for
    safe evaluation anywhere in the gated coordinate range
    [-0.5, M-0.5]."""
    return degree // 2 + 1
