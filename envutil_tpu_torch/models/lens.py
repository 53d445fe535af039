"""PTO lens correction: the panotools a/b/c radial polynomial.

Counterpart of envutil_tpu/models/lens.py (lens_correction.h:224-235).
Only the forward polynomial, which ``environment._planar_transform``
applies, is here; the inverse LUT spline waits for the PTO slice.
"""

from __future__ import annotations


def lcp_scale(r, a: float, b: float, c: float):
    """Radial scaling factor a r^3 + b r^2 + c r + d with
    d = 1 - (a+b+c), applied to radii in unit-radius units
    (lens_correction.h:224-235). Horner form."""
    d = 1.0 - (a + b + c)
    return ((a * r + b) * r + c) * r + d
