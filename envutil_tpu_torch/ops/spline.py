"""2D b-spline containers and evaluation on tensors.

PyTorch counterpart of envutil_tpu/ops/spline.py (the reference's
zimt/bspline.h, zimt/prefilter.h, zimt/eval.h, zimt/map.h and the
spherical prefilter in environment.h:356-522):

* ``prefilter`` turns image data into spline coefficients by a
  separable FIR convolution with the truncated inverse spline filter
  over a boundary-extended signal (ops/basis.py says why FIR).
* ``Spline2D`` holds *braced* coefficients: the core plus a frame filled
  according to the boundary conditions, so evaluation is a pure gather.
* ``eval_spline`` is the exact evaluator: gate, split into cell index +
  fraction, (degree+1) Horner weights per axis, gather the
  (degree+1)^2 coefficient window and reduce. It is also the plain
  version that ops/resample.py's CUDA kernel is held against.

Images are (H, W, C) tensors; coordinates are SoA pairs (x, y) in
spline units (0 .. M-1 across knots). The coefficient layout is
(Hp, Wp, C), channel-interleaved, so one tap is C contiguous floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import basis as _basis

# boundary condition codes (subset of zimt/common.h:72-82 that the
# renderer uses)
MIRROR = "mirror"      # whole-point reflection: x[-1] == x[1]
REFLECT = "reflect"    # half-point reflection: x[-1] == x[0]
PERIODIC = "periodic"
NATURAL = "natural"    # point-mirrored continuation: x[-i] = 2x[0]-x[i]
CONSTANT = "constant"  # clamp / edge replication
ZEROPAD = "zero"

# extra brace rows/columns beyond the evaluation half-width, kept equal
# to the JAX package's so both packages build the same padded tables
# (there the twined kernels read deflected taps from the brace)
EXTRA_BRACE = 2


def _take(a: torch.Tensor, idx, axis: int) -> torch.Tensor:
    index = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=a.device)
    return torch.index_select(a, axis, index)


def extend_axis(a: torch.Tensor, axis: int, lo: int, hi: int,
                bc: str) -> torch.Tensor:
    """Extend ``a`` along ``axis`` by ``lo``/``hi`` samples according to
    the boundary condition. This is both the signal extension ahead of
    prefiltering and the coefficient 'brace'."""
    if lo == 0 and hi == 0:
        return a
    n = a.shape[axis]
    if bc == PERIODIC:
        return _take(a, np.mod(np.arange(-lo, n + hi), n), axis)
    if bc == MIRROR:
        if n == 1:
            return _take(a, np.zeros(lo + hi + 1, dtype=int), axis)
        period = 2 * n - 2
        idx = np.abs(np.mod(np.arange(-lo, n + hi) + period, period))
        idx = np.where(idx >= n, period - idx, idx)
        return _take(a, idx, axis)
    if bc == REFLECT:
        period = 2 * n
        idx = np.mod(np.arange(-lo, n + hi) + period, period)
        idx = np.where(idx >= n, period - 1 - idx, idx)
        return _take(a, idx, axis)
    if bc == CONSTANT:
        return _take(a, np.clip(np.arange(-lo, n + hi), 0, n - 1), axis)
    if bc == ZEROPAD:
        shape_lo = list(a.shape)
        shape_lo[axis] = lo
        shape_hi = list(a.shape)
        shape_hi[axis] = hi
        return torch.cat([a.new_zeros(shape_lo), a, a.new_zeros(shape_hi)],
                         dim=axis)
    if bc == NATURAL:
        # x[-i] = 2 x[0] - x[i]; x[n-1+i] = 2 x[n-1] - x[n-1-i]
        head_idx = np.clip(np.arange(lo, 0, -1), 0, n - 1)
        tail_idx = np.clip(n - 2 - np.arange(hi), 0, n - 1)
        first = _take(a, [0], axis)
        last = _take(a, [n - 1], axis)
        head = 2.0 * first - _take(a, head_idx, axis)
        tail = 2.0 * last - _take(a, tail_idx, axis)
        return torch.cat([head, a, tail], dim=axis)
    raise ValueError(f"unknown boundary condition {bc!r}")


def _convolve_axis(a: torch.Tensor, axis: int, kernel: np.ndarray
                   ) -> torch.Tensor:
    """'valid' correlation of ``a`` with a symmetric 1D kernel along
    ``axis``. cuDNN would run a float32 convolution in TF32 by default,
    which keeps about three decimal digits of the 41-tap degree-3
    filter, so TF32 is switched off around the call."""
    k = kernel.size
    if k == 1:
        return a * float(kernel[0])
    moved = a.movedim(axis, -1)
    shp = moved.shape
    lhs = moved.reshape(-1, 1, shp[-1])  # (N, C=1, W)
    rhs = torch.as_tensor(kernel[::-1].copy(), dtype=a.dtype,
                          device=a.device).reshape(1, 1, k)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv1d(lhs, rhs)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    out = out.reshape(shp[:-1] + (shp[-1] - k + 1,))
    return out.movedim(-1, axis)


def prefilter_axis(a: torch.Tensor, axis: int, degree: int, bc: str
                   ) -> torch.Tensor:
    """Spline prefilter along one axis (output shape == input shape)."""
    kernel = _basis.inverse_kernel(degree)
    if kernel.size == 1:
        return a
    half = kernel.size // 2
    ext = extend_axis(a, axis, half, half, bc)
    return _convolve_axis(ext, axis, kernel)


def prefilter(a: torch.Tensor, degree: int, bcs) -> torch.Tensor:
    """Separable spline prefilter over the leading axes of an (H, W, C)
    tensor. ``bcs`` holds one boundary code per filtered axis (axis 0 =
    y first, axis 1 = x)."""
    out = a
    for axis, bc in enumerate(bcs):
        out = prefilter_axis(out, axis, degree, bc)
    return out


def spherical_prefilter(a: torch.Tensor, degree: int) -> torch.Tensor:
    """Prefilter for full-spherical (2:1 equirect) images, reference
    environment.h:356-522.

    Horizontally the image is periodic. Vertically, periodicity holds
    along great circles through the poles: the continuation of a column
    x beyond the pole is column x + W/2 running in the opposite
    direction. Stacking the left half and the vertically flipped right
    half yields a signal that is truly periodic vertically; filter that
    stack, then unstack. a is (H, W, C) with even W."""
    h, w = a.shape[0], a.shape[1]
    out = prefilter_axis(a, 1, degree, PERIODIC)
    if degree > 1:
        if w % 2:
            raise ValueError("full spherical needs even width")
        left = out[:, : w // 2]
        right = torch.flip(out[:, w // 2:], dims=(0,))
        stack = torch.cat([left, right], dim=0)  # (2H, W/2, C)
        stack = prefilter_axis(stack, 0, degree, PERIODIC)
        left = stack[:h]
        right = torch.flip(stack[h:], dims=(0,))
        out = torch.cat([left, right], dim=1)
    return out


def spherical_brace(c: torch.Tensor, pad_y: int, pad_x: int) -> torch.Tensor:
    """Brace for full sphericals: periodic horizontally, over-the-pole
    vertically (row -1-k of column x equals row k of column
    (x + W/2) mod W; same at the bottom). Reference environment.h:449-516.

    Output row r maps to s = mod(r, 2H); s < H reads row s unrolled,
    s >= H reads row 2H-1-s from the W/2-rolled image."""
    h, w = c.shape[0], c.shape[1]
    if pad_y:
        rows = np.arange(-pad_y, h + pad_y)
        s = np.mod(rows, 2 * h)
        row_idx = np.where(s < h, s, 2 * h - 1 - s)
        use_roll = torch.as_tensor(s >= h, device=c.device)
        plain = _take(c, row_idx, 0)
        rolled = _take(torch.roll(c, w // 2, dims=1), row_idx, 0)
        mask = use_roll.reshape((-1,) + (1,) * (c.dim() - 1))
        c = torch.where(mask, rolled, plain)
    if pad_x:
        c = extend_axis(c, 1, pad_x, pad_x, PERIODIC)
    return c


# ---------------------------------------------------------------------------
# gates (zimt/map.h) - map continuous coordinates into the defined range
# ---------------------------------------------------------------------------

def gate_bounds(bc: str, n: int):
    """(lower, upper) of the defined range for extent n
    (zimt/bspline.h:233-268: REFLECT/PERIODIC use [-0.5, n-0.5], others
    [0, n-1])."""
    if bc in (REFLECT, PERIODIC):
        return -0.5, n - 0.5
    return 0.0, float(n - 1)


def gate(c, bc: str, n: int):
    """Map coordinate c into the spline's defined range for extent n
    under boundary condition bc (zimt/eval.h:2003-2031: PERIODIC ->
    periodic gate, MIRROR/REFLECT -> mirror gate, else clamp).
    ``torch.remainder`` is a floor-mod, like the JAX package's mod."""
    lower, upper = gate_bounds(bc, n)
    if n == 1:
        return torch.zeros_like(c)
    if bc == PERIODIC:
        return lower + torch.remainder(c - lower, upper - lower)
    if bc in (MIRROR, REFLECT):
        period = 2.0 * (upper - lower)
        t = torch.remainder(c - lower, period)
        t = torch.minimum(t, period - t)
        return lower + t
    return torch.clamp(c, lower, upper)


# ---------------------------------------------------------------------------
# spline container + evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Spline2D:
    """Braced 2D spline coefficients over an (H, W, C) image.

    ``coeff`` has shape (H + 2*pad, W + 2*pad, C); the core starts at
    (pad, pad). ``degree`` is the evaluation degree; ``bcs`` the
    (y, x) boundary codes used for gating."""

    coeff: torch.Tensor
    pad: int
    degree: int
    bcs: tuple
    core_shape: tuple
    spherical: bool = False   # built with the over-the-pole brace


def make_spline(image: torch.Tensor, spline_degree: int,
                prefilter_degree: int | None = None,
                bcs=(REFLECT, REFLECT),
                spherical: bool = False) -> Spline2D:
    """Build a braced, prefiltered spline over (H, W, C) image data.

    ``prefilter_degree`` may differ from ``spline_degree`` (the
    reference's --prefilter vs --degree). ``spherical`` selects the
    full-spherical treatment (PERIODIC horizontal + over-the-pole
    vertical continuation)."""
    if prefilter_degree is None:
        prefilter_degree = spline_degree
    pad = max(_basis.eval_half_width(spline_degree),
              _basis.eval_half_width(prefilter_degree)) + EXTRA_BRACE
    if spherical:
        c = spherical_prefilter(image, prefilter_degree)
        c = spherical_brace(c, pad, pad)
        bcs = (REFLECT, PERIODIC)  # gating only; brace is special
    else:
        c = prefilter(image, prefilter_degree, bcs)
        c = extend_axis(c, 0, pad, pad, bcs[0])
        c = extend_axis(c, 1, pad, pad, bcs[1])
    return Spline2D(coeff=c.contiguous(), pad=pad, degree=spline_degree,
                    bcs=tuple(bcs), core_shape=tuple(image.shape[:2]),
                    spherical=spherical)


def split(c, degree: int):
    """Split a gated spline coordinate into cell index (int64) and
    fraction, following the even/odd convention (zimt/eval.h:595-610):
    odd degrees: select = floor(c), t in [0, 1);
    even degrees: select = round(c), t in [-0.5, 0.5)."""
    if degree % 2:
        sel = torch.floor(c)
    else:
        sel = torch.floor(c + 0.5)
    return sel.to(torch.int64), c - sel


def _weights(t, degree: int):
    """(degree+1) evaluation weights from the fraction t, via the
    polynomial weight matrix (Horner form)."""
    m = _basis.weight_matrix(degree)
    ws = []
    for j in range(degree + 1):
        acc = torch.full_like(t, float(m[j, degree]))
        for k in range(degree - 1, -1, -1):
            acc = acc * t + float(m[j, k])
        ws.append(acc)
    return ws


def eval_spline(spl: Spline2D, x, y, apply_gate: bool = True):
    """Evaluate the spline at continuous spline coordinates (x, y)
    (in knot units: 0..W-1 / 0..H-1). Returns a tensor shaped
    x.shape + (C,). Out-of-range coordinates are mapped by the gates
    (safe evaluator semantics, zimt/eval.h:2345). The flat table index
    is clamped to the table, as the JAX package's
    ``take(mode="clip")`` does; indexing would raise (CPU) or read out
    of bounds (CUDA) instead."""
    h, w = spl.core_shape
    n = spl.degree
    if apply_gate:
        x = gate(x, spl.bcs[1], w)
        y = gate(y, spl.bcs[0], h)
    sx, tx = split(x, n)
    sy, ty = split(y, n)
    wx = _weights(tx, n)
    wy = _weights(ty, n)

    hp, wp, ch = spl.coeff.shape
    flat = spl.coeff.reshape(hp * wp, ch)
    # base index of the coefficient window in the padded table
    bx = sx + (spl.pad - n // 2)
    by = sy + (spl.pad - n // 2)

    out = None
    for j in range(n + 1):
        row = (by + j) * wp
        # accumulate the row sum in x first, then weight by wy[j]
        row_acc = None
        for k in range(n + 1):
            idx = (row + (bx + k)).clamp_(0, hp * wp - 1)
            tap = flat[idx.reshape(-1)].reshape(idx.shape + (ch,))
            term = wx[k][..., None] * tap
            row_acc = term if row_acc is None else row_acc + term
        term = wy[j][..., None] * row_acc
        out = term if out is None else out + term
    return out
