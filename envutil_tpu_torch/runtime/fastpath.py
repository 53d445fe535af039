"""Fast single-facet render path: one launch of the inline-coordinates
kernel over the whole frame.

Counterpart of envutil_tpu/runtime/fastpath.py (eligible :106-126,
_inline_setup :569-685, the fused frame :1373-1734). The JAX fast path
plans window classes, tile passes and rolled/pitched source variants
because the TPU's Mosaic compiler offers only an (8,128) in-register
gather; on Hopper the kernel gathers through L1/L2 directly, so one
launch covers every output pixel exactly, poles and seam included, and
none of that planner is carried over.

This slice covers full-spherical mount sources with float32 tables
rendered to rectilinear, cubemap, biatan6, spherical or cylindrical
targets without twining. Other jobs on CUDA raise
``NotImplementedError`` naming the slice that will cover them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.conventions import Projection
from ..models import environment as E
from ..models import stepper as ST
from ..ops import resample as R
from ..ops import spline as S

# per-face in_face_to_ray as a linear map of (fx, fy, 1)
# (geometry.in_face_to_ray / geometry.h:577-637)
_FACE_P = np.asarray([
    [[0, 0, -1], [0, 1, 0], [1, 0, 0]],    # LEFT
    [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],    # RIGHT
    [[-1, 0, 0], [0, 0, -1], [0, -1, 0]],  # TOP
    [[-1, 0, 0], [0, 0, 1], [0, 1, 0]],    # BOTTOM
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]],     # FRONT
    [[-1, 0, 0], [0, 1, 0], [0, 0, -1]],   # BACK
], np.float32)

_INLINE_TARGETS = (Projection.RECTILINEAR, Projection.CUBEMAP,
                   Projection.BIATAN6, Projection.SPHERICAL,
                   Projection.CYLINDRICAL)


def uncovered(plan, sources):
    """Why this slice has no kernel for the job (a message naming the
    later slice), or None when ``fused_frame`` covers it."""
    if len(sources) != 1:
        return "multi-facet synopses wait for the multi-facet slice"
    if plan.spread is not None:
        return "twining waits for the twining slice (kernels K3/K4)"
    src = sources[0]
    st = src.static
    if st.kind != "mount":
        return f"{st.kind} sources wait for the cubemap-source slice"
    if st.masked != -1:
        return "masked (--mask_for) jobs wait for the masking slice"
    if not (st.projection == Projection.SPHERICAL and src.spl is not None
            and src.spl.spherical):
        return ("partial mounts wait for the K2 slice "
                "(resample_planar_into)")
    if st.has_lcp or st.has_shift or st.has_shear:
        return "PTO planar transforms wait for the K2/PTO slice"
    if plan.projection not in _INLINE_TARGETS:
        return (f"{Projection(plan.projection).name.lower()} targets "
                "wait for the K2 slice")
    if src.spl.degree > R.MAX_DEGREE:
        return f"degree {src.spl.degree} exceeds the kernel's {R.MAX_DEGREE}"
    if src.spl.coeff.dtype != torch.float32:
        return "bf16 tables wait for the twining-pyramid slice"
    if not 1 <= src.spl.coeff.shape[-1] <= 4:
        return f"{src.spl.coeff.shape[-1]}-channel sources are not covered"
    return None


def eligible(plan, sources) -> bool:
    """Does one kernel launch cover this job (see ``uncovered``)?"""
    return uncovered(plan, sources) is None


def _gate_bounds(bc, n):
    """(mode, lower, upper) of ops/spline.gate for the kernel."""
    lower, upper = S.gate_bounds(bc, n)
    if bc == S.PERIODIC:
        return ("periodic", lower, upper)
    if bc in (S.REFLECT, S.MIRROR):
        return ("mirror", lower, upper)
    return ("clamp", lower, upper)


def inline_setup(plan, window, core_shape, pad, bcs, statics):
    """Host-side axis features and constants for one kernel launch over
    ``window = (y0, y1, x0, x1)``: returns (tmode, xfeat (Fx, W),
    yfeat (Fy, H), P (nf, 3, 3), consts), the features float32 numpy
    built from the same float64 axes the exact path uses. ``statics``
    is (total extent x0, x1, y0, y1, total width, total height, window
    x offset, window y offset) of the source."""
    y0, y1, x0, x1 = window
    ext = plan.extent
    xs = ST.planar_axis(plan.width, ext.x0, ext.x1, 0.0, np.float64,
                        x0, x1)
    ys = ST.planar_axis(plan.height, ext.y0, ext.y1, 0.0, np.float64,
                        y0, y1)

    if plan.projection in (Projection.CUBEMAP, Projection.BIATAN6):
        tmode = "affine"
        section_md = ext.x1 - ext.x0
        refc_md = section_md / 2.0
        face_of_row = np.clip(np.arange(y0, y1) // plan.width, 0, 5)
        shift = (3.0 - face_of_row) * section_md - refc_md

        def fx(a):
            return (np.tan(a * (math.pi / 4.0))
                    if plan.projection == Projection.BIATAN6 else a)

        xf, yf = [fx(xs)], [fx(ys + shift)]
        P = _FACE_P
    elif plan.projection == Projection.RECTILINEAR:
        tmode = "affine"
        xf, yf = [xs], [ys]
        P = np.eye(3, dtype=np.float32)[None]
    elif plan.projection == Projection.SPHERICAL:
        tmode = "sph"
        xf = [np.sin(xs), np.cos(xs)]
        yf = [np.sin(ys), np.cos(ys)]
        P = np.eye(3, dtype=np.float32)[None]
    else:  # CYLINDRICAL
        tmode = "cyl"
        xf = [np.sin(xs), np.cos(xs)]
        yf = [ys]
        P = np.eye(3, dtype=np.float32)[None]
    xfeat = np.stack([a.astype(np.float32) for a in xf])
    yfeat = np.stack([a.astype(np.float32) for a in yf])

    # model -> spline affine (environment._md_to_spline)
    (tex0, tex1, tey0, tey1, tw, th, wxo, wyo) = statics
    kx = tw / (tex1 - tex0)
    ky = th / (tey1 - tey0)
    cx = -tex0 * kx - 0.5 - wxo
    cy = -tey0 * ky - 0.5 - wyo
    h, w = core_shape
    gate_x, glx, gux = _gate_bounds(bcs[1], w)
    gate_y, gly, guy = _gate_bounds(bcs[0], h)
    consts = (float(kx), float(cx), float(ky), float(cy),
              gate_x, float(glx), float(gux),
              gate_y, float(gly), float(guy), float(pad))
    return tmode, xfeat, yfeat, P, consts


def frame_window(plan):
    """(y0, y1, x0, x1) of the output: the crop or the whole raster."""
    if plan.crop is not None:
        return tuple(plan.crop)
    return (0, plan.height, 0, plan.width)


@functools.lru_cache(maxsize=16)
def _operands(plan, static, core_shape, pad, bcs, device):
    """Device-resident kernel operands of one plan (a RenderPlan hashes
    by identity), built once so a steady-state frame is one launch."""
    window = frame_window(plan)
    te = static.total_extent
    statics = (te.x0, te.x1, te.y0, te.y1, static.total_width,
               static.total_height, static.window_x_offset,
               static.window_y_offset)
    tmode, xfeat, yfeat, P, consts = inline_setup(
        plan, window, core_shape, pad, bcs, statics)
    basis = np.asarray(plan.bases[0], np.float32)
    bm = np.einsum("ij,fjk->fik", basis, P).reshape(-1, 9)
    face_rows = plan.width if P.shape[0] == 6 else 0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                ).to(device)
    return dict(tmode=tmode, consts=consts, xfeat=dev(xfeat),
                yfeat=dev(yfeat), bmats=dev(bm), row0=window[0],
                face_rows=face_rows)


def frame_operands(plan, src):
    """The kernel operands of ``fused_frame`` for this plan and source
    (a dict of tensors on the source's device and static values)."""
    spl = src.spl
    ops = _operands(plan, src.static, tuple(spl.core_shape), spl.pad,
                    tuple(spl.bcs), spl.coeff.device)
    return dict(ops, degree=spl.degree)


def fused_frame(plan, src, out=None, device=None):
    """Render the frame of a single full-spherical mount source with one
    kernel launch, then adapt channels (repix) and brighten. ``out``
    is a caller-held (H, W, C_source) float32 buffer that the launch
    rewrites completely (the steady-state 'reuse' contract: no
    zero-fill, no allocation); without it a fresh buffer is made.
    Returns the (H, W, nchannels) image tensor on the source's device,
    which is ``out`` itself when no adaptation applies."""
    reason = uncovered(plan, [src])
    if reason is not None:
        raise NotImplementedError(reason)
    coeff = src.spl.coeff
    if device is not None and torch.device(device) != coeff.device:
        raise ValueError(f"source lives on {coeff.device}, not {device}")
    y0, y1, x0, x1 = frame_window(plan)
    shape = (y1 - y0, x1 - x0, coeff.shape[-1])
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=coeff.device)
    elif tuple(out.shape) != shape or out.device != coeff.device:
        raise ValueError(f"out must be {shape} on {coeff.device}")
    ops = frame_operands(plan, src)
    R.resample_inline(out, coeff, ops["xfeat"], ops["yfeat"],
                      ops["bmats"], degree=ops["degree"],
                      tmode=ops["tmode"], consts=ops["consts"],
                      row0=ops["row0"], face_rows=ops["face_rows"])
    img = E.repix(out, plan.nchannels)
    if src.static.brighten != 1.0:
        img = E.apply_brighten(img, src.static.brighten)
    return img


def render_fast(plan, sources, verbose: bool = False) -> np.ndarray:
    """The CUDA render path of ``render.render_frame``: one fused frame,
    returned as a host (H, W, C) float32 array. Raises
    ``NotImplementedError`` for jobs this slice does not cover."""
    reason = uncovered(plan, sources)
    if reason is not None:
        raise NotImplementedError(
            f"no CUDA kernel for this job yet: {reason}")
    img = fused_frame(plan, sources[0])
    if verbose:
        print(f"fastpath: 1 launch of resample_inline over "
              f"{img.shape[0]}x{img.shape[1]} px")
    return img.cpu().numpy()
