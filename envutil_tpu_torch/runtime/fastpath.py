"""Fast render path on the card: one kernel launch per facet over the
whole frame.

Counterpart of envutil_tpu/runtime/fastpath.py (eligible :106-126,
_coords :283-389, _inline_setup :569-685, _inline_eligible :688-704,
the fused frame :1373-1734, fused_multi_frame :1743, _combine_stack
:2600). The JAX fast path plans window classes, tile passes,
forced-face cubemap sections, face-boundary merge passes and
rolled/pitched source variants because the TPU's Mosaic compiler
offers only an (8,128) in-register gather; on Hopper the kernels gather
through L1/L2 directly, so one launch covers every output pixel
exactly, poles, seam and cube edges included, and none of that planner
is carried over.

Two routes for a single facet, chosen per job (``inline_mode``), each
with a twined form taken when the plan carries a spread:

* ``fused_frame``: full-spherical mount or cubemap/biatan6 IR sources
  rendered to rectilinear, cubemap, biatan6, spherical or cylindrical
  targets by a plain rotation: the coordinate chain runs inside the
  inline kernel (K1, ``resample_inline``). Twined, the three rays of
  the ninepack, their differencing and the tap loop run inside the
  inline twined kernel (K4, ``resample_inline_twined``), which
  linearises in ray space as the exact path does.
* ``planar_frame``: every other single-facet job (partial mounts, PTO
  lens/shift/shear, translated facets, stereographic and fisheye
  targets). A job without a generic chain takes the chain forms of the
  planar kernels, which compute the coordinate chain per pixel in the
  kernel from ``inline_setup``'s axis features and a
  ``ChainPickup`` (``chain_operands``): one launch of the planar chain
  kernel (K2/K5, ``resample_planar_chain``), or, twined, of the twined
  chain kernel (K3/K6, ``resample_twined_chain``). On the TPU XLA fuses
  the JAX package's coordinate chain under ``jit``; eager PyTorch would
  run it as a string of elementwise launches, each a round trip of a
  full plane through device memory, which took most of such a frame. A
  translated facet's generic chain (``render.generic_r3``) has no kernel
  form: it takes the planes forms, the coordinate pass as PyTorch
  operations (``coords``, ``twined_coords``: the stepper's rays through
  the generic chain, then the chain forms' own source half in
  ops/resample, so the chain is written once) and one launch of the
  planar kernel (``resample_planar``) or of the planar twined kernel
  (``resample_twined``), the latter with per-pixel tap weights.

A stitch of several facets (``multi_frame``) renders each facet into
its slot of a pixel stack by one launch of those kernels, with a
voronoi score plane per facet where the synopsis needs one, and
combines the stacks in PyTorch (``models/synopsis``), as the JAX package
combines its per-facet frames in XLA. A twined stitch does so once per
tap of the spread, each facet through a one-tap launch of its twined
kernel, and sums the taps' combines with their weights: the exact
path's ``synopsis.twined``, where every facet's ray deflects and the
champion is chosen anew for each tap.

``render_fast_mesh`` renders a frame's output rows in bands, each on
its device through the route the whole frame takes (--mesh).

The kernel routes adapt channels and brighten after the taps are
summed, where the exact path does so per tap; the two agree unless the
channel adaptation divides by alpha (2 -> 1, 2 -> 3, 4 -> 1, 4 -> 3
channels), as in the JAX package's fast path.

Every route takes a float32 or a bfloat16 table (``--coeff bf16``);
the wrappers pass the table's type to the kernels, which evaluate in
float32.

The jobs the JAX package's ``eligible`` / ``_eligible_multi`` keep from
its Pallas kernels take ``exact_frame`` (``exact_route``): the port's
exact path on the card in row chunks, the counterpart of its XLA graph.
They are a spline degree above the kernels' (``R.MAX_DEGREE``), a
``--mask_for`` job (paint sources and alpha masking), and a
``--twine_precise`` job in which some facet would take the planar twined
kernel, whose taps deflect in source-coordinate space where
``--twine_precise`` deflects the ray (the inline twined kernel deflects
the ray, and keeps its precise jobs). The plan decides it, never a
kernel's failure.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref

import numpy as np
import torch

from ..core.conventions import Projection
from ..models import environment as E
from ..models import stepper as ST
from ..models import synopsis as SYN
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

_TWINED_PLANES = ("sx", "sy", "dux", "duy", "dvx", "dvy")

_INLINE_TARGETS = (Projection.RECTILINEAR, Projection.CUBEMAP,
                   Projection.BIATAN6, Projection.SPHERICAL,
                   Projection.CYLINDRICAL)


def uncovered(plan, sources):
    """Why the port has no route on the card for the job (a message), or
    None when ``fused_frame``, ``planar_frame``, ``multi_frame`` for
    several sources or ``exact_frame`` covers it."""
    if not sources:
        return "no source"
    for src in sources:
        if src.spl is None:
            continue        # a paint source: exact_frame
        if src.spl.coeff.dtype not in S.COEFF_DTYPES.values():
            return f"{src.spl.coeff.dtype} tables are not covered"
        if not 1 <= src.spl.coeff.shape[-1] <= 4:
            return (f"{src.spl.coeff.shape[-1]}-channel sources are not "
                    "covered")
    return None


def _masked(sources):
    """Whether the job is a ``--mask_for`` job: a paint source, or a
    source whose alpha is masked (JAX ``eligible``)."""
    return any(src.static.kind == "paint" or src.static.masked != -1
               for src in sources)


def exact_route(plan, sources):
    """Why the job takes ``exact_frame`` (a message), or None when a
    kernel takes it: a ``--mask_for`` job, a spline degree beyond the
    kernels' range 0..``R.MAX_DEGREE``, or a twined ``--twine_precise``
    job in which some facet's launch (``route``) would be the planar
    twined kernel, as the JAX package keeps every precise job from its
    kernels."""
    if _masked(sources):
        return "a --mask_for job (paint sources, alpha masking)"
    degree = max(src.spl.degree for src in sources)
    if degree > R.MAX_DEGREE:
        return f"degree {degree} exceeds the kernels' {R.MAX_DEGREE}"
    if plan.spread is not None and plan.twine_precise:
        score = len(sources) > 1 and SYN.pick_synopsis(
            plan.synopsis, plan.nchannels) is not SYN.hdr_merge
        plans = facet_plans(plan) if len(sources) > 1 else (plan,)
        if any(route(p, src, score) != "inline"
               for p, src in zip(plans, sources)):
            return ("--twine_precise deflects the ray; the planar twined "
                    "kernel deflects coordinates")
    return None


def exact_frame(plan, sources, device=None):
    """Render the frame through the port's exact path
    (``render.render_exact``: stepper rays, lookups, the synopsis, in
    row chunks) on the sources' device (``device`` where no source has
    a table): the route of the jobs no kernel takes (``exact_route``).
    Counted in ``exact_frame.launches``, once a frame, as the kernels'
    wrappers count theirs. Returns the (H, W, nchannels) image tensor."""
    from . import render as RD
    img = RD.render_exact(plan, sources, device=device)
    exact_frame.launches += 1
    return img


exact_frame.launches = 0


def inline_mode(plan, src):
    """The inline kernel's source mode for this job ("sph" for
    full-spherical mounts, "cubemap"/"biatan6" for IR sources), or None
    when the job goes through ``planar_frame`` (JAX
    ``_inline_eligible``)."""
    if plan.planar_to_ray[0] is not None \
            or plan.projection not in _INLINE_TARGETS:
        return None
    st = src.static
    if st.kind == "cubemap":
        return "biatan6" if st.projection == Projection.BIATAN6 \
            else "cubemap"
    if (st.kind == "mount" and st.projection == Projection.SPHERICAL
            and src.spl.spherical and not (st.has_lcp or st.has_shift
                                           or st.has_shear)):
        return "sph"
    return None


def _gate_bounds(bc, n):
    """(mode, lower, upper) of ops/spline.gate for the kernel."""
    lower, upper = S.gate_bounds(bc, n)
    if bc == S.PERIODIC:
        return ("periodic", lower, upper)
    if bc in (S.REFLECT, S.MIRROR):
        return ("mirror", lower, upper)
    return ("clamp", lower, upper)


def inline_setup(plan, window, core_shape, pad, bcs, statics,
                 smode: str = "sph", twined: bool = False):
    """Host-side axis features and constants for one kernel launch over
    ``window = (y0, y1, x0, x1)``: returns (tmode, xfeat (Fx, W),
    yfeat (Fy, H), P (nf, 3, 3), consts), the features float32 numpy
    built from the same float64 axes the exact path uses. For
    ``smode`` "sph", ``statics`` is (total extent x0, x1, y0, y1, total
    width, total height, window x offset, window y offset) of the
    source; for "cubemap"/"biatan6" it is the IR's (refc_md,
    model_to_px, section_px). ``twined`` doubles the feature sets: the
    centre's rows, then those of the axis biased by DERIV_BIAS (the
    twined kernel's derivative grids)."""
    y0, y1, x0, x1 = window
    ext = plan.extent

    def axes(bias):
        return (ST.planar_axis(plan.width, ext.x0, ext.x1, bias,
                               np.float64, x0, x1),
                ST.planar_axis(plan.height, ext.y0, ext.y1, bias,
                               np.float64, y0, y1))

    sets = [axes(0.0)] + ([axes(ST.DERIV_BIAS)] if twined else [])

    if plan.projection in (Projection.CUBEMAP, Projection.BIATAN6):
        tmode = "affine"
        section_md = ext.x1 - ext.x0
        refc_md = section_md / 2.0
        face_of_row = np.clip(np.arange(y0, y1) // plan.width, 0, 5)
        shift = (3.0 - face_of_row) * section_md - refc_md

        def fx(a):
            return (np.tan(a * (math.pi / 4.0))
                    if plan.projection == Projection.BIATAN6 else a)

        tmode, P = "affine", _FACE_P
        xf = [fx(xs) for xs, _ in sets]
        yf = [fx(ys + shift) for _, ys in sets]
    elif plan.projection == Projection.RECTILINEAR:
        tmode, P = "affine", np.eye(3, dtype=np.float32)[None]
        xf = [xs for xs, _ in sets]
        yf = [ys for _, ys in sets]
    elif plan.projection == Projection.SPHERICAL:
        tmode, P = "sph", np.eye(3, dtype=np.float32)[None]
        xf = [f(xs) for xs, _ in sets for f in (np.sin, np.cos)]
        yf = [f(ys) for _, ys in sets for f in (np.sin, np.cos)]
    elif plan.projection in (Projection.STEREOGRAPHIC, Projection.FISHEYE):
        # the planar kernels' chain forms: planar (x, y), mapped to the
        # ray in the kernel
        tmode = "ster" if plan.projection == Projection.STEREOGRAPHIC \
            else "fish"
        P = np.eye(3, dtype=np.float32)[None]
        xf = [xs for xs, _ in sets]
        yf = [ys for _, ys in sets]
    else:  # CYLINDRICAL
        tmode, P = "cyl", np.eye(3, dtype=np.float32)[None]
        xf = [f(xs) for xs, _ in sets for f in (np.sin, np.cos)]
        yf = [ys for _, ys in sets]
    xfeat = np.stack([a.astype(np.float32) for a in xf])
    yfeat = np.stack([a.astype(np.float32) for a in yf])

    if smode in ("cubemap", "biatan6"):
        # IR pickup (metrics.get_pickup_coordinate_px): scale fx/fy by
        # model_to_px around the section centre; the face's section
        # offset rides as consts[11] (the face is chosen in-kernel)
        refc_md, model_to_px, section_px = statics
        k = float(model_to_px)
        c = float(refc_md * model_to_px - 0.5)
        consts = (k, c, k, c, "none", 0.0, 0.0, "none", 0.0, 0.0,
                  float(pad), float(section_px))
        return tmode, xfeat, yfeat, P, consts

    return tmode, xfeat, yfeat, P, _sph_consts(statics, core_shape, pad,
                                               bcs)


def _sph_consts(statics, core_shape, pad, bcs):
    """(kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, pad): the
    model -> spline affine (environment._md_to_spline) and the gates of
    a mount source with ``statics`` as ``inline_setup`` takes them."""
    (tex0, tex1, tey0, tey1, tw, th, wxo, wyo) = statics
    kx = tw / (tex1 - tex0)
    ky = th / (tey1 - tey0)
    cx = -tex0 * kx - 0.5 - wxo
    cy = -tey0 * ky - 0.5 - wyo
    h, w = core_shape
    gate_x, glx, gux = _gate_bounds(bcs[1], w)
    gate_y, gly, guy = _gate_bounds(bcs[0], h)
    return (float(kx), float(cx), float(ky), float(cy),
            gate_x, float(glx), float(gux),
            gate_y, float(gly), float(guy), float(pad))


def frame_window(plan):
    """(y0, y1, x0, x1) of the output: the crop or the whole raster."""
    if plan.crop is not None:
        return tuple(plan.crop)
    return (0, plan.height, 0, plan.width)


def _source_mode(static):
    """(smode, statics) of ``inline_setup`` for a source."""
    if static.kind == "cubemap":
        m = static.metrics
        smode = ("biatan6" if static.projection == Projection.BIATAN6
                 else "cubemap")
        return smode, (m.refc_md, m.model_to_px, m.section_px)
    te = static.total_extent
    return "sph", (te.x0, te.x1, te.y0, te.y1, static.total_width,
                   static.total_height, static.window_x_offset,
                   static.window_y_offset)


# per plan (a RenderPlan hashes by identity), what is derived from it
# and kept as long as the plan lives: its kernel operands, its facet
# plans, its tap plans. A cache of a fixed size would be outgrown by a
# --mesh frame's band, facet and tap plans (4 bands x 6 facets of a
# stitch) and rebuild them every frame.
_OPERANDS = weakref.WeakKeyDictionary()
_FACET_PLANS = weakref.WeakKeyDictionary()
_TAP_PLANS = weakref.WeakKeyDictionary()


def _operands(plan, static, core_shape, pad, bcs, device):
    """Device-resident kernel operands of one plan, built once (counted
    in ``_operands.builds``) so a steady-state frame is one launch."""
    per_plan = _OPERANDS.setdefault(plan, {})
    key = (static, core_shape, pad, bcs, device)
    if key not in per_plan:
        per_plan[key] = _build_operands(plan, static, core_shape, pad, bcs,
                                        device)
        _operands.builds += 1
    return per_plan[key]


_operands.builds = 0


def _build_operands(plan, static, core_shape, pad, bcs, device):
    """``_operands``' build: the features, matrices and constants of
    ``inline_setup`` over the plan's window, uploaded to ``device``."""
    window = frame_window(plan)
    smode, statics = _source_mode(static)
    tmode, xfeat, yfeat, P, consts = inline_setup(
        plan, window, core_shape, pad, bcs, statics, smode,
        twined=plan.spread is not None)
    basis = np.asarray(plan.bases[0], np.float32)
    bm = np.einsum("ij,fjk->fik", basis, P).reshape(-1, 9)
    face_rows = plan.width if P.shape[0] == 6 else 0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                ).to(device)
    return dict(tmode=tmode, smode=smode, consts=consts, xfeat=dev(xfeat),
                yfeat=dev(yfeat), bmats=dev(bm), row0=window[0],
                face_rows=face_rows)


# room for the one-tap spreads of a twined stitch (up to 8 x 8 taps)
@functools.lru_cache(maxsize=128)
def _spread_tensor(spread, device):
    """The plan's spread with 1/DERIV_BIAS folded into the offsets, as
    the (K, 3) float32 tensor the twined kernels take."""
    return torch.tensor(SYN.scaled_spread(spread), dtype=torch.float32,
                        device=device)


def frame_operands(plan, src):
    """The kernel operands of ``fused_frame`` for this plan and source
    (a dict of tensors on the source's device and static values); for a
    twined plan the feature sets are doubled and ``spread``, ``n_taps``
    and ``precise`` are added."""
    spl = src.spl
    ops = _operands(_TAP_OF.get(plan, plan), src.static,
                    tuple(spl.core_shape), spl.pad, tuple(spl.bcs),
                    spl.coeff.device)
    ops = dict(ops, degree=spl.degree)
    if plan.spread is not None:
        ops.update(spread=_spread_tensor(plan.spread, spl.coeff.device),
                   n_taps=len(plan.spread), precise=plan.twine_precise)
    return ops


def _frame_buffer(plan, src, out, device):
    """Check the job and return the (H, W, C_source) output buffer:
    ``out`` itself or a fresh one on the source's device."""
    _check_kernel_job(plan, [src])
    coeff = src.spl.coeff
    if device is not None and torch.device(device) != coeff.device:
        raise ValueError(f"source lives on {coeff.device}, not {device}")
    y0, y1, x0, x1 = frame_window(plan)
    shape = (y1 - y0, x1 - x0, coeff.shape[-1])
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=coeff.device)
    if tuple(out.shape) != shape or out.device != coeff.device:
        raise ValueError(f"out must be {shape} on {coeff.device}")
    return out


def _check_kernel_job(plan, sources):
    """Raise for a job no kernel route takes: ``NotImplementedError``
    where the port has no route, ``ValueError`` where ``exact_frame``
    is the route (a ``--mask_for`` job: no kernel paints or masks)."""
    reason = uncovered(plan, sources)
    if reason is not None:
        raise NotImplementedError(reason)
    if _masked(sources):
        raise ValueError("a --mask_for job takes exact_frame")


def _finish(plan, src, out, slot=None):
    """Adapt the launch's ``out`` (H, W, C_source) to the plan's channels
    (repix), into ``slot`` (H, W, nchannels) when one is given, and
    brighten in place; returns the image (``slot``, or ``out`` itself
    when no channel adaptation applies)."""
    img = E.repix(out, plan.nchannels)
    if slot is not None and img is not slot:
        img = slot.copy_(img)
    if src.static.brighten != 1.0:
        E.apply_brighten_(img, src.static.brighten)
    return img


def fused_frame(plan, src, out=None, device=None):
    """Render the frame of a single full-spherical mount or cubemap
    source with one launch of the inline kernel (of the inline twined
    kernel when the plan carries a spread), then adapt channels (repix)
    and brighten. ``out`` is a caller-held (H, W, C_source)
    float32 buffer that the launch rewrites completely (the
    steady-state 'reuse' contract: no zero-fill, no allocation);
    without it a fresh buffer is made. Returns the (H, W, nchannels)
    image tensor on the source's device, which is ``out`` itself when
    no channel adaptation applies (the brighten is made in place)."""
    out = _frame_buffer(plan, src, out, device)
    if inline_mode(plan, src) is None:
        raise ValueError("the inline kernel does not cover this job "
                         "(partial or PTO source, generic chain, or a "
                         "stereographic/fisheye target): use planar_frame")
    inline_launch(plan, src, out)
    return _finish(plan, src, out)


def inline_launch(plan, src, out):
    """One launch of the inline kernel, or of the inline twined kernel
    for a twined plan, over the plan's window into ``out``
    (H, W, C_source)."""
    ops = frame_operands(plan, src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
    if plan.spread is None:
        R.resample_inline(out, src.spl.coeff, *tensors, **ops)
    else:
        R.resample_inline_twined(out, src.spl.coeff, *tensors,
                                 ops.pop("spread"), **ops)


@functools.lru_cache(maxsize=16)
def _chain_pickup(st, core_shape, pad, bcs):
    """The ``ops/resample.ChainPickup`` of a source's static
    configuration and spline layout."""
    if st.kind == "cubemap":
        m = st.metrics
        k = float(m.model_to_px)
        c = float(m.refc_md * m.model_to_px - 0.5)
        smode = "biatan6" if st.projection == Projection.BIATAN6 \
            else "cubemap"
        return R.ChainPickup(smode=smode, kx=k, cx=c, ky=k, cy=c,
                             pad=float(pad), section_px=float(m.section_px))
    # the model -> spline affine and the gates as inline_setup builds them
    (kx, cx, ky, cy, gate_x, glx, gux, gate_y, gly, guy, _pad) = \
        _sph_consts(_source_mode(st)[1], core_shape, pad, bcs)
    we = st.window_extent
    window = (-math.inf, math.inf, -math.inf, math.inf) \
        if st.full_fisheye else (we.x0, we.x1, we.y0, we.y1)
    return R.ChainPickup(
        smode="mount", kx=kx, cx=cx, ky=ky, cy=cy, pad=float(pad),
        projection=int(st.projection), gate_x=gate_x, glx=glx, gux=gux,
        gate_y=gate_y, gly=gly, guy=guy, window=window,
        lens=(st.s, st.a, st.b, st.c) if st.has_lcp else None,
        shift=(st.h, st.v) if st.has_shift else None,
        shear=(st.shear_g, st.shear_t) if st.has_shear else None,
        period=float(core_shape[1]) if bcs[1] == S.PERIODIC else 0.0)


def _pickup(src):
    """The source's ``ops/resample.ChainPickup``."""
    spl = src.spl
    return _chain_pickup(src.static, tuple(spl.core_shape), spl.pad,
                         tuple(spl.bcs))


def chain_operands(plan, src):
    """The kernel operands of the planar kernels' chain forms for this
    plan and source: ``frame_operands``' features, matrices and, for a
    twined plan, spread, with the source side as an
    ``ops/resample.ChainPickup`` (``pick``) in place of the inline
    kernel's ``consts`` and ``smode``; twined, ``tap_valid`` says whether
    each tap is tested against the source's window (a source that does
    not cover every ray)."""
    ops = frame_operands(plan, src)
    del ops["consts"], ops["smode"]
    ops["pick"] = _pickup(src)
    if plan.spread is not None:
        ops["tap_valid"] = not _covers_every_ray(src)
    return ops


def _generic_chain(plan):
    """The plan's generic planar -> ray chain (a translated facet,
    ``render.generic_r3``), the one case the coordinate passes serve."""
    if plan.planar_to_ray[0] is None:
        raise ValueError("the coordinate passes serve plans with a generic "
                         "chain (translated facets); every other plan takes "
                         "the chain forms")
    return plan.planar_to_ray[0]


def coords(plan, window, src):
    """Padded spline coordinates (sx, sy), the validity mask and the z of
    the normalised facet-CS ray, each (H, W) over ``window``, for a plan
    with a generic chain: the stepper's rays through the chain, then the
    chain forms' source half (``ops/resample.chain_coords``). Where the
    mask is False the coordinates may be non-finite (grazing or backward
    rays of a partial facet); only the mask hides them."""
    ray = ST.target_rays(plan.projection, plan.width, plan.height,
                         plan.extent, normalize=True,
                         planar_to_ray=_generic_chain(plan), window=window,
                         device=src.spl.coeff.device)
    sx, sy, mask = R.chain_coords(_pickup(src), *ray)
    return sx.contiguous(), sy.contiguous(), mask, ray[2]


def _covers_every_ray(src):
    """Cubemap sources, full-spherical mounts and full fisheyes have no
    invalid ray (``environment.get_mask`` is all-true), so a twined frame
    needs no per-tap validity."""
    return src.static.kind == "cubemap" or src.spl.spherical \
        or src.static.full_fisheye


def twined_coords(plan, window, src, recip_step=None):
    """Operands of the planar twined kernel over ``window`` for a twined
    plan with a generic chain, as the dict of
    ``ops/resample.twined_ray_operands``: the stepper's ninepack through
    the chain, then the twined chain's source half, with per-tap validity
    planes for a source that does not cover every ray, and with
    ``recip_step`` (a one-tap plan) the tap's voronoi score."""
    device = src.spl.coeff.device
    rays = ST.target_ninepack(plan.projection, plan.width, plan.height,
                              plan.extent, normalize=True,
                              planar_to_ray=_generic_chain(plan),
                              window=window, device=device)
    return R.twined_ray_operands(
        *rays, _spread_tensor(plan.spread, device), pick=_pickup(src),
        precise=plan.twine_precise, tap_valid=not _covers_every_ray(src),
        recip_step=recip_step)


def planar_frame(plan, src, out=None, device=None):
    """Render the frame of a single source with one launch of a planar
    kernel, then adapt channels and brighten. A plan without a generic
    chain (``plan.planar_to_ray[0] is None``) takes the chain forms,
    which compute the coordinate chain per pixel in the kernel
    (``chain_operands``): the planar chain kernel, or, for a twined plan,
    the twined chain kernel. A generic chain (a translated facet) takes
    the planes forms after the PyTorch coordinate pass: ``coords`` and
    the planar kernel, over the whole window for cubemap sources (the K5
    form) and over a zero-filled canvas through the validity mask (the
    K2 form) for other sources, or ``twined_coords`` and the planar
    twined kernel. Every form writes every pixel, 0 where the source
    (or, twined, every tap) misses: the JAX finish
    ``where(mask, canvas, 0)``. ``out`` and the return value are as for
    ``fused_frame``."""
    out = _frame_buffer(plan, src, out, device)
    launch(plan, src, out, inline=False)
    return _finish(plan, src, out)


def chain_launch(plan, src, out, score=None):
    """One launch of a chain form over the plan's window into ``out``
    (H, W, C_source): the planar chain kernel, or the twined chain
    kernel for a twined plan. The plan must have no generic chain. With
    ``score`` (H, W; untwined, or twined with one tap) the kernel writes
    each pixel's voronoi score there as well."""
    ops = chain_operands(plan, src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
    if plan.spread is None:
        R.resample_planar_chain(out, src.spl.coeff, *tensors, score=score,
                                recip_step=src.static.recip_step, **ops)
    else:
        R.resample_twined_chain(out, src.spl.coeff, *tensors,
                                ops.pop("spread"), score=score,
                                recip_step=src.static.recip_step, **ops)


def planes_launch(plan, src, out, score=None):
    """The PyTorch coordinate pass and one launch of a planes form over
    the plan's window into ``out`` (H, W, C_source): ``coords`` and the
    planar kernel (over a zero fill through the validity mask unless the
    source is a cubemap), or ``twined_coords`` and the planar twined
    kernel for a twined plan. With ``score`` (H, W; untwined, or twined
    with one tap) the voronoi score of the pass's rays (twined: of the
    tap's deflected rays) is written there."""
    coeff, degree = src.spl.coeff, src.spl.degree
    if plan.spread is not None:
        ops = twined_coords(plan, frame_window(plan), src,
                            None if score is None else src.static.recip_step)
        R.resample_twined(
            out, coeff, *(ops[k] for k in _TWINED_PLANES),
            _spread_tensor(plan.spread, coeff.device), degree=degree,
            n_taps=len(plan.spread), tap_weights=ops["tap_weights"],
            wrap_x=ops["wrap_x"])
        if score is not None:
            score.copy_(ops["score"])
        return
    sx, sy, mask, z = coords(plan, frame_window(plan), src)
    if score is not None:
        score.copy_(SYN.facet_score(z, mask, src.static.recip_step))
    if src.static.kind == "cubemap":
        R.resample_planar(out, coeff, sx, sy, degree=degree)
    else:
        out.zero_()
        R.resample_planar(out, coeff, sx, sy, degree=degree,
                          merge_mask=mask.to(torch.float32))


def facet_plans(plan):
    """One single-facet plan per facet of a stitch, each with that
    facet's basis or generic chain (kept per plan, so that each keeps
    its kernel operands from frame to frame)."""
    if plan not in _FACET_PLANS:
        _FACET_PLANS[plan] = tuple(
            dataclasses.replace(plan, facet_indices=(i,), bases=(b,),
                                planar_to_ray=(p,))
            for i, b, p in zip(plan.facet_indices, plan.bases,
                               plan.planar_to_ray))
    return _FACET_PLANS[plan]


# a one-tap plan of ``tap_plans`` -> its facet's twined plan, whose kernel
# operands (all but the spread) it shares, so that a stitch caches one
# set of features per facet, not per facet and tap
_TAP_OF = weakref.WeakKeyDictionary()


def tap_plans(plan):
    """Per tap (cx, cy, w) of a twined stitch's spread, (w, the facets'
    one-tap plans): each facet's entry of ``facet_plans`` with the spread
    ((cx, cy, 1.0),), so that one launch renders that tap alone, masked
    by its own deflected validity (kept per plan). The offsets stay as
    the plan has them: the kernels' operands fold 1/DERIV_BIAS in once
    (``synopsis.scaled_spread``)."""
    if plan not in _TAP_PLANS:
        taps = []
        for cx, cy, w in plan.spread:
            one = tuple(dataclasses.replace(fp, spread=((cx, cy, 1.0),))
                        for fp in facet_plans(plan))
            _TAP_OF.update(zip(one, facet_plans(plan)))
            taps.append((float(w), one))
        _TAP_PLANS[plan] = tuple(taps)
    return _TAP_PLANS[plan]


def route(plan, src, score=False, inline=True):
    """The one place where a facet's launch is chosen: "planes" for a
    generic chain (a translated facet: ``planes_launch``), "inline"
    where ``inline_mode`` allows it (unless ``inline`` is False or a
    ``score`` is asked for: the inline kernel writes none), else "chain"
    (``chain_launch``)."""
    if plan.planar_to_ray[0] is not None:
        return "planes"
    if inline and not score and inline_mode(plan, src) is not None:
        return "inline"
    return "chain"


def launch(plan, src, out, score=None, inline=True):
    """One kernel launch over the plan's window into ``out``
    (H, W, C_source), of the form ``route`` chooses. With ``score``
    (H, W; untwined, or twined with one tap) the facet's voronoi score
    is written there too. Returns the kernel's name."""
    form = "twined" if plan.spread is not None else "planar"
    how = route(plan, src, score is not None, inline)
    if how == "planes":
        planes_launch(plan, src, out, score)
        return f"resample_{form} after the coordinate pass"
    if how == "inline":
        inline_launch(plan, src, out)
        return "resample_inline" + ("_twined" if form == "twined" else "")
    chain_launch(plan, src, out, score)
    return f"resample_{form}_chain"


def facet_into(plan, src, slot, score=None):
    """Render one facet of a stitch (``plan`` is its entry of
    ``facet_plans``, or of one tap's ``tap_plans``) into ``slot``
    (H, W, nchannels), what the exact path's ``environment.lookup`` gives
    for it at that tap's rays: one ``launch`` (with ``score`` (H, W), the
    voronoi route, which writes the facet's score; without it,
    hdr_merge's, the route a single-facet frame takes), then the channel
    adaptation and brighten (``_finish``). Returns the kernel's name."""
    nch = src.spl.coeff.shape[-1]
    out = slot if nch == slot.shape[-1] else torch.empty(
        slot.shape[:2] + (nch,), dtype=torch.float32, device=slot.device)
    what = launch(plan, src, out, score)
    _finish(plan, src, out, slot)
    return what


def multi_frame(plan, sources, device=None, log=None):
    """Render a stitch of several sources: the counterpart of the JAX
    ``fused_multi_frame`` followed by ``_combine_stack`` and, twined, of
    ``_render_fast_multi_pertap``. One pixel stack (F, H, W, nchannels)
    and, for voronoi and voronoi_plus, one score stack (F, H, W) are
    allocated per frame; each facet is rendered into its slot by one
    kernel launch (``facet_into``); the synopsis of the stacks
    (``models/synopsis``: ``voronoi_stack``, ``voronoi_plus_stack`` or
    ``hdr_merge_stack``) gives the frame. A twined plan does that once
    per tap of its spread through the facets' one-tap plans
    (``tap_plans``), reusing the stacks, and sums the taps' combines with
    their weights (``synopsis.twined_stack``), as ``synopsis.twined``
    sums them on the exact path. Returns the (H, W, nchannels) image
    tensor on the sources' device; ``log``, a list, receives each
    launch's kernel name, tap by tap and facet by facet."""
    _check_kernel_job(plan, sources)
    dev = sources[0].spl.coeff.device
    if any(s.spl.coeff.device != dev for s in sources) or (
            device is not None and torch.device(device) != dev):
        raise ValueError("the sources must live on one device, the "
                         "render's")
    syn = SYN.pick_synopsis(plan.synopsis, plan.nchannels)
    y0, y1, x0, x1 = frame_window(plan)
    shape = (len(sources), y1 - y0, x1 - x0)
    stack = torch.empty(shape + (plan.nchannels,), dtype=torch.float32,
                        device=dev)
    score = None if syn is SYN.hdr_merge else torch.empty(
        shape, dtype=torch.float32, device=dev)

    def stitch(fplans):
        for fi, (fplan, src) in enumerate(zip(fplans, sources)):
            what = facet_into(fplan, src, stack[fi],
                              None if score is None else score[fi])
            if log is not None:
                log.append(what)
        if score is None:
            return SYN.hdr_merge_stack(list(stack),
                                       [s.static.brighten for s in sources],
                                       plan.nchannels)
        combine = SYN.voronoi_stack if syn is SYN.voronoi \
            else SYN.voronoi_plus_stack
        return combine(stack, None, score)

    if plan.spread is None:
        return stitch(facet_plans(plan))
    acc = None
    for w, fplans in tap_plans(plan):
        acc = SYN.twined_stack(acc, stitch(fplans), w)
    return acc


def frame_tensor(plan, sources, verbose: bool = False,
                 device=None) -> torch.Tensor:
    """The CUDA render path of ``render.render_frame``, up to the frame
    on the card: one frame through ``exact_frame`` where ``exact_route``
    names a reason, else through one ``launch`` (the route
    ``fused_frame`` or ``planar_frame`` takes), or for several sources
    ``multi_frame``; returned as the (H, W, C) float32 tensor on the
    sources' device, enqueued and not waited for. ``device`` is the
    render's (paint sources have no table to take it from). Raises
    ``NotImplementedError`` for jobs the port does not cover."""
    reason = uncovered(plan, sources)
    if reason is not None:
        raise NotImplementedError(
            f"no CUDA kernel for this job yet: {reason}")
    why = exact_route(plan, sources)
    if why is not None:
        img = exact_frame(plan, sources, device)
        if verbose:
            print(f"fastpath: the exact path over {img.shape[0]}x"
                  f"{img.shape[1]} px on {img.device} ({why})")
        return img
    if len(sources) > 1:
        log = []
        img = multi_frame(plan, sources, log=log)
        if verbose:
            n_f = len(sources)
            taps = plan.spread or ((0.0, 0.0, 1.0),)
            for ti, (cx, cy, w) in enumerate(taps):
                at = "" if plan.spread is None else \
                    f"tap {ti} ({cx:g}, {cy:g}, weight {w:g}): "
                for fi, what in enumerate(log[ti * n_f:(ti + 1) * n_f]):
                    print(f"fastpath: {at}facet {fi}: 1 launch of {what}")
            print(f"fastpath: {plan.synopsis} of {n_f} facets"
                  + ("" if plan.spread is None else
                     f" per tap, {len(taps)} taps")
                  + f", {len(log)} launches over "
                  f"{img.shape[0]}x{img.shape[1]} px")
        return img
    src = sources[0]
    out = _frame_buffer(plan, src, None, None)
    what = launch(plan, src, out)
    img = _finish(plan, src, out)
    if verbose:
        taps = f", {len(plan.spread)} taps" if plan.spread is not None \
            else ""
        print(f"fastpath: 1 launch of {what} over "
              f"{img.shape[0]}x{img.shape[1]} px{taps}")
    return img


def render_fast(plan, sources, verbose: bool = False,
                device=None) -> np.ndarray:
    """``frame_tensor``'s frame as a host (H, W, C) float32 array."""
    return frame_tensor(plan, sources, verbose, device).cpu().numpy()


def render_fast_mesh(plan, sources, mesh, verbose: bool = False,
                     split=None) -> np.ndarray:
    """``--mesh N`` through the kernels: ``parallel.mesh.sharded_render``
    (the frame's output rows in N bands, the same band plans from frame
    to frame so that each keeps its kernel operands, every band
    enqueued before any is copied back) with ``frame_tensor`` as each
    band's route on its device: the band's ``launch``, ``multi_frame``
    (per tap when twined) or ``exact_frame``, the route the whole frame
    takes. Each pixel is computed from its absolute coordinates, so the
    host (H, W, C) float32 frame is bit-equal to the one-device frame.
    The counterpart of the JAX package's ``render_fast_mesh``
    (``_mesh_solo``, ``_mesh_solo_twined``, ``_mesh_solo_twined_partial``,
    ``_mesh_multi``, ``_mesh_multi_pertap``), without its tile planner:
    only the height must divide into the bands. ``split`` as
    ``sharded_render``'s."""
    from ..parallel import mesh as PM
    return PM.sharded_render(
        plan, sources, mesh,
        lambda bplan, srcs, dev: frame_tensor(bplan, srcs, verbose, dev),
        verbose, split).numpy()
