"""Render orchestration.

PyTorch counterpart of envutil_tpu/runtime/render.py (the reference's
dispatch/roll_out/fuse stack, envutil_payload.cc:1885-2435). A plan
holds the target geometry and one camera-to-facet basis per facet;
``render_frame`` runs it

* on CUDA through one launch of an inline-coordinates kernel or of a
  planar kernel (runtime/fastpath.py), each with its twined form, and
  for a stitch one such launch per facet and the synopsis of their
  stacks (twined, once per tap of the spread, one-tap launches, the
  taps' synopses summed); a job no kernel takes (a spline degree above
  ``ops.resample.MAX_DEGREE``, a ``--mask_for`` job, a ``--twine_precise``
  job that would take the planar twined kernel) takes the exact path
  below on the card, as the JAX package sends it to its XLA graph.
  Jobs the port has no
  route for yet raise ``NotImplementedError``: the plan picks the
  route, and the plain versions never stand in for a kernel on the
  card;
* on the CPU through the exact path: target rays per facet
  (models/stepper), ``environment.lookup`` and ``spline.eval_spline``,
  then the synopsis (models/synopsis: voronoi, voronoi_plus,
  hdr_merge), in row chunks; under twining the three ray grids of the
  ninepack and ``synopsis.twined``, each tap masked by its own
  deflected validity.

Translated facets, and every facet of a ``--single`` re-creation of a
lens-corrected or translated facet, use the 'generic' transform chain
(generic_r3 / tf_ex_facet, envutil_payload.cc:1629-1883, with the
inverse lens LUT of models/lens for a lens-corrected target) instead of
a plain rotation.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..core.conventions import Projection
from ..core.facet import Facet
from ..core.metrics import Extent
from ..core.rotation import rotation_rpy
from ..models import environment as E
from ..models import lens as L
from ..models import stepper as ST
from ..models import synopsis as SYN
from .platform import resolve_device


# ---------------------------------------------------------------------------
# 3D->3D transform chains (generic_r3 / tf3d_t)
# ---------------------------------------------------------------------------

def _tf3d(r1: Optional[np.ndarray], r2: np.ndarray, shift: np.ndarray,
          dcp: float = 1.0) -> Callable:
    """Rotate to an intermediate CS, optionally reproject onto the
    plane z=1, scale by dcp, shift, rotate on (tf3d_t,
    geometry.h:1851-1942). Rays behind the reprojection plane are
    poisoned with z = -inf."""
    if not np.any(shift != 0.0):
        # collapse to a single rotation
        m = r2 if r1 is None else r2 @ r1

        def g(x, y, z):
            return geo.apply_matrix(m, x, y, z)
        return g

    def f(x, y, z):
        x, y, z = geo.apply_matrix(r1, x, y, z)
        bad = z <= 0.0
        zz = torch.where(bad, torch.ones_like(z), z)
        px = (x / zz) * dcp - float(shift[0])
        py = (y / zz) * dcp - float(shift[1])
        pz = torch.full_like(z, dcp - float(shift[2]))
        px, py, pz = geo.apply_matrix(r2, px, py, pz)
        px = torch.where(bad, 0.0, px)
        py = torch.where(bad, 0.0, py)
        pz = torch.where(bad, -math.inf, pz)
        return px, py, pz
    return f


def generic_r3(ft: Facet, fs: Facet) -> Callable:
    """Full target->source ray transform honouring translation planes
    on both sides (generic_r3, envutil_payload.cc:1629-1822). ``ft`` is
    the target geometry (the job's arguments), ``fs`` the source
    facet."""
    r_cam = rotation_rpy(ft.roll, ft.pitch, ft.yaw)
    r_ttp = rotation_rpy(ft.tp_r, ft.tp_p, ft.tp_y)
    r_stp = rotation_rpy(fs.tp_r, fs.tp_p, fs.tp_y)
    r_f = rotation_rpy(fs.roll, fs.pitch, fs.yaw)

    have_ttp = ft.tr_x != 0 or ft.tr_y != 0 or ft.tr_z != 0
    have_stp = fs.tr_x != 0 or fs.tr_y != 0 or fs.tr_z != 0

    shift_t = np.array([ft.tr_x, ft.tr_y, ft.tr_z], np.float64)
    if ft.tp_y != 0 or ft.tp_p != 0 or ft.tp_r != 0:
        shift_t = r_ttp.T @ shift_t
    dcp = 1.0 - shift_t[2]
    shift_t = -shift_t

    shift_s = np.array([fs.tr_x, fs.tr_y, fs.tr_z], np.float64)
    if fs.tp_y != 0 or fs.tp_p != 0 or fs.tp_r != 0:
        shift_s = r_stp.T @ shift_s

    if have_ttp and have_stp:
        f1 = _tf3d(r_ttp.T @ r_cam, r_ttp, shift_t, dcp)
        f2 = _tf3d(r_stp.T, r_f.T @ r_stp, shift_s)
        return lambda x, y, z: f2(*f1(x, y, z))
    if have_ttp:
        return _tf3d(r_ttp.T @ r_cam, r_f.T @ r_ttp, shift_t, dcp)
    if have_stp:
        return _tf3d(r_stp.T @ r_cam, r_f.T @ r_stp, shift_s)
    return _tf3d(None, r_f.T @ r_cam, np.zeros(3))


def tf_ex_facet(ft: Facet, fs: Facet) -> Callable:
    """planar (target model space) -> ray in the source facet's CS,
    including the inverse planar transform when the *target* is a
    lens-corrected facet (--single re-creation; tf_ex_facet,
    envutil_payload.cc:1841-1883). Returns fn(px, py) -> ray."""
    tf33 = generic_r3(ft, fs)
    tf23 = geo.to_ray(ft.projection,
                      section_md=(ft.extent.x1 - ft.extent.x0),
                      refc_md=(ft.extent.x1 - ft.extent.x0) / 2.0)
    tf22 = L.pto_planar_inverse(ft) if ft.has_2d_tf else None

    def f(px, py):
        if tf22 is not None:
            px, py = tf22(px, py)
        return tf33(*tf23(px, py))
    return f


@dataclasses.dataclass(eq=False)  # identity hash: one plan per job
class RenderPlan:
    """Everything static needed to render one frame, built host-side
    from Args + facet specs."""
    projection: Projection
    width: int
    height: int
    extent: Extent
    nchannels: int
    synopsis: str
    spread: Optional[tuple]       # None = no twining
    twine_precise: bool = False
    solo: int = -1
    # one entry per participating facet:
    facet_indices: Tuple[int, ...] = ()
    bases: Tuple = ()             # 3x3 np arrays or None
    planar_to_ray: Tuple = ()     # callables or None (generic path)
    # output cropping (p-line S clause)
    crop: Optional[Tuple[int, int, int, int]] = None  # y0,y1,x0,x1


def build_plan(args, facets: Sequence[Facet]) -> RenderPlan:
    """The fuse() decision tree (envutil_payload.cc:2028-2283): per
    facet, either a pre-rotated basis matrix or a generic planar->ray
    chain: for a translated facet, and for every facet when the target
    is a ``--single`` re-creation of a lens-corrected or translated
    facet."""
    cam = (args.roll, args.pitch, args.yaw)
    generic_target = args.single >= 0 and (
        facets[args.single].has_2d_tf or facets[args.single].has_translation)

    indices = [args.solo] if args.solo >= 0 else list(range(len(facets)))
    bases, p2r = [], []
    for i in indices:
        fct = facets[i]
        if generic_target or fct.has_translation:
            bases.append(None)
            p2r.append(tf_ex_facet(args.as_facet(), fct))
        else:
            bases.append(rotation_rpy(fct.roll, fct.pitch, fct.yaw).T
                         @ rotation_rpy(*cam))
            p2r.append(None)

    crop = None
    if getattr(args, "store_cropped", False):
        crop = (args.p_crop_y0, args.p_crop_y1,
                args.p_crop_x0, args.p_crop_x1)

    # twine == -1 with an empty spread means twine_setup was skipped
    # (API misuse): render untwined rather than summing zero taps
    spread = tuple(tuple(t) for t in args.twine_spread) \
        if (args.twine != 0 and args.twine_spread) else None

    return RenderPlan(
        projection=args.projection, width=args.width, height=args.height,
        extent=args.extent, nchannels=int(args.nchannels),
        synopsis=args.synopsis, spread=spread,
        twine_precise=bool(getattr(args, "twine_precise", False)
                           and spread is not None),
        solo=args.solo, facet_indices=tuple(indices), bases=tuple(bases),
        planar_to_ray=tuple(p2r), crop=crop)


def _solo(sources, rays, nch):
    """The synopsis of one facet: its lookup, misses painted 0."""
    px, mask = E.lookup(sources[0], rays[0], nch)
    return torch.where(mask[..., None], px, 0.0)


def sources_device(sources: List[E.FacetSource], device=None):
    """The device of the sources' tables, or ``device`` (the caller's)
    where none has a table (paint sources of a ``--mask_for`` job)."""
    for src in sources:
        if src.spl is not None:
            return src.spl.coeff.device
    if device is None:
        raise ValueError("no source has a table: name the render's device")
    return torch.device(device)


def _render_window(plan: RenderPlan, sources: List[E.FacetSource],
                   window, device=None) -> torch.Tensor:
    """Exact render of one output window on the sources' device
    (``sources_device``): rays per facet, then the synopsis (one facet:
    its lookup), under twining through ``synopsis.twined``."""
    device = sources_device(sources, device)
    syn = _solo if len(sources) == 1 else \
        SYN.pick_synopsis(plan.synopsis, plan.nchannels)
    geometry = [dict(basis=b, normalize=True, planar_to_ray=p, window=window,
                     device=device)
                for b, p in zip(plan.bases, plan.planar_to_ray)]
    if plan.spread is None:
        rays = [ST.target_rays(plan.projection, plan.width, plan.height,
                               plan.extent, **g) for g in geometry]
        return syn(sources, rays, plan.nchannels)
    packs = [ST.target_ninepack(plan.projection, plan.width, plan.height,
                                plan.extent, **g) for g in geometry]
    return SYN.twined(syn, sources, packs, plan.nchannels, plan.spread,
                      precise=plan.twine_precise)


def render_exact(plan: RenderPlan, sources: List[E.FacetSource],
                 amplify: Optional[float] = None,
                 device=None) -> torch.Tensor:
    """The exact path over the plan's window on the sources' device
    (``sources_device``), in row chunks that bound the working set to
    512 MB of float32 intermediates over pixels * facets * taps; the
    (H, W, C) tensor."""
    from . import fastpath

    device = sources_device(sources, device)
    y0, y1, x0, x1 = fastpath.frame_window(plan)
    taps = len(plan.spread) if plan.spread else 1
    budget = 512 * 1024 * 1024 // 4
    per_px = max(1, len(sources)) * (4 + plan.nchannels) * max(1, taps // 4)
    chunks = max(1, int(np.ceil((y1 - y0) * (x1 - x0) * per_px / budget)))
    chunk_rows = max(1, (y1 - y0 + chunks - 1) // chunks)
    parts = []
    for yy in range(y0, y1, chunk_rows):
        out = _render_window(plan, sources,
                             (yy, min(yy + chunk_rows, y1), x0, x1), device)
        if amplify is not None:
            out = E.apply_brighten(out, amplify)
        parts.append(out)
    return torch.cat(parts, dim=0)


def render_frame(plan: RenderPlan, sources: List[E.FacetSource],
                 verbose: bool = False,
                 amplify: Optional[float] = None,
                 device=None) -> np.ndarray:
    """Render a frame on ``device`` (CUDA unless the caller asks for the
    CPU) and return the host-side (H, W, C) float32 array. The sources
    must live on that device. Timing is reported like the reference's
    'frame rendering time' (envutil_payload.cc:546-557)."""
    from . import fastpath

    device = resolve_device(device)
    for src in sources:
        if src.spl is not None and src.spl.coeff.device.type != device.type:
            raise ValueError(f"source table lives on {src.spl.coeff.device}"
                             f", the render runs on {device}")
    y0, y1, x0, x1 = fastpath.frame_window(plan)
    n_px = (y1 - y0) * (x1 - x0)

    start = time.perf_counter()
    if device.type == "cuda":
        img = fastpath.render_fast(plan, sources, verbose=verbose,
                                   device=device)
        if amplify is not None:
            img = E.apply_brighten(torch.from_numpy(img), amplify).numpy()
    else:
        img = render_exact(plan, sources, amplify,
                           device).numpy().astype(np.float32)
    msec = (time.perf_counter() - start) * 1000.0
    if verbose:
        print(f"frame rendering time: {msec:.1f} ms "
              f"({n_px / 1e6 / (msec / 1000.0):.1f} Mpix/s)")
    render_frame.last_ms = msec
    return img


render_frame.last_ms = 0.0
