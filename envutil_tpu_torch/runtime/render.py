"""Render orchestration.

PyTorch counterpart of envutil_tpu/runtime/render.py (the reference's
dispatch/roll_out/fuse stack, envutil_payload.cc:1885-2435). A plan
holds the target geometry and one camera-to-facet basis per facet;
``render_frame`` runs it

* on CUDA through one launch of the inline-coordinates kernel
  (runtime/fastpath.py), raising ``NotImplementedError`` for jobs this
  slice of the port has no kernel for - the plain path never stands in
  for a kernel on the card;
* on the CPU through the exact path: target rays (models/stepper),
  ``environment.lookup`` and ``spline.eval_spline``, in row chunks.

Translation / lens-corrected chains (generic_r3 / tf_ex_facet),
twining and multi-facet synopses wait for later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.conventions import Projection
from ..core.facet import Facet
from ..core.metrics import Extent
from ..core.rotation import rotation_rpy
from ..models import environment as E
from ..models import stepper as ST
from .platform import resolve_device


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
    bases: Tuple = ()             # 3x3 np arrays
    # output cropping (p-line S clause)
    crop: Optional[Tuple[int, int, int, int]] = None  # y0,y1,x0,x1


def build_plan(args, facets: Sequence[Facet]) -> RenderPlan:
    """The fuse() decision tree (envutil_payload.cc:2028-2283) for
    rotation-only jobs: one pre-rotated basis matrix per facet."""
    cam = (args.roll, args.pitch, args.yaw)
    if args.single >= 0:
        fct = facets[args.single]
        if fct.has_2d_tf or fct.has_translation:
            raise NotImplementedError(
                "--single with lens/translation transforms (generic_r3, "
                "tf_ex_facet) waits for the PTO slice of the PyTorch port")

    indices = [args.solo] if args.solo >= 0 else list(range(len(facets)))
    bases = []
    for i in indices:
        fct = facets[i]
        if fct.has_translation:
            raise NotImplementedError(
                "translated facets (generic_r3) wait for the PTO slice "
                "of the PyTorch port")
        bases.append(rotation_rpy(fct.roll, fct.pitch, fct.yaw).T
                     @ rotation_rpy(*cam))

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
        crop=crop)


def _render_window(plan: RenderPlan, sources: List[E.FacetSource],
                   window) -> torch.Tensor:
    """Exact render of one output window (single facet, no twining) on
    the sources' device."""
    if len(sources) != 1 or plan.spread is not None:
        raise NotImplementedError(
            "multi-facet synopses and twining wait for later slices of "
            "the PyTorch port")
    src = sources[0]
    ray = ST.target_rays(plan.projection, plan.width, plan.height,
                         plan.extent, basis=plan.bases[0], normalize=True,
                         window=window, device=src.spl.coeff.device)
    px, mask = E.lookup(src, ray, plan.nchannels)
    return torch.where(mask[..., None], px, 0.0)


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
        img = fastpath.render_fast(plan, sources, verbose=verbose)
        if amplify is not None:
            img = E.apply_brighten(torch.from_numpy(img), amplify).numpy()
    else:
        # bound the working set: 512 MB of float32 intermediates
        budget = 512 * 1024 * 1024 // 4
        per_px = max(1, len(sources)) * (4 + plan.nchannels)
        chunks = max(1, int(np.ceil(n_px * per_px / budget)))
        rows = y1 - y0
        chunk_rows = max(1, (rows + chunks - 1) // chunks)
        parts = []
        yy = y0
        while yy < y1:
            ye = min(yy + chunk_rows, y1)
            out = _render_window(plan, sources, (yy, ye, x0, x1))
            if amplify is not None:
                out = E.apply_brighten(out, amplify)
            parts.append(out)
            yy = ye
        img = torch.cat(parts, dim=0).numpy().astype(np.float32)
    msec = (time.perf_counter() - start) * 1000.0
    if verbose:
        print(f"frame rendering time: {msec:.1f} ms "
              f"({n_px / 1e6 / (msec / 1000.0):.1f} Mpix/s)")
    render_frame.last_ms = msec
    return img


render_frame.last_ms = 0.0
