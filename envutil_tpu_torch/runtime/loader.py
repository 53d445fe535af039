"""Facet loading: image file -> FacetSource (prefiltered spline on the
render device + static lookup config), with asset caching.

Counterpart of envutil_tpu/runtime/loader.py for mount facets. Cubemap
facets, the on-disk coefficient cache, bf16 tables, the twining
pyramid and the TPU fast path's rolled/pitched source variants wait for
later slices (the variants are not needed on Hopper at all).
"""

from __future__ import annotations

from ..core.conventions import Projection
from ..core.facet import Facet
from ..io import imgio
from ..models import environment as E
from . import assets


def load_source(fct: Facet, args, device=None) -> E.FacetSource:
    """Build (or fetch from the asset cache) the FacetSource for a
    mount facet, on ``device``."""
    if fct.masked != -1 and args.nchannels in (1, 3):
        raise NotImplementedError(
            "--mask_for paint sources wait for the masking slice of the "
            "PyTorch port")
    if fct.projection in (Projection.CUBEMAP, Projection.BIATAN6):
        raise NotImplementedError(
            "cubemap/biatan6 sources wait for the cubemap-source slice "
            "of the PyTorch port")
    if getattr(args, "coeff_dtype", "f32") != "f32":
        raise NotImplementedError(
            "bf16 coefficient tables wait for a later slice of the "
            "PyTorch port")
    if fct.pyramid_level > 0:
        raise NotImplementedError(
            "--twine_pyramid waits for the twining slice of the PyTorch "
            "port")

    key = (fct.asset_key, args.spline_degree, args.prefilter_degree,
           fct.projection, str(device))
    cached = assets.cache.find(key)
    if cached is not None:
        if args.verbose:
            print(f"asset {fct.asset_key} is already present in RAM")
        # rebind the cached spline to this facet's static config (the
        # brighten may differ between jobs)
        return E.FacetSource(
            static=E.mount_static(fct, cached.coeff.shape[-1]), spl=cached)
    img = imgio.read_image(fct.filename, fct.colour_space,
                           args.working_colour_space, args.verbose,
                           oiio_options=args.oiio_options)
    src = E.make_mount_source(fct, img, args.spline_degree,
                              args.prefilter_degree, args.verbose,
                              device=device)
    assets.cache.add(key, src.spl)
    return src
