"""Facet loading: image file(s) -> FacetSource (prefiltered spline on the
render device + static lookup config), with asset caching.

Counterpart of envutil_tpu/runtime/loader.py: cubemap/biatan6 facets
(a 1:6 stripe or a ``%s`` cubeface series) build the IR spline,
everything else a mount source; a facet that ``--twine_pyramid``
marked (``Args._apply_pyramid``) is box-decimated before its spline is
built. ``--coeff bf16`` stores the table in bfloat16 (half the device
memory of float32; the kernels evaluate in float32), and
``--coeff_cache DIR`` keeps prefiltered tables on disk
(runtime/coeff_cache.py). The TPU fast path's rolled/pitched/section
source variants are not needed on the card at all.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.conventions import FACE_NAMES, Projection
from ..core.facet import Facet
from ..core.metrics import CubemapMetrics
from ..io import imgio
from ..models import cubemap as CBM
from ..models import environment as E
from ..ops import spline as S
from . import assets, coeff_cache
from .platform import resolve_device

_CUBE = (Projection.CUBEMAP, Projection.BIATAN6)


def _read_facet_image(fct: Facet, args) -> np.ndarray:
    """Read the facet's pixel data (single file or %s cubeface series,
    envutil_basic.h:265-356) in the working colour space."""
    def read(name):
        return imgio.read_image(name, fct.colour_space,
                                args.working_colour_space, args.verbose,
                                oiio_options=args.oiio_options)
    if "%s" in fct.filename:
        return np.stack([read(fct.filename % name)
                         for name in FACE_NAMES])  # (6, F, F, C)
    return read(fct.filename)


def _decimate(img: np.ndarray, level: int) -> np.ndarray:
    """--twine_pyramid 2^level x 2^level box decimation of (H, W, C)
    pixel data. Box averaging preserves the edge-to-edge sample grid
    exactly: decimated pixel centres coincide with the centroids of
    the source blocks they replace (twine_setup already rewrote the
    facet's geometry to the decimated size)."""
    s = 1 << level
    h, w, c = img.shape
    if h % s or w % s:
        raise ValueError(f"image {img.shape} does not divide by {s}")
    return img.reshape(h // s, s, w // s, s, c).mean(
        axis=(1, 3), dtype=np.float32)


def _build(fct: Facet, args, img: np.ndarray, device) -> E.FacetSource:
    if fct.projection in _CUBE:
        if img.ndim == 3:
            f = img.shape[1]
            if img.shape[0] != 6 * f:
                raise ValueError(
                    "cubemap input must be a 1:6 stripe or %s series")
            faces = img.reshape(6, f, f, img.shape[2])
        else:
            faces = img
        # the facet's width is the face width for cubemaps (the JAX
        # package sets it on the facet itself, and so does the port)
        fct.width = faces.shape[1]
        return CBM.make_cubemap_source(
            fct, faces, args.spline_degree, args.prefilter_degree,
            args.support_min, args.tile_size, device=device)
    return E.make_mount_source(fct, img, args.spline_degree,
                               args.prefilter_degree, args.verbose,
                               device=device)


def _make_source_from(fct: Facet, args, spl) -> E.FacetSource:
    """Recreate the static config around a cached spline (the brighten
    may differ between jobs)."""
    nch = spl.coeff.shape[-1]
    if fct.projection in _CUBE:
        m = CubemapMetrics.create(fct.width, fct.hfov, args.support_min,
                                  args.tile_size)
        return E.FacetSource(static=CBM.cubemap_static(fct, nch, m),
                             spl=spl)
    return E.FacetSource(static=E.mount_static(fct, nch), spl=spl)


def cache_keys(fct: Facet, args, device) -> tuple:
    """(disk key, RAM key) of a facet's table: the JAX package's key
    (envutil_tpu/runtime/loader.py), so that the two packages' disk
    entries are one; the RAM cache (``assets.cache``) adds the
    device."""
    key = (fct.asset_key, args.spline_degree, args.prefilter_degree,
           fct.projection, args.nchannels if fct.masked != -1 else -1,
           getattr(args, "coeff_dtype", "f32"), fct.pyramid_level)
    return key, key + (str(torch.device(device)),)


def load_source(fct: Facet, args, device=None) -> E.FacetSource:
    """Build (or fetch from the asset cache, then from the disk cache)
    the FacetSource for a facet, on ``device``, its table in the storage
    dtype ``args.coeff_dtype``; a ``--mask_for`` job without alpha gets
    a paint source, which has no table."""
    # masking jobs without alpha need no image data (masking_t path,
    # environment.h:1585-1588 / source_t:658)
    if fct.masked != -1 and args.nchannels in (1, 3):
        return E.make_paint_source(fct)
    device = resolve_device(device)
    coeff_dtype = getattr(args, "coeff_dtype", "f32")
    key, ram_key = cache_keys(fct, args, device)
    cached = assets.cache.find(ram_key)
    if cached is not None:
        if args.verbose:
            print(f"asset {fct.asset_key} is already present in RAM")
        return _make_source_from(fct, args, cached)

    # the on-disk cache skips the image read and the prefilter across
    # process restarts; its tables are stored in their storage dtype
    spl = coeff_cache.load(args, fct, key, device)
    if spl is not None:
        src = _make_source_from(fct, args,
                                S.storage_spline(spl, coeff_dtype))
    else:
        img = _read_facet_image(fct, args)
        if fct.pyramid_level > 0:
            img = _decimate(img, fct.pyramid_level)
        src = _build(fct, args, img, device)
        del img
        # the float32 table is dropped as its bf16 copy replaces it, so
        # the peak is one float32 table and its copy
        src.spl = S.storage_spline(src.spl, coeff_dtype)
        coeff_cache.store(args, fct, key, src.spl)
    assets.cache.add(ram_key, src.spl)
    return src
