"""The mesh's bookkeeping in the port (parallel/mesh.py,
runtime/fastpath.py), without the JAX package: a steady-state
``--mesh`` frame builds no kernel operands, the band plans and table
copies are made once, and (on a machine with two cards) a kernel
launches on the card its tensors live on whichever card is current."""

import dataclasses
import gc
import math

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection as P
from envutil_tpu_torch.core.facet import Facet
from envutil_tpu_torch.core.metrics import get_extent, get_step
from envutil_tpu_torch.models import environment as E
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.parallel import mesh as PM
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.args import Args
from envutil_tpu_torch.runtime.render import build_plan

torch.set_num_threads(1)


def _facet(projection, w, h, hfov_deg, no=0, yaw=0.0):
    f = Facet(facet_no=no, nchannels=3)
    f.set_geometry(projection, w, h, math.radians(hfov_deg))
    f.step = get_step(projection, w, h, math.radians(hfov_deg))
    f.yaw = math.radians(yaw)
    f.process_geometry()
    return f


def _job(device="cpu", twine=0, yaws=(-15.0, 15.0)):
    """(plan, sources): seeded noise facets, 80x112 rectilinear, stitched
    into a 64x64 view, twined 2x2 for ``twine`` 2; one full-spherical
    64x128 facet when ``yaws`` is empty."""
    rng = np.random.default_rng(13)
    if yaws:
        facets = [_facet(P.RECTILINEAR, 112, 80, 70.0, i, y)
                  for i, y in enumerate(yaws)]
    else:
        facets = [_facet(P.SPHERICAL, 128, 64, 360.0)]
    sources = [E.make_mount_source(
        f, rng.uniform(0, 1, (f.height, f.width, 3)).astype(np.float32),
        1, 1, device=device) for f in facets]
    a = Args()
    a.projection = P.RECTILINEAR
    a.width = a.height = 64
    a.hfov = math.radians(60)
    a.extent = get_extent(a.projection, 64, 64, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / 64
    a.spline_degree = a.prefilter_degree = 1
    a.twine, a.synopsis, a.nchannels = 0, "panorama", 3
    a.facets, a.solo = facets, (-1 if yaws else 0)
    if twine:
        a.twine = twine
        a.twine_setup()
    return build_plan(a, facets), sources


def test_steady_state_mesh_frame_builds_no_operands():
    """A twined stitch over four bands: the first frame builds each band
    facet's operands once (4 bands x 2 facets, the one-tap plans share
    their facet's), the second and third build none and hand the same
    band plans to the fast path; the operands go with their plan."""
    plan, sources = _job(twine=2)
    assert len(plan.spread) == 4
    mesh = PM.make_mesh(["cpu"] * 4)
    before = FP._operands.builds
    first = FP.render_fast_mesh(plan, sources, mesh)
    assert FP._operands.builds - before == 4 * 2
    bands = PM.band_plans(plan, 4)
    assert [b.crop for b in bands] == [(16 * k, 16 * k + 16, 0, 64)
                                       for k in range(4)]
    gc.collect()
    held = len(FP._OPERANDS)
    for _ in range(2):
        before = FP._operands.builds
        again = FP.render_fast_mesh(plan, sources, mesh)
        assert FP._operands.builds == before
        np.testing.assert_array_equal(again, first)
    assert PM.band_plans(plan, 4) is bands
    assert len(FP._OPERANDS) == held
    del plan, bands
    gc.collect()
    assert len(FP._OPERANDS) == held - 4 * 2


def test_mesh_devices_and_table_copies():
    """A mesh keeps its devices in order, repeats and all; the tables
    are copied once per distinct device and not at all where they live
    (the ``meta`` device stands in for a second card)."""
    mesh = PM.make_mesh(["cpu"] * 3)
    assert mesh.size == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="one device type"):
        PM.make_mesh(["cpu", "meta"])
    assert PM.available_devices("cpu", 5) == [torch.device("cpu")] * 5
    assert PM.band_windows((8, 40, 2, 30), 4) == [
        (8, 16, 2, 30), (16, 24, 2, 30), (24, 32, 2, 30), (32, 40, 2, 30)]
    _plan, sources = _job(yaws=())
    two = PM.Mesh((torch.device("cpu"), torch.device("meta"),
                   torch.device("meta")))
    slots = PM.replicate_sources(sources, two)
    assert slots[0][0] is sources[0]
    assert slots[1][0].spl is slots[2][0].spl
    assert slots[1][0].spl.coeff.device.type == "meta"
    assert PM.replicate_sources(sources, two)[2][0].spl is slots[1][0].spl


def test_table_copies_keep_each_sources_static():
    """Two facets that read one file share its table (the loader keys
    tables on the file) but differ in their static part, here their
    brighten: each copy on another device (``meta`` standing in for a
    second card) keeps its own facet's static and shares one copy of
    the table."""
    _plan, (src,) = _job(yaws=())
    bright = dataclasses.replace(
        src, static=dataclasses.replace(src.static, brighten=2.0))
    assert bright.spl is src.spl and bright.static != src.static
    two = PM.Mesh((torch.device("cpu"), torch.device("meta")))
    for _ in range(2):
        (a, b), (ma, mb) = PM.replicate_sources([src, bright], two)
        assert a is src and b is bright
        assert ma.static is src.static and mb.static is bright.static
        assert ma.spl is mb.spl and ma.spl.coeff.device.type == "meta"
    ring = PM.shard_sources([src, bright], two)
    assert [s.static for s in ring] == [src.static, bright.static]
    assert ring[0].spl is ring[1].spl


@pytest.mark.cuda
def test_kernel_launches_on_its_tensors_card():
    """The inline kernel with its tensors on the second card while the
    first is current (a mesh band on its card): it launches there, with
    a window budget above 48 KB (the opt-in its shared-memory attribute
    sets per card), and agrees with its plain version."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    plan, (src,) = _job(device="cuda:1", yaws=())
    ops = FP.frame_operands(plan, src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
    assert all(t.device == torch.device("cuda:1") for t in tensors)
    kw = dict(ops, degree=1)
    plain = R.resample_inline_plain(
        torch.empty(64, 64, 3, device="cuda:1"), src.spl.coeff, *tensors,
        **kw)
    with torch.cuda.device(0):
        for budget in (R.WINDOW_BYTES, 64 * 1024):
            out = R.resample_inline(
                torch.empty(64, 64, 3, device="cuda:1"), src.spl.coeff,
                *tensors, window_bytes=budget, **kw)
            torch.cuda.synchronize(1)
            assert float((out - plain).abs().max()) <= 1e-3
