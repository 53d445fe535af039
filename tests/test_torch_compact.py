"""The chain forms' compact grid (``ops/resample.chain_blocks``,
``runtime/fastpath.block_list``, the ``blocks`` of
``resample_planar_chain`` and ``resample_twined_chain``) on the CPU,
through the plain versions: over each geometry the coverage list holds
every pixel that the full-window chain writes as something other than
0 / ``synopsis.LOWEST``, a listed plain chain touches only its listed
blocks and equals the full-window chain there bit for bit, and
``fastpath.chain_launch`` (the fill, then the listed launch) equals the
full-window launch bit for bit over the whole window, score included.
The geometries: a facet straddling the equirect's periodic seam, a
partial lens facet, the same facet twined at 2x2 taps, one tap of a
twined stitch (whose list is its facet's union over the taps), and a
band of a cubemap target (``row0`` > 0, a matrix a face). And, on a
card, the coverage kernel and the listed kernels against their plain
versions.

No JAX: the module under test is the port's own, and the file imports
no JAX at its top, so that its card test runs where JAX is not
installed (``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_compact.py -m cuda``). tests/test_torch_compact_jax.py
holds the lists against the JAX ``_coords`` mask and the stitches
against the JAX ``render_frame``.

Every comparison is bit for bit: the listed launch runs the same
arithmetic on the same pixels as the full-window one, and the fill
writes what the full-window launch writes where a ray misses.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.core.facet import Facet
from envutil_tpu_torch.core.metrics import get_extent, get_step
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.args import Args
from envutil_tpu_torch.runtime.render import build_plan

torch.set_num_threads(1)

LENS = dict(a=0.01, b=-0.02, c=0.005)
BOX2 = [[-0.25, -0.25, 0.25], [0.25, -0.25, 0.25], [-0.25, 0.25, 0.25],
        [0.25, 0.25, 0.25]]


def facet(proj, w, h, hfov, no=0, **kw):
    """A port facet of ``proj``, w x h, ``hfov`` degrees, with the
    attributes ``kw`` (yaw and pitch in radians, lens terms)."""
    f = Facet(facet_no=no, nchannels=3)
    f.set_geometry(proj, w, h, math.radians(hfov))
    f.step = get_step(proj, w, h, math.radians(hfov))
    for k, v in kw.items():
        setattr(f, k, v)
    f.process_geometry()
    return f


def source(f, device="cpu", degree=3):
    """Seeded noise on ``f``'s raster, as a mount source on ``device``."""
    img = np.random.default_rng(13 + f.facet_no).uniform(
        0, 1, (f.height, f.width, 3)).astype(np.float32)
    return TE.make_mount_source(f, img, degree, degree, device=device)


def plan_of(facets, proj, w, h, hfov, ypr=(0.0, 0.0, 0.0), spread=None,
            degree=3):
    """The port's plan of the facets viewed in ``proj`` (a stitch for
    several facets, voronoi), twined by ``spread`` where given."""
    a = Args()
    a.projection = proj
    a.width, a.height = w, h
    a.hfov = math.radians(hfov)
    a.extent = get_extent(proj, w, h, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / w
    a.yaw, a.pitch, a.roll = (math.radians(v) for v in ypr)
    a.spline_degree = a.prefilter_degree = degree
    a.twine, a.synopsis, a.nchannels = 0, "panorama", 3
    a.facets, a.solo = facets, (0 if len(facets) == 1 else -1)
    if spread is not None:
        a.twine, a.twine_spread, a.twine_precise = 1, list(spread), False
    return build_plan(a, facets)


def geometry(name, device="cpu"):
    """(plan of one chain launch, its source, whether it writes a score)
    of a named geometry."""
    sph = (TP.SPHERICAL, 256, 128, 360.0)
    if name == "seam":
        f = facet(TP.RECTILINEAR, 64, 48, 70.0, yaw=math.pi)
        return plan_of([f], *sph), source(f, device), True
    if name in ("lens", "lens, twined 2x2"):
        f = facet(TP.RECTILINEAR, 64, 48, 72.0, yaw=0.3, pitch=0.2, **LENS)
        spread = BOX2 if name.endswith("2x2") else None
        return plan_of([f], *sph, spread=spread), source(f, device), False
    if name == "one tap of a stitch":
        fs = [facet(TP.RECTILINEAR, 64, 48, 70.0, no=i, yaw=y)
              for i, y in enumerate((-0.5, 0.5))]
        stitch = plan_of(fs, *sph, spread=BOX2)
        return FP.tap_plans(stitch)[1][1][0], source(fs[0], device), True
    # a band of a 32-px cubemap stripe: rows 40..136 cross the right, top
    # and bottom faces into the front one
    f = facet(TP.RECTILINEAR, 64, 48, 80.0, yaw=0.6, pitch=0.1)
    cube = plan_of([f], TP.CUBEMAP, 32, 192, 90.0)
    return dataclasses.replace(cube, crop=(40, 136, 0, 32)), \
        source(f, device), False


def launch_operands(plan, src):
    """(chain form, its plain version, positional operands, keywords) of
    the plan's chain launch without its block list."""
    ops = FP.chain_operands(plan, src)
    args = [src.spl.coeff] + [ops.pop(k) for k in ("xfeat", "yfeat",
                                                    "bmats")]
    if plan.spread is None:
        forms = R.resample_planar_chain, R.resample_planar_chain_plain
    else:
        args.append(ops.pop("spread"))
        forms = R.resample_twined_chain, R.resample_twined_chain_plain
    return (*forms, args, dict(ops, recip_step=src.static.recip_step))


def canvases(plan, src, scored, fill=float("nan")):
    y0, y1, x0, x1 = FP.frame_window(plan)
    shape = (y1 - y0, x1 - x0, src.spl.coeff.shape[-1])
    dev = src.spl.coeff.device
    return (torch.full(shape, fill, device=dev),
            torch.full(shape[:2], fill, device=dev) if scored else None)


@pytest.mark.parametrize("name", ["seam", "lens", "lens, twined 2x2",
                                  "one tap of a stitch", "cube band"])
def test_block_list_holds_the_chain(name):
    """The plan's block list against the full-window plain chain: no
    unlisted block holds a pixel other than 0 / LOWEST; the listed plain
    chain leaves unlisted pixels untouched and equals the full-window
    chain on the listed ones; ``chain_launch`` (fill, listed launch)
    equals it everywhere; the list is built once per plan."""
    plan, src, scored = geometry(name)
    _kernel, plain, args, kw = launch_operands(plan, src)
    y0, y1, x0, x1 = FP.frame_window(plan)
    h, w = y1 - y0, x1 - x0
    builds = FP.block_list.builds
    blocks = FP.block_list(plan, src)
    assert FP.block_list(plan, src) is blocks
    assert FP.block_list.builds == builds + 1
    nby, nbx = R.block_grid(h, w)
    assert blocks is not None and 0 < blocks.numel() < nby * nbx, name
    assert torch.equal(blocks, torch.sort(blocks).values)
    listed = R.block_pixels(blocks, h, w)

    full, full_score = canvases(plan, src, scored)
    plain(full, *args, score=full_score, **kw)
    assert bool((full[~listed] == 0).all()), name
    if scored:
        assert bool((full_score[~listed] == SYN.LOWEST).all()), name
    assert bool((full[listed] != 0).any()), name

    out, score = canvases(plan, src, scored)
    plain(out, *args, score=score, blocks=blocks, **kw)
    assert bool(torch.isnan(out[~listed]).all())
    assert torch.equal(out[listed], full[listed])
    if scored:
        assert bool(torch.isnan(score[~listed]).all())
        assert torch.equal(score[listed], full_score[listed])

    out, score = canvases(plan, src, scored)
    assert FP.chain_launch(plan, src, out, score) is blocks
    assert torch.equal(out, full)
    if scored:
        assert torch.equal(score, full_score)

    if name == "one tap of a stitch":
        # the facet's list serves every tap: the union of their coverage
        owner = FP._TAP_OF[plan]
        assert FP.block_list(owner, src) is blocks
        for cx, cy, _w in owner.spread:
            one = dataclasses.replace(owner, spread=((cx, cy, 1.0),))
            _k, tplain, targs, tkw = launch_operands(one, src)
            tout, tscore = canvases(one, src, True)
            tplain(tout, *targs, score=tscore, **tkw)
            assert bool((tout[~listed] == 0).all())
            assert bool((tscore[~listed] == SYN.LOWEST).all())


@pytest.mark.cuda
def test_compact_kernels_match_plain_on_card():
    """On a card: the coverage kernel's list against its plain version
    (the same blocks, none more and none fewer: a wider list would pass
    the launch checks unseen), each listed launch after the fill bit-equal to the full-window launch
    of the same kernel, and the launch and block counters (needs a CUDA
    card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    for name in ("seam", "lens", "lens, twined 2x2", "one tap of a stitch",
                 "cube band"):
        plan, src, scored = geometry(name, "cuda")
        kernel, _plain, args, kw = launch_operands(plan, src)
        feats, ckw = FP.cover_operands(plan, src)
        launches = R.chain_blocks.launches
        got = R.chain_blocks(*feats, **ckw)
        want = R.chain_blocks_plain(*feats, **ckw)
        assert R.chain_blocks.launches == launches + 1
        differ = set(got.tolist()) ^ set(want.tolist())
        assert not differ, (name, sorted(differ), got.numel(), want.numel())
        full, full_score = canvases(plan, src, scored)
        kernel(full, *args, score=full_score, **kw)
        h, w = full.shape[:2]
        listed = R.block_pixels(got, h, w)
        assert bool((full[~listed] == 0).all()), name
        out, score = canvases(plan, src, scored, 0.0)
        if scored:
            score.fill_(SYN.LOWEST)
        count = kernel.blocks
        kernel(out, *args, score=score, blocks=got, **kw)
        torch.cuda.synchronize()
        assert kernel.blocks == count + got.numel()
        assert torch.equal(out, full), name
        if scored:
            assert torch.equal(score, full_score), name
