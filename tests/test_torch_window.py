"""The staged windows of the port's inline kernel, on the CPU.

The CUDA kernel ``resample_inline`` copies each block's bounding box of
table entries into shared memory and reads its taps from there; a block
whose box does not fit its budget, and any support that is not inside
its block's window, reads global memory instead. ``ops/resample.window_model`` and ``window_holds`` say in plain
PyTorch which blocks stage what. These tests hold the model to what the
kernel relies on: a window covers every support it is said to hold, an
evaluation that can read nothing but the block's window agrees bit for
bit with the plain version (same weights, same order), and blocks that
cannot fit - a pole, the periodic seam, a cube-face edge - are reported
as such. The kernel's two branches against each other run only on a
card (the ``cuda``-marked test; chip_smoke.py drives them at full
size).
"""

import math

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection as P
from envutil_tpu_torch.core.facet import Facet
from envutil_tpu_torch.core.metrics import get_extent, get_step
from envutil_tpu_torch.models import cubemap as CBM
from envutil_tpu_torch.models import environment as E
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.ops import spline as S
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.args import Args
from envutil_tpu_torch.runtime.render import build_plan

torch.set_num_threads(1)

TILE = R.TILE_INLINE
# the kernel's default: small enough that the blocks at the pole, across
# the seam and across cube-face edges do not fit, large enough for the
# others (a 32x16 tile at ~1.5 source px per output px needs
# (48+4) x (24+4) x 12 bytes)
BUDGET = R.WINDOW_BYTES


def _facet(proj, w, h, hfov):
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(proj, w, h, hfov)
    f.step = get_step(proj, w, h, hfov)
    f.process_geometry()
    return f


def _plan(fct, proj, w, h, hfov_deg, degree, ypr, spread=None):
    a = Args()
    a.projection = proj
    a.width, a.height = w, h
    a.hfov = math.radians(hfov_deg)
    a.extent = get_extent(proj, w, h, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / w
    a.yaw, a.pitch, a.roll = (math.radians(v) for v in ypr)
    a.spline_degree = a.prefilter_degree = degree
    a.twine = 0
    a.synopsis = "panorama"
    a.nchannels = 3
    a.facets = [fct]
    a.solo = 0
    if spread is not None:
        a.twine, a.twine_spread = 1, list(spread)
    return build_plan(a, [fct])


def _source(kind, degree):
    rng = np.random.default_rng(11)
    if kind == "sph":
        fct = _facet(P.SPHERICAL, 256, 128, 2 * math.pi)
        img = rng.uniform(0, 1, (128, 256, 3)).astype(np.float32)
        return fct, E.make_mount_source(fct, img, degree, degree,
                                        device="cpu")
    proj, fov = (P.CUBEMAP, 90) if kind == "cubemap" else (P.BIATAN6, 100)
    fct = _facet(proj, 32, 192, math.radians(fov))
    faces = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
    return fct, CBM.make_cubemap_source(fct, faces, degree, degree, 8, 16,
                                        device="cpu")


# name -> (source kind, degree, target, w, h, hfov, (yaw, pitch, roll))
INLINE_CASES = {
    "sphere, pole and seam": ("sph", 3, P.SPHERICAL, 128, 64, 360,
                              (160, -80, 10)),
    "sphere to cubemap": ("sph", 3, P.CUBEMAP, 64, 384, 90, (0, 0, 0)),
    "cubemap source, face edges": ("cubemap", 3, P.SPHERICAL, 128, 64, 360,
                                   (20, -30, 10)),
    "biatan6 source, face edges": ("biatan6", 2, P.RECTILINEAR, 96, 64, 100,
                                   (40, 30, 5)),
    "sphere, degree 1 view of the pole": ("sph", 1, P.RECTILINEAR, 96, 64,
                                          100, (175, 70, 5)),
    "sphere, degree 7": ("sph", 7, P.CYLINDRICAL, 128, 64, 360,
                         (90, 0, 20)),
}

def _table(coeff, degree):
    return S.Spline2D(coeff=coeff, pad=0, degree=degree,
                      bcs=(S.CONSTANT, S.CONSTANT),
                      core_shape=tuple(coeff.shape[:2]))


def staged_eval(coeff, win, sx, sy, degree, tile):
    """The spline at (sx, sy), each block's pixels evaluated on a table
    that holds nothing but the block's staged window (NaN elsewhere; all
    NaN for a block that does not stage): a read outside the window
    shows as NaN."""
    hp, wp, nch = coeff.shape
    tw, th = tile
    h, w = sx.shape
    flat = coeff.reshape(hp, wp * nch)
    out = torch.full((h, w, nch), float("nan"))
    for i in range(win["staged"].shape[0]):
        for j in range(win["staged"].shape[1]):
            if not win["staged"][i, j]:
                continue
            only = torch.full_like(flat, float("nan"))
            y0, y1, f0, span = (int(win[k][i, j])
                                for k in ("y0", "y1", "f0", "span"))
            only[y0:y1 + 1, f0:f0 + span] = flat[y0:y1 + 1, f0:f0 + span]
            ys = slice(i * th, min((i + 1) * th, h))
            xs = slice(j * tw, min((j + 1) * tw, w))
            out[ys, xs] = S.eval_spline(
                _table(only.view(hp, wp, nch), degree), sx[ys, xs],
                sy[ys, xs], apply_gate=False)
    return out


@pytest.fixture(scope="module")
def inline_cases():
    out = {}
    for name, (kind, degree, proj, w, h, hfov, ypr) in INLINE_CASES.items():
        fct, src = _source(kind, degree)
        ops = FP.frame_operands(_plan(fct, proj, w, h, hfov, degree, ypr),
                                src)
        tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
        plain = R.resample_inline_plain(torch.empty(h, w, 3), src.spl.coeff,
                                        *tensors, **ops)
        ops.pop("degree")
        sx, sy = R.inline_coords(*tensors, **ops)
        out[name] = (src.spl.coeff, degree, sx, sy, plain)
    return out


@pytest.mark.parametrize("name", list(INLINE_CASES))
def test_window_covers_every_support_it_stages(inline_cases, name):
    coeff, degree, sx, sy, _plain = inline_cases[name]
    kw = dict(degree=degree, table_shape=coeff.shape, tile=TILE)
    win = R.window_model(sx, sy, window_bytes=BUDGET, **kw)
    holds = R.window_holds(win, sx, sy, **kw)
    staged_px = R.block_to_pixels(win["staged"], TILE, *sx.shape)
    inside = R.support_bases(sx, sy, degree, *coeff.shape[:2])[2]
    # the gated coordinates of these sources never leave the table
    assert bool(inside.all())
    assert torch.equal(holds, staged_px)
    assert bool((win["bytes"][win["staged"]] <= BUDGET).all())
    assert bool((win["bytes"][~win["staged"]] > BUDGET).all())
    # some blocks of every fixture stage and some cannot
    assert 0 < int(win["staged"].sum()) < win["staged"].numel()
    # 16-byte aligned row segments where the table's rows are
    if (coeff.shape[1] * coeff.shape[2]) % 4 == 0:
        assert bool((win["f0"] % 4 == 0).all())
        assert bool((win["span"] % 4 == 0).all())
    assert bool((win["pitch"] % 32 == 4).all())
    assert bool((win["pitch"] >= win["span"]).all())


@pytest.mark.parametrize("name", list(INLINE_CASES))
def test_staged_evaluation_is_bit_equal_to_plain(inline_cases, name):
    coeff, degree, sx, sy, plain = inline_cases[name]
    kw = dict(degree=degree, table_shape=coeff.shape, tile=TILE)
    win = R.window_model(sx, sy, window_bytes=BUDGET, **kw)
    holds = R.window_holds(win, sx, sy, **kw)
    staged = staged_eval(coeff, win, sx, sy, degree, TILE)
    assert bool(torch.isfinite(staged[holds]).all())
    assert torch.equal(staged[holds], plain[holds])
    assert bool(staged[~holds].isnan().all())


def test_hard_blocks_are_reported_as_not_fitting(inline_cases):
    coeff, degree, sx, sy, _plain = inline_cases["sphere, pole and seam"]
    kw = dict(degree=degree, table_shape=coeff.shape, tile=TILE)
    win = R.window_model(sx, sy, window_bytes=BUDGET, **kw)
    wide = (win["x1"] - win["x0"] + 1) > coeff.shape[1] // 2
    assert bool(wide.any())                   # the seam and the pole
    assert not bool(win["staged"][wide].any())
    none = R.window_model(sx, sy, window_bytes=0, **kw)
    assert not bool(none["staged"].any())
    every = R.window_model(sx, sy, window_bytes=1 << 30, **kw)
    assert bool(every["staged"].all())
    # a support that leaves the table is never staged
    far = R.window_model(sx + 1e4, sy, window_bytes=1 << 30, **kw)
    assert not bool(far["staged"].any())
    coeff, degree, sx, sy, _plain = inline_cases["cubemap source, face edges"]
    kw = dict(degree=degree, table_shape=coeff.shape, tile=TILE)
    # half the budget, so that no window taller than one of the
    # fixture's small sections fits
    win = R.window_model(sx, sy, window_bytes=BUDGET // 2, **kw)
    section = coeff.shape[0] // 6
    tall = (win["y1"] - win["y0"] + 1) > section   # two faces' sections
    assert bool(tall.any()) and not bool(win["staged"][tall].any())


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")


@pytest.mark.cuda
def test_inline_kernel_branches_agree_on_card():
    """The staged and the direct branch bit for bit, and both against
    the plain version, over the fixtures above (which hold a pole, the
    seam and cube-face edges) at several budgets."""
    _cuda_or_skip()
    for name, (kind, degree, proj, w, h, hfov, ypr) in INLINE_CASES.items():
        fct, src = _source(kind, degree)
        ops = FP.frame_operands(_plan(fct, proj, w, h, hfov, degree, ypr),
                                src)
        tensors = [ops.pop(k).cuda() for k in ("xfeat", "yfeat", "bmats")]
        coeff = src.spl.coeff.cuda()
        plain = R.resample_inline_plain(
            torch.empty(h, w, 3, device="cuda"), coeff, *tensors, **ops)
        direct = R.resample_inline(torch.empty(h, w, 3, device="cuda"),
                                   coeff, *tensors, window_bytes=0, **ops)
        for budget in (1024, BUDGET, R.WINDOW_BYTES):
            staged = R.resample_inline(
                torch.empty(h, w, 3, device="cuda"), coeff, *tensors,
                window_bytes=budget, **ops)
            torch.cuda.synchronize()
            assert torch.equal(staged, direct), (name, budget)
        if kind == "sph":   # cube-face edges aside (chip_smoke.py)
            assert float((direct - plain).abs().max()) <= 1e-3, name
