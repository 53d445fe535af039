"""The twined inline kernel's increment pickup (a tap's longitude and
latitude as increments from the centre ray's, ``ops/resample.
increment_coords``) against the full pickup ``ray_coords`` at the 8K and
16K tables' constants, the share of pixel-taps that take it, the gate's
branch without a division against ``_gate`` and the kernel's floor-mod,
and (on a card) the kernel against its plain version at 16 taps. No JAX
render: the module under test is the port's own arithmetic, and the
file imports no JAX at its top, so that its card test runs where JAX is
not installed.
"""

import math

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.core.facet import Facet
from envutil_tpu_torch.core.metrics import get_extent, get_step
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import twining
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.ops import spline as S
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.args import Args
from envutil_tpu_torch.runtime.render import build_plan

torch.set_num_threads(1)

# One ulp of the padded coordinate on the 16K table (sx >= 16384 px, so
# an ulp is 1.95e-3 px), with 2.5% to spare: the increment rounds
# lon0 + dlon once where atan2 rounds lon once, and the affine's
# rounding to the coordinate may then land one ulp apart; the bound
# admits one such ulp, not two
INCREMENT_PX = 2e-3


def sphere(width: int):
    """A full-spherical width x width/2 facet."""
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(TP.SPHERICAL, width, width // 2, 2 * math.pi)
    f.step = get_step(TP.SPHERICAL, width, width // 2, 2 * math.pi)
    f.process_geometry()
    return f


def sphere_source(device, degree=1):
    """A seeded noise 256x128 full-spherical mount."""
    img = np.random.default_rng(5).uniform(0, 1, (128, 256, 3))
    return TE.make_mount_source(sphere(256), img.astype(np.float32), degree,
                                degree, device=device)


def twined_plan(proj, w, h, hfov, ypr, spread, degree=1):
    """The plan of a twined view of ``sphere(256)`` with ``spread``."""
    a = Args()
    a.projection = proj
    a.width, a.height = w, h
    a.hfov = math.radians(hfov)
    a.extent = get_extent(proj, w, h, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / w
    a.yaw, a.pitch, a.roll = (math.radians(v) for v in ypr)
    a.spline_degree = a.prefilter_degree = degree
    a.synopsis, a.nchannels, a.solo = "panorama", 3, 0
    a.facets = [sphere(256)]
    a.twine, a.twine_spread, a.twine_precise = 1, list(spread), False
    return build_plan(a, a.facets)


def sph_consts(width: int, degree: int = 1):
    """``fused_frame``'s constants of a full-spherical width x width/2
    mount at ``degree``, without building its table."""
    st = TE.mount_static(sphere(width), 3)
    ext = st.total_extent
    statics = (ext.x0, ext.x1, ext.y0, ext.y1, st.total_width,
               st.total_height, st.window_x_offset, st.window_y_offset)
    return FP._sph_consts(statics, (width // 2, width), float(degree + 1),
                          (S.REFLECT, S.PERIODIC))


def seeded_rays(rng, n, pixel):
    """``n`` unit centre rays over the sphere (poles and the seam
    included) with derivative rays of ``pixel`` radians in their tangent
    planes, float32."""
    p0 = rng.normal(size=(3, n))
    p0[:, :8] = [[0, 0, 1e-4, -1e-4, 0, 0, 1e-3, 0],
                 [1, -1, 1, -1, 0.3, -0.2, 1, 0.5],
                 [0, 0, 0, 0, -1, -1, -1e-3, -1]]   # poles, seam
    p0 /= np.linalg.norm(p0, axis=0)
    a = np.cross(p0.T, rng.normal(size=(n, 3))).T
    a /= np.linalg.norm(a, axis=0)
    b = np.cross(p0.T, a.T).T
    scale = pixel * rng.uniform(0.25, 2.0, size=n)
    du, dv = a * scale, b * scale
    return tuple(tuple(torch.from_numpy(c.astype(np.float32)) for c in v)
                 for v in (p0, du, dv))


@pytest.mark.parametrize("width", [8192, 16384], ids=["8K", "16K"])
def test_increment_pickup_matches_ray_coords(width):
    """Seeded rays deflected by the 2x2, 4x4 and 5x5 spreads at output
    pixels of 1e-4 to 1e-2 rad: every tap's increment coordinates within
    INCREMENT_PX of the full pickup's (sx modulo the period), nearly all
    taps taken, the fallback taps equal to ``ray_coords``."""
    consts = sph_consts(width)
    period = consts[6] - consts[5]
    rng = np.random.default_rng(width)
    worst, taken_n, total = 0.0, 0, 0
    for n_side in (2, 4, 5):
        spread = twining.make_spread(n_side)
        for pixel in (1e-4, 8.5e-4, 1e-2):
            p0, du, dv = seeded_rays(rng, 4000, pixel)
            for cx, cy, _w in spread:
                d = tuple(cx * u + cy * v for u, v in zip(du, dv))
                sx, sy, taken = R.increment_coords(p0, d, consts=consts)
                fx, fy = R.ray_coords(*(a + b for a, b in zip(p0, d)),
                                      consts=consts)
                dx = torch.remainder(sx - fx, period)
                dx = torch.minimum(dx, period - dx)
                err = torch.maximum(dx, (sy - fy).abs())
                worst = max(worst, float(err[taken].max()))
                assert torch.equal(sx[~taken], fx[~taken])
                assert torch.equal(sy[~taken], fy[~taken])
                taken_n += int(taken.sum())
                total += taken.numel()
    assert worst <= INCREMENT_PX, worst
    assert taken_n >= 0.98 * total, taken_n / total


def increment_share(plan, src):
    """The share of the frame's pixel-taps whose tap took the
    increment pickup (the twined kernel's plain version)."""
    ops = FP.frame_operands(plan, src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats", "spread")]
    planes = [taken for _x, _y, _w, taken in R.inline_tap_coords(
        *tensors, tmode=ops["tmode"], consts=ops["consts"], row0=ops["row0"],
        face_rows=ops["face_rows"], smode=ops["smode"],
        precise=ops["precise"])]
    return float(torch.stack(planes).float().mean())


@pytest.mark.parametrize("name", ["config-4-like", "pole-and-seam"])
def test_increment_share(name):
    """A config-4-like view (rectilinear, hfov 100, 2x2 taps) takes the
    increment at >= 99% of its pixel-taps; the pole-and-seam view of
    the route tests (3x3 taps) sends taps next to the pole to the full
    pickup; a one-tap plan takes none."""
    if name == "pole-and-seam":
        from test_torch_twining import BOX3, INLINE_ROUTES
        view = next(r[1:6] for r in INLINE_ROUTES if r[0] == name)
        spread = BOX3
    else:
        view = (TP.RECTILINEAR, 128, 80, 100.0, (0.0, 0.0, 0.0))
        spread = twining.make_spread(2)
    src = sphere_source("cpu")
    share = increment_share(twined_plan(*view, spread), src)
    if name == "pole-and-seam":
        assert 0.5 < share < 1.0, share
    else:
        assert share >= 0.99, share
    ops = FP.frame_operands(twined_plan(*view, [(0.25, 0.0, 1.0)]), src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats", "spread")]
    assert all(taken is None for *_c, taken in R.inline_tap_coords(
        *tensors, **{k: ops[k] for k in ("tmode", "consts", "row0",
                                         "face_rows", "smode")}))


def _ulps_around(x, k):
    """float32 values within ``k`` ulps of ``x``, both sides."""
    x = np.float32(x)
    out = [x]
    lo = hi = x
    for _ in range(k):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return out


@pytest.mark.parametrize("mode", ["periodic", "mirror"])
def test_gate_in_range_is_bit_equal(mode):
    """The gate's branch without a division, ``gate_in_range``, on a
    sweep through, at and past both bounds (and the period) of the
    longitude and latitude gates of the 256-px, 8K and 16K tables: where
    it applies, its value is ``_gate``'s and the kernel's floor-mod
    form's (v - floor(v / p) p in float32) bit for bit; at u = period it
    does not apply."""
    rng = np.random.default_rng(7)
    for width in (256, 8192, 16384):
        for lower, upper in ((-0.5, width - 0.5), (-0.5, width / 2 - 0.5)):
            lo32, up32 = np.float32(lower), np.float32(upper)
            period = up32 - lo32 if mode == "periodic" \
                else np.float32(2.0) * (up32 - lo32)
            vals = []
            for edge in (lo32, up32, lo32 + period, lo32 + period / 2):
                vals += _ulps_around(edge, 64)
            vals += list(rng.uniform(lower - 2 * period, upper + 2 * period,
                                     4000).astype(np.float32))
            vals += [lo32 + np.nextafter(period, np.float32(0)), lo32 + period]
            v = torch.from_numpy(np.array(vals, np.float32))
            inside, value = R.gate_in_range(v, mode, lower, upper)
            want = R._gate(v, mode, lower, upper)
            assert torch.equal(value[inside], want[inside])
            u = (v.numpy() - lo32).astype(np.float32)
            fm = (u - np.floor(u / period) * period).astype(np.float32)
            if mode == "mirror":
                fm = np.minimum(fm, (period - fm).astype(np.float32))
            kernel = (lo32 + fm).astype(np.float32)
            assert np.array_equal(value.numpy()[inside.numpy()],
                                  kernel[inside.numpy()])
            # u just below the period is inside, u at the period not
            below = torch.from_numpy(u == np.nextafter(period, np.float32(0)))
            at = torch.from_numpy(u == period)
            assert bool(below.any()) and bool(inside[below].all())
            assert bool(at.any()) and not bool(inside[at].any())
            assert int(inside.sum()) > 100 and int((~inside).sum()) > 100


@pytest.mark.cuda
def test_inline_twined_kernel_matches_plain_at_16_taps():
    """K4 on the card against its plain version at 16 taps (the 4x4
    spread of a steep downscale), a full sphere to a rectilinear view
    with the pole and the seam in it (needs a CUDA card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    src = sphere_source("cuda")
    plan = twined_plan(TP.RECTILINEAR, 96, 64, 120.0, (180.0, 70.0, 0.0),
                       twining.make_spread(4))
    ops = FP.frame_operands(plan, src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats", "spread")]
    assert ops["n_taps"] == 16
    before = R.resample_inline_twined.launches
    k = R.resample_inline_twined(torch.empty(64, 96, 3, device="cuda"),
                                 src.spl.coeff, *tensors, **ops)
    p = R.resample_inline_twined_plain(torch.empty(64, 96, 3, device="cuda"),
                                       src.spl.coeff, *tensors, **ops)
    torch.cuda.synchronize()
    assert R.resample_inline_twined.launches == before + 1
    assert float((k - p).abs().max()) <= 1e-4
