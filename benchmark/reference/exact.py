"""The plain reference of a cell's frame, in float64.

A frozen copy of the exact-path mathematics of the upstream renderer
(the b-spline prefilter and evaluation of zimt, the projections of
geometry.h, the PT lens polynomial, the voronoi synopsis and twining of
envutil_payload.cc), written as plain PyTorch over float64 tensors. It
reads only the seeded images and the cell's JSON (the configuration's
facets, the traffic's request) and imports nothing of the measured
program: tables, rays, champions, spreads and tap weights are all worked
out again here.

``Reference(config, traffic, images, device)`` builds the tables once;
``rows(y0, y1)`` gives one block of output rows as

* ``value``: the frame the job asks for, (rows, W, C);
* ``slack``: per pixel and channel, how far a float32 render may lie from
  ``value`` because a decision is within rounding of its threshold: a ray
  within ``EDGE_PX`` of a facet's window edge, or two facets' voronoi
  scores within ``TIE_REL`` of each other. At such a tap every facet that
  could win is a candidate, and the slack is the largest distance of a
  candidate's value from the champion's, weighted as the tap is; 0
  elsewhere;
* ``ambiguous``: the pixels with such a tap.

``work`` counts, as the rows are made, what the frame needs: the table
entries under the taps that reach the frame, per facet, and the pixel-taps
that are evaluated; ``benchmark/counts`` turns that into a least time.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

PROJECTIONS = {"spherical": 0, "cylindrical": 1, "rectilinear": 2,
               "stereographic": 3, "fisheye": 4, "cubemap": 5, "biatan6": 6}
SPHERICAL, CYLINDRICAL, RECTILINEAR, CUBEMAP = 0, 1, 2, 5
D2R = math.pi / 180.0
# sub-pixel offset of the twining derivative grids, in sample steps
DERIV_BIAS = 0.25
# a tap whose source coordinate lies within this many source pixels of a
# facet's window edge may be taken as inside or outside by a float32 chain
EDGE_PX = 0.01
# two voronoi scores this close (relative) may be ordered either way by a
# float32 chain
TIE_REL = 1e-5
REFLECT, PERIODIC = "reflect", "periodic"


# ---------------------------------------------------------------------------
# image metrics (envutil_basic.cc: get_step, get_extent), for the
# projections the cells use
# ---------------------------------------------------------------------------

def step(projection, width, hfov):
    """Angular width of a central pixel."""
    if projection in (RECTILINEAR, CUBEMAP):
        return math.atan(2.0 * math.tan(hfov / 2.0) / width)
    if projection == SPHERICAL:
        return hfov / width
    raise ValueError(f"projection {projection} has no reference step")


def extent(projection, width, height, hfov):
    """(x0, x1, y0, y1) in model units of a centred image."""
    bx = hfov / 2.0
    if projection == SPHERICAL:
        by = hfov * height / width / 2.0
        return (-bx, bx, -by, by)
    if projection == RECTILINEAR:
        ty = height * math.tan(bx) / width
        return (math.tan(-bx), math.tan(bx), -ty, ty)
    if projection == CUBEMAP:
        x0, x1 = math.tan(-bx), math.tan(bx)
        return (x0, x1, 6.0 * x0, 6.0 * x1)
    raise ValueError(f"projection {projection} has no reference extent")


def rotation(roll, pitch, yaw):
    """Ry(yaw) @ Rx(pitch) @ Rz(roll) (Imath ZXY), radians."""
    c, s = math.cos(yaw), math.sin(yaw)
    ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    c, s = math.cos(pitch), math.sin(pitch)
    rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    c, s = math.cos(roll), math.sin(roll)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return ry @ rx @ rz


# ---------------------------------------------------------------------------
# b-spline basis (float64, host)
# ---------------------------------------------------------------------------

def bspline_basis(degree, x):
    """Centred cardinal b-spline of ``degree`` at x (Cox-de Boor)."""
    t = np.asarray(x, np.float64) + (degree + 1) / 2.0
    vals = np.stack([((t >= i) & (t < i + 1)).astype(np.float64)
                     for i in range(2 * degree + 1)])
    for p in range(1, degree + 1):
        vals = np.stack([(t - i) / p * vals[i]
                         + ((i + 1 + p) - t) / p * vals[i + 1]
                         for i in range(len(vals) - 1)])
    return vals[0]


@functools.lru_cache(maxsize=None)
def inverse_kernel(degree, tol=1e-12):
    """The inverse spline filter's impulse response, truncated where its
    taps fall below ``tol`` of the centre tap (odd length)."""
    if degree < 2:
        return np.array([1.0])
    m = degree // 2
    b = bspline_basis(degree, np.arange(-m, m + 1, dtype=np.float64))
    n_fft = 8192
    w = np.fft.rfftfreq(n_fft) * 2.0 * np.pi
    symbol = np.full_like(w, b[m])
    for k in range(1, m + 1):
        symbol += 2.0 * b[m + k] * np.cos(k * w)
    h = np.fft.irfft(1.0 / symbol, n=n_fft)
    k_max = 1
    for k in range(1, n_fft // 2):
        if abs(h[k]) > tol * abs(h[0]):
            k_max = k
    return np.concatenate([h[k_max:0:-1], h[:k_max + 1]])


@functools.lru_cache(maxsize=None)
def weight_matrix(degree):
    """M with w_j(t) = sum_k M[j, k] t^k, the weight of coefficient
    ``select - degree // 2 + j`` at the in-cell fraction t."""
    n = degree
    if n == 0:
        return np.array([[1.0]])
    lo, hi = (0.0, 1.0) if n % 2 else (-0.5, 0.5)
    ts = lo + (hi - lo) * np.arange(1, n + 2, dtype=np.float64) / (n + 2)
    vander = np.vander(ts, n + 1, increasing=True)
    return np.stack([np.linalg.solve(vander,
                                     bspline_basis(n, ts + n // 2 - j))
                     for j in range(n + 1)])


def half_width(degree):
    return degree // 2 + 1


# ---------------------------------------------------------------------------
# tables: prefilter, brace, gate, evaluation
# ---------------------------------------------------------------------------

def _index(a, idx, axis):
    return torch.index_select(a, axis, torch.as_tensor(
        np.asarray(idx), dtype=torch.long, device=a.device))


def extend(a, axis, lo, hi, bc):
    """``a`` extended by ``lo``/``hi`` samples along ``axis``."""
    n = a.shape[axis]
    i = np.arange(-lo, n + hi)
    if bc == PERIODIC:
        return _index(a, np.mod(i, n), axis)
    idx = np.mod(i, 2 * n)
    return _index(a, np.where(idx >= n, 2 * n - 1 - idx, idx), axis)


def fir(a, axis, degree, bc):
    """The spline prefilter along one axis: the inverse filter over the
    boundary-extended signal, summed in float64."""
    kernel = inverse_kernel(degree)
    if kernel.size == 1:
        return a
    half = kernel.size // 2
    ext = extend(a, axis, half, half, bc)
    n = a.shape[axis]
    out = torch.zeros_like(a)
    for k, h in enumerate(kernel):
        out += float(h) * ext.narrow(axis, k, n)
    return out


@dataclasses.dataclass
class Table:
    coeff: torch.Tensor        # (Hp, Wp, C) float64, braced
    pad: int
    degree: int
    bcs: tuple                 # (y, x)
    core: tuple                # (H, W)


def build_table(image, degree, prefilter, bcs, spherical):
    """Prefiltered, braced coefficients of an (H, W, C) float64 image.
    ``spherical``: a full 2:1 equirect, periodic across the seam and
    continued over the poles."""
    pad = max(half_width(degree), half_width(prefilter)) + 2
    h, w = image.shape[:2]
    if spherical:
        c = fir(image, 1, prefilter, PERIODIC)
        if prefilter > 1:
            stack = torch.cat([c[:, :w // 2],
                               torch.flip(c[:, w // 2:], dims=(0,))], 0)
            stack = fir(stack, 0, prefilter, PERIODIC)
            c = torch.cat([stack[:h], torch.flip(stack[h:], dims=(0,))], 1)
        rows = np.arange(-pad, h + pad)
        s = np.mod(rows, 2 * h)
        row_idx = np.where(s < h, s, 2 * h - 1 - s)
        over = torch.as_tensor(s >= h, device=c.device)[:, None, None]
        c = torch.where(over, _index(torch.roll(c, w // 2, dims=1),
                                     row_idx, 0), _index(c, row_idx, 0))
        c = extend(c, 1, pad, pad, PERIODIC)
        bcs = (REFLECT, PERIODIC)
    else:
        c = fir(fir(image, 0, prefilter, bcs[0]), 1, prefilter, bcs[1])
        c = extend(extend(c, 0, pad, pad, bcs[0]), 1, pad, pad, bcs[1])
    return Table(c.contiguous(), pad, degree, tuple(bcs), (h, w))


def gate(c, bc, n):
    """Map a coordinate into the defined range [-0.5, n - 0.5]:
    periodically, or by reflection."""
    if n == 1:
        return torch.zeros_like(c)
    lo, hi = -0.5, n - 0.5
    if bc == PERIODIC:
        return lo + torch.remainder(c - lo, hi - lo)
    period = 2.0 * (hi - lo)
    t = torch.remainder(c - lo, period)
    return lo + torch.minimum(t, period - t)


def _split(table, x, y):
    """Gated coordinates -> the window's first table row and column and
    the per-axis weights."""
    n = table.degree
    h, w = table.core
    x = gate(x, table.bcs[1], w)
    y = gate(y, table.bcs[0], h)
    if n % 2:
        sx, sy = torch.floor(x), torch.floor(y)
    else:
        sx, sy = torch.floor(x + 0.5), torch.floor(y + 0.5)
    m = weight_matrix(n)

    def weights(t):
        out = []
        for j in range(n + 1):
            acc = torch.full_like(t, float(m[j, n]))
            for k in range(n - 1, -1, -1):
                acc = acc * t + float(m[j, k])
            out.append(acc)
        return out
    bx = sx.to(torch.int64) + (table.pad - n // 2)
    by = sy.to(torch.int64) + (table.pad - n // 2)
    return bx, by, weights(x - sx), weights(y - sy)


def evaluate(table, x, y):
    """The spline at coordinates (x, y) in source pixels: (..., C)."""
    bx, by, wx, wy = _split(table, x, y)
    hp, wp, ch = table.coeff.shape
    flat = table.coeff.reshape(hp * wp, ch)
    out = 0.0
    for j, wyj in enumerate(wy):
        row = 0.0
        for k, wxk in enumerate(wx):
            idx = ((by + j) * wp + bx + k).clamp_(0, hp * wp - 1)
            row = row + wxk[..., None] * flat[idx]
        out = out + wyj[..., None] * row
    return out


def touch(table, x, y, touched):
    """Mark in ``touched`` ((Hp * Wp,) bool) the entries that the spline
    windows at (x, y) read."""
    bx, by, wx, _wy = _split(table, x, y)
    hp, wp, _ = table.coeff.shape
    for j in range(len(wx)):
        for k in range(len(wx)):
            touched[((by + j) * wp + bx + k).clamp_(0, hp * wp - 1)] = True


# ---------------------------------------------------------------------------
# twining spread (envutil_main.cc: make_spread, twine_setup)
# ---------------------------------------------------------------------------

def make_spread(w, h, d):
    """A w x h box of taps spanning one output pixel, width ``d``."""
    w = max(w, 2)
    h = w if h <= 0 else h
    x0, y0 = -(w - 1.0) / (2.0 * w), -(h - 1.0) / (2.0 * h)
    return [(d * (x0 + x / w), d * (y0 + y / h), 1.0 / (w * h))
            for y in range(h) for x in range(w)]


def twine_spread(twine, facet_steps, target_step, degree, twine_max=8):
    """The job's spread, or None: ``twine`` -1 chooses it from the
    magnification, as the CLI does; 0 renders untwined."""
    width = 1.0
    if twine == -1:
        mag = min(facet_steps) / target_step
        if mag > 1.0:
            if degree > 1:
                twine = 3 if len(facet_steps) > 1 else (2 if mag < 2.0
                                                        else 1)
            else:
                twine, width = min(5, int(1.0 + mag)), mag
        else:
            twine = min(twine_max, int(1.0 + 1.0 / mag))
    if twine <= 0:
        return None
    return make_spread(twine, twine, width)


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------

def planar_axis(n, lo, hi, bias, i0, i1):
    """Samples i0..i1 of an n-sample axis half a step inside [lo, hi],
    offset by ``bias`` sample steps."""
    ll = 2.0 * np.arange(i0, i1, dtype=np.float64) + 1.0
    return bias * (hi - lo) / n + ll * (hi / (2.0 * n)) \
        + (2.0 * n - ll) * (lo / (2.0 * n))


def in_face_to_ray(face, fx, fy):
    one = torch.ones_like(fx)
    dom = face // 2
    right, bottom, front = face == 1, face == 3, face == 4
    x = torch.where(dom == 0, torch.where(right, one, -one),
                    torch.where(dom == 1, -fx, torch.where(front, fx, -fx)))
    y = torch.where(dom == 0, fy, torch.where(
        dom == 1, torch.where(bottom, one, -one), fy))
    z = torch.where(dom == 0, torch.where(right, -fx, fx), torch.where(
        dom == 1, torch.where(bottom, fy, -fy),
        torch.where(front, one, -one)))
    return x, y, z


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Facet:
    projection: int
    width: int
    height: int
    extent: tuple
    recip_step: float
    basis: np.ndarray          # camera -> facet CS
    lens: tuple | None         # (a, b, c, unit radius)
    table: Table


@dataclasses.dataclass
class Job:
    projection: int
    width: int
    height: int
    extent: tuple
    spread: list | None
    channels: int


def facet_spec(spec):
    """(projection, hfov, extent, step, lens) of one configured facet;
    angles in the file are degrees, hfov here radians."""
    p = PROJECTIONS[spec["projection"]]
    hfov = spec["hfov"] * D2R
    ext = extent(p, spec["width"], spec["height"], hfov)
    abc = tuple(float(spec.get(k, 0.0)) for k in "abc")
    lens = None
    if any(abc):
        unit = min(abs(ext[1] - ext[0]), abs(ext[3] - ext[2])) / 2.0
        lens = abc + (unit,)
    return p, hfov, ext, step(p, spec["width"], hfov), lens


def make_job(config, traffic):
    """The target geometry and spread of a cell."""
    p = PROJECTIONS[traffic["projection"]]
    w, h = traffic["width"], traffic["height"]
    ext = extent(p, w, h, traffic["hfov"] * D2R)
    steps = [facet_spec(f)[3] for f in config["facets"]]
    spread = twine_spread(traffic.get("twine", -1), steps,
                          (ext[1] - ext[0]) / w, config["degree"])
    return Job(p, w, h, ext, spread, config["facets"][0]["channels"])


class Reference:
    """A cell's reference frame, block by block of output rows."""

    def __init__(self, config, traffic, images, device):
        self.job = make_job(config, traffic)
        self.device = torch.device(device)
        cam = rotation(*(traffic.get(k, 0.0) * D2R
                         for k in ("roll", "pitch", "yaw")))
        deg, pre = config["degree"], config.get("prefilter",
                                                 config["degree"])
        self.facets = []
        for spec, img in zip(config["facets"], images):
            p, hfov, ext, stp, lens = facet_spec(spec)
            full = p == SPHERICAL and abs(hfov - 2.0 * math.pi) < 1e-6 \
                and spec["width"] == 2 * spec["height"]
            periodic = p in (SPHERICAL, CYLINDRICAL) and \
                abs(hfov - 2.0 * math.pi) < 1e-6
            image = torch.as_tensor(np.asarray(img)).to(
                self.device, torch.float64)
            table = build_table(image, deg, pre, (REFLECT, PERIODIC if
                                                  periodic else REFLECT),
                                full)
            fr = rotation(*(spec.get(k, 0.0) * D2R
                            for k in ("roll", "pitch", "yaw")))
            self.facets.append(Facet(p, spec["width"], spec["height"], ext,
                                     1.0 / stp, fr.T @ cam, lens, table))
        n_taps = 1 if self.job.spread is None else len(self.job.spread)
        self.work = dict(
            pixels=0, taps=n_taps, facets=len(self.facets),
            live_taps=[0] * len(self.facets), degree=deg,
            channels=self.job.channels, target=traffic["projection"],
            sources=[s["projection"] for s in config["facets"]],
            lenses=[f.lens is not None for f in self.facets],
            entry_bytes=2 if config.get("coeff") == "bf16" else 4,
            touched=[torch.zeros(f.table.coeff.shape[0]
                                 * f.table.coeff.shape[1], dtype=torch.bool,
                                 device=self.device) for f in self.facets])

    # -- target rays ------------------------------------------------------

    def _target(self, y0, y1, bias):
        """Unit rays of rows y0..y1 in the camera CS, (rows, W) each."""
        j = self.job
        x0, x1, e0, e1 = j.extent
        dev = self.device

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)
        xs = t(planar_axis(j.width, x0, x1, bias[0], 0, j.width))[None, :]
        ys = t(planar_axis(j.height, e0, e1, bias[1], y0, y1))[:, None]
        shape = (y1 - y0, j.width)
        if j.projection == SPHERICAL:
            ray = (torch.sin(xs) * torch.cos(ys), torch.sin(ys).expand(shape),
                   torch.cos(xs) * torch.cos(ys))
        elif j.projection == RECTILINEAR:
            ray = (xs.expand(shape), ys.expand(shape),
                   torch.ones(shape, dtype=torch.float64, device=dev))
        elif j.projection == CUBEMAP:
            section = x1 - x0
            rows = torch.arange(y0, y1, device=dev)[:, None].expand(shape)
            face = torch.div(rows, j.width, rounding_mode="floor")
            p1 = ys + (3.0 - face.to(torch.float64)) * section - section / 2
            ray = in_face_to_ray(face, xs.expand(shape), p1)
        else:
            raise ValueError(f"no reference target {j.projection}")
        n = torch.sqrt(ray[0] ** 2 + ray[1] ** 2 + ray[2] ** 2)
        return tuple(c / n for c in ray)

    @staticmethod
    def _rotate(m, ray):
        return tuple(float(m[i][0]) * ray[0] + float(m[i][1]) * ray[1]
                     + float(m[i][2]) * ray[2] for i in range(3))

    # -- one facet at one tap ---------------------------------------------

    def _pickup(self, f, ray):
        """(sx, sy, valid, near) of rays in the facet's CS: source pixel
        coordinates, whether the facet covers them, and whether that
        decision is within EDGE_PX of going the other way."""
        x, y, z = ray
        if f.projection == SPHERICAL:
            px = torch.atan2(x, z)
            py = torch.atan2(y, torch.sqrt(x * x + z * z))
        elif f.projection == RECTILINEAR:
            px, py = x / z, y / z
        else:
            raise ValueError(f"no reference source {f.projection}")
        if f.lens is not None:
            a, b, c, unit = f.lens
            r = torch.sqrt(px * px + py * py) / unit
            k = ((a * r + b) * r + c) * r + (1.0 - (a + b + c))
            px, py = px * k, py * k
        x0, x1, y0, y1 = f.extent
        kx, ky = f.width / (x1 - x0), f.height / (y1 - y0)
        margin = torch.minimum(torch.minimum(px - x0, x1 - px) * kx,
                               torch.minimum(py - y0, y1 - py) * ky)
        valid = margin >= 0.0
        near = margin.abs() < EDGE_PX
        if f.projection == RECTILINEAR:
            valid = valid & (z > 0.0)
            near = near & (z > 0.0)
        if f.projection == SPHERICAL and abs(x1 - x0 - 2 * math.pi) < 1e-9:
            valid = torch.ones_like(valid)
            near = torch.zeros_like(near)
        sx = (px - x0) * kx - 0.5
        sy = (py - y0) * ky - 0.5
        return sx, sy, valid, near

    # -- rows of the frame ------------------------------------------------

    def rows(self, y0, y1):
        """(value, slack, ambiguous) of output rows y0..y1; ``work``
        counts the taps they need."""
        j = self.job
        taps = [(0.0, 0.0, 1.0)] if j.spread is None else j.spread
        if j.spread is None:
            centre = self._target(y0, y1, (0.0, 0.0))
            packs = [(self._rotate(f.basis, centre), None, None)
                     for f in self.facets]
        else:
            grids = [self._target(y0, y1, b) for b in
                     ((0.0, 0.0), (DERIV_BIAS, 0.0), (0.0, DERIV_BIAS))]
            packs = []
            for f in self.facets:
                p0, p10, p01 = (self._rotate(f.basis, g) for g in grids)
                packs.append((p0, tuple(a - b for a, b in zip(p10, p0)),
                              tuple(a - b for a, b in zip(p01, p0))))
        shape = (y1 - y0, j.width)
        value = torch.zeros(shape + (j.channels,), dtype=torch.float64,
                            device=self.device)
        slack = torch.zeros_like(value)
        ambiguous = torch.zeros(shape, dtype=torch.bool, device=self.device)
        for cx, cy, w in taps:
            rays = []
            for p0, du, dv in packs:
                if du is None:
                    rays.append(p0)
                else:
                    sx_, sy_ = cx / DERIV_BIAS, cy / DERIV_BIAS
                    rays.append(tuple(a + sx_ * u + sy_ * v
                                      for a, u, v in zip(p0, du, dv)))
            v, s, amb = self._tap(rays)
            value += w * v
            slack += w * s
            ambiguous |= amb
        self.work["pixels"] += shape[0] * shape[1]
        return value, slack, ambiguous

    def _tap(self, rays):
        """One tap of every pixel: the synopsis of the facets (one facet:
        its lookup, misses 0; several: voronoi, the first best score
        wins), the slack of its near decisions and where they are."""
        picks = [self._pickup(f, r) for f, r in zip(self.facets, rays)]
        valid = torch.stack([p[2] for p in picks])
        near = torch.stack([p[3] for p in picks])
        nf = len(self.facets)
        fid = torch.arange(nf, device=self.device).view(
            -1, *[1] * (valid.dim() - 1))
        lowest = -math.inf
        raw = torch.stack([r[2] * f.recip_step
                           for f, r in zip(self.facets, rays)])
        if nf == 1:
            raw = torch.ones_like(raw)
        score = torch.where(valid, raw, lowest)
        best, champ = torch.max(score, dim=0)
        champ = torch.where(best > lowest, champ, -1)
        tol = TIE_REL * best.abs()
        # a facet that could win: tied with the champion, or out of its
        # window by less than EDGE_PX and at least as good
        cand = ((valid & (score >= best - tol) & (best > lowest))
                | (near & ~valid & ((raw >= best - tol) | (best == lowest)))
                ) & (fid != champ)
        # a champion within EDGE_PX of its edge may drop out: then the
        # runner-up wins, or no facet
        leaving = (near & (fid == champ)).any(0)
        second = torch.where(fid == champ, lowest, score).amax(0)
        cand |= leaving & (fid != champ) & valid & (
            score >= second - TIE_REL * second.abs())
        none_cand = leaving & (second == lowest)

        value = torch.zeros(valid.shape[1:] + (self.job.channels,),
                            dtype=torch.float64, device=self.device)
        slack = torch.zeros_like(value)
        vals = []
        for fi, (f, (sx, sy, _v, _n)) in enumerate(zip(self.facets, picks)):
            live = champ == fi
            need = live | cand[fi]
            v = torch.zeros_like(value)
            if bool(need.any()):
                v[need] = evaluate(f.table, sx[need], sy[need])
            if bool(live.any()):
                touch(f.table, sx[live], sy[live], self.work["touched"][fi])
                self.work["live_taps"][fi] += int(live.sum())
            value = torch.where(live[..., None], v, value)
            vals.append(v)
        for fi, v in enumerate(vals):
            slack = torch.where(cand[fi][..., None],
                                torch.maximum(slack, (v - value).abs()),
                                slack)
        slack = torch.where(none_cand[..., None],
                            torch.maximum(slack, value.abs()), slack)
        return value, slack, cand.any(0) | none_cand
