"""Multi-device rendering: the output raster's rows over a list of devices.

PyTorch counterpart of envutil_tpu/parallel/mesh.py. The reference's
only scale-out axes are SIMD lanes and a thread pool over output
segments; the JAX package rides that zero-communication decomposition
on a device mesh: each device renders a horizontal band of the target
from replicated, read-only facet tables. The port does the same from
one process: a ``Mesh`` is an ordered list of devices, band k of the
frame is rendered on the k-th, and one process drives them all, as the
JAX package's single controller drives its list of devices. A device may
appear more than once (several bands on one card, as the JAX tests run
eight virtual CPU devices), so every band decomposition runs on a
one-card machine too.

``sharded_render`` is the one band loop: on the card each band takes
the frame's own kernel route (``runtime/fastpath.render_fast_mesh``);
by default it takes the exact path, the route of the CPU and of jobs
no kernel takes, as the JAX package falls back to its XLA sharded
render.

For sources too large to replicate, ``ring_spline_eval`` splits the
coefficient table itself into row bands over the same devices and
passes the bands round a ring, each device accumulating the partial
tensor-product sums of the band it holds: the reference's out-of-core
tile store promoted to the devices. A ring step's hand-over (the JAX
package's ``ppermute``) is one copy of a band to the next device,
``non_blocking``; a device holds two bands instead of the whole table.
The ring's evaluation is PyTorch tensor operations on the devices, as
the JAX package's is XLA gathers outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import List, Optional, Sequence

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..models import environment as E
from ..models import stepper as ST
from ..models import synopsis as SYN
from ..ops import spline as S
from ..runtime.platform import resolve_device
from ..runtime.render import RenderPlan, render_exact


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices over the output rows; repeats
    allowed. Band k of a frame belongs to ``devices[k]``."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def _normal(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def available_devices(device, n: int) -> List[torch.device]:
    """The devices a ``--mesh n`` frame may use on ``device``'s type:
    every CUDA card, or ``n`` CPU slots (one device, repeated) when the
    render runs on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * n
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA card)."""
    if devices is None:
        devices = available_devices(None, 0)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    devices = tuple(_normal(d) for d in devices)
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"one device type per mesh, not {devices}")
    return Mesh(devices)


def band_windows(window, n: int):
    """``window`` (y0, y1, x0, x1) cut into ``n`` bands of equal rows."""
    rows = (window[1] - window[0]) // n
    return [(window[0] + k * rows, window[0] + (k + 1) * rows, window[2],
             window[3]) for k in range(n)]


# per plan, its band plans by band windows: one job hands the same band
# plans to the fast path from frame to frame, so that each keeps its
# kernel operands (runtime/fastpath keeps them per plan object)
_BANDS = weakref.WeakKeyDictionary()


def band_plans(plan: RenderPlan, n: int) -> tuple:
    """The plan with its window (``plan.crop``) cut to each of ``n``
    bands of rows; the output height must divide by ``n``."""
    from ..runtime.fastpath import frame_window
    window = frame_window(plan)
    height = window[1] - window[0]
    if height % n:
        raise ValueError(f"output height {height} must divide the mesh "
                         f"axis {n}")
    windows = tuple(band_windows(window, n))
    per_plan = _BANDS.setdefault(plan, {})
    if windows not in per_plan:
        per_plan[windows] = tuple(dataclasses.replace(plan, crop=w)
                                  for w in windows)
    return per_plan[windows]


# per table, its spline's copies by device (the tables are read-only);
# only the spline: facets that share a table (one file read by several
# facets) differ in their static part
_REPLICAS = WeakIdKeyDictionary()


def _replica(src: E.FacetSource, device: torch.device) -> E.FacetSource:
    """``src`` with its table on ``device``, copied once per device."""
    if src.spl is None or src.spl.coeff.device == device:
        return src
    copies = _REPLICAS.setdefault(src.spl.coeff, {})
    if device not in copies:
        copies[device] = dataclasses.replace(
            src.spl, coeff=src.spl.coeff.to(device))
    return dataclasses.replace(src, spl=copies[device])


def replicate_sources(sources: List[E.FacetSource], mesh: Mesh
                      ) -> List[List[E.FacetSource]]:
    """Per mesh slot the sources with their tables on the slot's device:
    one copy of each table per distinct device, none where the table
    lives already."""
    return [[_replica(src, dev) for src in sources] for dev in mesh.devices]


def gather_bands(bands) -> torch.Tensor:
    """The bands of a frame, each on its device and all enqueued, copied
    in order into one host tensor (no concatenation after the copies)."""
    rows = sum(b.shape[0] for b in bands)
    out = torch.empty((rows,) + tuple(bands[0].shape[1:]),
                      dtype=bands[0].dtype)
    y = 0
    for band in bands:
        out[y:y + band.shape[0]].copy_(band)
        y += band.shape[0]
    return out


def _exact_band(plan: RenderPlan, sources, device) -> torch.Tensor:
    return render_exact(plan, sources, device=device)


def sharded_render(plan: RenderPlan, sources: List[E.FacetSource],
                   mesh: Mesh, render_band=_exact_band,
                   verbose: bool = False,
                   split: Optional[list] = None) -> torch.Tensor:
    """The frame's output rows in ``mesh.size`` bands (``band_plans``),
    band k rendered on the mesh's k-th device from that device's copy of
    the tables (``replicate_sources``) by ``render_band(band_plan,
    sources, device)``: by default the exact path
    (``render.render_exact``), the route of the CPU and of the jobs no
    kernel takes; on the card ``fastpath.render_fast_mesh`` passes each
    band's kernel route. Every band is enqueued before any is copied
    back into its rows of the host (H, W, C) tensor (``gather_bands``).

    A list ``split`` receives the host-clock ms to enqueue every band,
    to wait for the devices and to copy the bands to the host; the wait
    is made only then (a measurement hook)."""
    start = time.perf_counter()
    outs = []
    for k, (bplan, srcs, dev) in enumerate(zip(
            band_plans(plan, mesh.size), replicate_sources(sources, mesh),
            mesh.devices)):
        if verbose:
            print(f"--mesh {mesh.size}: band {k} (rows {bplan.crop[0]}.."
                  f"{bplan.crop[1]}) on {dev}")
        outs.append(render_band(bplan, srcs, dev))
    if split is not None:
        enqueued = time.perf_counter()
        for dev in set(mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        done = time.perf_counter()
    img = gather_bands(outs)
    if split is not None:
        split.extend([(enqueued - start) * 1e3, (done - enqueued) * 1e3,
                      (time.perf_counter() - done) * 1e3])
    return img


# ---------------------------------------------------------------------------
# facet-sharded evaluation: coefficient row bands passed round a ring
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedSpline:
    """A spline's braced table in row bands, band d on the mesh's d-th
    device (``shard_spline_rows``); evaluable only through
    ``ring_spline_eval``. ``rows`` is the table's own row count, before
    the pad to N equal bands."""
    bands: tuple
    rows: int
    pad: int
    degree: int
    bcs: tuple
    core_shape: tuple


def shard_spline_rows(spl: S.Spline2D, mesh: Mesh) -> ShardedSpline:
    """Split a spline's table into ``mesh.size`` row bands, band d on
    the d-th device, the rows padded to a multiple of the mesh size
    (the pad rows are never addressed: row indices are clamped to the
    real table)."""
    n = mesh.size
    hp, wp, ch = spl.coeff.shape
    b = -(-hp // n)
    coeff = spl.coeff
    if b * n != hp:
        coeff = torch.cat([coeff, coeff.new_zeros((b * n - hp, wp, ch))])
    bands = tuple(band.to(dev) for band, dev in
                  zip(torch.split(coeff, b), mesh.devices))
    return ShardedSpline(bands=bands, rows=hp, pad=spl.pad,
                         degree=spl.degree, bcs=tuple(spl.bcs),
                         core_shape=tuple(spl.core_shape))


def _ring_bands(spl: ShardedSpline, xs, ys, mesh: Mesh,
                apply_gate: bool = True):
    """``ring_spline_eval`` on coordinates already split by slot: ``xs``
    and ``ys`` hold slot d's coordinates on its device; returns slot d's
    values (..., C) on its device, float32."""
    n = spl.degree
    h, w = spl.core_shape
    nd = mesh.size
    band_h, wp, ch = spl.bands[0].shape
    real_h = spl.rows
    off = spl.pad - n // 2
    slots = []
    for x, y in zip(xs, ys):
        if apply_gate:
            x = S.gate(x, spl.bcs[1], w)
            y = S.gate(y, spl.bcs[0], h)
        sx, tx = S.split(x, n)
        sy, ty = S.split(y, n)
        # the integer pad shift after the split, as eval_spline's
        slots.append(dict(wx=S._weights(tx, n), wy=S._weights(ty, n),
                          by=torch.clamp(sy + off, 0, real_h - 1 - n),
                          bx=torch.clamp(sx + off, 0, wp - 1 - n),
                          accs=[torch.zeros(x.shape + (ch,),
                                            dtype=torch.float32,
                                            device=x.device)
                                for _ in range(n + 1)]))
    held = list(spl.bands)
    for s in range(nd):
        for d, slot in enumerate(slots):
            row0 = ((d + s) % nd) * band_h
            flat = held[d].reshape(band_h * wp, ch)
            for j in range(n + 1):
                row = torch.clamp(slot["by"] + j, max=real_h - 1)
                mine = (row >= row0) & (row < row0 + band_h)
                local = torch.clamp(row - row0, 0, band_h - 1) * wp
                racc = None
                for k in range(n + 1):
                    idx = local + torch.clamp(slot["bx"] + k, max=wp - 1)
                    tap = flat[idx.reshape(-1)].reshape(idx.shape + (ch,))
                    if tap.dtype != torch.float32:
                        tap = tap.to(torch.float32)
                    term = slot["wx"][k][..., None] * tap
                    racc = term if racc is None else racc + term
                wj = torch.where(mine, slot["wy"][j], 0.0)
                slot["accs"][j] = slot["accs"][j] + wj[..., None] * racc
        if s + 1 < nd:
            # the hand-over: slot i passes its band to slot i - 1
            held = [held[(i + 1) % nd].to(mesh.devices[i],
                                          non_blocking=True)
                    for i in range(nd)]
    outs = []
    for slot in slots:
        out = slot["accs"][0]
        for acc in slot["accs"][1:]:
            out = out + acc
        outs.append(out)
    return outs


def ring_spline_eval(spl: ShardedSpline, x, y, mesh: Mesh,
                     apply_gate: bool = True) -> torch.Tensor:
    """Exact gated b-spline evaluation from a row-banded table
    (``shard_spline_rows``), the coordinates' (H, W) rows split over the
    same devices (H must divide by the mesh size).

    N ring steps: at step s slot d holds band ``(d + s) % N``,
    accumulates the partial tensor-product sums of the vertical taps
    whose table rows lie in that band, and hands the band to slot d - 1.
    A tap whose support straddles a band boundary is completed when the
    neighbouring band arrives, so no halo is copied. Each vertical tap j
    is accumulated into its own slot (a tap's row lies in one band; the
    other steps add exact zeros) and the slots are summed in ascending j
    after the loop: the taps, weights and summation order of
    ``spline.eval_spline``. Returns the (H, W, C) float32 values on
    ``x``'s device."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} coordinate rows must divide the "
                         f"mesh axis {mesh.size}")
    xs = [b.to(d) for b, d in zip(torch.chunk(x, mesh.size), mesh.devices)]
    ys = [b.to(d) for b, d in zip(torch.chunk(y, mesh.size), mesh.devices)]
    outs = _ring_bands(spl, xs, ys, mesh, apply_gate)
    return torch.cat([o.to(x.device) for o in outs])


# ---------------------------------------------------------------------------
# --shard_table: whole frames from ring-sharded coefficient tables
# ---------------------------------------------------------------------------

# per table, its row bands by mesh devices
_SHARDS = WeakIdKeyDictionary()


def shard_sources(sources: List[E.FacetSource], mesh: Mesh
                  ) -> List[E.FacetSource]:
    """Every facet's table in row bands over the mesh
    (``shard_spline_rows``, made once per table and mesh); paint sources
    pass through unchanged."""
    out = []
    for src in sources:
        if src.spl is None:
            out.append(src)
            continue
        shards = _SHARDS.setdefault(src.spl.coeff, {})
        if mesh.devices not in shards:
            shards[mesh.devices] = shard_spline_rows(src.spl, mesh)
        out.append(E.FacetSource(static=src.static,
                                 spl=shards[mesh.devices]))
    return out


def shard_table_eligible(plan: RenderPlan,
                         sources: List[E.FacetSource]) -> bool:
    """--shard_table serves untwined plain-lookup jobs (the case it is
    for is a huge environment source; masking and paint jobs keep the
    replicated path)."""
    if plan.spread is not None:
        return False
    return all(src.spl is not None and src.static.masked == -1
               for src in sources)


def _lookup_ring(src, rays, mesh: Mesh, nch: int):
    """``environment.lookup`` with the spline evaluated through the ring,
    for slot d's rays ``rays[d]``: per slot (px, mask)."""
    st = src.static
    coords = [E.source_spline_coords(src, ray) for ray in rays]
    pxs = _ring_bands(src.spl, [c[0] for c in coords],
                      [c[1] for c in coords], mesh,
                      apply_gate=st.kind != "cubemap")
    out = []
    for px, (_sx, _sy, mask) in zip(pxs, coords):
        if st.kind != "cubemap":
            px = torch.where(mask[..., None], px, 0.0)
        px = E.repix(px, nch)
        if st.brighten != 1.0:
            px = E.apply_brighten(px, st.brighten)
        out.append((px, mask))
    return out


def ring_sharded_render(plan: RenderPlan, sources: List[E.FacetSource],
                        mesh: Mesh) -> torch.Tensor:
    """The frame from ring-sharded tables (``shard_sources``), the output
    rows in bands over the same devices: the exact path of
    ``render._render_window`` (the same rays, lookup tail and synopses)
    with ``eval_spline`` replaced by the ring, which sums its taps in the
    same order. Returns the (H, W, C) frame gathered on the host."""
    if not shard_table_eligible(plan, sources):
        raise ValueError("--shard_table supports untwined plain-lookup jobs")
    nch = plan.nchannels
    windows = [bplan.crop for bplan in band_plans(plan, mesh.size)]
    # per facet, per slot: (px, mask) and the ray's z
    looked, zs = [], []
    for src, basis, p2r in zip(sources, plan.bases, plan.planar_to_ray):
        rays = [ST.target_rays(plan.projection, plan.width, plan.height,
                               plan.extent, basis=basis, normalize=True,
                               planar_to_ray=p2r, window=win, device=dev)
                for win, dev in zip(windows, mesh.devices)]
        looked.append(_lookup_ring(src, rays, mesh, nch))
        zs.append([ray[2] for ray in rays])
    outs = []
    for d in range(mesh.size):
        if len(sources) == 1:
            px, mask = looked[0][d]
            outs.append(torch.where(mask[..., None], px, 0.0))
        elif plan.synopsis == "hdr_merge":
            outs.append(SYN.hdr_merge_stack(
                [f[d][0] for f in looked],
                [s.static.brighten for s in sources], nch))
        else:
            px = torch.stack([f[d][0] for f in looked])
            mask = torch.stack([f[d][1] for f in looked])
            score = torch.stack([
                SYN.facet_score(z[d], f[d][1], s.static.recip_step)
                for f, z, s in zip(looked, zs, sources)])
            combine = SYN.voronoi_stack if nch in (1, 3) \
                else SYN.voronoi_plus_stack
            outs.append(combine(px, mask, score))
    return gather_bands(outs)
