"""The twined kernels' plain versions (K4 inline twined, K3/K6 planar
twined) against the JAX kernels in interpret mode, the twined wrappers'
contract, and (on a card) the kernels against their plain versions.
The helpers and the bounds are test_torch_twining's.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_golden_oracle import synthetic_equirect
from test_torch_render import port_args, port_facet

from envutil_tpu.ops import pallas_resample as PR
from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import build_plan

from test_torch_twining import (
    BOX2, BOX3, INLINE_KERNEL_TOL, PLANAR_KERNEL_TOL, _cuda_or_skip,
    _jax_planes, _port_twined, _t, _twined_args, _warp, env, noise_mount,
)


def test_inline_twined_plain_matches_jax_kernel(noise_mount):
    """``resample_inline_twined`` on the CPU (its plain version) against
    the JAX ``resample_inline_twined_into`` in interpret mode, one tile of
    the JAX planner's first pass."""
    jplan, jsrc = noise_mount["jplan"], noise_mount["jsrc"]
    window = (0, 128, 0, 256)
    spread = SYN.scaled_spread(jplan.spread)
    passes, assigned = JFP.plan_passes(jplan, jsrc, window,
                                       JFP.DEFAULT_CLASSES, spread=spread)
    assert (assigned >= 0).all()
    name, wc, _box, tiles, merge = passes[0]
    assert JFP._inline_eligible(jplan, jsrc, 0, name, spread, merge) == "sph"
    assert name == "orig", "the tile reads the source itself"
    tiles = np.asarray(tiles)[:1]
    spl = jsrc.spl
    stt = jsrc.static
    statics = (stt.total_extent.x0, stt.total_extent.x1, stt.total_extent.y0,
               stt.total_extent.y1, stt.total_width, stt.total_height,
               stt.window_x_offset, stt.window_y_offset)
    tmode, xfeat, yfeat, P, consts = JFP._inline_setup(
        JFP._geom_static(jplan), window, name, spl.core_shape, spl.pad,
        tuple(spl.bcs), statics, twined=True)
    bm = np.einsum("ij,fjk->fik", np.asarray(jplan.bases[0], np.float32),
                   P).reshape(-1, 9)
    coeffp = jnp.moveaxis(spl.coeff, -1, 0)
    want = PR.resample_inline_twined_into(
        jnp.zeros((3, 128, 256), jnp.float32), coeffp, jnp.asarray(tiles),
        jnp.zeros(1, jnp.int32), jnp.asarray(xfeat), jnp.asarray(yfeat),
        jnp.asarray(bm), jnp.asarray(np.asarray(spread, np.float32).ravel()),
        jnp.float32(0), degree=1, n_taps=4, tmode=tmode, consts=consts,
        wc=wc, interpret=True)
    want = np.moveaxis(np.asarray(want), 0, -1)

    tplan, tsrc = noise_mount["tplan"], noise_mount["tsrc"]
    ops = FP.frame_operands(tplan, tsrc)
    # both packages build the same doubled feature sets and constants
    np.testing.assert_array_equal(ops["xfeat"].numpy(), xfeat[:, 0, :])
    np.testing.assert_array_equal(ops["yfeat"].numpy(), yfeat[:, :, 0])
    assert ops["consts"] == consts and ops["tmode"] == tmode
    assert ops["n_taps"] == 4 and ops["precise"] is False
    np.testing.assert_allclose(ops["spread"].numpy(), np.asarray(spread))
    got = FP.fused_frame(tplan, tsrc, device="cpu").numpy()
    r, c = int(tiles[0, 2]) * PR.TILE_H, int(tiles[0, 3]) * PR.TILE_W
    sl = np.s_[r:r + PR.TILE_H, c:c + PR.TILE_W]
    np.testing.assert_allclose(got[sl], want[sl], rtol=0,
                               atol=INLINE_KERNEL_TOL)


def test_twined_plain_matches_jax_merge_kernel():
    """K3 with a merge mask against the JAX
    ``resample_twined_into(..., merge_mask=...)``: kept pixels bit for
    bit, the others to the kernel tolerance."""
    f = _warp()
    mask = (f["rng"].uniform(size=(128, 128)) < 0.6).astype(np.float32)
    prior = f["rng"].uniform(2, 3, (3, 128, 128)).astype(np.float32)
    want = PR.resample_twined_into(
        jnp.asarray(prior), f["coeffp"], *_jax_planes(f),
        jnp.asarray(f["tiles"]), jnp.asarray(f["spread"].ravel()),
        degree=3, n_taps=4, wc=PR.ALIGNED, interpret=True,
        merge_mask=jnp.asarray(mask))
    want = np.moveaxis(np.asarray(want), 0, -1)
    out = _t(np.moveaxis(prior, 0, -1))
    got = _port_twined(f, out, merge_mask=_t(mask))
    assert got is out
    keep = mask <= 0.5
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    np.testing.assert_allclose(got.numpy()[~keep], want[~keep], rtol=0,
                               atol=PLANAR_KERNEL_TOL)


def test_twined_plain_matches_jax_champion_kernel():
    """K3 with per-pixel tap weights against the JAX kernel's
    champion-routed form: ``tap_weights = (champ == fi)``, for both
    facet ids of a seam-like champion field; 0 where no tap is the
    facet's."""
    f = _warp()
    ii, jj = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    champ = np.zeros((4, 128, 128), np.int32)
    for k in range(4):
        champ[k] = np.where(jj < 50 + 0.4 * ii + 7 * k, 0, 1)
        champ[k][(ii > 100 + 5 * k) & (jj > 100)] = -1
    for fi in (0, 1):
        flat = np.concatenate([f["spread"].ravel(),
                               np.asarray([fi], np.float32)])
        want = PR.resample_twined_into(
            jnp.zeros((3, 128, 128), jnp.float32), f["coeffp"],
            *_jax_planes(f), jnp.asarray(f["tiles"]), jnp.asarray(flat),
            degree=3, n_taps=4, wc=PR.ALIGNED, interpret=True,
            champ=jnp.asarray(champ))
        want = np.moveaxis(np.asarray(want), 0, -1)
        weights = torch.from_numpy(champ == fi)
        for tw in (weights, weights.to(torch.uint8),
                   weights.to(torch.float32)):
            got = _port_twined(f, torch.full((128, 128, 3), float("nan")),
                               tap_weights=tw).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=PLANAR_KERNEL_TOL)
        none = ~(champ == fi).any(axis=0)
        assert none.any() and not got[none].any()


def test_twined_plain_matches_jax_whole_frame_kernel():
    """K6: the plain version without a mask against the JAX
    ``resample_twined`` over the whole frame."""
    f = _warp()
    want = PR.resample_twined(
        f["coeffp"], *_jax_planes(f), jnp.asarray(f["origins"]),
        jnp.asarray(f["spread"].ravel()), degree=3, n_taps=4, cmax_x=0.5,
        cmax_y=0.5, wc=PR.ALIGNED, interpret=True)
    want = np.moveaxis(np.asarray(want), 0, -1)
    got = _port_twined(f, torch.full((128, 128, 3), float("nan"))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANAR_KERNEL_TOL)


def test_twined_contract_nonfinite_wrap_and_checks():
    """The wrapper's contract: NaN/inf planes stay harmless (clamped
    without a mask, untouched under one, unread under zero weights); a
    deflected x is wrapped by ``wrap_x``; bad operands raise; a bfloat16
    table renders what the float32 table it upcasts to renders."""
    rng = np.random.default_rng(12)
    table = _t(rng.uniform(-1, 1, (40, 72, 2)))
    h, w = 16, 24
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)
    planes = [rng.uniform(8, 60, (h, w)), rng.uniform(8, 30, (h, w))] + \
        [rng.uniform(-0.5, 0.5, (h, w)) for _ in range(4)]
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    dirty = []
    for a in planes:
        a = a.astype(np.float32)
        a[mask <= 0.5] = bad[rng.integers(0, 3, int((mask <= 0.5).sum()))]
        dirty.append(_t(a))
    spread = _t(SYN.scaled_spread(BOX2))
    kw = dict(degree=3, n_taps=4)
    full = R.resample_twined(torch.empty(h, w, 2), table, *dirty, spread,
                             **kw)
    assert bool(torch.isfinite(full).all())
    nan = torch.full((h, w, 2), float("nan"))
    kept = R.resample_twined(nan.clone(), table, *dirty, spread,
                             merge_mask=_t(mask), **kw)
    on = torch.from_numpy(mask > 0.5)
    assert bool(kept[~on].isnan().all())
    torch.testing.assert_close(kept[on], full[on], rtol=0, atol=0)
    live = torch.from_numpy(rng.uniform(size=(4, h, w)) < 0.6) & on
    weighted = R.resample_twined(nan.clone(), table, *dirty, spread,
                                 tap_weights=live, **kw)
    assert bool(torch.isfinite(weighted).all())
    assert not bool(weighted[~live.any(dim=0)].any())

    # periodic wrap: shifting the centre by one period changes nothing
    clean = [_t(a) for a in planes]
    period = (4.5, 60.0)
    a = R.resample_twined(torch.empty(h, w, 2), table, *clean, spread,
                          wrap_x=period, **kw)
    shifted = [clean[0] + 60.0] + clean[1:]
    b = R.resample_twined(torch.empty(h, w, 2), table, *shifted, spread,
                          wrap_x=period, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=2e-5)

    with pytest.raises(ValueError, match="exclude each other"):
        R.resample_twined(nan, table, *clean, spread, merge_mask=_t(mask),
                          tap_weights=live, **kw)
    with pytest.raises(ValueError, match="triplets"):
        R.resample_twined(nan, table, *clean, spread[:3], **kw)
    half = table.to(torch.bfloat16)
    torch.testing.assert_close(
        R.resample_twined(nan.clone(), half, *clean, spread, **kw),
        R.resample_twined(nan.clone(), half.float(), *clean, spread, **kw),
        rtol=0, atol=0)


@pytest.mark.cuda
def test_inline_twined_kernel_matches_plain_on_card():
    """The inline twined kernel against its plain version on the card
    (needs a CUDA card and nvcc): a full sphere to a pitched spherical
    target, degrees 1 and 3, with and without --twine_precise."""
    _cuda_or_skip()
    env = synthetic_equirect()
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    for degree in (1, 3):
        src = TE.make_mount_source(tf, env, degree, degree, device="cuda")
        for precise in (False, True):
            plan = build_plan(_twined_args(
                port_args, TP.SPHERICAL, 96, 48, 360.0, [tf], degree, 170.0,
                80.0, 0.0, spread=BOX3, precise=precise), [tf])
            ops = FP.frame_operands(plan, src)
            tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats",
                                            "spread")]
            before = R.resample_inline_twined.launches
            k = R.resample_inline_twined(
                torch.empty(48, 96, 3, device="cuda"), src.spl.coeff,
                *tensors, **ops)
            p = R.resample_inline_twined_plain(
                torch.empty(48, 96, 3, device="cuda"), src.spl.coeff,
                *tensors, **ops)
            torch.cuda.synchronize()
            assert R.resample_inline_twined.launches == before + 1
            assert float((k - p).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_twined_kernel_matches_plain_on_card():
    """The planar twined kernel against its plain version on the card
    (needs a CUDA card and nvcc): no mask, merge mask, tap weights."""
    _cuda_or_skip()
    f = _warp()
    rng = np.random.default_rng(14)
    mask = torch.from_numpy((rng.uniform(size=(128, 128)) < 0.5).astype(
        np.float32)).cuda()
    live = torch.from_numpy(rng.uniform(size=(4, 128, 128)) < 0.6).cuda()
    args = [_t(f["spl"].coeff).cuda()] + [_t(a).cuda() for a in f["planes"]] \
        + [_t(f["spread"]).cuda()]
    for extra in ({}, dict(merge_mask=mask),
                  dict(tap_weights=live.to(torch.uint8))):
        nan = torch.full((128, 128, 3), float("nan"), device="cuda")
        before = R.resample_twined.launches
        k = R.resample_twined(nan.clone(), *args, degree=3, n_taps=4, **extra)
        p = R.resample_twined_plain(nan.clone(), *args, degree=3, n_taps=4,
                                    **extra)
        torch.cuda.synchronize()
        assert R.resample_twined.launches == before + 1
        assert torch.equal(k.isnan(), p.isnan())
        assert float((k - p).nan_to_num().abs().max()) <= 1e-5
