"""Each kernel's plain version on a bf16 table against the JAX kernel in
interpret mode (K5/K6 on the table's float32 upcast: the JAX
whole-frame kernels take float32 only), and the staged window model at
bf16. The helpers and the bounds are test_torch_bf16's.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_golden_oracle import make_args, make_facet
from test_torch_planar import _jax_tile, _planes
from test_torch_render import port_args, port_facet
from test_torch_twining import _jax_planes, _warp, noise_mount
from test_torch_window import staged_eval

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.models import environment as JE
from envutil_tpu.ops import pallas_resample as PR
from envutil_tpu.runtime import fastpath as JFP
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import synopsis as SYN
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.ops import spline as S
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime.render import build_plan

from test_torch_bf16 import (
    INLINE_KERNEL_TOL, INLINE_TWINED_KERNEL_TOL, PLANAR_KERNEL_TOL,
    _bf16_pair, _to_bf16,
)


def test_inline_plain_matches_jax_kernel_at_bf16():
    """K1: ``resample_inline_plain`` on a bf16 table against the JAX
    ``resample_inline_into`` in interpret mode with the same bf16
    ``coeff``, one tile of a 128x768 cubemap view of a noise sphere."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (128, 256, 3)).astype(np.float32)
    jf = make_facet(JP.SPHERICAL, 256, 128, 2 * math.pi, yaw=math.radians(25))
    tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    tf.yaw = math.radians(25)
    tf.process_geometry()
    jsrc, tsrc = _bf16_pair(JE.make_mount_source(jf, img, 3, 3))
    jplan = jbuild_plan(make_args(JP.CUBEMAP, 128, 768, 90.0, [jf], degree=3),
                        [jf])
    tplan = build_plan(port_args(TP.CUBEMAP, 128, 768, 90.0, [tf], 3), [tf])
    window = (0, 768, 0, 128)
    passes, _assigned = JFP.plan_passes(jplan, jsrc, window,
                                        JFP.DEFAULT_CLASSES)
    name, wc, _box, tiles, merge = next(
        p for p in passes
        if JFP._inline_eligible(jplan, jsrc, 0, p[0], None, p[4]))
    tiles = np.asarray(tiles)[:1]
    st, spl = jsrc.static, jsrc.spl
    statics = (st.total_extent.x0, st.total_extent.x1, st.total_extent.y0,
               st.total_extent.y1, st.total_width, st.total_height,
               st.window_x_offset, st.window_y_offset)
    tmode, xfeat, yfeat, P, consts = JFP._inline_setup(
        JFP._geom_static(jplan), window, name, spl.core_shape, spl.pad,
        tuple(spl.bcs), statics)
    bm = np.einsum("ij,fjk->fik", np.asarray(jplan.bases[0], np.float32),
                   P).reshape(-1, 9)
    faces = np.clip(tiles[:, 2] * PR.TILE_H // 128, 0, 5).astype(np.int32)
    want = PR.resample_inline_into(
        jnp.zeros((3, 768, 128), jnp.float32), jnp.moveaxis(spl.coeff, -1, 0),
        jnp.asarray(tiles), jnp.asarray(faces), jnp.asarray(xfeat),
        jnp.asarray(yfeat), jnp.asarray(bm), jnp.float32(0), degree=3,
        tmode=tmode, consts=consts, wc=wc, interpret=True)
    want = np.moveaxis(np.asarray(want), 0, -1)
    ops = FP.frame_operands(tplan, tsrc)
    got = R.resample_inline(torch.empty(768, 128, 3), tsrc.spl.coeff,
                            *(ops.pop(k) for k in ("xfeat", "yfeat",
                                                   "bmats")), **ops).numpy()
    sl = np.s_[tiles[0, 2] * PR.TILE_H:(tiles[0, 2] + 1) * PR.TILE_H,
               tiles[0, 3] * PR.TILE_W:(tiles[0, 3] + 1) * PR.TILE_W]
    np.testing.assert_allclose(got[sl], want[sl], rtol=0,
                               atol=INLINE_KERNEL_TOL)


@pytest.mark.parametrize("kernel", ["K2", "K5"])
def test_planar_plain_matches_jax_kernels_at_bf16(kernel):
    """K2 (merge mask, degree 3; kept pixels bit for bit) and K5 (whole
    frame, degree 1): ``resample_planar_plain`` on a bf16 table against
    the JAX kernels in interpret mode with the same bf16 ``coeff`` (K5:
    its float32 upcast)."""
    degree = 3 if kernel == "K2" else 1
    spl, px, py, rng = _planes(degree)
    coeffp, origins = _jax_tile(spl, px, py, degree)
    jb, tb = _to_bf16(coeffp)
    table = tb.permute(1, 2, 0).contiguous()
    sx, sy = torch.from_numpy(px), torch.from_numpy(py)
    if kernel == "K5":
        want = PR.resample_planar(jb.astype(jnp.float32), jnp.asarray(px),
                                  jnp.asarray(py),
                                  jnp.asarray(origins), degree=degree,
                                  wc=PR.TIGHT, interpret=True)
        got = R.resample_planar(torch.full((128, 128, 3), float("nan")),
                                table, sx, sy, degree=degree).numpy()
        np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), 0, -1),
                                   rtol=0, atol=PLANAR_KERNEL_TOL)
        return
    tiles = np.array([[0, 0, 0, 0, origins[0, 0], origins[0, 1]]], np.int32)
    mask = (rng.uniform(size=px.shape) < 0.6).astype(np.float32)
    prior = rng.uniform(2, 3, (3,) + px.shape).astype(np.float32)
    want = PR.resample_planar_into(
        jnp.asarray(prior), jb, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(tiles), degree=degree, wc=PR.TIGHT, interpret=True,
        merge_mask=jnp.asarray(mask))
    want = np.moveaxis(np.asarray(want), 0, -1)
    got = R.resample_planar(torch.from_numpy(np.moveaxis(prior, 0, -1).copy()),
                            table, sx, sy, degree=degree,
                            merge_mask=torch.from_numpy(mask)).numpy()
    keep = mask <= 0.5
    np.testing.assert_array_equal(got[keep], want[keep])
    np.testing.assert_allclose(got[~keep], want[~keep], rtol=0,
                               atol=PLANAR_KERNEL_TOL)


def test_inline_twined_plain_matches_jax_kernel_at_bf16(noise_mount):
    """K4: ``resample_inline_twined_plain`` on a bf16 table against the
    JAX ``resample_inline_twined_into`` in interpret mode with the same
    bf16 ``coeff``, one tile, 2x2 taps."""
    jplan = noise_mount["jplan"]
    jsrc, tsrc = _bf16_pair(noise_mount["jsrc"])
    window = (0, 128, 0, 256)
    spread = SYN.scaled_spread(jplan.spread)
    passes, _assigned = JFP.plan_passes(jplan, jsrc, window,
                                        JFP.DEFAULT_CLASSES, spread=spread)
    name, wc, _box, tiles, _merge = passes[0]
    tiles = np.asarray(tiles)[:1]
    spl, st = jsrc.spl, jsrc.static
    statics = (st.total_extent.x0, st.total_extent.x1, st.total_extent.y0,
               st.total_extent.y1, st.total_width, st.total_height,
               st.window_x_offset, st.window_y_offset)
    tmode, xfeat, yfeat, P, consts = JFP._inline_setup(
        JFP._geom_static(jplan), window, name, spl.core_shape, spl.pad,
        tuple(spl.bcs), statics, twined=True)
    bm = np.einsum("ij,fjk->fik", np.asarray(jplan.bases[0], np.float32),
                   P).reshape(-1, 9)
    want = PR.resample_inline_twined_into(
        jnp.zeros((3, 128, 256), jnp.float32), jnp.moveaxis(spl.coeff, -1, 0),
        jnp.asarray(tiles), jnp.zeros(1, jnp.int32), jnp.asarray(xfeat),
        jnp.asarray(yfeat), jnp.asarray(bm),
        jnp.asarray(np.asarray(spread, np.float32).ravel()), jnp.float32(0),
        degree=1, n_taps=4, tmode=tmode, consts=consts, wc=wc,
        interpret=True)
    want = np.moveaxis(np.asarray(want), 0, -1)
    got = FP.fused_frame(noise_mount["tplan"], tsrc, device="cpu").numpy()
    r, c = int(tiles[0, 2]) * PR.TILE_H, int(tiles[0, 3]) * PR.TILE_W
    sl = np.s_[r:r + PR.TILE_H, c:c + PR.TILE_W]
    np.testing.assert_allclose(got[sl], want[sl], rtol=0,
                               atol=INLINE_TWINED_KERNEL_TOL)


@pytest.mark.parametrize("kernel", ["K3", "K6"])
def test_twined_plain_matches_jax_kernels_at_bf16(kernel):
    """K3 (merge mask; kept pixels bit for bit) and K6 (whole frame):
    ``resample_twined_plain`` on a bf16 table against the JAX kernels in
    interpret mode with the same bf16 ``coeff`` (K6: its float32
    upcast)."""
    f = _warp()
    jb, tb = _to_bf16(f["coeffp"])
    table = tb.permute(1, 2, 0).contiguous()
    planes = [torch.from_numpy(a) for a in f["planes"]]
    kw = dict(degree=3, n_taps=4)
    spread = torch.from_numpy(f["spread"])
    if kernel == "K6":
        want = PR.resample_twined(
            jb.astype(jnp.float32), *_jax_planes(f), jnp.asarray(f["origins"]),
            jnp.asarray(f["spread"].ravel()), cmax_x=0.5, cmax_y=0.5,
            wc=PR.ALIGNED, interpret=True, **kw)
        got = R.resample_twined(torch.full((128, 128, 3), float("nan")),
                                table, *planes, spread, **kw).numpy()
        np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), 0, -1),
                                   rtol=0, atol=PLANAR_KERNEL_TOL)
        return
    mask = (f["rng"].uniform(size=(128, 128)) < 0.6).astype(np.float32)
    prior = f["rng"].uniform(2, 3, (3, 128, 128)).astype(np.float32)
    want = PR.resample_twined_into(
        jnp.asarray(prior), jb, *_jax_planes(f), jnp.asarray(f["tiles"]),
        jnp.asarray(f["spread"].ravel()), wc=PR.ALIGNED, interpret=True,
        merge_mask=jnp.asarray(mask), **kw)
    want = np.moveaxis(np.asarray(want), 0, -1)
    got = R.resample_twined(torch.from_numpy(np.moveaxis(prior, 0, -1).copy()),
                            table, *planes, spread,
                            merge_mask=torch.from_numpy(mask), **kw).numpy()
    keep = mask <= 0.5
    np.testing.assert_array_equal(got[keep], want[keep])
    np.testing.assert_allclose(got[~keep], want[~keep], rtol=0,
                               atol=PLANAR_KERNEL_TOL)


def test_window_model_at_bf16():
    """The inline kernel's staged window at bf16: a window holds twice
    the entries, so at one budget every block that stages at float32
    stages at bf16 and more do; row segments start at the aligned-down
    element and are whole 16-byte units where the table's rows are;
    the pitch keeps 16 bytes over a multiple of 128; and an evaluation
    that reads nothing but the staged windows equals the plain version
    bit for bit."""
    rng = np.random.default_rng(11)
    fct = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    img = rng.uniform(0, 1, (128, 256, 3)).astype(np.float32)
    src = TE.make_mount_source(fct, img, 3, 3, device="cpu")
    plan = build_plan(port_args(TP.SPHERICAL, 128, 64, 360.0, [fct], 3,
                                160.0, -80.0, 10.0), [fct])
    ops = FP.frame_operands(plan, src)
    tensors = [ops.pop(k) for k in ("xfeat", "yfeat", "bmats")]
    ops.pop("degree")
    sx, sy = R.inline_coords(*tensors, **ops)
    coeff = src.spl.coeff.to(torch.bfloat16)
    kw = dict(degree=3, table_shape=tuple(coeff.shape), tile=R.TILE_INLINE)
    full = R.window_model(sx, sy, window_bytes=1 << 30, **kw)
    some = full["bytes"] > 0
    budget = int(full["bytes"][some].float().median()) // 16 * 16
    f32 = R.window_model(sx, sy, window_bytes=budget, **kw)
    b16 = R.window_model(sx, sy, window_bytes=budget, entry_bytes=2, **kw)
    assert bool((b16["staged"] | ~f32["staged"]).all())
    assert bool((b16["staged"] & ~f32["staged"]).any())
    assert not bool(b16["staged"].all())      # the pole and the seam
    assert (coeff.shape[1] * coeff.shape[2]) % 8 == 0
    assert bool((b16["f0"] % 8 == 0).all()) and \
        bool((b16["span"] % 8 == 0).all())
    assert bool((b16["pitch"] % 64 == 8).all())
    assert torch.equal(b16["bytes"][some],
                       ((b16["y1"] - b16["y0"] + 1) * b16["pitch"] * 2)[some])
    assert bool((b16["bytes"][b16["staged"]] <= budget).all())
    holds = R.window_holds(b16, sx, sy, **kw)
    plain = S.eval_spline(S.Spline2D(coeff=coeff, pad=0, degree=3,
                                     bcs=(S.CONSTANT, S.CONSTANT),
                                     core_shape=tuple(coeff.shape[:2])),
                          sx, sy, apply_gate=False)
    staged = staged_eval(coeff, b16, sx, sy, 3, R.TILE_INLINE)
    assert bool(holds.any())
    assert torch.equal(staged[holds], plain[holds])
    assert bool(staged[~holds].isnan().all())
