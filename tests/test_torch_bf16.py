"""bfloat16 coefficient tables (``--coeff bf16``), the on-disk coefficient
cache and the exact route for degrees above the kernels' range, in the
port on the CPU against the JAX package.

The JAX package rounds a float32 table to bfloat16 (``astype``) and its
bits cross into the port unchanged (``source_from_arrays``), so every
comparison below is of two evaluations of one bf16 table, not of two
roundings. Tolerances, each with its reason:

- renders against JAX ``render_frame``: 1e-5, as for float32 tables
  (both upcast each tap exactly; the JAX reference carries float64
  coordinates under the tests' x64 mode); the fast routes' plain
  versions against the port's exact path: 5e-5, as for float32.
- a bf16 frame against the float32 frame of the same job: at least
  40 dB, the JAX package's own bar for ``--coeff bf16``
  (tests/test_modes.py): bf16 keeps 8 bits of mantissa.
- the kernels' plain versions against the JAX kernels in interpret mode
  on a bf16 ``coeff``, one 128x128 tile a case: the float32 cases'
  bounds (the inline kernel 1e-3, the inline twined kernel 3e-3, the
  planar kernels 5e-5), since both sides upcast the same entries. The
  JAX whole-frame forms (``resample_planar``, ``resample_twined``: K5
  and K6) stage their window in a float32 scratch without the upcast
  of the other bodies and take float32 only, so they run on the bf16
  table's float32 upcast: the same values.
- the staged window at bf16 against the plain version, and the cache's
  round trips: bit for bit.
- the port's CLI against the JAX CLI at bf16: each package prefilters
  the image itself, float32 sums in another order (~1e-7 relative), so
  a coefficient may round to the neighbouring bf16 value in one package
  and not in the other: one bf16 ulp (2^-8 of coefficients below 1.2)
  times a tap's weight (at most (2/3)^2 at degree 3) moves a pixel by
  up to 2e-3. Such pixels are rare; all others agree within 1e-5.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle as O
from test_golden_oracle import (fw_render, make_args, make_facet,
                                synthetic_equirect)
from test_torch_render import port_args, port_facet, port_stripe
from test_torch_twining import _twined_args

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.models import cubemap as JCBM
from envutil_tpu.models import environment as JE
from envutil_tpu.ops import spline as JS
from envutil_tpu.runtime import coeff_cache as JCC
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.ops import spline as S
from envutil_tpu_torch.runtime import assets, cli
from envutil_tpu_torch.runtime import coeff_cache as TCC
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime import loader as LD
from envutil_tpu_torch.runtime.args import parse_args
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

JAX_TOL = 1e-5
FAST_TOL = 5e-5
BF16_DB = 40.0
INLINE_KERNEL_TOL = 1e-3
INLINE_TWINED_KERNEL_TOL = 3e-3
BF16_FLIP_TOL = 2e-3
PLANAR_KERNEL_TOL = 5e-5


def _bits(a):
    """The int16 bits of a bfloat16 numpy array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _to_bf16(a):
    """A JAX array rounded to bfloat16: (JAX array, the port's tensor of
    the same bits)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j).view(np.int16)).view(
        torch.bfloat16)


def _bf16_pair(jsrc):
    """(JAX source, port source) over the JAX table rounded to bf16."""
    spl = dataclasses.replace(jsrc.spl,
                              coeff=jsrc.spl.coeff.astype(jnp.bfloat16))
    j = dataclasses.replace(jsrc, spl=spl)
    t = TE.source_from_arrays(
        np.asarray(spl.coeff), dataclasses.asdict(jsrc.static), spl.pad,
        spl.degree, spl.bcs, spl.core_shape, spl.spherical, device="cpu")
    return j, t


def test_source_from_arrays_and_storage_keep_bits():
    """A bf16 table crosses into the port bit for bit, as its bfloat16
    array and as its 16-bit view, and ``storage_spline`` rounds a
    float32 table to the bits JAX's ``astype`` gives."""
    rng = np.random.default_rng(1)
    f32 = rng.normal(size=(12, 20, 3)).astype(np.float32) * 7
    f32[0, :4, 0] = [0.0, -0.0, 1e-40, 3.0e38]      # zeros, denormal, large
    jb, tb = _to_bf16(f32)
    static = dataclasses.asdict(JE.make_mount_source(
        make_facet(JP.SPHERICAL, 16, 8, 2 * math.pi),
        np.zeros((8, 16, 3), np.float32), 1, 1).static)
    for given in (np.asarray(jb), np.asarray(jb).view(np.uint16),
                  np.asarray(jb).view(np.int16)):
        src = TE.source_from_arrays(given, static, 2, 1, ("reflect",) * 2,
                                    (8, 16), False, device="cpu")
        assert src.spl.coeff.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(src.spl.coeff), _bits(jb))
    spl = S.Spline2D(coeff=torch.from_numpy(f32), pad=2, degree=1,
                     bcs=("reflect", "reflect"), core_shape=(8, 16))
    half = S.storage_spline(spl, "bf16")
    np.testing.assert_array_equal(_bits(half.coeff), _bits(tb))
    assert S.storage_spline(half, "bf16") is half
    assert S.storage_spline(spl, "f32") is spl


RENDERS = ["mount", "biatan6", "twined"]


@pytest.mark.parametrize("job", RENDERS)
def test_render_matches_jax_at_bf16(job):
    """The port's ``render_frame(device="cpu")`` against JAX
    ``render_frame`` on the same bf16 bits: a full-spherical mount to a
    rectilinear view (with its bf16 frame against the float32 frame),
    a biatan6 source to a stereographic view, and a twined mount; each
    fast route's plain version against the exact path at bf16."""
    env = synthetic_equirect()
    if job == "biatan6":
        stripe = port_stripe(TP.BIATAN6, env)
        jc = make_facet(JP.BIATAN6, 64, 384, math.pi / 2)
        jsrc = JCBM.make_cubemap_source(jc, stripe.reshape(6, 64, 64, 3), 3,
                                        3, support_min=8, tile_size=64)
        tc = port_facet(TP.BIATAN6, 64, 384, math.pi / 2)
        proj, w, h, hfov, ypr, degree = TP.STEREOGRAPHIC, 96, 64, 120.0, \
            (25.0, -15.0, 10.0), 3
        jargs = make_args(JP(int(proj)), w, h, hfov, [jc], degree=degree,
                          yaw=ypr[0], pitch=ypr[1], roll=ypr[2])
        targs = port_args(proj, w, h, hfov, [tc], degree, *ypr)
        tf = tc
    else:
        degree = 1 if job == "twined" else 3
        jf = make_facet(JP.SPHERICAL, 256, 128, 2 * math.pi)
        jsrc = JE.make_mount_source(jf, env, degree, degree)
        tf = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
        proj, w, h, hfov, ypr = TP.RECTILINEAR, 48, 32, 70.0, \
            (40.0, 25.0, 0.0)
        if job == "twined":
            spread = O.make_spread(2, 2, 1.0)
            jargs = _twined_args(make_args, JP(int(proj)), w, h, hfov, [jf],
                                 degree=1, yaw=ypr[0], pitch=ypr[1],
                                 spread=spread, precise=False)
            targs = _twined_args(port_args, proj, w, h, hfov, [tf], 1, *ypr,
                                 spread=spread, precise=False)
        else:
            jargs = make_args(JP(int(proj)), w, h, hfov, [jf], degree=3,
                              yaw=ypr[0], pitch=ypr[1], roll=ypr[2])
            targs = port_args(proj, w, h, hfov, [tf], 3, *ypr)
    jb, tb = _bf16_pair(jsrc)
    assert tb.spl.coeff.dtype == torch.bfloat16
    want = fw_render(jargs, [jb])
    plan = build_plan(targs, [tf])
    got = render_frame(plan, [tb], device="cpu")
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    route = FP.fused_frame if FP.inline_mode(plan, tb) else FP.planar_frame
    np.testing.assert_allclose(route(plan, tb, device="cpu").numpy(), got,
                               rtol=0, atol=FAST_TOL)
    if job == "mount":
        f32 = TE.source_from_arrays(
            np.asarray(jsrc.spl.coeff), dataclasses.asdict(jsrc.static),
            jsrc.spl.pad, 3, jsrc.spl.bcs, jsrc.spl.core_shape, True,
            device="cpu")
        ref = render_frame(plan, [f32], device="cpu")
        assert O.psnr(got, ref) >= BF16_DB


# ------------------------------------------- plain versions vs JAX kernels


# --------------------------------------------------------- the window model


# ------------------------------------------- the on-disk coefficient cache

def test_coeff_cache_round_trip_and_jax_entries(tmp_path):
    """``coeff_cache.store`` then ``load`` gives the table back bit for
    bit in its dtype (bf16 and float32), with its layout; an entry the
    JAX package's ``coeff_cache.store`` wrote reads as the same bits, the
    JAX package reads the port's, and a corrupt entry is a miss."""
    fct = types.SimpleNamespace(filename=str(tmp_path / "env.tif"),
                                asset_key="env.tif")
    (tmp_path / "env.tif").write_bytes(b"source")
    rng = np.random.default_rng(5)
    f32 = rng.normal(size=(20, 36, 3)).astype(np.float32)
    for dtype in ("bf16", "f32"):
        args = types.SimpleNamespace(coeff_cache=str(tmp_path / "c"),
                                     coeff_dtype=dtype, verbose=False)
        spl = S.storage_spline(S.Spline2D(
            coeff=torch.from_numpy(f32), pad=3, degree=3,
            bcs=("reflect", "periodic"), core_shape=(14, 30),
            spherical=True), dtype)
        key = ("env.tif", 3, 3, TP.SPHERICAL, -1, dtype, 0)
        assert TCC.load(args, fct, key, "cpu") is None
        TCC.store(args, fct, key, spl)
        back = TCC.load(args, fct, key, "cpu")
        assert back.coeff.dtype == spl.coeff.dtype
        assert torch.equal(back.coeff.view(torch.int16) if dtype == "bf16"
                           else back.coeff, spl.coeff.view(torch.int16)
                           if dtype == "bf16" else spl.coeff)
        assert (back.pad, back.degree, back.bcs, back.core_shape,
                back.spherical) == (3, 3, ("reflect", "periodic"), (14, 30),
                                    True)
        jback = JCC.load(args, fct, key)[0]
        assert jback.coeff.dtype == (jnp.bfloat16 if dtype == "bf16"
                                     else jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(jback.coeff).view(np.int16 if dtype == "bf16"
                                         else np.int32),
            back.coeff.view(torch.int16 if dtype == "bf16"
                            else torch.int32).numpy())

    args = types.SimpleNamespace(coeff_cache=str(tmp_path / "j"),
                                 coeff_dtype="bf16", verbose=False)
    jb, tb = _to_bf16(f32)
    key = ("env.tif", 1, 1, JP.SPHERICAL, -1, "bf16", 0)
    JCC.store(args, fct, key, JS.Spline2D(
        coeff=jb, pad=2, degree=1, bcs=("reflect", "periodic"),
        core_shape=(16, 32), spherical=True), {})
    got = TCC.load(args, fct, key, "cpu")
    assert got.coeff.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got.coeff), _bits(tb))
    assert (got.pad, got.degree, got.core_shape) == (2, 1, (16, 32))
    next((tmp_path / "j").glob("*.npz")).write_bytes(b"not an npz")
    assert TCC.load(args, fct, key, "cpu") is None


def test_loader_keys_on_coeff_dtype_and_restores_from_disk(tmp_path,
                                                           monkeypatch):
    """``load_source`` under ``--coeff bf16 --coeff_cache DIR``: a bf16
    table, stored on disk; after the RAM cache is cleared it comes back
    from disk without the image being read; a float32 job of the same
    facet is not handed the bf16 table, nor the reverse."""
    path = tmp_path / "env.tif"
    imgio.save_image(str(path), synthetic_equirect())
    base = ["--facet", str(path), "spherical", "360", "0", "0", "0",
            "--projection", "rectilinear", "--hfov", "70", "--width", "32",
            "--height", "24", "--degree", "3", "--twine", "0",
            "--output", str(tmp_path / "o.tif")]
    assets.cache.clear()
    args = parse_args(base + ["--coeff", "bf16", "--coeff_cache",
                              str(tmp_path / "c")])
    first = LD.load_source(args.facets[0], args, "cpu")
    assert first.spl.coeff.dtype == torch.bfloat16
    f32 = parse_args(base)
    other = LD.load_source(f32.facets[0], f32, "cpu")
    assert other.spl.coeff.dtype == torch.float32
    np.testing.assert_array_equal(
        _bits(first.spl.coeff), _bits(other.spl.coeff.to(torch.bfloat16)))
    assets.cache.clear()

    def unread(*_a):
        raise AssertionError("the image was read again")
    monkeypatch.setattr(LD, "_read_facet_image", unread)
    again = LD.load_source(args.facets[0], args, "cpu")
    assert again.spl.coeff.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(again.spl.coeff),
                                  _bits(first.spl.coeff))
    assert again.static == first.static
    assets.cache.clear()


def test_cli_bf16_job_matches_jax_cli(tmp_path, monkeypatch):
    """``--coeff bf16`` through the port's CLI and the JAX CLI, on the
    CPU, into float TIFFs: each package's own table (within one bf16
    ulp flip), then the port reading the JAX CLI's ``--coeff_cache``
    entry instead of the image (the same table: 1e-5)."""
    from envutil_tpu.runtime import assets as jassets
    from envutil_tpu.runtime import cli as jcli
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    src = tmp_path / "env.tif"
    imgio.save_image(str(src), synthetic_equirect())
    argv = ["--facet", str(src), "spherical", "360", "20", "0", "0",
            "--projection", "cubemap", "--width", "32", "--degree", "3",
            "--twine", "0", "--coeff", "bf16"]
    cache = ["--coeff_cache", str(tmp_path / "c")]

    def run(main, name, extra):
        out = tmp_path / f"{name}.tif"
        assert main(argv + extra + ["--output", str(out)]) == 0
        jassets.cache.clear()
        assets.cache.clear()
        return imgio.read_image(str(out))
    want = run(jcli.main, "jax", cache)
    own = run(cli.main, "port", [])
    assert own.shape == want.shape == (192, 32, 3)
    diff = np.abs(own - want)
    assert float(diff.max()) <= BF16_FLIP_TOL
    assert float((diff > JAX_TOL).mean()) <= 0.01

    def unread(*_a):
        raise AssertionError("the image was read: no cache entry")
    monkeypatch.setattr(LD, "_read_facet_image", unread)
    shared = run(cli.main, "shared", cache)
    np.testing.assert_allclose(shared, want, rtol=0, atol=JAX_TOL)


# --------------------------------------------- degree above the kernels'

def test_degree_9_takes_the_exact_route(capsys):
    """A degree-9 job: ``uncovered`` names no reason, ``render_fast``
    takes the exact route (counted once, no kernel wrapper counts a
    launch, named under verbose) and renders what ``render_frame`` on the
    CPU renders; the kernel routes refuse it."""
    fct = port_facet(TP.SPHERICAL, 256, 128, 2 * math.pi)
    src = TE.make_mount_source(fct, synthetic_equirect(), 9, 9,
                               device="cpu")
    plan = build_plan(port_args(TP.RECTILINEAR, 40, 24, 70.0, [fct], 9,
                                30.0, 10.0), [fct])
    assert FP.uncovered(plan, [src]) is None and FP.exact_route(plan, [src])
    wrappers = [getattr(R, n) for n in (
        "resample_inline", "resample_planar", "resample_planar_chain",
        "resample_inline_twined", "resample_twined",
        "resample_twined_chain")]
    before = [w.launches for w in wrappers]
    FP.exact_frame.launches = 0
    got = FP.render_fast(plan, [src], verbose=True)
    assert FP.exact_frame.launches == 1
    assert [w.launches for w in wrappers] == before
    assert "exact path" in capsys.readouterr().out
    want = render_frame(plan, [src], device="cpu")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside 0..7"):
        FP.fused_frame(plan, src, device="cpu")
