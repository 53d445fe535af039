"""PTO jobs on the port: alpha synthesis of exclude masks and lens crops,
the inverse lens LUT, ``--single`` on a lens-corrected facet, ``--split``
and the control-point check, against the JAX package.

Tolerances, each with its reason:

- ``synthesize_alpha``: bit-equal. It is the JAX package's host numpy,
  copied.
- ``InverseLcp`` against JAX's: 1e-6 relative. Both evaluate one float32
  knot table (the same float64 Newton knots) with a cubic spline; the
  JAX package runs its coordinates in float64 under the tests' x64 mode.
- ``pto_planar_forward(pto_planar_inverse(p))``: 1e-4 model units. The
  LUT interpolates 104 knots of the inverse; the reference accepts its
  interpolation error.
- frames and CLI images against the JAX package: 1e-5, as the other
  slices (both packages prefilter the same image).
- the card route (``fastpath.multi_frame``, kernels as their plain
  versions) against the port's exact path: 5e-5, as
  tests/test_torch_synopsis.py.
- control-point ratios: 1e-5 relative (sums of 16 float32 spline values).
"""

import math
import re
import textwrap

import numpy as np
import pytest
import torch

from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu.core.facet import Facet as JFacet
from envutil_tpu.core.facet import PtoMask as JPtoMask
from envutil_tpu.models import environment as JE
from envutil_tpu.models import lens as JL
from envutil_tpu.runtime import assets as jassets
from envutil_tpu.runtime import cli as jcli
from envutil_tpu.runtime import loader as jloader
from envutil_tpu.runtime.args import parse_args as jparse_args
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.core.facet import Facet as TFacet
from envutil_tpu_torch.core.facet import PtoMask as TPtoMask
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.models import environment as TE
from envutil_tpu_torch.models import lens as TL
from envutil_tpu_torch.runtime import assets as tassets
from envutil_tpu_torch.runtime import cli as tcli
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime import loader as tloader
from envutil_tpu_torch.runtime.args import parse_args as tparse_args
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

JAX_TOL = 1e-5
ROUTE_TOL = 5e-5
LUT_REL = 1e-6
ROUND_TRIP = 1e-4
CP_REL = 1e-5


def _star(cx, cy, r):
    pts = [(cx + r * math.cos(-math.pi / 2 + k * 4 * math.pi / 5),
            cy + r * math.sin(-math.pi / 2 + k * 4 * math.pi / 5))
           for k in range(5)]
    return [p[0] for p in pts], [p[1] for p in pts]


def _cancel():
    a = [(4, 4), (24, 4), (24, 24), (4, 24)]
    b = [(14, 14), (14, 34), (34, 34), (34, 14)]
    return ([p[0] for p in a] + [4] + [p[0] for p in b] + [14],
            [p[1] for p in a] + [4] + [p[1] for p in b] + [14])


# (projection, masks as (variant, vx, vy), crop (x0, x1, y0, y1) or None)
ALPHA_CASES = {
    "convex polygon": (JP.RECTILINEAR, [(0, [5.5, 30.2, 28, 6],
                                         [5, 7.5, 30, 26.8])], None),
    "self-intersecting star": (JP.RECTILINEAR,
                               [(0, *_star(32.0, 24.0, 20.0)),
                                (1, [0, 10, 10], [0, 0, 10])], None),
    "winding-cancel polygon": (JP.RECTILINEAR, [(0, *_cancel())], None),
    "rectangular crop": (JP.RECTILINEAR, [], (3, 61, 2, 46)),
    "elliptic crop": (JP.FISHEYE, [(0, [40, 60, 60, 40], [5, 5, 20, 20])],
                      (4, 60, 1, 47)),
}


@pytest.mark.parametrize("name", list(ALPHA_CASES))
def test_synthesize_alpha_is_bit_equal_to_jax(name):
    """The port's ``synthesize_alpha`` (k-line exclude polygons by
    winding-order scanline fill, a rectangular or, for fisheyes,
    elliptic lens crop, the binomial feather, associated alpha) gives
    the JAX package's result bit for bit; a mask of variant 1 is
    skipped by both."""
    proj, masks, crop = ALPHA_CASES[name]
    img = np.random.default_rng(3).uniform(0, 1, (48, 64, 3)).astype(
        np.float32)
    out = []
    for facet, mask in ((JFacet, JPtoMask), (TFacet, TPtoMask)):
        f = facet(projection=type(facet().projection)(int(proj)), width=64,
                  height=48)
        f.pto_masks = [mask(0, v, list(x), list(y)) for v, x, y in masks]
        f.has_pto_mask = bool(masks)
        if crop is not None:
            f.has_lens_crop = True
            f.crop_x0, f.crop_x1, f.crop_y0, f.crop_y1 = crop
        synth = JE.synthesize_alpha if facet is JFacet else \
            TE.synthesize_alpha
        out.append(synth(img, f))
    assert out[0].shape == (48, 64, 4) and out[0].dtype == out[1].dtype
    np.testing.assert_array_equal(out[1], out[0])
    alpha = out[1][..., 3]
    assert (alpha < 0.5).any() and (alpha > 0.99).any()


def test_inverse_lcp_matches_jax_and_inverts():
    """``InverseLcp`` at 1000 radii against the JAX package's (the same
    host knots, the LUT spline on the port's device), and the inverse
    planar transform (shear, shift, inverse lens) undone by the forward
    one."""
    a, b, c, r_max = 0.01, -0.02, 0.005, 1.25
    rr = np.linspace(0.0, r_max, 1000)
    want = np.asarray(JL.InverseLcp.create(a, b, c, r_max, sz=100)(rr))
    got = TL.InverseLcp.create(a, b, c, r_max, sz=100)(
        torch.from_numpy(rr.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, rtol=LUT_REL, atol=0)
    f = TFacet(a=a, b=b, c=c, h=0.04, v=-0.02, shear_g=0.01, shear_t=-0.02)
    f.set_geometry(TP.RECTILINEAR, 64, 48, math.radians(72))
    f.h, f.v = 3.0, -1.5               # pixels, as the PTO gives them
    f.process_geometry()
    assert f.has_lcp and f.has_shift and f.has_shear
    g = torch.Generator().manual_seed(5)
    # within the LUT's radii after the shift is taken off
    px = (torch.rand(2000, generator=g) * 1.8 - 0.9) * f.extent.x1
    py = (torch.rand(2000, generator=g) * 1.8 - 0.9) * f.extent.y1
    bx, by = TL.pto_planar_forward(f)(*TL.pto_planar_inverse(f)(px, py))
    assert float(torch.maximum((bx - px).abs(), (by - py).abs()).max()) \
        <= ROUND_TRIP


def _pto(tmp_path, facets, extra="", p_line="p f2 w96 h48 v360", scale=1.0):
    """Write seeded-noise TIFF facets (values in [0, ``scale``)) and a PTO
    over them; ``facets`` are i-line fields without the file name."""
    rng = np.random.default_rng(11)
    lines = [p_line]
    for i, fields in enumerate(facets):
        w, h = (int(re.search(k + r"(\d+)", fields).group(1))
                for k in (" w", " h"))
        imgio.save_image(str(tmp_path / f"f{i}.tif"),
                         rng.uniform(0, scale, (h, w, 3)).astype(np.float32))
        lines.append(f'i{fields} n"{tmp_path}/f{i}.tif"')
    path = tmp_path / "job.pto"
    path.write_text("\n".join(lines) + "\n" + textwrap.dedent(extra))
    return str(path)


LENS = " w64 h48 f0 v72 y-30 p0 r0 a0.01 b-0.02 c0.005 d2 e-1"
PLAIN = " w64 h48 f0 v72 y30 p5 r0"


def _both_clis(argv, tmp_path, outputs):
    """Run the port's and the JAX CLI on ``argv(tag)``; returns, per CLI,
    the images named ``outputs`` (formats of the tag)."""
    res = []
    for tag, main, cache in (("t", tcli.main, tassets),
                             ("j", jcli.main, jassets)):
        assert main(argv(tag)) == 0
        cache.cache.clear()
        res.append([imgio.read_image(str(tmp_path / o.format(tag)))
                    for o in outputs])
    return res


def test_single_lens_facet_matches_jax(tmp_path):
    """``--single 0`` re-creates the lens-corrected, shifted facet 0 (a
    lens crop, so 4 channels; Eev 1 against the p-line's 2, so the
    amplify undoes its brighten of 1/2; facet 1 has no Eev, so the amplify
    doubles it, and its noise lies in [0, 0.5) to keep the frame within
    [0, 1], the range the absolute bounds are stated for)
    from both facets: every facet takes a generic chain through the
    inverse lens LUT. The port's exact path against the JAX
    ``render_frame``, and the card route (one planes launch per facet)
    against the port's exact path."""
    pto = _pto(tmp_path, [LENS + " S3,61,2,46 Eev1", PLAIN],
               p_line="p f2 w96 h48 v360 Eev2", scale=0.5)
    argv = ["--pto", pto, "--single", "0", "--twine", "0", "--output",
            str(tmp_path / "s.tif")]
    frames = []
    for parse, load, plan_of, render in (
            (tparse_args, lambda f, a: tloader.load_source(f, a, "cpu"),
             build_plan, lambda p, s, b: render_frame(p, s, amplify=b,
                                                      device="cpu")),
            (jparse_args, jloader.load_source, jbuild_plan,
             lambda p, s, b: np.asarray(jrender_frame(p, s, amplify=b)))):
        args = parse(argv)
        args.twine_setup()
        plan = plan_of(args, args.facets)
        assert plan.planar_to_ray[0] is not None and plan.bases == (None,
                                                                    None)
        sources = [load(f, args) for f in args.facets]
        amplify = 1.0 / args.facets[0].brighten
        assert amplify == 2.0
        frames.append(render(plan, sources, amplify))
        if parse is tparse_args:
            tplan, tsrcs = plan, sources
    assert frames[0].shape == (48, 64, 4)
    np.testing.assert_allclose(frames[0], frames[1], rtol=0, atol=JAX_TOL)
    assert FP.exact_route(tplan, tsrcs) is None
    log = []
    fast = FP.multi_frame(tplan, tsrcs, log=log) * torch.tensor(
        [2.0, 2.0, 2.0, 1.0])
    assert log == ["resample_planar after the coordinate pass"] * 2
    np.testing.assert_allclose(fast.numpy(), frames[0], rtol=0,
                               atol=ROUTE_TOL)
    assert (frames[0][..., 3] > 0.5).mean() > 0.5


def test_split_cli_matches_jax_cli(tmp_path, monkeypatch):
    """``--split`` with ``--solo 1``: every facet but the solo one is
    re-created from the solo facet's data, one TIFF each, as the JAX CLI
    writes them; each of those jobs renders on the card route (the
    kernels' plain versions: the planes form into the lens-corrected
    facet 0, the chain form into facet 2) as the port's CLI wrote it."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    pto = _pto(tmp_path, [LENS, PLAIN, " w64 h48 f0 v72 y0 p-10 r0"])
    job = ["--pto", pto, "--solo", "1", "--twine", "0"]
    outs = _both_clis(
        lambda tag: job + ["--split", str(tmp_path / f"split_{tag}_%d.tif")],
        tmp_path, ["split_{}_0.tif", "split_{}_2.tif"])
    for got, want in zip(*outs):
        assert got.shape == want.shape == (48, 64, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
        assert (got != 0).any()
    for tag in "tj":
        assert not (tmp_path / f"split_{tag}_1.tif").exists()
    for i, written, how in ((0, outs[0][0], "planes"), (2, outs[0][1], "chain")):
        args = tparse_args(job + ["--single", str(i), "--output", "x.tif"])
        args.twine_setup()
        plan = build_plan(args, args.facets)
        assert plan.facet_indices == (1,)
        src = tloader.load_source(args.facets[1], args, "cpu")
        assert FP.route(plan, src) == how
        np.testing.assert_allclose(FP.render_fast(plan, [src]), written,
                                   rtol=0, atol=ROUTE_TOL)


def test_cp_statistics_and_masked_stitch_match_jax_cli(tmp_path, capsys,
                                                       monkeypatch):
    """A two-facet PTO with c-lines, a lens crop on facet 0 and a k-line
    exclude polygon on facet 1, under -v: the control-point check prints
    the JAX CLI's matrix and ratios, and the stitch of the two
    alpha-synthesized facets is the JAX CLI's image."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    pto = _pto(tmp_path, [LENS + " S3,61,2,46", PLAIN], """\
        c n0 N1 x50 y20 X10 Y22 t0
        c n0 N1 x55 y30 X15 Y31 t0
        c n0 N1 x5 y5 X6 Y6 t1
        k i1 t0 p"10 10 30 8 28 30 12 28"
        """)
    printed = []

    def argv(tag):
        printed.append(capsys.readouterr().out)
        return ["--pto", pto, "--twine", "0", "-v", "--output",
                str(tmp_path / f"cp_{tag}.tif")]
    (got,), (want,) = _both_clis(argv, tmp_path, ["cp_{}.tif"])
    printed.append(capsys.readouterr().out)
    assert got.shape == want.shape == (48, 96, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)

    def numbers(out):
        lines = out.split("CP intensity check:\n")[1].splitlines()[:3]
        assert lines[2].startswith("1:0 ")
        return [float(t) for line in lines[:2] for t in line.split()] + [
            float(lines[2].split()[1])]
    port, jax = numbers(printed[1]), numbers(printed[2])
    assert len(port) == len(jax) == 5 and port[-1] != 0
    np.testing.assert_allclose(port, jax, rtol=CP_REL, atol=0)
