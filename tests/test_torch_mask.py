"""``--mask_for`` jobs on the port: paint sources (``--nchannels 1``, no
image data) and alpha masking (``--nchannels 2``, the facets' alpha from
a lens crop), against the JAX package, and their route on the card:
``fastpath.exact_frame``, as the JAX package renders every masked job
on its XLA graph.

Tolerances: frames and CLI images against the JAX package 1e-5, as the
other slices; the card route (``render_fast`` on CPU tensors) is the
port's exact path itself, so it is held bit for bit to
``render_frame(device="cpu")``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_pto import LENS, PLAIN, _both_clis, _pto

from envutil_tpu.runtime import loader as jloader
from envutil_tpu.runtime.args import parse_args as jparse_args
from envutil_tpu.runtime.render import build_plan as jbuild_plan
from envutil_tpu.runtime.render import render_frame as jrender_frame
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime import loader as tloader
from envutil_tpu_torch.runtime.args import parse_args as tparse_args
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

JAX_TOL = 1e-5
WRAPPERS = ("resample_inline", "resample_planar", "resample_planar_chain",
            "resample_inline_twined", "resample_twined",
            "resample_twined_chain")


def _job(tmp_path, nch, mask_for=1):
    """The argument list of a three-facet ``--mask_for`` job (a lens
    facet with a crop, two plain facets) into a 96x48 equirect."""
    pto = _pto(tmp_path, [LENS + " S3,61,2,46", PLAIN,
                          " w64 h48 f0 v72 y100 p-10 r0"])
    return ["--pto", pto, "--mask_for", str(mask_for), "--nchannels",
            str(nch), "--twine", "0"]


@pytest.mark.parametrize("nch", [1, 2])
def test_mask_for_matches_jax_on_the_exact_route(tmp_path, nch):
    """A ``--mask_for 1`` frame: with one channel every facet is a paint
    source (no table; 1 where facet 1 wins, else 0), with two the
    facets keep their tables and their alpha is masked. The port's
    ``render_frame(device="cpu")`` against the JAX ``render_frame``;
    ``render_fast`` takes ``exact_frame`` (counted once, no kernel
    launched) and renders the same frame."""
    argv = _job(tmp_path, nch) + ["--output", "x.tif"]
    frames = []
    for parse, load, plan_of, render in (
            (tparse_args, lambda f, a: tloader.load_source(f, a, "cpu"),
             build_plan, lambda p, s: render_frame(p, s, device="cpu")),
            (jparse_args, jloader.load_source, jbuild_plan,
             lambda p, s: np.asarray(jrender_frame(p, s)))):
        args = parse(argv)
        args.twine_setup()
        plan = plan_of(args, args.facets)
        sources = [load(f, args) for f in args.facets]
        assert [s.spl is None for s in sources] == [nch == 1] * 3
        frames.append(render(plan, sources))
        if parse is tparse_args:
            tplan, tsrcs = plan, sources
    got, want = frames
    assert got.shape == want.shape == (48, 96, nch)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    assert FP.uncovered(tplan, tsrcs) is None
    assert "mask_for" in FP.exact_route(tplan, tsrcs)
    before = [getattr(R, n).launches for n in WRAPPERS]
    FP.exact_frame.launches = 0
    fast = FP.render_fast(tplan, tsrcs, device="cpu")
    assert FP.exact_frame.launches == 1
    assert [getattr(R, n).launches for n in WRAPPERS] == before
    np.testing.assert_array_equal(fast, got)
    if nch == 1:
        assert set(np.unique(got)) == {0.0, 1.0}
    assert 0.02 < float((got[..., 0] > 0.5).mean()) < 0.5


@pytest.mark.parametrize("nch", [1, 2])
def test_cli_mask_for_matches_jax_cli(tmp_path, monkeypatch, nch):
    """``--mask_for 0`` through both CLIs: the image is the mask's first
    channel (of (value x alpha, alpha) with two channels), as the JAX CLI
    writes it."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    job = _job(tmp_path, nch, mask_for=0)
    (got,), (want,) = _both_clis(
        lambda tag: job + ["--output", str(tmp_path / f"m_{tag}.tif")],
        tmp_path, ["m_{}.tif"])
    assert got.shape == want.shape == (48, 96, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    assert (got > 0.5).any() and (got < 0.5).any()


def test_kernel_routes_refuse_masked_sources(tmp_path):
    """No kernel paints or masks: the kernel entry points refuse a paint
    source and a masked source, naming ``exact_frame``; ``render_fast``
    needs the render's device where no source has a table; a source
    whose mask flag is cleared goes back to its kernel."""
    args = tparse_args(_job(tmp_path, 1) + ["--output", "x.tif"])
    args.twine_setup()
    plan = build_plan(args, args.facets)
    paint = [tloader.load_source(f, args, "cpu") for f in args.facets]
    with pytest.raises(ValueError, match="device"):
        FP.render_fast(plan, paint)
    with pytest.raises(ValueError, match="exact_frame"):
        FP.multi_frame(plan, paint)
    args2 = tparse_args(_job(tmp_path, 2) + ["--output", "x.tif"])
    args2.twine_setup()
    masked = [tloader.load_source(f, args2, "cpu") for f in args2.facets]
    one = FP.facet_plans(build_plan(args2, args2.facets))[1]
    with pytest.raises(ValueError, match="exact_frame"):
        FP.planar_frame(one, masked[1])
    clear = dataclasses.replace(masked[1], static=dataclasses.replace(
        masked[1].static, masked=-1))
    assert FP.exact_route(one, [clear]) is None
    assert FP.planar_frame(one, clear).shape == (48, 96, 2)
