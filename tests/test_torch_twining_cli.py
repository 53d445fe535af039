"""Twined CLI jobs of the port against the JAX CLI: `--twine_pyramid`'s
decimation, twined jobs with and without an explicit `--twine`, and a
`--twf_file` spread. The helpers are test_torch_twining's.
"""

import numpy as np
import pytest

from test_golden_oracle import synthetic_equirect

from envutil_tpu.runtime import loader as JLD
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.runtime import cli
from envutil_tpu_torch.runtime import loader as LD
from envutil_tpu_torch.runtime.render import build_plan, render_frame

from test_torch_twining import (
    CLI_JOBS, JAX_TOL, _cli_pair,
)


def test_decimate_matches_jax():
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (64, 128, 3)).astype(np.float32)
    for level in (1, 2, 3):
        got = LD._decimate(img, level)
        assert got.shape == (64 >> level, 128 >> level, 3)
        np.testing.assert_array_equal(got, JLD._decimate(img, level))
    with pytest.raises(ValueError, match="divide"):
        LD._decimate(img[:63], 1)


@pytest.mark.parametrize("name,extra", CLI_JOBS, ids=[c[0] for c in CLI_JOBS])
def test_cli_twined_job_matches_jax_cli(tmp_path, monkeypatch, name, extra):
    """A downscale through the port's CLI without ``--twine 0`` (the
    automatic twine), with ``--twine_pyramid`` (the facet decimated at
    load) and with explicit twine options, against the JAX CLI."""
    got, want = _cli_pair(tmp_path, monkeypatch, extra, name)
    assert got.shape == want.shape == (48, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)


def test_cli_pyramid_decimates_and_twf_file_is_read(tmp_path, monkeypatch):
    """``--twine_pyramid`` really decimates (the facet's geometry and the
    cached asset shrink, the twine drops to 2x2 or fewer taps), and a
    ``--twf_file`` reaches ``twining.read_twf_file``."""
    from envutil_tpu_torch.runtime.args import parse_args
    src_path = tmp_path / "env.tif"
    imgio.save_image(str(src_path), synthetic_equirect(512, 256))
    base = ["--facet", str(src_path), "spherical", "360", "20", "0", "0",
            "--projection", "rectilinear", "--hfov", "90", "--width", "64",
            "--height", "48", "--degree", "1", "--output", "x.tif"]
    plain = parse_args(base)
    plain.twine_setup()
    pyr = parse_args(base + ["--twine_pyramid"])
    pyr.twine_setup()
    assert pyr.facets[0].pyramid_level >= 1
    assert pyr.facets[0].width == 512 >> pyr.facets[0].pyramid_level
    assert len(pyr.twine_spread) <= 4 < len(plain.twine_spread)
    src = LD.load_source(pyr.facets[0], pyr, "cpu")
    assert tuple(src.spl.core_shape) == (pyr.facets[0].height,
                                         pyr.facets[0].width)
    full = LD.load_source(plain.facets[0], plain, "cpu")
    assert tuple(full.spl.core_shape) == (256, 512), \
        "the asset cache keys on the pyramid level"

    twf = tmp_path / "k.twf"
    twf.write_text("-0.25 0 0.25\n0 0 0.5\n0.25 0 0.25\n")
    args = parse_args(base + ["--twf_file", str(twf), "--twine_width", "2"])
    args.twine_setup()
    assert args.twine_spread == [(-0.5, 0.0, 0.25), (0.0, 0.0, 0.5),
                                 (0.5, 0.0, 0.25)]
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    out = tmp_path / "twf.tif"
    assert cli.main(base[:-1] + [str(out), "--twf_file", str(twf),
                                 "--twine_width", "2"]) == 0
    lib = render_frame(build_plan(args, args.facets),
                       [LD.load_source(args.facets[0], args, "cpu")],
                       device="cpu")
    np.testing.assert_array_equal(imgio.read_image(str(out)), lib)
