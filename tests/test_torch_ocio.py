"""The port's OCIO config reader (``io/ocio.py``, a copy of the JAX
package's) against the JAX module on the configs that
``tests/test_colour.py`` writes: each case runs one of those tests
(which writes its configs into its own directory and checks the JAX
module), then converts seeded pixels between every ordered pair of the
config's spaces through both modules, which must agree bit for bit or
raise the same error."""

import numpy as np
import pytest

import test_colour as TC
from envutil_tpu.io import ocio as jocio
from envutil_tpu_torch.io import imgio as pio
from envutil_tpu_torch.io import ocio as pocio

CONFIG_TESTS = ["test_ocio_subset_config",         # matrix, exponent, group
                "test_ocio_file_transform_luts",   # .cube 1D/3D, .spi1d
                "test_ocio_log_and_cdl_sat",       # log camera/affine, CDL
                "test_ocio_builtin_transform_styles",
                "test_ocio_grading_transforms",
                "test_ocio_inverse_lut3d",
                "test_aces_output_transform",      # SDR view
                "test_aces_hdr_output_transforms"]  # PQ views


def _names(path):
    doc = pocio._load_yaml(path.read_text())
    names = [cs["name"] for cs in doc["colorspaces"]]
    return names + sorted(doc.get("roles", {}))


def _convert(mod, x, src, dst):
    try:
        return mod.convert(x, src, dst)
    except ValueError as e:     # OcioError: a kind the reader refuses
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("test_name", CONFIG_TESTS)
def test_ocio_config_as_jax(test_name, tmp_path, monkeypatch):
    # the JAX test draws from its module's RNG: leave that stream where
    # tests/test_colour.py expects it when it runs in this process
    state = TC.RNG.bit_generator.state
    try:
        getattr(TC, test_name)(tmp_path, monkeypatch)
    finally:
        TC.RNG.bit_generator.state = state
    configs = sorted(tmp_path.glob("*.ocio"))
    assert configs
    rng = np.random.default_rng(31)
    x = rng.uniform(0.02, 0.95, (12, 1, 3)).astype(np.float32)
    n_pairs = 0
    for cfg in configs:
        monkeypatch.setenv("OCIO", str(cfg))
        pocio._CACHE.clear()
        jocio._CACHE.clear()
        names = _names(cfg)
        for src in names:
            for dst in names:
                got = _convert(pocio, x, src, dst)
                want = _convert(jocio, x, src, dst)
                if isinstance(want, str):
                    assert got == want, (cfg.name, src, dst)
                else:
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{cfg.name}: {src}->{dst}")
                    n_pairs += 1
        # the port's imgio routes through the config first
        src, dst = names[-1], names[0]
        if not isinstance(_convert(jocio, x, src, dst), str):
            np.testing.assert_array_equal(
                pio.convert_colour(x, src, dst), pocio.convert(x, src, dst))
    assert n_pairs >= 4
    pocio._CACHE.clear()
    jocio._CACHE.clear()


def test_pq_hlg_display_styles_as_jax():
    """The HDR display encodes (ST 2084 PQ, BT.2100 HLG) hit their
    anchors, and every display style's forward and inverse are the JAX
    module's, bit for bit."""
    np.testing.assert_allclose(float(pocio._pq_encode(1.0)), 0.5080784,
                               atol=1e-6)
    np.testing.assert_allclose(float(pocio._hlg_encode(1.0 / 12.0)), 0.5,
                               atol=1e-9)
    rng = np.random.default_rng(32)
    xyz = rng.uniform(0.0, 1.2, (64, 3)).astype(np.float32)
    lum = np.logspace(-4, 2, 50)        # display-linear, 1.0 = 100 nits
    code = np.linspace(0.0, 1.0, 50)    # encoded signal
    for fn, v in (("_pq_encode", lum), ("_pq_decode", code),
                  ("_hlg_encode", lum / 100.0), ("_hlg_decode", code)):
        np.testing.assert_array_equal(getattr(pocio, fn)(v),
                                      getattr(jocio, fn)(v), err_msg=fn)
    for style in ("DISPLAY - CIE-XYZ-D65_to_REC.2100-PQ",
                  "DISPLAY - CIE-XYZ-D65_to_REC.2100-HLG",
                  "DISPLAY - CIE-XYZ-D65_to_ST2084-P3-D65",
                  "DISPLAY - CIE-XYZ-D65_to_sRGB",
                  "UTILITY - ACES-AP0_to_CIE-XYZ-D65_BFD"):
        for inv in (False, True):
            np.testing.assert_array_equal(
                pocio._builtin_fn(style, inv, "t")(xyz),
                jocio._builtin_fn(style, inv, "t")(xyz), err_msg=style)
