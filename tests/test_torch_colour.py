"""The port's colour modules (``io/colour.py``, ``io/aces.py``, copies of
the JAX package's, numpy only) give bit-equal results to the JAX
modules on seeded inputs, and the port's ``imgio.convert_colour`` routes
as the JAX package's does: an active ``$OCIO`` config first, then
sRGB<->linear, then the built-in spaces, else PyOpenColorIO or the
same ``ValueError``."""

import textwrap

import numpy as np
import pytest

from envutil_tpu.io import aces as jaces
from envutil_tpu.io import colour as jcol
from envutil_tpu.io import imgio as jio
from envutil_tpu.io import ocio as jocio
from envutil_tpu_torch.io import aces as paces
from envutil_tpu_torch.io import colour as pcol
from envutil_tpu_torch.io import imgio as pio
from envutil_tpu_torch.io import ocio as pocio

SPACES = ["scene_linear", "sRGB", "lin_rec2020", "ACEScg", "ACES2065-1",
          "lin_p3d65", "rec709", "gamma2.2", "ACEScct", "logc3", "logc4",
          "slog3", "vlog", "log3g10"]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rec709_matrix_and_derived_matrices():
    """The Rec.709->XYZ matrix derived from primaries is the published
    BT.709 one, and every derived matrix is the JAX module's, bit for
    bit."""
    m = pcol.rgb_to_xyz_matrix(*pcol._PRIMARIES["rec709"])
    ref = np.array([[0.4123908, 0.35758434, 0.18048079],
                    [0.21263901, 0.71516868, 0.07219232],
                    [0.01933082, 0.11919478, 0.95053215]])
    np.testing.assert_allclose(m, ref, atol=2e-4)
    assert sorted(pcol._PRIMARIES) == sorted(jcol._PRIMARIES)
    for name, (prim, white) in pcol._PRIMARIES.items():
        _same(pcol.rgb_to_xyz_matrix(prim, white),
              jcol.rgb_to_xyz_matrix(prim, white))
    for a in ("acescg", "aces", "lin_rec2020", "slog3"):
        for b in ("lin_rec709", "aces", "lin_p3d65"):
            _same(pcol.conversion_matrix(pcol.find_space(a),
                                         pcol.find_space(b)),
                  jcol.conversion_matrix(jcol.find_space(a),
                                         jcol.find_space(b)))


def test_builtin_spaces_round_trip_as_jax():
    """Every ordered pair of built-in spaces converts bit-equal to the JAX
    module, and the round trip returns the input."""
    rng = np.random.default_rng(21)
    x = rng.uniform(0.01, 1.0, (64, 3)).astype(np.float32)
    for a in SPACES:
        assert pcol.known(a) and jcol.known(a)
        for b in SPACES:
            y = pcol.convert(x, a, b)
            _same(y, jcol.convert(x, a, b))
            np.testing.assert_allclose(pcol.convert(y, b, a), x, atol=2e-4,
                                       err_msg=f"{a}->{b}")
    assert not pcol.known("weird_cam_log")


def test_camera_logs_as_jax():
    """The camera-log curves: 18% grey lands on the vendor codes, decode
    inverts encode, and both are the JAX module's bit for bit."""
    anchors = {"slog3": 420.0 / 1023.0, "logc3": 0.391007,
               "log3g10": 1.0 / 3.0, "vlog": 0.423311,
               "acescct": 0.4135884, "acescc": 0.4135884,
               "logc4": 0.2783958}
    assert sorted(pcol._TRANSFERS) == sorted(jcol._TRANSFERS)
    x = np.linspace(-0.05, 8.0, 2001, dtype=np.float32)
    for name, (dec, enc) in pcol._TRANSFERS.items():
        if enc is None:
            continue
        jdec, jenc = jcol._TRANSFERS[name]
        e = enc(x)
        _same(e, jenc(x))
        _same(dec(e), jdec(e))
        if name in anchors:
            got = float(np.asarray(enc(np.float32(0.18))).ravel()[0])
            assert abs(got - anchors[name]) < 2e-4, name
        if name in ("acescct", "logc3", "logc4", "slog3", "log3g10",
                    "vlog", "clog2"):
            np.testing.assert_allclose(dec(e), x, atol=2e-5, rtol=1e-4,
                                       err_msg=name)


def test_aces_sdr_output_transform_as_jax():
    """The RRT + 48-nit ODT: the tonescale knots, 18% grey near 0.10
    display-linear Y, and the transform bit-equal to the JAX module's
    for both surrounds."""
    assert paces.rrc_tonescale(0.18) == pytest.approx(4.8, rel=1e-9)
    x = 0.18 * 2.0 ** np.linspace(-15, 18, 200)
    _same(paces.rrc_tonescale(x), jaces.rrc_tonescale(x))
    _same(paces.odt48_tonescale(paces.rrc_tonescale(x)),
          jaces.odt48_tonescale(jaces.rrc_tonescale(x)))
    rng = np.random.default_rng(22)
    rgb = rng.uniform(0.0, 4.0, (128, 3))
    for surround in ("dim", "dark"):
        _same(paces.output_transform_sdr(rgb, surround),
              jaces.output_transform_sdr(rgb, surround))
    y = float(paces.output_transform_sdr(np.full((1, 3), 0.18), "dim")[0, 1])
    assert 0.095 < y < 0.112


def test_aces_hdr_output_transforms_as_jax():
    """The SSTS HDR transforms: the curve hits its anchors and the
    transforms are the JAX module's, bit for bit."""
    rng = np.random.default_rng(23)
    rgb = rng.uniform(0.0, 50.0, (128, 3))
    xs = np.logspace(-6.0, 4.0, 400)
    for y_min, y_mid, y_max in ((0.0001, 15.0, 1000.0),
                                (0.0001, 15.0, 4000.0),
                                (0.0001, 7.2, 108.0)):
        p = paces.SstsParams(y_min, y_mid, y_max)
        assert float(p(0.18)) == pytest.approx(y_mid, rel=1e-6)
        _same(p(xs), jaces.SstsParams(y_min, y_mid, y_max)(xs))
        _same(paces.output_transform_hdr(rgb, y_min, y_mid, y_max),
              jaces.output_transform_hdr(rgb, y_min, y_mid, y_max))


def test_convert_colour_routing_as_jax(tmp_path, monkeypatch):
    """Without ``$OCIO`` the built-in paths answer (alpha passed
    through); an active config takes precedence even over a built-in
    name; a space nothing knows raises JAX's error without
    PyOpenColorIO."""
    rng = np.random.default_rng(24)
    x = rng.uniform(0.0, 1.0, (4, 5, 3)).astype(np.float32)
    xa = np.concatenate([x, np.full((4, 5, 1), 0.7, np.float32)], -1)
    monkeypatch.delenv("OCIO", raising=False)
    for src, dst in (("sRGB", "scene_linear"), ("linear", "srgb"),
                     ("ACEScg", "scene_linear"), ("lin_rec709", "logc4"),
                     ("lin_rec2020", "ACES2065-1"), ("Linear", "")):
        for arr in (x, xa):
            out = pio.convert_colour(arr, src, dst)
            _same(out, jio.convert_colour(arr, src, dst))
        np.testing.assert_array_equal(out[..., 3], np.float32(0.7))
    _same(pio.convert_colour(x, "sRGB", "scene_linear"),
          pio.srgb_to_linear(x))
    _same(pio.convert_colour(x, "ACEScg", "scene_linear"),
          pcol.convert(x, "ACEScg", "scene_linear"))
    with pytest.raises(ValueError, match="OCIO") as port_err:
        pio.convert_colour(x, "weird_cam_log", "scene_linear")
    with pytest.raises(ValueError) as jax_err:
        jio.convert_colour(x, "weird_cam_log", "scene_linear")
    assert str(port_err.value) == str(jax_err.value)

    cfg = tmp_path / "shadow.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles: {scene_linear: lin}
        colorspaces:
          - name: lin
          - name: ACEScg
            from_scene_reference: !<MatrixTransform>
              matrix: [0.5, 0, 0, 0, 0, 0.5, 0, 0, 0, 0, 0.5, 0, 0, 0, 0, 1]
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    pocio._CACHE.clear()
    jocio._CACHE.clear()
    out = pio.convert_colour(xa, "lin", "ACEScg")
    np.testing.assert_allclose(out[..., :3], x * 0.5, atol=1e-7)
    _same(out, jio.convert_colour(xa, "lin", "ACEScg"))
    # a pair the config does not know falls through to the built-ins
    _same(pio.convert_colour(x, "sRGB", "lin_rec2020"),
          jio.convert_colour(x, "sRGB", "lin_rec2020"))
    pocio._CACHE.clear()
    jocio._CACHE.clear()


def test_exr_output_colour_space_as_jax(tmp_path, monkeypatch):
    """``save_image`` converts to the output colour space before it
    writes: an ACEScg EXR from the port holds the JAX package's
    pixels."""
    monkeypatch.delenv("OCIO", raising=False)
    rng = np.random.default_rng(25)
    img = rng.uniform(0.0, 2.0, (24, 40, 4)).astype(np.float32)
    kw = dict(projection_name="spherical", hfov_deg=360.0,
              output_colour_space="ACEScg")
    pio.save_image(str(tmp_path / "p.exr"), img, **kw)
    jio.save_image(str(tmp_path / "j.exr"), img, **kw)
    got = jio.read_image(str(tmp_path / "p.exr"))
    _same(got, jio.read_image(str(tmp_path / "j.exr")))
    _same(got[..., :3], pcol.convert(img[..., :3], "scene_linear",
                                     "ACEScg"))
    _same(got[..., 3], img[..., 3])
