"""The port's EXR shim (``envutil_tpu_torch/io/native/envio.cc``, built at
first use into ``_build/``) against the JAX package's: files written by
either package read back bit-equal in the other, with their
Projection/Hfov metadata, as single files and as ``%s`` cube-face
series; the header probe reads no pixels."""

import ctypes
import re

import numpy as np
import pytest

from envutil_tpu.io import imgio as jio
from envutil_tpu_torch.core.conventions import FACE_NAMES
from envutil_tpu_torch.io import imgio as pio

RNG = np.random.default_rng(12)


def _pixels(h, w, c):
    """Seeded float32 pixels with negatives, HDR values and exact
    zeros, none of which EXR's float channels may change."""
    a = RNG.uniform(-0.5, 4.0, (h, w, c)).astype(np.float32)
    a[0, :3] = 0.0
    return a


def test_shim_builds_at_first_use_into_build(tmp_path, monkeypatch):
    """A missing library is built with g++ from the port's own source into
    the build directory, named by the source's hash, and loads with every
    C entry point declared; a failed build raises with the compiler's
    output."""
    assert pio._NATIVE_SRC.parent.parent.name == "io"
    assert pio._BUILD_DIR.name == "_build"
    assert pio.native_path().parent == pio._BUILD_DIR
    build = tmp_path / "_build"
    monkeypatch.setattr(pio, "_BUILD_DIR", build)
    monkeypatch.setattr(pio, "_LIB", None)
    lib = pio._load_native()
    so = pio.native_path()
    assert so.parent == build and so.exists()
    assert re.fullmatch(r"envio_[0-9a-f]{16}\.so", so.name)
    assert sorted(p.name for p in build.iterdir()) == [so.name]

    # one argtype per C parameter, pointers where C takes one
    text = pio._NATIVE_SRC.read_text()
    found = {}
    for ret, name, params in re.findall(
            r"^(int|void\*|void) (envio_\w+)\((.*?)\)\s*\{", text,
            re.S | re.M):
        found[name] = [p.strip() for p in params.split(",")]
        argtypes, restype = pio.NATIVE_SYMBOLS[name]
        assert getattr(lib, name).argtypes == argtypes
        assert len(argtypes) == len(found[name]), name
        for p, t in zip(found[name], argtypes):
            is_ptr = "*" in p
            assert is_ptr == (t in (ctypes.c_void_p, ctypes.c_char_p)
                              or hasattr(t, "contents")), (name, p)
        assert restype == {"int": ctypes.c_int, "void*": ctypes.c_void_p,
                           "void": None}[ret], name
    assert set(found) == set(pio.NATIVE_SYMBOLS)

    bad = tmp_path / "envio.cc"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(pio, "_NATIVE_SRC", bad)
    monkeypatch.setattr(pio, "_LIB", None)
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed.*no_such_header"):
        pio._load_native()
    assert sorted(p.name for p in build.iterdir()) == [so.name]


@pytest.mark.parametrize("nch", [1, 3, 4])
def test_exr_written_by_either_package_reads_in_the_other(tmp_path, nch):
    a = _pixels(37, 53, nch)
    b = _pixels(37, 53, nch)
    pio.save_image(str(tmp_path / "port.exr"), a,
                   projection_name="spherical", hfov_deg=360.0)
    jio.save_image(str(tmp_path / "jax.exr"), b,
                   projection_name="fisheye", hfov_deg=187.5)
    for read in (pio.read_image, jio.read_image):
        np.testing.assert_array_equal(read(str(tmp_path / "port.exr")), a)
        np.testing.assert_array_equal(read(str(tmp_path / "jax.exr")), b)
    for meta in (pio.read_image_metadata, jio.read_image_metadata):
        m = meta(str(tmp_path / "port.exr"))
        assert (m["Projection"], m["Hfov"]) == ("spherical", 360.0)
        assert (m["width"], m["height"], m["nchannels"]) == (53, 37, nch)
        m = meta(str(tmp_path / "jax.exr"))
        assert (m["Projection"], m["Hfov"]) == ("fisheye", 187.5)
    assert pio.read_image_metadata(str(tmp_path / "jax.exr")) == \
        jio.read_image_metadata(str(tmp_path / "jax.exr"))


def test_cube_face_series_both_ways(tmp_path):
    """A ``%s`` output path stores a 1:6 cubemap stripe as six faces, each
    a 90-degree rectilinear file; either package reads the other's."""
    stripe = _pixels(6 * 16, 16, 3)
    pio.save_image(str(tmp_path / "p_%s.exr"), stripe,
                   projection_name="cubemap", hfov_deg=90.0)
    jio.save_image(str(tmp_path / "j_%s.exr"), stripe[::-1].copy(),
                   projection_name="cubemap", hfov_deg=90.0)
    assert not (tmp_path / "p_%s.exr").exists()
    for i, face in enumerate(FACE_NAMES):
        want = stripe[i * 16:(i + 1) * 16]
        np.testing.assert_array_equal(
            jio.read_image(str(tmp_path / f"p_{face}.exr")), want)
        np.testing.assert_array_equal(
            pio.read_image(str(tmp_path / f"j_{face}.exr")),
            stripe[::-1][i * 16:(i + 1) * 16])
        m = jio.read_image_metadata(str(tmp_path / f"p_{face}.exr"))
        assert (m["Projection"], m["Hfov"]) == ("rectilinear", 90.0)


def test_header_only_probe(tmp_path):
    """``read_image_metadata`` reads the header alone: it answers for a
    file whose pixel data is cut off, which ``read_image`` cannot read;
    a missing file raises."""
    path = tmp_path / "cut.exr"
    pio.save_image(str(path), _pixels(64, 96, 3),
                   projection_name="cylindrical", hfov_deg=200.0)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 8])
    m = pio.read_image_metadata(str(path))
    assert m == {"Projection": "cylindrical", "Hfov": 200.0, "width": 96,
                 "height": 64, "nchannels": 3}
    assert m == jio.read_image_metadata(str(path))
    with pytest.raises(IOError, match="failed to read EXR"):
        pio.read_image(str(path))
    with pytest.raises(IOError, match="cannot probe EXR header"):
        pio.read_image_metadata(str(tmp_path / "missing.exr"))
