"""The port's out-of-core stores (``io/tiles.py``): per-tile files with
ref-counted, bounded residency, scanline stores over callbacks and the
native EXR scanline streams, and ``render_to_store``, which renders a
plan strip by strip through ``render_frame``, against the port's whole
frame and the JAX package's ``render_to_store``."""

import math

import numpy as np
import pytest
import torch

from envutil_tpu.io import imgio as jio
from envutil_tpu.io import tiles as jtiles
from envutil_tpu_torch.io import imgio as pio
from envutil_tpu_torch.io.tiles import (LineStore, TileStore,
                                        exr_line_reader, exr_line_writer,
                                        render_to_store)

torch.set_num_threads(1)


def ramp(h, w, c=3):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([x / w, y / h, (x + y) % 7.0], -1)[..., :c]


def test_tile_store_window_round_trip(tmp_path):
    """Windows across tile boundaries and ragged edges read back what was
    written; a read-only store refuses writes; the tile files are the
    JAX package's, which reads them back the same."""
    img = ramp(300, 500)
    with TileStore(tmp_path / "ts", "w", shape=img.shape,
                   tile_shape=(128, 128)) as st:
        st.write_window(img, 0, 0)
    st = TileStore(tmp_path / "ts", "r")
    assert st.ntiles == (3, 4)
    np.testing.assert_array_equal(st.read_window(0, 300, 0, 500), img)
    np.testing.assert_array_equal(st.read_window(100, 260, 120, 130),
                                  img[100:260, 120:130])
    with pytest.raises(PermissionError):
        st.write_window(img[:10, :10], 0, 0)
    np.testing.assert_array_equal(
        jtiles.TileStore(tmp_path / "ts", "r").read_window(7, 299, 3, 401),
        img[7:299, 3:401])


def test_tile_store_eviction_write_through(tmp_path):
    img = ramp(512, 512)
    st = TileStore(tmp_path / "ts", "w", shape=img.shape,
                   tile_shape=(64, 64), max_resident=2)
    for y in range(0, 512, 100):      # 64 tiles through a budget of 2
        st.write_window(img[y:y + 100], y, 0)
    assert len(st._resident) <= 2 + 1
    st.close()
    assert len(list((tmp_path / "ts").glob("tile_*.npy"))) == 64
    got = TileStore(tmp_path / "ts", "r").read_window(0, 512, 0, 512)
    np.testing.assert_array_equal(got, img)


def test_tile_store_absent_tiles_read_zero(tmp_path):
    st = TileStore(tmp_path / "ts", "w", shape=(100, 100, 1),
                   tile_shape=(50, 50))
    np.testing.assert_array_equal(st.read_window(0, 100, 0, 100),
                                  np.zeros((100, 100, 1), np.float32))
    with pytest.raises(IndexError):
        st.get(2, 0)


def test_tile_refcount(tmp_path):
    st = TileStore(tmp_path / "ts", "w", shape=(64, 64, 1),
                   tile_shape=(32, 32), max_resident=0)
    t = st.get(0, 0, for_write=True)
    t.data[:] = 5.0
    t2 = st.get(0, 0)
    assert t2 is t and t.nusers == 2
    st.release(t)
    assert (0, 0) in st._resident          # still held
    st.release(t2)
    assert (0, 0) not in st._resident      # evicted, written through
    assert np.all(np.load(st.tile_path(0, 0)) == 5.0)


def test_line_store_and_exr_scanline_streams(tmp_path):
    """A LineStore over callbacks; the native EXR scanline writer (rows
    top-down, Projection/Hfov attributes) and reader (rows in any
    order) against the whole-file readers of both packages; a writer
    closed short raises."""
    img = ramp(20, 30)
    seen = {}
    ls = LineStore(30, 20, 3, load_fn=lambda y: img[y],
                   store_fn=lambda y, line: seen.__setitem__(y, line.copy()))
    np.testing.assert_array_equal(ls.read_window(3, 7, 5, 25),
                                  img[3:7, 5:25])
    ls.write_window(img[2:5], 2, 0)
    assert sorted(seen) == [2, 3, 4]
    with pytest.raises(ValueError):
        ls.write_window(img[2:5, 1:], 2, 1)

    img = ramp(64, 96)
    path = str(tmp_path / "stream.exr")
    wr = exr_line_writer(path, 96, 64, 3, projection_name="spherical",
                         hfov_deg=360.0)
    for y in range(0, 64, 16):
        wr.write(img[y:y + 16])
    wr.close()
    for read, meta in ((pio.read_image, pio.read_image_metadata),
                       (jio.read_image, jio.read_image_metadata)):
        np.testing.assert_array_equal(read(path), img)
        m = meta(path)
        assert (m["Projection"], m["Hfov"]) == ("spherical", 360.0)
    rd = exr_line_reader(path)
    assert (rd.width, rd.height, rd.nchannels) == (96, 64, 3)
    np.testing.assert_array_equal(rd.read(40, 8), img[40:48])
    np.testing.assert_array_equal(rd.read(0, 1), img[0:1])
    np.testing.assert_array_equal(rd.line_store().read_window(10, 12, 0, 96),
                                  img[10:12])
    rd.close()

    wr = exr_line_writer(str(tmp_path / "short.exr"), 8, 8, 3)
    wr.write(ramp(4, 8))
    with pytest.raises(IOError):
        wr.close()


def smooth_equirect(w=128, h=64):
    lon = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    lat = (np.arange(h) + 0.5) / h * math.pi - math.pi / 2
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.5 + 0.4 * np.sin(3 * lon[None, :]) * np.cos(lat[:, None])
    img[..., 1] = 0.5 + 0.4 * np.cos(2 * lat[:, None])
    img[..., 2] = 0.5 + 0.4 * np.sin(lat[:, None])
    return img


def _plan_and_sources(pkg):
    """A 64x32 rectilinear view (hfov 100, yaw 30, pitch 10) of a smooth
    128x64 equirect at degree 3, built with ``pkg``'s modules."""
    import importlib
    Projection = importlib.import_module(
        f"{pkg}.core.conventions").Projection
    Facet = importlib.import_module(f"{pkg}.core.facet").Facet
    metrics = importlib.import_module(f"{pkg}.core.metrics")
    E = importlib.import_module(f"{pkg}.models.environment")
    Args = importlib.import_module(f"{pkg}.runtime.args").Args
    build_plan = importlib.import_module(f"{pkg}.runtime.render").build_plan

    w, h = 128, 64
    fct = Facet(facet_no=0, nchannels=3)
    fct.set_geometry(Projection.SPHERICAL, w, h, 2 * math.pi)
    fct.step = metrics.get_step(Projection.SPHERICAL, w, h, 2 * math.pi)
    fct.process_geometry()
    kw = {"device": "cpu"} if pkg.endswith("torch") else {}
    src = E.make_mount_source(fct, smooth_equirect(w, h), 3, 3, **kw)
    args = Args()
    args.projection = Projection.RECTILINEAR
    args.width, args.height = 64, 32
    args.hfov = math.radians(100)
    args.extent = metrics.get_extent(args.projection, 64, 32, args.hfov)
    args.step = (args.extent.x1 - args.extent.x0) / 64
    args.yaw, args.pitch = math.radians(30), math.radians(10)
    args.spline_degree = args.prefilter_degree = 3
    args.nchannels = 3
    args.facets = [fct]
    return build_plan(args, [fct]), [src]


def test_render_to_store_matches_the_frame_and_jax(tmp_path):
    """Strips of 12 rows (the tail strip moved up to end at the last row)
    into a TileStore, and one strip into an EXR scanline store, equal
    the port's whole frame bit for bit, and the JAX package's
    ``render_to_store`` to the exact path's 1e-5."""
    from envutil_tpu_torch.runtime.render import render_frame
    plan, sources = _plan_and_sources("envutil_tpu_torch")
    ref = render_frame(plan, sources, device="cpu")
    assert ref.shape == (32, 64, 3)
    with TileStore(tmp_path / "out", "w", shape=(32, 64, 3),
                   tile_shape=(16, 16), max_resident=4) as st:
        render_to_store(plan, sources, st, strip_rows=12, device="cpu")
    got = TileStore(tmp_path / "out", "r").read_window(0, 32, 0, 64)
    np.testing.assert_array_equal(got, ref)

    path = str(tmp_path / "out.exr")
    wr = exr_line_writer(path, 64, 32, 3)
    render_to_store(plan, sources, wr.line_store(), strip_rows=32,
                    device="cpu")
    wr.close()
    np.testing.assert_array_equal(pio.read_image(path), ref)

    jplan, jsources = _plan_and_sources("envutil_tpu")
    with jtiles.TileStore(tmp_path / "jax", "w", shape=(32, 64, 3),
                          tile_shape=(16, 16)) as st:
        jtiles.render_to_store(jplan, jsources, st, strip_rows=12)
    want = jtiles.TileStore(tmp_path / "jax", "r").read_window(0, 32, 0, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="store shape"):
        render_to_store(plan, sources, LineStore(64, 31, 3), device="cpu")
