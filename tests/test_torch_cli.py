"""The port's CLI (``envutil-torch``) on a small float TIFF writes the
image its library call renders."""

import io
import math
import sys

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import FACE_NAMES, Projection
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.runtime import cli, serve, visor
from envutil_tpu_torch.runtime.args import parse_args
from envutil_tpu_torch.runtime.loader import load_source
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)


def _equirect(w=128, h=64):
    lon = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    lat = (np.arange(h) + 0.5) / h * math.pi - math.pi / 2
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.5 + 0.4 * np.sin(3 * lon[None, :]) * np.cos(lat[:, None])
    img[..., 1] = 0.5 + 0.4 * np.cos(2 * lat[:, None])
    img[..., 2] = 0.5 + 0.4 * np.sin(lat[:, None])
    return img


def test_cli_writes_the_library_render(tmp_path, monkeypatch):
    src_path = tmp_path / "env.tif"
    imgio.save_image(str(src_path), _equirect())
    argv = ["--facet", str(src_path), "spherical", "360", "10", "0", "0",
            "--projection", "cubemap", "--hfov", "90", "--width", "32",
            "--degree", "3", "--twine", "0", "--output", str(tmp_path / "cm.tif")]
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    assert cli.main(list(argv)) == 0
    written = imgio.read_image(str(tmp_path / "cm.tif"))

    args = parse_args(argv)
    args.twine_setup()
    assert args.projection == Projection.CUBEMAP
    plan = build_plan(args, args.facets)
    lib = render_frame(plan, [load_source(args.facets[0], args, "cpu")],
                       device="cpu")
    assert written.shape == lib.shape == (192, 32, 3)
    np.testing.assert_array_equal(written, lib)


def test_cli_renders_cubemap_stripe_and_face_series(tmp_path, monkeypatch):
    """A 1:6 cubemap stripe and the same faces as a ``%s`` series render
    back to an equirect through the CLI, identically, and as the library
    call does."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    env = tmp_path / "env.tif"
    imgio.save_image(str(env), _equirect())
    stripe = tmp_path / "cm.tif"
    assert cli.main(["--facet", str(env), "spherical", "360", "0", "0", "0",
                     "--projection", "cubemap", "--hfov", "90", "--width",
                     "32", "--twine", "0", "--output", str(stripe)]) == 0
    faces = imgio.read_image(str(stripe)).reshape(6, 32, 32, 3)
    for name, face in zip(FACE_NAMES, faces):
        imgio.save_image(str(tmp_path / f"face_{name}.tif"), face)
    written = []
    for facet in (str(stripe), str(tmp_path / "face_%s.tif")):
        out = tmp_path / f"eq{len(written)}.tif"
        argv = ["--facet", facet, "cubemap", "90", "0", "0", "0",
                "--projection", "spherical", "--hfov", "360", "--width",
                "64", "--degree", "3", "--twine", "0", "--output", str(out)]
        assert cli.main(list(argv)) == 0
        written.append(imgio.read_image(str(out)))
    assert written[0].shape == (32, 64, 3)
    np.testing.assert_array_equal(written[0], written[1])

    args = parse_args(argv)
    args.twine_setup()
    plan = build_plan(args, args.facets)
    lib = render_frame(plan, [load_source(args.facets[0], args, "cpu")],
                       device="cpu")
    np.testing.assert_array_equal(written[1], lib)


def test_cli_downscale_twines_automatically(tmp_path, monkeypatch):
    """A downscale without ``--twine 0``: ``twine_setup`` switches
    twining on from the magnification, and the CLI writes what the
    library renders with that spread, which differs from the untwined
    render."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    src_path = tmp_path / "env.tif"
    imgio.save_image(str(src_path), _equirect(256, 128))
    out = tmp_path / "view.tif"
    argv = ["--facet", str(src_path), "spherical", "360", "30", "10", "0",
            "--projection", "rectilinear", "--hfov", "100", "--width", "48",
            "--height", "32", "--degree", "1", "--output", str(out)]
    assert cli.main(list(argv)) == 0
    written = imgio.read_image(str(out))

    args = parse_args(argv)
    args.twine_setup()
    assert args.twine >= 2 and len(args.twine_spread) == args.twine ** 2
    plan = build_plan(args, args.facets)
    assert plan.spread is not None
    source = load_source(args.facets[0], args, "cpu")
    np.testing.assert_array_equal(
        written, render_frame(plan, [source], device="cpu"))
    untwined = parse_args(argv + ["--twine", "0"])
    untwined.twine_setup()
    plain = render_frame(build_plan(untwined, untwined.facets), [source],
                         device="cpu")
    assert written.shape == plain.shape == (32, 48, 3)
    assert float(np.abs(written - plain).max()) > 1e-4


def test_cli_uncovered_modes_raise(tmp_path, monkeypatch):
    """No mode raises any more: streaming and serve run their loops
    (stubbed out here; tests/test_torch_cli_stream.py renders through
    them); --mesh 4 writes the image the job without it writes, bit for
    bit, and with --shard_table to the ring's 4e-7
    (tests/test_torch_mesh_ring.py); --shard_table without --mesh is
    ignored, as in the JAX CLI; EXR works;
    --single, --split and --mask_for render: a facet re-created at its
    own geometry, one file per facet but the solo one, and a one-channel
    mask of the facet's coverage."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    monkeypatch.setattr(serve, "render_loop", lambda **kw: None)
    monkeypatch.setattr(visor, "render_loop", lambda **kw: None)
    for tail in ("-", "+", "++"):
        assert cli.main(["--input", "x.tif", tail]) == 0
    src_path = tmp_path / "env.tif"
    imgio.save_image(str(src_path), _equirect())
    one = ["--facet", str(src_path), "spherical", "360", "0", "0", "0",
           "--twine", "0", "--output"]
    assert cli.main(one + [str(tmp_path / "o.tif")]) == 0
    plain = imgio.read_image(str(tmp_path / "o.tif"))
    for i, (flag, tol) in enumerate(((["--mesh", "4"], 0.0),
                                     (["--mesh", "4", "--shard_table"], 4e-7),
                                     (["--shard_table"], 0.0))):
        out = str(tmp_path / f"o{i}.tif")
        assert cli.main(one + [out] + flag) == 0
        np.testing.assert_allclose(imgio.read_image(out), plain, rtol=tol,
                                   atol=tol)
    view = tmp_path / "view.tif"
    imgio.save_image(str(view), _equirect(48, 32))
    job = ["--facet", str(src_path), "spherical", "360", "0", "0", "0",
           "--facet", str(view), "rectilinear", "60", "20", "0", "0",
           "--projection", "spherical", "--hfov", "360", "--width", "64",
           "--twine", "0"]
    assert cli.main(job + ["--solo", "0", "--single", "1", "--output",
                           str(tmp_path / "s.tif")]) == 0
    assert imgio.read_image(str(tmp_path / "s.tif")).shape == (32, 48, 3)
    assert cli.main(job + ["--solo", "0", "--split",
                           str(tmp_path / "split_%d.tif")]) == 0
    assert not (tmp_path / "split_0.tif").exists()
    np.testing.assert_array_equal(
        imgio.read_image(str(tmp_path / "split_1.tif")),
        imgio.read_image(str(tmp_path / "s.tif")))
    assert cli.main(job + ["--mask_for", "1", "--nchannels", "1",
                           "--output", str(tmp_path / "m.tif")]) == 0
    mask = imgio.read_image(str(tmp_path / "m.tif"))
    assert mask.shape == (32, 64, 1) and set(np.unique(mask)) <= {0.0, 1.0}
    assert 0 < mask.mean() < 0.5
    # EXR no longer raises: the mask round-trips through the native shim
    imgio.save_image(str(tmp_path / "m.exr"), mask)
    np.testing.assert_array_equal(imgio.read_image(str(tmp_path / "m.exr")),
                                  mask)
