"""The port's CLI (``envutil-torch``) on a small float TIFF writes the
image its library call renders."""

import math

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection
from envutil_tpu_torch.io import imgio
from envutil_tpu_torch.runtime import cli
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


def test_cli_uncovered_modes_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match="streaming"):
        cli.main(["--input", "x.tif", "-"])
    src_path = tmp_path / "env.tif"
    imgio.save_image(str(src_path), _equirect())
    with pytest.raises(NotImplementedError, match="mesh"):
        cli.main(["--facet", str(src_path), "spherical", "360", "0", "0",
                  "0", "--output", str(tmp_path / "o.tif"), "--mesh", "2"])
    with pytest.raises(NotImplementedError, match="EXR"):
        imgio.read_image(str(tmp_path / "x.exr"))
