"""The port CLI's job modes beside the single job: streaming (``-``)
against the JAX CLI's streaming output files, the dispatch of ``+``
(serve) and ``++`` (visor) to their loops on the device
``ENVUTIL_PLATFORM`` names, and ``--mesh`` with and without
``--shard_table`` on an EXR job."""

import io
import sys

import numpy as np
import pytest
import torch

from envutil_tpu.runtime import cli as jcli
from envutil_tpu_torch.io import imgio as pio
from envutil_tpu_torch.runtime import cli as pcli
from envutil_tpu_torch.runtime import serve, visor
from test_torch_serve import _env_exr

torch.set_num_threads(1)


def test_streaming_lines_as_jax(tmp_path, monkeypatch, capsys):
    """Two argument lines on stdin after the common arguments: the port
    writes both frames (a cubemap and a yawed view, degree 3) as the JAX
    CLI does, to the exact path's 1e-5, and echoes the lines alike."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    env = _env_exr(tmp_path / "env.exr")
    lines = ("--projection cubemap --width 16 --output {d}/cm.exr\n"
             "\n"
             "--width 40 --height 24 --hfov 70 --yaw 30 --pitch -10 "
             "--output {d}/view.exr\n")
    base = ["--input", env, "--twine", "0", "--degree", "3", "-"]
    out = {}
    for name, cli in (("port", pcli), ("jax", jcli)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines.format(d=d)))
        assert cli.main(list(base)) == 0
        out[name] = capsys.readouterr().out.replace(str(d), "D")
        for f in ("cm.exr", "view.exr"):
            assert (d / f).exists(), (name, f)
    assert out["port"] == out["jax"]
    assert out["port"].rstrip().endswith("pipe has reached EOF")
    for f, shape in (("cm.exr", (96, 16, 3)), ("view.exr", (24, 40, 3))):
        got = pio.read_image(str(tmp_path / "port" / f))
        want = pio.read_image(str(tmp_path / "jax" / f))
        assert got.shape == shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        m = pio.read_image_metadata(str(tmp_path / "port" / f))
        assert m["Projection"] == ("cubemap" if f == "cm.exr"
                                   else "rectilinear")


def test_serve_modes_dispatch_to_their_loops(monkeypatch):
    """``+`` runs the socket loop and ``++`` the shared-memory loop, each
    on the device ``ENVUTIL_PLATFORM`` names; without it they ask for
    CUDA, which raises here before any socket is bound."""
    calls = []
    monkeypatch.setattr(serve, "render_loop",
                        lambda **kw: calls.append(("+", kw)))
    monkeypatch.setattr(visor, "render_loop",
                        lambda **kw: calls.append(("++", kw)))
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    assert pcli.main(["+"]) == 0
    assert pcli.main(["-v", "++"]) == 0
    assert calls == [("+", {"device": "cpu"}),
                     ("++", {"verbose": True, "device": "cpu"})]
    monkeypatch.undo()
    monkeypatch.delenv("ENVUTIL_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the loops would serve")
    for mode in ("+", "++"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main([mode])


def test_mesh_still_raises(tmp_path, monkeypatch, capsys):
    """``--mesh`` no longer raises: ``--mesh 4`` writes the EXR the job
    without it writes, bit for bit, and says so under ``-v``; with
    ``--shard_table`` to the ring's 4e-7 (tests/test_torch_mesh_ring.py);
    ``--mesh 3`` on 16 rows falls back to one device with the JAX
    package's message."""
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    env = _env_exr(tmp_path / "env.exr", 32, 16)
    job = ["--input", env, "--twine", "0", "--width", "32", "--height",
           "16", "--output"]
    assert pcli.main(job + [str(tmp_path / "o.exr")]) == 0
    plain = pio.read_image(str(tmp_path / "o.exr"))
    assert plain.shape[0] == 16
    capsys.readouterr()
    for i, (extra, tol, said) in enumerate((
            (["--mesh", "4", "-v"], 0.0, "4 devices)"),
            (["--mesh", "4", "--shard_table", "-v"], 4e-7,
             "4 devices, ring-sharded tables)"),
            (["--mesh", "3"], 0.0, "--mesh 3: output height 16 not "
                                   "divisible by 3; rendering on one"))):
        out = str(tmp_path / f"o{i}.exr")
        assert pcli.main(job + [out] + extra) == 0
        assert said in capsys.readouterr().out
        np.testing.assert_allclose(pio.read_image(out), plain, rtol=tol,
                                   atol=tol)
