"""The port's serve mode (``runtime/serve.py``): ``to_screen`` bit-equal
to the JAX package's, ``handle_job`` against JAX ``handle_job`` on a
tiny EXR source (with and without ``refine``, whose automatic twine
must give JAX's spread), and ``render_loop`` in a thread of this
process: two frames, a bad job answered while the loop keeps serving,
then shutdown. Every receive has a timeout and every thread is joined
with one."""

import json
import math
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from envutil_tpu.runtime import args as jargs
from envutil_tpu.runtime import serve as jserve
from envutil_tpu_torch.io import imgio as pio
from envutil_tpu_torch.runtime import args as pargs
from envutil_tpu_torch.runtime import serve as pserve
from envutil_tpu_torch.runtime.render import build_plan

torch.set_num_threads(1)


def _env_exr(path, w=128, h=64):
    lon = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    lat = (np.arange(h) + 0.5) / h * math.pi - math.pi / 2
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.5 + 0.4 * np.sin(3 * lon[None, :]) * np.cos(lat[:, None])
    img[..., 1] = 0.5 + 0.4 * np.cos(2 * lat[:, None])
    img[..., 2] = (lon[None, :] + math.pi) / (2 * math.pi) \
        * np.ones((h, 1), np.float32)
    pio.save_image(str(path), img, projection_name="spherical",
                   hfov_deg=360.0)
    return str(path)


def test_to_screen_as_jax():
    rng = np.random.default_rng(41)
    for c in (1, 2, 3, 4):
        img = rng.uniform(-0.2, 1.3, (9, 11, c)).astype(np.float32)
        got = pserve.to_screen(img)
        assert got.dtype == np.uint32 and got.shape == (9, 11)
        np.testing.assert_array_equal(got, jserve.to_screen(img))


def _channels(frame):
    return np.stack([(frame >> s) & 0xFF for s in (0, 8, 16, 24)], -1
                    ).astype(np.int32)


@pytest.mark.parametrize("refine", [False, True])
def test_handle_job_as_jax(tmp_path, refine):
    """The packed frame of a job spec, rendered by the port on the CPU
    and by the JAX package: at most one 8-bit code apart in any channel;
    the differing pixels are counted. With ``refine`` the job twines
    automatically (a downscale), with JAX's spread."""
    env = _env_exr(tmp_path / "env.exr")
    spec = {"args": ["--input", env], "width": 48, "height": 32,
            "yaw": 40.0, "pitch": 15.0, "hfov": 80.0, "serial_no": 3}
    if refine:
        spec.update(refine=True, width=24, height=16, hfov=120.0)
    argv = pserve.job_argv(spec)
    assert ("--twine", "-1" if refine else "0") in zip(argv, argv[1:])
    pa, ja = pargs.parse_args(argv), jargs.parse_args(argv)
    pa.twine_setup()
    ja.twine_setup()
    assert [list(t) for t in pa.twine_spread] == \
        [list(t) for t in ja.twine_spread]
    spread = build_plan(pa, pa.facets).spread
    assert (spread is not None and len(spread) > 1) == refine

    got, timing = pserve.handle_job(spec, "cpu")
    want, _ = jserve.handle_job(spec)
    assert got.shape == want.shape == (spec["height"], spec["width"])
    assert timing["t_render"] > 0
    diff = np.abs(_channels(got) - _channels(want))
    assert diff.max() <= 1, diff.max()
    n_diff = int((diff > 0).any(-1).sum())
    assert n_diff <= got.size // 100, n_diff


def _client(path):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(10.0)
    c.connect(path)
    return c


def _send(c, obj):
    d = json.dumps(obj).encode()
    c.sendall(struct.pack("<I", len(d)) + d)


def _recv(c):
    (n,) = struct.unpack("<I", pserve.recv_exact(c, 4))
    hdr = json.loads(pserve.recv_exact(c, n).decode())
    payload = b""
    if "width" in hdr and "error" not in hdr:
        payload = pserve.recv_exact(c, hdr["width"] * hdr["height"] * 4)
    return hdr, payload


def test_render_loop_in_a_thread(tmp_path):
    """The loop in a thread: two frames, a bad job answered, one more
    frame, shutdown. ``recv_exact`` takes a whole 8 MB frame from a
    socket with a timeout, which one ``recv(n, MSG_WAITALL)`` need not."""
    a, b = socket.socketpair()
    a.settimeout(10.0)
    blob = np.random.default_rng(42).bytes(8 << 20)
    sender = threading.Thread(target=b.sendall, args=(blob,), daemon=True)
    sender.start()
    try:
        assert pserve.recv_exact(a, len(blob)) == blob
    finally:
        sender.join(timeout=10)
        a.close()
        b.close()
    assert not sender.is_alive()

    env = _env_exr(tmp_path / "env.exr")
    sock = str(tmp_path / "serve.sock")
    th = threading.Thread(target=pserve.render_loop, args=(sock, "cpu"),
                          daemon=True)
    th.start()
    for _ in range(200):
        if (tmp_path / "serve.sock").exists():
            break
        th.join(0.05)
    c = _client(sock)
    try:
        for serial, yaw in ((1, 90.0), (2, -90.0)):
            spec = {"serial_no": serial, "width": 64, "height": 32,
                    "yaw": yaw, "hfov": 90, "args": ["--input", env]}
            _send(c, spec)
            hdr, payload = _recv(c)
            assert hdr["serial_no"] == serial and hdr["t_render"] > 0
            frame = np.frombuffer(payload, np.uint32).reshape(32, 64)
            np.testing.assert_array_equal(
                frame, pserve.handle_job(spec, "cpu")[0])
            # the centre samples lon = yaw: blue holds (lon + pi) / 2pi
            want = pio.linear_to_srgb(np.float32((yaw / 360.0) + 0.5))
            assert abs(((frame[16, 32] >> 16) & 0xFF) / 255.0 - want) < 0.03
            assert frame[16, 32] >> 24 == 255
        _send(c, {"serial_no": 3, "width": 32, "height": 32,
                  "args": ["--projection", "bogus"]})
        hdr, _ = _recv(c)
        assert hdr["serial_no"] == 3 and "error" in hdr
        _send(c, {"serial_no": 4, "width": 16, "height": 8,
                  "args": ["--input", env]})
        assert _recv(c)[0]["serial_no"] == 4
        _send(c, {"serial_no": 0})
        assert _recv(c)[0] == {"serial_no": 0}
    finally:
        c.close()
    th.join(timeout=10)
    assert not th.is_alive()
    assert not (tmp_path / "serve.sock").exists()
