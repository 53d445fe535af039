"""The port's shared-memory tethered mode (``runtime/visor.py``, the JAX
package's tests/test_visor.py mirrored): rotating frame buffers over
POSIX shared memory, the bounded frame queue's back-pressure, the
spec_t timing pipeline, a bad job that keeps the server serving, buffer
rotation, a client that vanishes holding buffers, and the production
render function (``card_render_fn``, here on the CPU) against
``to_screen(render_frame(...))``. Each server has its own socket under
the test's directory and its own shared-memory prefix; every join and
receive has a timeout."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from envutil_tpu_torch.runtime import visor

torch.set_num_threads(1)


def _start_server(render_fn, tmp_path, **kw):
    sock = str(tmp_path / "visor.sock")
    srv = visor.VisorServer(render_fn, sock, width=64, height=32,
                            shm_prefix=f"eutorch_{os.getpid()}_"
                                       f"{tmp_path.name}", **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    for _ in range(200):
        if (tmp_path / "visor.sock").exists():
            break
        th.join(0.02)
    return srv, th, sock


def _stop(cl, th):
    cl.shutdown()
    th.join(timeout=10)
    assert not th.is_alive(), "server did not shut down"
    cl.close()


def _checker(spec):
    """A frame whose pixels encode the serial_no."""
    return np.full((32, 64), int(spec["serial_no"]), np.uint32)


def _shm_names(srv):
    return [f"/dev/shm/{s.name.lstrip('/')}" for s in srv.store.shm]


def test_visor_frames_and_timing(tmp_path):
    srv, th, sock = _start_server(_checker, tmp_path)
    cl = visor.VisorClient(sock, timeout=10.0)
    assert cl.hello["nframes"] == visor.NFRAMES
    assert cl.hello["hello"] == "envutil_tpu_torch visor"
    for _ in range(7):
        cl.submit({"width": 64, "height": 32})
    seen = []
    for _ in range(7):
        hdr, px = cl.next_frame()
        assert px.shape == (32, 64)
        assert int(px[0, 0]) == hdr["serial_no"]
        seen.append(hdr["serial_no"])
        stamps = [hdr[k] for k in visor.TIMING_STAGES if k in hdr]
        assert len(stamps) >= 5
        assert all(b >= a for a, b in zip(stamps, stamps[1:]))
        assert visor.print_timing(hdr)
    assert seen == list(range(1, 8))
    shm = _shm_names(srv)
    _stop(cl, th)
    # the server unlinks its segments: nothing is left in /dev/shm
    assert not any(os.path.exists(p) for p in shm)


def test_visor_back_pressure(tmp_path):
    """The render thread runs at most FRAME_QUEUE_DEPTH frames ahead of
    the consumer (visor.h:608); consuming frames drains the queue."""
    rendered = []

    def count(spec):
        rendered.append(spec["serial_no"])
        return np.zeros((32, 64), np.uint32)

    srv, th, sock = _start_server(count, tmp_path)
    cl = visor.VisorClient(sock, timeout=10.0)
    for _ in range(10):
        cl.submit({})
    time.sleep(0.5)
    assert len(rendered) <= visor.FRAME_QUEUE_DEPTH
    for _ in range(10):
        cl.next_frame()
    assert len(rendered) == 10
    _stop(cl, th)


def test_visor_bad_job_keeps_serving(tmp_path):
    def flaky(spec):
        if spec.get("boom"):
            raise ValueError("no such facet")
        return np.ones((32, 64), np.uint32)

    srv, th, sock = _start_server(flaky, tmp_path)
    cl = visor.VisorClient(sock, timeout=10.0)
    cl.submit({"boom": True})
    with pytest.raises(RuntimeError, match="no such facet"):
        cl.next_frame()
    cl.submit({})
    hdr, px = cl.next_frame()
    assert px[0, 0] == 1
    _stop(cl, th)


def test_visor_buffer_rotation(tmp_path):
    """Buffers come from a free stack of NFRAMES and are reused only after
    release (store_t, visor.h:177-228)."""
    srv, th, sock = _start_server(_checker, tmp_path)
    cl = visor.VisorClient(sock, timeout=10.0)
    used = set()
    for _ in range(visor.NFRAMES * 3):
        cl.submit({})
        hdr, _px = cl.next_frame()
        used.add(hdr["buffer"])
    assert used <= set(range(visor.NFRAMES))
    _stop(cl, th)


def test_visor_disconnect_with_held_buffers(tmp_path):
    """A client that vanishes holding every pipeline slot does not
    deadlock the render thread; the next connection is served."""
    srv, th, sock = _start_server(_checker, tmp_path)
    c1 = visor.VisorClient(sock, timeout=10.0)
    for i in range(visor.FRAME_QUEUE_DEPTH + 2):
        c1.submit({"job": i})
    for _ in range(visor.FRAME_QUEUE_DEPTH):
        assert "buffer" in visor._recv_msg(c1.conn)
    c1.close()
    c2 = visor.VisorClient(sock, timeout=10.0)
    c2.submit({"job": "again"})
    hdr, px = c2.next_frame()
    assert px[0, 0] == hdr["serial_no"]
    _stop(c2, th)


def test_card_render_fn_through_the_server(tmp_path):
    """The production render function (the serve job handler) on the
    CPU: the frames the server hands over equal ``to_screen`` of the
    port's ``render_frame`` of the same job, and a job naming a missing
    file is answered while the server keeps serving."""
    import functools

    from envutil_tpu_torch.runtime import serve
    from envutil_tpu_torch.runtime.args import parse_args
    from envutil_tpu_torch.runtime.loader import load_source
    from envutil_tpu_torch.runtime.render import build_plan, render_frame
    from test_torch_serve import _env_exr

    env = _env_exr(tmp_path / "env.exr")
    fn = functools.partial(visor.card_render_fn, device="cpu")
    srv, th, sock = _start_server(fn, tmp_path)
    cl = visor.VisorClient(sock, timeout=10.0)
    specs = [{"args": ["--input", env], "width": 64, "height": 32,
              "yaw": yaw, "hfov": 75.0} for yaw in (0.0, 120.0)]
    for spec in specs:
        cl.submit(spec)
    for spec in specs:
        hdr, px = cl.next_frame()
        args = parse_args(serve.job_argv(spec))
        args.twine_setup()
        plan = build_plan(args, args.facets)
        img = render_frame(plan, [load_source(args.facets[0], args, "cpu")],
                           device="cpu")
        np.testing.assert_array_equal(px, serve.to_screen(img))
    cl.submit({"args": ["--input", str(tmp_path / "missing.exr")],
               "width": 64, "height": 32})
    with pytest.raises(RuntimeError, match="missing.exr"):
        cl.next_frame()
    cl.submit(specs[0])
    assert cl.next_frame()[1].shape == (32, 64)
    _stop(cl, th)
