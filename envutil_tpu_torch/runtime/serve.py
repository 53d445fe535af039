"""Interactive serve mode (the reference's 'tethered' visor protocol,
visor.h + envutil_main.cc:1755-1869).

Counterpart of the JAX package's runtime/serve.py. The reference
renders into shared-memory frame buffers handed over by a GUI process
('visor'), with a bounded frame queue for back-pressure. Here the
transport is a Unix domain socket speaking a small length-prefixed JSON
protocol; the render side keeps facet assets on the device across
frames (the loader's asset cache, ``runtime/assets.py``, holds each
source's table there between requests) and returns packed sRGBA uint32
frames, preserving the pipeline-timing fields of the reference's spec_t
(visor.h:76-137). Jobs render on CUDA unless the caller names another
device.

Protocol (one JSON object per message, little-endian uint32 length
prefix; binary frame payload follows the frame header message):

  client -> server: {"args": [...], "width": W, "height": H,
                     "yaw": deg, "pitch": deg, "roll": deg,
                     "hfov": deg, "serial_no": N}
  server -> client: {"serial_no": N, "width": W, "height": H,
                     "t_in": ..., "t_render": ..., "t_out": ...}
                    + W*H*4 bytes of sRGBA pixels

serial_no == 0 requests shutdown (visor.h:578).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time

import numpy as np

from ..io.imgio import linear_to_srgb
from . import assets
from .args import parse_args
from .loader import load_source
from .platform import resolve_device
from .render import build_plan, render_frame

# the port's own default, so that it never shares a socket with the JAX
# package's server
SOCKET_PATH = os.environ.get("ENVUTIL_SOCKET", "/tmp/envutil_tpu_torch.sock")


def to_screen(img: np.ndarray) -> np.ndarray:
    """float linear (H, W, C) -> packed sRGBA uint32 (to_screen_t,
    envutil_payload.cc:289-413)."""
    h, w, c = img.shape
    if c == 1:
        rgb = np.repeat(img, 3, axis=-1)
        alpha = np.ones((h, w, 1), np.float32)
    elif c == 2:
        rgb = np.repeat(img[..., :1], 3, axis=-1)
        alpha = img[..., 1:2]
    elif c == 3:
        rgb = img
        alpha = np.ones((h, w, 1), np.float32)
    else:
        rgb = img[..., :3]
        alpha = img[..., 3:4]
    srgb = np.clip(linear_to_srgb(rgb) * 255.0 + 0.5, 0, 255
                   ).astype(np.uint32)
    a = np.clip(linear_to_srgb(alpha) * 255.0 + 0.5, 0, 255
                ).astype(np.uint32)
    packed = (a[..., 0] << 24) | (srgb[..., 2] << 16) \
        | (srgb[..., 1] << 8) | srgb[..., 0]
    return packed.astype(np.uint32)


def recv_exact(conn, n: int) -> bytes:
    """``n`` bytes from ``conn``, fewer only where the peer closed. A
    socket with a timeout is non-blocking underneath, and there one
    ``recv(n, MSG_WAITALL)`` may return part of a large frame."""
    parts, got = [], 0
    while got < n:
        part = conn.recv(n - got, socket.MSG_WAITALL)
        if not part:
            break
        parts.append(part)
        got += len(part)
    return b"".join(parts)


def _recv_msg(conn):
    head = recv_exact(conn, 4)
    if len(head) < 4:
        return None
    (n,) = struct.unpack("<I", head)
    data = recv_exact(conn, n)
    return json.loads(data.decode())


def _send_msg(conn, obj, payload: bytes = b""):
    data = json.dumps(obj).encode()
    conn.sendall(struct.pack("<I", len(data)) + data + payload)


def job_argv(spec: dict) -> list:
    """The argument list of a job spec (handle_job,
    envutil_main.cc:1755-1869): the spec's own arguments between the
    defaults and its view, ``--twine -1`` (automatic) where it asks to
    ``refine``."""
    argv = ["--output", spec.get("filename", "none.jpg"),
            "--twine", "-1" if spec.get("refine") else "0",
            "--hfov", "65"]
    argv += [str(a) for a in spec.get("args", [])]
    argv += ["--width", str(spec["width"]), "--height", str(spec["height"]),
             "--yaw", str(spec.get("yaw", 0.0)),
             "--pitch", str(spec.get("pitch", 0.0)),
             "--roll", str(spec.get("roll", 0.0)),
             "--hfov", str(spec.get("hfov", 65.0))]
    if spec.get("brighten", 1.0) != 1.0:
        argv += ["--brighten", str(spec["brighten"])]
    return argv


def handle_job(spec: dict, device=None) -> tuple:
    """Rebuild an argv from the job spec and render one frame on
    ``device`` (CUDA unless named); returns the packed frame and
    {"t_render": ms} (render_frame until the host frame is back)."""
    device = resolve_device(device)
    args = parse_args(job_argv(spec))
    args.tethered = True
    args.twine_setup()
    plan = build_plan(args, args.facets)
    sources = [load_source(args.facets[i], args, device)
               for i in plan.facet_indices]
    t0 = time.perf_counter()
    img = render_frame(plan, sources, verbose=args.verbose, device=device)
    t1 = time.perf_counter()
    frame = to_screen(img)
    assets.conclude_cycle()
    return frame, {"t_render": (t1 - t0) * 1000.0}


def render_loop(socket_path: str = SOCKET_PATH, device=None) -> None:
    """Serve frames until a shutdown job arrives. Bad jobs answer with
    an error message instead of killing the loop (the reference's
    streaming loop dies on errors; for serving we stay up)."""
    device = resolve_device(device)
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(socket_path)
    server.listen(1)
    print(f"envutil_tpu_torch serving on {socket_path} ({device})")
    try:
        while True:
            conn, _ = server.accept()
            try:
                while True:
                    spec = _recv_msg(conn)
                    if spec is None:
                        break
                    if spec.get("serial_no", 1) == 0:
                        _send_msg(conn, {"serial_no": 0})
                        return
                    t_in = time.time()
                    try:
                        frame, timing = handle_job(spec, device)
                    except Exception as exc:  # keep serving on bad jobs
                        _send_msg(conn, {"serial_no": spec.get("serial_no"),
                                         "error": str(exc)})
                        continue
                    header = {"serial_no": spec.get("serial_no"),
                              "width": int(frame.shape[1]),
                              "height": int(frame.shape[0]),
                              "t_in": t_in, "t_out": time.time(), **timing}
                    _send_msg(conn, header, frame.tobytes())
            finally:
                conn.close()
    finally:
        server.close()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass
