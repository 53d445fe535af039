"""Shared-memory tethered serving - the visor protocol.

Counterpart of the JAX package's runtime/visor.py; frames render on
CUDA unless the caller names another device (``card_render_fn``).

The reference's interactive mode couples envutil to a GUI process
('visor') through boost.interprocess shared memory: NFRAMES=5 rotating
desktop-size sRGBA frame buffers with a free-index stack (store_t,
visor.h:177), a job queue and a *bounded* frame queue (depth 3,
visor.h:608) guarded by mutex/condition-variable triplets
(visor.h:295-372), job descriptors carrying a 9-stage timing pipeline
(spec_t, visor.h:76-137), and serial_no==0 as the shutdown job
(visor.h:578).

This module keeps that architecture but splits the planes between
the render host and the GUI: the *data plane* (pixels) lives in POSIX
shared memory (multiprocessing.shared_memory - the renderer packs sRGBA
straight into a donated frame buffer, the GUI maps the same pages),
while the *control plane* (job submit / frame ready / buffer release) is
a Unix socket speaking length-prefixed JSON - replacing named mutexes
with a message stream the Python side can select on. Semantics
preserved:

  * NFRAMES rotating buffers; a buffer is only reused after the client
    releases it (store_t.get/put);
  * at most FRAME_QUEUE_DEPTH rendered-but-unconsumed frames - the
    render thread blocks, providing the back-pressure that paces
    rendering to display speed (render_loop, visor.h:602-631);
  * jobs queue while a frame renders (two-stage pipeline);
  * spec_t timing stamps at each hand-off, printable like
    print_timing (visor.h:104-136);
  * a job with serial_no == 0 shuts the server down.
"""

from __future__ import annotations

import functools
import json
import os
import queue
import socket
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

NFRAMES = 5             # rotating frame buffers (visor.h:177)
FRAME_QUEUE_DEPTH = 3   # bounded pipeline depth (visor.h:608)

# the spec_t timing pipeline (visor.h:76-137), as stamp keys in order
TIMING_STAGES = ("t_submit", "t_job_queued", "t_job_popped",
                 "t_render_start", "t_render_done", "t_pack_done",
                 "t_frame_queued", "t_frame_sent", "t_released")

# the port's own default, so that it never shares a socket with the JAX
# package's server
SOCKET_PATH = os.environ.get("ENVUTIL_VISOR_SOCKET",
                             "/tmp/envutil_tpu_torch_visor.sock")


def print_timing(stamps: dict) -> str:
    """Render the stage-to-stage latencies like the reference's
    spec_t::print_timing (visor.h:104-136)."""
    parts = []
    prev = None
    for k in TIMING_STAGES:
        if k not in stamps:
            continue
        if prev is not None:
            parts.append(f"{k[2:]}: {(stamps[k] - prev) * 1000.0:.2f} ms")
        prev = stamps[k]
    return ", ".join(parts)


class FrameStore:
    """NFRAMES shared-memory sRGBA buffers + a free-index stack
    (store_t, visor.h:177-228). ``get`` blocks while every buffer is
    still with the consumer - part of the back-pressure chain."""

    def __init__(self, prefix: str, width: int, height: int,
                 create: bool):
        self.width, self.height = int(width), int(height)
        self.create = create
        nbytes = self.width * self.height * 4
        self.shm = []
        for i in range(NFRAMES):
            name = f"{prefix}_{i}"
            if create:
                try:  # clean up stale segments from a dead server
                    shared_memory.SharedMemory(name=name).unlink()
                except FileNotFoundError:
                    pass
                self.shm.append(shared_memory.SharedMemory(
                    name=name, create=True, size=nbytes))
            else:
                try:  # the server owns the segments; don't let this
                    # process's resource tracker try to clean them up
                    seg = shared_memory.SharedMemory(name=name,
                                                     track=False)
                except TypeError:  # Python < 3.13: unregister by hand
                    seg = shared_memory.SharedMemory(name=name)
                    from multiprocessing import resource_tracker
                    resource_tracker.unregister(seg._name,
                                                "shared_memory")
                self.shm.append(seg)
        self._free = queue.LifoQueue()
        if create:
            for i in range(NFRAMES):
                self._free.put(i)

    def view(self, idx: int) -> np.ndarray:
        nbytes = self.width * self.height * 4
        return np.frombuffer(self.shm[idx].buf[:nbytes], np.uint32
                             ).reshape(self.height, self.width)

    def get(self, timeout: Optional[float] = None) -> int:
        return self._free.get(timeout=timeout)

    def put(self, idx: int) -> None:
        self._free.put(idx)

    def reset(self) -> None:
        """Mark every buffer free (new-connection recovery)."""
        self._free = queue.LifoQueue()
        for i in range(NFRAMES):
            self._free.put(i)

    def close(self) -> None:
        for s in self.shm:
            s.close()
            if self.create:
                try:
                    s.unlink()
                except FileNotFoundError:
                    pass


def _recv_msg(conn):
    from .serve import recv_exact
    head = recv_exact(conn, 4)
    if len(head) < 4:
        return None
    (n,) = struct.unpack("<I", head)
    data = recv_exact(conn, n)
    if len(data) < n:
        return None
    return json.loads(data.decode())


def _send_msg(conn, obj):
    data = json.dumps(obj).encode()
    conn.sendall(struct.pack("<I", len(data)) + data)


class VisorServer:
    """The render side of the tethered pipeline: a receiver thread
    queues jobs, the render thread (the only device user) renders each
    job into a free shared-memory buffer and announces it; the client
    releases buffers when displayed. Render-ahead is bounded by
    FRAME_QUEUE_DEPTH outstanding frames *and* NFRAMES buffers, the
    exact two-stage back-pressure of the reference (visor.h:602-631).

    ``render_fn(spec) -> (H, W) uint32 sRGBA array`` is injected so the
    transport is testable without a card (the reference tests visor with
    a dummy render process, visor.h:386-388)."""

    def __init__(self, render_fn, socket_path: str = SOCKET_PATH,
                 width: int = 1920, height: int = 1200,
                 shm_prefix: str = "envutil_torch_visor",
                 verbose: bool = False):
        self.render_fn = render_fn
        self.socket_path = socket_path
        self.store = FrameStore(shm_prefix, width, height, create=True)
        self.shm_prefix = shm_prefix
        self.verbose = verbose
        self._jobs = queue.Queue()
        self._inflight = threading.Semaphore(FRAME_QUEUE_DEPTH)
        self._shutdown = threading.Event()

    def serve_forever(self) -> None:
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        server.bind(self.socket_path)
        server.listen(1)
        if self.verbose:
            print(f"visor server on {self.socket_path} "
                  f"({NFRAMES} x {self.store.width}x{self.store.height}"
                  f" buffers, queue depth {FRAME_QUEUE_DEPTH})")
        try:
            while not self._shutdown.is_set():
                conn, _ = server.accept()
                self._serve_conn(conn)
        finally:
            server.close()
            self.store.close()
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass

    def _serve_conn(self, conn) -> None:
        hello = {"hello": "envutil_tpu_torch visor", "nframes": NFRAMES,
                 "depth": FRAME_QUEUE_DEPTH,
                 "shm_prefix": self.shm_prefix,
                 "width": self.store.width,
                 "height": self.store.height}
        _send_msg(conn, hello)
        send_lock = threading.Lock()
        stop = threading.Event()
        render = threading.Thread(target=self._render_thread,
                                  args=(conn, send_lock, stop),
                                  daemon=True)
        render.start()
        try:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    break
                if "release" in msg:
                    # buffer returns to the free stack (store_t.put)
                    # and its pipeline slot frees: outstanding
                    # rendered-but-unconsumed frames stay <= depth
                    self.store.put(int(msg["release"]))
                    self._inflight.release()
                    continue
                msg["t_job_queued"] = time.time()
                if msg.get("serial_no", 1) == 0:
                    self._shutdown.set()
                    self._jobs.put(None)
                    break
                self._jobs.put(msg)
        finally:
            # wake the render thread even if it is parked waiting for a
            # pipeline slot / free buffer that a dead client will never
            # release, so join() below cannot deadlock
            stop.set()
            self._jobs.put(None)
            render.join()
            conn.close()
            # a client may die holding buffers: reset the pipeline so
            # the next connection starts with all buffers free
            self._jobs = queue.Queue()
            self._inflight = threading.Semaphore(FRAME_QUEUE_DEPTH)
            self.store.reset()

    def _render_thread(self, conn, send_lock, stop) -> None:
        while True:
            spec = self._jobs.get()
            if spec is None:
                return
            spec["t_job_popped"] = time.time()
            # back-pressure: wait for a pipeline slot, then a buffer -
            # with a stop check, since releases only arrive from client
            # messages and the client may be gone
            while not self._inflight.acquire(timeout=0.1):
                if stop.is_set():
                    return
            while True:
                try:
                    idx = self.store.get(timeout=0.1)
                    break
                except queue.Empty:
                    if stop.is_set():
                        self._inflight.release()
                        return
            try:
                spec["t_render_start"] = time.time()
                frame = self.render_fn(spec)
                spec["t_render_done"] = time.time()
                h, w = frame.shape
                view = self.store.view(idx)
                view[:h, :w] = frame
                spec["t_pack_done"] = time.time()
                header = {k: spec[k] for k in spec
                          if k.startswith(("t_", "serial"))}
                header.update(buffer=idx, width=w, height=h,
                              t_frame_queued=time.time())
                with send_lock:
                    _send_msg(conn, header)
            except Exception as exc:   # keep serving on bad jobs
                self.store.put(idx)
                self._inflight.release()
                with send_lock:
                    try:
                        _send_msg(conn, {
                            "serial_no": spec.get("serial_no"),
                            "error": str(exc)})
                    except OSError:
                        return


class VisorClient:
    """The GUI side (the reference's sparring partner, visor.h:386):
    submits jobs, maps the server's shared-memory buffers, and
    releases them after consuming - for tests and for embedding."""

    def __init__(self, socket_path: str = SOCKET_PATH,
                 timeout: float = 120.0):
        self.conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.conn.settimeout(timeout)
        self.conn.connect(socket_path)
        self.hello = _recv_msg(self.conn)
        self.store = FrameStore(self.hello["shm_prefix"],
                                self.hello["width"],
                                self.hello["height"], create=False)
        self._serial = 0

    def submit(self, spec: dict) -> int:
        self._serial += 1
        spec = dict(spec)
        spec["serial_no"] = self._serial
        spec["t_submit"] = time.time()
        _send_msg(self.conn, spec)
        return self._serial

    def next_frame(self):
        """Receive one frame header; returns (header, pixels-copy) and
        releases the buffer. Raises on server-reported job errors."""
        header = _recv_msg(self.conn)
        if header is None:
            raise ConnectionError("server closed")
        if "error" in header:
            raise RuntimeError(header["error"])
        idx = header["buffer"]
        px = self.store.view(idx)[:header["height"],
                                  :header["width"]].copy()
        header["t_frame_sent"] = header.get("t_frame_queued")
        _send_msg(self.conn, {"release": idx})
        header["t_released"] = time.time()
        return header, px

    def shutdown(self) -> None:
        _send_msg(self.conn, {"serial_no": 0})

    def close(self) -> None:
        self.conn.close()
        self.store.close()


def card_render_fn(spec: dict, device=None) -> np.ndarray:
    """Production render_fn: the serve-mode job handler (argv rebuild +
    render_frame on ``device``, CUDA unless named, + sRGBA pack,
    runtime/serve.py handle_job)."""
    from .serve import handle_job
    frame, _timing = handle_job(spec, device)
    return frame


def render_loop(socket_path: str = SOCKET_PATH, verbose: bool = False,
                device=None) -> None:
    """Entry point for `envutil-torch ... ++` (shared-memory tethered
    mode; the socket-transport `+` mode lives in runtime/serve.py)."""
    from .platform import resolve_device
    device = resolve_device(device)
    VisorServer(functools.partial(card_render_fn, device=device),
                socket_path, verbose=verbose).serve_forever()
