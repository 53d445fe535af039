"""Spans at the port's layer boundaries, kept in memory while recording
is on.

A span is a name, its start and end on the host
(``time.perf_counter_ns``), the span that was open around it when it
began (its parent) and the frame it belongs to: each ``frame_tensor``
span takes the next frame number and the spans inside it carry it.
The sites, one a layer boundary:

- ``frame_tensor``: ``runtime/fastpath.frame_tensor``, the whole call;
- a kernel wrapper's name: each wrapper of ``ops/resample.py`` with a
  ``.launches`` counter, from entry to return (checks, operands, the
  ctypes call, or the plain version on the CPU);
- ``operands_build``, ``block_list_build``, ``champion_planes_build``:
  the build branches of ``fastpath._operands``, ``block_list`` and
  ``champion_planes`` (a plan's cache hit records nothing);
- ``make_mount_source`` (``models/environment``) and inside it
  ``upload``, the image's copy to the device.

Recording is off until ``enable()``. While it is off a site costs one
test of ``on``::

    s = SP.begin("name") if SP.on else -1
    try:
        ...
    finally:
        if s >= 0:
            SP.end(s)

The buffer holds ``CAPACITY`` spans; a span that does not fit is
counted in ``dropped`` and not recorded. ``drain()`` returns the spans
as chrome-trace "X" events (``ts`` and ``dur`` in microseconds, the
parent's place in the list and the frame under ``args``) and empties
the buffer. To put them on a ``torch.profiler`` trace's clock, call
``mark_clock(device)`` while the profiler records: it brackets a few
calls that the trace records (``cudaDeviceSynchronize`` on an idle
card; a ``record_function`` range on the CPU) with ``perf_counter_ns``.
``clock_offset(trace_events)`` finds those calls in the exported trace
and returns the offset that takes a span's host microseconds to the
trace's, with its error bound; ``drain(offset_us)`` applies it.

One thread records: spans of threads that render at the same time
would nest into each other.
"""

from __future__ import annotations

import os
import threading
import time

# 2,000 frames of up to 16 spans
CAPACITY = 1 << 15
# calls bracketed by one mark_clock
MARKS = 8
MARK_NAME = "envutil_clock_mark"

on = False
dropped = 0
# [name, start_ns, end_ns, parent, frame] a span; end_ns 0 while open
_spans = []
_open = []
_frames = 0
# (device type, [(before_ns, after_ns) a bracketed call]) a mark_clock
_marks = []
_clock = time.perf_counter_ns


def enable():
    """Start recording."""
    global on
    on = True


def disable():
    """Stop recording; spans still open are ended by their sites."""
    global on
    on = False


def begin(name: str, frame: bool = False) -> int:
    """Open a span; its index for ``end``, or -1 where the buffer is
    full. ``frame`` starts the next frame."""
    global dropped, _frames
    if frame:
        _frames += 1
    i = len(_spans)
    if i >= CAPACITY:
        dropped += 1
        return -1
    parent = _open[-1] if _open else -1
    at = _frames if frame else (_spans[parent][4] if _open else -1)
    _spans.append([name, 0, 0, parent, at])
    _open.append(i)
    _spans[i][1] = _clock()
    return i


def end(i: int):
    """Close span ``i`` (and any span opened inside it and left open)."""
    t = _clock()
    _spans[i][2] = t
    del _open[_open.index(i):]


def drain(offset_us: float = 0.0) -> list:
    """The recorded spans as chrome-trace "X" events, ``offset_us``
    added to each host time (``clock_offset``); empties the buffer and
    the clock's marks, and the next frame is frame 1 again. Raises while
    a span is open."""
    global _frames
    if _open:
        raise RuntimeError(f"{len(_open)} spans are still open")
    pid, tid = os.getpid(), threading.get_native_id()
    out = [dict(ph="X", cat="user_annotation", name=name,
                ts=t0 * 1e-3 + offset_us, dur=(t1 - t0) * 1e-3, pid=pid,
                tid=tid, args=dict(parent=parent, frame=frame))
           for name, t0, t1, parent, frame in _spans]
    _spans.clear()
    _marks.clear()
    _frames = 0
    return out


def mark_clock(device) -> None:
    """Bracket ``MARKS`` calls that a running ``torch.profiler`` trace
    records with ``perf_counter_ns``, for ``clock_offset``: on a card
    ``torch.cuda.synchronize`` (``cudaDeviceSynchronize``; the first
    idles the card, so that the others return at once), on the CPU a
    ``record_function`` range named ``MARK_NAME``."""
    import torch

    kind = torch.device(device).type
    group = []
    for _ in range(MARKS):
        t0 = _clock()
        if kind == "cuda":
            torch.cuda.synchronize(device)
        else:
            with torch.profiler.record_function(MARK_NAME):
                pass
        group.append((t0, _clock()))
    _marks.append((kind, group))


def _bounds(hits, group):
    """(lowest, highest) offset that puts each (ts, dur) of ``hits``
    inside its (before_ns, after_ns) bracket of ``group``."""
    return (max(ts + dur - t1 * 1e-3
                for (ts, dur), (_t0, t1) in zip(hits, group)),
            min(ts - t0 * 1e-3
                for (ts, _dur), (t0, _t1) in zip(hits, group)))


def clock_offset(events):
    """(offset_us, error_us): the offset that takes a span's host
    microseconds onto the clock of the chrome-trace ``events``, and its
    error bound; None where the trace's events of the marked call hold
    no fit. A bracketed call's event lies inside its bracket, so the
    offset lies in [ts + dur - after, ts - before]. Each ``mark_clock``
    takes a run of consecutive events of its call, in order (the trace
    may hold others, as the profiler's own synchronisation), such that
    one offset fits every bracket; of those fits the narrowest is kept.
    The offset is its middle, the error half its width."""
    if not _marks:
        return None
    name = "cudaDeviceSynchronize" if _marks[0][0] == "cuda" else MARK_NAME
    hits = sorted((float(e["ts"]), float(e.get("dur", 0.0)))
                  for e in events
                  if e.get("ph") == "X" and e.get("name") == name)
    fits = []

    def fit(g, start, lo, hi):
        if g == len(_marks):
            fits.append((lo, hi))
            return
        group = _marks[g][1]
        for k in range(start, len(hits) - len(group) + 1):
            a, b = _bounds(hits[k:k + len(group)], group)
            if max(lo, a) <= min(hi, b):
                fit(g + 1, k + len(group), max(lo, a), min(hi, b))

    fit(0, 0, float("-inf"), float("inf"))
    if not fits:
        return None
    lo, hi = min(fits, key=lambda f: f[1] - f[0])
    return 0.5 * (lo + hi), 0.5 * (hi - lo)
