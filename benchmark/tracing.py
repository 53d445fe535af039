"""The traced span of a ``--trace 1`` run and its reduction.

After the measured window, ``traced_span`` renders a fixed number of
frames more, as the window does, under ``torch.profiler``. On the card
it records the CUDA activities alone (CUPTI: the device's kernels,
memsets and copies, and the host's CUDA runtime calls) and no host
operations: recording each of the program's PyTorch operations lengthens
the host's share of a frame and shows as device idle that the untraced
window does not have. On the CPU (the tests) it records the host's
operations. The chrome trace goes to a temporary file under ``TMPDIR``,
is read back and deleted. ``reduce`` takes from it:

* ``window_s``: from the first host call of the span to the last device
  operation's end;
* ``busy_s``: the union of the device operations (kernels, memsets,
  copies) over that window;
* ``device_ms_per_frame``: their summed time over the frames traced;
* ``device_ops``: the ten operations that took most device time, by
  name, with their seconds;
* ``idle_gaps``: the device's idle time within the window, summed by
  what the host was doing at the middle of each gap (the innermost
  recorded host call then: ``cudaEventSynchronize`` is the wait for the
  frame in flight; "no recorded host call" is the host's own work
  between CUDA calls, the program's Python and the loop's), the ten
  largest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy", "memset", "memcpy")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
HOST_LOOKBACK = 256


def traced_span(render, device, frames, depth, frames_in_flight,
                warm_frames):
    from torch.profiler import ProfilerActivity, profile, schedule

    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        with profile(activities=_activities(device, ProfilerActivity),
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            frames_in_flight(render, device, frames=warm_frames, depth=depth)
            prof.step()
            rec, _held, _last = frames_in_flight(render, device,
                                                 frames=frames, depth=depth)
            prof.step()
        with open(path) as f:
            events = json.load(f)
        size = os.path.getsize(path)
    finally:
        os.unlink(path)
    out = reduce(events.get("traceEvents", events), rec["frames"])
    out["trace_bytes"] = size
    return out


def _activities(device, kinds):
    """What the profiler records: on the card the CUDA activities alone,
    on the CPU the host's operations."""
    return [kinds.CUDA] if device.type == "cuda" else [kinds.CPU]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _is_device(ev):
    cat = str(ev.get("cat", "")).lower()
    return ev.get("ph") == "X" and cat in DEVICE_CATS


def reduce(events, frames):
    """The span's numbers from chrome-trace ``events`` (times in us) over
    ``frames`` frames."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e.get("name", "?")) for e in events if _is_device(e)]
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", "?")) for e in events
            if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in HOST_CATS
            and not str(e.get("name", "")).startswith("ProfilerStep")]
    first = [s for s, _e, _n in host]
    out = dict(frames=frames, device_ops=[], idle_gaps=[], busy_s=0.0,
               window_s=0.0, device_ms_per_frame=None, device_op_count=0)
    if not first:
        return out
    t0 = min(first)
    t1 = max([e for _s, e, _n in dev] + [e for _s, e, _n in host])
    out["window_s"] = (t1 - t0) * 1e-6
    dev = [(max(s, t0), min(e, t1), n) for s, e, n in dev if e > t0]
    if not dev:
        return out
    busy = _union([(s, e) for s, e, _n in dev])
    out["busy_s"] = sum(e - s for s, e in busy) * 1e-6
    out["device_op_count"] = len(dev)
    out["device_ms_per_frame"] = sum(e - s for s, e, _n in dev) \
        * 1e-3 / max(frames, 1)
    by_name = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    out["device_ops"] = [[n[:160], v] for n, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    host.sort()
    starts = [h[0] for h in host]
    gaps, prev = {}, t0
    for s, e in busy + [(t1, t1)]:
        if s > prev:
            mid = 0.5 * (s + prev)
            # the host spans open at the gap's middle, outermost first;
            # one frame's spans are a few dozen, so look back that far
            at = bisect.bisect_right(starts, mid)
            names = [h[2] for h in host[max(0, at - HOST_LOOKBACK):at]
                     if h[1] >= mid]
            what = " > ".join(names[-2:]) if names else \
                "no recorded host call"
            gaps[what[:160]] = gaps.get(what[:160], 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    out["idle_gaps"] = [[n, v] for n, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:10]]
    return out
