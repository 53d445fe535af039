"""frame_ms_p95: the 95th percentile over every frame of the measured
window of the frame's latency on the host clock: from the call that
enqueues it to the moment its completion event is seen done. With two
frames in flight that includes its wait behind the frame before it, and
any stall of the host between frames."""

import statistics


def read(run):
    ms = run.window.get("latency_ms") or []
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
