"""enqueue_ms: host milliseconds of a call into the program's frame route
(runtime/fastpath.frame_tensor), averaged over the frames of the
measured window."""


def read(run):
    ms = run.window.get("enqueue_ms") or []
    return sum(ms) / len(ms) if ms else None
