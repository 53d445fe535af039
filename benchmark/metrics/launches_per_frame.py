"""launches_per_frame: the kernel wrappers' own launch counters
(``<wrapper>.launches`` in ops/resample.py, every one of them), summed
over the measured window and divided by its frames."""


def read(run):
    w = run.window
    return w["launches"] / w["frames"] if w.get("frames") else None
