"""frame_roofline: the least time of one frame's work
(counts/frame_roofline.py, from the reference's coordinates against the
data-sheet peaks) as a share of the device time of all of a frame's
kernels, memsets and copies in the traced span."""


def read(run):
    t = run.trace
    c = run.counts.get("frame_roofline")
    if not t or not c or not t.get("device_ms_per_frame"):
        return None
    return 100.0 * c["least_ms"] / t["device_ms_per_frame"]
