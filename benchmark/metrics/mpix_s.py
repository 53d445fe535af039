"""mpix_s: output pixels of every frame rendered in the measured window,
divided by the window's seconds on the host clock (from the first call
to the last frame's completion), in millions."""


def read(run):
    w = run.window
    if not w.get("frames") or not w.get("seconds"):
        return None
    return w["frames"] * w["pixels"] / w["seconds"] / 1e6
