"""first_frame_ms: host milliseconds around the plan's first frame,
synchronised: the per-plan work (the kernel operands, the coverage pass
and the champion planes of a stitch) and the frame. The set-up line on
standard error gives the counters of the passes that ran in it."""


def read(run):
    return run.setup.get("first_frame_ms")
