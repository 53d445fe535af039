"""setup_s: host seconds from the start of the process to the start of
the measured window: imports, the CUDA context, loading (in a checkout's
first run, building) the kernel libraries, the seeded images, the
sources' prefilter, the plan's first frame and the warm frames."""


def read(run):
    return run.setup.get("setup_s")
