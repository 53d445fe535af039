"""source_build_ms: host milliseconds around building every source of
the configuration from its image (models/environment.make_mount_source:
the upload and the prefilter; the table stored as --coeff asks),
synchronised."""


def read(run):
    return run.setup.get("source_build_ms")
