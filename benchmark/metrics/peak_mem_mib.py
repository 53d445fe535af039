"""peak_mem_mib: torch.cuda.max_memory_allocated() over the measured
window, after reset_peak_memory_stats() at its start: the tables, the
plan's operands and champion planes, the frames in flight and the frame
that the check keeps."""


def read(run):
    peak = run.device.get("memory_peak_bytes", 0)
    return peak / 2 ** 20 if peak else None
