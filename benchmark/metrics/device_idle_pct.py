"""device_idle_pct: the share of the traced span in which no kernel,
memset or copy ran on the card, from the profiler's (CUPTI) device
timeline."""


def read(run):
    t = run.trace
    if not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
