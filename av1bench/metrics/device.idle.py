"""Share of the window in which the card ran no kernel, copy or memset:
1 minus the union of the profiler's device intervals (every
session's, on the host's monotonic clock) over the window, %.  None
where the sessions' intervals were not shown to share one clock."""


def read(rec):
    d = rec["device"]
    if not d["clock_ok"] or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / rec["window_s"])
