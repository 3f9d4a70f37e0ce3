"""The program's kernels' least device time (``roofline.py`` on each
call) over the device time the profiler read for those kernels, %: both
over the sample of the cell's own traffic that every session sends after
the window (``harness.roofline_sample``), summed over the sessions."""


def read(rec):
    r = rec["roofline"]
    if not r:
        return None
    took = sum(r["kernel_ms"].values())
    need = sum(r["bound_ms"].get(k, 0.0) for k in r["kernel_ms"])
    return 100.0 * need / took if took > 0 and need > 0 else None
