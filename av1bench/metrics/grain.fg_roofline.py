"""The film-grain kernel's least device time (``roofline.py``'s bound of
each ``fg`` call) over the device time the profiler read for it
(``fg_kernel``), %: both over the sample of the cell's own traffic that
every session sends after the window (``harness.roofline_sample``)."""


def read(rec):
    r = rec["roofline"]
    if not r:
        return None
    took = r["kernel_ms"].get("fg_kernel", 0.0)
    need = r["bound_ms"].get("fg_kernel", 0.0)
    return 100.0 * need / took if took > 0 and need > 0 else None
