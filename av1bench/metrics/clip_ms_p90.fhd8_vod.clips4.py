"""The 90th percentile of the traced window's clip latencies (from the
call that opens a clip's decoder to its last picture), ms:
``clip_ms_p90`` where its spread is too wide for an end-to-end bound
(PERF.md, section 2)."""

import numpy as np


def read(rec):
    ms = rec["clip_ms"]
    return float(np.percentile(ms, 90)) if ms else None
