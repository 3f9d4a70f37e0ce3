"""Frame-buffer pool: recycles the large per-frame numpy allocations.

The reference keeps picture buffers in a refcounted pool
(src/mem.c dav1d_mem_pool_push/pop, include/dav1d/dav1d.h allocator) so a
steady-state decode never returns frame-sized buffers to the OS.  Python
GC gives us lifetimes for free but not memory reuse: a 4K int32 plane is
~33 MB, glibc serves it with fresh mmap'd pages, and first-touch page
faults during reconstruction cost ~45 ms/frame at 4K (measured: touching
every page of a fresh np.zeros costs 52 ms vs 7.6 ms for a warm pooled
buffer + memset).

Design: the pool owns every raw buffer it ever handed out (a bounded
registry of strong references).  Callers get dtype/shape views of a raw
1-D buffer; numpy collapses ``view.base`` to the memory owner, so ANY
surviving view (a cropped output picture a user still holds, a reference
plane in the 8-slot state) keeps the raw buffer's refcount above the
sole-owner threshold and the pool will not reuse it.  No explicit
release call exists or is needed — exactly the lifetime rule the
reference implements with atomics, expressed with CPython refcounts.
"""

import ctypes
import sys
import threading

import numpy as np

# registry cap per size bucket: 8 ref slots + output queue + frames in
# flight; beyond this the oldest sole-owned buffers are dropped to GC
_BUCKET_CAP = 24


def _scan_sole(bucket, sole):
    """Index of the first bucket entry with no references outside the
    bucket (+ the scan's own locals), or -1.  Shared by the real scan
    and the calibration below so both observe the same refcount
    geometry."""
    for i in range(len(bucket)):
        cand = bucket[i]
        if sys.getrefcount(cand) == sole:
            return i
    return -1


def _calibrate():
    """Measure what "sole-owned" reads as under THIS interpreter.  The
    exact in-loop refcount of a view-free buffer depends on CPython
    bytecode details (r5: a hard-coded 4 matched an older interpreter;
    here it reads 3 via the shared scan — the mismatch silently
    disabled all reuse).  Calibrating against a buffer known to have no
    outside views removes the version dependence; a surviving view can
    only ADD references, so the threshold stays exact."""
    bucket = [np.empty(16, np.uint8)]
    for sole in range(2, 10):
        if _scan_sole(bucket, sole) == 0:
            return sole
    raise RuntimeError("bufpool: cannot calibrate sole-owner refcount")


_SOLE = _calibrate()


class BufPool:
    def __init__(self):
        self._lock = threading.Lock()
        self._bufs = {}  # nbytes -> list[np.ndarray(uint8, 1-D)]

    def take(self, shape, dtype, fill=None):
        """A (shape, dtype) array backed by a pooled buffer.  fill=None
        leaves reused memory UNINITIALIZED (np.empty semantics); pass 0
        (np.zeros semantics) or any scalar otherwise."""
        dtype = np.dtype(dtype)
        n = 1
        for s in shape:
            n *= int(s)
        nbytes = n * dtype.itemsize
        if nbytes < (1 << 20):
            # small buffers: fresh-page cost is trivial and pooling
            # them only bloats buckets and scan time — plain numpy
            if fill is None:
                return np.empty(shape, dtype)
            if fill == 0 or fill is False:
                return np.zeros(shape, dtype)
            return np.full(shape, fill, dtype)
        # round the raw size up to a 1/8th-power-of-two granule so
        # near-sized requests (itx residual batches vary per frame)
        # share buckets; waste is <= 12.5%
        g = 1 << (nbytes.bit_length() - 4)
        nbytes = (nbytes + g - 1) & ~(g - 1)
        raw = None
        with self._lock:
            bucket = self._bufs.setdefault(nbytes, [])
            # sole-owned = referenced only by the bucket (+ the scan's
            # locals; threshold calibrated at import): every view a
            # FrameContext, ref slot or user picture holds counts via
            # .base
            i = _scan_sole(bucket, _SOLE)
            if i >= 0:
                raw = bucket[i]
                # move to the back: keeps hot buffers hot
                bucket.append(bucket.pop(i))
            if raw is None:
                raw = np.empty(nbytes, dtype=np.uint8)
                if len(bucket) < _BUCKET_CAP:
                    bucket.append(raw)
                # beyond the cap the buffer stays unpooled (plain GC):
                # an all-pinned bucket must not grow without bound
        arr = raw.view(dtype)[:n].reshape(shape)
        if fill is not None:
            # ndarray.fill is a scalar strided-copy loop (~0.4 GB/s —
            # it showed up at 29% of decode CPU); all-zeros and
            # all-ones-bytes patterns take the libc memset path instead
            iv = int(fill) if dtype.kind in "iub" else None
            if iv == 0 or (fill is False):
                ctypes.memset(arr.ctypes.data, 0, n * dtype.itemsize)
            elif iv == -1 and dtype.kind == "i":
                ctypes.memset(arr.ctypes.data, 0xFF, n * dtype.itemsize)
            else:
                arr.fill(fill)
        return arr

    def clear(self):
        with self._lock:
            self._bufs.clear()


pool = BufPool()


def take(shape, dtype, fill=None):
    return pool.take(shape, dtype, fill)
