"""Host-tier inverse transforms for the port's pass 1 (counterpart of the
host helpers in dav1d_tpu/ops/itx.py: _txinfo, scan_bounds_lut,
itx_batch_c_ptrs).

The JAX module holds these beside its device programs and imports jax
at its top, so the port carries the host helpers over: numpy plus the
native C batch of the port's native/.  The device transform (TPU
ops/itx._itx_core, Pallas ops/pallas_itx) is not ported yet: itx stays
on this host tier.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import tables
from ..bufpool import take as _take
from ..levels import TxfmType
from ..recon.itx import TX1D_TYPES, TX_SHIFT


@functools.lru_cache(maxsize=None)
def _txinfo(tx):
    t_dim = tables.txfm_info()[tx]
    return (4 * int(t_dim[0]), 4 * int(t_dim[1]), int(t_dim[2]),
            int(t_dim[3]))


@functools.lru_cache(maxsize=None)
def scan_bounds_lut(tx):
    """Per-eob inclusive (x, y) bounds of the first eob+1 scan positions
    of a TWO_D-class transform: cummax over the scan order decoded as
    rc = (x << (min(lh,3)+2)) | y (recon/coef.py scan convention)."""
    w, h, lw, lh = _txinfo(tx)
    sh = min(h, 32)
    scan = tables.scans()[tx].astype(np.int64)
    xs = np.maximum.accumulate(scan >> (min(lh, 3) + 2))
    ys = np.maximum.accumulate(scan & (sh - 1))
    return xs.astype(np.uint8), ys.astype(np.uint8)


def itx_batch_c_ptrs(ptrs, tx, txtp, bitdepth, eob=None):
    """Native-C host batch over a uint64 pointer array of coefficient
    blocks in the pass-1 capture arena (ops/itx.itx_batch_c_ptrs).
    Residuals come back int16 for bitdepth <= 10 and int32 at 12-bit
    (12-bit IDTX exceeds int16)."""
    from ..native import lib as _nlib

    n = len(ptrs)
    w, h, lw, lh = _txinfo(tx)
    i16 = bitdepth <= 10
    fn = _nlib.dtpu_itx_batch_ptrs_b16 if i16 \
        else _nlib.dtpu_itx_batch_ptrs_b
    out = _take((n, h, w), np.int16 if i16 else np.int32)
    if txtp == TxfmType.WHT_WHT:
        fn(ptrs.ctypes.data, n, 4, 4, 0, 0, 0, 0, bitdepth, 1, None, None,
           out.ctypes.data)
        return out
    xb = yb = None
    if eob is not None and tables.tx_type_class[txtp] == 0:
        lx, ly = scan_bounds_lut(int(tx))
        xb = np.ascontiguousarray(lx[eob])
        yb = np.ascontiguousarray(ly[eob])
    row_t, col_t = TX1D_TYPES[TxfmType(txtp)]
    is_rect2 = int((w * 2 == h) or (h * 2 == w))
    fn(ptrs.ctypes.data, n, w, h, int(TX_SHIFT[tx]), int(row_t),
       int(col_t), is_rect2, int(bitdepth), 0,
       xb.ctypes.data if xb is not None else None,
       yb.ctypes.data if yb is not None else None, out.ctypes.data)
    return out
