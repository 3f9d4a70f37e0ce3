"""Pass-1 residual launch and pass 2, host tier (counterparts of
dav1d_tpu/pipeline._launch_residuals_native and _run_pass2_native
without their device branches).

The reference's functions consult its dispatch, which imports jax and
picks jax device tiers (MC, itx, intra) on an accelerator; the port
owns both steps, so its pass 2 is always the arena-driven native replay
on the host C tier.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dav1d_tpu.decode.tile import TaskContext
from dav1d_tpu.pipeline import _NativeResiduals, _replay_one

from .ops.itx import itx_batch_c_ptrs


def _launch_residuals_native(f):
    """Group every captured inverse transform per (tx size, tx type)
    straight off the coefficient-meta arena and run each group through
    the native batched itx via a pointer array into the cf arena."""
    glue = f._nat
    meta = glue.meta_rows()
    st = _NativeResiduals(meta.shape[0])
    if meta.shape[0] == 0:
        return st
    valid = np.flatnonzero(meta[:, 0] >= 0)
    if valid.size == 0:
        return st
    key = (meta[valid, 2].astype(np.int64) >> 8 << 16) | meta[valid, 1]
    # secondary sort by eob: clusters sparse blocks into the same
    # 8-lane SIMD groups so the native itx's all-zero-row skip bites
    # (groups still cut on the (tx, txtp) part of the key only)
    eob = np.minimum(meta[valid, 0].astype(np.int64), 0x7FF)
    order = np.argsort(key << 11 | eob, kind="stable")
    sk = key[order]
    cuts = np.flatnonzero(np.diff(sk)) + 1
    cf_base = glue.cf_arena.ctypes.data
    # host itx emits int16 residuals for bd <= 10; 12-bit IDTX needs int32
    st.elsz = 2 if f.bitdepth <= 10 else 4
    for idxs in np.split(valid[order], cuts):
        m0 = meta[idxs[0]]
        gtx, gtxtp = int(m0[2]) >> 8, int(m0[1])
        ptrs = (cf_base +
                meta[idxs, 5].astype(np.int64) * 4).astype(np.uint64)
        st._register(idxs, itx_batch_c_ptrs(ptrs, gtx, gtxtp, f.bitdepth,
                                            eob=meta[idxs, 0]))
    return st


def run_pass2(f, st) -> None:
    """Arena-driven pass 2 with the residuals ``st`` computed in pass 1:
    native phase-A inter replay with the residual adds, then the native
    phase-B ordered intra walk; Python replays only the blocks C reports
    back (scaled references, intrabc, interintra, consistency stops)."""
    from dav1d_tpu.native import lib as _nlib

    glue = f._nat
    t = TaskContext(f)
    t.pass_ = 2
    n = int(glue.c.n_blocks)
    if n == 0:
        return
    rc = glue.build_replay_ctx(st.ptrs, st.elsz)
    ic = glue.build_inter_ctx()

    # phase A: order-free inter predictions + residual adds.  Walks are
    # ranged per tile slice: parallel pass 1 leaves zeroed gap rows
    # between slices that must never be visited (serial mode is one
    # range).
    ranges = glue.block_ranges()
    skipped = np.empty(n, dtype=np.int64)
    ns = 0
    for s, e in ranges:
        if s < e:
            ns += int(_nlib.dtpu_inter_replay(
                ctypes.byref(rc), ctypes.byref(ic), s, e, 1,
                skipped.ctypes.data + 8 * ns, None))
    for bi in skipped[:ns]:
        _replay_one(t, glue.build_record(int(bi), st.resid_of_meta))

    # phase B: ordered intra walk, stopping at blocks needing Python.
    # Per-tile ranges are a valid order: intra prediction never crosses
    # tile boundaries.
    for s, e in ranges:
        cursor = s
        while cursor < e:
            k = int(_nlib.dtpu_intra_replay(ctypes.byref(rc), cursor, e))
            cursor += k
            if cursor < e:
                _replay_one(t, glue.build_record(cursor, st.resid_of_meta))
                cursor += 1
