"""CDEF: constrained directional enhancement filter, host side.

The unit collection the filter chain runs (``cdef_collect``, reference
src/cdef_apply_tmpl.c dav1d_cdef_brow :100), the direction tables the
device state uploads (state.py), and the batched golden numpy models of
the direction search and the filter (reference src/cdef_tmpl.c
cdef_find_dir_c :239, cdef_filter_block_c :106); the chain filters on
the device (ops/cdef.py).  Every unit reads pre-CDEF (deblocked)
pixels, which matches the reference's top/left/right backup-line scheme
exactly."""

from __future__ import annotations

import numpy as np

INT16_MIN = -32768

# (dy, dx) per [2 + dir + 2][pass] (reference src/tables.c:400
# dav1d_cdef_directions, offsets decomposed from o = dy*12 + dx)
CDEF_DIRECTIONS = [
    ((1, 0), (2, 0)),    # 6
    ((1, 0), (2, -1)),   # 7
    ((-1, 1), (-2, 2)),  # 0
    ((0, 1), (-1, 2)),   # 1
    ((0, 1), (0, 2)),    # 2
    ((0, 1), (1, 2)),    # 3
    ((1, 1), (2, 2)),    # 4
    ((1, 0), (2, 1)),    # 5
    ((1, 0), (2, 0)),    # 6
    ((1, 0), (2, -1)),   # 7
    ((-1, 1), (-2, 2)),  # 0
    ((0, 1), (-1, 2)),   # 1
]

UV_DIRS_420 = list(range(8))
UV_DIRS_422 = [7, 0, 2, 4, 5, 6, 6, 6]


def _constrain(diff, threshold: int, shift: int):
    adiff = np.abs(diff)
    t = adiff >> shift
    np.subtract(threshold, t, out=t)
    np.maximum(t, 0, out=t)
    np.minimum(t, adiff, out=t)
    np.negative(t, out=adiff)
    return np.where(diff < 0, adiff, t)


_SCRATCH = {}


def _scratch(key, shape, dtype=np.int32):
    """Reused flat buffers for the per-frame batches: fresh multi-MB
    allocations each frame fault in new pages every time; reuse keeps
    them hot (same rationale as dav1d_tpu.__init__._tune_malloc)."""
    need = int(np.prod(shape))
    buf = _SCRATCH.get(key)
    if buf is None or buf.size < need or buf.dtype != np.dtype(dtype):
        buf = np.empty(need, dtype=dtype)
        _SCRATCH[key] = buf
    return buf[:need].reshape(shape)


_DIR_DY = np.array([[d[0][0] for d in CDEF_DIRECTIONS],
                    [d[1][0] for d in CDEF_DIRECTIONS]])  # (2 pass, 12)
_DIR_DX = np.array([[d[0][1] for d in CDEF_DIRECTIONS],
                    [d[1][1] for d in CDEF_DIRECTIONS]])


def _onehot_maps():
    """One-hot projection matrices for the batched direction search:
    (64, bins) per psum accumulator."""
    ys, xs = np.mgrid[0:8, 0:8]
    maps = [
        ((ys + xs).ravel(), 15),          # diag0
        ((ys + (xs >> 1)).ravel(), 11),   # alt0
        (ys.ravel(), 8),                  # hv0
        ((3 + ys - (xs >> 1)).ravel(), 11),
        ((7 + ys - xs).ravel(), 15),
        ((3 - (ys >> 1) + xs).ravel(), 11),
        (xs.ravel(), 8),
        (((ys >> 1) + xs).ravel(), 11),
    ]
    out = []
    for idx, bins in maps:
        m = np.zeros((64, bins), dtype=np.int64)
        m[np.arange(64), idx] = 1
        out.append(m)
    return out


_ONEHOT = None


def cdef_find_dir_batch(blocks, bitdepth):
    """(N, 8, 8) -> (dirs (N,), vars (N,)) (vectorized cdef_find_dir_c).
    Dispatches to the native C kernel when available
    (dav1d_tpu/native/filters.c, bit-identical)."""
    from ..native import lib as _nlib
    if _nlib is not None:
        blk = np.ascontiguousarray(blocks.reshape(-1, 64), dtype=np.int32)
        n = blk.shape[0]
        dirs = np.empty(n, dtype=np.int64)
        variances = np.empty(n, dtype=np.int64)
        _nlib.dtpu_cdef_find_dir_batch(blk.ctypes.data, n, int(bitdepth),
                                       dirs.ctypes.data,
                                       variances.ctypes.data)
        return dirs, variances
    return cdef_find_dir_batch_np(blocks, bitdepth)


def cdef_find_dir_batch_np(blocks, bitdepth):
    """Golden numpy batch (the device-kernel shape: one-hot projection
    matmuls; see cdef_find_dir_batch for the native dispatch)."""
    global _ONEHOT
    if _ONEHOT is None:
        _ONEHOT = _onehot_maps()
    shift = bitdepth - 8
    px = (blocks.reshape(-1, 64).astype(np.int64) >> shift) - 128
    psum = [px @ m for m in _ONEHOT]
    diag0, alt0, hv0, alt1, diag1, alt2, hv1, alt3 = psum
    N = px.shape[0]
    cost = np.zeros((N, 8), dtype=np.int64)
    cost[:, 2] = (hv0 * hv0).sum(axis=1) * 105
    cost[:, 6] = (hv1 * hv1).sum(axis=1) * 105
    div = np.array([840, 420, 280, 210, 168, 140, 120], dtype=np.int64)
    for diag, ci in ((diag0, 0), (diag1, 4)):
        sq = diag * diag
        cost[:, ci] = ((sq[:, :7] + sq[:, 8:][:, ::-1]) * div).sum(axis=1) \
            + sq[:, 7] * 105
    div_alt = np.array([420, 210, 140], dtype=np.int64)
    for n, alt in enumerate((alt0, alt1, alt2, alt3)):
        sq = alt * alt
        c = sq[:, 3:8].sum(axis=1) * 105
        c += ((sq[:, :3] + sq[:, 8:][:, ::-1]) * div_alt).sum(axis=1)
        cost[:, n * 2 + 1] = c
    best = np.argmax(cost, axis=1)
    best_cost = np.take_along_axis(cost, best[:, None], 1)[:, 0]
    alt_cost = np.take_along_axis(cost, (best ^ 4)[:, None], 1)[:, 0]
    return best.astype(np.int64), (best_cost - alt_cost) >> 10


def cdef_filter_batch(canvas, ys, xs, w, h, pri, sec, dirs, damping,
                      bitdepth):
    """Filter a batch of (h, w) units. canvas: plane with a 2px INT16_MIN
    border (border index 0); ys/xs: unit top-left in canvas coordinates
    (i.e. +2). Returns (N, h, w) filtered pixels
    (vectorized cdef_filter_block_c). Dispatches to the native C kernel
    when available (dav1d_tpu/native/filters.c, bit-identical)."""
    from ..native import lib as _nlib
    if _nlib is not None:
        c = np.ascontiguousarray(canvas, dtype=np.int32)
        ysa = np.ascontiguousarray(ys, dtype=np.int64)
        xsa = np.ascontiguousarray(xs, dtype=np.int64)
        pa = np.ascontiguousarray(pri, dtype=np.int64)
        sa = np.ascontiguousarray(sec, dtype=np.int64)
        da = np.ascontiguousarray(dirs, dtype=np.int64)
        out = _scratch("flt_out", (len(ysa), h, w))
        _nlib.dtpu_cdef_filter_batch(
            c.ctypes.data, c.shape[1], ysa.ctypes.data, xsa.ctypes.data,
            len(ysa), w, h, pa.ctypes.data, sa.ctypes.data, da.ctypes.data,
            int(damping), int(bitdepth), out.ctypes.data)
        return out
    return cdef_filter_batch_np(canvas, ys, xs, w, h, pri, sec, dirs,
                                damping, bitdepth)


def cdef_filter_batch_np(canvas, ys, xs, w, h, pri, sec, dirs, damping,
                         bitdepth):
    """Golden numpy batch (the device kernel shape; see cdef_filter_batch
    for the native dispatch)."""
    N = len(ys)
    yy = (ys[:, None, None] + np.arange(-2, h + 2)[None, :, None])
    xx = (xs[:, None, None] + np.arange(-2, w + 2)[None, None, :])
    # one gather of the padded per-unit windows; all taps then index the
    # small contiguous (N, h+4, w+4) buffer instead of the full plane
    tmp = np.ascontiguousarray(canvas[yy, xx], dtype=np.int32)
    px = np.ascontiguousarray(tmp[:, 2 : 2 + h, 2 : 2 + w])

    bdmin8 = bitdepth - 8
    pri_nz = pri > 0
    sec_nz = sec > 0
    both = pri_nz & sec_nz
    safe_pri = np.maximum(pri, 1)
    safe_sec = np.maximum(sec, 1)
    def ulog2(v):
        # exact for the small positive strengths involved
        return (np.frexp(v.astype(np.float64))[1] - 1).astype(np.int64)

    pri_shift = np.maximum(0, damping - ulog2(safe_pri)) \
        .astype(np.int32)[:, None, None]
    sec_shift = (damping - ulog2(safe_sec)).astype(np.int32)[:, None, None]
    pri_thr = pri.astype(np.int32)[:, None, None]
    sec_thr = sec.astype(np.int32)[:, None, None]
    pri_tap = (4 - ((pri >> bdmin8) & 1)).astype(np.int32)[:, None, None]

    nidx = np.arange(N)[:, None, None]
    hidx = np.arange(h)[None, :, None]
    widx = np.arange(w)[None, None, :]

    def tap(dy, dx):
        iy = 2 + dy[:, None, None] + hidx
        ix = 2 + dx[:, None, None] + widx
        return tmp[nidx, iy, ix]

    sum_ = np.zeros((N, h, w), dtype=np.int32)
    mn = px.copy()
    mx = px.copy()

    def acc_minmax(v):
        nonlocal mn, mx
        # any value above the pixel range works as the "ignore" sentinel
        # for the unsigned-min trick (golden uses 0xFFFF8000)
        u = np.where(v == INT16_MIN, np.int32(0x7FFF0000), v)
        np.minimum(mn, u, out=mn)
        np.maximum(mx, v, out=mx)

    for k in range(2):
        dy = _DIR_DY[k][2 + dirs]
        dx = _DIR_DX[k][2 + dirs]
        p0 = tap(dy, dx)
        p1 = tap(-dy, -dx)
        ptk = pri_tap if k == 0 else (pri_tap & 3) | 2
        pc = ptk * (_constrain(p0 - px, pri_thr, pri_shift)
                    + _constrain(p1 - px, pri_thr, pri_shift))
        sum_ += np.where(pri_nz[:, None, None], pc, 0)
        acc_minmax(np.where(both[:, None, None], p0, px))
        acc_minmax(np.where(both[:, None, None], p1, px))
        sec_tap = 2 - k
        for sdir_off in (4, 0):
            dy2 = _DIR_DY[k][sdir_off + dirs]
            dx2 = _DIR_DX[k][sdir_off + dirs]
            for sgn in (1, -1):
                s = tap(sgn * dy2, sgn * dx2)
                sc = sec_tap * _constrain(s - px, sec_thr, sec_shift)
                sum_ += np.where(sec_nz[:, None, None], sc, 0)
                acc_minmax(np.where(both[:, None, None], s, px))

    out = px + ((sum_ - (sum_ < 0) + 8) >> 4)
    clipped = np.clip(out, mn, mx)
    return np.where(both[:, None, None], clipped, out)


def cdef_collect(f):
    """Unit collection, fully vectorized: 8x8 units on the 2-aligned
    block grid where the superblock has a cdef index with nonzero
    strengths and any 4x4 in the unit is non-skip.  Returns
    (bys, bxs, y_pri, y_sec, uv_pri, uv_sec, uvlvl) in block (4px)
    coords, or None when no unit is filtered."""
    hdr = f.frame_hdr
    bdmin8 = f.bitdepth - 8
    sb64w = (f.bw + 15) >> 4
    sb64h = (f.bh + 15) >> 4
    nrows, ncols = (f.bh + 1) >> 1, (f.bw + 1) >> 1
    cdef_idx = f.cdef_idx[:sb64h, :sb64w]
    ystr = np.asarray(list(hdr.cdef.y_strength) + [0], dtype=np.int64)
    uvstr = np.asarray(list(hdr.cdef.uv_strength) + [0], dtype=np.int64)
    ylvl_sb = ystr[cdef_idx]    # idx -1 -> trailing 0
    uvlvl_sb = uvstr[cdef_idx]
    on_sb = (cdef_idx >= 0) & ((ylvl_sb | uvlvl_sb) != 0)
    rs8 = np.arange(nrows) >> 3
    cs8 = np.arange(ncols) >> 3
    ns = f.noskip[:nrows]
    skip_grid = ns[:, 0 : 2 * ncols : 2].copy()
    if 2 * ncols <= ns.shape[1]:
        skip_grid |= ns[:, 1 : 2 * ncols : 2]
    else:  # odd bw: last unit is a single 4x4 column
        skip_grid[:, :-1] |= ns[:, 1 : 2 * ncols - 1 : 2]
    sel = on_sb[np.ix_(rs8, cs8)] & skip_grid
    rr, cc = np.nonzero(sel)
    if rr.size == 0:
        return None
    bys = rr << 1
    bxs = cc << 1
    ylvl = ylvl_sb[rr >> 3, cc >> 3]
    uvlvl = uvlvl_sb[rr >> 3, cc >> 3]
    y_pri = (ylvl >> 2) << bdmin8
    y_sec = ylvl & 3
    y_sec += (y_sec == 3)
    y_sec <<= bdmin8
    uv_pri = (uvlvl >> 2) << bdmin8
    uv_sec = uvlvl & 3
    uv_sec += (uv_sec == 3)
    uv_sec <<= bdmin8
    return bys, bxs, y_pri, y_sec, uv_pri, uv_sec, uvlvl

