"""CDEF: constrained directional enhancement filter (golden numpy model).

Behavioral parity with reference src/cdef_tmpl.c (cdef_filter_block_c :106,
cdef_find_dir_c :239, padding :56) and src/cdef_apply_tmpl.c (dav1d_cdef_brow
:100). Applied full-frame after deblocking; every unit reads pre-CDEF
(deblocked) pixels from a frame copy, which matches the reference's
top/left/right backup-line scheme exactly."""

from __future__ import annotations

import numpy as np

INT16_MIN = -32768

HAVE_LEFT = 1
HAVE_RIGHT = 2
HAVE_TOP = 4
HAVE_BOTTOM = 8

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


def _ulog2(v: int) -> int:
    return v.bit_length() - 1


def cdef_find_dir(img: np.ndarray, bitdepth: int):
    """8x8 direction search. Returns (dir, variance)
    (reference cdef_find_dir_c)."""
    shift = bitdepth - 8
    px = (img.astype(np.int64) >> shift) - 128
    ys, xs = np.mgrid[0:8, 0:8]
    psum_hv = np.zeros((2, 8), np.int64)
    psum_diag = np.zeros((2, 15), np.int64)
    psum_alt = np.zeros((4, 11), np.int64)
    np.add.at(psum_diag[0], (ys + xs).ravel(), px.ravel())
    np.add.at(psum_alt[0], (ys + (xs >> 1)).ravel(), px.ravel())
    np.add.at(psum_hv[0], ys.ravel(), px.ravel())
    np.add.at(psum_alt[1], (3 + ys - (xs >> 1)).ravel(), px.ravel())
    np.add.at(psum_diag[1], (7 + ys - xs).ravel(), px.ravel())
    np.add.at(psum_alt[2], (3 - (ys >> 1) + xs).ravel(), px.ravel())
    np.add.at(psum_hv[1], xs.ravel(), px.ravel())
    np.add.at(psum_alt[3], ((ys >> 1) + xs).ravel(), px.ravel())

    cost = [0] * 8
    cost[2] = int((psum_hv[0] * psum_hv[0]).sum()) * 105
    cost[6] = int((psum_hv[1] * psum_hv[1]).sum()) * 105
    div_table = [840, 420, 280, 210, 168, 140, 120]
    for n in range(7):
        d = div_table[n]
        cost[0] += int(psum_diag[0][n] ** 2 + psum_diag[0][14 - n] ** 2) * d
        cost[4] += int(psum_diag[1][n] ** 2 + psum_diag[1][14 - n] ** 2) * d
    cost[0] += int(psum_diag[0][7] ** 2) * 105
    cost[4] += int(psum_diag[1][7] ** 2) * 105
    for n in range(4):
        c = 0
        for m in range(5):
            c += int(psum_alt[n][3 + m] ** 2)
        c *= 105
        for m in range(3):
            d = div_table[2 * m + 1]
            c += int(psum_alt[n][m] ** 2 + psum_alt[n][10 - m] ** 2) * d
        cost[n * 2 + 1] = c

    best_dir = 0
    best_cost = cost[0]
    for n in range(1, 8):
        if cost[n] > best_cost:
            best_cost = cost[n]
            best_dir = n
    var = (best_cost - cost[best_dir ^ 4]) >> 10
    return best_dir, var


def _constrain(diff, threshold: int, shift: int):
    adiff = np.abs(diff)
    t = adiff >> shift
    np.subtract(threshold, t, out=t)
    np.maximum(t, 0, out=t)
    np.minimum(t, adiff, out=t)
    np.negative(t, out=adiff)
    return np.where(diff < 0, adiff, t)


def _pad(src, y0, x0, w, h, edges):
    """(h+4, w+4) int64 buffer, INT16_MIN outside available edges
    (reference padding())."""
    tmp = np.full((h + 4, w + 4), INT16_MIN, np.int64)
    x_start, x_end = -2, w + 2
    y_start, y_end = -2, h + 2
    if not (edges & HAVE_TOP):
        y_start = 0
    if not (edges & HAVE_BOTTOM):
        y_end = h
    if not (edges & HAVE_LEFT):
        x_start = 0
    if not (edges & HAVE_RIGHT):
        x_end = w
    tmp[2 + y_start : 2 + y_end, 2 + x_start : 2 + x_end] = \
        src[y0 + y_start : y0 + y_end, x0 + x_start : x0 + x_end]
    return tmp


def cdef_filter_block(dst, src, y0, x0, w, h, pri_strength, sec_strength,
                      dir_, damping, edges, bitdepth):
    """Filter one unit in place; src is the pre-CDEF frame copy
    (reference cdef_filter_block_c)."""
    tmp = _pad(src, y0, x0, w, h, edges)
    body = tmp[2 : 2 + h, 2 : 2 + w]
    px = src[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
    assert (body == px).all()

    def tap_view(dy, dx):
        return tmp[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    sum_ = np.zeros((h, w), np.int64)
    if pri_strength:
        bdmin8 = bitdepth - 8
        pri_tap = 4 - ((pri_strength >> bdmin8) & 1)
        pri_shift = max(0, damping - _ulog2(pri_strength))
        if sec_strength:
            sec_shift = damping - _ulog2(sec_strength)
            mn = px.copy()
            mx = px.copy()

            def acc_minmax(v):
                nonlocal mn, mx
                # umin: INT16_MIN reads as a huge unsigned value
                u = np.where(v == INT16_MIN, np.int64(0xFFFF8000), v)
                mn = np.minimum(mn, u)
                mx = np.maximum(mx, v)

            pri_tap_k = pri_tap
            for k in range(2):
                dy, dx = CDEF_DIRECTIONS[2 + dir_][k]
                p0 = tap_view(dy, dx)
                p1 = tap_view(-dy, -dx)
                sum_ += pri_tap_k * _constrain(p0 - px, pri_strength,
                                               pri_shift)
                sum_ += pri_tap_k * _constrain(p1 - px, pri_strength,
                                               pri_shift)
                pri_tap_k = (pri_tap_k & 3) | 2
                acc_minmax(p0)
                acc_minmax(p1)
                sec_tap = 2 - k
                for sdir in (4 + dir_, dir_):
                    dy2, dx2 = CDEF_DIRECTIONS[sdir][k]
                    for sgn in (1, -1):
                        s = tap_view(sgn * dy2, sgn * dx2)
                        sum_ += sec_tap * _constrain(s - px, sec_strength,
                                                     sec_shift)
                        acc_minmax(s)
            out = px + ((sum_ - (sum_ < 0) + 8) >> 4)
            out = np.clip(out, mn, mx)
        else:
            pri_tap_k = pri_tap
            for k in range(2):
                dy, dx = CDEF_DIRECTIONS[2 + dir_][k]
                p0 = tap_view(dy, dx)
                p1 = tap_view(-dy, -dx)
                sum_ += pri_tap_k * _constrain(p0 - px, pri_strength,
                                               pri_shift)
                sum_ += pri_tap_k * _constrain(p1 - px, pri_strength,
                                               pri_shift)
                pri_tap_k = (pri_tap_k & 3) | 2
            out = px + ((sum_ - (sum_ < 0) + 8) >> 4)
    else:
        assert sec_strength
        sec_shift = damping - _ulog2(sec_strength)
        for k in range(2):
            sec_tap = 2 - k
            for sdir in (4 + dir_, dir_):
                dy2, dx2 = CDEF_DIRECTIONS[sdir][k]
                for sgn in (1, -1):
                    s = tap_view(sgn * dy2, sgn * dx2)
                    sum_ += sec_tap * _constrain(s - px, sec_strength,
                                                 sec_shift)
        out = px + ((sum_ - (sum_ < 0) + 8) >> 4)
    dst[y0 : y0 + h, x0 : x0 + w] = out


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


def adjust_strength(strength: int, var: int) -> int:
    if not var:
        return 0
    i = min(_ulog2(var >> 6), 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


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


def cdef_frame(f) -> None:
    """Full-frame CDEF (reference dav1d_cdef_brow, single-tile pipeline).
    Every unit reads pre-CDEF deblocked pixels from the frame copy, which
    reproduces the reference's cdef_line/lr_bak backups."""
    from ..headers import PixelLayout
    hdr = f.frame_hdr
    seq = f.seq_hdr
    bitdepth = f.bitdepth
    bdmin8 = bitdepth - 8
    damping = hdr.cdef.damping + bdmin8
    layout = f.layout
    ss_ver = int(layout == PixelLayout.I420)
    ss_hor = int(layout != PixelLayout.I444)
    has_chroma = layout != PixelLayout.I400
    uv_dir_map = UV_DIRS_422 if layout == PixelLayout.I422 else UV_DIRS_420

    from ..native import lib as _nlib

    if _nlib is not None:
        # whole-frame native pass: unit collection, direction search,
        # strength adjust and the three plane filters in one C call
        ph, pw = (f.bh * 4) >> ss_ver, (f.bw * 4) >> ss_hor
        canvas0 = _scratch("canvas0", (f.bh * 4 + 4, f.bw * 4 + 4))
        canvas1 = _scratch("canvas1", (ph + 4, pw + 4))
        ystr = np.ascontiguousarray(
            list(hdr.cdef.y_strength) + [0] * 8, dtype=np.int32)[:8]
        uvstr = np.ascontiguousarray(
            list(hdr.cdef.uv_strength) + [0] * 8, dtype=np.int32)[:8]
        uvdm = np.ascontiguousarray(uv_dir_map, dtype=np.int32)
        ns = np.ascontiguousarray(f.noskip.view(np.uint8))
        if _nlib.dtpu_cdef_frame(
                f.planes[0].ctypes.data,
                f.planes[1].ctypes.data if has_chroma else None,
                f.planes[2].ctypes.data if has_chroma else None,
                f.planes[0].shape[1],
                f.planes[1].shape[1] if has_chroma else 0,
                f.bw, f.bh, ss_hor, ss_ver, int(has_chroma),
                canvas0.ctypes.data, canvas1.ctypes.data,
                f.cdef_idx.ctypes.data, f.cdef_idx.shape[1],
                ns.ctypes.data, ns.shape[1],
                ystr.ctypes.data, uvstr.ctypes.data, uvdm.ctypes.data,
                damping, bitdepth):
            return
        # scratch allocation failed inside the C pass (it modified
        # nothing) — fall through to the Python path

    units = cdef_collect(f)
    if units is None:
        return
    bys, bxs, y_pri, y_sec, uv_pri, uv_sec, uvlvl = units

    need_dir = (y_pri | uv_pri) > 0
    dirs = np.zeros(bys.size, dtype=np.int64)
    variances = np.zeros(bys.size, dtype=np.int64)
    if need_dir.any():
        src0 = f.planes[0]
        dbys = (bys[need_dir] * 4).astype(np.int64)
        dbxs = (bxs[need_dir] * 4).astype(np.int64)
        if _nlib is not None:
            # native path reads the 8x8 windows straight from the plane
            d = np.empty(dbys.size, dtype=np.int64)
            v = np.empty(dbys.size, dtype=np.int64)
            _nlib.dtpu_cdef_find_dir_pos(
                src0.ctypes.data, src0.shape[1], dbys.ctypes.data,
                dbxs.ctypes.data, dbys.size, int(bitdepth),
                d.ctypes.data, v.ctypes.data)
        else:
            ar8 = np.arange(8)
            blk = src0[dbys[:, None, None] + ar8[None, :, None],
                       dbxs[:, None, None] + ar8[None, None, :]]
            d, v = cdef_find_dir_batch(blk, bitdepth)
        dirs[need_dir] = d
        variances[need_dir] = v

    # vectorized adjust_strength (reference adjust_strength, cdef_apply)
    v6 = variances >> 6
    i = np.zeros_like(variances)
    nz = v6 > 0
    i[nz] = np.minimum(np.frexp(v6[nz].astype(np.float64))[1] - 1, 12)
    y_adj = np.where(variances != 0, (y_pri * (4 + i) + 8) >> 4, 0)

    for pl in range(3 if has_chroma else 1):
        if pl == 0:
            m_pri = y_pri > 0
            m = (m_pri & ((y_adj | y_sec) != 0)) | (~m_pri & (y_sec > 0))
            if not m.any():
                continue
            upri = np.where(m_pri, y_adj, 0)[m]
            usec = y_sec[m]
            udir = np.where(m_pri, dirs, 0)[m]
            uys = bys[m] * 4
            uxs = bxs[m] * 4
            sv = sh = 0
        else:
            m = uvlvl != 0
            if not m.any():
                continue
            upri = uv_pri[m]
            usec = uv_sec[m]
            uvdm = np.asarray(uv_dir_map, dtype=np.int64)
            udir = np.where(uv_pri > 0, uvdm[dirs], 0)[m]
            uys = (bys[m] * 4) >> ss_ver
            uxs = (bxs[m] * 4) >> ss_hor
            sv, sh = ss_ver, ss_hor
        w, h = 8 >> sh, 8 >> sv
        pw, ph = (f.bw * 4) >> sh, (f.bh * 4) >> sv
        canvas = _scratch("canvas%d" % min(pl, 1), (ph + 4, pw + 4))
        if _nlib is not None:
            # native whole-plane pass: canvas build + per-unit filter
            # straight back into the plane, all in C
            plane = f.planes[pl]
            uysa = np.ascontiguousarray(uys, dtype=np.int64)
            uxsa = np.ascontiguousarray(uxs, dtype=np.int64)
            pa = np.ascontiguousarray(upri, dtype=np.int64)
            sa = np.ascontiguousarray(usec, dtype=np.int64)
            da = np.ascontiguousarray(udir, dtype=np.int64)
            _nlib.dtpu_cdef_filter_plane(
                plane.ctypes.data, plane.shape[1], pw, ph,
                canvas.ctypes.data, uysa.ctypes.data, uxsa.ctypes.data,
                uysa.size, w, h, pa.ctypes.data, sa.ctypes.data,
                da.ctypes.data, damping - (1 if pl else 0), bitdepth)
            continue
        canvas[:2] = INT16_MIN
        canvas[-2:] = INT16_MIN
        canvas[:, :2] = INT16_MIN
        canvas[:, -2:] = INT16_MIN
        canvas[2 : 2 + ph, 2 : 2 + pw] = f.planes[pl][:ph, :pw]
        out = cdef_filter_batch(canvas, uys + 2, uxs + 2, w, h,
                                upri, usec, udir,
                                damping - (1 if pl else 0), bitdepth)
        arh = np.arange(h)
        arw = np.arange(w)
        f.planes[pl][uys[:, None, None] + arh[None, :, None],
                     uxs[:, None, None] + arw[None, None, :]] = out
