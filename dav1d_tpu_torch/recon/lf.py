"""Deblocking loop filter: edge planes, levels, and filtering.

Behavioral parity with the reference (src/lf_mask.c:36-468,
src/loopfilter_tmpl.c:36-241, src/lf_apply_tmpl.c:176-466; AV1 spec 7.14),
in a formulation designed for batched application rather than the
reference's per-SB128 32-lane bitmasks:

- Edge state is two frame-wide byte planes per plane group
  (`FrameContext.lf_wd_y` / `lf_wd_uv`, shape (2, h4, w4)): plane [0]
  holds the filter-width class of the VERTICAL edge on the left side of
  each 4x4 cell, plane [1] the HORIZONTAL edge on its top side.  The
  stored value is class+1 (0 = no filter); luma classes 0/1/2 select
  widths 4/8/16, chroma classes 0/1 select widths 4/6.
- Filter levels live in the per-4x4 cache `lf_level[y][x][plane_dir]`.
- Application is full-frame: all vertical edges, then all horizontal
  edges, each gathered with numpy and filtered in one batch per width
  class.  Exactness: an edge of width class c has a transform block of
  at least its class width on both sides, so any two edges in the same
  direction are separated by at least that many pixels, which exceeds
  the filters' combined read+write reach for every class pairing - no
  edge ever reads another edge's writes within a direction pass, and the
  cols->rows order matches the reference's per-sbrow interleaving
  because writes never cross a superblock-row boundary except through
  the boundary edge itself, which belongs to the later rows pass.
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..headers import PixelLayout
from ..native import lib as _native


def calc_eih(sharpness: int):
    """(E, I) LUTs per level (reference dav1d_calc_eih)."""
    e = np.zeros(64, dtype=np.int32)
    i_ = np.zeros(64, dtype=np.int32)
    for level in range(64):
        limit = level
        if sharpness > 0:
            limit >>= (sharpness + 3) >> 2
            limit = min(limit, 9 - sharpness)
        limit = max(limit, 1)
        i_[level] = limit
        e[level] = 2 * (level + 2) + limit
    return e, i_


def _calc_lf_value(out, base_lvl, lf_delta, seg_delta, mr_delta):
    base = max(0, min(63, max(0, min(63, base_lvl + lf_delta)) + seg_delta))
    if mr_delta is None:
        out[:, :] = base
        return
    sh = int(base >= 32)
    out[0, 0] = out[0, 1] = max(0, min(63, base + mr_delta.ref_delta[0] * (1 << sh)))
    for r in range(1, 8):
        for m in range(2):
            delta = mr_delta.mode_delta[m] + mr_delta.ref_delta[r]
            out[r, m] = max(0, min(63, base + delta * (1 << sh)))


def calc_lf_values(hdr, lf_delta):
    """(8 seg, 4 plane-dir, 8 ref, 2 mode) uint8
    (reference dav1d_calc_lf_values)."""
    n_seg = 8 if hdr.segmentation.enabled else 1
    out = np.zeros((8, 4, 8, 2), dtype=np.uint8)
    lf = hdr.loopfilter
    if not lf.level_y[0] and not lf.level_y[1]:
        return out
    mr = lf.mode_ref_deltas if lf.mode_ref_delta_enabled else None
    multi = hdr.delta.lf_multi
    for s in range(n_seg):
        segd = hdr.segmentation.seg_data.d[s] if hdr.segmentation.enabled \
            else None
        _calc_lf_value(out[s][0], lf.level_y[0], lf_delta[0],
                       segd.delta_lf_y_v if segd else 0, mr)
        _calc_lf_value(out[s][1], lf.level_y[1], lf_delta[1 if multi else 0],
                       segd.delta_lf_y_h if segd else 0, mr)
        if lf.level_u:
            _calc_lf_value(out[s][2], lf.level_u, lf_delta[2 if multi else 0],
                           segd.delta_lf_u if segd else 0, mr)
        if lf.level_v:
            _calc_lf_value(out[s][3], lf.level_v, lf_delta[3 if multi else 0],
                           segd.delta_lf_v if segd else 0, mr)
    return out


# --- edge-plane construction ------------------------------------------------

def mask_edges_intra(wd_y, by, bx, w4, h4, tx, a, a_off, l, l_off):
    """Record the deblock edges of one intra block into the frame edge
    planes (same edge semantics as reference mask_edges_intra,
    src/lf_mask.c:149-200; AV1 spec 7.14.5)."""
    t_dim = tables.txfm_info()[tx]
    twl4c = min(2, int(t_dim[2]))
    thl4c = min(2, int(t_dim[3]))
    if _native is not None:
        stride = wd_y.shape[2]
        _native.dtpu_mask_edges_intra(
            wd_y.ctypes.data, wd_y.ctypes.data + wd_y.strides[0],
            stride, by, bx, w4, h4, twl4c, thl4c,
            int(t_dim[0]), int(t_dim[1]),
            a.ctypes.data + a_off, l.ctypes.data + l_off)
        return

    # block edges: width class = min of the tx sizes on either side
    wd_y[0, by : by + h4, bx] = \
        1 + np.minimum(twl4c, l[l_off : l_off + h4])
    wd_y[1, by, bx : bx + w4] = \
        1 + np.minimum(thl4c, a[a_off : a_off + w4])
    # inner tx edges: both sides share this block's tx size
    tw, th = int(t_dim[0]), int(t_dim[1])
    for x in range(tw, w4, tw):
        wd_y[0, by : by + h4, bx + x] = 1 + twl4c
    for y in range(th, h4, th):
        wd_y[1, by + y, bx : bx + w4] = 1 + thl4c

    a[a_off : a_off + w4] = thl4c
    l[l_off : l_off + h4] = twl4c


def mask_edges_chroma(wd_uv, cby, cbx, cw4, ch4, skip_inter, tx,
                      a, a_off, l, l_off):
    """Chroma edge recording (same edge semantics as reference
    mask_edges_chroma, src/lf_mask.c:202-258)."""
    t_dim = tables.txfm_info()[tx]
    twl4c = int(bool(int(t_dim[2])))
    thl4c = int(bool(int(t_dim[3])))
    if _native is not None:
        stride = wd_uv.shape[2]
        _native.dtpu_mask_edges_chroma(
            wd_uv.ctypes.data, wd_uv.ctypes.data + wd_uv.strides[0],
            stride, cby, cbx, cw4, ch4, skip_inter, twl4c, thl4c,
            int(t_dim[0]), int(t_dim[1]),
            a.ctypes.data + a_off, l.ctypes.data + l_off)
        return

    wd_uv[0, cby : cby + ch4, cbx] = \
        1 + np.minimum(twl4c, l[l_off : l_off + ch4])
    wd_uv[1, cby, cbx : cbx + cw4] = \
        1 + np.minimum(thl4c, a[a_off : a_off + cw4])
    if not skip_inter:
        tw, th = int(t_dim[0]), int(t_dim[1])
        for x in range(tw, cw4, tw):
            wd_uv[0, cby : cby + ch4, cbx + x] = 1 + twl4c
        for y in range(th, ch4, th):
            wd_uv[1, cby + y, cbx : cbx + cw4] = 1 + thl4c

    a[a_off : a_off + cw4] = thl4c
    l[l_off : l_off + ch4] = twl4c


def create_lf_mask_intra(f, level_cache, filter_level, bx, by, iw, ih, bs,
                         ytx, uvtx, layout, ay, ay_off, ly, ly_off,
                         auv, auv_off, luv, luv_off):
    """reference dav1d_create_lf_mask_intra (src/lf_mask.c:259-320)."""
    b_dim = tables.block_dimensions[bs]
    bw4 = min(iw - bx, int(b_dim[0]))
    bh4 = min(ih - by, int(b_dim[1]))

    if bw4 and bh4:
        level_cache[by : by + bh4, bx : bx + bw4, 0] = filter_level[0][0][0]
        level_cache[by : by + bh4, bx : bx + bw4, 1] = filter_level[1][0][0]
        mask_edges_intra(f.lf_wd_y, by, bx, bw4, bh4, ytx,
                         ay, ay_off, ly, ly_off)

    if auv is None:
        return
    ss_ver = int(layout == PixelLayout.I420)
    ss_hor = int(layout != PixelLayout.I444)
    cbw4 = min(((iw + ss_hor) >> ss_hor) - (bx >> ss_hor),
               (int(b_dim[0]) + ss_hor) >> ss_hor)
    cbh4 = min(((ih + ss_ver) >> ss_ver) - (by >> ss_ver),
               (int(b_dim[1]) + ss_ver) >> ss_ver)
    if cbw4 <= 0 or cbh4 <= 0:
        return
    cy, cx = by >> ss_ver, bx >> ss_hor
    level_cache[cy : cy + cbh4, cx : cx + cbw4, 2] = filter_level[2][0][0]
    level_cache[cy : cy + cbh4, cx : cx + cbw4, 3] = filter_level[3][0][0]
    mask_edges_chroma(f.lf_wd_uv, cy, cx, cbw4, cbh4, 0, uvtx,
                      auv, auv_off, luv, luv_off)


# --- filtering ---------------------------------------------------------------

def _loop_filter(plane, py, px, E, I, H, along_rows, wd, bitdepth):
    """Filter 4 pixels across one edge (reference loop_filter,
    src/loopfilter_tmpl.c:36-161). along_rows: True for a vertical edge
    (pixels advance down rows; taps run horizontally)."""
    bd_m8 = bitdepth - 8
    F = 1 << bd_m8
    E <<= bd_m8
    I <<= bd_m8
    H <<= bd_m8
    maxp = (1 << bitdepth) - 1
    cd_lim = 128 << bd_m8

    def iclip_diff(v):
        return max(-cd_lim, min(cd_lim - 1, v))

    for i in range(4):
        if along_rows:
            y, x = py + i, px
            get = lambda o: int(plane[y, x + o])
            def put(o, v):
                plane[y, x + o] = v
        else:
            y, x = py, px + i
            get = lambda o: int(plane[y + o, x])
            def put(o, v):
                plane[y + o, x] = v

        p1, p0 = get(-2), get(-1)
        q0, q1 = get(0), get(1)
        fm = (abs(p1 - p0) <= I and abs(q1 - q0) <= I
              and abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= E)
        p2 = q2 = p3 = q3 = 0
        if wd > 4:
            p2, q2 = get(-3), get(2)
            fm = fm and abs(p2 - p1) <= I and abs(q2 - q1) <= I
            if wd > 6:
                p3, q3 = get(-4), get(3)
                fm = fm and abs(p3 - p2) <= I and abs(q3 - q2) <= I
        if not fm:
            continue

        flat8out = False
        if wd >= 16:
            p6, p5, p4 = get(-7), get(-6), get(-5)
            q4, q5, q6 = get(4), get(5), get(6)
            flat8out = (abs(p6 - p0) <= F and abs(p5 - p0) <= F
                        and abs(p4 - p0) <= F and abs(q4 - q0) <= F
                        and abs(q5 - q0) <= F and abs(q6 - q0) <= F)
        flat8in = False
        if wd >= 6:
            flat8in = (abs(p2 - p0) <= F and abs(p1 - p0) <= F
                       and abs(q1 - q0) <= F and abs(q2 - q0) <= F)
        if wd >= 8:
            flat8in = flat8in and abs(p3 - p0) <= F and abs(q3 - q0) <= F

        if wd >= 16 and flat8out and flat8in:
            put(-6, (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4)
            put(-5, (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4)
            put(-4, (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4)
            put(-3, (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4)
            put(-2, (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4)
            put(-1, (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4)
            put(0, (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4)
            put(1, (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4)
            put(2, (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4)
            put(3, (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4)
            put(4, (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4)
            put(5, (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4)
        elif wd >= 8 and flat8in:
            put(-3, (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3)
            put(-2, (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3)
            put(-1, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3)
            put(0, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3)
            put(1, (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3)
            put(2, (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3)
        elif wd == 6 and flat8in:
            put(-2, (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3)
            put(-1, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
            put(0, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
            put(1, (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3)
        else:
            hev = abs(p1 - p0) > H or abs(q1 - q0) > H
            if hev:
                f = iclip_diff(p1 - q1)
                f = iclip_diff(3 * (q0 - p0) + f)
                f1 = min(f + 4, cd_lim - 1) >> 3
                f2 = min(f + 3, cd_lim - 1) >> 3
                put(-1, max(0, min(maxp, p0 + f2)))
                put(0, max(0, min(maxp, q0 - f1)))
            else:
                f = iclip_diff(3 * (q0 - p0))
                f1 = min(f + 4, cd_lim - 1) >> 3
                f2 = min(f + 3, cd_lim - 1) >> 3
                put(-1, max(0, min(maxp, p0 + f2)))
                put(0, max(0, min(maxp, q0 - f1)))
                f = (f1 + 1) >> 1
                put(-2, max(0, min(maxp, p1 + f)))
                put(1, max(0, min(maxp, q1 - f)))


def _loop_filter_batch(plane, ys, xs, E, I, H, along_rows, wd, bitdepth):
    """Vectorized _loop_filter over N 4-line edge segments of one width
    class. Within a pass, segments never read each other's writes (edge
    spacing >= the tx width implied by wd exceeds read+write reach), so
    batching is exact (reference loop_filter, src/loopfilter_tmpl.c:36)."""
    bd_m8 = bitdepth - 8
    F = 1 << bd_m8
    maxp = (1 << bitdepth) - 1
    cd_lim = 128 << bd_m8
    E = (E << bd_m8)[:, None]
    I = (I << bd_m8)[:, None]
    H = (H << bd_m8)[:, None]
    m = {4: 2, 6: 3, 8: 4, 16: 7}[wd]
    n = len(ys)
    lines = np.arange(4)
    taps = np.arange(2 * m) - m
    if along_rows:  # vertical edge: lines advance down rows
        ridx = ys[:, None, None] + lines[None, :, None]
        cidx = xs[:, None, None] + taps[None, None, :]
        W = plane[ridx, cidx].astype(np.int64)  # (N, 4, 2m)
    else:           # horizontal edge: lines advance across columns
        ridx = ys[:, None, None] + taps[None, :, None]
        cidx = xs[:, None, None] + lines[None, None, :]
        W = plane[ridx, cidx].astype(np.int64).transpose(0, 2, 1)

    def P(k):
        return W[:, :, m - 1 - k]

    def Q(k):
        return W[:, :, m + k]

    p1, p0, q0, q1 = P(1), P(0), Q(0), Q(1)
    fm = ((np.abs(p1 - p0) <= I) & (np.abs(q1 - q0) <= I)
          & (np.abs(p0 - q0) * 2 + (np.abs(p1 - q1) >> 1) <= E))
    if wd > 4:
        p2, q2 = P(2), Q(2)
        fm &= (np.abs(p2 - p1) <= I) & (np.abs(q2 - q1) <= I)
        if wd > 6:
            p3, q3 = P(3), Q(3)
            fm &= (np.abs(p3 - p2) <= I) & (np.abs(q3 - q2) <= I)

    out = {}  # offset -> (cond, value)

    def emit(o, cond, val):
        if o in out:
            pc, pv = out[o]
            out[o] = (pc | cond, np.where(cond, val, pv))
        else:
            out[o] = (cond, val)

    big = None
    if wd >= 16:
        p6, p5, p4 = P(6), P(5), P(4)
        q4, q5, q6 = Q(4), Q(5), Q(6)
        flat8out = ((np.abs(p6 - p0) <= F) & (np.abs(p5 - p0) <= F)
                    & (np.abs(p4 - p0) <= F) & (np.abs(q4 - q0) <= F)
                    & (np.abs(q5 - q0) <= F) & (np.abs(q6 - q0) <= F))
    flat8in = None
    if wd >= 6:
        flat8in = ((np.abs(p2 - p0) <= F) & (np.abs(p1 - p0) <= F)
                   & (np.abs(q1 - q0) <= F) & (np.abs(q2 - q0) <= F))
        if wd >= 8:
            flat8in &= (np.abs(p3 - p0) <= F) & (np.abs(q3 - q0) <= F)

    if wd >= 16:
        big = fm & flat8out & flat8in
        emit(-6, big, (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0
                       + 8) >> 4)
        emit(-5, big, (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0
                       + q0 + q1 + 8) >> 4)
        emit(-4, big, (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0
                       + q0 + q1 + q2 + 8) >> 4)
        emit(-3, big, (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0
                       + q0 + q1 + q2 + q3 + 8) >> 4)
        emit(-2, big, (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2
                       + q0 + q1 + q2 + q3 + q4 + 8) >> 4)
        emit(-1, big, (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2
                       + q1 + q2 + q3 + q4 + q5 + 8) >> 4)
        emit(0, big, (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2
                      + q2 + q3 + q4 + q5 + q6 + 8) >> 4)
        emit(1, big, (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2
                      + q3 + q4 + q5 + q6 * 2 + 8) >> 4)
        emit(2, big, (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2
                      + q4 + q5 + q6 * 3 + 8) >> 4)
        emit(3, big, (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2
                      + q5 + q6 * 4 + 8) >> 4)
        emit(4, big, (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                      + q6 * 5 + 8) >> 4)
        emit(5, big, (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7
                      + 8) >> 4)

    notbig = fm if big is None else (fm & ~big)
    if wd >= 8:
        mid = notbig & flat8in
        emit(-3, mid, (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3)
        emit(-2, mid, (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3)
        emit(-1, mid, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3)
        emit(0, mid, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3)
        emit(1, mid, (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3)
        emit(2, mid, (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3)
        narrow = notbig & ~flat8in
    elif wd == 6:
        mid = notbig & flat8in
        emit(-2, mid, (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3)
        emit(-1, mid, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
        emit(0, mid, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
        emit(1, mid, (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3)
        narrow = notbig & ~flat8in
    else:
        narrow = fm

    def iclip_diff(v):
        return np.clip(v, -cd_lim, cd_lim - 1)

    hev = (np.abs(p1 - p0) > H) | (np.abs(q1 - q0) > H)
    fh = iclip_diff(3 * (q0 - p0) + iclip_diff(p1 - q1))
    fnh = iclip_diff(3 * (q0 - p0))
    fv = np.where(hev, fh, fnh)
    f1 = np.minimum(fv + 4, cd_lim - 1) >> 3
    f2 = np.minimum(fv + 3, cd_lim - 1) >> 3
    emit(-1, narrow, np.clip(p0 + f2, 0, maxp))
    emit(0, narrow, np.clip(q0 - f1, 0, maxp))
    nh = narrow & ~hev
    fo = (f1 + 1) >> 1
    emit(-2, nh, np.clip(p1 + fo, 0, maxp))
    emit(1, nh, np.clip(q1 - fo, 0, maxp))

    for o, (cond, val) in out.items():
        final = np.where(cond, val, W[:, :, m + o])
        if along_rows:
            plane[ys[:, None] + lines[None, :], (xs + o)[:, None]] = final
        else:
            plane[(ys + o)[:, None], xs[:, None] + lines[None, :]] = final


def _collect_edges(level, wd_plane, pd_idx, dir_, n_rows, n_cols):
    """Select the active edges of one plane/direction: 4-aligned cell
    coords, width class, and resolved filter level (q-side cell, falling
    back to the p-side cell — reference loop_filter_sb128
    'level_ptr[-1] if !L').  Returns (ys, xs, cls, L), possibly empty."""
    empty = (np.empty(0, np.int64),) * 4
    wd = wd_plane[:n_rows, :n_cols]
    ys, xs = np.nonzero(wd)
    if ys.size == 0:
        return empty
    # the frame's own left/top boundary is never filtered
    keep = (xs > 0) if dir_ == 0 else (ys > 0)
    ys, xs = ys[keep], xs[keep]
    if ys.size == 0:
        return empty
    cls = wd[ys, xs]
    L = level[ys, xs, pd_idx].astype(np.int64)
    fb = L == 0
    if fb.any():
        if dir_ == 0:
            L[fb] = level[ys[fb], xs[fb] - 1, pd_idx]
        else:
            L[fb] = level[ys[fb] - 1, xs[fb], pd_idx]
    on = L != 0
    return ys[on], xs[on], cls[on], L[on]


def _apply_edges(plane, level, wd_plane, pd_idx, dir_, wd_map, e_lut,
                 i_lut, bitdepth, n_rows, n_cols):
    """Filter every recorded edge of one plane/direction, batched per
    width class (replaces the reference's per-sbrow
    dav1d_loopfilter_sbrow_cols/rows, src/lf_apply_tmpl.c:313-466)."""
    if _native is not None and wd_plane.flags["C_CONTIGUOUS"] \
            and level.flags["C_CONTIGUOUS"]:
        # whole-plane native pass: the C walks the width-class and level
        # planes directly (no numpy nonzero/gather per direction).  The
        # contiguity conditions guard the stride arithmetic below; a
        # non-contiguous caller falls through to the gather path.
        _native.dtpu_lf_filter_plane(
            plane.ctypes.data, plane.shape[1],
            wd_plane.ctypes.data, wd_plane.shape[1],
            level.ctypes.data, level.shape[1] * 4,
            int(pd_idx), int(n_rows), int(n_cols),
            e_lut.ctypes.data, i_lut.ctypes.data,
            dir_, int(pd_idx >= 2), bitdepth)
        return
    ys, xs, cls, L = _collect_edges(level, wd_plane, pd_idx, dir_,
                                    n_rows, n_cols)
    if ys.size == 0:
        return
    E = e_lut[L].astype(np.int64)
    I = i_lut[L].astype(np.int64)
    H = L >> 4
    for c, wd_px in wd_map.items():
        sel = cls == c
        if not sel.any():
            continue
        _loop_filter_batch(plane, ys[sel] * 4, xs[sel] * 4, E[sel],
                           I[sel], H[sel], dir_ == 0, wd_px, bitdepth)


def deblock_frame(f) -> None:
    """Full-frame deblock: all vertical edges, then all horizontal edges
    (equivalence to the reference's per-sbrow interleaving argued in the
    module docstring)."""
    hdr = f.frame_hdr
    if hdr.tiling.cols > 1 or hdr.tiling.rows > 1:
        _fix_tile_boundaries(f)
    e_lut, i_lut = f.lf_lim_lut
    level = f.lf_level
    ss_ver, ss_hor = f.ss_ver, f.ss_hor
    ch4 = (f.h4 + ss_ver) >> ss_ver
    cw4 = (f.w4 + ss_hor) >> ss_hor
    do_uv = f.layout != PixelLayout.I400 and \
        (hdr.loopfilter.level_u or hdr.loopfilter.level_v)
    y_wd = {1: 4, 2: 8, 3: 16}
    uv_wd = {1: 4, 2: 6}
    for dir_ in (0, 1):  # vertical edges first, then horizontal
        _apply_edges(f.planes[0], level, f.lf_wd_y[dir_], dir_, dir_,
                     y_wd, e_lut, i_lut, f.bitdepth, f.h4, f.w4)
        if do_uv:
            for pl in (1, 2):
                _apply_edges(f.planes[pl], level, f.lf_wd_uv[dir_],
                             1 + pl, dir_, uv_wd, e_lut, i_lut,
                             f.bitdepth, ch4, cw4)


def _cap_classes(v, cap):
    """Replace edge classes with min(class, cap); the edge is (re)set
    even where no edge was recorded, mirroring the reference's
    unconditional mask rewrite at tile boundaries (every 4px run on a
    tile boundary is a block edge)."""
    idx = np.maximum(v.astype(np.int32) - 1, 0)
    v[:] = (np.minimum(idx, cap) + 1).astype(np.uint8)


def _fix_tile_boundaries(f):
    """Cap filter width across tile boundaries with the neighbour tile's
    edge tx sizes (reference src/lf_apply_tmpl.c:331-403): decode-time
    edge classes at a tile boundary used this tile's own a/l tx context,
    which does not see the other side."""
    hdr = f.frame_hdr
    is_sb64 = int(not f.seq_hdr.sb128)
    sbl2 = 5 - is_sb64
    halign = (f.bh + 31) & ~31
    ss_ver, ss_hor = f.ss_ver, f.ss_hor
    ch4 = (f.h4 + ss_ver) >> ss_ver
    cw4 = (f.w4 + ss_hor) >> ss_hor

    # tile column boundaries: vertical-edge classes capped by the left
    # tile's right-edge tx widths (tx_lpf_right_edge, filled per tile)
    for k in range(1, hdr.tiling.cols):
        x4 = hdr.tiling.col_start_sb[k] << sbl2
        if x4 >= f.bw:
            break
        cap = f.tx_lpf_right_edge[0][halign * (k - 1):
                                     halign * (k - 1) + f.h4]
        _cap_classes(f.lf_wd_y[0][:f.h4, x4], cap)
        if f.layout != PixelLayout.I400:
            ha = halign >> ss_ver
            cap = f.tx_lpf_right_edge[1][ha * (k - 1): ha * (k - 1) + ch4]
            _cap_classes(f.lf_wd_uv[0][:ch4, x4 >> ss_hor], cap)

    # tile row boundaries: horizontal-edge classes capped by the above
    # tile row's bottom-edge tx heights (its persistent above context)
    cpl = 32 >> ss_hor  # chroma cells per sb128 column
    for sby in range(f.sbh):
        tr = f.start_of_tile_row[sby]
        if not tr:
            continue
        y4 = sby * f.sb_step
        cap = np.concatenate(
            [f.a[f.sb128w * (tr - 1) + x].tx_lpf_y
             for x in range(f.sb128w)])[:f.w4]
        _cap_classes(f.lf_wd_y[1][y4, :f.w4], cap)
        if f.layout != PixelLayout.I400:
            cap = np.concatenate(
                [f.a[f.sb128w * (tr - 1) + x].tx_lpf_uv[:cpl]
                 for x in range(f.sb128w)])[:cw4]
            _cap_classes(f.lf_wd_uv[1][y4 >> ss_ver, :cw4], cap)


def _decomp_tx(txa, from_tx, depth, y_off, x_off, tx_masks, y0, x0):
    """reference decomp_tx (src/lf_mask.c:40-77). txa: (2,2,32,32) uint8."""
    t_dim = tables.txfm_info()[from_tx]
    tw, th = int(t_dim[0]), int(t_dim[1])
    is_split = 0 if (from_tx == 0 or depth > 1) else \
        (tx_masks[depth] >> (y_off * 4 + x_off)) & 1
    if is_split:
        sub = int(t_dim[6])
        htw4, hth4 = tw >> 1, th >> 1
        _decomp_tx(txa, sub, depth + 1, y_off * 2, x_off * 2, tx_masks,
                   y0, x0)
        if tw >= th:
            _decomp_tx(txa, sub, depth + 1, y_off * 2, x_off * 2 + 1,
                       tx_masks, y0, x0 + htw4)
        if th >= tw:
            _decomp_tx(txa, sub, depth + 1, y_off * 2 + 1, x_off * 2,
                       tx_masks, y0 + hth4, x0)
            if tw >= th:
                _decomp_tx(txa, sub, depth + 1, y_off * 2 + 1, x_off * 2 + 1,
                           tx_masks, y0 + hth4, x0 + htw4)
    else:
        lw, lh = min(2, int(t_dim[2])), min(2, int(t_dim[3]))
        txa[0, 0, y0 : y0 + th, x0 : x0 + tw] = lw
        txa[1, 0, y0 : y0 + th, x0 : x0 + tw] = lh
        txa[0, 1, y0 : y0 + th, x0] = tw
        txa[1, 1, y0, x0 : x0 + tw] = th


def mask_edges_inter(wd_y, by, bx, w4, h4, skip, max_tx, tx_masks,
                     a, a_off, l, l_off):
    """Inter-block edge recording: the var-tx split tree is decomposed
    into a per-4x4 tx-size map, then block and inner-tx edges land in
    the frame edge planes (same edge semantics as reference
    mask_edges_inter, src/lf_mask.c:79-147)."""
    ti = tables.txfm_info()
    if _native is not None:
        stride = wd_y.shape[2]
        _native.dtpu_mask_edges_inter(
            wd_y.ctypes.data, wd_y.ctypes.data + wd_y.strides[0],
            stride, by, bx, w4, h4, skip, max_tx,
            int(tx_masks[0]), int(tx_masks[1]), ti.ctypes.data,
            a.ctypes.data + a_off, l.ctypes.data + l_off)
        return
    t_dim = ti[max_tx]
    tw, th = int(t_dim[0]), int(t_dim[1])
    txa = np.zeros((2, 2, 32, 32), dtype=np.uint8)
    y_off = 0
    y = 0
    while y < h4:
        x_off = 0
        x = 0
        while x < w4:
            _decomp_tx(txa, max_tx, 0, y_off, x_off, tx_masks, y, x)
            x += tw
            x_off += 1
        y += th
        y_off += 1

    # block edges
    wd_y[0, by : by + h4, bx] = 1 + np.minimum(txa[0, 0, :h4, 0],
                                               l[l_off : l_off + h4])
    wd_y[1, by, bx : bx + w4] = 1 + np.minimum(txa[1, 0, 0, :w4],
                                               a[a_off : a_off + w4])

    if not skip:
        # inner tx edges: class = min of the adjacent tx sizes
        for y in range(h4):
            ltx = int(txa[0, 0, y, 0])
            x = int(txa[0, 1, y, 0])
            while x < w4:
                rtx = int(txa[0, 0, y, x])
                wd_y[0, by + y, bx + x] = 1 + min(rtx, ltx)
                ltx = rtx
                x += int(txa[0, 1, y, x])
        for x in range(w4):
            ttx = int(txa[1, 0, 0, x])
            y = int(txa[1, 1, 0, x])
            while y < h4:
                btx = int(txa[1, 0, y, x])
                wd_y[1, by + y, bx + x] = 1 + min(ttx, btx)
                ttx = btx
                y += int(txa[1, 1, y, x])

    l[l_off : l_off + h4] = txa[0, 0, :h4, w4 - 1]
    a[a_off : a_off + w4] = txa[1, 0, h4 - 1, :w4]


def create_lf_mask_inter(f, level_cache, filter_level, bx, by, iw, ih,
                         skip, bs, max_ytx, tx_masks, uvtx, layout,
                         ay, ay_off, ly, ly_off, auv, auv_off, luv, luv_off):
    """reference dav1d_create_lf_mask_inter (src/lf_mask.c:322-384)."""
    b_dim = tables.block_dimensions[bs]
    bw4 = min(iw - bx, int(b_dim[0]))
    bh4 = min(ih - by, int(b_dim[1]))

    if bw4 and bh4:
        level_cache[by : by + bh4, bx : bx + bw4, 0] = filter_level[0][0][0]
        level_cache[by : by + bh4, bx : bx + bw4, 1] = filter_level[1][0][0]
        mask_edges_inter(f.lf_wd_y, by, bx, bw4, bh4, skip, max_ytx,
                         tx_masks, ay, ay_off, ly, ly_off)

    if auv is None:
        return
    ss_ver = int(layout == PixelLayout.I420)
    ss_hor = int(layout != PixelLayout.I444)
    cbw4 = min(((iw + ss_hor) >> ss_hor) - (bx >> ss_hor),
               (int(b_dim[0]) + ss_hor) >> ss_hor)
    cbh4 = min(((ih + ss_ver) >> ss_ver) - (by >> ss_ver),
               (int(b_dim[1]) + ss_ver) >> ss_ver)
    if cbw4 <= 0 or cbh4 <= 0:
        return
    cy, cx = by >> ss_ver, bx >> ss_hor
    level_cache[cy : cy + cbh4, cx : cx + cbw4, 2] = filter_level[2][0][0]
    level_cache[cy : cy + cbh4, cx : cx + cbw4, 3] = filter_level[3][0][0]
    mask_edges_chroma(f.lf_wd_uv, cy, cx, cbw4, cbh4, skip, uvtx,
                      auv, auv_off, luv, luv_off)
