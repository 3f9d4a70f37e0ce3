"""Loop restoration: stripe/unit geometry + wiener and self-guided filters.

Behavioral parity with reference src/lr_apply_tmpl.c (lr_sbrow :108,
lr_stripe :36) and src/looprestoration_tmpl.c (wiener_c :250, sgr_3x3_c
:679, sgr_5x5_c :825, sgr_mix_c :1040). The reference's row-pipelined
formulation is re-expressed as an explicit padded-unit buffer:

  * interior = post-CDEF pixels of the unit (out-of-place reads make the
    reference's 4-px "left" backup unnecessary)
  * 3 rows above/below a stripe come from the *deblocked pre-CDEF* frame
    (the reference's lpf line buffer, dav1d_copy_lpf src/lf_apply_tmpl.c:104)
    as [A1, A1, A2] / [B1, B2, B2], clamped at most 2 rows outside the
    stripe (AV1 spec 7.17)
  * absent edges replicate the outermost row/column.
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..headers import RestorationType as RT

LR_HAVE_LEFT = 1
LR_HAVE_RIGHT = 2
LR_HAVE_TOP = 4
LR_HAVE_BOTTOM = 8


def lr_frame(f, geom_sink=None) -> None:
    """Apply loop restoration to the whole frame (called after CDEF and
    super-res; reference dav1d_lr_sbrow per sbrow).

    With `geom_sink` (a dict), no pixels are touched: every stripe's
    geometry + filter params are collected per (unit_w, stripe_h[,
    variant]) group for the device-resident chain (recon/device_chain),
    which gathers the padded units straight from the resident planes."""
    if not f.restore_planes:
        return
    hdr = f.frame_hdr
    if geom_sink is not None:
        f._lr_geom_sink = geom_sink
        f._lr_wiener_sink = f._lr_sgr_sink = None
        for pl in range(3):
            if not ((f.restore_planes >> pl) & 1):
                continue
            ss_ver = int(bool(pl)) and f.ss_ver
            ss_hor = int(bool(pl)) and f.ss_hor
            h = (hdr.height + ss_ver) >> ss_ver
            w = ((hdr.width[1]) + ss_hor) >> ss_hor
            shift = (6 - ss_ver) + f.seq_hdr.sb128
            for sby in range(f.sbh):
                not_last = sby + 1 < f.sbh
                next_row_y = (sby + 1) << shift
                row_h = min(next_row_y - (8 >> ss_ver) * not_last, h)
                offset = (8 >> ss_ver) * (sby != 0)
                y_stripe = (sby << shift) - offset
                _lr_plane_sbrow(f, pl, None, y_stripe, w, h, row_h,
                                ss_ver, ss_hor)
        f._lr_geom_sink = None
        return
    f._lr_geom_sink = None
    src_planes = [p.copy() for p in f.sr_planes]  # post-CDEF+SR input
    # with no sink the stripe filters run on the host, in place
    f._lr_wiener_sink = f._lr_sgr_sink = None
    for pl in range(3):
        if not ((f.restore_planes >> pl) & 1):
            continue
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        h = (hdr.height + ss_ver) >> ss_ver
        w = ((hdr.width[1]) + ss_hor) >> ss_hor
        shift = (6 - ss_ver) + f.seq_hdr.sb128
        for sby in range(f.sbh):
            not_last = sby + 1 < f.sbh
            next_row_y = (sby + 1) << shift
            row_h = min(next_row_y - (8 >> ss_ver) * not_last, h)
            offset = (8 >> ss_ver) * (sby != 0)
            y_stripe = (sby << shift) - offset
            _lr_plane_sbrow(f, pl, src_planes[pl], y_stripe, w, h, row_h,
                            ss_ver, ss_hor)


def _lr_plane_sbrow(f, pl, src, y, w, h, row_h, ss_ver, ss_hor) -> None:
    """reference lr_sbrow (src/lr_apply_tmpl.c:108-166)."""
    hdr = f.frame_hdr
    unit_size_log2 = hdr.restoration.unit_size[int(bool(pl))]
    unit_size = 1 << unit_size_log2
    half_unit = unit_size >> 1
    max_unit_size = unit_size + half_unit
    row_y = y + (8 >> ss_ver) * (y != 0)
    shift_hor = 7 - ss_hor

    edges = (LR_HAVE_TOP if y > 0 else 0) | LR_HAVE_RIGHT

    aligned_unit_pos = row_y & ~(unit_size - 1)
    if aligned_unit_pos and aligned_unit_pos + half_unit > h:
        aligned_unit_pos -= unit_size
    aligned_unit_pos <<= ss_ver
    sb_idx_base = (aligned_unit_pos >> 7) * f.sr_sb128w
    unit_idx0 = ((aligned_unit_pos >> 6) & 1) << 1

    # full units while >= 1.5 units remain; the final unit extends to the
    # frame edge (reference lr_sbrow :145-164)
    xs = []
    x = 0
    while x + max_unit_size <= w:
        xs.append((x, unit_size))
        x += unit_size
    xs.append((x, w - x))
    for x, unit_w in xs:
        e = edges | (LR_HAVE_LEFT if x > 0 else 0)
        if x + unit_w >= w:
            e &= ~LR_HAVE_RIGHT
        u_idx = unit_idx0 + ((x >> (shift_hor - 1)) & 1)
        lr = f.lr_units.get((sb_idx_base + (x >> shift_hor), pl, u_idx))
        if lr is not None and lr["type"] != RT.NONE:
            _lr_stripes(f, pl, src, x, y, unit_w, row_h, lr, e, ss_ver, h)


def _lr_stripes(f, pl, src, x, y, unit_w, row_h, lr, edges, ss_ver,
                h) -> None:
    """reference lr_stripe (src/lr_apply_tmpl.c:36-100)."""
    sb128 = f.seq_hdr.sb128
    bitdepth = f.bitdepth
    stripe_h = min((64 - 8 * (y == 0)) >> ss_ver, row_h - y)
    ty = lr["type"]
    if getattr(f, "_lr_geom_sink", None) is None:
        out = f.sr_planes[pl]
        pre_cdef = f.pre_cdef[pl]
    # the sbrow this stripe run belongs to -- loop-invariant (reference
    # lr_stripe computes it once from the starting y)
    sby = (y + ((8 << ss_ver) if y else 0)) >> ((6 - ss_ver) + sb128)

    geom = getattr(f, "_lr_geom_sink", None)
    while y + stripe_h <= row_h:
        have_bottom = sby + 1 != f.sbh or y + stripe_h != row_h
        e = (edges & ~LR_HAVE_BOTTOM) | (LR_HAVE_BOTTOM if have_bottom
                                         else 0)
        if geom is not None:
            # device-resident chain: record geometry + params only
            if ty == RT.WIENER:
                geom.setdefault(("w", unit_w, stripe_h), []).append(
                    (pl, x, y, e, h, lr["filter_h"], lr["filter_v"]))
            else:
                sgr_idx = lr["type"] - int(RT.SGRPROJ)
                s0 = int(tables.sgr_params[sgr_idx][0])
                s1 = int(tables.sgr_params[sgr_idx][1])
                w0 = lr["sgr_weights"][0]
                w1 = 128 - (lr["sgr_weights"][0] + lr["sgr_weights"][1])
                variant = 2 if (s0 and s1) else (0 if s0 else 1)
                geom.setdefault(("s", unit_w, stripe_h, variant),
                                []).append(
                    (pl, x, y, e, h, s0, s1, w0, w1))
            y += stripe_h
            edges |= LR_HAVE_TOP
            stripe_h = min(64 >> ss_ver, row_h - y)
            if stripe_h == 0:
                break
            continue
        P = _pad_unit(src, pre_cdef, x, y, unit_w, stripe_h, h, e)
        if ty == RT.WIENER:
            sink = getattr(f, "_lr_wiener_sink", None)
            if sink is not None:
                sink.setdefault((unit_w, stripe_h), []).append(
                    (P, lr["filter_h"], lr["filter_v"], pl, y, x))
                blk = None
            else:
                blk = _wiener(P, lr["filter_h"], lr["filter_v"], unit_w,
                              stripe_h, bitdepth)
        else:
            sink = getattr(f, "_lr_sgr_sink", None)
            if sink is not None:
                sgr_idx = lr["type"] - int(RT.SGRPROJ)
                s0 = int(tables.sgr_params[sgr_idx][0])
                s1 = int(tables.sgr_params[sgr_idx][1])
                w0 = lr["sgr_weights"][0]
                w1 = 128 - (lr["sgr_weights"][0] + lr["sgr_weights"][1])
                variant = 2 if (s0 and s1) else (0 if s0 else 1)
                sink.setdefault((unit_w, stripe_h, variant), []).append(
                    (P, src[y : y + stripe_h, x : x + unit_w], s0, s1,
                     w0, w1, pl, y, x))
                blk = None
            else:
                blk = _sgr(P, src[y : y + stripe_h, x : x + unit_w], lr,
                           unit_w, stripe_h, bitdepth)
        if blk is not None:
            out[y : y + stripe_h, x : x + unit_w] = blk
        y += stripe_h
        edges |= LR_HAVE_TOP
        stripe_h = min(64 >> ss_ver, row_h - y)
        if stripe_h == 0:
            break


def _pad_unit_indices(x0, y0, unit_w, stripe_h, h, edges, W, H):
    """Gather-index form of _pad_unit for the device-resident chain:
    the source is S = concat(post-CDEF plane, pre-CDEF plane) (2H rows);
    returns (rows (stripe_h+6,), cols (unit_w+6,)) with
    P = S[rows][:, cols]."""
    cols = np.arange(x0 - 3, x0 + unit_w + 3)
    if not (edges & LR_HAVE_LEFT):
        cols = np.maximum(cols, x0)
    if not (edges & LR_HAVE_RIGHT):
        cols = np.minimum(cols, x0 + unit_w - 1)
    cols = np.clip(cols, 0, W - 1)
    rows = np.empty(stripe_h + 6, dtype=np.int64)
    rows[3 : 3 + stripe_h] = np.arange(y0, y0 + stripe_h)
    if edges & LR_HAVE_TOP:
        rows[0] = rows[1] = H + y0 - 2
        rows[2] = H + y0 - 1
    else:
        rows[0:3] = y0
    if edges & LR_HAVE_BOTTOM:
        rows[3 + stripe_h] = H + y0 + stripe_h
        rows[4 + stripe_h] = rows[5 + stripe_h] = \
            H + min(y0 + stripe_h + 1, h - 1)
    else:
        rows[3 + stripe_h :] = y0 + stripe_h - 1
    return rows.astype(np.int32), cols.astype(np.int32)


def _pad_unit(src, pre_cdef, x0, y0, unit_w, stripe_h, h, edges):
    """(stripe_h+6, unit_w+6) padded source buffer."""
    cols = np.arange(x0 - 3, x0 + unit_w + 3)
    if not (edges & LR_HAVE_LEFT):
        cols = np.maximum(cols, x0)
    if not (edges & LR_HAVE_RIGHT):
        cols = np.minimum(cols, x0 + unit_w - 1)
    cols = np.clip(cols, 0, src.shape[1] - 1)

    P = np.zeros((stripe_h + 6, unit_w + 6), dtype=np.int64)
    P[3 : 3 + stripe_h] = src[y0 : y0 + stripe_h][:, cols]
    if edges & LR_HAVE_TOP:
        a1 = pre_cdef[y0 - 2][cols]
        a2 = pre_cdef[y0 - 1][cols]
        P[0] = a1
        P[1] = a1
        P[2] = a2
    else:
        P[0:3] = P[3]
    if edges & LR_HAVE_BOTTOM:
        b1 = pre_cdef[y0 + stripe_h][cols]
        b2 = pre_cdef[min(y0 + stripe_h + 1, h - 1)][cols]
        P[3 + stripe_h] = b1
        P[4 + stripe_h] = b2
        P[5 + stripe_h] = b2
    else:
        P[3 + stripe_h :] = P[2 + stripe_h]
    return P


def _wiener(P, fh, fv, unit_w, stripe_h, bitdepth):
    """7-tap separable wiener (reference wiener_filter_h/v,
    src/looprestoration_tmpl.c:44-190)."""
    wh = np.array([fh[0], fh[1], fh[2], 128 - 2 * (fh[0] + fh[1] + fh[2]),
                   fh[2], fh[1], fh[0]], dtype=np.int64)
    wv = np.array([fv[0], fv[1], fv[2], 128 - 2 * (fv[0] + fv[1] + fv[2]),
                   fv[2], fv[1], fv[0]], dtype=np.int64)
    rb_h = 3 + (bitdepth == 12) * 2
    clip_limit = 1 << (bitdepth + 1 + 7 - rb_h)
    mid = sum(wh[i] * P[:, i : i + unit_w] for i in range(7))
    mid += (1 << (bitdepth + 6)) + (1 << (rb_h - 1))
    mid = np.clip(mid >> rb_h, 0, clip_limit - 1)

    rb_v = 11 - (bitdepth == 12) * 2
    round_offset = 1 << (bitdepth + rb_v - 1)
    out = sum(wv[k] * mid[k : k + stripe_h] for k in range(7))
    out = (out - round_offset + (1 << (rb_v - 1))) >> rb_v
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)


def _box_h(P, r):
    """Horizontal (2r+1)-box sums of the padded buffer: returns (sum, sumsq)
    of shape (rows, unit_w+2) covering x in [-1, unit_w]."""
    n = 2 * r + 1
    w2 = P.shape[1] - 6 + 2  # unit_w + 2; entries centered at x in [-1, w]
    su = np.zeros((P.shape[0], w2), dtype=np.int64)
    sq = np.zeros((P.shape[0], w2), dtype=np.int64)
    for i in range(n):
        c = P[:, 2 - r + i : 2 - r + i + w2]
        su += c
        sq += c * c
    return su, sq


def _sgr_calc_ab(su, sq, s, n, one_by_x, bitdepth):
    """reference sgr_calc_row_ab (src/looprestoration_tmpl.c:505-523)."""
    bdm8 = bitdepth - 8
    a = (sq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8)
    b = (su + ((1 << bdm8) >> 1)) >> bdm8
    p = np.maximum(a * n - b * b, 0)
    z = (p * s + (1 << 19)) >> 20
    xv = tables.sgr_x_by_x[np.minimum(z, 255)].astype(np.int64)
    A = (xv * su * one_by_x + (1 << 11)) >> 12
    B = xv
    return A, B


def _sgr(P, src_unit, lr, unit_w, stripe_h, bitdepth):
    """Self-guided restoration (5x5 / 3x3 / mix)."""
    sgr_idx = lr["type"] - int(RT.SGRPROJ)
    s0, s1 = int(tables.sgr_params[sgr_idx][0]), \
        int(tables.sgr_params[sgr_idx][1])
    w0 = lr["sgr_weights"][0]
    w1 = 128 - (lr["sgr_weights"][0] + lr["sgr_weights"][1])
    src = src_unit.astype(np.int64)

    tmp5 = tmp3 = None
    if s0:
        tmp5 = _sgr_5x5_tmp(P, src, s0, unit_w, stripe_h, bitdepth)
    if s1:
        tmp3 = _sgr_3x3_tmp(P, src, s1, unit_w, stripe_h, bitdepth)

    if s0 and s1:
        v = w0 * tmp5 + w1 * tmp3
    elif s0:
        v = w0 * tmp5
    else:
        v = w1 * tmp3
    out = src + ((v + (1 << 10)) >> 11)
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)


def _sgr_3x3_tmp(P, src, s, unit_w, stripe_h, bitdepth):
    """3x3 pass -> per-pixel tmp (reference sgr_finish_filter_row1)."""
    # AB rows y in [-1, stripe_h]: box rows y-1..y+1 (P rows y+2..y+4)
    su, sq = _box_h(P, 1)
    nrows = stripe_h + 2
    A = np.zeros((nrows, unit_w + 2), dtype=np.int64)
    B = np.zeros((nrows, unit_w + 2), dtype=np.int64)
    for k, y in enumerate(range(-1, stripe_h + 1)):
        s3 = su[y + 2] + su[y + 3] + su[y + 4]
        q3 = sq[y + 2] + sq[y + 3] + sq[y + 4]
        A[k], B[k] = _sgr_calc_ab(s3, q3, s, 9, 455, bitdepth)

    def eight(M, j):
        c = M[j + 1]
        up, dn = M[j], M[j + 2]
        return ((c[1:-1] + c[:-2] + c[2:] + up[1:-1] + dn[1:-1]) * 4
                + (up[:-2] + dn[:-2] + up[2:] + dn[2:]) * 3)

    tmp = np.zeros((stripe_h, unit_w), dtype=np.int64)
    for j in range(stripe_h):
        a = eight(B, j)
        b = eight(A, j)
        tmp[j] = (b - a * src[j] + (1 << 8)) >> 9
    return tmp


def _sgr_5x5_tmp(P, src, s, unit_w, stripe_h, bitdepth):
    """5x5 pass -> per-pixel tmp (reference sgr_finish_filter2): AB on odd
    rows; even output rows blend the two surrounding AB rows (weights 6/5,
    shift 9), odd rows use the single AB row (shift 8)."""
    su, sq = _box_h(P, 2)
    ab = {}

    def get_ab(y):  # y odd, in [-1, stripe_h]
        if y not in ab:
            s5 = sum(su[y + 1 + i] for i in range(5))
            q5 = sum(sq[y + 1 + i] for i in range(5))
            ab[y] = _sgr_calc_ab(s5, q5, s, 25, 164, bitdepth)
        return ab[y]

    def six2(Mu, Md):
        return ((Mu[1:-1] + Md[1:-1]) * 6 + (Mu[:-2] + Md[:-2]
                                             + Mu[2:] + Md[2:]) * 5)

    def six1(M):
        return M[1:-1] * 6 + (M[:-2] + M[2:]) * 5

    tmp = np.zeros((stripe_h, unit_w), dtype=np.int64)
    for j in range(stripe_h):
        if j % 2 == 0:
            Au, Bu = get_ab(j - 1)
            Ad, Bd = get_ab(j + 1)
            a = six2(Bu, Bd)
            b = six2(Au, Ad)
            tmp[j] = (b - a * src[j] + (1 << 8)) >> 9
        else:
            A1, B1 = get_ab(j)
            a = six1(B1)
            b = six1(A1)
            tmp[j] = (b - a * src[j] + (1 << 7)) >> 8
    return tmp
