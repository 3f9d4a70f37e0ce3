"""Reference-MV prediction: spatial scans, candidate stack, contexts.

Behavioral parity with reference src/refmvs.c (dav1d_refmvs_find :348,
scan_row/col :97-170, extended candidates :238-330, init_frame :804; AV1
spec 7.10.2). The per-4x4 MV grid is allocated full-frame (the reference's
35-row ring buffer is a memory optimisation for its threading model);
temporal MV projection (save/load_tmvs) follows the same structures.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import tables
from .headers import WarpedMotionType
from .intra_edge import EDGE_I444_TOP_HAS_RIGHT
from .native import lib as _native

INVALID_MV_Y = -32768  # mv.n == 0x80008000 marker (y == x == -32768)

RB_DT = np.dtype([
    ("mv", np.int16, (2, 2)),  # [n][0]=y, [n][1]=x
    ("ref", np.int8, (2,)),
    ("bs", np.uint8),
    ("mf", np.uint8),  # bit0: globalmv, bit1: newmv
])


def mv_is_invalid(m) -> bool:
    return m[0] == INVALID_MV_Y and m[1] == INVALID_MV_Y


def fix_int_mv_precision(y, x):
    x = (x - (x >> 15) + 3) & ~7
    y = (y - (y >> 15) + 3) & ~7
    return _s16(y), _s16(x)


def _s16(v):
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def fix_mv_precision(hdr, y, x):
    if hdr.force_integer_mv:
        return fix_int_mv_precision(y, x)
    if not hdr.hp:
        x = (x - (x >> 15)) & ~1
        y = (y - (y >> 15)) & ~1
        return _s16(y), _s16(x)
    return y, x


def apply_sign(v, s):
    return -v if s < 0 else v


def get_gmv_2d(gmv, bx4, by4, bw4, bh4, hdr):
    """reference env.h:478-520; returns (y, x)."""
    if gmv.type == WarpedMotionType.IDENTITY:
        return (0, 0)
    if gmv.type == WarpedMotionType.TRANSLATION:
        y = gmv.matrix[0] >> 13
        x = gmv.matrix[1] >> 13
        if hdr.force_integer_mv:
            return fix_int_mv_precision(y, x)
        return (y, x)
    x = bx4 * 4 + bw4 * 2 - 1
    y = by4 * 4 + bh4 * 2 - 1
    xc = (gmv.matrix[2] - (1 << 16)) * x + gmv.matrix[3] * y + gmv.matrix[0]
    yc = (gmv.matrix[5] - (1 << 16)) * y + gmv.matrix[4] * x + gmv.matrix[1]
    shift = 16 - (3 - (not hdr.hp))
    rnd = (1 << shift) >> 1
    res_y = apply_sign(((abs(yc) + rnd) >> shift) << (not hdr.hp), yc)
    res_x = apply_sign(((abs(xc) + rnd) >> shift) << (not hdr.hp), xc)
    if hdr.force_integer_mv:
        return fix_int_mv_precision(res_y, res_x)
    return (res_y, res_x)


TMV_DT = np.dtype([
    ("mv", np.int16, (2,)),  # [0]=y, [1]=x
    ("ref", np.int8),
])

INVALID_REF2CUR = -(1 << 7)

# mv_projection division table (reference src/refmvs.c:176-181; AV1 spec
# 7.9.3 Div_Mult)
_DIV_MULT = np.array([
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340,
    2048, 1820, 1638, 1489, 1365, 1260, 1170, 1092,
    1024, 963, 910, 862, 819, 780, 744, 712,
    682, 655, 630, 606, 585, 564, 546, 528], dtype=np.int32)


def mv_projection(mvy, mvx, num, den):
    """Scale an MV by num/den with spec 7.9.3 rounding
    (reference mv_projection, src/refmvs.c:175-192)."""
    frac = num * int(_DIV_MULT[den])
    y = mvy * frac
    x = mvx * frac
    return (max(-0x3FFF, min(0x3FFF, (y + 8192 + (-1 if y < 0 else 0)) >> 14)),
            max(-0x3FFF, min(0x3FFF, (x + 8192 + (-1 if x < 0 else 0)) >> 14)))


class RefMvsFrame:
    """Full-frame 4x4 MV grid + frame-level temporal MV setup
    (reference dav1d_refmvs_init_frame, src/refmvs.c:805-905)."""

    def __init__(self, seq_hdr, frm_hdr, ref_poc=None, ref_ref_poc=None,
                 rp_ref=None):
        self.frm_hdr = frm_hdr
        self.seq_hdr = seq_hdr
        self.iw8 = (frm_hdr.width[0] + 7) >> 3
        self.ih8 = (frm_hdr.height + 7) >> 3
        self.iw4 = self.iw8 << 1
        self.ih4 = self.ih8 << 1
        stride = ((frm_hdr.width[0] + 127) & ~127) >> 2
        h = ((frm_hdr.height + 127) & ~127) >> 2
        self.r = np.zeros((h + 1, stride), dtype=RB_DT)
        self.rp_stride = stride >> 1
        # current-frame temporal MVs (8x8 units), saved for future frames
        self.rp = np.zeros((h >> 1, self.rp_stride), dtype=TMV_DT)
        # projected MVs of this frame's mfmv references (full-frame rather
        # than the reference's 16-row ring: same values, simpler indexing)
        self.rp_proj = np.zeros((h >> 1, self.rp_stride), dtype=TMV_DT)
        self.sign_bias = [0] * 7
        self.mfmv_sign = [0] * 7
        self.pocdiff = [0] * 7
        from .obu import get_poc_diff
        poc = frm_hdr.frame_offset
        n_bits = seq_hdr.order_hint_n_bits
        if ref_poc is not None:
            for i in range(7):
                d = get_poc_diff(n_bits, ref_poc[i], poc)
                self.sign_bias[i] = int(d > 0)
                self.mfmv_sign[i] = int(d < 0)
                self.pocdiff[i] = max(-31, min(31, get_poc_diff(
                    n_bits, poc, ref_poc[i])))

        # motion-field MV reference selection
        self.n_mfmvs = 0
        self.mfmv_ref = []
        self.mfmv_ref2cur = []
        self.mfmv_ref2ref = []
        self.rp_ref = rp_ref or [None] * 7
        if frm_hdr.use_ref_frame_mvs and n_bits and ref_poc is not None \
                and ref_ref_poc is not None:
            total = 2
            if self.rp_ref[0] is not None and \
                    ref_ref_poc[0][6] != ref_poc[3]:  # alt-of-last != gold
                self.mfmv_ref.append(0)  # last
                total = 3
            if self.rp_ref[4] is not None and \
                    get_poc_diff(n_bits, ref_poc[4], poc) > 0:
                self.mfmv_ref.append(4)  # bwd
            if self.rp_ref[5] is not None and \
                    get_poc_diff(n_bits, ref_poc[5], poc) > 0:
                self.mfmv_ref.append(5)  # altref2
            if len(self.mfmv_ref) < total and self.rp_ref[6] is not None \
                    and get_poc_diff(n_bits, ref_poc[6], poc) > 0:
                self.mfmv_ref.append(6)  # altref
            if len(self.mfmv_ref) < total and self.rp_ref[1] is not None:
                self.mfmv_ref.append(1)  # last2
            for ref in self.mfmv_ref:
                rpoc = ref_poc[ref]
                diff1 = get_poc_diff(n_bits, rpoc, poc)
                if abs(diff1) > 31:
                    self.mfmv_ref2cur.append(INVALID_REF2CUR)
                    self.mfmv_ref2ref.append([0] * 7)
                else:
                    self.mfmv_ref2cur.append(-diff1 if ref < 4 else diff1)
                    r2r = []
                    for m in range(7):
                        diff2 = get_poc_diff(n_bits, rpoc,
                                             ref_ref_poc[ref][m])
                        r2r.append(0 if diff2 > 31 or diff2 < 0 else diff2)
                    self.mfmv_ref2ref.append(r2r)
            self.n_mfmvs = len(self.mfmv_ref)
        self.use_ref_frame_mvs = self.n_mfmvs > 0


def load_tmvs(rf: RefMvsFrame, col_start8, col_end8, row_start8, row_end8):
    """Project the mfmv references' saved MVs into rf.rp_proj for the sbrow
    rows [row_start8, row_end8) (reference load_tmvs_c, src/refmvs.c:691-761).
    Per-cell formulation: the reference's identical-block run loop writes
    each 8x8 cell with per-cell window checks, so cell-wise iteration is
    exact."""
    nat = _nat_frame(rf)
    if nat is not None:
        _native.dtpu_load_tmvs(ctypes.byref(nat), col_start8, col_end8,
                               row_start8, row_end8)
        return
    row_end8 = min(row_end8, rf.ih8)
    col_start8i = max(col_start8 - 8, 0)
    col_end8i = min(col_end8 + 8, rf.iw8)

    rp_proj = rf.rp_proj
    rp_proj["mv"][row_start8:row_end8, col_start8:col_end8] = INVALID_MV_Y
    for n in range(rf.n_mfmvs):
        ref2cur = rf.mfmv_ref2cur[n]
        if ref2cur == INVALID_REF2CUR:
            continue
        ref = rf.mfmv_ref[n]
        ref_sign = ref - 4
        r = rf.rp_ref[ref]
        ref2ref_n = rf.mfmv_ref2ref[n]
        for y in range(row_start8, row_end8):
            y_sb_align = y & ~7
            y_proj_start = max(y_sb_align, row_start8)
            y_proj_end = min(y_sb_align + 8, row_end8)
            row = r[y]
            for x in range(col_start8i, col_end8i):
                b_ref = int(row[x]["ref"])
                if not b_ref:
                    continue
                ref2ref = ref2ref_n[b_ref - 1]
                if not ref2ref:
                    continue
                b_mvy = int(row[x]["mv"][0])
                b_mvx = int(row[x]["mv"][1])
                oy, ox = mv_projection(b_mvy, b_mvx, ref2cur, ref2ref)
                pos_y = y + (-(abs(oy) >> 6) if (oy ^ ref_sign) < 0
                             else (abs(oy) >> 6))
                if not (y_proj_start <= pos_y < y_proj_end):
                    continue
                pos_x = x + (-(abs(ox) >> 6) if (ox ^ ref_sign) < 0
                             else (abs(ox) >> 6))
                x_sb_align = x & ~7
                if max(x_sb_align - 8, col_start8) <= pos_x < \
                        min(x_sb_align + 16, col_end8):
                    rp_proj[pos_y, pos_x]["mv"][0] = b_mvy
                    rp_proj[pos_y, pos_x]["mv"][1] = b_mvx
                    rp_proj[pos_y, pos_x]["ref"] = ref2ref


def save_tmvs(rf: RefMvsFrame, col_start8, col_end8, row_start8, row_end8):
    """Store the frame's decoded MVs (8x8 granularity, bottom-right 4x4
    sample) into rf.rp for future frames' temporal prediction
    (reference save_tmvs_c, src/refmvs.c:763-803; per-8x8 evaluation is
    exact because splat_mv fills all 4x4s of a block identically)."""
    nat = _nat_frame(rf)
    if nat is not None:
        sign = np.ascontiguousarray(rf.mfmv_sign, dtype=np.uint8)
        _native.dtpu_save_tmvs(ctypes.byref(nat), sign.ctypes.data,
                               col_start8, col_end8, row_start8, row_end8)
        return
    row_end8 = min(row_end8, rf.ih8)
    col_end8 = min(col_end8, rf.iw8)
    if row_end8 <= row_start8 or col_end8 <= col_start8:
        return
    cand = rf.r[row_start8 * 2 + 1 : row_end8 * 2 : 2,
                col_start8 * 2 + 1 : col_end8 * 2 : 2]
    ref_sign = np.asarray(rf.mfmv_sign + [0], dtype=np.uint8)
    refs = cand["ref"]  # (h8, w8, 2)
    mvs = cand["mv"].astype(np.int32)  # (h8, w8, 2, 2)
    small = (np.abs(mvs[..., 0]) | np.abs(mvs[..., 1])) < 4096  # (h8,w8,2)
    eligible = (refs > 0) & ref_sign[np.clip(refs - 1, 0, 7)].astype(bool) \
        & small
    out = np.zeros(refs.shape[:2], dtype=TMV_DT)
    use1 = eligible[..., 1]
    use0 = eligible[..., 0] & ~use1
    for idx, use in ((1, use1), (0, use0)):
        out["mv"][use] = cand["mv"][..., idx, :][use]
        out["ref"][use] = refs[..., idx][use]
    rf.rp[row_start8:row_end8, col_start8:col_end8] = out


class RefMvsTile:
    def __init__(self, rf: RefMvsFrame, col_start4, col_end4, row_start4,
                 row_end4):
        self.rf = rf
        self.tile_col = (col_start4, min(col_end4, rf.iw4))
        self.tile_row = (row_start4, min(row_end4, rf.ih4))


# Native (C) fast path: one DtpuRefMvsFrame mirror per RefMvsFrame
# (native/refmvs.c, bit-identical; the Python functions below remain the
# reference/fallback).

_MVCAND_DT = np.dtype([("mv", np.int32, (2, 2)), ("weight", np.int32)])


def _nat_frame(rf: RefMvsFrame):
    """Build (and cache) the ctypes mirror; returns None when the native
    path can't be used (lib missing, or a saved tmv plane has a different
    stride after a resolution switch)."""
    nat = getattr(rf, "_nat", False)
    if nat is not False:
        return nat
    if _native is None:
        rf._nat = None
        return None
    from .native import CRefMvsFrame
    c = CRefMvsFrame()
    ok = True
    c.r = rf.r.ctypes.data
    c.rp = rf.rp.ctypes.data
    for i in range(7):
        a = rf.rp_ref[i]
        if a is None:
            c.rp_ref[i] = None
        else:
            if a.shape[1] != rf.rp_stride or not a.flags.c_contiguous:
                ok = False
            c.rp_ref[i] = a.ctypes.data
    c.rp_proj = rf.rp_proj.ctypes.data
    c.r_stride = rf.r.shape[1]
    c.rp_stride = rf.rp_stride
    c.iw4, c.ih4, c.iw8, c.ih8 = rf.iw4, rf.ih4, rf.iw8, rf.ih8
    for i in range(7):
        c.sign_bias[i] = int(rf.sign_bias[i])
        c.mfmv_sign[i] = int(rf.mfmv_sign[i])
        c.pocdiff[i] = int(rf.pocdiff[i])
    c.n_mfmvs = rf.n_mfmvs
    for i in range(rf.n_mfmvs):
        c.mfmv_ref[i] = int(rf.mfmv_ref[i])
        c.mfmv_ref2cur[i] = int(rf.mfmv_ref2cur[i])
        for m in range(7):
            c.mfmv_ref2ref[i][m] = int(rf.mfmv_ref2ref[i][m])
    hdr = rf.frm_hdr
    c.use_ref_frame_mvs = int(rf.use_ref_frame_mvs)
    c.force_integer_mv = int(hdr.force_integer_mv)
    c.hp = int(hdr.hp)
    c.use_frame_ref_mvs_hdr = int(hdr.use_ref_frame_mvs)
    for i in range(7):
        g = hdr.gmv[i]
        c.gmv[i].type = int(g.type)
        for m in range(6):
            c.gmv[i].matrix[m] = int(g.matrix[m])
    rf._nat = c if ok else None
    if ok:
        rf._nat_stack = np.zeros(8, dtype=_MVCAND_DT)
        rf._nat_ctx = ctypes.c_int(0)
    return rf._nat


def splat_mv(rf: RefMvsFrame, by4, bx4, bw4, bh4, mv0, mv1, ref0, ref1,
             bs, mf):
    nat = _nat_frame(rf)
    if nat is not None:
        _native.dtpu_splat_mv(ctypes.byref(nat), by4, bx4, bw4, bh4,
                              int(mv0[0]), int(mv0[1]),
                              int(mv1[0]), int(mv1[1]),
                              int(ref0), int(ref1), int(bs), int(mf))
        return
    blk = np.zeros((), dtype=RB_DT)
    blk["mv"][0] = mv0
    blk["mv"][1] = mv1
    blk["ref"][0] = ref0
    blk["ref"][1] = ref1
    blk["bs"] = bs
    blk["mf"] = mf
    rf.r[by4 : by4 + bh4, bx4 : bx4 + bw4] = blk


def _add_spatial_candidate(mvstack, weight, b, ref, gmv,
                           flags):
    """reference add_spatial_candidate (src/refmvs.c:40-95).
    flags = [have_newmv_match, have_refmv_match]."""
    bmv = b["mv"]
    if mv_is_invalid(bmv[0]):
        return
    if ref[1] == -1:
        for n in range(2):
            if int(b["ref"][n]) == ref[0]:
                if (int(b["mf"]) & 1) and gmv[0] is not None:
                    cand = gmv[0]
                else:
                    cand = (int(bmv[n][0]), int(bmv[n][1]))
                flags[1] = 1
                flags[0] |= int(b["mf"]) >> 1
                for m in mvstack:
                    if m["mv"][0] == cand:
                        m["weight"] += weight
                        return
                if len(mvstack) < 8:
                    mvstack.append({"mv": [cand, (0, 0)], "weight": weight})
                return
    elif int(b["ref"][0]) == ref[0] and int(b["ref"][1]) == ref[1]:
        c0 = gmv[0] if ((int(b["mf"]) & 1) and gmv[0] is not None) \
            else (int(bmv[0][0]), int(bmv[0][1]))
        c1 = gmv[1] if ((int(b["mf"]) & 1) and gmv[1] is not None) \
            else (int(bmv[1][0]), int(bmv[1][1]))
        flags[1] = 1
        flags[0] |= int(b["mf"]) >> 1
        for m in mvstack:
            if m["mv"][0] == c0 and m["mv"][1] == c1:
                m["weight"] += weight
                return
        if len(mvstack) < 8:
            mvstack.append({"mv": [c0, c1], "weight": weight})


def _scan_row(mvstack, ref, gmv, row, bx4, bw4, w4, max_rows, step, flags):
    """reference scan_row (src/refmvs.c:97-133)."""
    cand_b = row[bx4]
    first_dim = tables.block_dimensions[int(cand_b["bs"])]
    cand_bw4 = int(first_dim[0])
    ln = max(step, min(bw4, cand_bw4))
    if bw4 <= cand_bw4:
        weight = 2 if bw4 == 1 else max(2, min(2 * max_rows, int(first_dim[1])))
        _add_spatial_candidate(mvstack, ln * weight, cand_b, ref, gmv, flags)
        return weight >> 1
    x = 0
    while True:
        _add_spatial_candidate(mvstack, ln * 2, row[bx4 + x], ref, gmv, flags)
        x += ln
        if x >= w4:
            return 1
        cand_bw4 = int(tables.block_dimensions[int(row[bx4 + x]["bs"])][0])
        ln = max(step, cand_bw4)


def _scan_col(mvstack, ref, gmv, r, rows_base, col, bh4, h4, max_cols, step,
              flags):
    """reference scan_col (src/refmvs.c:135-170)."""
    cand_b = r[rows_base, col]
    first_dim = tables.block_dimensions[int(cand_b["bs"])]
    cand_bh4 = int(first_dim[1])
    ln = max(step, min(bh4, cand_bh4))
    if bh4 <= cand_bh4:
        weight = 2 if bh4 == 1 else max(2, min(2 * max_cols, int(first_dim[0])))
        _add_spatial_candidate(mvstack, ln * weight, cand_b, ref, gmv, flags)
        return weight >> 1
    y = 0
    while True:
        _add_spatial_candidate(mvstack, ln * 2, r[rows_base + y, col], ref,
                               gmv, flags)
        y += ln
        if y >= h4:
            return 1
        cand_bh4 = int(tables.block_dimensions[
            int(r[rows_base + y, col]["bs"])][1])
        ln = max(step, cand_bh4)


def _add_temporal_candidate(rf, mvstack, rb, ref, gctx, tgmv):
    """reference add_temporal_candidate (src/refmvs.c:193-236)."""
    if int(rb["mv"][0]) == INVALID_MV_Y and int(rb["mv"][1]) == INVALID_MV_Y:
        return
    rby, rbx = int(rb["mv"][0]), int(rb["mv"][1])
    rbref = int(rb["ref"])
    mv = mv_projection(rby, rbx, rf.pocdiff[ref[0] - 1], rbref)
    mv = fix_mv_precision(rf.frm_hdr, *mv)
    if ref[1] == -1:
        if gctx is not None:
            gctx[0] = int((abs(mv[1] - tgmv[0][1])
                           | abs(mv[0] - tgmv[0][0])) >= 16)
        for m in mvstack:
            if tuple(m["mv"][0]) == mv:
                m["weight"] += 2
                return
        if len(mvstack) < 8:
            mvstack.append({"mv": [mv, (0, 0)], "weight": 2})
    else:
        mv1 = mv_projection(rby, rbx, rf.pocdiff[ref[1] - 1], rbref)
        mv1 = fix_mv_precision(rf.frm_hdr, *mv1)
        for m in mvstack:
            if tuple(m["mv"][0]) == mv and tuple(m["mv"][1]) == mv1:
                m["weight"] += 2
                return
        if len(mvstack) < 8:
            mvstack.append({"mv": [mv, mv1], "weight": 2})


def _add_single_extended(mvstack, cand_b, sign, sign_bias):
    """reference add_single_extended_candidate (src/refmvs.c:332-363)."""
    for n in range(2):
        cand_ref = int(cand_b["ref"][n])
        if cand_ref <= 0:
            break
        cy, cx = int(cand_b["mv"][n][0]), int(cand_b["mv"][n][1])
        if sign ^ sign_bias[cand_ref - 1]:
            cy, cx = -cy, -cx
        for m in mvstack:
            if m["mv"][0] == (cy, cx):
                break
        else:
            mvstack.append({"mv": [(cy, cx), (0, 0)], "weight": 2})


def _add_compound_extended(same, same_count, cand_b, sign0, sign1, ref,
                           sign_bias):
    """reference add_compound_extended_candidate (src/refmvs.c:238-293).
    same: list of 4 slots [same0, same1, diff0, diff1] each {'mv': [m0, m1]}."""
    for n in range(2):
        cand_ref = int(cand_b["ref"][n])
        if cand_ref <= 0:
            break
        cy, cx = int(cand_b["mv"][n][0]), int(cand_b["mv"][n][1])
        if cand_ref == ref[0]:
            if same_count[0] < 2:
                same[same_count[0]]["mv"][0] = (cy, cx)
                same_count[0] += 1
            if same_count[3] < 2:
                if sign1 ^ sign_bias[cand_ref - 1]:
                    my = (-cy, -cx)
                else:
                    my = (cy, cx)
                same[2 + same_count[3]]["mv"][1] = my
                same_count[3] += 1
        elif cand_ref == ref[1]:
            if same_count[1] < 2:
                same[same_count[1]]["mv"][1] = (cy, cx)
                same_count[1] += 1
            if same_count[2] < 2:
                if sign0 ^ sign_bias[cand_ref - 1]:
                    my = (-cy, -cx)
                else:
                    my = (cy, cx)
                same[2 + same_count[2]]["mv"][0] = my
                same_count[2] += 1
        else:
            icand = (-cy, -cx)
            if same_count[2] < 2:
                same[2 + same_count[2]]["mv"][0] = \
                    icand if sign0 ^ sign_bias[cand_ref - 1] else (cy, cx)
                same_count[2] += 1
            if same_count[3] < 2:
                same[2 + same_count[3]]["mv"][1] = \
                    icand if sign1 ^ sign_bias[cand_ref - 1] else (cy, cx)
                same_count[3] += 1


def refmvs_find(rt: RefMvsTile, ref, bs, edge_flags, by4, bx4):
    """Returns (mvstack, n_before_clamp_unused, ctx).
    mvstack entries: {'mv': [(y,x),(y,x)], 'weight': int}
    (reference dav1d_refmvs_find, src/refmvs.c:348-651)."""
    rf = rt.rf
    nat = _nat_frame(rf)
    if nat is not None:
        stack = rf._nat_stack
        n = _native.dtpu_refmvs_find(
            ctypes.byref(nat), rt.tile_col[0], rt.tile_col[1],
            rt.tile_row[0], rt.tile_row[1], int(ref[0]), int(ref[1]),
            int(bs), int(edge_flags), by4, bx4,
            tables.block_dimensions.ctypes.data,
            stack.ctypes.data, ctypes.byref(rf._nat_ctx))
        rows = stack["mv"][: max(n, 2)].tolist()
        ws = stack["weight"][: max(n, 2)].tolist()
        mvstack = [{"mv": [tuple(mv[0]), tuple(mv[1])], "weight": w}
                   for mv, w in zip(rows, ws)]
        return mvstack, n, rf._nat_ctx.value
    hdr = rf.frm_hdr
    b_dim = tables.block_dimensions[bs]
    bw4, bh4 = int(b_dim[0]), int(b_dim[1])
    w4 = min(min(bw4, 16), rt.tile_col[1] - bx4)
    h4 = min(min(bh4, 16), rt.tile_row[1] - by4)

    mvstack: list = []
    if ref[0] > 0:
        tgmv0 = get_gmv_2d(hdr.gmv[ref[0] - 1], bx4, by4, bw4, bh4, hdr)
        gmv0 = tgmv0 if hdr.gmv[ref[0] - 1].type > \
            WarpedMotionType.TRANSLATION else None
    else:
        tgmv0 = (0, 0)
        gmv0 = None
    if ref[1] > 0:
        tgmv1 = get_gmv_2d(hdr.gmv[ref[1] - 1], bx4, by4, bw4, bh4, hdr)
        gmv1 = tgmv1 if hdr.gmv[ref[1] - 1].type > \
            WarpedMotionType.TRANSLATION else None
    else:
        tgmv1 = None
        gmv1 = None
    gmv = [gmv0, gmv1]
    tgmv = [tgmv0, tgmv1]

    flags_row = [0, 0]  # newmv, refmv
    flags_col = [0, 0]
    max_rows = 0
    n_rows = None
    r = rf.r
    if by4 > rt.tile_row[0]:
        max_rows = min((by4 - rt.tile_row[0] + 1) >> 1, 2 + (bh4 > 1))
        n_rows = _scan_row(mvstack, ref, gmv, r[by4 - 1], bx4, bw4, w4,
                           max_rows, 4 if bw4 >= 16 else 1, flags_row)
    max_cols = 0
    n_cols = None
    if bx4 > rt.tile_col[0]:
        max_cols = min((bx4 - rt.tile_col[0] + 1) >> 1, 2 + (bw4 > 1))
        n_cols = _scan_col(mvstack, ref, gmv, r, by4, bx4 - 1, bh4, h4,
                           max_cols, 4 if bh4 >= 16 else 1, flags_col)

    # top-right
    if (n_rows is not None and (edge_flags & EDGE_I444_TOP_HAS_RIGHT)
            and max(bw4, bh4) <= 16 and bw4 + bx4 < rt.tile_col[1]):
        _add_spatial_candidate(mvstack, 4, r[by4 - 1, bx4 + bw4], ref, gmv,
                               flags_row)

    have_newmv = flags_row[0] | flags_col[0]
    nearest_match = flags_col[1] + flags_row[1]
    nearest_cnt = len(mvstack)
    for m in mvstack:
        m["weight"] += 640

    globalmv_ctx = hdr.use_ref_frame_mvs
    if rf.use_ref_frame_mvs:
        # temporal candidates from the projected motion field
        # (reference src/refmvs.c:417-455)
        by8, bx8 = by4 >> 1, bx4 >> 1
        rp_proj = rf.rp_proj
        step_h = 2 if bw4 >= 16 else 1
        step_v = 2 if bh4 >= 16 else 1
        w8 = min((w4 + 1) >> 1, 8)
        h8 = min((h4 + 1) >> 1, 8)
        gctx = [globalmv_ctx]
        for y in range(0, h8, step_v):
            for x in range(0, w8, step_h):
                _add_temporal_candidate(
                    rf, mvstack, rp_proj[by8 + y, bx8 + x], ref,
                    gctx if not (x | y) else None, tgmv)
        globalmv_ctx = gctx[0]
        if min(bw4, bh4) >= 2 and max(bw4, bh4) < 16:
            bh8, bw8 = bh4 >> 1, bw4 >> 1
            has_bottom = by8 + bh8 < min(rt.tile_row[1] >> 1,
                                         (by8 & ~7) + 8)
            if has_bottom and bx8 - 1 >= max(rt.tile_col[0] >> 1, bx8 & ~7):
                _add_temporal_candidate(rf, mvstack,
                                        rp_proj[by8 + bh8, bx8 - 1], ref,
                                        None, None)
            if bx8 + bw8 < min(rt.tile_col[1] >> 1, (bx8 & ~7) + 8):
                if has_bottom:
                    _add_temporal_candidate(rf, mvstack,
                                            rp_proj[by8 + bh8, bx8 + bw8],
                                            ref, None, None)
                if by8 + bh8 - 1 < min(rt.tile_row[1] >> 1, (by8 & ~7) + 8):
                    _add_temporal_candidate(
                        rf, mvstack, rp_proj[by8 + bh8 - 1, bx8 + bw8],
                        ref, None, None)

    # top-left and secondary scans only update the refmv-match flags; the
    # newmv flag uses a dummy there (reference :456-478). have_newmv was
    # captured above, so mutating flags_*[0] here is inert.
    # reference: (n_rows | n_cols) != ~0U -- true only when BOTH edges
    # were scanned (n_rows/n_cols are unsigned ~0 sentinels there)
    if n_rows is not None and n_cols is not None:
        _add_spatial_candidate(mvstack, 4, r[by4 - 1, bx4 - 1], ref, gmv,
                               flags_row)

    # secondary (non-adjacent) rows/cols at 8x8 resolution
    for n in (2, 3):
        if n_rows is not None and n > n_rows and n <= max_rows:
            row_idx = ((by4 & ~31) + (((by4 & 31) - 2 * n + 1) | 1))
            n_rows += _scan_row(mvstack, ref, gmv, r[row_idx], bx4 | 1, bw4,
                                w4, 1 + max_rows - n, 4 if bw4 >= 16 else 2,
                                flags_row)
        if n_cols is not None and n > n_cols and n <= max_cols:
            n_cols += _scan_col(mvstack, ref, gmv, r,
                                (by4 & ~31) + ((by4 & 31) | 1),
                                (bx4 - n * 2 + 1) | 1, bh4, h4,
                                1 + max_cols - n, 4 if bh4 >= 16 else 2,
                                flags_col)

    ref_match_count = flags_col[1] + flags_row[1]

    if nearest_match == 0:
        refmv_ctx = min(2, ref_match_count)
        newmv_ctx = int(ref_match_count > 0)
    elif nearest_match == 1:
        refmv_ctx = min(ref_match_count * 3, 4)
        newmv_ctx = 3 - have_newmv
    else:
        refmv_ctx = 5
        newmv_ctx = 5 - have_newmv

    # stable two-phase bubble sort by weight (nearest first, then rest)
    def sort_range(lo, hi):
        ln = hi
        while ln > lo:
            last = lo
            for n in range(lo + 1, ln):
                if mvstack[n - 1]["weight"] < mvstack[n]["weight"]:
                    mvstack[n - 1], mvstack[n] = mvstack[n], mvstack[n - 1]
                    last = n
            ln = last

    sort_range(0, nearest_cnt)
    sort_range(nearest_cnt, len(mvstack))

    if ref[1] > 0:
        if len(mvstack) < 2:
            sign0 = rf.sign_bias[ref[0] - 1]
            sign1 = rf.sign_bias[ref[1] - 1]
            sz4 = min(w4, h4)
            same = [{"mv": [(0, 0), (0, 0)]} for _ in range(4)]
            same_count = [0, 0, 0, 0]
            if n_rows is not None:
                x = 0
                while x < sz4:
                    cand_b = r[by4 - 1, bx4 + x]
                    _add_compound_extended(same, same_count, cand_b, sign0,
                                           sign1, ref, rf.sign_bias)
                    x += int(tables.block_dimensions[int(cand_b["bs"])][0])
            if n_cols is not None:
                y = 0
                while y < sz4:
                    cand_b = r[by4 + y, bx4 - 1]
                    _add_compound_extended(same, same_count, cand_b, sign0,
                                           sign1, ref, rf.sign_bias)
                    y += int(tables.block_dimensions[int(cand_b["bs"])][1])
            # merge
            for n in range(2):
                m = same_count[n]
                if m >= 2:
                    continue
                ln = same_count[2 + n]
                if ln:
                    same[m]["mv"][n] = same[2]["mv"][n]
                    m += 1
                    if m != 2:
                        if ln == 2:
                            same[1]["mv"][n] = same[3]["mv"][n]
                            continue
                        while m < 2:
                            same[m]["mv"][n] = tgmv[n]
                            m += 1
                else:
                    while m < 2:
                        same[m]["mv"][n] = tgmv[n]
                        m += 1
            n0 = len(mvstack)
            ext = [{"mv": [tuple(same[i]["mv"][0]), tuple(same[i]["mv"][1])],
                    "weight": 2} for i in range(3)]
            if n0 == 1 and mvstack[0]["mv"][0] == ext[0]["mv"][0] and \
                    mvstack[0]["mv"][1] == ext[0]["mv"][1]:
                mvstack.append({"mv": ext[1]["mv"], "weight": 2})
            else:
                while len(mvstack) < 2:
                    mvstack.append(ext[len(mvstack) - n0])
        cnt = len(mvstack)

        _clamp_stack(mvstack, bx4, by4, bw4, bh4, rf, both=True)

        rc2 = refmv_ctx >> 1
        if rc2 == 0:
            ctx = min(newmv_ctx, 1)
        elif rc2 == 1:
            ctx = 1 + min(newmv_ctx, 3)
        else:
            ctx = max(4, min(7, 3 + newmv_ctx))
        return mvstack, cnt, ctx

    if len(mvstack) < 2 and ref[0] > 0:
        sign = rf.sign_bias[ref[0] - 1]
        sz4 = min(w4, h4)
        if n_rows is not None:
            x = 0
            while x < sz4 and len(mvstack) < 2:
                cand_b = r[by4 - 1, bx4 + x]
                _add_single_extended(mvstack, cand_b, sign, rf.sign_bias)
                x += int(tables.block_dimensions[int(cand_b["bs"])][0])
        if n_cols is not None:
            y = 0
            while y < sz4 and len(mvstack) < 2:
                cand_b = r[by4 + y, bx4 - 1]
                _add_single_extended(mvstack, cand_b, sign, rf.sign_bias)
                y += int(tables.block_dimensions[int(cand_b["bs"])][1])

    _clamp_stack(mvstack, bx4, by4, bw4, bh4, rf, both=False)
    cnt = len(mvstack)
    while len(mvstack) < 2:
        # safe-access fill; does NOT count toward n_mvs (reference :647)
        mvstack.append({"mv": [tgmv[0], (0, 0)], "weight": 0})

    ctx = (refmv_ctx << 4) | (globalmv_ctx << 3) | newmv_ctx
    return mvstack, cnt, ctx


def _clamp_stack(mvstack, bx4, by4, bw4, bh4, rf, both):
    left = -(bx4 + bw4 + 4) * 4 * 8
    right = (rf.iw4 - bx4 + 4) * 4 * 8
    top = -(by4 + bh4 + 4) * 4 * 8
    bottom = (rf.ih4 - by4 + 4) * 4 * 8

    def cl(m):
        return (max(top, min(bottom, m[0])), max(left, min(right, m[1])))

    for m in mvstack:
        m["mv"][0] = cl(m["mv"][0])
        if both:
            m["mv"][1] = cl(m["mv"][1])
