"""Inter block reconstruction (reference dav1d_recon_b_inter,
src/recon_tmpl.c:1557-1985, mc() :938, read_coef_tree :731)."""

from __future__ import annotations

import numpy as np

from .. import tables
from ..headers import PixelLayout
from ..levels import (CompInterPredMode, CompInterType, InterPredMode,
                      MotionMode)
from . import mc_np
from ..native import lib as _nlib
from .coef import decode_coefs
from .itx import itx_add_cached


def mc_put(t, pl, dst_plane, dst_y, dst_x, bw4, bh4, bx, by, mv, ref_planes,
           ref_w, ref_h, filter_2d, refidx=None):
    """Translation MC into the picture (reference mc(), src/recon_tmpl.c:938).
    ref_w/ref_h are the reference picture's (post-super-res) dimensions; a
    mismatch with the current coded size selects the scaled path."""
    f = t.f
    if refidx is not None and (ref_w != f.frame_hdr.width[0]
                               or ref_h != f.frame_hdr.height):
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
        blk = _mc_scaled(t, pl, bw4, bh4, bx, by, mv, ref_planes, ref_w,
                         ref_h, filter_2d, refidx, prep=False)
        dst_plane[dst_y : dst_y + bh4 * v_mul,
                  dst_x : dst_x + bw4 * h_mul] = blk
        return
    ss_ver = int(bool(pl)) and f.ss_ver
    ss_hor = int(bool(pl)) and f.ss_hor
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    mvy, mvx = mv
    mx = (mvx & (15 >> (not ss_hor))) << (not ss_hor)
    my = (mvy & (15 >> (not ss_ver))) << (not ss_ver)
    dx = bx * h_mul + (mvx >> (3 + ss_hor))
    dy = by * v_mul + (mvy >> (3 + ss_ver))
    w = (ref_w + ss_hor) >> ss_hor
    h = (ref_h + ss_ver) >> ss_ver
    bw_px, bh_px = bw4 * h_mul, bh4 * v_mul
    ref = ref_planes[pl]
    if filter_2d != 9 and _nlib is not None \
            and ref.dtype == np.int32 and ref.flags.c_contiguous:
        # replay fast path: filter straight into the picture
        ftype = _filter_type(filter_2d)
        fh, fv = mc_np._get_filters(ftype, bw_px, bh_px, mx, my)
        _nlib.dtpu_put_8tap_into(
            ref.ctypes.data, ref.shape[1], w, h, dy, dx, bw_px, bh_px,
            None if fh is None else fh.ctypes.data,
            None if fv is None else fv.ctypes.data,
            mc_np._intermediate_bits(f.bitdepth), (1 << f.bitdepth) - 1,
            dst_plane.ctypes.data
            + (dst_y * dst_plane.shape[1] + dst_x) * 4,
            dst_plane.shape[1])
        return
    if filter_2d == 9:  # FILTER_2D_BILINEAR
        blk = mc_np.put_bilin(ref_planes[pl], w, h, dy, dx, bw_px, bh_px,
                              mx, my, f.bitdepth)
    else:
        ftype = _filter_type(filter_2d)
        blk = mc_np.put_8tap(ref_planes[pl], w, h, dy, dx, bw_px, bh_px,
                             mx, my, ftype, f.bitdepth)
    dst_plane[dst_y : dst_y + bh_px, dst_x : dst_x + bw_px] = blk


def mc_prep(t, pl, bw4, bh4, bx, by, mv, ref_planes, ref_w, ref_h,
            filter_2d, refidx=None):
    f = t.f
    if refidx is not None and (ref_w != f.frame_hdr.width[0]
                               or ref_h != f.frame_hdr.height):
        return _mc_scaled(t, pl, bw4, bh4, bx, by, mv, ref_planes, ref_w,
                          ref_h, filter_2d, refidx, prep=True)
    ss_ver = int(bool(pl)) and f.ss_ver
    ss_hor = int(bool(pl)) and f.ss_hor
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    mvy, mvx = mv
    mx = mvx & (15 >> (not ss_hor))
    my = mvy & (15 >> (not ss_ver))
    dx = bx * h_mul + (mvx >> (3 + ss_hor))
    dy = by * v_mul + (mvy >> (3 + ss_ver))
    w = (ref_w + ss_hor) >> ss_hor
    h = (ref_h + ss_ver) >> ss_ver
    if filter_2d == 9:
        return mc_np.prep_bilin(ref_planes[pl], w, h, dy, dx, bw4 * h_mul,
                                bh4 * v_mul, mx << (not ss_hor),
                                my << (not ss_ver), f.bitdepth)
    ftype = _filter_type(filter_2d)
    return mc_np.prep_8tap(ref_planes[pl], w, h, dy, dx, bw4 * h_mul,
                           bh4 * v_mul, mx << (not ss_hor),
                           my << (not ss_ver), ftype, f.bitdepth)


# Filter2d -> put_8tap filter_type (h | v<<2); reference mc_tmpl.c:400-414.
_F2D_TO_TYPE = {
    0: 0 | (0 << 2),   # regular/regular
    1: 0 | (1 << 2),   # regular h, smooth v
    2: 0 | (2 << 2),   # regular h, sharp v
    3: 2 | (0 << 2),   # sharp h, regular v
    4: 2 | (1 << 2),
    5: 2 | (2 << 2),
    6: 1 | (0 << 2),
    7: 1 | (1 << 2),
    8: 1 | (2 << 2),
}


def _filter_type(filter_2d):
    return _F2D_TO_TYPE[int(filter_2d)]


def _mc_scaled(t, pl, bw4, bh4, bx, by, mv, ref_planes, ref_w, ref_h,
               filter_2d, refidx, prep):
    """Scaled-reference MC (reference mc(), src/recon_tmpl.c:992-1050)."""
    f = t.f
    ss_ver = int(bool(pl)) and f.ss_ver
    ss_hor = int(bool(pl)) and f.ss_hor
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    mvy, mvx = mv
    orig_pos_y = (by * v_mul << 4) + mvy * (1 << (not ss_ver))
    orig_pos_x = (bx * h_mul << 4) + mvx * (1 << (not ss_hor))

    def scale_mv(val, scale):
        tmp = val * scale + (scale - 0x4000) * 8
        v = (abs(tmp) + 128) >> 8
        return (-v if tmp < 0 else v) + 32

    pos_x = scale_mv(orig_pos_x, f.svc[refidx][0][0])
    pos_y = scale_mv(orig_pos_y, f.svc[refidx][1][0])
    left = pos_x >> 10
    top = pos_y >> 10
    w = (ref_w + ss_hor) >> ss_hor
    h = (ref_h + ss_ver) >> ss_ver
    if filter_2d == 9:
        return mc_np.put_bilin_scaled(
            ref_planes[pl], w, h, top, left, bw4 * h_mul, bh4 * v_mul,
            pos_x & 0x3FF, pos_y & 0x3FF, f.svc[refidx][0][1],
            f.svc[refidx][1][1], f.bitdepth, prep=prep)
    return mc_np.put_8tap_scaled(
        ref_planes[pl], w, h, top, left, bw4 * h_mul, bh4 * v_mul,
        pos_x & 0x3FF, pos_y & 0x3FF, f.svc[refidx][0][1],
        f.svc[refidx][1][1], _filter_type(filter_2d), f.bitdepth, prep=prep)


def warp_affine(t, pl, b_dim, refslot, wmp, prep):
    """Warped prediction over 8x8 tiles (reference warp_affine,
    src/recon_tmpl.c:1115-1174). Returns the full block."""
    f = t.f
    ss_ver = int(bool(pl)) and f.ss_ver
    ss_hor = int(bool(pl)) and f.ss_hor
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    bw_px, bh_px = b_dim[0] * h_mul, b_dim[1] * v_mul
    mat = wmp.matrix
    abcd = wmp.abcd
    width = (refslot.frame_hdr.width[1] + ss_hor) >> ss_hor
    height = (refslot.frame_hdr.height + ss_ver) >> ss_ver
    plane = refslot.planes[pl]
    out = np.zeros((bh_px, bw_px), dtype=np.int32)
    for y in range(0, bh_px, 8):
        src_y = t.by * 4 + ((y + 4) << ss_ver)
        mat3_y = mat[3] * src_y + mat[0]
        mat5_y = mat[5] * src_y + mat[1]
        for x in range(0, bw_px, 8):
            src_x = t.bx * 4 + ((x + 4) << ss_hor)
            mvx = (mat[2] * src_x + mat3_y) >> ss_hor
            mvy = (mat[4] * src_x + mat5_y) >> ss_ver
            dx = (mvx >> 16) - 4
            mx = ((mvx & 0xFFFF) - abcd[0] * 4 - abcd[1] * 7) & ~0x3F
            dy = (mvy >> 16) - 4
            my = ((mvy & 0xFFFF) - abcd[2] * 4 - abcd[3] * 4) & ~0x3F
            out[y : y + 8, x : x + 8] = mc_np.warp8x8(
                plane, width, height, dy, dx, abcd, mx, my, f.bitdepth,
                prep=prep)
    return out


def obmc(t, pl, b, bw4, bh4, w4, h4, bx4, by4):
    """Overlapped block MC: blend top/left neighbour predictions into the
    current block (reference obmc(), src/recon_tmpl.c:1052-1114). In
    replay (pass 2) the neighbour parameters come from the capture-time
    snapshot (above/left contexts are parse-time state)."""
    f = t.f
    b_dim = tables.block_dimensions[b.bs]
    ss_ver = int(bool(pl)) and f.ss_ver
    ss_hor = int(bool(pl)) and f.ss_hor
    h_mul, v_mul = 4 >> ss_hor, 4 >> ss_ver
    dst_y = (t.by * 4) >> ss_ver
    dst_x = (t.bx * 4) >> ss_hor
    plane = f.planes[pl]

    if t.pass_ == 2:
        for kind, off, mv, refidx, f2d, step4 in t.cur_rec["obmc"]:
            refslot = f.refp[refidx]
            if kind == "top":
                if pl and int(b_dim[0]) * h_mul + int(b_dim[1]) * v_mul < 16:
                    continue
                ow4 = min(step4, int(b_dim[0]))
                oh4 = min(int(b_dim[1]), 16) >> 1
                lap = np.zeros(((((oh4 * 3 + 3) >> 2) * v_mul),
                                ow4 * h_mul), dtype=np.int32)
                mc_put(t, pl, lap, 0, 0, ow4, (oh4 * 3 + 3) >> 2,
                       t.bx + off, t.by, mv, refslot.planes,
                       refslot.frame_hdr.width[1], refslot.frame_hdr.height,
                       f2d, refidx=refidx)
                dstv = plane[dst_y:, dst_x + off * h_mul:]
                mc_np.blend_h(dstv, lap, h_mul * ow4, v_mul * oh4)
            else:
                ow4 = min(int(b_dim[0]), 16) >> 1
                oh4 = min(step4, int(b_dim[1]))
                lap = np.zeros((oh4 * v_mul, ow4 * h_mul), dtype=np.int32)
                mc_put(t, pl, lap, 0, 0, ow4, oh4, t.bx, t.by + off, mv,
                       refslot.planes, refslot.frame_hdr.width[1],
                       refslot.frame_hdr.height, f2d, refidx=refidx)
                dstv = plane[dst_y + off * v_mul:, dst_x:]
                mc_np.blend_v(dstv, lap, h_mul * ow4, v_mul * oh4)
        return

    r = f.rf.r

    if t.by > t.ts.row_start and \
            (not pl or int(b_dim[0]) * h_mul + int(b_dim[1]) * v_mul >= 16):
        i = 0
        x = 0
        while x < w4 and i < min(int(b_dim[2]), 4):
            a_r = r[t.by - 1, t.bx + x + 1]
            a_b_dim = tables.block_dimensions[int(a_r["bs"])]
            step4 = max(2, min(16, int(a_b_dim[0])))
            if int(a_r["ref"][0]) > 0:
                ow4 = min(step4, int(b_dim[0]))
                oh4 = min(int(b_dim[1]), 16) >> 1
                f2d = int(tables.filter_2d[t.a.filter[1][bx4 + x + 1]]
                          [t.a.filter[0][bx4 + x + 1]])
                refslot = f.refp[int(a_r["ref"][0]) - 1]
                lap = np.zeros(((((oh4 * 3 + 3) >> 2) * v_mul),
                                ow4 * h_mul), dtype=np.int32)
                mc_put(t, pl, lap, 0, 0, ow4, (oh4 * 3 + 3) >> 2,
                       t.bx + x, t.by,
                       (int(a_r["mv"][0][0]), int(a_r["mv"][0][1])),
                       refslot.planes, refslot.frame_hdr.width[1],
                       refslot.frame_hdr.height, f2d,
                       refidx=int(a_r["ref"][0]) - 1)
                dstv = plane[dst_y:, dst_x + x * h_mul:]
                mc_np.blend_h(dstv, lap, h_mul * ow4, v_mul * oh4)
                i += 1
            x += step4

    if t.bx > t.ts.col_start:
        i = 0
        y = 0
        while y < h4 and i < min(int(b_dim[3]), 4):
            l_r = r[t.by + y + 1, t.bx - 1]
            l_b_dim = tables.block_dimensions[int(l_r["bs"])]
            step4 = max(2, min(16, int(l_b_dim[1])))
            if int(l_r["ref"][0]) > 0:
                ow4 = min(int(b_dim[0]), 16) >> 1
                oh4 = min(step4, int(b_dim[1]))
                f2d = int(tables.filter_2d[t.l.filter[1][by4 + y + 1]]
                          [t.l.filter[0][by4 + y + 1]])
                refslot = f.refp[int(l_r["ref"][0]) - 1]
                lap = np.zeros((oh4 * v_mul, ow4 * h_mul), dtype=np.int32)
                mc_put(t, pl, lap, 0, 0, ow4, oh4, t.bx, t.by + y,
                       (int(l_r["mv"][0][0]), int(l_r["mv"][0][1])),
                       refslot.planes, refslot.frame_hdr.width[1],
                       refslot.frame_hdr.height, f2d,
                       refidx=int(l_r["ref"][0]) - 1)
                dstv = plane[dst_y + y * v_mul:, dst_x:]
                mc_np.blend_v(dstv, lap, h_mul * ow4, v_mul * oh4)
                i += 1
            y += step4


def _interintra(t, b, bs, pl, cbw4, cbh4, dst_y, dst_x):
    """Inter-intra blend (reference src/recon_tmpl.c:1617-1642 luma,
    :1738-1777 chroma)."""
    from ..headers import PixelLayout as PL
    from ..levels import IntraPredMode as M
    from . import ipred as ipred_mod
    f = t.f
    ts = t.ts
    ss_ver = int(bool(pl)) and f.ss_ver
    ss_hor = int(bool(pl)) and f.ss_hor
    chr_layout_idx = 0 if pl == 0 or f.layout == PL.I400 else \
        int(PL.I444) - int(f.layout)
    m = M.SMOOTH_PRED if b.interintra_mode == 3 else int(b.interintra_mode)
    top_sb_edge = None
    if not (t.by & (f.sb_step - 1)):
        sby = t.by >> f.sb_shift
        if sby > 0:
            top_sb_edge = f.ipred_edge[pl][sby - 1]
    m, _, edge, ofs = ipred_mod.prepare_intra_edges(
        t.bx >> ss_hor, (t.bx >> ss_hor) > (ts.col_start >> ss_hor),
        t.by >> ss_ver, (t.by >> ss_ver) > (ts.row_start >> ss_ver),
        ts.col_end >> ss_hor, ts.row_end >> ss_ver, 0, f.planes[pl],
        dst_y, dst_x, top_sb_edge, 0, m, 0, cbw4, cbh4, 0, f.bitdepth)
    tmp = ipred_mod.ipred(m, edge, ofs, cbw4 * 4, cbh4 * 4, 0, 0, 0,
                          f.bitdepth)
    ii = tables.ii_mask(chr_layout_idx, bs, b)
    w_px, h_px = cbw4 * 4, cbh4 * 4
    mask = ii[: w_px * h_px].reshape(h_px, w_px).astype(np.int64)
    dstv = f.planes[pl][dst_y : dst_y + h_px, dst_x : dst_x + w_px]
    f.planes[pl][dst_y : dst_y + h_px, dst_x : dst_x + w_px] = \
        mc_np.blend(dstv, tmp, mask)


def recon_b_inter(t, bs, b) -> None:
    f = t.f
    ts = t.ts
    bx4, by4 = t.bx & 31, t.by & 31
    ss_ver = int(f.layout == PixelLayout.I420)
    ss_hor = int(f.layout != PixelLayout.I444)
    cbx4, cby4 = bx4 >> ss_hor, by4 >> ss_ver
    b_dim = tables.block_dimensions[bs]
    bw4, bh4 = int(b_dim[0]), int(b_dim[1])
    w4 = min(bw4, f.bw - t.bx)
    h4 = min(bh4, f.bh - t.by)
    has_chroma = (f.layout != PixelLayout.I400
                  and (bw4 > ss_hor or t.bx & 1)
                  and (bh4 > ss_ver or t.by & 1))
    cbh4 = (bh4 + ss_ver) >> ss_ver
    cbw4 = (bw4 + ss_hor) >> ss_hor
    bitdepth = f.bitdepth

    dst_y_px = 4 * t.by
    dst_x_px = 4 * t.bx
    cdst_y = 4 * (t.by >> ss_ver)
    cdst_x = 4 * (t.bx >> ss_hor)

    if t.pass_ == 1:
        pass  # prediction happens in pass 2 (device batch + replay)
    elif f.frame_hdr.frame_type.is_key_or_intra:
        # intra block copy: bilinear MC from the current (partial) frame
        # (reference src/recon_tmpl.c:1583-1599)
        mc_put(t, 0, f.planes[0], dst_y_px, dst_x_px, bw4, bh4, t.bx, t.by,
               b.mv[0], f.planes, f.bw * 4, f.bh * 4, 9)
        if has_chroma:
            for pl in range(1, 3):
                mc_put(t, pl, f.planes[pl], cdst_y, cdst_x,
                       bw4 << (bw4 == ss_hor), bh4 << (bh4 == ss_ver),
                       t.bx & ~ss_hor, t.by & ~ss_ver, b.mv[0], f.planes,
                       f.bw * 4, f.bh * 4, 9)
    elif b.comp_type == CompInterType.NONE:
        refslot = f.refp[b.ref[0]]
        ref_planes = refslot.planes
        ref_w, ref_h = refslot.frame_hdr.width[1], refslot.frame_hdr.height
        use_warp_y = min(bw4, bh4) > 1 and (
            (b.inter_mode == InterPredMode.GLOBALMV
             and f.gmv_warp_allowed[b.ref[0]])
            or (b.motion_mode == MotionMode.WARP and t.warpmv.type > 1))
        wmp = t.warpmv if b.motion_mode == MotionMode.WARP \
            else f.frame_hdr.gmv[b.ref[0]]
        if use_warp_y:
            blk = warp_affine(t, 0, (bw4, bh4), refslot, wmp, False)
            f.planes[0][dst_y_px : dst_y_px + bh4 * 4,
                        dst_x_px : dst_x_px + bw4 * 4] = blk
        else:
            mc_put(t, 0, f.planes[0], dst_y_px, dst_x_px, bw4, bh4, t.bx,
                   t.by, b.mv[0], ref_planes, ref_w, ref_h, b.filter2d,
                   refidx=b.ref[0])
            if b.motion_mode == MotionMode.OBMC:
                obmc(t, 0, b, bw4, bh4, w4, h4, bx4, by4)
        if b.interintra_type:
            _interintra(t, b, bs, 0, bw4, bh4, dst_y_px, dst_x_px)
        if has_chroma:
            is_sub8x8 = bw4 == ss_hor or bh4 == ss_ver
            r = f.rf.r
            if is_sub8x8:
                if bw4 == 1:
                    is_sub8x8 &= int(r[t.by, t.bx - 1]["ref"][0]) > 0
                if bh4 == ss_ver:
                    is_sub8x8 &= int(r[t.by - 1, t.bx]["ref"][0]) > 0
                if bw4 == 1 and bh4 == ss_ver:
                    is_sub8x8 &= int(r[t.by - 1, t.bx - 1]["ref"][0]) > 0
            if is_sub8x8:
                _sub8x8_chroma(t, b, bw4, bh4, cdst_y, cdst_x, ss_ver, by4,
                               bx4)
            else:
                use_warp_uv = min(cbw4, cbh4) > 1 and (
                    (b.inter_mode == InterPredMode.GLOBALMV
                     and f.gmv_warp_allowed[b.ref[0]])
                    or (b.motion_mode == MotionMode.WARP
                        and t.warpmv.type > 1))
                for pl in range(1, 3):
                    if use_warp_uv:
                        blk = warp_affine(t, pl, (bw4, bh4), refslot, wmp,
                                          False)
                        f.planes[pl][cdst_y : cdst_y + (bh4 * 4 >> ss_ver),
                                     cdst_x : cdst_x
                                     + (bw4 * 4 >> ss_hor)] = blk
                    else:
                        mc_put(t, pl, f.planes[pl], cdst_y, cdst_x,
                               bw4 << (bw4 == ss_hor),
                               bh4 << (bh4 == ss_ver),
                               t.bx & ~ss_hor, t.by & ~ss_ver, b.mv[0],
                               ref_planes, ref_w, ref_h, b.filter2d,
                               refidx=b.ref[0])
                        if b.motion_mode == MotionMode.OBMC:
                            obmc(t, pl, b, bw4, bh4, w4, h4, bx4, by4)
                if b.interintra_type:
                    for pl in range(1, 3):
                        _interintra(t, b, bs, pl, cbw4, cbh4, cdst_y,
                                    cdst_x)
    else:
        chr_layout_idx = 0 if f.layout == PixelLayout.I400 else \
            int(PixelLayout.I444) - int(f.layout)
        seg_mask = None
        mask = None
        jw = None
        tmp = [None, None]
        for i in range(2):
            refslot = f.refp[b.ref[i]]
            if b.inter_mode == CompInterPredMode.GLOBALMV_GLOBALMV and \
                    f.gmv_warp_allowed[b.ref[i]]:
                tmp[i] = warp_affine(t, 0, (bw4, bh4), refslot,
                                     f.frame_hdr.gmv[b.ref[i]], True)
            else:
                tmp[i] = mc_prep(t, 0, bw4, bh4, t.bx, t.by, b.mv[i],
                                 refslot.planes, refslot.frame_hdr.width[1],
                                 refslot.frame_hdr.height, b.filter2d,
                                 refidx=b.ref[i])
        if b.comp_type == CompInterType.AVG:
            blk = mc_np.avg(tmp[0], tmp[1], bitdepth)
        elif b.comp_type == CompInterType.WEIGHTED_AVG:
            jw = f.jnt_weights[b.ref[0]][b.ref[1]]
            blk = mc_np.w_avg(tmp[0], tmp[1], jw, bitdepth)
        elif b.comp_type == CompInterType.SEG:
            blk, seg_mask = mc_np.w_mask(tmp[b.mask_sign],
                                         tmp[not b.mask_sign],
                                         b.mask_sign, ss_hor, ss_ver,
                                         bitdepth)
            mask = seg_mask
        else:  # WEDGE
            mask = tables.wedge_mask(0, bs, 0, b.wedge_idx, bw4 * 4, bh4 * 4)
            blk = mc_np.mask_blend(tmp[b.mask_sign], tmp[not b.mask_sign],
                                   mask.astype(np.int64), bitdepth)
            if has_chroma:
                mask = tables.wedge_mask(chr_layout_idx, bs, b.mask_sign,
                                         b.wedge_idx, bw4 * 4 >> ss_hor,
                                         bh4 * 4 >> ss_ver)
        f.planes[0][dst_y_px : dst_y_px + bh4 * 4,
                    dst_x_px : dst_x_px + bw4 * 4] = blk
        if has_chroma:
            for pl in range(1, 3):
                for i in range(2):
                    refslot = f.refp[b.ref[i]]
                    if b.inter_mode == CompInterPredMode.GLOBALMV_GLOBALMV \
                            and min(cbw4, cbh4) > 1 \
                            and f.gmv_warp_allowed[b.ref[i]]:
                        tmp[i] = warp_affine(t, pl, (bw4, bh4), refslot,
                                             f.frame_hdr.gmv[b.ref[i]],
                                             True)
                    else:
                        tmp[i] = mc_prep(t, pl, bw4, bh4, t.bx, t.by,
                                         b.mv[i], refslot.planes,
                                         refslot.frame_hdr.width[1],
                                         refslot.frame_hdr.height,
                                         b.filter2d, refidx=b.ref[i])
                if b.comp_type == CompInterType.AVG:
                    blk = mc_np.avg(tmp[0], tmp[1], bitdepth)
                elif b.comp_type == CompInterType.WEIGHTED_AVG:
                    blk = mc_np.w_avg(tmp[0], tmp[1], jw, bitdepth)
                else:  # WEDGE or SEG: blend with the luma-derived mask
                    blk = mc_np.mask_blend(tmp[b.mask_sign],
                                           tmp[not b.mask_sign],
                                           mask.astype(np.int64), bitdepth)
                f.planes[pl][cdst_y : cdst_y + (bh4 * 4 >> ss_ver),
                             cdst_x : cdst_x + (bw4 * 4 >> ss_hor)] = blk

    t.tl_4x4_filter = b.filter2d

    if t.pass_ == 2 and getattr(t, "device_resid", False):
        return  # residuals applied by the batched device stage

    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver

    if b.skip:
        if t.pass_ != 2:
            t.a.lcoef[bx4 : bx4 + bw4] = 0x40
            t.l.lcoef[by4 : by4 + bh4] = 0x40
            if has_chroma:
                for pl in range(2):
                    t.a.ccoef[pl][cbx4 : cbx4 + cbw4] = 0x40
                    t.l.ccoef[pl][cby4 : cby4 + cbh4] = 0x40
        return

    uvtx = tables.txfm_info()[b.uvtx]
    ytx = tables.txfm_info()[b.max_ytx]
    ytw, yth = int(ytx[0]), int(ytx[1])
    utw, uth = int(uvtx[0]), int(uvtx[1])

    for init_y in range(0, bh4, 16):
        for init_x in range(0, bw4, 16):
            y_off = int(bool(init_y))
            y = init_y
            t.by += init_y
            while y < min(h4, init_y + 16):
                x = init_x
                x_off = int(bool(init_x))
                t.bx += init_x
                while x < min(w4, init_x + 16):
                    read_coef_tree(t, bs, b, b.max_ytx, 0,
                                   (b.tx_split0, b.tx_split1), x_off, y_off,
                                   True)
                    t.bx += ytw
                    x += ytw
                    x_off += 1
                t.bx -= x
                t.by += yth
                y += yth
                y_off += 1
            t.by -= y

            if has_chroma:
                for pl in range(2):
                    y = init_y >> ss_ver
                    t.by += init_y
                    while y < min(ch4, (init_y + 16) >> ss_ver):
                        x = init_x >> ss_hor
                        t.bx += init_x
                        while x < min(cw4, (init_x + 16) >> ss_hor):
                            if t.pass_ == 2:
                                eob, txtp, cf = \
                                    t.cur_rec["coefs"][t.rec_coef_pos][:3]
                                t.rec_coef_pos += 1
                            else:
                                txtp = t.txtp_map[by4 + (y << ss_ver),
                                                  bx4 + (x << ss_hor)]
                                eob, txtp, cf, cf_ctx = decode_coefs(
                                    t, t.a.ccoef[pl], cbx4 + x,
                                    t.l.ccoef[pl], cby4 + y, b.uvtx, bs, b,
                                    0, 1 + pl, ytxtp=txtp)
                                ctw = min(utw,
                                          (f.bw - t.bx + ss_hor) >> ss_hor)
                                cth = min(uth,
                                          (f.bh - t.by + ss_ver) >> ss_ver)
                                t.a.ccoef[pl][cbx4 + x : cbx4 + x + ctw] = \
                                    cf_ctx
                                t.l.ccoef[pl][cby4 + y : cby4 + y + cth] = \
                                    cf_ctx
                                if t.pass_ == 1:
                                    t.cur_rec["coefs"].append(
                                        (eob, txtp, None if cf is None
                                         else cf.copy(), 1 + pl, b.uvtx,
                                         cdst_y + 4 * y, cdst_x + 4 * x))
                            if t.pass_ != 1 and eob >= 0:
                                itx_add_cached(
                                    t, f.planes[1 + pl], cdst_y + 4 * y,
                                    cdst_x + 4 * x, b.uvtx, txtp, cf,
                                    eob, bitdepth)
                            t.bx += utw << ss_hor
                            x += utw
                        t.bx -= x << ss_hor
                        t.by += uth << ss_ver
                        y += uth
                    t.by -= y << ss_ver


def _sub8x8_chroma(t, b, bw4, bh4, cdst_y, cdst_x, ss_ver, by4, bx4):
    """Sub-8x8 chroma prediction from neighbouring blocks' MVs
    (reference src/recon_tmpl.c:1650-1712)."""
    f = t.f
    r = f.rf.r

    def neighbour_mc(rr, dst_dy, dst_dx, bx, by, fil):
        mv = (int(rr["mv"][0][0]), int(rr["mv"][0][1]))
        refslot = f.refp[int(rr["ref"][0]) - 1]
        for pl in range(1, 3):
            mc_put(t, pl, f.planes[pl], cdst_y + dst_dy, cdst_x + dst_dx,
                   bw4, bh4, bx, by, mv, refslot.planes,
                   refslot.frame_hdr.width[1], refslot.frame_hdr.height, fil,
                   refidx=int(rr["ref"][0]) - 1)

    if t.pass_ == 2:
        tl_f2d, left_f2d, top_f2d = t.cur_rec["sub8x8"]
    else:
        tl_f2d = t.tl_4x4_filter
        left_f2d = int(tables.filter_2d[t.l.filter[1][by4]][
            t.l.filter[0][by4]])
        top_f2d = int(tables.filter_2d[t.a.filter[1][bx4]][
            t.a.filter[0][bx4]])
    h_off = v_off = 0
    if bw4 == 1 and bh4 == ss_ver:
        neighbour_mc(r[t.by - 1, t.bx - 1], 0, 0, t.bx - 1, t.by - 1,
                     tl_f2d)
        v_off = 2
        h_off = 2
    if bw4 == 1:
        neighbour_mc(r[t.by, t.bx - 1], v_off, 0, t.bx - 1, t.by, left_f2d)
        h_off = 2
    if bh4 == ss_ver:
        neighbour_mc(r[t.by - 1, t.bx], 0, h_off, t.bx, t.by - 1, top_f2d)
        v_off = 2
    refslot = f.refp[b.ref[0]]
    for pl in range(1, 3):
        mc_put(t, pl, f.planes[pl], cdst_y + v_off, cdst_x + h_off, bw4, bh4,
               t.bx, t.by, b.mv[0], refslot.planes,
               refslot.frame_hdr.width[1], refslot.frame_hdr.height,
               b.filter2d, refidx=b.ref[0])


def read_coef_tree(t, bs, b, ytx, depth, tx_split, x_off, y_off, do_recon):
    """reference read_coef_tree (src/recon_tmpl.c:731)."""
    f = t.f
    ts = t.ts
    t_dim = tables.txfm_info()[ytx]
    txw, txh = int(t_dim[0]), int(t_dim[1])

    if depth < 2 and tx_split[depth] and \
            tx_split[depth] & (1 << (y_off * 4 + x_off)):
        sub = int(t_dim[6])
        sub_t = tables.txfm_info()[sub]
        txsw, txsh = int(sub_t[0]), int(sub_t[1])
        read_coef_tree(t, bs, b, sub, depth + 1, tx_split,
                       x_off * 2, y_off * 2, do_recon)
        t.bx += txsw
        if txw >= txh and t.bx < f.bw:
            read_coef_tree(t, bs, b, sub, depth + 1, tx_split,
                           x_off * 2 + 1, y_off * 2, do_recon)
        t.bx -= txsw
        t.by += txsh
        if txh >= txw and t.by < f.bh:
            read_coef_tree(t, bs, b, sub, depth + 1, tx_split,
                           x_off * 2, y_off * 2 + 1, do_recon)
            t.bx += txsw
            if txw >= txh and t.bx < f.bw:
                read_coef_tree(t, bs, b, sub, depth + 1, tx_split,
                               x_off * 2 + 1, y_off * 2 + 1, do_recon)
            t.bx -= txsw
        t.by -= txsh
    else:
        bx4, by4 = t.bx & 31, t.by & 31
        if t.pass_ == 2:
            eob, txtp, cf = t.cur_rec["coefs"][t.rec_coef_pos][:3]
            t.rec_coef_pos += 1
        else:
            eob, txtp, cf, cf_ctx = decode_coefs(
                t, t.a.lcoef, bx4, t.l.lcoef, by4, ytx, bs, b, 0, 0)
            t.a.lcoef[bx4 : bx4 + min(txw, f.bw - t.bx)] = cf_ctx
            t.l.lcoef[by4 : by4 + min(txh, f.bh - t.by)] = cf_ctx
            t.txtp_map[by4 : by4 + txh, bx4 : bx4 + txw] = txtp
            if t.pass_ == 1:
                t.cur_rec["coefs"].append(
                    (eob, txtp, None if cf is None else cf.copy(),
                     0, ytx, 4 * t.by, 4 * t.bx))
        if do_recon and t.pass_ != 1 and eob >= 0:
            itx_add_cached(t, f.planes[0], 4 * t.by, 4 * t.bx, ytx, txtp,
                           cf, eob, f.bitdepth)
