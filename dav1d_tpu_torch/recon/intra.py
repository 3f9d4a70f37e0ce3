"""Intra block reconstruction (reference dav1d_recon_b_intra,
src/recon_tmpl.c:1176-1556): per-TX-block edge prep + prediction +
coefficient decode + inverse transform add."""

from __future__ import annotations

import numpy as np

from .. import tables
from ..headers import PixelLayout
from ..intra_edge import EDGE_I444_LEFT_HAS_BOTTOM, EDGE_I444_TOP_HAS_RIGHT
from ..levels import IntraPredMode as M, TxfmSize
from . import ipred as ipred_mod
from .coef import decode_coefs
from ..debug import trace
from .itx import itx_add_cached

SMOOTH_MODES = (M.SMOOTH_PRED, M.SMOOTH_H_PRED, M.SMOOTH_V_PRED)


def _sm_flag(ctx, idx) -> int:
    if not ctx.intra[idx]:
        return 0
    return ipred_mod.ANGLE_SMOOTH_EDGE_FLAG \
        if ctx.mode[idx] in SMOOTH_MODES else 0


def _sm_uv_flag(ctx, idx) -> int:
    return ipred_mod.ANGLE_SMOOTH_EDGE_FLAG \
        if ctx.uvmode[idx] in SMOOTH_MODES else 0


def _coef_y(t, b, bs, bx4, by4, x, y, tw, th, dst_y, dst_x, f, ts,
            bitdepth) -> None:
    """Luma coefficient decode + inverse transform add for one tx block
    (pass-aware: capture stores coefs, replay pops them)."""
    if not b.skip:
        if t.pass_ == 2:
            eob, txtp, cf = t.cur_rec["coefs"][t.rec_coef_pos][:3]
            t.rec_coef_pos += 1
        else:
            eob, txtp, cf, cf_ctx = decode_coefs(
                t, t.a.lcoef, bx4 + x, t.l.lcoef, by4 + y, b.tx, bs, b, 1, 0)
            trace("Post-y-cf-blk[tx=%d,txtp=%d,eob=%d]: r=%d",
                  b.tx, txtp, eob, ts.msac.rng)
            t.a.lcoef[bx4 + x : bx4 + x + min(tw, f.bw - t.bx)] = cf_ctx
            t.l.lcoef[by4 + y : by4 + y + min(th, f.bh - t.by)] = cf_ctx
            if t.pass_ == 1:
                t.cur_rec["coefs"].append(
                    (eob, txtp, None if cf is None else cf.copy(),
                     0, b.tx, dst_y, dst_x))
        if t.pass_ != 1 and eob >= 0:
            itx_add_cached(t, f.planes[0], dst_y, dst_x, b.tx, txtp, cf,
                           eob, bitdepth)
    elif t.pass_ != 2:
        t.a.lcoef[bx4 + x : bx4 + x + tw] = 0x40
        t.l.lcoef[by4 + y : by4 + y + th] = 0x40


def _coef_uv(t, b, bs, pl, x, y, cbx4, cby4, utw, uth, dst_y, dst_x, f,
             ts, bitdepth, ss_hor, ss_ver) -> None:
    """Chroma coefficient decode + itx add for one tx block (pass-aware)."""
    if not b.skip:
        if t.pass_ == 2:
            eob, txtp, cf = t.cur_rec["coefs"][t.rec_coef_pos][:3]
            t.rec_coef_pos += 1
        else:
            eob, txtp, cf, cf_ctx = decode_coefs(
                t, t.a.ccoef[pl], cbx4 + x, t.l.ccoef[pl], cby4 + y,
                b.uvtx, bs, b, 1, 1 + pl)
            trace("Post-uv-cf-blk[pl=%d,tx=%d,txtp=%d,eob=%d]: r=%d "
                  "[x=%d,cbx4=%d]", pl, b.uvtx, txtp, eob, ts.msac.rng,
                  x, cbx4)
            ctw = min(utw, (f.bw - t.bx + ss_hor) >> ss_hor)
            cth = min(uth, (f.bh - t.by + ss_ver) >> ss_ver)
            t.a.ccoef[pl][cbx4 + x : cbx4 + x + ctw] = cf_ctx
            t.l.ccoef[pl][cby4 + y : cby4 + y + cth] = cf_ctx
            if t.pass_ == 1:
                t.cur_rec["coefs"].append(
                    (eob, txtp, None if cf is None else cf.copy(),
                     1 + pl, b.uvtx, dst_y, dst_x))
        if t.pass_ != 1 and eob >= 0:
            itx_add_cached(t, f.planes[1 + pl], dst_y, dst_x, b.uvtx,
                           txtp, cf, eob, bitdepth)
    elif t.pass_ != 2:
        t.a.ccoef[pl][cbx4 + x : cbx4 + x + utw] = 0x40
        t.l.ccoef[pl][cby4 + y : cby4 + y + uth] = 0x40


def recon_b_intra(t, bs, intra_edge_flags, b) -> None:
    f = t.f
    ts = t.ts
    bx4 = t.bx & 31
    by4 = t.by & 31
    ss_ver = int(f.layout == PixelLayout.I420)
    ss_hor = int(f.layout != PixelLayout.I444)
    cbx4 = bx4 >> ss_hor
    cby4 = by4 >> ss_ver
    b_dim = tables.block_dimensions[b.bs]
    bw4, bh4 = int(b_dim[0]), int(b_dim[1])
    w4 = min(bw4, f.bw - t.bx)
    h4 = min(bh4, f.bh - t.by)
    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver
    has_chroma = (f.layout != PixelLayout.I400
                  and (bw4 > ss_hor or t.bx & 1)
                  and (bh4 > ss_ver or t.by & 1))
    t_dim = tables.txfm_info()[b.tx]
    uv_t_dim = tables.txfm_info()[b.uvtx]
    cbw4 = (bw4 + ss_hor) >> ss_hor
    cbh4 = (bh4 + ss_ver) >> ss_ver
    bitdepth = f.bitdepth

    intra_edge_filter_flag = f.seq_hdr.intra_edge_filter << 10

    # neighbour smoothness flags are parse-time (above/left ctx) state
    if t.pass_ == 2:
        sm_fl, sm_uv_fl = t.cur_rec["sm"]
    else:
        sm_fl = _sm_flag(t.a, bx4) | _sm_flag(t.l, by4)
        sm_uv_fl = (_sm_uv_flag(t.a, cbx4) | _sm_uv_flag(t.l, cby4)) \
            if has_chroma else 0
        if t.pass_ == 1:
            t.cur_rec["sm"] = (sm_fl, sm_uv_fl)
            # pass 1 is purely the coefficient walk: one native call per
            # block when available (recon/coef.py intra_coefs_pass1)
            from .coef import intra_coefs_pass1
            if intra_coefs_pass1(t, b, bs, bx4, by4, w4, h4,
                                 ss_hor, ss_ver, has_chroma):
                return

    for init_y in range(0, h4, 16):
        sub_h4 = min(h4, 16 + init_y)
        sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
        for init_x in range(0, w4, 16):
            if b.pal_sz[0] and t.pass_ != 1:
                dst_y0, dst_x0 = 4 * t.by, 4 * t.bx
                f.planes[0][dst_y0 : dst_y0 + bh4 * 4,
                            dst_x0 : dst_x0 + bw4 * 4] = \
                    ipred_mod.pal_pred(t.scratch_pal[0], t.pal_idx_y,
                                       bw4 * 4, bh4 * 4)

            intra_flags = sm_fl | intra_edge_filter_flag
            sb_has_tr = (1 if init_x + 16 < w4 else 0 if init_y else
                         intra_edge_flags & EDGE_I444_TOP_HAS_RIGHT)
            sb_has_bl = (0 if init_x else 1 if init_y + 16 < h4 else
                         intra_edge_flags & EDGE_I444_LEFT_HAS_BOTTOM)
            sub_w4 = min(w4, init_x + 16)

            tw, th = int(t_dim[0]), int(t_dim[1])
            y = init_y
            t.by += init_y
            while y < sub_h4:
                x = init_x
                t.bx += init_x
                while x < sub_w4:
                    dst_x = 4 * t.bx
                    dst_y = 4 * t.by
                    if b.pal_sz[0] or t.pass_ == 1:
                        _coef_y(t, b, bs, bx4, by4, x, y, tw, th, dst_y,
                                dst_x, f, ts, bitdepth)
                        x += tw
                        t.bx += tw
                        continue
                    angle = b.y_angle
                    edge_flags = (
                        (0 if ((y > init_y or not sb_has_tr)
                               and (x + tw >= sub_w4))
                         else EDGE_I444_TOP_HAS_RIGHT)
                        | (0 if (x > init_x
                                 or (not sb_has_bl and y + th >= sub_h4))
                           else EDGE_I444_LEFT_HAS_BOTTOM))
                    top_sb_edge = None
                    if not (t.by & (f.sb_step - 1)):
                        sby = t.by >> f.sb_shift
                        if sby > 0:
                            top_sb_edge = f.planes[0][4 * t.by - 1] \
                                if t.pass_ == 2 else \
                                f.ipred_edge[0][sby - 1]
                    m, angle, edge, ofs = ipred_mod.prepare_intra_edges(
                        t.bx, t.bx > ts.col_start, t.by, t.by > ts.row_start,
                        ts.col_end, ts.row_end, edge_flags, f.planes[0],
                        dst_y, dst_x, top_sb_edge, 0, b.y_mode, angle,
                        tw, th, f.seq_hdr.intra_edge_filter, bitdepth)
                    plane0 = f.planes[0]
                    pred = ipred_mod.ipred(
                        m, edge, ofs, tw * 4, th * 4, angle | intra_flags,
                        4 * f.bw - 4 * t.bx, 4 * f.bh - 4 * t.by, bitdepth,
                        out_ptr=plane0.ctypes.data
                        + (dst_y * plane0.shape[1] + dst_x) * 4,
                        out_stride=plane0.shape[1])
                    if pred is not None:
                        plane0[dst_y : dst_y + th * 4,
                               dst_x : dst_x + tw * 4] = pred

                    _coef_y(t, b, bs, bx4, by4, x, y, tw, th, dst_y, dst_x,
                            f, ts, bitdepth)
                    x += tw
                    t.bx += tw
                t.bx -= x
                y += th
                t.by += th
            t.by -= y

            if not has_chroma:
                continue

            utw, uth = int(uv_t_dim[0]), int(uv_t_dim[1])
            if t.pass_ == 1:
                pass
            elif b.uv_mode == M.CFL_PRED:
                assert not init_x and not init_y
                y0 = 4 * (t.by & ~ss_ver)
                x0 = 4 * (t.bx & ~ss_hor)
                furthest_r = ((cw4 << ss_hor) + utw - 1) & ~(utw - 1)
                furthest_b = ((ch4 << ss_ver) + uth - 1) & ~(uth - 1)
                ac = ipred_mod.cfl_ac(
                    f.planes[0], y0, x0,
                    cbw4 - (furthest_r >> ss_hor),
                    cbh4 - (furthest_b >> ss_ver),
                    cbw4 * 4, cbh4 * 4, ss_hor, ss_ver)
                for pl in range(2):
                    if not b.cfl_alpha[pl]:
                        continue
                    top_sb_edge = None
                    if not ((t.by & ~ss_ver) & (f.sb_step - 1)):
                        sby = t.by >> f.sb_shift
                        if sby > 0:
                            top_sb_edge = f.planes[1 + pl][
                                (((t.by & ~ss_ver) * 4) >> ss_ver) - 1] \
                                if t.pass_ == 2 else \
                                f.ipred_edge[1 + pl][sby - 1]
                    xpos = t.bx >> ss_hor
                    ypos = t.by >> ss_ver
                    dst_x = 4 * xpos
                    dst_y = 4 * ypos
                    m, _, edge, ofs = ipred_mod.prepare_intra_edges(
                        xpos, xpos > (ts.col_start >> ss_hor),
                        ypos, ypos > (ts.row_start >> ss_ver),
                        ts.col_end >> ss_hor, ts.row_end >> ss_ver,
                        0, f.planes[1 + pl], dst_y, dst_x, top_sb_edge, 0,
                        M.DC_PRED, 0, utw, uth, 0, bitdepth)
                    pred = ipred_mod.cfl_pred(m, edge, ofs, utw * 4, uth * 4,
                                              ac, b.cfl_alpha[pl], bitdepth)
                    f.planes[1 + pl][dst_y : dst_y + uth * 4,
                                     dst_x : dst_x + utw * 4] = pred
            elif b.pal_sz[1]:
                dst_x = 4 * (t.bx >> ss_hor)
                dst_y = 4 * (t.by >> ss_ver)
                for pl in range(2):
                    f.planes[1 + pl][dst_y : dst_y + cbh4 * 4,
                                     dst_x : dst_x + cbw4 * 4] = \
                        ipred_mod.pal_pred(t.scratch_pal[1 + pl],
                                           t.pal_idx_uv, cbw4 * 4, cbh4 * 4)

            uv_sb_has_tr = (
                1 if ((init_x + 16) >> ss_hor) < cw4 else 0 if init_y else
                intra_edge_flags & ((1 << 2) >> (f.layout - 1)))
            uv_sb_has_bl = (
                0 if init_x else 1 if ((init_y + 16) >> ss_ver) < ch4 else
                intra_edge_flags & ((1 << 5) >> (f.layout - 1)))
            sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
            for pl in range(2):
                y = init_y >> ss_ver
                t.by += init_y
                while y < sub_ch4:
                    x = init_x >> ss_hor
                    t.bx += init_x
                    while x < sub_cw4:
                        dst_x = 4 * ((t.bx + 0) >> ss_hor)
                        dst_y = 4 * (t.by >> ss_ver)
                        if (b.uv_mode == M.CFL_PRED and b.cfl_alpha[pl]) \
                                or b.pal_sz[1] or t.pass_ == 1:
                            _coef_uv(t, b, bs, pl, x, y, cbx4, cby4, utw,
                                     uth, dst_y, dst_x, f, ts, bitdepth,
                                     ss_hor, ss_ver)
                            x += utw
                            t.bx += utw << ss_hor
                            continue
                        angle = b.uv_angle
                        edge_flags = (
                            (0 if ((y > (init_y >> ss_ver)
                                    or not uv_sb_has_tr)
                                   and (x + utw >= sub_cw4))
                             else EDGE_I444_TOP_HAS_RIGHT)
                            | (0 if (x > (init_x >> ss_hor)
                                     or (not uv_sb_has_bl
                                         and y + uth >= sub_ch4))
                               else EDGE_I444_LEFT_HAS_BOTTOM))
                        top_sb_edge = None
                        if not ((t.by & ~ss_ver) & (f.sb_step - 1)):
                            sby = t.by >> f.sb_shift
                            if sby > 0:
                                top_sb_edge = f.planes[1 + pl][
                                    (((t.by & ~ss_ver) * 4) >> ss_ver) - 1] \
                                    if t.pass_ == 2 else \
                                    f.ipred_edge[1 + pl][sby - 1]
                        uv_mode = M.DC_PRED if b.uv_mode == M.CFL_PRED \
                            else b.uv_mode
                        xpos = t.bx >> ss_hor
                        ypos = t.by >> ss_ver
                        xstart = ts.col_start >> ss_hor
                        ystart = ts.row_start >> ss_ver
                        m, angle, edge, ofs = ipred_mod.prepare_intra_edges(
                            xpos, xpos > xstart, ypos, ypos > ystart,
                            ts.col_end >> ss_hor, ts.row_end >> ss_ver,
                            edge_flags, f.planes[1 + pl], dst_y, dst_x,
                            top_sb_edge, 0, uv_mode, angle, utw, uth,
                            f.seq_hdr.intra_edge_filter, bitdepth)
                        angle |= intra_edge_filter_flag
                        planec = f.planes[1 + pl]
                        pred = ipred_mod.ipred(
                            m, edge, ofs, utw * 4, uth * 4,
                            angle | sm_uv_fl,
                            (4 * f.bw + ss_hor - 4 * (t.bx & ~ss_hor)) >> ss_hor,
                            (4 * f.bh + ss_ver - 4 * (t.by & ~ss_ver)) >> ss_ver,
                            bitdepth,
                            out_ptr=planec.ctypes.data
                            + (dst_y * planec.shape[1] + dst_x) * 4,
                            out_stride=planec.shape[1])
                        if pred is not None:
                            planec[dst_y : dst_y + uth * 4,
                                   dst_x : dst_x + utw * 4] = pred

                        _coef_uv(t, b, bs, pl, x, y, cbx4, cby4, utw, uth,
                                 dst_y, dst_x, f, ts, bitdepth, ss_hor,
                                 ss_ver)
                        x += utw
                        t.bx += utw << ss_hor
                    t.bx -= x << ss_hor
                    y += uth
                    t.by += uth << ss_ver
                t.by -= y << ss_ver
