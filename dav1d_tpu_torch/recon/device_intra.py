"""Device intra reconstruction: whole-frame wavefront levels (counterpart
of dav1d_tpu/recon/device_intra.py).

Intra prediction reads its own outputs: every block's edge vector is
built from its neighbours' reconstructed pixels, so the reference walks
the blocks in decode order (src/recon_tmpl.c:1176-1556).  Here the
pixels stay on the device and the order becomes a schedule of levels:

1. host (:func:`_enumerate_units`, copied from the reference): walk the
   captured blocks in decode order and emit one job row per prediction
   unit (the geometry of recon/intra.recon_b_intra: position, transform
   size, resolved mode and angle, edge availability), each with its
   wavefront level over a 4x4 map of the plane (:class:`_LevelMap`):
   1 + the highest level of any cell its edge gather can read, so the
   units of one level never read each other's cells;
2. device (:func:`intra_frame_device`): the planes after phase A (inter
   blocks final) go up once, luma and the two chroma planes stacked
   vertically; the residual canvases are scattered on the device from
   the itx kernel's output, which never came up from the host; each
   chain's walk table (:func:`_job_table`: job rows sorted by level and
   kind, a tag each, the units of each level) goes up in the same copy;
   one launch per chain holding units (ops/ipred.walk, kernel
   ``ipred_walk`` of csrc/ipred.cu) reconstructs every level in order,
   in place; the luma chain runs before the chroma one (CFL reads
   finished luma); the planes come down once, narrow.

The reference fused up to 64 levels into one XLA program
(_multi_run_program, planned by KMAX/GMAX) for XLA's program cache and
launch cost; the walk is its Hopper form and takes every level of a
chain.  The reference's sink shim (_chain_call) is not ported, nor its
sticky fallback to the host walk on a device error: a failing launch
raises out of the decode.

Coverage: a frame with intrabc blocks (they copy from the in-progress
canvas in decode order), with interintra blocks (phase A leaves them to
the ordered walk, so they are not final when the schedule runs), or with
a palette or CFL unit the schedule cannot place (:func:`_enumerate_units`
returns None), returns False: the host walk reconstructs it, and the
pipeline counts it in devrt.COUNTS["intra_host_frames"].  An all-inter
frame has no unit and makes no launch.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import devrt, state, tables
from ..headers import PixelLayout
from ..levels import IntraPredMode as M
from ..ops import ipred as oip
from ..ops import itx as ditx
from .ipred import (ANGLE_SMOOTH_EDGE_FLAG, EDGE_I444_LEFT_HAS_BOTTOM,
                    EDGE_I444_TOP_HAS_RIGHT, EDGE_NEEDS, MODE_TO_ANGLE)

# edge-meta fields of _edge_meta's tuple
_DY, _DX, _HL, _HT = 0, 1, 2, 3
_ANGULAR = (M.Z1_PRED, M.Z2_PRED, M.Z3_PRED)
KINDS = ("pred", "cfl", "pal")


def _resolve_mode(mode, angle, have_left, have_top):
    """The mode/angle remap at the top of prepare_intra_edges."""
    if M.VERT_PRED <= mode <= M.VERT_LEFT_PRED:
        angle = MODE_TO_ANGLE[mode - M.VERT_PRED] + 3 * angle
        if angle <= 90:
            mode = M.Z1_PRED if angle < 90 and have_top else M.VERT_PRED
        elif angle < 180:
            mode = M.Z2_PRED
        else:
            mode = M.Z3_PRED if angle > 180 and have_left else M.HOR_PRED
    elif mode == M.DC_PRED:
        mode = [[M.DC_128_PRED, M.TOP_DC_PRED],
                [M.LEFT_DC_PRED, M.DC_PRED]][int(bool(have_left))][
                    int(bool(have_top))]
    elif mode == M.PAETH_PRED:
        mode = [[M.DC_128_PRED, M.VERT_PRED],
                [M.HOR_PRED, M.PAETH_PRED]][int(bool(have_left))][
                    int(bool(have_top))]
    return int(mode), int(angle)


class _LevelMap:
    """4x4-granular wavefront levels for one plane."""

    __slots__ = ("lvl", "h4", "w4")

    def __init__(self, ph, pw):
        self.h4, self.w4 = ph >> 2, pw >> 2
        self.lvl = np.zeros((self.h4, self.w4), dtype=np.int32)

    def place(self, dy, dx, w, h, have_l, have_t):
        """Assign the unit its level from the cells its edge gather can
        touch (conservatively the full 2x spans — extra cells only ever
        raise the level), then mark its output window."""
        lvl = self.lvl
        r0, c0 = dy >> 2, dx >> 2
        level = 0
        if have_t and r0 > 0:
            seg = lvl[r0 - 1, max(c0 - 1, 0):min(c0 + ((2 * w) >> 2) + 1,
                                                 self.w4)]
            if seg.size:
                level = int(seg.max())
        if have_l and c0 > 0:
            seg = lvl[max(r0 - 1, 0):min(r0 + ((2 * h) >> 2) + 1, self.h4),
                      c0 - 1]
            if seg.size:
                level = max(level, int(seg.max()))
        # the cross-side fills (canvas[dy-1, dx] / [dy, dx-1]) are inside
        # the spans above
        level += 1
        lvl[r0:r0 + (h >> 2), c0:c0 + (w >> 2)] = level
        return level


def _edge_meta(xpos, have_left, ypos, have_top, w_end, h_end, edge_flags,
               mode, angle, tw, th):
    """Resolve (impl mode, final angle) + the 8 availability scalars of
    one prediction unit — the host half of prepare_intra_edges."""
    mode_i, angle_r = _resolve_mode(mode, angle, have_left, have_top)
    if mode_i not in EDGE_NEEDS:
        return None
    needs_left, needs_top, _, needs_tr, needs_bl = EDGE_NEEDS[mode_i]
    px_l = px_bl = px_t = px_tr = 0
    if needs_left and have_left:
        px_l = min(th << 2, (h_end - ypos) << 2)
        if needs_bl and ypos + th < h_end and \
                edge_flags & EDGE_I444_LEFT_HAS_BOTTOM:
            px_bl = min(th << 2, (h_end - ypos - th) << 2)
    if needs_top and have_top:
        px_t = min(tw << 2, (w_end - xpos) << 2)
        if needs_tr and xpos + tw < w_end and \
                edge_flags & EDGE_I444_TOP_HAS_RIGHT:
            px_tr = min(tw << 2, (w_end - xpos - tw) << 2)
    return mode_i, angle_r, (4 * ypos, 4 * xpos, int(bool(have_left)),
                             int(bool(have_top)), px_l, px_bl, px_t, px_tr)


def _emit_pred_unit(emit, lmap, ch, mode, angle, flags, xpos, ypos, tw, th,
                    col_start, col_end, row_start, row_end, edge_flags, ief,
                    max_w, max_h, row_off=0):
    meta = _edge_meta(xpos, xpos > col_start, ypos, ypos > row_start,
                      col_end, row_end, edge_flags, mode, angle, tw, th)
    if meta is None:
        return
    mode_i, angle_r, m = meta
    m = (m[_DY] + row_off,) + m[1:]
    w, h = tw * 4, th * 4
    if mode_i in _ANGULAR:
        akey = angle_r | flags
        kmw = min(max_w, w) if mode_i == M.Z2_PRED else 0
        kmh = min(max_h, h) if mode_i == M.Z2_PRED else 0
    elif mode_i == M.FILTER_PRED:
        akey, kmw, kmh = angle_r & 511, 0, 0
    else:
        akey, kmw, kmh = 0, 0, 0
    z2f = int(mode_i == M.Z2_PRED and tw + th >= 6 and ief)
    level = lmap.place(m[_DY], m[_DX], w, h, m[_HL], m[_HT])
    emit(ch, "pred", level, [m[0], m[1], w, h, *m[2:], akey, kmw, kmh, z2f,
                             mode_i, 0])


def _enumerate_units(f, glue, ranges):
    """Walk the capture arena in decode order, mirroring
    recon/intra.recon_b_intra's unit geometry (dav1d_tpu/recon/
    device_intra._enumerate_units).  Returns (schedule, level maps), the
    schedule per chain (0 luma, 1 the stacked chroma pair)
    {level: {kind: [job rows]}}, or (None, None) on a block the device
    path does not cover."""
    bdim = tables.block_dimensions
    tinfo = tables.txfm_info()
    ss_ver, ss_hor = f.ss_ver, f.ss_hor
    layout = f.layout
    ief = int(f.seq_hdr.intra_edge_filter)
    ief_flag = ief << 10
    rows = glue.cap_blocks
    n_planes = 1 if layout == PixelLayout.I400 else 3
    hc = f.planes[1].shape[0] if n_planes == 3 else 0
    n_chains = 1 if n_planes == 1 else 2

    maps = [_LevelMap(*f.planes[0].shape)]
    if n_chains == 2:
        maps.append(_LevelMap(2 * hc, f.planes[1].shape[1]))
    sched = [{} for _ in range(n_chains)]

    def emit(ch, kind, level, row):
        sched[ch].setdefault(level, {}).setdefault(kind, []).append(row)

    for s, e in ranges:
        for i in range(s, e):
            row = rows[i]
            kind = int(row["kind"])
            if kind == 2 or (kind == 1 and int(row["interintra_type"])):
                # intrabc copies from the in-progress canvas in decode
                # order; an interintra block's prediction waits for the
                # ordered walk (phase A skips it): both need the host walk
                return None, None
            if kind == 1:
                # inter block: final after phase A, its cells stay at
                # level 0
                continue
            ts = glue.ts_of_block(i)
            bx, by = int(row["bx"]), int(row["by"])
            bs = int(row["bs"])
            bw4, bh4 = int(bdim[bs][0]), int(bdim[bs][1])
            w4 = min(bw4, f.bw - bx)
            h4 = min(bh4, f.bh - by)
            cw4 = (w4 + ss_hor) >> ss_hor
            ch4 = (h4 + ss_ver) >> ss_ver
            cbw4 = (bw4 + ss_hor) >> ss_hor
            cbh4 = (bh4 + ss_ver) >> ss_ver
            has_chroma = (n_planes == 3
                          and (bw4 > ss_hor or bx & 1)
                          and (bh4 > ss_ver or by & 1))
            t_dim = tinfo[int(row["tx"])]
            uv_t_dim = tinfo[int(row["uvtx"])]
            tw, th = int(t_dim[0]), int(t_dim[1])
            utw, uth = int(uv_t_dim[0]), int(uv_t_dim[1])
            ief_flags = int(row["edge_flags"])
            sm = int(row["sm_flags"])
            sm_fl = ANGLE_SMOOTH_EDGE_FLAG if sm & 1 else 0
            sm_uv_fl = ANGLE_SMOOTH_EDGE_FLAG if sm & 2 else 0
            y_mode = int(row["y_mode"])
            uv_mode = int(row["uv_mode"])
            y_angle = int(row["y_angle"])
            uv_angle = int(row["uv_angle"])
            pal_y = int(row["pal_sz"][0])
            pal_uv = int(row["pal_sz"][1])
            cfl = [int(row["cfl_alpha"][0]), int(row["cfl_alpha"][1])]

            if pal_y or pal_uv:
                pal_idx = int(row["pal_idx"])
                if pal_idx < 0:
                    return None, None
                pal = glue.cap_pal[pal_idx].astype(np.int64)

            if pal_y:
                # whole-block palette unit, its residuals from the canvas;
                # no edge reads
                dy0, dx0 = 4 * by, 4 * bx
                off = int(row["pal_y_off"])
                if off < 0:
                    return None, None
                level = maps[0].place(dy0, dx0, bw4 * 4, bh4 * 4, 0, 0)
                emit(0, "pal", level, [dy0, dx0, bw4 * 4, bh4 * 4, off, 0, 0,
                                       0, *pal[0]])

            for init_y in range(0, h4, 16):
                sub_h4 = min(h4, 16 + init_y)
                sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
                for init_x in range(0, w4, 16):
                    sb_has_tr = (1 if init_x + 16 < w4 else 0 if init_y
                                 else ief_flags & EDGE_I444_TOP_HAS_RIGHT)
                    sb_has_bl = (0 if init_x else 1 if init_y + 16 < h4
                                 else ief_flags & EDGE_I444_LEFT_HAS_BOTTOM)
                    sub_w4 = min(w4, init_x + 16)

                    if not pal_y:
                        y = init_y
                        while y < sub_h4:
                            x = init_x
                            while x < sub_w4:
                                eflags = (
                                    (0 if ((y > init_y or not sb_has_tr)
                                           and (x + tw >= sub_w4))
                                     else EDGE_I444_TOP_HAS_RIGHT)
                                    | (0 if (x > init_x
                                             or (not sb_has_bl
                                                 and y + th >= sub_h4))
                                       else EDGE_I444_LEFT_HAS_BOTTOM))
                                _emit_pred_unit(
                                    emit, maps[0], 0, y_mode, y_angle,
                                    sm_fl | ief_flag, bx + x, by + y, tw, th,
                                    ts.col_start, ts.col_end, ts.row_start,
                                    ts.row_end, eflags, ief,
                                    4 * f.bw - 4 * (bx + x),
                                    4 * f.bh - 4 * (by + y))
                                x += tw
                            y += th

                    if not has_chroma:
                        continue

                    if uv_mode == M.CFL_PRED and not init_x and not init_y \
                            and (cfl[0] or cfl[1]):
                        if cbw4 != utw or cbh4 != uth:
                            return None, None  # multi-txb CFL: host walk
                        y0p = 4 * (by & ~ss_ver)
                        x0p = 4 * (bx & ~ss_hor)
                        furthest_r = ((cw4 << ss_hor) + utw - 1) & ~(utw - 1)
                        furthest_b = ((ch4 << ss_ver) + uth - 1) & ~(uth - 1)
                        w_pad = cbw4 - (furthest_r >> ss_hor)
                        h_pad = cbh4 - (furthest_b >> ss_ver)
                        for pl in range(2):
                            if not cfl[pl]:
                                continue
                            xpos = bx >> ss_hor
                            ypos = by >> ss_ver
                            meta = _edge_meta(
                                xpos, xpos > (ts.col_start >> ss_hor),
                                ypos, ypos > (ts.row_start >> ss_ver),
                                ts.col_end >> ss_hor,
                                ts.row_end >> ss_ver, 0,
                                M.DC_PRED, 0, utw, uth)
                            if meta is None:
                                return None, None
                            mode_i, _, m = meta
                            m = (m[_DY] + pl * hc,) + m[1:]
                            level = maps[1].place(
                                m[_DY], m[_DX], utw * 4, uth * 4,
                                m[_HL], m[_HT])
                            emit(1, "cfl", level,
                                 [m[0], m[1], utw * 4, uth * 4, *m[2:], y0p,
                                  x0p, cfl[pl], w_pad, mode_i, h_pad])

                    if pal_uv and not init_x and not init_y:
                        off = int(row["pal_uv_off"])
                        if off < 0:
                            return None, None
                        dyc = 4 * (by >> ss_ver)
                        dxc = 4 * (bx >> ss_hor)
                        for pl in range(2):
                            level = maps[1].place(
                                dyc + pl * hc, dxc, cbw4 * 4,
                                cbh4 * 4, 0, 0)
                            emit(1, "pal", level,
                                 [dyc + pl * hc, dxc, cbw4 * 4, cbh4 * 4,
                                  off, 0, 0, 0, *pal[1 + pl]])

                    if (uv_mode == M.CFL_PRED and (cfl[0] or cfl[1])) \
                            or pal_uv:
                        # CFL with one zero alpha still predicts that
                        # plane per transform block below; palette covers
                        # both
                        planes_left = [] if pal_uv else \
                            [pl for pl in range(2) if not cfl[pl]]
                    else:
                        planes_left = [0, 1]

                    uv_sb_has_tr = (
                        1 if ((init_x + 16) >> ss_hor) < cw4 else
                        0 if init_y else
                        ief_flags & ((1 << 2) >> (layout - 1)))
                    uv_sb_has_bl = (
                        0 if init_x else
                        1 if ((init_y + 16) >> ss_ver) < ch4 else
                        ief_flags & ((1 << 5) >> (layout - 1)))
                    sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
                    uv_imode = M.DC_PRED if uv_mode == M.CFL_PRED \
                        else uv_mode
                    for pl in planes_left:
                        y = init_y >> ss_ver
                        while y < sub_ch4:
                            x = init_x >> ss_hor
                            while x < sub_cw4:
                                tbx = bx + init_x \
                                    + ((x - (init_x >> ss_hor)) << ss_hor)
                                tby = by + init_y \
                                    + ((y - (init_y >> ss_ver)) << ss_ver)
                                eflags = (
                                    (0 if ((y > (init_y >> ss_ver)
                                            or not uv_sb_has_tr)
                                           and (x + utw >= sub_cw4))
                                     else EDGE_I444_TOP_HAS_RIGHT)
                                    | (0 if (x > (init_x >> ss_hor)
                                             or (not uv_sb_has_bl
                                                 and y + uth >= sub_ch4))
                                       else EDGE_I444_LEFT_HAS_BOTTOM))
                                _emit_pred_unit(
                                    emit, maps[1], 1, uv_imode,
                                    uv_angle, sm_uv_fl | ief_flag,
                                    tbx >> ss_hor, tby >> ss_ver, utw, uth,
                                    ts.col_start >> ss_hor,
                                    ts.col_end >> ss_hor,
                                    ts.row_start >> ss_ver,
                                    ts.row_end >> ss_ver, eflags, ief,
                                    (4 * f.bw + ss_hor
                                     - 4 * (tbx & ~ss_hor)) >> ss_hor,
                                    (4 * f.bh + ss_ver
                                     - 4 * (tby & ~ss_ver)) >> ss_ver,
                                    row_off=pl * hc)
                                x += utw
                            y += uth

    return sched, maps


def _residual_canvases(f, st, shapes, hc):
    """The chains' int32 residual canvases on ``f.device``, scattered from
    the itx kernel's flat output (``st.dev``, still on the device) by each
    transform block's offset (the itx job table) and its meta row's
    plane and position; zero where a block has no residual.  Only the
    (position, offset) rows of the blocks go up."""
    dev = f.device
    canvases = [torch.zeros(s, dtype=torch.int32, device=dev)
                for s in shapes]
    if st.dev is None:
        return canvases
    meta = f._nat.meta_rows()
    m = np.flatnonzero(st.pos >= 0)
    jobs = st.jobs[st.pos[m]]
    pl = meta[m, 2] & 0xFF
    dy = meta[m, 3].astype(np.int64) + np.where(pl == 2, hc, 0)
    chain = np.minimum(pl, 1)
    widths = np.array([s[1] for s in shapes], np.int64)
    base = dy * widths[chain] + meta[m, 4]
    groups, parts = [], []
    for tx in np.unique(jobs[:, ditx.J_TX]):
        w, h = ditx._txinfo(int(tx))[:2]
        for c in range(len(shapes)):
            sel = (jobs[:, ditx.J_TX] == tx) & (chain == c)
            if sel.any():
                groups.append((c, w, h, int(sel.sum())))
                parts += [base[sel], jobs[sel, ditx.J_OUT].astype(np.int64)]
    t = devrt.upload(np.concatenate(parts), dev)
    out = st.dev.reshape(-1)
    o = 0
    for c, w, h, n in groups:
        b, src = t[o:o + n], t[o + n:o + 2 * n]
        o += 2 * n
        yy = torch.arange(h, device=dev)[None, :, None]
        xx = torch.arange(w, device=dev)[None, None, :]
        dst = b[:, None, None] + yy * shapes[c][1] + xx
        canvases[c].view(-1)[dst] = out[src[:, None, None] + yy * w +
                                        xx].to(torch.int32)
    return canvases


def _job_table(levels):
    """One chain's walk table (ops/ipred.walk): int32 (n, JOB_COLS) job
    rows sorted by level and then kind, their int32 tags (the level's
    index << 2 | kind) and the int32 units of each level, checked."""
    groups, counts = [], []
    for i, level in enumerate(sorted(levels)):
        n = 0
        for k, kind in enumerate(KINDS):
            units = levels[level].get(kind)
            if units:
                groups.append((i << 2 | k, units))
                n += len(units)
        counts.append(n)
    n = sum(counts)
    J = np.fromiter(itertools.chain.from_iterable(
        itertools.chain.from_iterable(u for _, u in groups)), np.int32,
        count=n * oip.JOB_COLS).reshape(n, oip.JOB_COLS)
    tags = np.repeat(np.asarray([t for t, _ in groups], np.int32),
                     [len(u) for _, u in groups])
    counts = np.asarray(counts, np.int32)
    oip.check_walk(tags, counts, n)
    return J, tags, counts


def intra_frame_device(f, st) -> bool:
    """Phase B on ``f.device``: every intra unit of the frame, one walk
    launch per chain holding units.  Returns False (the caller runs the
    host walk) when the frame has blocks this path does not cover.
    Spans: ``pass2.intra.schedule`` (the unit walk), ``.device`` (the
    rest), within it ``.table`` (the walk tables), ``.upload`` (planes,
    residual canvases, tables, index maps), ``.walk`` (the launches) and
    ``.download`` (which waits for the walks)."""
    glue = f._nat
    with devrt.span("pass2.intra.schedule"):
        sched, _ = _enumerate_units(f, glue, glue.block_ranges())
    if sched is None:
        return False
    if not any(sched):
        return True  # all-inter: phase A reconstructed every block
    dev, bd = f.device, f.bitdepth
    with devrt.span("pass2.intra.device"):
        with devrt.span("pass2.intra.table"):
            tabs = [_job_table(levels) for levels in sched]
        with devrt.span("pass2.intra.upload"):
            planes = state.upload_planes(f.planes, bd, dev)
            hc = f.planes[1].shape[0] if len(planes) == 3 else 0
            canv = [planes[0]] + ([torch.cat(planes[1:])] if hc else [])
            resid = _residual_canvases(f, st, [c.shape for c in canv], hc)
            pidx = None
            pal = [J[(tags & 3) == oip.KIND_PAL] for J, tags, _ in tabs]
            if any(len(P) for P in pal):  # the index maps, to the last end
                P = np.concatenate(pal)
                end = int((P[:, oip.J_IDX]
                           + P[:, oip.J_W] * P[:, oip.J_H]).max())
                pidx = devrt.upload(glue.pal_arena[:end], dev)
            # the chains' job rows, tags and level counts in one copy
            flat = devrt.upload(np.concatenate(
                [J.reshape(-1) for J, _, _ in tabs]
                + [a for _, t, c in tabs for a in (t, c)]), dev)
        with devrt.span("pass2.intra.walk"):
            o = sum(J.size for J, _, _ in tabs)
            j0 = 0
            for ch, (J, tags, counts) in enumerate(tabs):
                jt = flat[j0:j0 + J.size].view(-1, oip.JOB_COLS)
                tt = flat[o:o + len(tags)]
                ct = flat[o + len(tags):o + len(tags) + len(counts)]
                j0 += J.size
                o += len(tags) + len(counts)
                if not len(J):
                    continue
                devrt.call("ipred_walk", oip.walk, canv[ch], canv[0],
                           resid[ch], jt, tt, ct, pidx,
                           f.planes[ch].shape[0], f.ss_hor, f.ss_ver, bd,
                           max_ctas=oip.walk_ctas(counts))
                devrt.COUNTS["intra_walk_launches"] += 1
                devrt.COUNTS["intra_levels"] += len(counts)
                pairs = np.unique(tags) & 3  # each (level, kind) once
                for k, kind in enumerate(KINDS):
                    if (pairs == k).any():
                        devrt.COUNTS[f"intra_{kind}_units"] += int(
                            ((tags & 3) == k).sum())
                        devrt.COUNTS[f"intra_{kind}_levels"] += int(
                            (pairs == k).sum())
        with devrt.span("pass2.intra.download"):
            cast = devrt.narrow_cast(bd)
            f.planes[0][:] = devrt.fetch(cast(canv[0]))
            if hc:
                uv = devrt.fetch(cast(canv[1]))
                f.planes[1][:] = uv[:hc]
                f.planes[2][:] = uv[hc:]
    return True
