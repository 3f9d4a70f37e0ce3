"""Film grain synthesis and application.

Behavioral parity with reference src/filmgrain_tmpl.c (generate_grain_y :50,
generate_grain_uv :89, fgy/fguv_32x32xn :170-404) and src/fg_apply_tmpl.c
(generate_scaling :41, prep/apply :100-241); AV1 spec 7.18.3.
Grain is an output-stage operation: reference pictures stay grain-free.
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..headers import PixelLayout

GRAIN_WIDTH = 82
GRAIN_HEIGHT = 73
SUB_GRAIN_WIDTH = 44
SUB_GRAIN_HEIGHT = 38
FG_BLOCK_SIZE = 32


def _rand(state, bits):
    r = state[0]
    bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
    state[0] = (r >> 1) | (bit << 15)
    return (state[0] >> (16 - bits)) & ((1 << bits) - 1)


def _round2(x, shift):
    return (x + ((1 << shift) >> 1)) >> shift


def generate_grain_y(data, bitdepth):
    bdm8 = bitdepth - 8
    state = [data.seed]
    shift = 4 - bdm8 + data.grain_scale_shift
    grain_ctr = 128 << bdm8
    gmin, gmax = -grain_ctr, grain_ctr - 1
    gauss = tables.gaussian_sequence

    buf = np.zeros((GRAIN_HEIGHT + 1, GRAIN_WIDTH), dtype=np.int32)
    for y in range(GRAIN_HEIGHT):
        for x in range(GRAIN_WIDTH):
            buf[y, x] = _round2(int(gauss[_rand(state, 11)]), shift)

    lag = data.ar_coeff_lag
    coeffs = data.ar_coeffs_y
    if lag:
        for y in range(3, GRAIN_HEIGHT):
            for x in range(3, GRAIN_WIDTH - 3):
                s = 0
                ci = 0
                for dy in range(-lag, 1):
                    for dx in range(-lag, lag + 1):
                        if not dx and not dy:
                            break
                        s += coeffs[ci] * int(buf[y + dy, x + dx])
                        ci += 1
                g = int(buf[y, x]) + _round2(s, data.ar_coeff_shift)
                buf[y, x] = max(gmin, min(gmax, g))
    return buf


def generate_grain_uv(data, buf_y, uv, subx, suby, bitdepth):
    bdm8 = bitdepth - 8
    state = [data.seed ^ (0x49D8 if uv else 0xB524)]
    shift = 4 - bdm8 + data.grain_scale_shift
    grain_ctr = 128 << bdm8
    gmin, gmax = -grain_ctr, grain_ctr - 1
    gauss = tables.gaussian_sequence

    ch_w = SUB_GRAIN_WIDTH if subx else GRAIN_WIDTH
    ch_h = SUB_GRAIN_HEIGHT if suby else GRAIN_HEIGHT

    buf = np.zeros((GRAIN_HEIGHT + 1, GRAIN_WIDTH), dtype=np.int32)
    for y in range(ch_h):
        for x in range(ch_w):
            buf[y, x] = _round2(int(gauss[_rand(state, 11)]), shift)

    lag = data.ar_coeff_lag
    coeffs = data.ar_coeffs_uv[uv]
    for y in range(3, ch_h):
        for x in range(3, ch_w - 3):
            s = 0
            ci = 0
            done = False
            for dy in range(-lag, 1):
                for dx in range(-lag, lag + 1):
                    if not dx and not dy:
                        if data.num_y_points:
                            luma = 0
                            lx = ((x - 3) << subx) + 3
                            ly = ((y - 3) << suby) + 3
                            for i in range(suby + 1):
                                for j in range(subx + 1):
                                    luma += int(buf_y[ly + i, lx + j])
                            luma = _round2(luma, subx + suby)
                            s += luma * coeffs[ci]
                        done = True
                        break
                    s += coeffs[ci] * int(buf[y + dy, x + dx])
                    ci += 1
                if done:
                    break
            g = int(buf[y, x]) + _round2(s, data.ar_coeff_shift)
            buf[y, x] = max(gmin, min(gmax, g))
    return buf


def generate_scaling(bitdepth, points, num):
    """Piecewise-linear scaling LUT (reference generate_scaling,
    src/fg_apply_tmpl.c:41-97)."""
    shift_x = bitdepth - 8
    size = 1 << bitdepth
    scaling = np.zeros(size, dtype=np.int32)
    if num == 0:
        return scaling
    scaling[: points[0][0] << shift_x] = points[0][1]
    for i in range(num - 1):
        bx, by = points[i]
        ex, ey = points[i + 1]
        dx = ex - bx
        dy = ey - by
        delta = dy * ((0x10000 + (dx >> 1)) // dx)
        d = 0x8000
        for x in range(dx):
            scaling[(bx + x) << shift_x] = by + (d >> 16)
            d += delta
    n = points[num - 1][0] << shift_x
    scaling[n:] = points[num - 1][1]
    if shift_x:
        pad = 1 << shift_x
        rnd = pad >> 1
        for i in range(num - 1):
            bx = points[i][0] << shift_x
            ex = points[i + 1][0] << shift_x
            for x in range(0, ex - bx, pad):
                rng = int(scaling[bx + x + pad]) - int(scaling[bx + x])
                r = rnd
                for k in range(1, pad):
                    r += rng
                    scaling[bx + x + k] = scaling[bx + x] + (r >> shift_x)
    return scaling


def _block_offsets(data, row_num, pw, sub_x):
    """Per-block grain offsets for a block row, incl. previous-row offsets
    (the reference's seed[0]/seed[1] + offsets[2][2] shifting)."""
    rows = 1 + (data.overlap_flag and row_num > 0)
    states = []
    for i in range(rows):
        s = data.seed
        s ^= (((row_num - i) * 37 + 178) & 0xFF) << 8
        s ^= ((row_num - i) * 173 + 105) & 0xFF
        states.append([s])
    bsz = FG_BLOCK_SIZE >> sub_x
    n_blocks = (pw + bsz - 1) // bsz
    offs = np.zeros((n_blocks, 2), dtype=np.int32)  # [block][row 0=cur,1=up]
    for b in range(n_blocks):
        for i in range(rows):
            offs[b, i] = _rand(states[i], 8)
    return offs, rows


def _lut_block(lut, offs, subx, suby, bx_sel, by_sel, bw, bh):
    """Grain slab for one block (reference sample_lut)."""
    randval = int(offs)
    offx = 3 + (2 >> subx) * (3 + (randval >> 4))
    offy = 3 + (2 >> suby) * (3 + (randval & 0xF))
    offx += (FG_BLOCK_SIZE >> subx) * bx_sel
    offy += (FG_BLOCK_SIZE >> suby) * by_sel
    return lut[offy : offy + bh, offx : offx + bw].astype(np.int64)


_W_SUB = [[[27, 17], [17, 27]], [[23, 22], [0, 0]]]


def _grain_blocks(data, lut, row_num, pw, bh, subx, suby, gmin, gmax):
    """Assemble the blended grain row (pw wide, bh tall) for block row
    row_num, applying the overlap blending."""
    offs, rows = _block_offsets(data, row_num, pw, subx)
    bsz = FG_BLOCK_SIZE >> subx
    grain_row = np.zeros((bh, pw), dtype=np.int64)
    wsx = _W_SUB[subx]
    wsy = _W_SUB[suby]
    for bi in range(offs.shape[0]):
        bx = bi * bsz
        bw = min(bsz, pw - bx)
        g = _lut_block(lut, offs[bi, 0], subx, suby, 0, 0, bw, bh)
        ystart = min(2 >> suby, bh) if (data.overlap_flag and row_num) else 0
        xstart = min(2 >> subx, bw) if (data.overlap_flag and bx) else 0
        if xstart:
            old = _lut_block(lut, offs[bi - 1, 0], subx, suby, 1, 0, bw, bh)
            for x in range(xstart):
                blend = _round2_arr(old[:, x] * wsx[x][0]
                                    + g[:, x] * wsx[x][1], 5)
                g[:, x] = np.clip(blend, gmin, gmax)
        if ystart:
            top = _lut_block(lut, offs[bi, 1], subx, suby, 0, 1, bw, ystart)
            if xstart:
                told = _lut_block(lut, offs[bi - 1, 1], subx, suby, 1, 1,
                                  bw, ystart)
                for x in range(xstart):
                    blend = _round2_arr(told[:, x] * wsx[x][0]
                                        + top[:, x] * wsx[x][1], 5)
                    top[:, x] = np.clip(blend, gmin, gmax)
            for y in range(ystart):
                blend = _round2_arr(top[y] * wsy[y][0] + g[y] * wsy[y][1], 5)
                g[y] = np.clip(blend, gmin, gmax)
        grain_row[:, bx : bx + bw] = g
    return grain_row


def _round2_arr(x, shift):
    return (x + ((1 << shift) >> 1)) >> shift


def _fg_cdata(data):
    """Build the ctypes mirror of FilmGrainData for the native tier."""
    import ctypes

    from ..native import CFgData

    c = CFgData()
    c.seed = data.seed
    c.num_y_points = data.num_y_points
    c.chroma_scaling_from_luma = data.chroma_scaling_from_luma
    c.scaling_shift = data.scaling_shift
    c.ar_coeff_lag = data.ar_coeff_lag
    c.ar_coeff_shift = data.ar_coeff_shift
    c.grain_scale_shift = data.grain_scale_shift
    c.overlap_flag = data.overlap_flag
    c.clip_to_restricted_range = data.clip_to_restricted_range
    for i in range(2):
        c.num_uv_points[i] = data.num_uv_points[i]
        c.uv_mult[i] = data.uv_mult[i]
        c.uv_luma_mult[i] = data.uv_luma_mult[i]
        c.uv_offset[i] = data.uv_offset[i]
    for i, (px, py) in enumerate(data.y_points):
        c.y_points[i][0], c.y_points[i][1] = px, py
    for uv in range(2):
        for i, (px, py) in enumerate(data.uv_points[uv]):
            c.uv_points[uv][i][0], c.uv_points[uv][i][1] = px, py
        for i, v in enumerate(data.ar_coeffs_uv[uv]):
            c.ar_coeffs_uv[uv][i] = v
    for i, v in enumerate(data.ar_coeffs_y):
        c.ar_coeffs_y[i] = v
    return c


def _apply_grain_native(pic) -> bool:
    """Native whole-frame grain pass (fg.c): LUT + scaling generation and
    per-plane application in C, chroma first so it scales off pristine
    luma, then luma in place (no grain-free luma copy needed)."""
    import ctypes

    from ..native import lib as _nlib

    if _nlib is None:
        return False
    hdr = pic.frame_hdr
    data = hdr.film_grain.data
    bitdepth = pic.bitdepth
    ss_y = int(pic.layout == PixelLayout.I420)
    ss_x = int(pic.layout != PixelLayout.I444)
    has_chroma = pic.layout != PixelLayout.I400
    w, h = pic.width, pic.height
    is_id = int(pic.seq_hdr.mtrx == 0)

    c = _fg_cdata(data)
    gauss = np.ascontiguousarray(tables.gaussian_sequence, dtype=np.int16)
    lut_y = np.zeros((GRAIN_HEIGHT + 1) * GRAIN_WIDTH, dtype=np.int32)
    _nlib.dtpu_fg_gen_y(ctypes.byref(c), gauss.ctypes.data, bitdepth,
                        lut_y.ctypes.data)
    sc_y = np.zeros(1 << bitdepth, dtype=np.int32)
    if data.num_y_points or data.chroma_scaling_from_luma:
        pts = np.asarray(data.y_points, dtype=np.uint8).reshape(-1)
        _nlib.dtpu_fg_scaling(bitdepth,
                              pts.ctypes.data if pts.size else None,
                              data.num_y_points, sc_y.ctypes.data)

    luma = pic.planes[0]
    applied = False
    if has_chroma:
        for uv in range(2):
            csfl = data.chroma_scaling_from_luma
            if not (data.num_uv_points[uv] or csfl):
                continue
            lut_uv = np.zeros((GRAIN_HEIGHT + 1) * GRAIN_WIDTH,
                              dtype=np.int32)
            _nlib.dtpu_fg_gen_uv(ctypes.byref(c), gauss.ctypes.data,
                                 lut_y.ctypes.data, uv, ss_x, ss_y,
                                 bitdepth, lut_uv.ctypes.data)
            if csfl:
                sc = sc_y
            else:
                sc = np.zeros(1 << bitdepth, dtype=np.int32)
                pts = np.asarray(data.uv_points[uv],
                                 dtype=np.uint8).reshape(-1)
                _nlib.dtpu_fg_scaling(
                    bitdepth, pts.ctypes.data if pts.size else None,
                    data.num_uv_points[uv], sc.ctypes.data)
            plane = pic.planes[1 + uv]
            ok = _nlib.dtpu_fg_apply_plane(
                plane.ctypes.data, plane.shape[1],
                luma.ctypes.data, luma.shape[1], w,
                1 + uv, (w + ss_x) >> ss_x, (h + ss_y) >> ss_y,
                ss_x, ss_y, lut_uv.ctypes.data, sc.ctypes.data,
                ctypes.byref(c), bitdepth, is_id)
            if not ok:
                if applied:
                    # some planes already grained in place — a silent
                    # Python fallback would re-grain them
                    raise MemoryError("film grain scratch allocation")
                return False
            applied = True
    if data.num_y_points:
        if not _nlib.dtpu_fg_apply_plane(
                luma.ctypes.data, luma.shape[1], None, 0, w,
                0, w, h, 0, 0, lut_y.ctypes.data, sc_y.ctypes.data,
                ctypes.byref(c), bitdepth, is_id):
            if applied:
                raise MemoryError("film grain scratch allocation")
            return False
    return True


def apply_grain(pic) -> None:
    """Apply film grain to an output Picture in place (planes must already
    be writable copies). Reference dav1d_apply_grain
    (src/fg_apply_tmpl.c:225-241)."""
    hdr = pic.frame_hdr
    data = hdr.film_grain.data
    bitdepth = pic.bitdepth
    bdm8 = bitdepth - 8
    grain_ctr = 128 << bdm8
    gmin, gmax = -grain_ctr, grain_ctr - 1
    ss_y = int(pic.layout == PixelLayout.I420)
    ss_x = int(pic.layout != PixelLayout.I444)
    has_chroma = pic.layout != PixelLayout.I400
    w, h = pic.width, pic.height
    is_id = int(pic.seq_hdr.mtrx == 0)  # MC_IDENTITY

    if _apply_grain_native(pic):
        return

    lut_y = generate_grain_y(data, bitdepth)
    luts = [lut_y, None, None]
    if has_chroma:
        for uv in range(2):
            if data.num_uv_points[uv] or data.chroma_scaling_from_luma:
                luts[1 + uv] = generate_grain_uv(data, lut_y, uv, ss_x, ss_y,
                                                 bitdepth)
    scaling = [None, None, None]
    if data.num_y_points or data.chroma_scaling_from_luma:
        scaling[0] = generate_scaling(bitdepth, data.y_points,
                                      data.num_y_points)
    for uv in range(2):
        if has_chroma and data.num_uv_points[uv]:
            scaling[1 + uv] = generate_scaling(bitdepth, data.uv_points[uv],
                                               data.num_uv_points[uv])

    if data.clip_to_restricted_range:
        min_v = 16 << bdm8
        max_v_y = 235 << bdm8
        max_v_uv = (235 if is_id else 240) << bdm8
    else:
        min_v = 0
        max_v_y = max_v_uv = (1 << bitdepth) - 1

    luma_src = pic.planes[0].copy()  # grain-free luma for chroma scaling
    # extend padding pixel for odd widths (reference apply_grain_row)
    if has_chroma and (w & ss_x):
        luma_src = np.pad(luma_src, ((0, 0), (0, 1)), mode="edge")

    def _apply(pl, y0, src, idx, grain, sc, maxv):
        """Apply one 32-row stripe."""
        noise = _round2_arr(sc[idx] * grain, data.scaling_shift)
        out = np.clip(src + noise, min_v, maxv)
        if pl == 0:
            pic.planes[0][y0 : y0 + src.shape[0], :w] = out
        else:
            pic.planes[pl][y0 : y0 + src.shape[0], : src.shape[1]] = out

    n_rows = (h + FG_BLOCK_SIZE - 1) // FG_BLOCK_SIZE
    for row in range(n_rows):
        y0 = row * FG_BLOCK_SIZE
        bh = min(h - y0, FG_BLOCK_SIZE)
        if data.num_y_points:
            src = luma_src[y0 : y0 + bh, :w].astype(np.int64)
            grain = _grain_blocks(data, lut_y, row, w, bh, 0, 0, gmin, gmax)
            _apply(0, y0, src, src, grain, scaling[0], max_v_y)
        if not has_chroma or (not data.num_uv_points[0]
                              and not data.num_uv_points[1]
                              and not data.chroma_scaling_from_luma):
            continue
        cbh = (bh + ss_y) >> ss_y
        cw = (w + ss_x) >> ss_x
        cy0 = y0 >> ss_y
        # luma average at chroma resolution
        ly = luma_src[y0 : y0 + (cbh << ss_y) : 1 << ss_y]
        if ss_x:
            avg = (ly[:, 0 : cw * 2 : 2].astype(np.int64)
                   + ly[:, 1 : cw * 2 : 2] + 1) >> 1
        else:
            avg = ly[:, :cw].astype(np.int64)
        for pl in range(2):
            if data.chroma_scaling_from_luma:
                sc = scaling[0]
            elif data.num_uv_points[pl]:
                sc = scaling[1 + pl]
            else:
                continue
            src = pic.planes[1 + pl][cy0 : cy0 + cbh, :cw].astype(np.int64)
            if data.chroma_scaling_from_luma:
                val = avg[:cbh]
            else:
                combined = avg[:cbh] * data.uv_luma_mult[pl] \
                    + src * data.uv_mult[pl]
                val = np.clip((combined >> 6)
                              + data.uv_offset[pl] * (1 << bdm8), 0,
                              (1 << bitdepth) - 1)
            grain = _grain_blocks(data, luts[1 + pl], row, cw, cbh,
                                  ss_x, ss_y, gmin, gmax)
            _apply(1 + pl, cy0, src, val, grain, sc, max_v_uv)
