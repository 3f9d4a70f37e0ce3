"""Intra prediction kernels + edge preparation (exact integer semantics).

Behavioral parity with the reference DSP family (reference
src/ipred_tmpl.c:40-744, src/ipred_prepare_tmpl.c:28-204; AV1 spec 7.11.2).
Kernels operate on an `edge` buffer laid out like the reference's: a single
vector with the top-left pixel at index [ofs], top row at [ofs+1..] and left
column at [ofs-1, ofs-2, ...] (so left[i] = edge[ofs-1-i]).
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..levels import IntraPredMode as M

ANGLE_USE_EDGE_FILTER_FLAG = 1024
ANGLE_SMOOTH_EDGE_FLAG = 512

# mode -> base angle (VERT..VERT_LEFT); reference ipred_prepare_tmpl.c:46
MODE_TO_ANGLE = [90, 180, 45, 135, 113, 157, 203, 67]

# per implementation mode: needs_left, top, topleft, topright, bottomleft
EDGE_NEEDS = {
    int(M.DC_PRED): (1, 1, 0, 0, 0),
    int(M.VERT_PRED): (0, 1, 0, 0, 0),
    int(M.HOR_PRED): (1, 0, 0, 0, 0),
    int(M.LEFT_DC_PRED): (1, 0, 0, 0, 0),
    int(M.TOP_DC_PRED): (0, 1, 0, 0, 0),
    int(M.DC_128_PRED): (0, 0, 0, 0, 0),
    int(M.Z1_PRED): (0, 1, 1, 1, 0),
    int(M.Z2_PRED): (1, 1, 1, 0, 0),
    int(M.Z3_PRED): (1, 0, 1, 0, 1),
    int(M.SMOOTH_PRED): (1, 1, 0, 0, 0),
    int(M.SMOOTH_V_PRED): (1, 1, 0, 0, 0),
    int(M.SMOOTH_H_PRED): (1, 1, 0, 0, 0),
    int(M.PAETH_PRED): (1, 1, 1, 0, 0),
    int(M.FILTER_PRED): (1, 1, 1, 0, 0),
}

EDGE_I444_TOP_HAS_RIGHT = 1 << 0
EDGE_I444_LEFT_HAS_BOTTOM = 1 << 3


def prepare_intra_edges(x, have_left, y, have_top, w, h, edge_flags,
                        dst, dst_y, dst_x, top_sb_edge, top_sb_x,
                        mode, angle, tw, th, filter_edge_enabled, bitdepth):
    """Build the 257-entry edge vector; returns (impl_mode, angle, edge, ofs).

    dst: the current plane (2-D numpy), (dst_y, dst_x) the block's top-left
    pixel position.  top_sb_edge: optional 1-D saved pre-filter row covering
    the superblock row above (indexed from tile x=0 via top_sb_x).
    Mirrors reference dav1d_prepare_intra_edges (ipred_prepare_tmpl.c:76).
    """
    sz_max = 64 * 2
    edge = np.zeros(sz_max * 2 + 1, dtype=np.int32)
    ofs = sz_max

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
                [M.LEFT_DC_PRED, M.DC_PRED]][int(bool(have_left))][int(bool(have_top))]
    elif mode == M.PAETH_PRED:
        mode = [[M.DC_128_PRED, M.VERT_PRED],
                [M.HOR_PRED, M.PAETH_PRED]][int(bool(have_left))][int(bool(have_top))]

    needs_left, needs_top, needs_topleft, needs_topright, needs_bottomleft = \
        EDGE_NEEDS[int(mode)]

    def top_row(px_x, n):
        """n pixels of the row above dst_y starting at pixel px_x."""
        if top_sb_edge is not None:
            return top_sb_edge[px_x - top_sb_x : px_x - top_sb_x + n]
        return dst[dst_y - 1, px_x : px_x + n]

    half = (1 << bitdepth) >> 1

    if needs_left:
        sz = th << 2
        if have_left:
            px_have = min(sz, (h - y) << 2)
            col = dst[dst_y : dst_y + px_have, dst_x - 1]
            edge[ofs - px_have : ofs] = col[::-1]
            if px_have < sz:
                edge[ofs - sz : ofs - px_have] = edge[ofs - px_have]
        else:
            fill = int(top_row(dst_x, 1)[0]) if have_top else half + 1
            edge[ofs - sz : ofs] = fill
        if needs_bottomleft:
            have_bl = (0 if (not have_left or y + th >= h)
                       else (edge_flags & EDGE_I444_LEFT_HAS_BOTTOM))
            if have_bl:
                px_have = min(sz, (h - y - th) << 2)
                col = dst[dst_y + sz : dst_y + sz + px_have, dst_x - 1]
                edge[ofs - sz - px_have : ofs - sz] = col[::-1]
                if px_have < sz:
                    edge[ofs - 2 * sz : ofs - sz - px_have] = \
                        edge[ofs - sz - px_have]
            else:
                edge[ofs - 2 * sz : ofs - sz] = edge[ofs - sz]

    if needs_top:
        sz = tw << 2
        if have_top:
            px_have = min(sz, (w - x) << 2)
            edge[ofs + 1 : ofs + 1 + px_have] = top_row(dst_x, px_have)
            if px_have < sz:
                edge[ofs + 1 + px_have : ofs + 1 + sz] = edge[ofs + px_have]
        else:
            fill = int(dst[dst_y, dst_x - 1]) if have_left else half - 1
            edge[ofs + 1 : ofs + 1 + sz] = fill
        if needs_topright:
            have_tr = (0 if (not have_top or x + tw >= w)
                       else (edge_flags & EDGE_I444_TOP_HAS_RIGHT))
            if have_tr:
                px_have = min(sz, (w - x - tw) << 2)
                edge[ofs + 1 + sz : ofs + 1 + sz + px_have] = \
                    top_row(dst_x + sz, px_have)
                if px_have < sz:
                    edge[ofs + 1 + sz + px_have : ofs + 1 + 2 * sz] = \
                        edge[ofs + sz + px_have]
            else:
                edge[ofs + 1 + sz : ofs + 1 + 2 * sz] = edge[ofs + sz]

    if needs_topleft:
        if have_left:
            edge[ofs] = int(top_row(dst_x - 1, 1)[0]) if have_top \
                else int(dst[dst_y, dst_x - 1])
        else:
            edge[ofs] = int(top_row(dst_x, 1)[0]) if have_top else half
        if mode == M.Z2_PRED and tw + th >= 6 and filter_edge_enabled:
            edge[ofs] = ((int(edge[ofs - 1]) + int(edge[ofs + 1])) * 5
                         + int(edge[ofs]) * 6 + 8) >> 4

    return int(mode), angle, edge, ofs


# --- kernels -----------------------------------------------------------------
# all take (edge, ofs, width, height, angle_flags, max_w, max_h, bitdepth)
# and return an (h, w) int32 block.

def splat(value, width, height):
    return np.full((height, width), value, dtype=np.int32)


def dc_gen_top(edge, ofs, width):
    return (int(edge[ofs + 1 : ofs + 1 + width].sum()) + (width >> 1)) >> \
        (width.bit_length() - 1)


def dc_gen_left(edge, ofs, height):
    return (int(edge[ofs - height : ofs].sum()) + (height >> 1)) >> \
        (height.bit_length() - 1)


def dc_gen(edge, ofs, width, height, bitdepth=8):
    dc = (width + height) >> 1
    dc += int(edge[ofs + 1 : ofs + 1 + width].sum())
    dc += int(edge[ofs - height : ofs].sum())
    dc >>= ((width + height) & -(width + height)).bit_length() - 1  # ctz
    if width != height:
        # reference ipred_tmpl.c:142-155 (bitdepth-specific multipliers)
        if width > height * 2 or height > width * 2:
            m8, m16 = 0x3334, 0x6667
        else:
            m8, m16 = 0x5556, 0xAAAB
        return (dc * m8) >> 16 if bitdepth == 8 else (dc * m16) >> 17
    return dc


_IPRED_TABLES = None


def ipred(mode, edge, ofs, width, height, angle, max_w, max_h, bitdepth,
          out_ptr=None, out_stride=0):
    """Dispatch like the reference fn table dsp->ipred.intra_pred[m].
    Uses the native C port (dav1d_tpu/native/filters.c dtpu_ipred,
    bit-identical) when available; numpy golden model otherwise.

    With out_ptr/out_stride the native kernel writes straight into the
    caller's int32 canvas and returns None; callers must handle the
    fallback still returning an array."""
    from ..native import lib as _nlib
    if _nlib is not None and edge.dtype == np.int32 \
            and edge.flags.c_contiguous:
        global _IPRED_TABLES
        if _IPRED_TABLES is None:
            _IPRED_TABLES = (
                np.ascontiguousarray(tables.sm_weights, dtype=np.uint8),
                np.ascontiguousarray(tables.dr_intra_derivative,
                                     dtype=np.uint16),
                np.ascontiguousarray(tables.filter_intra_taps,
                                     dtype=np.int8))
        smw, drd, fit = _IPRED_TABLES
        if out_ptr is None:
            out = np.empty((height, width), dtype=np.int32)
            dst, dstride = out.ctypes.data, width
        else:
            out, dst, dstride = None, out_ptr, out_stride
        _nlib.dtpu_ipred(int(mode), edge.ctypes.data, int(ofs),
                         int(width), int(height), int(angle),
                         int(max_w), int(max_h), int(bitdepth),
                         smw.ctypes.data, drd.ctypes.data, fit.ctypes.data,
                         dst, dstride)
        return out
    return ipred_np(mode, edge, ofs, width, height, angle, max_w, max_h,
                    bitdepth)


def ipred_np(mode, edge, ofs, width, height, angle, max_w, max_h, bitdepth):
    """Golden numpy model (see ipred for the native dispatch)."""
    half = (1 << bitdepth) >> 1
    maxp = (1 << bitdepth) - 1
    top = edge[ofs + 1 : ofs + 1 + width].astype(np.int64)
    left_col = edge[ofs - height : ofs][::-1].astype(np.int64)  # left[i]

    if mode == M.DC_PRED:
        return splat(dc_gen(edge, ofs, width, height, bitdepth),
                     width, height)
    if mode == M.TOP_DC_PRED:
        return splat(dc_gen_top(edge, ofs, width), width, height)
    if mode == M.LEFT_DC_PRED:
        return splat(dc_gen_left(edge, ofs, height), width, height)
    if mode == M.DC_128_PRED:
        return splat(half, width, height)
    if mode == M.VERT_PRED:
        return np.tile(top.astype(np.int32), (height, 1))
    if mode == M.HOR_PRED:
        return np.tile(left_col.astype(np.int32)[:, None], (1, width))
    if mode == M.PAETH_PRED:
        topleft = int(edge[ofs])
        l = left_col[:, None]
        t = top[None, :]
        base = l + t - topleft
        ldiff = np.abs(l - base)
        tdiff = np.abs(t - base)
        tldiff = np.abs(topleft - base)
        out = np.where((ldiff <= tdiff) & (ldiff <= tldiff), l,
                       np.where(tdiff <= tldiff, t, topleft))
        return out.astype(np.int32)
    if mode == M.SMOOTH_PRED:
        w_hor = tables.sm_weights[width : 2 * width].astype(np.int64)
        w_ver = tables.sm_weights[height : 2 * height].astype(np.int64)
        right = int(edge[ofs + width])
        bottom = int(edge[ofs - height])
        pred = (w_ver[:, None] * top[None, :]
                + (256 - w_ver[:, None]) * bottom
                + w_hor[None, :] * left_col[:, None]
                + (256 - w_hor[None, :]) * right)
        return ((pred + 256) >> 9).astype(np.int32)
    if mode == M.SMOOTH_V_PRED:
        w_ver = tables.sm_weights[height : 2 * height].astype(np.int64)
        bottom = int(edge[ofs - height])
        pred = w_ver[:, None] * top[None, :] + (256 - w_ver[:, None]) * bottom
        return ((pred + 128) >> 8).astype(np.int32)
    if mode == M.SMOOTH_H_PRED:
        w_hor = tables.sm_weights[width : 2 * width].astype(np.int64)
        right = int(edge[ofs + width])
        pred = (w_hor[None, :] * left_col[:, None]
                + (256 - w_hor[None, :]) * right)
        return ((pred + 128) >> 8).astype(np.int32)
    if mode == M.Z1_PRED:
        return _z1(edge, ofs, width, height, angle, bitdepth)
    if mode == M.Z2_PRED:
        return _z2(edge, ofs, width, height, angle, max_w, max_h, bitdepth)
    if mode == M.Z3_PRED:
        return _z3(edge, ofs, width, height, angle, bitdepth)
    if mode == M.FILTER_PRED:
        return _filter(edge, ofs, width, height, angle, bitdepth)
    raise NotImplementedError(f"ipred mode {mode}")


def get_filter_strength(wh, angle, is_sm):
    if is_sm:
        if wh <= 8:
            if angle >= 64:
                return 2
            if angle >= 40:
                return 1
        elif wh <= 16:
            if angle >= 48:
                return 2
            if angle >= 20:
                return 1
        elif wh <= 24:
            if angle >= 4:
                return 3
        else:
            return 3
    else:
        if wh <= 8:
            if angle >= 56:
                return 1
        elif wh <= 16:
            if angle >= 40:
                return 1
        elif wh <= 24:
            if angle >= 32:
                return 3
            if angle >= 16:
                return 2
            if angle >= 8:
                return 1
        elif wh <= 32:
            if angle >= 32:
                return 3
            if angle >= 4:
                return 2
            return 1
        else:
            return 3
    return 0


_EDGE_KERNELS = np.array([[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]],
                         dtype=np.int64)


def filter_edge_vec(sz, lim_from, lim_to, inp, base, frm, to, strength):
    """reference filter_edge (ipred_tmpl.c:362). Index i reads
    inp[base + clip(i, frm, to-1)] so negative logical indices (the
    topleft at -1) resolve correctly."""
    out = np.zeros(sz, dtype=np.int64)
    k = _EDGE_KERNELS[strength - 1]
    clipped = lambda i: int(inp[base + max(frm, min(i, to - 1))])
    for i in range(sz):
        if i < min(sz, lim_from) or i >= min(lim_to, sz):
            out[i] = clipped(i)
        else:
            s = sum(clipped(i - 2 + j) * int(k[j]) for j in range(5))
            out[i] = (s + 8) >> 4
    return out


def get_upsample(wh, angle, is_sm):
    return int(angle < 40 and wh <= (16 >> is_sm))


def upsample_edge(hsz, inp, base, frm, to, bitdepth):
    """reference upsample_edge (ipred_tmpl.c:391)."""
    out = np.zeros(hsz * 2 - 1 + 1, dtype=np.int64)
    maxp = (1 << bitdepth) - 1
    clipped = lambda i: int(inp[base + max(frm, min(i, to - 1))])
    for i in range(hsz - 1):
        out[i * 2] = clipped(i)
        s = (-clipped(i - 1) + 9 * clipped(i) + 9 * clipped(i + 1)
             - clipped(i + 2))
        out[i * 2 + 1] = np.clip((s + 8) >> 4, 0, maxp)
    out[(hsz - 1) * 2] = clipped(hsz - 1)
    return out[: hsz * 2 - 1]


def _z1(edge, ofs, width, height, angle_in, bitdepth):
    is_sm = (angle_in >> 9) & 1
    en_filter = angle_in >> 10
    angle = angle_in & 511
    dx = int(tables.dr_intra_derivative[angle >> 1])
    top_in = edge[ofs : ofs + 1 + width + height].astype(np.int64)  # [0]=tl
    upsample_above = get_upsample(width + height, 90 - angle, is_sm) \
        if en_filter else 0
    if upsample_above:
        top = upsample_edge(width + height, top_in, 1, -1,
                            width + min(width, height), bitdepth)
        max_base_x = 2 * (width + height) - 2
        dx <<= 1
    else:
        strength = get_filter_strength(width + height, 90 - angle, is_sm) \
            if en_filter else 0
        if strength:
            top = filter_edge_vec(width + height, 0, width + height,
                                  top_in, 1, -1,
                                  width + min(width, height), strength)
            max_base_x = width + height - 1
        else:
            top = top_in[1:]
            max_base_x = width + min(width, height) - 1
    base_inc = 1 + upsample_above
    out = np.zeros((height, width), dtype=np.int32)
    for y in range(height):
        xpos = dx * (y + 1)
        frac = xpos & 0x3E
        for x in range(width):
            base = (xpos >> 6) + base_inc * x
            if base < max_base_x:
                v = int(top[base]) * (64 - frac) + int(top[base + 1]) * frac
                out[y, x] = (v + 32) >> 6
            else:
                out[y, x:] = top[max_base_x]
                break
    return out


def _z2(edge, ofs, width, height, angle_in, max_w, max_h, bitdepth):
    is_sm = (angle_in >> 9) & 1
    en_filter = angle_in >> 10
    angle = angle_in & 511
    dy = int(tables.dr_intra_derivative[(angle - 90) >> 1])
    dx = int(tables.dr_intra_derivative[(180 - angle) >> 1])
    upsample_left = get_upsample(width + height, 180 - angle, is_sm) \
        if en_filter else 0
    upsample_above = get_upsample(width + height, angle - 90, is_sm) \
        if en_filter else 0
    buf = np.zeros(64 + 64 + 1, dtype=np.int64)
    tl = 64  # index of topleft within buf

    top_in = edge[ofs : ofs + width + 1].astype(np.int64)  # [0] = topleft
    left_in = edge[ofs - height : ofs + 1].astype(np.int64)  # [height]=tl

    if upsample_above:
        up = upsample_edge(width + 1, top_in, 0, 0, width + 1, bitdepth)
        buf[tl : tl + len(up)] = up
        dx <<= 1
    else:
        strength = get_filter_strength(width + height, angle - 90, is_sm) \
            if en_filter else 0
        if strength:
            buf[tl + 1 : tl + 1 + width] = filter_edge_vec(
                width, 0, max_w, top_in, 1, -1, width, strength)
        else:
            buf[tl + 1 : tl + 1 + width] = top_in[1:]
    if upsample_left:
        up = upsample_edge(height + 1, left_in, 0, 0, height + 1, bitdepth)
        buf[tl - height * 2 : tl - height * 2 + len(up)] = up
        dy <<= 1
    else:
        strength = get_filter_strength(width + height, 180 - angle, is_sm) \
            if en_filter else 0
        if strength:
            buf[tl - height : tl] = filter_edge_vec(
                height, height - max_h, height, left_in, 0, 0, height + 1,
                strength)
        else:
            buf[tl - height : tl] = left_in[:height]
    buf[tl] = edge[ofs]

    base_inc_x = 1 + upsample_above
    left_base = tl - (1 + upsample_left)
    out = np.zeros((height, width), dtype=np.int32)
    for y in range(height):
        xpos = ((1 + upsample_above) << 6) - dx * (y + 1)
        base_x0 = xpos >> 6
        frac_x = xpos & 0x3E
        ypos = (y << (6 + upsample_left)) - dy
        for x in range(width):
            base_x = base_x0 + base_inc_x * x
            if base_x >= 0:
                v = int(buf[tl + base_x]) * (64 - frac_x) + \
                    int(buf[tl + base_x + 1]) * frac_x
            else:
                base_y = ypos >> 6
                frac_y = ypos & 0x3E
                v = int(buf[left_base - base_y]) * (64 - frac_y) + \
                    int(buf[left_base - (base_y + 1)]) * frac_y
            out[y, x] = (v + 32) >> 6
            ypos -= dy
    return out


def _z3(edge, ofs, width, height, angle_in, bitdepth):
    is_sm = (angle_in >> 9) & 1
    en_filter = angle_in >> 10
    angle = angle_in & 511
    dy = int(tables.dr_intra_derivative[(270 - angle) >> 1])
    upsample_left = get_upsample(width + height, angle - 180, is_sm) \
        if en_filter else 0
    # input: topleft_in[-(width+height)..0]; left[i] below indexes downward
    lo = edge[ofs - (width + height) : ofs + 1].astype(np.int64)
    # lo[k] = topleft_in[k - (width+height)]
    n = width + height
    if upsample_left:
        up = upsample_edge(width + height, lo, 0,
                           max(width - height, 0), width + height + 1,
                           bitdepth)
        # left = &left_out[2*(w+h)-2] i.e. topmost; left[-i] = up[len-1-i]
        left_vec = up
        left_top = 2 * (width + height) - 2
        max_base_y = 2 * (width + height) - 2
        dy <<= 1
    else:
        strength = get_filter_strength(width + height, angle - 180, is_sm) \
            if en_filter else 0
        if strength:
            left_vec = filter_edge_vec(width + height, 0, width + height,
                                       lo, 0, max(width - height, 0),
                                       width + height + 1, strength)
            left_top = width + height - 1
            max_base_y = width + height - 1
        else:
            # left = &topleft_in[-1]; left[-base] = edge[ofs-1-base]
            left_vec = lo
            left_top = n - 1  # lo[n-1] = topleft_in[-1]
            max_base_y = height + min(width, height) - 1
    base_inc = 1 + upsample_left
    out = np.zeros((height, width), dtype=np.int32)
    for x in range(width):
        ypos = dy * (x + 1)
        frac = ypos & 0x3E
        y = 0
        base = ypos >> 6
        while y < height:
            if base < max_base_y:
                v = int(left_vec[left_top - base]) * (64 - frac) + \
                    int(left_vec[left_top - (base + 1)]) * frac
                out[y, x] = (v + 32) >> 6
            else:
                out[y:, x] = left_vec[left_top - max_base_y]
                break
            y += 1
            base += base_inc
    return out


def _filter(edge, ofs, width, height, filt_idx, bitdepth):
    """FILTER_PRED (reference ipred_tmpl.c:639-700); up to 32x32."""
    filt_idx &= 511
    flt = tables.filter_intra_taps[filt_idx].astype(np.int64)  # (64,)
    maxp = (1 << bitdepth) - 1
    # working canvas with edge pixels placed around the block
    canvas = np.zeros((height + 1, width + 1), dtype=np.int64)
    canvas[0, 0] = edge[ofs]
    canvas[0, 1:] = edge[ofs + 1 : ofs + 1 + width]
    canvas[1:, 0] = edge[ofs - height : ofs][::-1][:height]
    for y in range(0, height, 2):
        for x in range(0, width, 4):
            p0 = int(canvas[y, x])
            p1, p2, p3, p4 = (int(canvas[y, x + 1 + i]) for i in range(4))
            p5 = int(canvas[y + 1, x])
            p6 = int(canvas[y + 2, x])
            for yy in range(2):
                for xx in range(4):
                    fi = xx + yy * 4  # column in the 7x8 tap layout
                    acc = (int(flt[fi]) * p0 + int(flt[fi + 8]) * p1
                           + int(flt[fi + 16]) * p2 + int(flt[fi + 24]) * p3
                           + int(flt[fi + 32]) * p4 + int(flt[fi + 40]) * p5
                           + int(flt[fi + 48]) * p6)
                    canvas[y + 1 + yy, x + 1 + xx] = np.clip(
                        (acc + 8) >> 4, 0, maxp)
    return canvas[1:, 1:].astype(np.int32)


# --- chroma-from-luma ---------------------------------------------------------

def cfl_ac(y_plane, y0, x0, w_pad, h_pad, cw, ch, ss_hor, ss_ver):
    """Subsampled, DC-subtracted luma plane (reference cfl_ac_c,
    src/ipred_tmpl.c:658-703). Returns (ch, cw) int32."""
    ac = np.zeros((ch, cw), dtype=np.int64)
    shift = 1 + (not ss_ver) + (not ss_hor)
    for y in range(ch - 4 * h_pad):
        sy = y0 + (y << ss_ver)
        for x in range(cw - 4 * w_pad):
            sx = x0 + (x << ss_hor)
            s = int(y_plane[sy, sx])
            if ss_hor:
                s += int(y_plane[sy, sx + 1])
            if ss_ver:
                s += int(y_plane[sy + 1, sx])
                if ss_hor:
                    s += int(y_plane[sy + 1, sx + 1])
            ac[y, x] = s << shift
        ac[y, cw - 4 * w_pad : cw] = ac[y, cw - 4 * w_pad - 1]
    for y in range(ch - 4 * h_pad, ch):
        ac[y] = ac[y - 1]
    log2sz = (cw.bit_length() - 1) + (ch.bit_length() - 1)
    total = int(ac.sum()) + ((1 << log2sz) >> 1)
    total >>= log2sz
    return (ac - total).astype(np.int32)


def cfl_pred(mode, edge, ofs, width, height, ac, alpha, bitdepth):
    """CFL prediction: DC (per availability variant) + alpha*ac
    (reference cfl_pred/ipred_cfl_*_c, src/ipred_tmpl.c:72-214)."""
    half = (1 << bitdepth) >> 1
    maxp = (1 << bitdepth) - 1
    if mode == M.DC_PRED:
        dc = dc_gen(edge, ofs, width, height, bitdepth)
    elif mode == M.TOP_DC_PRED:
        dc = dc_gen_top(edge, ofs, width)
    elif mode == M.LEFT_DC_PRED:
        dc = dc_gen_left(edge, ofs, height)
    else:  # DC_128
        dc = half
    diff = alpha * ac[:height, :width].astype(np.int64)
    adj = (np.abs(diff) + 32) >> 6
    out = dc + np.sign(diff) * adj
    return np.clip(out, 0, maxp).astype(np.int32)


def pal_pred(pal, idx, w, h):
    """Palette expansion (reference pal_pred_c, src/ipred_tmpl.c:717).
    idx is the unpacked (h, w) index map (the reference packs 2 px/byte as
    a storage optimization)."""
    return np.asarray(pal)[idx[:h, :w]].astype(np.int32)
