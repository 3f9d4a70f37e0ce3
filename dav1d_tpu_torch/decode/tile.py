"""Tile-level symbol decoding: superblock tree walk and block decode.

Behavioral parity with reference src/decode.c (decode_sb :2117, decode_b
:683, setup_tile :2425, dav1d_decode_tile_sbrow :2594) for the intra path;
inter parsing lands with the MC stage.
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..headers import PixelLayout, TxfmMode
from ..intra_edge import (
    EDGE_ALL_LEFT_HAS_BOTTOM, EDGE_ALL_TOP_HAS_RIGHT, EDGE_ALL_TR_AND_BL,
)
from ..levels import (
    BlockLevel, BlockPartition as BP, BlockSize, IntraPredMode as M,
    TxfmSize, CFL_ALLOWED_MASK,
)
from ..msac import make_msac


class Av1Block:
    """Per-block mode info (reference src/levels.h:262-287)."""

    __slots__ = (
        "bl", "bs", "bp", "intra", "seg_id", "skip_mode", "skip", "uvtx",
        # intra
        "y_mode", "uv_mode", "tx", "pal_sz", "y_angle", "uv_angle",
        "cfl_alpha",
        # inter
        "mv", "wedge_idx", "mask_sign", "interintra_mode", "mv2d", "matrix",
        "comp_type", "inter_mode", "motion_mode", "drl_idx", "ref",
        "max_ytx", "filter2d", "interintra_type", "tx_split0", "tx_split1",
    )

    def __init__(self):
        for s in self.__slots__:
            setattr(self, s, 0)
        self.pal_sz = [0, 0]
        self.cfl_alpha = [0, 0]


class BlockContext:
    """Above/left neighbour context (reference src/env.h:39-57).

    Backed by ONE contiguous buffer whose layout mirrors the native
    BlockCtx struct (native/dtpu.h) so the C block-decode layer can
    address a context through a single base pointer; the attributes are
    views into it. Field order here defines the C layout."""

    FIELDS = [
        ("mode", np.uint8, 32), ("lcoef", np.uint8, 32),
        ("ccoef", np.uint8, (2, 32)), ("seg_pred", np.uint8, 32),
        ("skip", np.uint8, 32), ("skip_mode", np.uint8, 32),
        ("intra", np.uint8, 32), ("comp_type", np.uint8, 32),
        ("ref", np.int8, (2, 32)), ("filter", np.uint8, (2, 32)),
        ("tx_intra", np.int8, 32), ("tx", np.int8, 32),
        ("tx_lpf_y", np.uint8, 32), ("tx_lpf_uv", np.uint8, 32),
        ("partition", np.uint8, 16), ("uvmode", np.uint8, 32),
        ("pal_sz", np.uint8, 32),
    ]
    NBYTES = 624  # must equal sizeof(BlockCtx) in native/dtpu.h

    # layout resolved once (per-field byte offsets/sizes)
    _LAYOUT: list | None = None

    def __init__(self):
        buf = np.zeros(self.NBYTES, dtype=np.uint8)
        self.buf = buf
        layout = BlockContext._LAYOUT
        if layout is None:
            layout = []
            off = 0
            for name, dt, shape in self.FIELDS:
                n = int(np.prod(shape))
                layout.append((name, dt, shape, off, n))
                off += n
            assert off == self.NBYTES
            BlockContext._LAYOUT = layout
        for name, dt, shape, off, n in layout:
            setattr(self, name, buf[off : off + n].view(dt).reshape(shape))

    def reset(self, keyframe: bool, pass_: int = 0) -> None:
        """reference reset_context (src/decode.c:2390)."""
        self.intra.fill(keyframe)
        self.uvmode.fill(M.DC_PRED)
        if keyframe:
            self.mode.fill(M.DC_PRED)
        if pass_ == 2:
            return
        self.partition.fill(0)
        self.skip.fill(0)
        self.skip_mode.fill(0)
        self.tx_lpf_y.fill(2)
        self.tx_lpf_uv.fill(1)
        self.tx_intra.fill(-1)
        self.tx.fill(TxfmSize.TX_64X64)
        if not keyframe:
            self.ref.fill(-1)
            self.comp_type.fill(0)
            self.mode.fill(0)  # NEARESTMV
        self.lcoef.fill(0x40)
        self.ccoef.fill(0x40)
        self.filter.fill(3)  # N_SWITCHABLE_FILTERS
        self.seg_pred.fill(0)
        self.pal_sz.fill(0)


class TileState:
    """reference Dav1dTileState (src/internal.h:354-387)."""

    def __init__(self, f, data, start, end, tile_row, tile_col):
        hdr = f.frame_hdr
        self.cdf = f.in_cdf.copy()
        self.last_qidx = hdr.quant.yac
        self.last_delta_lf = [0, 0, 0, 0]
        self.msac = make_msac(
            data, start, end,
            disable_cdf_update=bool(hdr.disable_cdf_update))
        self.tiling_row = tile_row
        self.tiling_col = tile_col
        sb_shift = f.sb_shift
        self.col_start = hdr.tiling.col_start_sb[tile_col] << sb_shift
        self.col_end = min(hdr.tiling.col_start_sb[tile_col + 1] << sb_shift,
                           f.bw)
        self.row_start = hdr.tiling.row_start_sb[tile_row] << sb_shift
        self.row_end = min(hdr.tiling.row_start_sb[tile_row + 1] << sb_shift,
                           f.bh)
        self.dq = f.dq  # current dequant table (per seg, plane, dc/ac)
        self.dqmem = None
        self.lflvl = f.lf_lvl  # per-seg deblock levels (delta-lf overrides)
        self.lr_ref = [dict(filter_v=[3, -7, 15], filter_h=[3, -7, 15],
                            sgr_weights=[-32, 31]) for _ in range(3)]


class TaskContext:
    """Per-worker decode state (subset of reference Dav1dTaskContext)."""

    def __init__(self, f):
        self.f = f
        self.ts: TileState | None = None
        self.bx = 0
        self.by = 0
        self.a: BlockContext | None = None  # above ctx (slice of f.a list)
        self.l = BlockContext()
        self.cur_sb_cdef_idx = None  # list of 4 ints view
        self.frame_thread_pass = 0
        self.tl_4x4_filter = 0
        self.txtp_map = np.zeros((32, 32), dtype=np.uint8)
        self.warpmv = None
        self.rt = None
        self.cf = np.zeros(32 * 32, dtype=np.int32)
        # palette state (reference Dav1dTaskContext al_pal/pal_sz_uv/scratch)
        self.al_pal = np.zeros((2, 32, 3, 8), dtype=np.uint16)
        self.pal_sz_uv = np.zeros((2, 32), dtype=np.uint8)
        self.scratch_pal = np.zeros((3, 8), dtype=np.uint16)
        self.pal_idx_y = None  # unpacked (bh4*4, bw4*4) index map
        self.pal_idx_uv = None
        # two-pass pipeline: 0 = fused, 1 = capture (no pixels),
        # 2 = replay (pixels from captured coefs)
        self.pass_ = 0
        self.cur_rec = None
        self.rec_coef_pos = 0


def get_partition_ctx(a, l, bl, yb8, xb8):
    return ((a.partition[xb8] >> (4 - bl)) & 1) + \
        (((l.partition[yb8] >> (4 - bl)) & 1) << 1)


def gather_left_partition_prob(cdf, bl):
    out = int(cdf[BP.H - 1]) - int(cdf[BP.H])
    out += int(cdf[BP.SPLIT - 1]) - int(cdf[BP.T_LEFT_SPLIT])
    if bl != BlockLevel.BL_128X128:
        out += int(cdf[BP.H4 - 1]) - int(cdf[BP.H4])
    return out


def gather_top_partition_prob(cdf, bl):
    out = int(cdf[BP.V - 1]) - int(cdf[BP.T_TOP_SPLIT])
    out += int(cdf[BP.T_LEFT_SPLIT - 1])
    if bl != BlockLevel.BL_128X128:
        out += int(cdf[BP.V4 - 1]) - int(cdf[BP.T_RIGHT_SPLIT])
    return out


def get_intra_ctx(a, l, yb4, xb4, have_top, have_left):
    if have_left:
        if have_top:
            ctx = int(l.intra[yb4]) + int(a.intra[xb4])
            return ctx + (ctx == 2)
        return int(l.intra[yb4]) * 2
    return int(a.intra[xb4]) * 2 if have_top else 0


def get_tx_ctx(a, l, max_tx_lw, max_tx_lh, yb4, xb4):
    return (int(l.tx_intra[yb4]) >= max_tx_lh) + \
        (int(a.tx_intra[xb4]) >= max_tx_lw)


def neg_deinterleave(diff, ref, max_):
    """reference env.h neg_deinterleave."""
    if not ref:
        return diff
    if ref >= max_ - 1:
        return max_ - diff - 1
    if 2 * ref < max_:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    else:
        if diff <= 2 * (max_ - ref - 1):
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return max_ - (diff + 1)


def get_cur_frame_segid(by, bx, have_top, have_left, cur_seg_map, b4_stride):
    """Returns (pred_seg_id, seg_ctx); reference env.h:439-460."""
    if have_left and have_top:
        l = int(cur_seg_map[by, bx - 1])
        a = int(cur_seg_map[by - 1, bx])
        al = int(cur_seg_map[by - 1, bx - 1])
        if l == a and al == l:
            seg_ctx = 2
        elif l == a or al == l or a == al:
            seg_ctx = 1
        else:
            seg_ctx = 0
        return (a if a == al else l), seg_ctx
    if have_left:
        return int(cur_seg_map[by, bx - 1]), 0
    if have_top:
        return int(cur_seg_map[by - 1, bx]), 0
    return 0, 0


def decode_sb(t: TaskContext, bl: int, node) -> None:
    """reference decode_sb (src/decode.c:2117)."""
    f = t.f
    ts = t.ts
    hsz = 16 >> bl
    have_h_split = f.bw > t.bx + hsz
    have_v_split = f.bh > t.by + hsz

    if not have_h_split and not have_v_split:
        assert bl < BlockLevel.BL_8X8
        return decode_sb(t, bl + 1, node.split[0])

    bx8 = (t.bx & 31) >> 1
    by8 = (t.by & 31) >> 1
    ctx = get_partition_ctx(t.a, t.l, bl, by8, bx8)
    pc = ts.cdf.m.partition[bl][ctx]

    if have_h_split and have_v_split:
        n_part = int(tables.partition_type_count[bl])
        bp = ts.msac.decode_symbol_adapt(pc, n_part)
        if f.layout == PixelLayout.I422 and bp in (
                BP.V, BP.V4, BP.T_LEFT_SPLIT, BP.T_RIGHT_SPLIT):
            raise ValueError("illegal vertical partition in 4:2:2")
        b = tables.block_sizes[bl][bp]

        if bp == BP.NONE:
            decode_b(t, bl, int(b[0]), bp, node.o)
        elif bp == BP.H:
            decode_b(t, bl, int(b[0]), bp, node.h[0])
            t.by += hsz
            decode_b(t, bl, int(b[0]), bp, node.h[1])
            t.by -= hsz
        elif bp == BP.V:
            decode_b(t, bl, int(b[0]), bp, node.v[0])
            t.bx += hsz
            decode_b(t, bl, int(b[0]), bp, node.v[1])
            t.bx -= hsz
        elif bp == BP.SPLIT:
            if bl == BlockLevel.BL_8X8:
                tip = node
                decode_b(t, bl, BlockSize.BS_4x4, bp, EDGE_ALL_TR_AND_BL)
                tl_filter = t.tl_4x4_filter
                t.bx += 1
                decode_b(t, bl, BlockSize.BS_4x4, bp, tip.split[0])
                t.bx -= 1
                t.by += 1
                decode_b(t, bl, BlockSize.BS_4x4, bp, tip.split[1])
                t.bx += 1
                t.tl_4x4_filter = tl_filter
                decode_b(t, bl, BlockSize.BS_4x4, bp, tip.split[2])
                t.bx -= 1
                t.by -= 1
            else:
                decode_sb(t, bl + 1, node.split[0])
                t.bx += hsz
                decode_sb(t, bl + 1, node.split[1])
                t.bx -= hsz
                t.by += hsz
                decode_sb(t, bl + 1, node.split[2])
                t.bx += hsz
                decode_sb(t, bl + 1, node.split[3])
                t.bx -= hsz
                t.by -= hsz
        elif bp == BP.T_TOP_SPLIT:
            decode_b(t, bl, int(b[0]), bp, EDGE_ALL_TR_AND_BL)
            t.bx += hsz
            decode_b(t, bl, int(b[0]), bp, node.v[1])
            t.bx -= hsz
            t.by += hsz
            decode_b(t, bl, int(b[1]), bp, node.h[1])
            t.by -= hsz
        elif bp == BP.T_BOTTOM_SPLIT:
            decode_b(t, bl, int(b[0]), bp, node.h[0])
            t.by += hsz
            decode_b(t, bl, int(b[1]), bp, node.v[0])
            t.bx += hsz
            decode_b(t, bl, int(b[1]), bp, 0)
            t.bx -= hsz
            t.by -= hsz
        elif bp == BP.T_LEFT_SPLIT:
            decode_b(t, bl, int(b[0]), bp, EDGE_ALL_TR_AND_BL)
            t.by += hsz
            decode_b(t, bl, int(b[0]), bp, node.h[1])
            t.by -= hsz
            t.bx += hsz
            decode_b(t, bl, int(b[1]), bp, node.v[1])
            t.bx -= hsz
        elif bp == BP.T_RIGHT_SPLIT:
            decode_b(t, bl, int(b[0]), bp, node.v[0])
            t.bx += hsz
            decode_b(t, bl, int(b[1]), bp, node.h[0])
            t.by += hsz
            decode_b(t, bl, int(b[1]), bp, 0)
            t.by -= hsz
            t.bx -= hsz
        elif bp == BP.H4:
            decode_b(t, bl, int(b[0]), bp, node.h[0])
            t.by += hsz >> 1
            decode_b(t, bl, int(b[0]), bp, node.h4)
            t.by += hsz >> 1
            decode_b(t, bl, int(b[0]), bp, EDGE_ALL_LEFT_HAS_BOTTOM)
            t.by += hsz >> 1
            if t.by < f.bh:
                decode_b(t, bl, int(b[0]), bp, node.h[1])
            t.by -= hsz * 3 >> 1
        elif bp == BP.V4:
            decode_b(t, bl, int(b[0]), bp, node.v[0])
            t.bx += hsz >> 1
            decode_b(t, bl, int(b[0]), bp, node.v4)
            t.bx += hsz >> 1
            decode_b(t, bl, int(b[0]), bp, EDGE_ALL_TOP_HAS_RIGHT)
            t.bx += hsz >> 1
            if t.bx < f.bw:
                decode_b(t, bl, int(b[0]), bp, node.v[1])
            t.bx -= hsz * 3 >> 1
        else:
            raise AssertionError(bp)
    elif have_h_split:
        is_split = ts.msac.decode_bool(gather_top_partition_prob(pc, bl))
        assert bl < BlockLevel.BL_8X8
        if is_split:
            bp = BP.SPLIT
            decode_sb(t, bl + 1, node.split[0])
            t.bx += hsz
            decode_sb(t, bl + 1, node.split[1])
            t.bx -= hsz
        else:
            bp = BP.H
            decode_b(t, bl, int(tables.block_sizes[bl][BP.H][0]), BP.H,
                     node.h[0])
    else:
        assert have_v_split
        is_split = ts.msac.decode_bool(gather_left_partition_prob(pc, bl))
        if f.layout == PixelLayout.I422 and not is_split:
            raise ValueError("illegal non-split in 4:2:2")
        assert bl < BlockLevel.BL_8X8
        if is_split:
            bp = BP.SPLIT
            decode_sb(t, bl + 1, node.split[0])
            t.by += hsz
            decode_sb(t, bl + 1, node.split[2])
            t.by -= hsz
        else:
            bp = BP.V
            decode_b(t, bl, int(tables.block_sizes[bl][BP.V][0]), BP.V,
                     node.v[0])

    if bp != BP.SPLIT or bl == BlockLevel.BL_8X8:
        # above/left partition ctx spans hsz 8x8 units
        t.a.partition[bx8 : bx8 + hsz] = tables.al_part_ctx[0][bl][bp]
        t.l.partition[by8 : by8 + hsz] = tables.al_part_ctx[1][bl][bp]


def decode_b(t: TaskContext, bl: int, bs: int, bp: int,
             intra_edge_flags: int) -> None:
    """reference decode_b (src/decode.c:683) — intra path."""
    f = t.f
    ts = t.ts
    hdr = f.frame_hdr
    b = Av1Block()
    b_dim = tables.block_dimensions[bs]
    bx4 = t.bx & 31
    by4 = t.by & 31
    ss_ver = int(f.layout == PixelLayout.I420)
    ss_hor = int(f.layout != PixelLayout.I444)
    cbx4 = bx4 >> ss_hor
    cby4 = by4 >> ss_ver
    bw4 = int(b_dim[0])
    bh4 = int(b_dim[1])
    w4 = min(bw4, f.bw - t.bx)
    h4 = min(bh4, f.bh - t.by)
    cbw4 = (bw4 + ss_hor) >> ss_hor
    cbh4 = (bh4 + ss_ver) >> ss_ver
    have_left = t.bx > ts.col_start
    have_top = t.by > ts.row_start
    has_chroma = (f.layout != PixelLayout.I400
                  and (bw4 > ss_hor or t.bx & 1)
                  and (bh4 > ss_ver or t.by & 1))
    frame_is_inter = hdr.frame_type.is_inter_or_switch

    b.bl = bl
    b.bp = bp
    b.bs = bs

    seg = None
    seg_pred = 0
    if hdr.segmentation.enabled:
        if not hdr.segmentation.update_map:
            if f.prev_segmap is not None:
                seg_id = _prev_segid(f, t.by, t.bx, w4, h4)
                if seg_id >= 8:
                    raise ValueError("bad prev seg id")
                b.seg_id = seg_id
            else:
                b.seg_id = 0
            seg = hdr.segmentation.seg_data.d[b.seg_id]
        elif hdr.segmentation.seg_data.preskip:
            if hdr.segmentation.temporal:
                seg_pred = ts.msac.decode_bool_adapt(
                    ts.cdf.m.seg_pred[int(t.a.seg_pred[bx4])
                                      + int(t.l.seg_pred[by4])])
            if hdr.segmentation.temporal and seg_pred:
                if f.prev_segmap is not None:
                    seg_id = _prev_segid(f, t.by, t.bx, w4, h4)
                    if seg_id >= 8:
                        raise ValueError("bad prev seg id")
                    b.seg_id = seg_id
                else:
                    b.seg_id = 0
            else:
                pred_seg_id, seg_ctx = get_cur_frame_segid(
                    t.by, t.bx, have_top, have_left, f.cur_segmap, f.b4_stride)
                diff = ts.msac.decode_symbol_adapt(
                    ts.cdf.m.seg_id[seg_ctx], 7)
                last_active = hdr.segmentation.seg_data.last_active_segid
                b.seg_id = neg_deinterleave(diff, pred_seg_id, last_active + 1)
                if b.seg_id > last_active or b.seg_id >= 8:
                    b.seg_id = 0
            seg = hdr.segmentation.seg_data.d[b.seg_id]
    else:
        b.seg_id = 0

    # skip_mode
    if ((seg is None or (not seg.globalmv and seg.ref == -1 and not seg.skip))
            and hdr.skip_mode_enabled and min(bw4, bh4) > 1):
        smctx = int(t.a.skip_mode[bx4]) + int(t.l.skip_mode[by4])
        b.skip_mode = ts.msac.decode_bool_adapt(ts.cdf.m.skip_mode[smctx])
    else:
        b.skip_mode = 0

    # skip
    if b.skip_mode or (seg is not None and seg.skip):
        b.skip = 1
    else:
        sctx = int(t.a.skip[bx4]) + int(t.l.skip[by4])
        b.skip = ts.msac.decode_bool_adapt(ts.cdf.m.skip[sctx])

    # post-skip segment id
    if (hdr.segmentation.enabled and hdr.segmentation.update_map
            and not hdr.segmentation.seg_data.preskip):
        if not b.skip and hdr.segmentation.temporal:
            seg_pred = ts.msac.decode_bool_adapt(
                ts.cdf.m.seg_pred[int(t.a.seg_pred[bx4])
                                  + int(t.l.seg_pred[by4])])
        else:
            seg_pred = 0
        if seg_pred:
            if f.prev_segmap is not None:
                seg_id = _prev_segid(f, t.by, t.bx, w4, h4)
                if seg_id >= 8:
                    raise ValueError("bad prev seg id")
                b.seg_id = seg_id
            else:
                b.seg_id = 0
        else:
            pred_seg_id, seg_ctx = get_cur_frame_segid(
                t.by, t.bx, have_top, have_left, f.cur_segmap, f.b4_stride)
            if b.skip:
                b.seg_id = pred_seg_id
            else:
                diff = ts.msac.decode_symbol_adapt(ts.cdf.m.seg_id[seg_ctx], 7)
                last_active = hdr.segmentation.seg_data.last_active_segid
                b.seg_id = neg_deinterleave(diff, pred_seg_id, last_active + 1)
                if b.seg_id > last_active:
                    b.seg_id = 0
            if b.seg_id >= 8:
                b.seg_id = 0
        seg = hdr.segmentation.seg_data.d[b.seg_id]

    # cdef index
    if not b.skip:
        idx = (((t.bx & 16) >> 4) + ((t.by & 16) >> 3)) if f.seq_hdr.sb128 else 0
        if t.cur_sb_cdef_idx[idx] == -1:
            v = ts.msac.decode_bools(hdr.cdef.n_bits)
            t.cur_sb_cdef_idx[idx] = v
            if bw4 > 16:
                t.cur_sb_cdef_idx[idx + 1] = v
            if bh4 > 16:
                t.cur_sb_cdef_idx[idx + 2] = v
            if bw4 == 32 and bh4 == 32:
                t.cur_sb_cdef_idx[idx + 3] = v

    # delta q/lf
    if not ((t.bx | t.by) & (31 >> (not f.seq_hdr.sb128))):
        prev_qidx = ts.last_qidx
        sb_bs = BlockSize.BS_128x128 if f.seq_hdr.sb128 else BlockSize.BS_64x64
        have_delta_q = hdr.delta.q_present and (bs != sb_bs or not b.skip)
        prev_delta_lf = list(ts.last_delta_lf)
        if have_delta_q:
            delta_q = ts.msac.decode_symbol_adapt(ts.cdf.m.delta_q, 3)
            if delta_q == 3:
                n_bits = 1 + ts.msac.decode_bools(3)
                delta_q = ts.msac.decode_bools(n_bits) + 1 + (1 << n_bits)
            if delta_q:
                if ts.msac.decode_bool_equi():
                    delta_q = -delta_q
                delta_q *= 1 << hdr.delta.q_res_log2
            ts.last_qidx = max(1, min(255, ts.last_qidx + delta_q))
            if hdr.delta.lf_present:
                n_lfs = (4 if f.layout != PixelLayout.I400 else 2) \
                    if hdr.delta.lf_multi else 1
                for i in range(n_lfs):
                    delta_lf = ts.msac.decode_symbol_adapt(
                        ts.cdf.m.delta_lf[i + hdr.delta.lf_multi], 3)
                    if delta_lf == 3:
                        n_bits = 1 + ts.msac.decode_bools(3)
                        delta_lf = ts.msac.decode_bools(n_bits) + 1 + \
                            (1 << n_bits)
                    if delta_lf:
                        if ts.msac.decode_bool_equi():
                            delta_lf = -delta_lf
                        delta_lf *= 1 << hdr.delta.lf_res_log2
                    ts.last_delta_lf[i] = max(
                        -63, min(63, ts.last_delta_lf[i] + delta_lf))
        if ts.last_qidx == hdr.quant.yac:
            ts.dq = f.dq
        elif ts.last_qidx != prev_qidx:
            from .frame import init_quant_tables
            ts.dqmem = init_quant_tables(f.seq_hdr, hdr, ts.last_qidx)
            ts.dq = ts.dqmem
        if ts.last_delta_lf == [0, 0, 0, 0]:
            ts.lflvl = f.lf_lvl
        elif ts.last_delta_lf != prev_delta_lf:
            from ..recon.lf import calc_lf_values
            ts.lflvl = calc_lf_values(hdr, ts.last_delta_lf)

    # intra/inter flag
    if b.skip_mode:
        b.intra = 0
    elif frame_is_inter:
        if seg is not None and (seg.ref >= 0 or seg.globalmv):
            b.intra = int(not seg.ref)
        else:
            ictx = get_intra_ctx(t.a, t.l, by4, bx4, have_top, have_left)
            b.intra = 1 - ts.msac.decode_bool_adapt(ts.cdf.m.intra[ictx])
    elif hdr.allow_intrabc:
        b.intra = 1 - ts.msac.decode_bool_adapt(ts.cdf.m.intrabc)
    else:
        b.intra = 1

    if b.intra:
        _decode_b_intra(t, b, bl, bs, bp, intra_edge_flags, b_dim,
                        bx4, by4, cbx4, cby4, bw4, bh4, w4, h4, cbw4, cbh4,
                        have_top, have_left, has_chroma, seg, seg_pred,
                        frame_is_inter)
    elif frame_is_inter:
        _decode_b_inter(t, b, bl, bs, bp, intra_edge_flags, b_dim,
                        bx4, by4, cbx4, cby4, bw4, bh4, w4, h4, cbw4, cbh4,
                        have_top, have_left, has_chroma, seg, seg_pred)
    else:
        _decode_b_intrabc(t, b, bl, bs, bp, intra_edge_flags, b_dim,
                          bx4, by4, cbx4, cby4, bw4, bh4, w4, h4,
                          cbw4, cbh4, has_chroma, seg_pred)

    if not b.skip:
        # per-8x8 "has coefficients" mask for cdef
        # (reference src/decode.c:1946-1955)
        r0 = t.by >> 1
        f.noskip[r0 : r0 + ((bh4 + 1) >> 1), t.bx : t.bx + bw4] = True


def _decode_b_intra(t, b, bl, bs, bp, intra_edge_flags, b_dim,
                    bx4, by4, cbx4, cby4, bw4, bh4, w4, h4, cbw4, cbh4,
                    have_top, have_left, has_chroma, seg, seg_pred,
                    frame_is_inter):
    f = t.f
    ts = t.ts
    hdr = f.frame_hdr

    if frame_is_inter:
        ymode_cdf = ts.cdf.m.y_mode[int(tables.ymode_size_context[bs])]
    else:
        ymode_cdf = ts.cdf.kfym[
            int(tables.intra_mode_context[int(t.a.mode[bx4])])][
            int(tables.intra_mode_context[int(t.l.mode[by4])])]
    b.y_mode = ts.msac.decode_symbol_adapt(ymode_cdf, 12)

    # angle delta
    if int(b_dim[2]) + int(b_dim[3]) >= 2 and \
            M.VERT_PRED <= b.y_mode <= M.VERT_LEFT_PRED:
        acdf = ts.cdf.m.angle_delta[b.y_mode - M.VERT_PRED]
        angle = ts.msac.decode_symbol_adapt(acdf, 6)
        b.y_angle = angle - 3
    else:
        b.y_angle = 0

    if has_chroma:
        cfl_allowed = (cbw4 == 1 and cbh4 == 1) \
            if hdr.segmentation.lossless[b.seg_id] \
            else bool(CFL_ALLOWED_MASK & (1 << bs))
        uvmode_cdf = ts.cdf.m.uv_mode[int(cfl_allowed)][b.y_mode]
        b.uv_mode = ts.msac.decode_symbol_adapt(
            uvmode_cdf, 13 - (not cfl_allowed))
        b.uv_angle = 0
        if b.uv_mode == M.CFL_PRED:
            sign = ts.msac.decode_symbol_adapt(ts.cdf.m.cfl_sign, 7) + 1
            sign_u = sign * 0x56 >> 8
            sign_v = sign - sign_u * 3
            if sign_u:
                ctx = (sign_u == 2) * 3 + sign_v
                b.cfl_alpha[0] = ts.msac.decode_symbol_adapt(
                    ts.cdf.m.cfl_alpha[ctx], 15) + 1
                if sign_u == 1:
                    b.cfl_alpha[0] = -b.cfl_alpha[0]
            else:
                b.cfl_alpha[0] = 0
            if sign_v:
                ctx = (sign_v == 2) * 3 + sign_u
                b.cfl_alpha[1] = ts.msac.decode_symbol_adapt(
                    ts.cdf.m.cfl_alpha[ctx], 15) + 1
                if sign_v == 1:
                    b.cfl_alpha[1] = -b.cfl_alpha[1]
            else:
                b.cfl_alpha[1] = 0
        elif int(b_dim[2]) + int(b_dim[3]) >= 2 and \
                M.VERT_PRED <= b.uv_mode <= M.VERT_LEFT_PRED:
            acdf = ts.cdf.m.angle_delta[b.uv_mode - M.VERT_PRED]
            angle = ts.msac.decode_symbol_adapt(acdf, 6)
            b.uv_angle = angle - 3

    b.pal_sz = [0, 0]
    if hdr.allow_screen_content_tools and max(bw4, bh4) <= 16 and \
            bw4 + bh4 >= 4:
        sz_ctx = int(b_dim[2]) + int(b_dim[3]) - 2
        if b.y_mode == M.DC_PRED:
            pal_ctx = int(t.a.pal_sz[bx4] > 0) + int(t.l.pal_sz[by4] > 0)
            use_y_pal = ts.msac.decode_bool_adapt(
                ts.cdf.m.pal_y[sz_ctx][pal_ctx])
            if use_y_pal:
                _read_pal_plane(t, b, 0, sz_ctx, bx4, by4)
        if has_chroma and b.uv_mode == M.DC_PRED:
            pal_ctx = int(b.pal_sz[0] > 0)
            use_uv_pal = ts.msac.decode_bool_adapt(ts.cdf.m.pal_uv[pal_ctx])
            if use_uv_pal:  # aomedia bug 2183: luma coordinates
                _read_pal_uv(t, b, sz_ctx, bx4, by4)

    if b.y_mode == M.DC_PRED and not b.pal_sz[0] and \
            max(int(b_dim[2]), int(b_dim[3])) <= 3 and f.seq_hdr.filter_intra:
        is_filter = ts.msac.decode_bool_adapt(ts.cdf.m.use_filter_intra[bs])
        if is_filter:
            b.y_mode = M.FILTER_PRED
            b.y_angle = ts.msac.decode_symbol_adapt(ts.cdf.m.filter_intra, 4)

    if b.pal_sz[0]:
        t.pal_idx_y = _read_pal_indices(t, b.pal_sz[0], 0, w4, h4, bw4, bh4)
    if has_chroma and b.pal_sz[1]:
        ss_ver = int(f.layout == PixelLayout.I420)
        ss_hor = int(f.layout != PixelLayout.I444)
        cw4 = (w4 + ss_hor) >> ss_hor
        ch4 = (h4 + ss_ver) >> ss_ver
        t.pal_idx_uv = _read_pal_indices(t, b.pal_sz[1], 1, cw4, ch4,
                                         cbw4, cbh4)

    # tx size
    if hdr.segmentation.lossless[b.seg_id]:
        b.tx = b.uvtx = TxfmSize.TX_4X4
        t_dim = tables.txfm_info()[TxfmSize.TX_4X4]
    else:
        b.tx = int(tables.max_txfm_size_for_bs[bs][0])
        b.uvtx = int(tables.max_txfm_size_for_bs[bs][f.layout])
        t_dim = tables.txfm_info()[b.tx]
        if hdr.txfm_mode == TxfmMode.SWITCHABLE and int(t_dim[5]) > \
                TxfmSize.TX_4X4:
            tctx = get_tx_ctx(t.a, t.l, int(t_dim[2]), int(t_dim[3]),
                              by4, bx4)
            tx_cdf = ts.cdf.m.txsz[int(t_dim[5]) - 1][tctx]
            depth = ts.msac.decode_symbol_adapt(
                tx_cdf, min(int(t_dim[5]), 2))
            for _ in range(depth):
                b.tx = int(t_dim[6])  # sub
                t_dim = tables.txfm_info()[b.tx]

    # reconstruction (pass 0: fused)
    from ..recon.intra import recon_b_intra
    if t.pass_ == 1:
        t.cur_rec = dict(kind="intra", ts=t.ts, bx=t.bx, by=t.by, bs=bs, b=b,
                         edge_flags=intra_edge_flags, coefs=[],
                         pal=(t.scratch_pal.copy(), t.pal_idx_y,
                              t.pal_idx_uv)
                         if b.pal_sz[0] or b.pal_sz[1] else None)
        t.f.tasks.append(t.cur_rec)
    recon_b_intra(t, bs, intra_edge_flags, b)

    if hdr.loopfilter.level_y[0] or hdr.loopfilter.level_y[1]:
        from ..recon.lf import create_lf_mask_intra
        create_lf_mask_intra(
            f, f.lf_level, ts.lflvl[b.seg_id],
            t.bx, t.by, f.w4, f.h4, bs, b.tx, b.uvtx, f.layout,
            t.a.tx_lpf_y, bx4, t.l.tx_lpf_y, by4,
            t.a.tx_lpf_uv if has_chroma else None, cbx4,
            t.l.tx_lpf_uv, cby4)

    # update contexts
    y_mode_nofilt = M.DC_PRED if b.y_mode == M.FILTER_PRED else b.y_mode
    lw, lh = int(t_dim[2]), int(t_dim[3])
    t.a.tx_intra[bx4 : bx4 + bw4] = lw
    t.a.tx[bx4 : bx4 + bw4] = lw
    t.a.mode[bx4 : bx4 + bw4] = y_mode_nofilt
    t.a.pal_sz[bx4 : bx4 + bw4] = b.pal_sz[0]
    t.a.seg_pred[bx4 : bx4 + bw4] = seg_pred
    t.a.skip_mode[bx4 : bx4 + bw4] = 0
    t.a.intra[bx4 : bx4 + bw4] = 1
    t.a.skip[bx4 : bx4 + bw4] = b.skip
    t.l.tx_intra[by4 : by4 + bh4] = lh
    t.l.tx[by4 : by4 + bh4] = lh
    t.l.mode[by4 : by4 + bh4] = y_mode_nofilt
    t.l.pal_sz[by4 : by4 + bh4] = b.pal_sz[0]
    t.l.seg_pred[by4 : by4 + bh4] = seg_pred
    t.l.skip_mode[by4 : by4 + bh4] = 0
    t.l.intra[by4 : by4 + bh4] = 1
    t.l.skip[by4 : by4 + bh4] = b.skip
    # aomedia bug 2183: uv palette context uses luma coordinates
    uv_pal = b.pal_sz[1] if has_chroma else 0
    t.pal_sz_uv[0][bx4 : bx4 + bw4] = uv_pal
    t.pal_sz_uv[1][by4 : by4 + bh4] = uv_pal
    if b.pal_sz[0]:
        t.al_pal[0, bx4 : bx4 + bw4, 0] = t.scratch_pal[0]
        t.al_pal[1, by4 : by4 + bh4, 0] = t.scratch_pal[0]
    if has_chroma and b.pal_sz[1]:
        t.al_pal[0, bx4 : bx4 + bw4, 1:] = t.scratch_pal[1:]
        t.al_pal[1, by4 : by4 + bh4, 1:] = t.scratch_pal[1:]
    if frame_is_inter:
        t.a.comp_type[bx4 : bx4 + bw4] = 0
        t.a.ref[0][bx4 : bx4 + bw4] = -1
        t.a.ref[1][bx4 : bx4 + bw4] = -1
        t.a.filter[0][bx4 : bx4 + bw4] = 3
        t.a.filter[1][bx4 : bx4 + bw4] = 3
        t.l.comp_type[by4 : by4 + bh4] = 0
        t.l.ref[0][by4 : by4 + bh4] = -1
        t.l.ref[1][by4 : by4 + bh4] = -1
        t.l.filter[0][by4 : by4 + bh4] = 3
        t.l.filter[1][by4 : by4 + bh4] = 3
    if has_chroma:
        t.a.uvmode[cbx4 : cbx4 + cbw4] = b.uv_mode
        t.l.uvmode[cby4 : cby4 + cbh4] = b.uv_mode
    if frame_is_inter or hdr.allow_intrabc:
        from ..refmvs import splat_mv, INVALID_MV_Y
        splat_mv(f.rf, t.by, t.bx, bw4, bh4,
                 (INVALID_MV_Y, INVALID_MV_Y), (0, 0), 0, -1, bs, 0)
    if hdr.segmentation.enabled and hdr.segmentation.update_map:
        f.cur_segmap[t.by : t.by + bh4, t.bx : t.bx + bw4] = b.seg_id


def _decode_b_intrabc(t, b, bl, bs, bp, intra_edge_flags, b_dim,
                      bx4, by4, cbx4, cby4, bw4, bh4, w4, h4, cbw4, cbh4,
                      has_chroma, seg_pred):
    """Intra block copy decode (reference src/decode.c:1264-1378)."""
    from ..levels import (CompInterType, InterIntraType, IntraPredMode as M,
                          MotionMode)
    from ..refmvs import refmvs_find, splat_mv
    f = t.f
    ts = t.ts
    hdr = f.frame_hdr
    seq = f.seq_hdr
    ss_ver = int(f.layout == PixelLayout.I420)
    ss_hor = int(f.layout != PixelLayout.I444)

    mvstack, n_mvs, _ = refmvs_find(t.rt, (0, -1), bs, intra_edge_flags,
                                    t.by, t.bx)
    if mvstack[0]["mv"][0] != (0, 0):
        mv = mvstack[0]["mv"][0]
    elif mvstack[1]["mv"][0] != (0, 0):
        mv = mvstack[1]["mv"][0]
    elif t.by - (16 << seq.sb128) < ts.row_start:
        mv = (0, -(512 << seq.sb128) - 2048)
    else:
        mv = (-(512 << seq.sb128), 0)

    ref = mv
    mv = read_mv_residual(ts, mv, -1)

    # clip to decoded parts of the current tile
    border_left = ts.col_start * 4
    border_top = ts.row_start * 4
    if has_chroma:
        if bw4 < 2 and ss_hor:
            border_left += 4
        if bh4 < 2 and ss_ver:
            border_top += 4
    src_left = t.bx * 4 + (mv[1] >> 3)
    src_top = t.by * 4 + (mv[0] >> 3)
    src_right = src_left + bw4 * 4
    src_bottom = src_top + bh4 * 4
    border_right = ((ts.col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4

    if src_left < border_left:
        src_right += border_left - src_left
        src_left = border_left
    elif src_right > border_right:
        src_left -= src_right - border_right
        src_right = border_right
    if src_top < border_top:
        src_bottom += border_top - src_top
        src_top = border_top

    sbx = (t.bx >> (4 + seq.sb128)) << (6 + seq.sb128)
    sby_px = (t.by >> (4 + seq.sb128)) << (6 + seq.sb128)
    sb_size = 1 << (6 + seq.sb128)
    if src_bottom > sby_px and src_right > sbx:
        if src_top - border_top >= src_bottom - sby_px:
            src_top -= src_bottom - sby_px
            src_bottom = sby_px
        elif src_left - border_left >= src_right - sbx:
            src_left -= src_right - sbx
            src_right = sbx
    if src_bottom > sby_px + sb_size:
        src_top -= src_bottom - (sby_px + sb_size)
        src_bottom = sby_px + sb_size
    if src_bottom > sby_px and src_right > sbx:
        raise ValueError("intrabc mv overlaps current superblock")

    b.mv = [((src_top - t.by * 4) * 8, (src_left - t.bx * 4) * 8), None]

    b.comp_type = CompInterType.NONE
    b.motion_mode = MotionMode.TRANSLATION
    b.interintra_type = InterIntraType.NONE
    b.filter2d = 9  # FILTER_2D_BILINEAR
    b.ref = [-1, -1]
    b.inter_mode = 0
    b.drl_idx = 0

    read_vartx_tree(t, b, bs, bx4, by4)

    from ..recon.inter import recon_b_inter
    if t.pass_ == 1:
        t.cur_rec = dict(kind="intrabc", ts=t.ts, bx=t.bx, by=t.by, bs=bs, b=b,
                         coefs=[])
        t.f.tasks.append(t.cur_rec)
    recon_b_inter(t, bs, b)

    splat_mv(f.rf, t.by, t.bx, bw4, bh4, b.mv[0], (0, 0), 0, -1, bs, 0)

    t.a.tx_intra[bx4 : bx4 + bw4] = int(b_dim[2])
    t.a.mode[bx4 : bx4 + bw4] = M.DC_PRED
    t.a.pal_sz[bx4 : bx4 + bw4] = 0
    t.a.seg_pred[bx4 : bx4 + bw4] = seg_pred
    t.a.skip_mode[bx4 : bx4 + bw4] = 0
    t.a.intra[bx4 : bx4 + bw4] = 0
    t.a.skip[bx4 : bx4 + bw4] = b.skip
    t.l.tx_intra[by4 : by4 + bh4] = int(b_dim[3])
    t.l.mode[by4 : by4 + bh4] = M.DC_PRED
    t.l.pal_sz[by4 : by4 + bh4] = 0
    t.l.seg_pred[by4 : by4 + bh4] = seg_pred
    t.l.skip_mode[by4 : by4 + bh4] = 0
    t.l.intra[by4 : by4 + bh4] = 0
    t.l.skip[by4 : by4 + bh4] = b.skip
    t.pal_sz_uv[0][bx4 : bx4 + bw4] = 0
    t.pal_sz_uv[1][by4 : by4 + bh4] = 0
    if has_chroma:
        t.a.uvmode[cbx4 : cbx4 + cbw4] = M.DC_PRED
        t.l.uvmode[cby4 : cby4 + cbh4] = M.DC_PRED

    # no lf masks: allow_intrabc implies all in-loop filters are disabled
    if hdr.segmentation.enabled and hdr.segmentation.update_map:
        f.cur_segmap[t.by : t.by + bh4, t.bx : t.bx + bw4] = b.seg_id


def _prev_segid(f, by, bx, w4, h4):
    """min seg id over the colocated area (reference get_prev_frame_segid)."""
    return int(f.prev_segmap[by : by + h4, bx : bx + w4].min())


def read_mv_component_diff(msac, mv_comp, mv_prec):
    """reference src/decode.c:76-105."""
    sign = msac.decode_bool_adapt(mv_comp.sign)
    cl = msac.decode_symbol_adapt(mv_comp.classes, 10)
    fp, hp = 3, 1
    if not cl:
        up = msac.decode_bool_adapt(mv_comp.class0)
        if mv_prec >= 0:
            fp = msac.decode_symbol_adapt(mv_comp.class0_fp[up], 3)
            if mv_prec > 0:
                hp = msac.decode_bool_adapt(mv_comp.class0_hp)
    else:
        up = 1 << cl
        for n in range(cl):
            up |= msac.decode_bool_adapt(mv_comp.classN[n]) << n
        if mv_prec >= 0:
            fp = msac.decode_symbol_adapt(mv_comp.classN_fp, 3)
            if mv_prec > 0:
                hp = msac.decode_bool_adapt(mv_comp.classN_hp)
    diff = ((up << 3) | (fp << 1) | hp) + 1
    return -diff if sign else diff


def read_mv_residual(ts, mv, mv_prec):
    """Returns updated (y, x) (reference src/decode.c:107-118)."""
    from ..levels import MVJoint
    msac = ts.msac
    mv_joint = msac.decode_symbol_adapt(ts.cdf.mv_joint, 3)
    y, x = mv
    if mv_joint & MVJoint.V:
        y += read_mv_component_diff(msac, ts.cdf.mv[0], mv_prec)
    if mv_joint & MVJoint.H:
        x += read_mv_component_diff(msac, ts.cdf.mv[1], mv_prec)
    return (y, x)


def read_tx_tree(t, from_tx, depth, masks, x_off, y_off):
    """reference src/decode.c:119-168."""
    f = t.f
    bx4, by4 = t.bx & 31, t.by & 31
    t_dim = tables.txfm_info()[from_tx]
    txw, txh = int(t_dim[2]), int(t_dim[3])  # log2
    tw, th = int(t_dim[0]), int(t_dim[1])
    ts = t.ts
    if depth < 2 and from_tx > TxfmSize.TX_4X4:
        cat = 2 * (TxfmSize.TX_64X64 - int(t_dim[5])) - depth
        a = int(int(t.a.tx[bx4]) < txw)
        l = int(int(t.l.tx[by4]) < txh)
        is_split = ts.msac.decode_bool_adapt(ts.cdf.m.txpart[cat][a + l])
        if is_split:
            masks[depth] |= 1 << (y_off * 4 + x_off)
    else:
        is_split = 0
    if is_split and int(t_dim[5]) > TxfmSize.TX_8X8:
        sub = int(t_dim[6])
        sub_t = tables.txfm_info()[sub]
        txsw, txsh = int(sub_t[0]), int(sub_t[1])
        read_tx_tree(t, sub, depth + 1, masks, x_off * 2, y_off * 2)
        t.bx += txsw
        if tw >= th and t.bx < f.bw:
            read_tx_tree(t, sub, depth + 1, masks, x_off * 2 + 1, y_off * 2)
        t.bx -= txsw
        t.by += txsh
        if th >= tw and t.by < f.bh:
            read_tx_tree(t, sub, depth + 1, masks, x_off * 2, y_off * 2 + 1)
            t.bx += txsw
            if tw >= th and t.bx < f.bw:
                read_tx_tree(t, sub, depth + 1, masks,
                             x_off * 2 + 1, y_off * 2 + 1)
            t.bx -= txsw
        t.by -= txsh
    else:
        val = TxfmSize.TX_4X4 if is_split else txw
        t.a.tx[bx4 : bx4 + tw] = val
        val = TxfmSize.TX_4X4 if is_split else txh
        t.l.tx[by4 : by4 + th] = val


def read_vartx_tree(t, b, bs, bx4, by4):
    """reference src/decode.c:445-492."""
    f = t.f
    hdr = f.frame_hdr
    b_dim = tables.block_dimensions[bs]
    bw4, bh4 = int(b_dim[0]), int(b_dim[1])
    tx_split = [0, 0]
    b.max_ytx = int(tables.max_txfm_size_for_bs[bs][0])
    if not b.skip and (hdr.segmentation.lossless[b.seg_id]
                       or b.max_ytx == TxfmSize.TX_4X4):
        b.max_ytx = b.uvtx = TxfmSize.TX_4X4
        if hdr.txfm_mode == TxfmMode.SWITCHABLE:
            t.a.tx[bx4 : bx4 + bw4] = TxfmSize.TX_4X4
            t.l.tx[by4 : by4 + bh4] = TxfmSize.TX_4X4
    elif hdr.txfm_mode != TxfmMode.SWITCHABLE or b.skip:
        if hdr.txfm_mode == TxfmMode.SWITCHABLE:
            t.a.tx[bx4 : bx4 + bw4] = int(b_dim[2])
            t.l.tx[by4 : by4 + bh4] = int(b_dim[3])
        b.uvtx = int(tables.max_txfm_size_for_bs[bs][f.layout])
    else:
        ytx = tables.txfm_info()[b.max_ytx]
        yw, yh = int(ytx[0]), int(ytx[1])
        y = 0
        y_off = 0
        while y < bh4:
            x = 0
            x_off = 0
            while x < bw4:
                read_tx_tree(t, b.max_ytx, 0, tx_split, x_off, y_off)
                t.bx += yw
                x += yw
                x_off += 1
            t.bx -= x
            t.by += yh
            y += yh
            y_off += 1
        t.by -= y
        b.uvtx = int(tables.max_txfm_size_for_bs[bs][f.layout])
    b.tx_split0 = tx_split[0] & 0xFF
    b.tx_split1 = tx_split[1]


def _decode_b_inter(t, b, bl, bs, bp, intra_edge_flags, b_dim,
                    bx4, by4, cbx4, cby4, bw4, bh4, w4, h4, cbw4, cbh4,
                    have_top, have_left, has_chroma, seg, seg_pred):
    """Inter-specific mode/mv parsing (reference src/decode.c:1381-2067)."""
    from .. import env
    from ..refmvs import (fix_mv_precision, get_gmv_2d, refmvs_find,
                          splat_mv)
    from ..levels import (CompInterPredMode as CIPM, CompInterType,
                          InterPredMode as IPM, InterIntraType, MotionMode,
                          WEDGE_ALLOWED_MASK, INTERINTRA_ALLOWED_MASK)
    from ..headers import FilterMode, WarpedMotionType

    f = t.f
    ts = t.ts
    hdr = f.frame_hdr
    msac = ts.msac
    seq = f.seq_hdr

    if b.skip_mode:
        is_comp = 1
    elif ((seg is None or (seg.ref == -1 and not seg.globalmv
                           and not seg.skip))
          and hdr.switchable_comp_refs and min(bw4, bh4) > 1):
        ctx = env.get_comp_ctx(t.a, t.l, by4, bx4, have_top, have_left)
        is_comp = msac.decode_bool_adapt(ts.cdf.m.comp[ctx])
    else:
        is_comp = 0

    has_subpel_filter = 0
    if b.skip_mode:
        # reference src/decode.c:1399-1421
        b.ref = [hdr.skip_mode_refs[0], hdr.skip_mode_refs[1]]
        b.comp_type = CompInterType.AVG
        b.inter_mode = CIPM.NEARESTMV_NEARESTMV
        b.drl_idx = 0
        mvstack, n_mvs, _ = refmvs_find(
            t.rt, (b.ref[0] + 1, b.ref[1] + 1), bs, intra_edge_flags,
            t.by, t.bx)
        b.mv = [fix_mv_precision(hdr, *mvstack[0]["mv"][0]),
                fix_mv_precision(hdr, *mvstack[0]["mv"][1])]
        b.motion_mode = MotionMode.TRANSLATION
        b.interintra_type = InterIntraType.NONE
        filter_ = _read_filter(t, b, has_subpel_filter, 1, by4, bx4)
    elif is_comp:
        dir_ctx = env.get_comp_dir_ctx(t.a, t.l, by4, bx4,
                                       have_top, have_left)
        if msac.decode_bool_adapt(ts.cdf.m.comp_dir[dir_ctx]):
            # bidirectional
            ctx1 = env.av1_get_fwd_ref_ctx(t.a, t.l, by4, bx4, have_top,
                                           have_left)
            if msac.decode_bool_adapt(ts.cdf.m.comp_fwd_ref[0][ctx1]):
                ctx2 = env.av1_get_fwd_ref_2_ctx(t.a, t.l, by4, bx4,
                                                 have_top, have_left)
                b.ref = [2 + msac.decode_bool_adapt(
                    ts.cdf.m.comp_fwd_ref[2][ctx2]), 0]
            else:
                ctx2 = env.av1_get_fwd_ref_1_ctx(t.a, t.l, by4, bx4,
                                                 have_top, have_left)
                b.ref = [msac.decode_bool_adapt(
                    ts.cdf.m.comp_fwd_ref[1][ctx2]), 0]
            ctx3 = env.av1_get_bwd_ref_ctx(t.a, t.l, by4, bx4, have_top,
                                           have_left)
            if msac.decode_bool_adapt(ts.cdf.m.comp_bwd_ref[0][ctx3]):
                b.ref[1] = 6
            else:
                ctx4 = env.av1_get_bwd_ref_1_ctx(t.a, t.l, by4, bx4,
                                                 have_top, have_left)
                b.ref[1] = 4 + msac.decode_bool_adapt(
                    ts.cdf.m.comp_bwd_ref[1][ctx4])
        else:
            # unidirectional
            uctx_p = env.av1_get_uni_p_ctx(t.a, t.l, by4, bx4, have_top,
                                           have_left)
            if msac.decode_bool_adapt(ts.cdf.m.comp_uni_ref[0][uctx_p]):
                b.ref = [4, 6]
            else:
                uctx_p1 = env.av1_get_uni_p1_ctx(t.a, t.l, by4, bx4,
                                                 have_top, have_left)
                b.ref = [0, 1 + msac.decode_bool_adapt(
                    ts.cdf.m.comp_uni_ref[1][uctx_p1])]
                if b.ref[1] == 2:
                    uctx_p2 = env.av1_get_uni_p2_ctx(t.a, t.l, by4, bx4,
                                                     have_top, have_left)
                    b.ref[1] += msac.decode_bool_adapt(
                        ts.cdf.m.comp_uni_ref[2][uctx_p2])

        mvstack, n_mvs, ctx = refmvs_find(
            t.rt, (b.ref[0] + 1, b.ref[1] + 1), bs, intra_edge_flags,
            t.by, t.bx)
        b.inter_mode = msac.decode_symbol_adapt(
            ts.cdf.m.comp_inter_mode[ctx], 7)

        im = tables.comp_inter_pred_modes[b.inter_mode]
        b.drl_idx = 0
        if b.inter_mode == CIPM.NEWMV_NEWMV:
            if n_mvs > 1:
                drl_ctx = env.get_drl_context(mvstack, 0)
                b.drl_idx += msac.decode_bool_adapt(ts.cdf.m.drl_bit[drl_ctx])
                if b.drl_idx == 1 and n_mvs > 2:
                    drl_ctx = env.get_drl_context(mvstack, 1)
                    b.drl_idx += msac.decode_bool_adapt(
                        ts.cdf.m.drl_bit[drl_ctx])
        elif int(im[0]) == IPM.NEARMV or int(im[1]) == IPM.NEARMV:
            b.drl_idx = 1
            if n_mvs > 2:
                drl_ctx = env.get_drl_context(mvstack, 1)
                b.drl_idx += msac.decode_bool_adapt(ts.cdf.m.drl_bit[drl_ctx])
                if b.drl_idx == 2 and n_mvs > 3:
                    drl_ctx = env.get_drl_context(mvstack, 2)
                    b.drl_idx += msac.decode_bool_adapt(
                        ts.cdf.m.drl_bit[drl_ctx])

        has_subpel_filter = min(bw4, bh4) == 1 or \
            b.inter_mode != CIPM.GLOBALMV_GLOBALMV
        b.mv = [None, None]
        for idx in range(2):
            mode_i = int(im[idx])
            if mode_i in (IPM.NEARMV, IPM.NEARESTMV):
                b.mv[idx] = fix_mv_precision(
                    hdr, *mvstack[b.drl_idx]["mv"][idx])
            elif mode_i == IPM.GLOBALMV:
                has_subpel_filter |= int(
                    hdr.gmv[b.ref[idx]].type == WarpedMotionType.TRANSLATION)
                b.mv[idx] = get_gmv_2d(hdr.gmv[b.ref[idx]], t.bx, t.by,
                                       bw4, bh4, hdr)
            else:  # NEWMV
                b.mv[idx] = mvstack[b.drl_idx]["mv"][idx]
                mv_prec = hdr.hp - hdr.force_integer_mv
                b.mv[idx] = read_mv_residual(ts, b.mv[idx], mv_prec)

        # jnt_comp vs seg vs wedge
        is_segwedge = 0
        if seq.masked_compound:
            mask_ctx = env.get_mask_comp_ctx(t.a, t.l, by4, bx4)
            is_segwedge = msac.decode_bool_adapt(ts.cdf.m.mask_comp[mask_ctx])
        if not is_segwedge:
            if seq.jnt_comp:
                jnt_ctx = env.get_jnt_comp_ctx(
                    seq.order_hint_n_bits, hdr.frame_offset,
                    f.refp[b.ref[0]].frame_hdr.frame_offset,
                    f.refp[b.ref[1]].frame_hdr.frame_offset,
                    t.a, t.l, by4, bx4)
                b.comp_type = CompInterType.WEIGHTED_AVG + \
                    msac.decode_bool_adapt(ts.cdf.m.jnt_comp[jnt_ctx])
            else:
                b.comp_type = CompInterType.AVG
        else:
            if WEDGE_ALLOWED_MASK & (1 << bs):
                wctx = int(tables.wedge_ctx_lut[bs])
                b.comp_type = CompInterType.WEDGE - msac.decode_bool_adapt(
                    ts.cdf.m.wedge_comp[wctx])
                if b.comp_type == CompInterType.WEDGE:
                    b.wedge_idx = msac.decode_symbol_adapt(
                        ts.cdf.m.wedge_idx[wctx], 15)
            else:
                b.comp_type = CompInterType.SEG
            b.mask_sign = msac.decode_bool_equi()

        b.motion_mode = MotionMode.TRANSLATION
        b.interintra_type = InterIntraType.NONE
        filter_ = _read_filter(t, b, has_subpel_filter, 1, by4, bx4)
    else:
        b.comp_type = CompInterType.NONE
        if seg is not None and seg.ref > 0:
            b.ref = [seg.ref - 1, -1]
        elif seg is not None and (seg.globalmv or seg.skip):
            b.ref = [0, -1]
        else:
            ctx1 = env.av1_get_ref_ctx(t.a, t.l, by4, bx4, have_top,
                                       have_left)
            if msac.decode_bool_adapt(ts.cdf.m.ref[0][ctx1]):
                ctx2 = env.av1_get_ref_2_ctx(t.a, t.l, by4, bx4, have_top,
                                             have_left)
                if msac.decode_bool_adapt(ts.cdf.m.ref[1][ctx2]):
                    ref0 = 6
                else:
                    ctx3 = env.av1_get_ref_6_ctx(t.a, t.l, by4, bx4,
                                                 have_top, have_left)
                    ref0 = 4 + msac.decode_bool_adapt(ts.cdf.m.ref[5][ctx3])
            else:
                ctx2 = env.av1_get_ref_3_ctx(t.a, t.l, by4, bx4, have_top,
                                             have_left)
                if msac.decode_bool_adapt(ts.cdf.m.ref[2][ctx2]):
                    ctx3 = env.av1_get_ref_5_ctx(t.a, t.l, by4, bx4,
                                                 have_top, have_left)
                    ref0 = 2 + msac.decode_bool_adapt(ts.cdf.m.ref[4][ctx3])
                else:
                    ctx3 = env.av1_get_ref_4_ctx(t.a, t.l, by4, bx4,
                                                 have_top, have_left)
                    ref0 = msac.decode_bool_adapt(ts.cdf.m.ref[3][ctx3])
            b.ref = [ref0, -1]
        b.ref = [int(b.ref[0]), -1]

        mvstack, n_mvs, ctx = refmvs_find(
            t.rt, (b.ref[0] + 1, -1), bs, intra_edge_flags, t.by, t.bx)

        if (seg is not None and (seg.skip or seg.globalmv)) or \
                msac.decode_bool_adapt(ts.cdf.m.newmv_mode[ctx & 7]):
            if (seg is not None and (seg.skip or seg.globalmv)) or \
                    not msac.decode_bool_adapt(
                        ts.cdf.m.globalmv_mode[(ctx >> 3) & 1]):
                b.inter_mode = IPM.GLOBALMV
                b.mv = [get_gmv_2d(hdr.gmv[b.ref[0]], t.bx, t.by, bw4, bh4,
                                   hdr), None]
                has_subpel_filter = min(bw4, bh4) == 1 or \
                    hdr.gmv[b.ref[0]].type == WarpedMotionType.TRANSLATION
            else:
                has_subpel_filter = 1
                if msac.decode_bool_adapt(
                        ts.cdf.m.refmv_mode[(ctx >> 4) & 15]):
                    b.inter_mode = IPM.NEARMV
                    b.drl_idx = 1
                    if n_mvs > 2:
                        drl_ctx = env.get_drl_context(mvstack, 1)
                        b.drl_idx += msac.decode_bool_adapt(
                            ts.cdf.m.drl_bit[drl_ctx])
                        if b.drl_idx == 2 and n_mvs > 3:
                            drl_ctx = env.get_drl_context(mvstack, 2)
                            b.drl_idx += msac.decode_bool_adapt(
                                ts.cdf.m.drl_bit[drl_ctx])
                else:
                    b.inter_mode = IPM.NEARESTMV
                    b.drl_idx = 0
                mv0 = mvstack[b.drl_idx]["mv"][0]
                if b.drl_idx < 2:
                    mv0 = fix_mv_precision(hdr, *mv0)
                b.mv = [mv0, None]
        else:
            has_subpel_filter = 1
            b.inter_mode = IPM.NEWMV
            b.drl_idx = 0
            if n_mvs > 1:
                drl_ctx = env.get_drl_context(mvstack, 0)
                b.drl_idx += msac.decode_bool_adapt(ts.cdf.m.drl_bit[drl_ctx])
                if b.drl_idx == 1 and n_mvs > 2:
                    drl_ctx = env.get_drl_context(mvstack, 1)
                    b.drl_idx += msac.decode_bool_adapt(
                        ts.cdf.m.drl_bit[drl_ctx])
            if n_mvs > 1:
                mv0 = mvstack[b.drl_idx]["mv"][0]
            else:
                mv0 = fix_mv_precision(hdr, *mvstack[0]["mv"][0])
            mv_prec = hdr.hp - hdr.force_integer_mv
            b.mv = [read_mv_residual(ts, mv0, mv_prec), None]

        # interintra
        ii_sz_grp = int(tables.ymode_size_context[bs])
        if seq.inter_intra and (INTERINTRA_ALLOWED_MASK & (1 << bs)) and \
                msac.decode_bool_adapt(ts.cdf.m.interintra[ii_sz_grp]):
            b.interintra_mode = msac.decode_symbol_adapt(
                ts.cdf.m.interintra_mode[ii_sz_grp], 3)
            wctx = int(tables.wedge_ctx_lut[bs])
            b.interintra_type = InterIntraType.BLEND + \
                msac.decode_bool_adapt(ts.cdf.m.interintra_wedge[wctx])
            if b.interintra_type == InterIntraType.WEDGE:
                b.wedge_idx = msac.decode_symbol_adapt(
                    ts.cdf.m.wedge_idx[wctx], 15)
        else:
            b.interintra_type = InterIntraType.NONE

        # motion variation (reference src/decode.c:1772-1837)
        from ..env import findoddzero
        if (hdr.switchable_motion_mode
                and b.interintra_type == InterIntraType.NONE
                and min(bw4, bh4) >= 2
                and not (not hdr.force_integer_mv
                         and b.inter_mode == IPM.GLOBALMV
                         and hdr.gmv[b.ref[0]].type >
                         WarpedMotionType.TRANSLATION)
                and ((have_left and findoddzero(t.l.intra, by4 + 1, h4 >> 1))
                     or (have_top and findoddzero(t.a.intra, bx4 + 1,
                                                  w4 >> 1)))):
            masks = _find_matching_ref(t, intra_edge_flags, bw4, bh4, w4, h4,
                                       have_left, have_top, b.ref[0])
            allow_warp = (not f.svc_scale[b.ref[0]]
                          and not hdr.force_integer_mv
                          and hdr.warp_motion and (masks[0] | masks[1]))
            if allow_warp:
                b.motion_mode = msac.decode_symbol_adapt(
                    ts.cdf.m.motion_mode[bs], 2)
            else:
                b.motion_mode = MotionMode.OBMC if msac.decode_bool_adapt(
                    ts.cdf.m.obmc[bs]) else MotionMode.TRANSLATION
            if b.motion_mode == MotionMode.WARP:
                has_subpel_filter = 0
                t.warpmv = _derive_warpmv(t, bw4, bh4, masks, b.mv[0])
        else:
            b.motion_mode = MotionMode.TRANSLATION

        filter_ = _read_filter(t, b, has_subpel_filter, 0, by4, bx4)

    b.filter2d = int(tables.filter_2d[filter_[1]][filter_[0]])

    read_vartx_tree(t, b, bs, bx4, by4)

    # reconstruction
    from ..recon.inter import recon_b_inter
    if t.pass_ == 1:
        t.cur_rec = dict(kind="inter", ts=t.ts, bx=t.bx, by=t.by, bs=bs, b=b,
                         coefs=[], warpmv=t.warpmv,
                         obmc=_capture_obmc(t, b, bw4, bh4, w4, h4,
                                            bx4, by4)
                         if b.motion_mode == MotionMode.OBMC else None,
                         sub8x8=_capture_sub8x8(t, b, bw4, bh4, by4, bx4))
        t.f.tasks.append(t.cur_rec)
    recon_b_inter(t, bs, b)

    if hdr.loopfilter.level_y[0] or hdr.loopfilter.level_y[1]:
        from ..recon.lf import create_lf_mask_inter
        is_globalmv = b.inter_mode == (
            CIPM.GLOBALMV_GLOBALMV if is_comp else IPM.GLOBALMV)
        lf_lvls = ts.lflvl[b.seg_id][:, b.ref[0] + 1,
                           1 - int(is_globalmv)].reshape(4, 1, 1)
        ytx_lf, uvtx_lf = b.max_ytx, b.uvtx
        if hdr.segmentation.lossless[b.seg_id]:
            ytx_lf = uvtx_lf = TxfmSize.TX_4X4
        create_lf_mask_inter(
            f, f.lf_level, lf_lvls,
            t.bx, t.by, f.w4, f.h4, b.skip, bs, ytx_lf,
            (b.tx_split0, b.tx_split1), uvtx_lf, f.layout,
            t.a.tx_lpf_y, bx4, t.l.tx_lpf_y, by4,
            t.a.tx_lpf_uv if has_chroma else None, cbx4,
            t.l.tx_lpf_uv, cby4)

    # splat mvs + context updates
    from ..refmvs import splat_mv
    if is_comp:
        mf = int(b.inter_mode == CIPM.GLOBALMV_GLOBALMV) | \
            (2 * int(bool((1 << b.inter_mode) & 0xBC)))
        splat_mv(f.rf, t.by, t.bx, bw4, bh4, b.mv[0], b.mv[1],
                 b.ref[0] + 1, b.ref[1] + 1, bs, mf)
    else:
        mf = int(b.inter_mode == IPM.GLOBALMV and min(bw4, bh4) >= 2) | \
            (2 * int(b.inter_mode == IPM.NEWMV))
        splat_mv(f.rf, t.by, t.bx, bw4, bh4, b.mv[0], (0, 0),
                 b.ref[0] + 1, 0 if b.interintra_type else -1, bs, mf)

    t.a.seg_pred[bx4 : bx4 + bw4] = seg_pred
    t.a.skip_mode[bx4 : bx4 + bw4] = b.skip_mode
    t.a.intra[bx4 : bx4 + bw4] = 0
    t.a.skip[bx4 : bx4 + bw4] = b.skip
    t.a.pal_sz[bx4 : bx4 + bw4] = 0
    t.pal_sz_uv[0][bx4 : bx4 + bw4] = 0
    t.pal_sz_uv[1][by4 : by4 + bh4] = 0
    t.a.tx_intra[bx4 : bx4 + bw4] = int(b_dim[2])
    t.a.comp_type[bx4 : bx4 + bw4] = b.comp_type
    t.a.filter[0][bx4 : bx4 + bw4] = filter_[0]
    t.a.filter[1][bx4 : bx4 + bw4] = filter_[1]
    t.a.mode[bx4 : bx4 + bw4] = b.inter_mode
    t.a.ref[0][bx4 : bx4 + bw4] = b.ref[0]
    t.a.ref[1][bx4 : bx4 + bw4] = b.ref[1]
    t.l.seg_pred[by4 : by4 + bh4] = seg_pred
    t.l.skip_mode[by4 : by4 + bh4] = b.skip_mode
    t.l.intra[by4 : by4 + bh4] = 0
    t.l.skip[by4 : by4 + bh4] = b.skip
    t.l.pal_sz[by4 : by4 + bh4] = 0
    t.l.tx_intra[by4 : by4 + bh4] = int(b_dim[3])
    t.l.comp_type[by4 : by4 + bh4] = b.comp_type
    t.l.filter[0][by4 : by4 + bh4] = filter_[0]
    t.l.filter[1][by4 : by4 + bh4] = filter_[1]
    t.l.mode[by4 : by4 + bh4] = b.inter_mode
    t.l.ref[0][by4 : by4 + bh4] = b.ref[0]
    t.l.ref[1][by4 : by4 + bh4] = b.ref[1]
    if has_chroma:
        t.a.uvmode[cbx4 : cbx4 + cbw4] = M.DC_PRED
        t.l.uvmode[cby4 : cby4 + cbh4] = M.DC_PRED
    if hdr.segmentation.enabled and hdr.segmentation.update_map:
        f.cur_segmap[t.by : t.by + bh4, t.bx : t.bx + bw4] = b.seg_id


def _capture_obmc(t, b, bw4, bh4, w4, h4, bx4, by4):
    """Snapshot OBMC neighbour parameters at parse time (above/left
    contexts are only valid then); replayed by recon.inter.obmc."""
    f = t.f
    r = f.rf.r
    b_dim = tables.block_dimensions[b.bs]
    tasks = []
    if t.by > t.ts.row_start:
        i = x = 0
        while x < w4 and i < min(int(b_dim[2]), 4):
            a_r = r[t.by - 1, t.bx + x + 1]
            step4 = max(2, min(16, int(
                tables.block_dimensions[int(a_r["bs"])][0])))
            if int(a_r["ref"][0]) > 0:
                f2d = int(tables.filter_2d[t.a.filter[1][bx4 + x + 1]]
                          [t.a.filter[0][bx4 + x + 1]])
                tasks.append(("top", x,
                              (int(a_r["mv"][0][0]), int(a_r["mv"][0][1])),
                              int(a_r["ref"][0]) - 1, f2d, step4))
                i += 1
            x += step4
    if t.bx > t.ts.col_start:
        i = y = 0
        while y < h4 and i < min(int(b_dim[3]), 4):
            l_r = r[t.by + y + 1, t.bx - 1]
            step4 = max(2, min(16, int(
                tables.block_dimensions[int(l_r["bs"])][1])))
            if int(l_r["ref"][0]) > 0:
                f2d = int(tables.filter_2d[t.l.filter[1][by4 + y + 1]]
                          [t.l.filter[0][by4 + y + 1]])
                tasks.append(("left", y,
                              (int(l_r["mv"][0][0]), int(l_r["mv"][0][1])),
                              int(l_r["ref"][0]) - 1, f2d, step4))
                i += 1
            y += step4
    return tasks


def _capture_sub8x8(t, b, bw4, bh4, by4, bx4):
    """Snapshot the left/top filter types needed by the sub-8x8 chroma
    path (valid only at parse time)."""
    ss_ver = t.f.ss_ver
    if not (bw4 == 1 or bh4 == ss_ver):
        return None
    return (t.tl_4x4_filter,
            int(tables.filter_2d[t.l.filter[1][by4]][t.l.filter[0][by4]]),
            int(tables.filter_2d[t.a.filter[1][bx4]][t.a.filter[0][bx4]]))


def _read_pal_plane(t, b, pl, sz_ctx, bx4, by4):
    """reference dav1d_read_pal_plane (src/recon_tmpl.c:2172-2253)."""
    ts = t.ts
    f = t.f
    msac = ts.msac
    pal_sz = msac.decode_symbol_adapt(ts.cdf.m.pal_sz[pl][sz_ctx], 6) + 2
    b.pal_sz[pl] = pal_sz
    cache = []
    l_cache = int(t.pal_sz_uv[1][by4]) if pl else int(t.l.pal_sz[by4])
    # don't reuse above palette outside SB64 boundaries
    a_cache = (int(t.pal_sz_uv[0][bx4]) if pl else int(t.a.pal_sz[bx4])) \
        if by4 & 15 else 0
    l = t.al_pal[1, by4, pl]
    a = t.al_pal[0, bx4, pl]
    li = ai = 0

    # fill/sort cache (merge of two sorted palettes, deduplicated)
    while l_cache and a_cache:
        lv, av = int(l[li]), int(a[ai])
        if lv < av:
            if not cache or cache[-1] != lv:
                cache.append(lv)
            li += 1
            l_cache -= 1
        else:
            if av == lv:
                li += 1
                l_cache -= 1
            if not cache or cache[-1] != av:
                cache.append(av)
            ai += 1
            a_cache -= 1
    while l_cache:
        lv = int(l[li])
        if not cache or cache[-1] != lv:
            cache.append(lv)
        li += 1
        l_cache -= 1
    while a_cache:
        av = int(a[ai])
        if not cache or cache[-1] != av:
            cache.append(av)
        ai += 1
        a_cache -= 1

    # find reused cache entries
    used_cache = []
    for v in cache:
        if len(used_cache) >= pal_sz:
            break
        if msac.decode_bool_equi():
            used_cache.append(v)
    n_used_cache = len(used_cache)

    pal = t.scratch_pal[pl]
    i = n_used_cache
    if i < pal_sz:
        bpc = f.seq_hdr.bitdepth
        new = [0] * pal_sz
        prev = new[i] = msac.decode_bools(bpc)
        i += 1
        if i < pal_sz:
            bits = bpc - 3 + msac.decode_bools(2)
            maxv = (1 << bpc) - 1
            while i < pal_sz:
                delta = msac.decode_bools(bits)
                prev = new[i] = min(prev + delta + (not pl), maxv)
                i += 1
                if prev + (not pl) >= maxv:
                    while i < pal_sz:
                        new[i] = maxv
                        i += 1
                    break
                bits = min(bits, 1 + (maxv - prev - (not pl)).bit_length()
                           - 1)
        # merge cache + new entries (both sorted)
        n = 0
        m = n_used_cache
        for i in range(pal_sz):
            if n < n_used_cache and (m >= pal_sz
                                     or used_cache[n] <= new[m]):
                pal[i] = used_cache[n]
                n += 1
            else:
                pal[i] = new[m]
                m += 1
    else:
        pal[:n_used_cache] = used_cache


def _read_pal_uv(t, b, sz_ctx, bx4, by4):
    """reference dav1d_read_pal_uv (src/recon_tmpl.c:2278-2320)."""
    _read_pal_plane(t, b, 1, sz_ctx, bx4, by4)
    ts = t.ts
    msac = ts.msac
    pal = t.scratch_pal[2]
    bpc = t.f.seq_hdr.bitdepth
    if msac.decode_bool_equi():
        bits = bpc - 4 + msac.decode_bools(2)
        maxv = (1 << bpc) - 1
        prev = pal[0] = msac.decode_bools(bpc)
        for i in range(1, b.pal_sz[1]):
            delta = msac.decode_bools(bits)
            if delta and msac.decode_bool_equi():
                delta = -delta
            prev = pal[i] = (int(prev) + delta) & maxv
    else:
        for i in range(b.pal_sz[1]):
            pal[i] = msac.decode_bools(bpc)


def _order_palette(tmp, i, first, last, order, ctxs):
    """Per-diagonal neighbor ordering (reference order_palette,
    src/decode.c:353-413). tmp is the unpacked index map."""
    have_top = i > first
    n = 0
    for j in range(first, last - 1, -1):
        row, col = i - j, j
        have_left = j > 0
        mask = 0
        o = []

        def add(v):
            nonlocal mask
            o.append(v)
            mask |= 1 << v

        if not have_left:
            ctxs[n] = 0
            add(int(tmp[row - 1, col]))
        elif not have_top:
            ctxs[n] = 0
            add(int(tmp[row, col - 1]))
        else:
            lv = int(tmp[row, col - 1])
            tv = int(tmp[row - 1, col])
            tlv = int(tmp[row - 1, col - 1])
            same_t_l = tv == lv
            same_t_tl = tv == tlv
            same_l_tl = lv == tlv
            if same_t_l and same_t_tl and same_l_tl:
                ctxs[n] = 4
                add(tv)
            elif same_t_l:
                ctxs[n] = 3
                add(tv)
                add(tlv)
            elif same_t_tl or same_l_tl:
                ctxs[n] = 2
                add(tlv)
                add(lv if same_t_tl else tv)
            else:
                ctxs[n] = 1
                add(min(tv, lv))
                add(max(tv, lv))
                add(tlv)
        for bit in range(8):
            if not (mask & (1 << bit)):
                o.append(bit)
        order[n] = o
        n += 1
        have_top = True


def _read_pal_indices(t, pal_sz, pl, w4, h4, bw4, bh4):
    """reference read_pal_indices (src/decode.c:414-443) + unpacked
    pal_idx_finish edge fill (src/pal.c:37-61)."""
    ts = t.ts
    msac = ts.msac
    tmp = np.zeros((bh4 * 4, bw4 * 4), dtype=np.uint8)
    tmp[0, 0] = msac.decode_uniform(pal_sz)
    cdf = ts.cdf.m.color_map[pl][pal_sz - 2]
    order = [None] * 64
    ctxs = [0] * 64
    for i in range(1, 4 * (w4 + h4) - 1):
        first = min(i, w4 * 4 - 1)
        last = max(0, i - h4 * 4 + 1)
        _order_palette(tmp, i, first, last, order, ctxs)
        m = 0
        for j in range(first, last - 1, -1):
            color_idx = msac.decode_symbol_adapt(cdf[ctxs[m]], pal_sz - 1)
            tmp[i - j, j] = order[m][color_idx]
            m += 1
    # fill invisible edges (replicate last coded col/row)
    w_px, h_px = w4 * 4, h4 * 4
    if w_px < bw4 * 4:
        tmp[:h_px, w_px:] = tmp[:h_px, w_px - 1 : w_px]
    if h_px < bh4 * 4:
        tmp[h_px:] = tmp[h_px - 1]
    return tmp


def _find_matching_ref(t, intra_edge_flags, bw4, bh4, w4, h4, have_left,
                       have_top, ref):
    """Bitmasks of same-(single-)ref neighbour blocks along the top/left
    edges (reference find_matching_ref, src/decode.c:191-262).
    Returns [top_mask | topright<<32, left_mask | topleft<<32]."""
    from ..intra_edge import EDGE_I444_TOP_HAS_RIGHT
    r = t.f.rf.r
    masks = [0, 0]
    count = 0
    have_topleft = have_top and have_left
    have_topright = (max(bw4, bh4) < 32 and have_top
                     and t.bx + bw4 < t.ts.col_end
                     and (intra_edge_flags & EDGE_I444_TOP_HAS_RIGHT))

    def matches(b):
        return int(b["ref"][0]) == ref + 1 and int(b["ref"][1]) == -1

    if have_top:
        row = r[t.by - 1]
        b2 = row[t.bx]
        if matches(b2):
            masks[0] |= 1
            count = 1
        aw4 = int(tables.block_dimensions[int(b2["bs"])][0])
        if aw4 >= bw4:
            off = t.bx & (aw4 - 1)
            if off:
                have_topleft = 0
            if aw4 - off > bw4:
                have_topright = 0
        else:
            mask = 1 << aw4
            x = aw4
            while x < w4:
                b2 = row[t.bx + x]
                if matches(b2):
                    masks[0] |= mask
                    count += 1
                    if count >= 8:
                        return masks
                aw4 = int(tables.block_dimensions[int(b2["bs"])][0])
                mask <<= aw4
                x += aw4
    if have_left:
        b2 = r[t.by, t.bx - 1]
        if matches(b2):
            masks[1] |= 1
            count += 1
            if count >= 8:
                return masks
        lh4 = int(tables.block_dimensions[int(b2["bs"])][1])
        if lh4 >= bh4:
            if t.by & (lh4 - 1):
                have_topleft = 0
        else:
            mask = 1 << lh4
            y = lh4
            while y < h4:
                b2 = r[t.by + y, t.bx - 1]
                if matches(b2):
                    masks[1] |= mask
                    count += 1
                    if count >= 8:
                        return masks
                lh4 = int(tables.block_dimensions[int(b2["bs"])][1])
                mask <<= lh4
                y += lh4
    if have_topleft and matches(r[t.by - 1, t.bx - 1]):
        masks[1] |= 1 << 32
        count += 1
        if count >= 8:
            return masks
    if have_topright and matches(r[t.by - 1, t.bx + bw4]):
        masks[0] |= 1 << 32
    return masks


def _derive_warpmv(t, bw4, bh4, masks, mv):
    """Least-squares warp model from matching neighbours (reference
    derive_warpmv, src/decode.c:264-336)."""
    from ..headers import WarpedMotionParams, WarpedMotionType
    from ..warpmv import find_affine_int, get_shear_params
    pts = [[[0, 0], [0, 0]] for _ in range(8)]
    np_ = 0
    r = t.f.rf.r
    mvy, mvx = mv

    def add_sample(dx, dy, sx, sy, rp):
        nonlocal np_
        bd = tables.block_dimensions[int(rp["bs"])]
        pts[np_][0][0] = 16 * (2 * dx + sx * int(bd[0])) - 8
        pts[np_][0][1] = 16 * (2 * dy + sy * int(bd[1])) - 8
        pts[np_][1][0] = pts[np_][0][0] + int(rp["mv"][0][1])
        pts[np_][1][1] = pts[np_][0][1] + int(rp["mv"][0][0])
        np_ += 1

    if (masks[0] & 0xFFFFFFFF) == 1 and not (masks[1] >> 32):
        aw4 = int(tables.block_dimensions[int(r[t.by - 1, t.bx]["bs"])][0])
        off = t.bx & (aw4 - 1)
        add_sample(-off, 0, 1, -1, r[t.by - 1, t.bx])
    else:
        xmask = masks[0] & 0xFFFFFFFF
        off = 0
        while np_ < 8 and xmask:
            tz = (xmask & -xmask).bit_length() - 1
            off += tz
            xmask >>= tz
            add_sample(off, 0, 1, -1, r[t.by - 1, t.bx + off])
            xmask &= ~1
    if np_ < 8 and masks[1] == 1:
        lh4 = int(tables.block_dimensions[int(r[t.by, t.bx - 1]["bs"])][1])
        off = t.by & (lh4 - 1)
        add_sample(0, -off, -1, 1, r[t.by - off, t.bx - 1])
    else:
        ymask = masks[1] & 0xFFFFFFFF
        off = 0
        while np_ < 8 and ymask:
            tz = (ymask & -ymask).bit_length() - 1
            off += tz
            ymask >>= tz
            add_sample(0, off, -1, 1, r[t.by + off, t.bx - 1])
            ymask &= ~1
    if np_ < 8 and (masks[1] >> 32):
        add_sample(0, 0, -1, -1, r[t.by - 1, t.bx - 1])
    if np_ < 8 and (masks[0] >> 32):
        add_sample(bw4, 0, 1, -1, r[t.by - 1, t.bx + bw4])

    # select by motion-vector difference against a threshold
    mvd = [0] * 8
    ret = 0
    thresh = 4 * max(4, min(28, max(bw4, bh4)))
    for i in range(np_):
        mvd[i] = abs(pts[i][1][0] - pts[i][0][0] - mvx) + \
            abs(pts[i][1][1] - pts[i][0][1] - mvy)
        if mvd[i] > thresh:
            mvd[i] = -1
        else:
            ret += 1
    if not ret:
        ret = 1
    else:
        i, j = 0, np_ - 1
        for _ in range(np_ - ret):
            while mvd[i] != -1:
                i += 1
            while mvd[j] == -1:
                j -= 1
            if i > j:
                break
            mvd[i] = mvd[j]
            pts[i] = [list(pts[j][0]), list(pts[j][1])]
            i += 1
            j -= 1

    wmp = WarpedMotionParams()
    if not find_affine_int(pts, ret, bw4, bh4, mvy, mvx, wmp, t.bx, t.by) \
            and not get_shear_params(wmp):
        wmp.type = WarpedMotionType.AFFINE
    else:
        wmp.type = WarpedMotionType.IDENTITY
    return wmp


def _read_filter(t, b, has_subpel_filter, comp, by4, bx4):
    from .. import env
    from ..headers import FilterMode
    f = t.f
    ts = t.ts
    hdr = f.frame_hdr
    if hdr.subpel_filter_mode == FilterMode.SWITCHABLE:
        if has_subpel_filter:
            ctx1 = env.get_filter_ctx(t.a, t.l, comp, 0, b.ref[0], by4, bx4)
            f0 = ts.msac.decode_symbol_adapt(ts.cdf.m.filter[0][ctx1], 2)
            if f.seq_hdr.dual_filter:
                ctx2 = env.get_filter_ctx(t.a, t.l, comp, 1, b.ref[0],
                                          by4, bx4)
                f1 = ts.msac.decode_symbol_adapt(ts.cdf.m.filter[1][ctx2], 2)
            else:
                f1 = f0
            return [f0, f1]
        return [0, 0]
    return [int(hdr.subpel_filter_mode), int(hdr.subpel_filter_mode)]
