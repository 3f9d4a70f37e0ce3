"""Frame-level orchestration: context init, tile splitting, sbrow loop.

Behavioral parity with reference src/decode.c (dav1d_decode_frame_init
:2750, init_cdf :3142, main :3196, dav1d_decode_frame :3285) — single
threaded ("pass 0") path; the two-pass pipeline replaces the
worker-thread scheduler with batched device stages: pass 1 is the
native symbol decode with the residual launch on ``f.device`` (one
itx kernel a frame), the finish runs
pass 2 (pipeline.run_pass2, with the batched MC on ``f.device``) and
the in-loop filter chain (recon/device_chain.py: deblock and CDEF on
``f.device``, super-res and loop restoration on the host).
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..cdf import CdfContext
from ..headers import FrameHeader, PixelLayout, SequenceHeader, TxfmMode
from ..intra_edge import INTRA_EDGE_TREE
from ..levels import BlockLevel
from ..recon.lf import calc_eih, calc_lf_values
from .tile import BlockContext, TaskContext, TileState, decode_sb

_TILE_POOL = None
_TILE_POOL_SIZE = 0


def _tile_pool(n):
    """Process-wide worker pool for tile-column pass-1 parallelism."""
    global _TILE_POOL, _TILE_POOL_SIZE
    if _TILE_POOL is None or _TILE_POOL_SIZE < n:
        from concurrent.futures import ThreadPoolExecutor

        _TILE_POOL = ThreadPoolExecutor(max_workers=n,
                                        thread_name_prefix="dav1d_tpu-tile")
        _TILE_POOL_SIZE = n
    return _TILE_POOL


def init_quant_tables(seq_hdr, frame_hdr, qidx):
    """(8, 3 planes, 2 dc/ac) uint16 dequant values
    (reference src/decode.c:54-74)."""
    dq = np.zeros((8, 3, 2), dtype=np.uint16)
    n = 8 if frame_hdr.segmentation.enabled else 1
    tbl = tables.dq_tbl[seq_hdr.hbd]

    def clip_u8(v):
        return max(0, min(255, v))

    for i in range(n):
        yac = clip_u8(qidx + frame_hdr.segmentation.seg_data.d[i].delta_q) \
            if frame_hdr.segmentation.enabled else qidx
        q = frame_hdr.quant
        dq[i, 0, 0] = tbl[clip_u8(yac + q.ydc_delta)][0]
        dq[i, 0, 1] = tbl[yac][1]
        dq[i, 1, 0] = tbl[clip_u8(yac + q.udc_delta)][0]
        dq[i, 1, 1] = tbl[clip_u8(yac + q.uac_delta)][1]
        dq[i, 2, 0] = tbl[clip_u8(yac + q.vdc_delta)][0]
        dq[i, 2, 1] = tbl[clip_u8(yac + q.vac_delta)][1]
    return dq


class FrameContext:
    """Decode state for one frame (reference Dav1dFrameContext)."""

    def __init__(self, seq_hdr: SequenceHeader, frame_hdr: FrameHeader,
                 prev_segmap=None, in_cdf: CdfContext | None = None,
                 refs=None):
        self.seq_hdr = seq_hdr
        self.frame_hdr = frame_hdr
        self.layout = seq_hdr.layout
        self.bitdepth = seq_hdr.bitdepth

        hdr = frame_hdr
        self.w4 = (hdr.width[0] + 3) >> 2
        self.h4 = (hdr.height + 3) >> 2
        self.bw = ((hdr.width[0] + 7) >> 3) << 1
        self.bh = ((hdr.height + 7) >> 3) << 1
        self.sb128w = (self.bw + 31) >> 5
        self.sb128h = (self.bh + 31) >> 5
        self.sb_shift = 4 + seq_hdr.sb128
        self.sb_step = 16 << seq_hdr.sb128
        self.sbh = (self.bh + self.sb_step - 1) >> self.sb_shift
        self.b4_stride = (self.bw + 31) & ~31

        # current picture: padded planes, int32 for uniform integer math
        ss_ver = 1 if self.layout == PixelLayout.I420 else 0
        ss_hor = 0 if self.layout == PixelLayout.I444 else 1
        self.ss_ver, self.ss_hor = ss_ver, ss_hor
        # superblock-aligned allocation: partial edge blocks predict/add
        # full TX blocks into the padding (reference pads pictures too,
        # include/dav1d/picture.h:113-116)
        align = self.sb_step
        yw = ((self.bw + align - 1) & ~(align - 1)) * 4
        yh = ((self.bh + align - 1) & ~(align - 1)) * 4
        # pooled: fresh-page faults on frame-sized buffers cost ~45 ms
        # per 4K frame (see bufpool.py; reference analog src/mem.c pools).
        # The coded bw*4 x bh*4 area is NOT pre-zeroed: reconstruction
        # writes every pixel of every 4x4 block (skip blocks via MC,
        # coded via prediction+residual), MC clamps reference reads to
        # the real frame dims, the filter chain and output crop stay
        # inside the coded area — so only the superblock-alignment
        # padding needs deterministic contents (partial edge blocks
        # write full TX blocks into it, but nothing ever reads it; it
        # is zeroed for insurance).  decode errors zero the planes of
        # the half-written frame (decoder._finish_task) so errored
        # frames referenced by later frames stay deterministic.
        from ..bufpool import take as _take
        self.planes = [_take((yh, yw), np.int32)]
        if self.layout != PixelLayout.I400:
            cw = (yw + ss_hor) >> ss_hor
            ch = (yh + ss_ver) >> ss_ver
            self.planes += [_take((ch, cw), np.int32)
                            for _ in range(2)]
        cph, cpw = self.bh * 4, self.bw * 4
        for pl, p in enumerate(self.planes):
            sv, sh_ = (ss_ver, ss_hor) if pl else (0, 0)
            p[(cph + sv) >> sv :, :] = 0
            p[:, (cpw + sh_) >> sh_ :] = 0

        # quantizer matrices: (tx, plane) -> weights, absent when disabled
        # or qm level 15 (reference src/decode.c:3078-3085)
        self.qm = {}
        if hdr.quant.qm:
            qtbl = tables.qm_tbl()
            for i in range(19):
                for pl, qmid in ((0, hdr.quant.qm_y), (1, hdr.quant.qm_u),
                                 (2, hdr.quant.qm_v)):
                    key = (qmid, int(pl > 0), i)
                    if key in qtbl:
                        self.qm[(i, pl)] = qtbl[key]

        self.in_cdf = in_cdf if in_cdf is not None else \
            CdfContext.from_defaults(hdr.quant.yac)
        self.out_cdf: CdfContext | None = None
        self.dq = init_quant_tables(seq_hdr, hdr, hdr.quant.yac)

        self.cur_segmap = (
            _take((self.bh, self.bw), np.uint8, fill=0)
            if hdr.segmentation.enabled else None)
        self.prev_segmap = prev_segmap
        self.refs = refs or [None] * 7
        self.refp = self.refs  # 7 reference slots (planes + frame_hdr)

        # ref-MV state for inter / intrabc frames
        # (reference src/decode.c:3570-3612: refpoc/refrefpoc/ref_mvs setup)
        self.rf = None
        self.refpoc = [0] * 7
        if hdr.frame_type.is_inter_or_switch or hdr.allow_intrabc:
            from ..refmvs import RefMvsFrame
            ref_poc = None
            ref_ref_poc = None
            rp_ref = None
            if hdr.frame_type.is_inter_or_switch and not hdr.allow_intrabc:
                ref_poc = [r.frame_hdr.frame_offset if r and r.frame_hdr
                           else 0 for r in self.refs]
                self.refpoc = list(ref_poc)
                if hdr.use_ref_frame_mvs:
                    ref_ref_poc = []
                    rp_ref = []
                    for r in self.refs:
                        ref_ref_poc.append(list(r.refpoc)
                                           if r is not None and
                                           getattr(r, "refpoc", None)
                                           else [0] * 7)
                        rp = getattr(r, "refmvs", None) \
                            if r is not None else None
                        if rp is not None and r.frame_hdr is not None:
                            ref_w = ((r.frame_hdr.width[0] + 7) >> 3) << 1
                            ref_h = ((r.frame_hdr.height + 7) >> 3) << 1
                            if ref_w != self.bw or ref_h != self.bh:
                                rp = None
                        rp_ref.append(rp)
            self.rf = RefMvsFrame(seq_hdr, hdr, ref_poc=ref_poc,
                                  ref_ref_poc=ref_ref_poc, rp_ref=rp_ref)

        # per-ref scaling + global-motion warp gates
        # (reference src/decode.c:3466-3489)
        self.svc_scale = [0] * 7  # nonzero => scaled reference
        self.svc = [[(0, 0), (0, 0)] for _ in range(7)]  # (scale, step) x/y
        self.gmv_warp_allowed = [0] * 7
        if hdr.frame_type.is_inter_or_switch and self.refs[0] is not None:
            from ..warpmv import get_shear_params

            def scale_fac(ref_sz, this_sz):
                return ((ref_sz << 14) + (this_sz >> 1)) // this_sz

            for i in range(7):
                r = self.refs[i]
                if r is not None and r.frame_hdr is not None and \
                        (hdr.width[0] != r.frame_hdr.width[1]
                         or hdr.height != r.frame_hdr.height):
                    sx = scale_fac(r.frame_hdr.width[1], hdr.width[0])
                    sy = scale_fac(r.frame_hdr.height, hdr.height)
                    self.svc[i] = [(sx, (sx + 8) >> 4), (sy, (sy + 8) >> 4)]
                    self.svc_scale[i] = 1
                self.gmv_warp_allowed[i] = int(
                    hdr.gmv[i].type > 1  # > TRANSLATION
                    and not hdr.force_integer_mv
                    and not get_shear_params(hdr.gmv[i])
                    and not self.svc_scale[i])

        # distance-weighted compound weights (reference src/decode.c:3088)
        self.jnt_weights = None
        if hdr.switchable_comp_refs and seq_hdr.order_hint:
            self.jnt_weights = _init_jnt_weights(seq_hdr, hdr, self.refs)

        # above block contexts: one per sb128 column per tile row
        self.a = [BlockContext()
                  for _ in range(self.sb128w * hdr.tiling.rows)]

        # pre-filter bottom-row backup per sbrow for next sbrow's intra
        n_pl = 1 if self.layout == PixelLayout.I400 else 3
        self.ipred_edge = [
            _take((self.sbh, self.sb128w * 128 >> (ss_hor if pl else 0)),
                  np.int32, fill=0) for pl in range(n_pl)]

        # deblock state: per-4x4 levels + frame-wide edge width-class
        # planes ([0] vertical edges, [1] horizontal; see recon/lf.py)
        h4a = (self.bh + 31) & ~31
        self.lf_level = _take((h4a, self.b4_stride, 4), np.uint8, fill=0)
        self.lf_wd_y = _take((2, h4a, self.b4_stride), np.uint8, fill=0)
        self.lf_wd_uv = _take(
            (2, (h4a + ss_ver) >> ss_ver,
             (self.b4_stride + ss_hor) >> ss_hor), np.uint8, fill=0)
        self.lf_lim_lut = calc_eih(hdr.loopfilter.sharpness)
        self.lf_lvl = calc_lf_values(hdr, [0, 0, 0, 0])
        self.start_of_tile_row = [0] * self.sbh
        sby = 0
        for tile_row in range(hdr.tiling.rows):
            self.start_of_tile_row[sby] = tile_row
            sby += 1
            while sby < min(hdr.tiling.row_start_sb[tile_row + 1], self.sbh):
                self.start_of_tile_row[sby] = 0
                sby += 1

        # per-tile-column right-edge tx sizes for cross-tile lf fixups
        # (reference f->lf.tx_lpf_right_edge, src/decode.c:3055-3065)
        align_h = (self.bh + 31) & ~31
        self.tx_lpf_right_edge = [
            _take((align_h * hdr.tiling.cols,), np.uint8, fill=0),
            _take(((align_h >> ss_ver) * hdr.tiling.cols,), np.uint8,
                  fill=0)]

        # cdef index per 64x64 unit: (sb128h*2, sb128w*2)
        self.cdef_idx = _take((self.sb128h * 2, self.sb128w * 2),
                              np.int32, fill=-1)
        # per-8x8-unit "any coded coefficients" mask for cdef
        # (reference Av1Filter.noskip_mask, set in src/decode.c:1946-1955)
        self.noskip = _take((self.sb128h * 16, self.sb128w * 32),
                            np.bool_, fill=False)
        self.ts: list[TileState] = []

        # loop restoration state (reference src/decode.c:3030,2662-2713)
        self.restore_planes = (
            (int(hdr.restoration.type[0] != 0) << 0)
            | (int(hdr.restoration.type[1] != 0) << 1)
            | (int(hdr.restoration.type[2] != 0) << 2))
        self.sr_sb128w = (hdr.width[1] + 127) >> 7
        # (sb_idx, plane, unit_idx) -> restoration unit dict
        self.lr_units = {}
        # Settings.inloop_filters bitmask: 1 deblock, 2 cdef, 4 lr
        self.inloop_filters = 7

    def lr_unit(self, sb_idx, plane, unit_idx):
        key = (sb_idx, plane, unit_idx)
        u = self.lr_units.get(key)
        if u is None:
            u = dict(type=0, filter_v=[0, 0, 0], filter_h=[0, 0, 0],
                     sgr_weights=[0, 0])
            self.lr_units[key] = u
        return u

    @property
    def frame_is_intra(self) -> bool:
        return self.frame_hdr.frame_type.is_key_or_intra


def split_tiles(f: FrameContext, tile_groups) -> None:
    """Split tile-group payloads into per-tile MSAC ranges and create
    TileStates (reference dav1d_decode_frame_init_cdf, src/decode.c:3142)."""
    hdr = f.frame_hdr
    if hdr.refresh_context:
        f.out_cdf = f.in_cdf.copy()
    n_tiles = hdr.tiling.cols * hdr.tiling.rows
    f.ts = [None] * n_tiles
    tile_row = tile_col = 0
    for tg in tile_groups:
        data = tg.data
        pos = tg.start_offset
        end_pos = tg.end_offset
        for j in range(tg.tile_start, tg.tile_end + 1):
            if j == tg.tile_end:
                tile_sz = end_pos - pos
            else:
                nb = hdr.tiling.n_bytes
                if nb > end_pos - pos:
                    raise ValueError("tile size field overruns")
                tile_sz = 0
                for k in range(nb):
                    tile_sz |= data[pos + k] << (k * 8)
                tile_sz += 1
                pos += nb
                if tile_sz > end_pos - pos:
                    raise ValueError("tile overruns tile group")
            f.ts[j] = TileState(f, data, pos, pos + tile_sz,
                                tile_row, tile_col)
            tile_col += 1
            if tile_col == hdr.tiling.cols:
                tile_col = 0
                tile_row += 1
            pos += tile_sz


def _init_jnt_weights(seq_hdr, hdr, refs):
    """reference src/decode.c:3088-3118."""
    from ..obu import get_poc_diff
    quant_dist_lookup = [[9, 7], [11, 5], [12, 4], [13, 3]]
    quant_dist_weight = [[2, 3], [2, 5], [2, 7]]
    out = [[0] * 7 for _ in range(7)]
    poc = hdr.frame_offset
    for i in range(7):
        for j in range(7):
            ref0poc = refs[i].frame_hdr.frame_offset
            ref1poc = refs[j].frame_hdr.frame_offset
            d1 = min(abs(get_poc_diff(seq_hdr.order_hint_n_bits, ref0poc,
                                      poc)), 31)
            d0 = min(abs(get_poc_diff(seq_hdr.order_hint_n_bits, ref1poc,
                                      poc)), 31)
            order = d0 <= d1
            k = 3
            for qd in range(3):
                c0 = quant_dist_weight[qd][int(order)]
                c1 = quant_dist_weight[qd][int(not order)]
                d0_c0 = d0 * c0
                d1_c1 = d1 * c1
                if (d0 > d1 and d0_c0 < d1_c1) or \
                        (d0 <= d1 and d0_c0 > d1_c1):
                    k = qd
                    break
            out[i][j] = quant_dist_lookup[k][int(order)]
    return out


def decode_tile_sbrow(t: TaskContext) -> None:
    """reference dav1d_decode_tile_sbrow (src/decode.c:2594)."""
    f = t.f
    ts = t.ts
    root_bl = BlockLevel.BL_128X128 if f.seq_hdr.sb128 else BlockLevel.BL_64X64
    sb_step = f.sb_step
    tile_row, tile_col = ts.tiling_row, ts.tiling_col
    col_sb128_start = f.frame_hdr.tiling.col_start_sb[tile_col] >> \
        (not f.seq_hdr.sb128)

    t.l.reset(f.frame_is_intra)
    t.pal_sz_uv[1].fill(0)
    if f.rf is not None:
        from ..refmvs import RefMvsTile
        t.rt = RefMvsTile(f.rf, ts.col_start, ts.col_end,
                          ts.row_start, ts.row_end)

    if f.frame_hdr.restoration.type != [0, 0, 0] and any(
            f.frame_hdr.restoration.type):
        pass  # restoration info reads land with the LR stage

    a_base = col_sb128_start + tile_row * f.sb128w
    t.bx = ts.col_start
    a_idx = a_base
    while t.bx < ts.col_end:
        t.a = f.a[a_idx]
        sb64x = t.bx >> 4
        sb64y = t.by >> 4
        if root_bl == BlockLevel.BL_128X128:
            t.cur_sb_cdef_idx = _CdefIdxView(f.cdef_idx, sb64y, sb64x)
            for i in range(4):
                t.cur_sb_cdef_idx[i] = -1
        else:
            t.cur_sb_cdef_idx = _CdefIdxView(f.cdef_idx, sb64y, sb64x)
            t.cur_sb_cdef_idx[0] = -1
        _read_lr_for_sb(t)
        decode_sb(t, root_bl, INTRA_EDGE_TREE[0 if f.seq_hdr.sb128 else 1])
        if (t.bx & 16) or f.seq_hdr.sb128:
            a_idx += 1
        t.bx += sb_step

    if t.pass_ != 1:
        _backup_ipred_edge(t)

    # backup left-ctx tx sizes at the tile's right edge for cross-tile lf
    # fixups (reference src/decode.c:2732-2740)
    align_h = (f.bh + 31) & ~31
    tc = ts.tiling_col
    off16 = t.by & 16
    f.tx_lpf_right_edge[0][align_h * tc + t.by :
                           align_h * tc + t.by + f.sb_step] = \
        t.l.tx_lpf_y[off16 : off16 + f.sb_step]
    ss_ver = f.ss_ver
    ah = align_h >> ss_ver
    f.tx_lpf_right_edge[1][ah * tc + (t.by >> ss_ver) :
                           ah * tc + (t.by >> ss_ver)
                           + (f.sb_step >> ss_ver)] = \
        t.l.tx_lpf_uv[off16 >> ss_ver :
                      (off16 >> ss_ver) + (f.sb_step >> ss_ver)]

    if t.ts.msac.cnt <= -15:
        raise ValueError("MSAC overread in tile")


class _CdefIdxView:
    """4-slot view over the per-64x64 cdef index grid for the current
    superblock (layout: idx0..3 = (0,0),(0,1),(1,0),(1,1) in 64x64 units)."""

    def __init__(self, grid, sb64y, sb64x):
        self.grid = grid
        self.y = sb64y
        self.x = sb64x

    def _yx(self, i):
        return self.y + (i >> 1), self.x + (i & 1)

    def __getitem__(self, i):
        y, x = self._yx(i)
        return int(self.grid[y, x])

    def __setitem__(self, i, v):
        y, x = self._yx(i)
        self.grid[y, x] = v


def _read_lr_for_sb(t: TaskContext) -> None:
    """Per-superblock restoration-unit info (reference src/decode.c
    :2662-2713 + read_restoration_info :2519-2592)."""
    f = t.f
    hdr = f.frame_hdr
    if not f.restore_planes:
        return
    sb_step = f.sb_step
    for p in range(3):
        if not ((f.restore_planes >> p) & 1):
            continue
        ss_ver = int(bool(p)) and f.ss_ver
        ss_hor = int(bool(p)) and f.ss_hor
        unit_size_log2 = hdr.restoration.unit_size[int(bool(p))]
        y = t.by * 4 >> ss_ver
        h = (hdr.height + ss_ver) >> ss_ver
        unit_size = 1 << unit_size_log2
        mask = unit_size - 1
        if y & mask:
            continue
        half_unit = unit_size >> 1
        if y and y + half_unit > h:
            continue
        frame_type = hdr.restoration.type[p]
        if hdr.width[0] != hdr.width[1]:
            w = (hdr.width[1] + ss_hor) >> ss_hor
            n_units = max(1, (w + half_unit) >> unit_size_log2)
            d = hdr.super_res_width_scale_denominator
            rnd = unit_size * 8 - 1
            shift = unit_size_log2 + 3
            x0 = ((4 * t.bx * d >> ss_hor) + rnd) >> shift
            x1 = ((4 * (t.bx + sb_step) * d >> ss_hor) + rnd) >> shift
            for x in range(x0, min(x1, n_units)):
                px_x = x << (unit_size_log2 + ss_hor)
                sb_idx = (t.by >> 5) * f.sr_sb128w + (px_x >> 7)
                unit_idx = ((t.by & 16) >> 3) + ((px_x & 64) >> 6)
                _read_restoration_info(t, f.lr_unit(sb_idx, p, unit_idx), p,
                                       frame_type)
        else:
            x = 4 * t.bx >> ss_hor
            if x & mask:
                continue
            w = (hdr.width[0] + ss_hor) >> ss_hor
            if x and x + half_unit > w:
                continue
            sb_idx = (t.by >> 5) * f.sr_sb128w + (t.bx >> 5)
            unit_idx = ((t.by & 16) >> 3) + ((t.bx & 16) >> 4)
            _read_restoration_info(t, f.lr_unit(sb_idx, p, unit_idx), p,
                                   frame_type)


def _read_restoration_info(t, lr, p, frame_type) -> None:
    from ..debug import trace
    from ..headers import RestorationType as RT
    ts = t.ts
    msac = ts.msac
    ref = ts.lr_ref[p]

    if frame_type == RT.SWITCHABLE:
        filt = msac.decode_symbol_adapt(ts.cdf.m.restore_switchable, 2)
        lr["type"] = filt + int(bool(filt))
    else:
        ty = msac.decode_bool_adapt(
            ts.cdf.m.restore_wiener if frame_type == RT.WIENER
            else ts.cdf.m.restore_sgrproj)
        lr["type"] = int(frame_type) if ty else int(RT.NONE)

    if lr["type"] == RT.WIENER:
        lr["filter_v"] = [
            0 if p else msac.decode_subexp(ref["filter_v"][0] + 5, 16, 1) - 5,
            msac.decode_subexp(ref["filter_v"][1] + 23, 32, 2) - 23,
            msac.decode_subexp(ref["filter_v"][2] + 17, 64, 3) - 17]
        lr["filter_h"] = [
            0 if p else msac.decode_subexp(ref["filter_h"][0] + 5, 16, 1) - 5,
            msac.decode_subexp(ref["filter_h"][1] + 23, 32, 2) - 23,
            msac.decode_subexp(ref["filter_h"][2] + 17, 64, 3) - 17]
        lr["sgr_weights"] = list(ref["sgr_weights"])
        ts.lr_ref[p] = lr
        trace("Post-lr_wiener[pl=%d,v[%d,%d,%d],h[%d,%d,%d]]: r=%d",
              p, *lr["filter_v"], *lr["filter_h"], msac.rng)
    elif lr["type"] == RT.SGRPROJ:
        idx = msac.decode_bools(4)
        sgr_params = tables.sgr_params[idx]
        lr["type"] += idx
        lr["sgr_weights"] = [
            msac.decode_subexp(ref["sgr_weights"][0] + 96, 128, 4) - 96
            if sgr_params[0] else 0,
            msac.decode_subexp(ref["sgr_weights"][1] + 32, 128, 4) - 32
            if sgr_params[1] else 95]
        lr["filter_v"] = list(ref["filter_v"])
        lr["filter_h"] = list(ref["filter_h"])
        ts.lr_ref[p] = lr
        trace("Post-lr_sgrproj[pl=%d,idx=%d,w[%d,%d]]: r=%d",
              p, idx, lr["sgr_weights"][0], lr["sgr_weights"][1], msac.rng)


def _backup_ipred_edge(t: TaskContext) -> None:
    """reference dav1d_backup_ipred_edge (src/recon_tmpl.c:2111)."""
    f = t.f
    ts = t.ts
    sby = t.by >> f.sb_shift
    x_off = ts.col_start
    y_row = (t.by + f.sb_step) * 4 - 1
    if y_row < f.planes[0].shape[0]:
        f.ipred_edge[0][sby, x_off * 4 : ts.col_end * 4] = \
            f.planes[0][y_row, x_off * 4 : ts.col_end * 4]
    if f.layout != PixelLayout.I400:
        ss_ver, ss_hor = f.ss_ver, f.ss_hor
        uv_row = ((t.by + f.sb_step) * 4 >> ss_ver) - 1
        if uv_row < f.planes[1].shape[0]:
            for pl in (1, 2):
                f.ipred_edge[pl][sby, x_off * 4 >> ss_hor :
                                 ts.col_end * 4 >> ss_hor] = \
                    f.planes[pl][uv_row, x_off * 4 >> ss_hor :
                                 ts.col_end * 4 >> ss_hor]


def decode_frame(f: FrameContext, tile_groups, two_pass: bool = False) \
        -> None:
    """Frame decode (reference dav1d_decode_frame_main). two_pass splits
    entropy (pass 1, task capture) from reconstruction (pass 2: batched
    device stages + sequential replay) — the reference's frame-threading
    architecture (src/internal.h:276-293), re-expressed for a host/TPU
    split."""
    decode_frame_pass1(f, tile_groups, two_pass)
    decode_frame_finish(f)


def decode_frame_pass1(f: FrameContext, tile_groups,
                       two_pass: bool = False) -> None:
    """Everything whose outputs the NEXT frame's pass 1 needs: the symbol
    decode (capture in two-pass mode, fused pixels otherwise), the CDF
    refresh, segmap/refmvs state — plus the residual stage: every
    inverse transform of the frame in one launch on ``f.device``
    (pipeline._launch_residuals_native).

    Two-pass mode needs the native pass-1 decoder (native/): its capture
    arenas feed the residual launch and the native replay of pass 2.
    With n_threads >= 2 and multiple tiles, the tiles decode on
    concurrent threads (the reference's tile-task parallelism,
    src/thread_task.c TILE_ENTROPY; each tile captures into its own arena
    slice, decode_glue._setup_parallel)."""
    split_tiles(f, tile_groups)
    hdr = f.frame_hdr
    t = TaskContext(f)
    if two_pass:
        f.tasks = []
        t.pass_ = 1

    for a in f.a:
        a.reset(f.frame_is_intra)

    nat = None
    par_cols = 0
    if two_pass:
        from .. import debug
        from ..msac import MsacNative
        from ..native import decode_glue
        if not (decode_glue.available() and not debug.TRACE
                and isinstance(f.ts[0].msac, MsacNative)):
            raise RuntimeError("two-pass decode needs the native pass-1 "
                               "decoder (dav1d_tpu_torch.native)")
        par = (getattr(f, "n_threads", 0) >= 2
               and hdr.tiling.cols * hdr.tiling.rows > 1)
        nat = decode_glue.NativeFrameDecode(
            f, parallel_tiles=f.ts if par else None)
        if par:
            par_cols = hdr.tiling.cols

    from ..refmvs import load_tmvs, save_tmvs

    def _sbrows():
        for tile_row in range(hdr.tiling.rows):
            sbh_end = min(hdr.tiling.row_start_sb[tile_row + 1], f.sbh)
            for sby in range(hdr.tiling.row_start_sb[tile_row], sbh_end):
                by = sby << (4 + f.seq_hdr.sb128)
                yield by, (by + f.sb_step) >> 1

    if par_cols:
        # tile-grid parallel pass 1: serial temporal-MV prologue and
        # epilogue around independent tiles (tiles are entropy-
        # independent; arenas, above contexts and refmvs rows are
        # disjoint per tile)
        if hdr.use_ref_frame_mvs and f.rf is not None:
            for by, by_end in _sbrows():
                load_tmvs(f.rf, 0, f.bw >> 1, by >> 1, by_end)
        tasks = []
        for tile_row in range(hdr.tiling.rows):
            sbh_end = min(hdr.tiling.row_start_sb[tile_row + 1], f.sbh)
            rows = range(hdr.tiling.row_start_sb[tile_row], sbh_end)
            for c in range(hdr.tiling.cols):
                tasks.append((f.ts[tile_row * hdr.tiling.cols + c], rows))
        pool = _tile_pool(min(f.n_threads, len(tasks)))

        def _tile_task(ts, rows):
            tc = TaskContext(f)
            tc.pass_ = t.pass_
            for sby in rows:
                tc.by = sby << (4 + f.seq_hdr.sb128)
                tc.ts = ts
                nat.decode_tile_sbrow(tc)

        futs = [pool.submit(_tile_task, ts, rows) for ts, rows in tasks]
        for fu in futs:
            fu.result()
        if hdr.frame_type.is_inter_or_switch and f.rf is not None:
            for by, by_end in _sbrows():
                save_tmvs(f.rf, 0, f.bw >> 1, by >> 1, by_end)
        nat.finish_parallel()
    else:
        for tile_row in range(hdr.tiling.rows):
            sbh_end = min(hdr.tiling.row_start_sb[tile_row + 1], f.sbh)
            for sby in range(hdr.tiling.row_start_sb[tile_row], sbh_end):
                t.by = sby << (4 + f.seq_hdr.sb128)
                by_end = (t.by + f.sb_step) >> 1
                if hdr.use_ref_frame_mvs and f.rf is not None:
                    load_tmvs(f.rf, 0, f.bw >> 1, t.by >> 1, by_end)
                for tile_col in range(hdr.tiling.cols):
                    t.ts = f.ts[tile_row * hdr.tiling.cols + tile_col]
                    if nat is not None:
                        nat.decode_tile_sbrow(t)
                    else:
                        decode_tile_sbrow(t)
                if hdr.frame_type.is_inter_or_switch and f.rf is not None:
                    save_tmvs(f.rf, 0, f.bw >> 1, t.by >> 1, by_end)

    f._two_pass = two_pass
    f._launched = None
    f._nat = nat  # capture arenas stay live for the native pass-2 replay
    if two_pass:
        # record-free pass 2: the replay drivers walk the capture arenas
        # directly (pipeline.run_pass2)
        nat.finish_lr_units()
        from .. import devrt
        from ..pipeline import _launch_residuals_native
        with devrt.span("pass1.itx"):
            f._launched = _launch_residuals_native(f)

    # CDF refresh is a pass-1 product (the next frame's in_cdf)
    if hdr.refresh_context:
        f.out_cdf.update(f.ts[hdr.tiling.update].cdf,
                         frame_is_intra=f.frame_is_intra)


def decode_frame_finish(f: FrameContext) -> None:
    """Pass 2 (prediction replay + residuals, with the batched MC on
    ``f.device``) and the in-loop filter chain, deblock -> CDEF ->
    super-res -> loop restoration, all on ``f.device``
    (recon/device_chain.py); deferred behind pass 1 of subsequent frames
    when frames are in flight (Settings.max_frame_delay)."""
    from .. import devrt
    from ..recon.device_chain import filter_chain_device

    if f._two_pass:
        from ..pipeline import run_pass2
        with devrt.span("pass2"):
            run_pass2(f, f._launched)
        f._launched = None

    # full-frame filter chain: deblock -> cdef -> super-res -> restoration
    # (the reference pipelines these per sbrow; the full-frame formulation
    # is output-equivalent, see recon/lf.py and recon/cdef.py docstrings)
    with devrt.span("chain"):
        filter_chain_device(f, f.device)

    nat = getattr(f, "_nat", None)
    if nat is not None:
        nat.release()
        f._nat = None

    # per-frame filter state is dead once the chain ran; dropping the
    # references lets the buffer pool reuse the backing memory while
    # the frame itself lives on in the 8-slot ref state
    f.lf_level = f.lf_wd_y = f.lf_wd_uv = None
    f.noskip = f.cdef_idx = None
    f.ipred_edge = None
    f.tx_lpf_right_edge = None
    f.tasks = []


def _cdiv(a, b):
    """C-style truncating integer division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def superres_geometry(f, pl):
    """Per-plane super-res resample geometry (reference step/start
    derivation, src/decode.c:3524-3539): returns
    (out_w, src_w, step, mx0, h, alloc_w)."""
    hdr = f.frame_hdr
    w0, w1 = hdr.width[0], hdr.width[1]
    ss_hor = f.ss_hor if pl else 0
    ss_ver = f.ss_ver if pl else 0
    in_w = (w0 + ss_hor) >> ss_hor
    out_w = (w1 + ss_hor) >> ss_hor
    # the reference clamps reads at the PADDED coded width (4*bw), so
    # edge taps see real decoded padding pixels (recon_tmpl.c:2079)
    src_w = (4 * f.bw + ss_hor) >> ss_hor
    h = (hdr.height + ss_ver) >> ss_ver
    step = ((in_w << 14) + (out_w >> 1)) // out_w
    err = out_w * step - (in_w << 14)
    mx0 = (_cdiv(-((out_w - in_w) << 13) + (out_w >> 1), out_w) + 128
           - _cdiv(err, 2)) & 0x3FFF
    return out_w, src_w, step, mx0, h, (out_w + 127) & ~127
