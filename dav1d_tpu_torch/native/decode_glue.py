"""Glue for the native block-decode layer (native/decode.c).

Builds the DtpuFrameCtx / DtpuTileCtx / DtpuTaskCtx ctypes mirrors from
the Python decode state, drives dtpu_decode_tile_sbrow for pass 1, and
rebuilds the Python replay records (FrameContext.tasks) from the flat
capture arenas.  The Python decode path (decode/tile.py) remains the
reference and the fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import devrt, tables
from . import CMsac, CRefMvsFrame, DtpuCoefCtx, lib as _native

_ptr = ctypes.c_void_p
_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
_u32 = ctypes.c_uint32

CAP_COEF_WORDS = 6

CAP_BLOCK_DT = np.dtype([
    ("bx", "<u2"), ("by", "<u2"),
    ("bs", "u1"), ("bl", "u1"), ("bp", "u1"), ("kind", "u1"),
    ("skip", "u1"), ("skip_mode", "u1"), ("seg_id", "u1"),
    ("edge_flags", "u1"),
    ("y_mode", "u1"), ("uv_mode", "u1"), ("tx", "u1"), ("uvtx", "u1"),
    ("y_angle", "i1"), ("uv_angle", "i1"), ("cfl_alpha", "i1", (2,)),
    ("pal_sz", "u1", (2,)), ("sm_flags", "u1"), ("filter2d", "u1"),
    ("max_ytx", "u1"), ("comp_type", "u1"), ("inter_mode", "u1"),
    ("motion_mode", "u1"),
    ("drl_idx", "u1"), ("interintra_type", "u1"),
    ("interintra_mode", "u1"), ("wedge_idx", "u1"),
    ("mask_sign", "u1"), ("tx_split0", "u1"), ("pad0", "u1"),
    ("pad1", "u1"),
    ("tx_split1", "<u2"), ("pad2", "<u2"),
    ("mv", "<i2", (2, 2)),
    ("warp_idx", "<i4"), ("obmc_start", "<i4"), ("obmc_count", "<i4"),
    ("sub8x8", "<i4"), ("coef_start", "<i4"), ("coef_count", "<i4"),
    ("pal_idx", "<i4"), ("pal_y_off", "<i4"), ("pal_uv_off", "<i4"),
])

CAP_OBMC_DT = np.dtype([
    ("kind", "u1"), ("off", "u1"), ("mv", "<i2", (2,)), ("refidx", "i1"),
    ("f2d", "u1"), ("step4", "u1"), ("pad", "u1"),
])

CAP_WARP_DT = np.dtype([
    ("matrix", "<i4", (6,)), ("abcd", "<i2", (4,)), ("type", "<i4"),
])

LR_UNIT_DT = np.dtype([
    ("type", "<i2"), ("filter_v", "<i2", (3,)), ("filter_h", "<i2", (3,)),
    ("sgr_weights", "<i2", (2,)),
])


class CSegData(ctypes.Structure):
    _fields_ = [("delta_q", _i32), ("delta_lf_y_v", _i32),
                ("delta_lf_y_h", _i32), ("delta_lf_u", _i32),
                ("delta_lf_v", _i32), ("ref", _i32), ("skip", _i32),
                ("globalmv", _i32), ("lossless", _i32), ("qidx", _i32)]


class CFrameCtx(ctypes.Structure):
    _fields_ = [
        ("bw", _i32), ("bh", _i32), ("w4", _i32), ("h4", _i32),
        ("sb128", _i32), ("sb_shift", _i32), ("sb_step", _i32),
        ("sbh", _i32),
        ("b4_stride", _i32), ("layout", _i32), ("ss_hor", _i32),
        ("ss_ver", _i32), ("bitdepth", _i32),
        ("frame_is_inter", _i32), ("frame_is_key_or_intra", _i32),
        ("seg_enabled", _i32), ("seg_update_map", _i32),
        ("seg_temporal", _i32), ("seg_preskip", _i32),
        ("seg_last_active", _i32),
        ("seg_d", CSegData * 8),
        ("skip_mode_enabled", _i32), ("skip_mode_refs", _i32 * 2),
        ("delta_q_present", _i32), ("delta_q_res_log2", _i32),
        ("delta_lf_present", _i32), ("delta_lf_res_log2", _i32),
        ("delta_lf_multi", _i32),
        ("cdef_n_bits", _i32),
        ("allow_intrabc", _i32), ("allow_screen_content_tools", _i32),
        ("switchable_comp_refs", _i32), ("hp", _i32),
        ("force_integer_mv", _i32),
        ("switchable_motion_mode", _i32), ("warp_motion", _i32),
        ("reduced_txtp_set", _i32),
        ("txfm_mode", _i32),
        ("subpel_filter_mode", _i32), ("dual_filter", _i32),
        ("seq_filter_intra", _i32), ("seq_inter_intra", _i32),
        ("seq_masked_compound", _i32),
        ("seq_jnt_comp", _i32), ("order_hint_n_bits", _i32),
        ("frame_offset", _i32),
        ("quant_yac", _i32), ("quant_ydc_d", _i32), ("quant_udc_d", _i32),
        ("quant_uac_d", _i32),
        ("quant_vdc_d", _i32), ("quant_vac_d", _i32),
        ("lf_level_y", _i32 * 2), ("lf_level_u", _i32), ("lf_level_v", _i32),
        ("lf_sharpness", _i32),
        ("lf_mode_ref_delta_enabled", _i32),
        ("lf_mode_deltas", _i32 * 2), ("lf_ref_deltas", _i32 * 8),
        ("loopfilter_any", _i32),
        ("have_prev_segmap", _i32),
        ("svc_scale", _i32 * 7), ("gmv_warp_allowed", _i32 * 7),
        ("jnt_offset", (_i32 * 7) * 7),
        ("refpoc_valid", _i32),
        ("restore_planes", _i32), ("restoration_type", _i32 * 3),
        ("restoration_unit_size", _i32 * 2),
        ("frame_w0", _i32), ("frame_w1", _i32), ("frame_h", _i32),
        ("superres_denom", _i32), ("sr_sb128w", _i32),
        ("lr_units", _ptr),
        ("cur_segmap", _ptr), ("prev_segmap", _ptr),
        ("cur_segmap_stride", _i32), ("prev_segmap_stride", _i32),
        ("noskip", _ptr), ("noskip_stride", _i32),
        ("cdef_idx", _ptr), ("cdef_idx_stride", _i32),
        ("lf_level", _ptr),
        ("lf_mask_buf", _ptr), ("lf_wd_y_plane", _i64),
        ("lf_wd_uv", _ptr), ("lf_wd_uv_plane", _i64),
        ("sb128w", _i32),
        ("dq_tbl", _ptr), ("dq_tbl_hbd", _i32),
        ("qm_tbl", (_ptr * 3) * 19),
        ("cfl_allowed_mask", _u32), ("wedge_allowed_mask", _u32),
        ("interintra_allowed_mask", _u32),
        ("edge_tree", _ptr), ("root_bl", _i32),
        ("block_dim", _ptr), ("txfm_info", _ptr), ("al_part_ctx", _ptr),
        ("block_sizes", _ptr), ("partition_count", _ptr),
        ("ymode_size_ctx", _ptr), ("intra_mode_ctx", _ptr),
        ("max_tx_for_bs", _ptr), ("filter_2d_tbl", _ptr),
        ("comp_inter_modes", _ptr), ("wedge_ctx_lut", _ptr),
        ("filter_mode_to_y", _ptr), ("sgr_params", _ptr),
        ("rf", _ptr),
        ("cap_blocks", _ptr), ("cap_blocks_cap", _i64), ("n_blocks", _i64),
        ("cap_coef_meta", _ptr), ("cap_coef_cap", _i64),
        ("n_coef_meta", _i64),
        ("cf_arena", _ptr), ("cf_arena_cap", _i64), ("cf_used", _i64),
        ("cap_obmc", _ptr), ("cap_obmc_cap", _i64), ("n_obmc", _i64),
        ("cap_warp", _ptr), ("cap_warp_cap", _i64), ("n_warp", _i64),
        ("cap_pal", _ptr), ("cap_pal_cap", _i64), ("n_pal", _i64),
        ("pal_arena", _ptr), ("pal_arena_cap", _i64), ("pal_used", _i64),
        ("error", _i32),
    ]


class CLrRef(ctypes.Structure):
    _fields_ = [("filter_v", ctypes.c_int16 * 3),
                ("filter_h", ctypes.c_int16 * 3),
                ("sgr_weights", ctypes.c_int16 * 2)]


class CTileCtx(ctypes.Structure):
    _fields_ = [
        ("msac", ctypes.POINTER(CMsac)),
        ("coef", ctypes.POINTER(DtpuCoefCtx)),
        *[(n, _ptr) for n in (
            "partition", "seg_pred", "seg_id", "skip_mode", "skip",
            "delta_q", "delta_lf", "intra", "intrabc", "y_mode", "kfym",
            "angle_delta", "uv_mode", "cfl_sign", "cfl_alpha", "pal_y",
            "pal_uv", "pal_sz", "color_map", "use_filter_intra",
            "filter_intra", "txsz", "txpart", "comp", "comp_dir",
            "jnt_comp", "mask_comp", "wedge_comp", "wedge_idx",
            "interintra", "interintra_mode", "interintra_wedge", "ref",
            "comp_fwd_ref", "comp_bwd_ref", "comp_uni_ref",
            "comp_inter_mode", "newmv_mode", "globalmv_mode",
            "refmv_mode", "drl_bit", "motion_mode", "obmc", "filter",
            "restore_wiener", "restore_sgrproj", "restore_switchable",
            "mv_joint")],
        ("mv_classes", _ptr * 2), ("mv_sign", _ptr * 2),
        ("mv_class0", _ptr * 2), ("mv_class0_fp", _ptr * 2),
        ("mv_class0_hp", _ptr * 2), ("mv_classN", _ptr * 2),
        ("mv_classN_fp", _ptr * 2), ("mv_classN_hp", _ptr * 2),
        ("col_start", _i32), ("col_end", _i32), ("row_start", _i32),
        ("row_end", _i32),
        ("tiling_row", _i32), ("tiling_col", _i32),
        ("last_qidx", _i32), ("last_delta_lf", _i32 * 4),
        ("dq", ((ctypes.c_uint16 * 2) * 3) * 8),
        ("lflvl", (((ctypes.c_uint8 * 2) * 8) * 4) * 8),
        ("lr_ref", CLrRef * 3),
    ]


class CCapWarp(ctypes.Structure):
    _fields_ = [("matrix", _i32 * 6), ("abcd", ctypes.c_int16 * 4),
                ("type", _i32)]


class CTaskCtx(ctypes.Structure):
    _fields_ = [
        ("f", _ptr), ("ts", _ptr),
        ("bx", _i32), ("by", _i32),
        ("a_list", _ptr), ("a_base", _i32), ("a", _ptr), ("l", _ptr),
        ("al_pal", _ptr), ("pal_sz_uv", _ptr),
        ("tl_4x4_filter", _i32),
        ("txtp_map", (ctypes.c_uint8 * 32) * 32),
        ("scratch_pal", (ctypes.c_uint16 * 8) * 3),
        ("sb_cdef64_y", _i32), ("sb_cdef64_x", _i32),
        ("lf_idx", _i32),
        ("cur_warp_valid", _i32), ("cur_warp", CCapWarp),
        ("pal_y_off", _i32), ("pal_uv_off", _i32),
    ]


_abi_checked = False


def _check_abi():
    global _abi_checked
    if _abi_checked:
        return
    sizes = (ctypes.c_int64 * 8)()
    _native.dtpu_abi_sizes(ctypes.byref(sizes))
    assert sizes[0] == CAP_BLOCK_DT.itemsize, (sizes[0],
                                               CAP_BLOCK_DT.itemsize)
    assert sizes[1] == CAP_OBMC_DT.itemsize
    assert sizes[2] == CAP_WARP_DT.itemsize
    assert sizes[3] == ctypes.sizeof(CFrameCtx), (sizes[3],
                                                  ctypes.sizeof(CFrameCtx))
    assert sizes[4] == ctypes.sizeof(CTileCtx), (sizes[4],
                                                 ctypes.sizeof(CTileCtx))
    assert sizes[5] == ctypes.sizeof(CTaskCtx), (sizes[5],
                                                 ctypes.sizeof(CTaskCtx))
    assert sizes[7] == ctypes.sizeof(CRefMvsFrame)
    _abi_checked = True


# ---- intra-edge tree flattening -------------------------------------------


_edge_flat = {}


def _flatten_edge_tree(sb128: bool) -> np.ndarray:
    key = bool(sb128)
    arr = _edge_flat.get(key)
    if arr is not None:
        return arr
    from ..intra_edge import INTRA_EDGE_TREE

    root = INTRA_EDGE_TREE[0 if sb128 else 1]
    nodes = []
    index = {}

    def walk(n):
        if id(n) in index:
            return index[id(n)]
        idx = len(nodes)
        index[id(n)] = idx
        nodes.append(None)  # reserve
        split = []
        for c in n.split:
            if isinstance(c, int):
                split.append(int(c))
            else:
                split.append(walk(c))
        while len(split) < 4:
            split.append(0)
        nodes[idx] = (int(n.o), int(n.h[0]), int(n.h[1]), int(n.v[0]),
                      int(n.v[1]), int(n.h4), int(n.v4), *split)
        return idx

    walk(root)
    arr = np.array(nodes, dtype=np.int32)
    _edge_flat[key] = arr
    return arr


# ---- frame/tile/task builders ---------------------------------------------


class CReplayCtx(ctypes.Structure):
    """Mirror of native/dtpu.h DtpuReplayCtx (field order must match)."""
    _fields_ = [
        ("planes", _ptr * 3), ("stride", _i64 * 3),
        ("bw", _i32), ("bh", _i32),
        ("ss_hor", _i32), ("ss_ver", _i32), ("layout", _i32),
        ("bitdepth", _i32), ("intra_edge_filter", _i32),
        ("resid_elsz", _i32),
        ("cap_blocks", _ptr), ("coef_meta", _ptr), ("resid_ptrs", _ptr),
        ("cap_pal", _ptr), ("pal_arena", _ptr),
        ("tile_of_block", _ptr), ("tile_bounds", _ptr),
        ("block_dim", _ptr), ("txfm_info", _ptr),
        ("sm_weights", _ptr), ("dr_deriv", _ptr), ("filter_taps", _ptr),
    ]


class CInterCtx(ctypes.Structure):
    """Mirror of native/dtpu.h DtpuInterCtx (field order must match)."""
    _fields_ = [
        ("ref_planes", (_ptr * 3) * 7), ("ref_stride", (_i64 * 3) * 7),
        ("ref_w", _i32 * 7), ("ref_h", _i32 * 7), ("ref_ok", _i32 * 7),
        ("gmv_type", _i32 * 7), ("gmv_matrix", (_i32 * 6) * 7),
        ("gmv_abcd", (_i32 * 4) * 7), ("gmv_warp_allowed", _i32 * 7),
        ("jnt_weights", (_i32 * 7) * 7),
        ("rb", _ptr), ("rb_stride", _i64),
        ("cap_obmc", _ptr), ("cap_warp", _ptr),
        ("subpel_filters", _ptr), ("obmc_masks", _ptr),
        ("masks_blob", _ptr), ("mask_offsets", _ptr),
        ("warp_filter", _ptr),
    ]


_INTER_TABLES = None


def _inter_tables():
    """Contiguous typed copies of the MC/compound tables the native inter
    replay reads (cached for the process)."""
    global _INTER_TABLES
    if _INTER_TABLES is None:
        _INTER_TABLES = (
            np.ascontiguousarray(tables.mc_subpel_filters, dtype=np.int8),
            np.ascontiguousarray(tables.obmc_masks, dtype=np.uint8),
            np.ascontiguousarray(tables._get("masks.blob"), dtype=np.uint8),
            np.ascontiguousarray(tables.mask_offsets(), dtype=np.uint16),
            np.ascontiguousarray(tables.mc_warp_filter, dtype=np.int64),
        )
    return _INTER_TABLES


def _np_ptr(a):
    return a.ctypes.data if a is not None else None


_ARENA_POOL: dict = {}  # (name, shape) -> [ndarray, ...]

# concurrent reconstruction workers (decoder n_fc pool) release and
# acquire arenas from different threads; compound get-check-pop /
# stats updates need the lock (list.append alone would be GIL-atomic,
# the read-modify-write sequences are not)
import threading as _threading

_POOL_LOCK = _threading.Lock()

# process-wide allocation accounting per category (the reference's
# TRACK_HEAP_ALLOCATIONS analog, src/mem.c:52-101): [allocs, reuses,
# cur_bytes, peak_bytes], read via dav1d_tpu.decoder.memory_stats()
ALLOC_STATS: dict = {}


def _stat_alloc(name, nbytes, reuse):
    st = ALLOC_STATS.setdefault(name, [0, 0, 0, 0])
    if reuse:
        st[1] += 1
    else:
        st[0] += 1
        st[2] += nbytes
        st[3] = max(st[3], st[2])


def _pool_get(name, shape, dtype):
    with _POOL_LOCK:
        lst = _ARENA_POOL.get((name, shape if isinstance(shape, tuple)
                               else (shape,)))
        if lst:
            _stat_alloc(name, 0, reuse=True)
            return lst.pop()
        _stat_alloc(name, int(np.prod(shape)) * np.dtype(dtype).itemsize,
                    reuse=False)
    return np.zeros(shape, dtype=dtype)


def _pool_put(name, arr, used):
    """Return an arena to the pool, re-zeroing the [start, end) ranges
    in ``used`` that the frame wrote, so that every pooled arena reads
    all-zero.  Two kinds of users rely on that: a reused coefficient
    slot must read 0 beyond the nonzero scan positions decode_coefs
    stores, and in a tile-sliced frame the dense consumers of the block
    arena (the device-MC batcher) scan [0:n_blocks] and read the gap
    records between the slices as zero.  The other arenas are written
    whole per record (cap_block_begin memsets, emit_coef/obmc/warp/pal
    write every field, read_pal_indices memsets its own slice) and are
    cleared alike, so no user has to know which frame, sliced or not,
    held an arena last.  The gaps themselves are never written: the
    frame's used ranges (NativeFrameDecode.used_ranges) are all there
    is to clear."""
    for s, e in used:
        arr[s:e] = 0
    with _POOL_LOCK:
        _ARENA_POOL.setdefault((name, arr.shape), []).append(arr)


# the capture arenas: (pool name, NativeFrameDecode attribute, CFrameCtx
# cursor), in the order of the slice starts a tile-sliced frame keeps
# per tile (NativeFrameDecode.tile_fctx)
_ARENAS = (("blocks", "cap_blocks", "n_blocks"),
           ("coef_meta", "cap_coef_meta", "n_coef_meta"),
           ("cf", "cf_arena", "cf_used"),
           ("obmc", "cap_obmc", "n_obmc"),
           ("warp", "cap_warp", "n_warp"),
           ("pal", "cap_pal", "n_pal"),
           ("pal_arena", "pal_arena", "pal_used"))
_CURSORS = tuple(cur for _, _, cur in _ARENAS)


class NativeFrameDecode:
    """Per-frame native pass-1 state: ctypes mirrors + capture arenas."""

    def __init__(self, f, parallel_tiles=None):
        """parallel_tiles: list of TileStates (decode order) to give
        each tile its own disjoint capture-arena slice so tile columns
        of an sbrow can decode on concurrent threads (SURVEY §2.7 tile
        data-parallelism on the host); None = shared-cursor serial."""
        _check_abi()
        from ..obu import get_poc_diff
        from ..refmvs import _nat_frame

        hdr = f.frame_hdr
        seq = f.seq_hdr
        self.f = f
        c = self.c = CFrameCtx()
        keep = self.keep = []
        self.parallel = bool(parallel_tiles)

        c.bw, c.bh, c.w4, c.h4 = f.bw, f.bh, f.w4, f.h4
        c.sb128 = int(seq.sb128)
        c.sb_shift, c.sb_step, c.sbh = f.sb_shift, f.sb_step, f.sbh
        c.b4_stride = f.b4_stride
        c.layout = int(f.layout)
        c.ss_hor, c.ss_ver = f.ss_hor, f.ss_ver
        c.bitdepth = f.bitdepth
        c.frame_is_inter = int(hdr.frame_type.is_inter_or_switch)
        c.frame_is_key_or_intra = int(hdr.frame_type.is_key_or_intra)

        segd = hdr.segmentation
        c.seg_enabled = int(segd.enabled)
        c.seg_update_map = int(segd.update_map)
        c.seg_temporal = int(segd.temporal)
        c.seg_preskip = int(segd.seg_data.preskip)
        c.seg_last_active = int(segd.seg_data.last_active_segid)
        for i in range(8):
            d = segd.seg_data.d[i]
            s = c.seg_d[i]
            s.delta_q = int(d.delta_q)
            s.delta_lf_y_v = int(d.delta_lf_y_v)
            s.delta_lf_y_h = int(d.delta_lf_y_h)
            s.delta_lf_u = int(d.delta_lf_u)
            s.delta_lf_v = int(d.delta_lf_v)
            s.ref = int(d.ref)
            s.skip = int(d.skip)
            s.globalmv = int(d.globalmv)
            s.lossless = int(segd.lossless[i])
            s.qidx = int(segd.qidx[i])

        c.skip_mode_enabled = int(hdr.skip_mode_enabled)
        c.skip_mode_refs[0] = int(hdr.skip_mode_refs[0])
        c.skip_mode_refs[1] = int(hdr.skip_mode_refs[1])
        c.delta_q_present = int(hdr.delta.q_present)
        c.delta_q_res_log2 = int(hdr.delta.q_res_log2)
        c.delta_lf_present = int(hdr.delta.lf_present)
        c.delta_lf_res_log2 = int(hdr.delta.lf_res_log2)
        c.delta_lf_multi = int(hdr.delta.lf_multi)
        c.cdef_n_bits = int(hdr.cdef.n_bits)
        c.allow_intrabc = int(hdr.allow_intrabc)
        c.allow_screen_content_tools = int(hdr.allow_screen_content_tools)
        c.switchable_comp_refs = int(hdr.switchable_comp_refs)
        c.hp = int(hdr.hp)
        c.force_integer_mv = int(hdr.force_integer_mv)
        c.switchable_motion_mode = int(hdr.switchable_motion_mode)
        c.warp_motion = int(hdr.warp_motion)
        c.reduced_txtp_set = int(hdr.reduced_txtp_set)
        c.txfm_mode = int(hdr.txfm_mode)
        c.subpel_filter_mode = int(hdr.subpel_filter_mode)
        c.dual_filter = int(seq.dual_filter)
        c.seq_filter_intra = int(seq.filter_intra)
        c.seq_inter_intra = int(seq.inter_intra)
        c.seq_masked_compound = int(seq.masked_compound)
        c.seq_jnt_comp = int(seq.jnt_comp)
        c.order_hint_n_bits = int(seq.order_hint_n_bits)
        c.frame_offset = int(hdr.frame_offset)
        q = hdr.quant
        c.quant_yac = int(q.yac)
        c.quant_ydc_d = int(q.ydc_delta)
        c.quant_udc_d = int(q.udc_delta)
        c.quant_uac_d = int(q.uac_delta)
        c.quant_vdc_d = int(q.vdc_delta)
        c.quant_vac_d = int(q.vac_delta)
        lf = hdr.loopfilter
        c.lf_level_y[0] = int(lf.level_y[0])
        c.lf_level_y[1] = int(lf.level_y[1])
        c.lf_level_u = int(lf.level_u)
        c.lf_level_v = int(lf.level_v)
        c.lf_sharpness = int(lf.sharpness)
        c.lf_mode_ref_delta_enabled = int(lf.mode_ref_delta_enabled)
        for i in range(2):
            c.lf_mode_deltas[i] = int(lf.mode_ref_deltas.mode_delta[i])
        for i in range(8):
            c.lf_ref_deltas[i] = int(lf.mode_ref_deltas.ref_delta[i])
        c.loopfilter_any = int(bool(lf.level_y[0] or lf.level_y[1]))
        c.have_prev_segmap = int(f.prev_segmap is not None)
        for i in range(7):
            c.svc_scale[i] = int(f.svc_scale[i])
            c.gmv_warp_allowed[i] = int(f.gmv_warp_allowed[i])
        if c.frame_is_inter and f.refs[0] is not None:
            poc = hdr.frame_offset
            nb = seq.order_hint_n_bits
            for i in range(7):
                for j in range(7):
                    ri = f.refs[i]
                    rj = f.refs[j]
                    if ri is None or rj is None or ri.frame_hdr is None \
                            or rj.frame_hdr is None:
                        continue
                    d0 = abs(get_poc_diff(nb, ri.frame_hdr.frame_offset,
                                          poc))
                    d1 = abs(get_poc_diff(nb, poc,
                                          rj.frame_hdr.frame_offset))
                    c.jnt_offset[i][j] = 3 * int(d0 == d1)
        c.refpoc_valid = int(c.frame_is_inter)

        c.restore_planes = int(f.restore_planes)
        for i in range(3):
            c.restoration_type[i] = int(hdr.restoration.type[i])
        c.restoration_unit_size[0] = int(hdr.restoration.unit_size[0])
        c.restoration_unit_size[1] = int(hdr.restoration.unit_size[1])
        c.frame_w0 = int(hdr.width[0])
        c.frame_w1 = int(hdr.width[1])
        c.frame_h = int(hdr.height)
        c.superres_denom = int(hdr.super_res_width_scale_denominator
                               if hdr.width[0] != hdr.width[1] else 0)
        c.sr_sb128w = f.sr_sb128w
        self.lr_units = np.zeros((f.sb128h * f.sr_sb128w, 3, 4),
                                 dtype=LR_UNIT_DT)
        c.lr_units = _np_ptr(self.lr_units)

        c.cur_segmap = _np_ptr(f.cur_segmap)
        c.cur_segmap_stride = f.cur_segmap.shape[1] \
            if f.cur_segmap is not None else 0
        prev = f.prev_segmap
        if prev is not None and not prev.flags.c_contiguous:
            prev = np.ascontiguousarray(prev)
            keep.append(prev)
        c.prev_segmap = _np_ptr(prev)
        c.prev_segmap_stride = prev.shape[1] if prev is not None else 0
        c.noskip = f.noskip.ctypes.data
        c.noskip_stride = f.noskip.shape[1]
        c.cdef_idx = f.cdef_idx.ctypes.data
        c.cdef_idx_stride = f.cdef_idx.shape[1]
        c.lf_level = f.lf_level.ctypes.data
        c.lf_mask_buf = f.lf_wd_y.ctypes.data
        c.lf_wd_y_plane = f.lf_wd_y.shape[1] * f.lf_wd_y.shape[2]
        c.lf_wd_uv = f.lf_wd_uv.ctypes.data
        c.lf_wd_uv_plane = f.lf_wd_uv.shape[1] * f.lf_wd_uv.shape[2]
        # the C builders index chroma planes with stride
        # (b4_stride + ss_hor) >> ss_hor; assert the allocation matches
        assert f.lf_wd_uv.shape[2] == (f.b4_stride + f.ss_hor) >> f.ss_hor
        c.sb128w = f.sb128w

        dq_tbl = np.ascontiguousarray(tables.dq_tbl[seq.hbd])
        keep.append(dq_tbl)
        c.dq_tbl = dq_tbl.ctypes.data
        c.dq_tbl_hbd = int(seq.hbd)
        for tx in range(19):
            for pl in range(3):
                qm = f.qm.get((tx, pl))
                if qm is not None:
                    if qm.dtype != np.uint8:
                        qm = qm.astype(np.uint8)
                        f.qm[(tx, pl)] = qm
                    c.qm_tbl[tx][pl] = qm.ctypes.data
                else:
                    c.qm_tbl[tx][pl] = None

        from ..levels import (CFL_ALLOWED_MASK, INTERINTRA_ALLOWED_MASK,
                              WEDGE_ALLOWED_MASK)
        c.cfl_allowed_mask = CFL_ALLOWED_MASK
        c.wedge_allowed_mask = WEDGE_ALLOWED_MASK
        c.interintra_allowed_mask = INTERINTRA_ALLOWED_MASK

        edge = _flatten_edge_tree(seq.sb128)
        c.edge_tree = edge.ctypes.data
        c.root_bl = 0 if seq.sb128 else 1

        ti = tables.txfm_info()
        statics = dict(
            block_dim=tables.block_dimensions, txfm_info=ti,
            al_part_ctx=tables.al_part_ctx, block_sizes=tables.block_sizes,
            partition_count=tables.partition_type_count,
            ymode_size_ctx=tables.ymode_size_context,
            intra_mode_ctx=tables.intra_mode_context,
            max_tx_for_bs=tables.max_txfm_size_for_bs,
            filter_2d_tbl=tables.filter_2d,
            comp_inter_modes=tables.comp_inter_pred_modes,
            wedge_ctx_lut=tables.wedge_ctx_lut,
            filter_mode_to_y=tables.filter_mode_to_y_mode,
            sgr_params=tables.sgr_params)
        for name, arr in statics.items():
            assert arr.flags.c_contiguous
            keep.append(arr)
            setattr(c, name, arr.ctypes.data)

        if f.rf is not None:
            nat_rf = _nat_frame(f.rf)
            if nat_rf is None:
                raise RuntimeError("native refmvs unavailable")
            c.rf = ctypes.cast(ctypes.byref(nat_rf), _ptr)
            keep.append(nat_rf)
        else:
            c.rf = None

        # capture arenas (exact worst-case bounds), drawn from the
        # process-wide recycling pool: a released frame re-zeroes only
        # the ranges it actually used, so steady-state decode does no
        # multi-MB allocation or full-arena zeroing
        n_cells = f.bw * f.bh
        n_px = 16 * n_cells
        chroma_px = 0 if f.layout == 0 else \
            2 * ((n_px >> (f.ss_hor + f.ss_ver)) + 4 * f.bw + 4 * f.bh)
        # per-tile slicing inflates every arena by the per-tile margins
        # (each slice carries its own rounding/overshoot headroom)
        n_t = len(parallel_tiles) if parallel_tiles else 1
        marg = 64 * n_t
        cf_marg = (4096 + 8 * (f.bw + f.bh)) * n_t
        self.cap_blocks = _pool_get("blocks", n_cells + marg, CAP_BLOCK_DT)
        self.cap_coef_meta = _pool_get(
            "coef_meta", (3 * n_cells + marg, CAP_COEF_WORDS), np.int32)
        self.cf_arena = _pool_get("cf", n_px + chroma_px + cf_marg,
                                  np.int32)
        self.cap_obmc = _pool_get("obmc", 8 * n_cells + marg, CAP_OBMC_DT)
        self.cap_warp = _pool_get("warp", n_cells + marg, CAP_WARP_DT)
        self.cap_pal = _pool_get("pal", (n_cells // 4 + marg, 3, 8),
                                 np.uint16)
        self.pal_arena = _pool_get("pal_arena",
                                   n_px + (chroma_px or 1) + cf_marg,
                                   np.uint8)
        c.cap_blocks = _np_ptr(self.cap_blocks)
        c.cap_blocks_cap = len(self.cap_blocks)
        c.cap_coef_meta = _np_ptr(self.cap_coef_meta)
        c.cap_coef_cap = len(self.cap_coef_meta)
        c.cf_arena = _np_ptr(self.cf_arena)
        c.cf_arena_cap = len(self.cf_arena)
        c.cap_obmc = _np_ptr(self.cap_obmc)
        c.cap_obmc_cap = len(self.cap_obmc)
        c.cap_warp = _np_ptr(self.cap_warp)
        c.cap_warp_cap = len(self.cap_warp)
        c.cap_pal = _np_ptr(self.cap_pal)
        c.cap_pal_cap = len(self.cap_pal)
        c.pal_arena = _np_ptr(self.pal_arena)
        c.pal_arena_cap = len(self.pal_arena)
        c.error = 0

        # above-context pointer list (f.a BlockContext buffers)
        self.a_ptrs = (ctypes.c_void_p * len(f.a))(
            *[a.buf.ctypes.data for a in f.a])

        self.tiles = {}   # id(ts) -> (CTileCtx, CTaskCtx keepalive...)
        self.block_tile = []  # (n_blocks_after, ts)
        self.tile_fctx = {}   # parallel mode: id(ts) -> CFrameCtx clone
        self.tile_order = None
        if parallel_tiles:
            self._setup_parallel(parallel_tiles)

    def _setup_parallel(self, tiles):
        """Slice every capture arena into disjoint per-tile ranges and
        clone CFrameCtx per tile with cursors pre-set to its slice start
        and caps to its slice end — recorded indices stay ABSOLUTE, so
        the replay/pipeline consumers read the shared arenas unchanged.
        The gap between a tile's used prefix and the next slice is
        never written and stays zero; consumers read only the used
        ranges (:meth:`used_ranges`)."""
        f = self.f
        self.tile_order = list(tiles)
        chroma = f.layout != 0
        ss = f.ss_hor + f.ss_ver
        cur = dict(blocks=0, coef=0, cf=0, obmc=0, warp=0, pal=0, pala=0)
        for ts in tiles:
            cells = (ts.col_end - ts.col_start) * \
                (ts.row_end - ts.row_start)
            px = 16 * cells
            cpx = (2 * (px >> ss)) if chroma else 0
            fc = CFrameCtx()
            ctypes.memmove(ctypes.byref(fc), ctypes.byref(self.c),
                           ctypes.sizeof(CFrameCtx))
            caps = dict(blocks=cells + 64, coef=3 * cells + 64,
                        cf=px + cpx + 4096 + 8 * (f.bw + f.bh),
                        obmc=8 * cells + 64, warp=cells + 64,
                        pal=cells // 4 + 64,
                        pala=px + cpx + 4096)
            fc.n_blocks = cur["blocks"]
            fc.cap_blocks_cap = cur["blocks"] = \
                cur["blocks"] + caps["blocks"]
            fc.n_coef_meta = cur["coef"]
            fc.cap_coef_cap = cur["coef"] = cur["coef"] + caps["coef"]
            fc.cf_used = cur["cf"]
            fc.cf_arena_cap = cur["cf"] = cur["cf"] + caps["cf"]
            fc.n_obmc = cur["obmc"]
            fc.cap_obmc_cap = cur["obmc"] = cur["obmc"] + caps["obmc"]
            fc.n_warp = cur["warp"]
            fc.cap_warp_cap = cur["warp"] = cur["warp"] + caps["warp"]
            fc.n_pal = cur["pal"]
            fc.cap_pal_cap = cur["pal"] = cur["pal"] + caps["pal"]
            fc.pal_used = cur["pala"]
            fc.pal_arena_cap = cur["pala"] = cur["pala"] + caps["pala"]
            self.tile_fctx[id(ts)] = \
                (fc, *(getattr(fc, cur) for cur in _CURSORS))
        assert cur["blocks"] <= len(self.cap_blocks)
        assert cur["coef"] <= len(self.cap_coef_meta)
        assert cur["cf"] <= len(self.cf_arena)
        assert cur["obmc"] <= len(self.cap_obmc)
        assert cur["warp"] <= len(self.cap_warp)
        assert cur["pal"] <= len(self.cap_pal)
        assert cur["pala"] <= len(self.pal_arena)

    def finish_parallel(self):
        """Merge per-tile cursors back into the shared ctx.  Each becomes
        the end of the furthest used slice: the length of the absolute
        index space that consumers size their per-row tables by
        (meta_rows, cap_blocks[:n_blocks]).  Not all of it was used:
        between one tile's used end and the next tile's slice start lies
        a gap, never written and zero, which :meth:`used_ranges` leaves
        out for the residual launcher, the replay walks and release."""
        c = self.c
        err = 0
        for ts in self.tile_order:
            fc = self.tile_fctx[id(ts)][0]
            err |= fc.error
            for cur in _CURSORS:
                setattr(c, cur, max(getattr(c, cur), getattr(fc, cur)))
        c.error |= err

    def used_ranges(self, cursor):
        """The used [start, end) ranges, in decode order, of the arena
        whose CFrameCtx cursor is ``cursor`` (``"n_blocks"``,
        ``"n_coef_meta"``, ``"cf_used"``, ...): one per tile in a
        tile-sliced frame, whose slices leave zeroed gaps no consumer
        may take for records; otherwise the single dense prefix."""
        if not self.tile_order:
            return [(0, int(getattr(self.c, cursor)))]
        k = 1 + _CURSORS.index(cursor)
        return [(int(ent[k]), int(getattr(ent[0], cursor)))
                for ent in (self.tile_fctx[id(ts)]
                            for ts in self.tile_order)]

    def tile_ctx(self, ts):
        ent = self.tiles.get(id(ts))
        if ent is not None:
            return ent
        from ..recon.coef import _make_coef_ctx

        f = self.f
        t = CTileCtx()
        cdf = ts.cdf
        m = cdf.m
        coef_cx = _make_coef_ctx(ts, f)
        msac_ref = ctypes.byref(ts.msac.s)
        t.msac = ctypes.cast(msac_ref, ctypes.POINTER(CMsac))
        coef_ref = ctypes.byref(coef_cx)
        t.coef = ctypes.cast(coef_ref, ctypes.POINTER(DtpuCoefCtx))

        shapes = {
            "partition": (5, 4, 16), "seg_pred": (3, 2), "seg_id": (3, 8),
            "skip_mode": (3, 2), "skip": (3, 2), "delta_q": (4,),
            "delta_lf": (5, 4), "intra": (4, 2), "intrabc": (2,),
            "y_mode": (4, 16), "angle_delta": (8, 8),
            "uv_mode": (2, 13, 16), "cfl_sign": (8,),
            "cfl_alpha": (6, 16), "pal_y": (7, 3, 2), "pal_uv": (2, 2),
            "pal_sz": (2, 7, 8), "color_map": (2, 7, 5, 8),
            "use_filter_intra": (22, 2), "filter_intra": (8,),
            "txsz": (4, 3, 4), "txpart": (7, 3, 2), "comp": (5, 2),
            "comp_dir": (5, 2), "jnt_comp": (6, 2), "mask_comp": (6, 2),
            "wedge_comp": (9, 2), "wedge_idx": (9, 16),
            "interintra": (7, 2), "interintra_mode": (4, 4),
            "interintra_wedge": (7, 2), "ref": (6, 3, 2),
            "comp_fwd_ref": (3, 3, 2), "comp_bwd_ref": (2, 3, 2),
            "comp_uni_ref": (3, 3, 2), "comp_inter_mode": (8, 8),
            "newmv_mode": (6, 2), "globalmv_mode": (2, 2),
            "refmv_mode": (6, 2), "drl_bit": (3, 2),
            "motion_mode": (22, 4), "obmc": (22, 2), "filter": (2, 8, 4),
            "restore_wiener": (2,), "restore_sgrproj": (2,),
            "restore_switchable": (4,),
        }
        for name, shape in shapes.items():
            arr = getattr(m, name)
            assert arr.shape == shape and arr.flags.c_contiguous, name
            setattr(t, name, arr.ctypes.data)
        t.kfym = cdf.kfym.ctypes.data
        assert cdf.kfym.shape == (5, 5, 16)
        t.mv_joint = cdf.mv_joint.ctypes.data
        for comp in range(2):
            mv = cdf.mv[comp]
            t.mv_classes[comp] = mv.classes.ctypes.data
            t.mv_sign[comp] = mv.sign.ctypes.data
            t.mv_class0[comp] = mv.class0.ctypes.data
            t.mv_class0_fp[comp] = mv.class0_fp.ctypes.data
            t.mv_class0_hp[comp] = mv.class0_hp.ctypes.data
            t.mv_classN[comp] = mv.classN.ctypes.data
            t.mv_classN_fp[comp] = mv.classN_fp.ctypes.data
            t.mv_classN_hp[comp] = mv.classN_hp.ctypes.data

        t.col_start, t.col_end = ts.col_start, ts.col_end
        t.row_start, t.row_end = ts.row_start, ts.row_end
        t.tiling_row, t.tiling_col = ts.tiling_row, ts.tiling_col
        t.last_qidx = ts.last_qidx
        for i in range(4):
            t.last_delta_lf[i] = ts.last_delta_lf[i]
        # initial dq / lflvl value copies
        dq = np.ascontiguousarray(f.dq, dtype=np.uint16)
        ctypes.memmove(t.dq, dq.ctypes.data, 8 * 3 * 2 * 2)
        lflvl = np.ascontiguousarray(f.lf_lvl, dtype=np.uint8)
        ctypes.memmove(t.lflvl, lflvl.ctypes.data, 8 * 4 * 8 * 2)
        for p in range(3):
            r = ts.lr_ref[p]
            for i in range(3):
                t.lr_ref[p].filter_v[i] = r["filter_v"][i]
                t.lr_ref[p].filter_h[i] = r["filter_h"][i]
            t.lr_ref[p].sgr_weights[0] = r["sgr_weights"][0]
            t.lr_ref[p].sgr_weights[1] = r["sgr_weights"][1]

        ent = (t, coef_cx, msac_ref, coef_ref, cdf)
        self.tiles[id(ts)] = ent
        return ent

    def decode_tile_sbrow(self, t) -> None:
        """Native replacement for decode/frame.py decode_tile_sbrow in
        pass 1 (tile symbol decode + capture)."""
        f = self.f
        ts = t.ts
        hdr = f.frame_hdr
        ct, *_ = self.tile_ctx(ts)

        # per-tile-sbrow resets (decode_tile_sbrow preamble)
        t.l.reset(f.frame_is_intra)
        t.pal_sz_uv[1].fill(0)

        fctx = self.tile_fctx[id(ts)][0] if self.parallel else self.c
        ctask = CTaskCtx()
        ctask.f = ctypes.cast(ctypes.byref(fctx), _ptr)
        ctask.ts = ctypes.cast(ctypes.byref(ct), _ptr)
        ctask.by = t.by
        ctask.bx = ts.col_start
        ctask.a_list = ctypes.cast(self.a_ptrs, _ptr)
        col_sb128_start = hdr.tiling.col_start_sb[ts.tiling_col] >> \
            (not f.seq_hdr.sb128)
        ctask.a_base = col_sb128_start + ts.tiling_row * f.sb128w
        ctask.l = t.l.buf.ctypes.data
        ctask.al_pal = t.al_pal.ctypes.data
        ctask.pal_sz_uv = t.pal_sz_uv.ctypes.data
        ctask.tl_4x4_filter = t.tl_4x4_filter

        err = _native.dtpu_decode_tile_sbrow(
            ctypes.byref(fctx), ctypes.byref(ct), ctypes.byref(ctask))
        t.tl_4x4_filter = ctask.tl_4x4_filter
        if err:
            raise ValueError(
                "native pass-1 decode error %d (tile %d,%d sbrow at by=%d)"
                % (err, ts.tiling_row, ts.tiling_col, t.by))

        # cross-tile lf fixup state (decode/frame.py:355-370): the C wrote
        # the l-ctx through the shared buffer, copy its right edge
        align_h = (f.bh + 31) & ~31
        tc = ts.tiling_col
        off16 = t.by & 16
        f.tx_lpf_right_edge[0][align_h * tc + t.by:
                               align_h * tc + t.by + f.sb_step] = \
            t.l.tx_lpf_y[off16: off16 + f.sb_step]
        ss_ver = f.ss_ver
        ah = align_h >> ss_ver
        f.tx_lpf_right_edge[1][ah * tc + (t.by >> ss_ver):
                               ah * tc + (t.by >> ss_ver)
                               + (f.sb_step >> ss_ver)] = \
            t.l.tx_lpf_uv[off16 >> ss_ver:
                          (off16 >> ss_ver) + (f.sb_step >> ss_ver)]

        if not self.parallel:
            self.block_tile.append((int(self.c.n_blocks), ts))

    def build_replay_ctx(self, resid_ptrs, resid_elsz):
        """DtpuReplayCtx for the native pass-2 intra replay (replay.c):
        plane pointers + the still-live capture arenas + per-meta-row
        residual pointers from the batched itx stage."""
        f = self.f
        rc = CReplayCtx()
        for pl, p in enumerate(f.planes):
            rc.planes[pl] = p.ctypes.data
            rc.stride[pl] = p.shape[1]
        rc.bw, rc.bh = f.bw, f.bh
        rc.ss_hor, rc.ss_ver = f.ss_hor, f.ss_ver
        rc.layout = int(f.layout)
        rc.bitdepth = f.bitdepth
        rc.intra_edge_filter = int(f.seq_hdr.intra_edge_filter)
        rc.resid_elsz = resid_elsz
        rc.cap_blocks = _np_ptr(self.cap_blocks)
        rc.coef_meta = _np_ptr(self.cap_coef_meta)
        rc.resid_ptrs = _np_ptr(resid_ptrs)
        rc.cap_pal = _np_ptr(self.cap_pal)
        rc.pal_arena = _np_ptr(self.pal_arena)

        # per-block tile index + tile bounds (block_tile holds the block
        # count AFTER each sbrow call and its TileState)
        n = int(self.c.n_blocks)
        tile_of_block = np.full(n, -1, dtype=np.int32)  # -1 = slice gap
        ts_idx = {}
        bounds = []
        if self.parallel:
            for ts, (start, end) in zip(self.tile_order,
                                        self.used_ranges("n_blocks")):
                tile_of_block[start:end] = len(bounds)
                bounds.append([ts.col_start, ts.col_end,
                               ts.row_start, ts.row_end])
        else:
            prev = 0
            for end, ts in self.block_tile:
                ti = ts_idx.get(id(ts))
                if ti is None:
                    ti = ts_idx[id(ts)] = len(bounds)
                    bounds.append([ts.col_start, ts.col_end,
                                   ts.row_start, ts.row_end])
                tile_of_block[prev:end] = ti
                prev = end
        tile_bounds = np.ascontiguousarray(bounds, dtype=np.int32) \
            if bounds else np.zeros((1, 4), dtype=np.int32)
        rc.tile_of_block = _np_ptr(tile_of_block)
        rc.tile_bounds = _np_ptr(tile_bounds)

        rc.block_dim = tables.block_dimensions.ctypes.data
        ti_tbl = tables.txfm_info()
        rc.txfm_info = ti_tbl.ctypes.data
        smw = np.ascontiguousarray(tables.sm_weights, dtype=np.uint8)
        drd = np.ascontiguousarray(tables.dr_intra_derivative,
                                   dtype=np.uint16)
        fit = np.ascontiguousarray(tables.filter_intra_taps, dtype=np.int8)
        rc.sm_weights = _np_ptr(smw)
        rc.dr_deriv = _np_ptr(drd)
        rc.filter_taps = _np_ptr(fit)
        self._replay_keep = (resid_ptrs, tile_of_block, tile_bounds,
                             tables.block_dimensions, ti_tbl, smw, drd, fit)
        return rc

    def build_inter_ctx(self):
        """DtpuInterCtx for the native phase-A inter replay
        (replay_inter.c): reference-frame planes + gmv/jnt tables + the
        refmvs grid for sub8x8 neighbour lookups."""
        f = self.f
        hdr = f.frame_hdr
        ic = CInterCtx()
        keep = []
        for i in range(7):
            slot = f.refp[i] if f.refp is not None else None
            ok = 0
            if slot is not None and slot.planes is not None \
                    and slot.frame_hdr is not None:
                rw = slot.frame_hdr.width[1]
                rh = slot.frame_hdr.height
                ic.ref_w[i], ic.ref_h[i] = rw, rh
                good = True
                for pl, p in enumerate(slot.planes[:3]):
                    if p is None or p.dtype != np.int32 \
                            or not p.flags.c_contiguous:
                        good = False
                        break
                    ic.ref_planes[i][pl] = p.ctypes.data
                    ic.ref_stride[i][pl] = p.shape[1]
                    keep.append(p)
                ok = int(good and rw == hdr.width[0] and rh == hdr.height)
            ic.ref_ok[i] = ok
            g = hdr.gmv[i] if hdr.gmv is not None else None
            if g is not None:
                ic.gmv_type[i] = int(g.type)
                for k in range(6):
                    ic.gmv_matrix[i][k] = int(g.matrix[k])
                for k in range(4):
                    ic.gmv_abcd[i][k] = int(g.abcd[k])
            ic.gmv_warp_allowed[i] = int(f.gmv_warp_allowed[i])
        if f.jnt_weights is not None:
            for i in range(7):
                for j in range(7):
                    ic.jnt_weights[i][j] = int(f.jnt_weights[i][j])
        if f.rf is not None:  # None on intra frames (no inter blocks)
            r = f.rf.r
            ic.rb = r.ctypes.data
            ic.rb_stride = r.shape[1]
            keep.append(r)
        ic.cap_obmc = _np_ptr(self.cap_obmc)
        ic.cap_warp = _np_ptr(self.cap_warp)
        tbls = _inter_tables()
        (ic.subpel_filters, ic.obmc_masks, ic.masks_blob,
         ic.mask_offsets, ic.warp_filter) = (t.ctypes.data for t in tbls)
        self._inter_keep = (keep, tbls)
        return ic

    def ts_of_block(self, i):
        """TileState owning capture block i (block_tile holds the block
        count AFTER each sbrow call and its TileState; parallel mode
        resolves through the slice ranges)."""
        if self.parallel:
            for ts, (start, end) in zip(self.tile_order,
                                        self.used_ranges("n_blocks")):
                if start <= i < end:
                    return ts
            raise IndexError(i)
        for end, ts in self.block_tile:
            if i < end:
                return ts
        raise IndexError(i)

    def meta_rows(self):
        """The raw coefficient-meta arena as an (n, 6) int32 view."""
        return self.cap_coef_meta[: int(self.c.n_coef_meta)]

    def build_record(self, i, resid_of_meta=None):
        """One FrameContext.tasks-style replay record for capture block
        i (the Python-fallback path of the native phase-A/B replay:
        scaled references, intrabc, interintra).  resid_of_meta maps a
        meta-row index to its precomputed residual (pipeline batch)."""
        from ..decode.tile import Av1Block
        from ..headers import WarpedMotionParams

        f = self.f
        row = self.cap_blocks[i]
        bdim = tables.block_dimensions
        cf = self.cf_arena
        kind = int(row["kind"])

        b = Av1Block()
        b.bl, b.bs, b.bp = int(row["bl"]), int(row["bs"]), int(row["bp"])
        b.intra = int(kind == 0)
        b.seg_id = int(row["seg_id"])
        b.skip_mode = int(row["skip_mode"])
        b.skip = int(row["skip"])
        b.uvtx = int(row["uvtx"])
        b.y_mode = int(row["y_mode"])
        b.uv_mode = int(row["uv_mode"])
        b.tx = int(row["tx"])
        b.pal_sz = [int(row["pal_sz"][0]), int(row["pal_sz"][1])]
        b.y_angle = int(row["y_angle"])
        b.uv_angle = int(row["uv_angle"])
        b.cfl_alpha = [int(row["cfl_alpha"][0]), int(row["cfl_alpha"][1])]
        mv = row["mv"]
        b.mv = [(int(mv[0][0]), int(mv[0][1])),
                (int(mv[1][0]), int(mv[1][1]))]
        b.wedge_idx = int(row["wedge_idx"])
        b.mask_sign = int(row["mask_sign"])
        b.interintra_mode = int(row["interintra_mode"])
        b.comp_type = int(row["comp_type"])
        b.inter_mode = int(row["inter_mode"])
        b.motion_mode = int(row["motion_mode"])
        b.drl_idx = int(row["drl_idx"])
        b.ref = [-1, -1]
        b.max_ytx = int(row["max_ytx"])
        b.filter2d = int(row["filter2d"])
        b.interintra_type = int(row["interintra_type"])
        b.tx_split0 = int(row["tx_split0"])
        b.tx_split1 = int(row["tx_split1"])

        coef_start = int(row["coef_start"])
        coef_count = int(row["coef_count"])
        coefs = []
        resid = []
        for m in range(coef_start, coef_start + coef_count):
            eob, txtp, pltx, dst_y, dst_x, cf_off = \
                (int(v) for v in self.cap_coef_meta[m])
            pl = pltx & 0xFF
            mtx = pltx >> 8
            arr = None
            if cf_off >= 0:
                arr = cf[cf_off : cf_off + _n_coef(mtx)]
            coefs.append((eob, txtp, arr, pl, mtx, dst_y, dst_x))
            resid.append(resid_of_meta(m) if resid_of_meta is not None
                         and eob >= 0 else None)

        rec = dict(ts=self.ts_of_block(i), bx=int(row["bx"]),
                   by=int(row["by"]), bs=b.bs, b=b, coefs=coefs,
                   resid=resid, _cap=(i, coef_start))
        ss_hor, ss_ver = f.ss_hor, f.ss_ver
        if kind == 0:
            rec["kind"] = "intra"
            rec["edge_flags"] = int(row["edge_flags"])
            sm_flags = int(row["sm_flags"])
            rec["sm"] = (512 if sm_flags & 1 else 0,
                         512 if sm_flags & 2 else 0)
            pal_idx = int(row["pal_idx"])
            if pal_idx >= 0:
                bw4, bh4 = int(bdim[b.bs][0]), int(bdim[b.bs][1])
                idx_y = idx_uv = None
                off = int(row["pal_y_off"])
                if off >= 0:
                    idx_y = self.pal_arena[off : off + 16 * bw4 * bh4] \
                        .reshape(bh4 * 4, bw4 * 4)
                off = int(row["pal_uv_off"])
                if off >= 0:
                    cbw4 = (bw4 + ss_hor) >> ss_hor
                    cbh4 = (bh4 + ss_ver) >> ss_ver
                    idx_uv = self.pal_arena[off : off + 16 * cbw4 * cbh4] \
                        .reshape(cbh4 * 4, cbw4 * 4)
                rec["pal"] = (self.cap_pal[pal_idx], idx_y, idx_uv)
            else:
                rec["pal"] = None
        else:
            rec["kind"] = "inter" if kind == 1 else "intrabc"
            if kind == 1:
                b.ref = [int(row["pad0"]) - 1, int(row["pad1"]) - 1]
            rec["warpmv"] = None
            warp_idx = int(row["warp_idx"])
            if warp_idx >= 0:
                w = self.cap_warp[warp_idx]
                wmp = WarpedMotionParams()
                wmp.matrix = [int(v) for v in w["matrix"]]
                wmp.abcd = [int(v) for v in w["abcd"]]
                wmp.type = int(w["type"])
                rec["warpmv"] = wmp
            rec["obmc"] = None
            if b.motion_mode == 1:  # OBMC
                os_, oc = int(row["obmc_start"]), int(row["obmc_count"])
                rec["obmc"] = [
                    ("top" if int(o["kind"]) == 0 else "left",
                     int(o["off"]), (int(o["mv"][0]), int(o["mv"][1])),
                     int(o["refidx"]), int(o["f2d"]), int(o["step4"]))
                    for o in self.cap_obmc[os_ : os_ + oc]]
            rec["sub8x8"] = None
            s8 = int(row["sub8x8"])
            if s8 >= 0:
                rec["sub8x8"] = (s8 & 0xFF, (s8 >> 8) & 0xFF,
                                 (s8 >> 16) & 0xFF)
        return rec

    def release(self):
        """Return the capture arenas to the recycling pool (called once
        the frame's pass 2 + filter chain are complete).  Only the used
        ranges are re-zeroed: one per tile in a tile-sliced frame (the
        gaps between its slices were never written), else the dense
        prefix; ``devrt.COUNTS["arena.cleared_bytes"]`` counts them."""
        cleared = 0
        for name, attr, cur in _ARENAS:
            arr = getattr(self, attr)
            used = self.used_ranges(cur)
            _pool_put(name, arr, used)
            cleared += arr.strides[0] * sum(e - s for s, e in used)
            setattr(self, attr, None)
        devrt.COUNTS["arena.cleared_bytes"] += cleared

    def finish_lr_units(self):
        """Restoration units: dense capture grid -> FrameContext dict."""
        f = self.f
        lr = self.lr_units
        nz = np.nonzero(lr["type"] != 0)
        if nz[0].size == 0:
            return
        grid = lr.tolist()
        for sbp, p, u in zip(*nz):
            ent = grid[sbp][p][u]
            f.lr_units[(int(sbp), int(p), int(u))] = dict(
                type=ent[0], filter_v=list(ent[1]), filter_h=list(ent[2]),
                sgr_weights=list(ent[3]))


_N_COEF_CACHE = None


def _n_coef(tx):
    global _N_COEF_CACHE
    if _N_COEF_CACHE is None:
        ti = tables.txfm_info()
        _N_COEF_CACHE = [
            (4 << min(int(r[2]), 3)) * (4 << min(int(r[3]), 3)) for r in ti]
    return _N_COEF_CACHE[tx]


def available() -> bool:
    return _native is not None
