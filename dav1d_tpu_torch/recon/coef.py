"""Coefficient decoding + dequantization (reference decode_coefs,
src/recon_tmpl.c:321-730; AV1 spec 5.11.39 coefficient parsing, 7.12.3
dequant)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..msac import MsacNative
from ..native import lib as _native

from .. import tables
from ..levels import (
    TxClass, TxfmSize, TxfmType, IntraPredMode as M,
    RTX_4X8,
)


def read_golomb(msac) -> int:
    ln = 0
    val = 1
    while not msac.decode_bool_equi() and ln < 32:
        ln += 1
    for _ in range(ln):
        val = (val << 1) + msac.decode_bool_equi()
    return val - 1


def get_skip_ctx(t_dim, bs, a, a_off, l, l_off, chroma, layout) -> int:
    """reference get_skip_ctx (src/recon_tmpl.c:60-139)."""
    b_dim = tables.block_dimensions[bs]
    lw, lh = int(t_dim[2]), int(t_dim[3])
    if chroma:
        ss_ver = layout == 1  # I420
        ss_hor = layout != 3  # not I444
        not_one_blk = (int(b_dim[2]) - (bool(b_dim[2]) and ss_hor) > lw
                       or int(b_dim[3]) - (bool(b_dim[3]) and ss_ver) > lh)
        ca = int(np.any(a[a_off : a_off + (1 << lw)] != 0x40))
        cl = int(np.any(l[l_off : l_off + (1 << lh)] != 0x40))
        return 7 + not_one_blk * 3 + ca + cl
    if int(b_dim[2]) == lw and int(b_dim[3]) == lh:
        return 0
    la = 0
    for v in a[a_off : a_off + min(1 << lw, 16)]:
        la |= int(v)
    ll = 0
    for v in l[l_off : l_off + min(1 << lh, 16)]:
        ll |= int(v)
    return int(tables.skip_ctx[min(la & 0x3F, 4)][min(ll & 0x3F, 4)])


def get_dc_sign_ctx(tx, a, a_off, l, l_off) -> int:
    """reference get_dc_sign_ctx (src/recon_tmpl.c:141-292): sum of per-4px
    dc-sign categories minus the neutral count."""
    t_dim = tables.txfm_info()[tx]
    na = 1 << int(t_dim[2])
    nl = 1 << int(t_dim[3])
    s = 0
    for v in a[a_off : a_off + na]:
        s += int(v) >> 6
    for v in l[l_off : l_off + nl]:
        s += int(v) >> 6
    s -= na + nl
    return (s != 0) + (s > 0)


def get_lo_ctx(levels, base, tx_class, ctx_offsets, x, y, stride):
    """Returns (base ctx, br magnitude).

    Spec context derivation (AV1 8.3.2) over the plain clamped-magnitude
    plane `levels` (values min(level, 3) for base neighbors, raw <= 15
    for br neighbors):
      base ctx: offset(pos) + min(4, (1 + sum_{5 nbrs} min(3, lvl)) >> 1)
      br  mag : sum over the 3 nearest neighbors (clamp-free, lvl <= 15)
    """
    l0 = int(levels[base + stride])
    l1 = int(levels[base + 1])
    if tx_class == TxClass.TWO_D:
        l2 = int(levels[base + stride + 1])
        br_mag = l0 + l1 + l2
        mag = (min(l0, 3) + min(l1, 3) + min(l2, 3)
               + min(int(levels[base + 2]), 3)
               + min(int(levels[base + 2 * stride]), 3))
        offset = int(ctx_offsets[min(y, 4)][min(x, 4)])
    else:
        l2 = int(levels[base + 2])
        br_mag = l0 + l1 + l2
        mag = (min(l0, 3) + min(l1, 3) + min(l2, 3)
               + min(int(levels[base + 3]), 3)
               + min(int(levels[base + 4]), 3))
        offset = 26 + (10 if y > 1 else y * 5)
    return offset + min(4, (mag + 1) >> 1), br_mag


def decode_coefs(t, a, a_off, l, l_off, tx, bs, b, intra, plane,
                 ytxtp=None):
    """Returns (eob, txtp, cf, res_ctx). cf is an int32 array indexed by
    rc = (x << (slh+2)) | y (the reference's transposed layout)."""
    if _native is not None and isinstance(t.ts.msac, MsacNative):
        # one C call per tx block; the Python path below is the fallback
        # where the native build is unavailable
        return decode_coefs_native(t, a, a_off, l, l_off, tx, bs, b,
                                   intra, plane, ytxtp)
    ts = t.ts
    f = t.f
    chroma = int(bool(plane))
    hdr = f.frame_hdr
    lossless = hdr.segmentation.lossless[b.seg_id]
    t_dim = tables.txfm_info()[tx]
    lw, lh = int(t_dim[2]), int(t_dim[3])
    tmin, tmax, tctx = int(t_dim[4]), int(t_dim[5]), int(t_dim[7])
    msac = ts.msac

    sctx = get_skip_ctx(t_dim, bs, a, a_off, l, l_off, chroma, f.layout)
    all_skip = msac.decode_bool_adapt(ts.cdf.coef.skip[tctx][sctx])
    if all_skip:
        return -1, (TxfmType.WHT_WHT if lossless else TxfmType.DCT_DCT), \
            None, 0x40

    # transform type
    if lossless:
        txtp = TxfmType.WHT_WHT
    elif tmax + intra >= TxfmSize.TX_64X64:
        txtp = TxfmType.DCT_DCT
    elif chroma:
        if intra:
            txtp = TxfmType(int(tables.txtp_from_uvmode[b.uv_mode]))
        else:
            txtp = get_uv_inter_txtp(t_dim, TxfmType(int(ytxtp)))
    elif not hdr.segmentation.qidx[b.seg_id]:
        txtp = TxfmType.DCT_DCT
    else:
        if intra:
            if b.y_mode == M.FILTER_PRED:
                y_mode_nofilt = int(tables.filter_mode_to_y_mode[b.y_angle])
            else:
                y_mode_nofilt = b.y_mode
            if hdr.reduced_txtp_set or tmin == TxfmSize.TX_16X16:
                idx = msac.decode_symbol_adapt(
                    ts.cdf.m.txtp_intra2[tmin][y_mode_nofilt], 4)
                txtp = TxfmType(int(tables.tx_types_per_set[idx]))
            else:
                idx = msac.decode_symbol_adapt(
                    ts.cdf.m.txtp_intra1[tmin][y_mode_nofilt], 6)
                txtp = TxfmType(int(tables.tx_types_per_set[idx + 5]))
        else:
            if hdr.reduced_txtp_set or tmax == TxfmSize.TX_32X32:
                idx = msac.decode_bool_adapt(ts.cdf.m.txtp_inter3[tmin])
                txtp = TxfmType.DCT_DCT if idx else TxfmType.IDTX
            elif tmin == TxfmSize.TX_16X16:
                idx = msac.decode_symbol_adapt(ts.cdf.m.txtp_inter2, 11)
                txtp = TxfmType(int(tables.tx_types_per_set[idx + 12]))
            else:
                idx = msac.decode_symbol_adapt(
                    ts.cdf.m.txtp_inter1[tmin], 15)
                txtp = TxfmType(int(tables.tx_types_per_set[idx + 24]))

    # eob
    slw = min(lw, 3)
    slh = min(lh, 3)
    tx2dszctx = slw + slh
    tx_class = TxClass(int(tables.tx_type_class[txtp]))
    is_1d = int(tx_class != TxClass.TWO_D)
    coef = ts.cdf.coef

    dq_tbl = ts.dq[b.seg_id][plane]
    qm_tbl = f.qm.get((tx, plane)) if txtp < TxfmType.IDTX else None
    eob, cf, res_ctx = _decode_coefs_tail_py(
        msac, coef, a, a_off, l, l_off, tx, plane, chroma, tctx,
        tx2dszctx, tx_class, slw, slh, txtp, dq_tbl, qm_tbl, f.bitdepth)
    return eob, txtp, cf, res_ctx


def _make_coef_ctx(ts, f):
    """Build the per-tile native DtpuCoefCtx pointer set (see
    native/msac_coef.c).  The keepalive tuple pins every array whose
    raw pointer the struct holds."""
    from ..native import DtpuCoefCtx
    coef = ts.cdf.coef
    m = ts.cdf.m
    cx = DtpuCoefCtx()
    cx.skip = coef.skip.ctypes.data
    cx.txtp_intra1 = m.txtp_intra1.ctypes.data
    cx.txtp_intra2 = m.txtp_intra2.ctypes.data
    cx.txtp_inter1 = m.txtp_inter1.ctypes.data
    cx.txtp_inter2 = m.txtp_inter2.ctypes.data
    cx.txtp_inter3 = m.txtp_inter3.ctypes.data
    eob_bins = (coef.eob_bin_16, coef.eob_bin_32, coef.eob_bin_64,
                coef.eob_bin_128, coef.eob_bin_256, coef.eob_bin_512,
                coef.eob_bin_1024)
    for i, arr in enumerate(eob_bins):
        cx.eob_bin[i] = arr.ctypes.data
    cx.eob_hi_bit = coef.eob_hi_bit.ctypes.data
    cx.eob_base_tok = coef.eob_base_tok.ctypes.data
    cx.base_tok = coef.base_tok.ctypes.data
    cx.br_tok = coef.br_tok.ctypes.data
    cx.dc_sign = coef.dc_sign.ctypes.data
    ti = tables.txfm_info()
    scans = tables.scans()
    cx.txfm_info = ti.ctypes.data
    cx.block_dim = tables.block_dimensions.ctypes.data
    cx.skip_ctx_tbl = tables.skip_ctx.ctypes.data
    cx.txtp_from_uvmode = tables.txtp_from_uvmode.ctypes.data
    cx.tx_types_per_set = tables.tx_types_per_set.ctypes.data
    cx.tx_type_class = tables.tx_type_class.ctypes.data
    cx.lo_ctx_offsets = tables.lo_ctx_offsets.ctypes.data
    for i in range(19):
        cx.scans[i] = scans[i].ctypes.data
    cx.layout = int(f.layout)
    cx.cf_max = (~(~127 << (8 if f.bitdepth == 8
                            else f.bitdepth))) & 0xFFFFFFFF
    cx._keepalive = (coef, m, eob_bins, ti, scans)
    return cx


_N_COEF = None  # per-tx flat coefficient counts, filled lazily


def decode_coefs_native(t, a, a_off, l, l_off, tx, bs, b, intra, plane,
                        ytxtp=None):
    """One-call native decode_coefs (skip ctx + txtp + tail in C);
    bit-identical to decode_coefs above (parity: tests/test_native.py).
    txtp comes back as a plain int (IntEnum-compatible downstream)."""
    ts = t.ts
    f = t.f
    hdr = f.frame_hdr
    cxe = getattr(ts, "_ncoef", None)
    if cxe is None or cxe[0] is not ts.cdf:
        global _N_COEF
        if _N_COEF is None:
            ti = tables.txfm_info()
            _N_COEF = [(4 << min(int(r[2]), 3)) * (4 << min(int(r[3]), 3))
                       for r in ti]
        cx = _make_coef_ctx(ts, f)
        cxe = (ts.cdf, ctypes.byref(cx), ctypes.byref(ts.msac.s), cx)
        ts._ncoef = cxe
    _, cx_ref, msac_ref, _ = cxe

    if intra and not plane:
        ymn = int(tables.filter_mode_to_y_mode[b.y_angle]) \
            if b.y_mode == M.FILTER_PRED else b.y_mode
    else:
        ymn = 0
    qm_tbl = f.qm.get((tx, plane))
    qm_ptr = None
    if qm_tbl is not None:
        if qm_tbl.dtype != np.uint8:
            qm_tbl = qm_tbl.astype(np.uint8)
            f.qm[(tx, plane)] = qm_tbl
        qm_ptr = qm_tbl.ctypes.data
    dq_tbl = ts.dq[b.seg_id][plane]
    seg = hdr.segmentation
    cf = np.empty(_N_COEF[tx], dtype=np.int32)
    eob_out = ctypes.c_int(0)
    ret = _native.dtpu_decode_coefs(
        cx_ref, msac_ref,
        a.ctypes.data, a_off, l.ctypes.data, l_off,
        tx, bs, intra, plane,
        ymn, b.uv_mode, 0 if ytxtp is None else ytxtp,
        seg.lossless[b.seg_id], 1 if seg.qidx[b.seg_id] else 0,
        hdr.reduced_txtp_set,
        int(dq_tbl[0]), int(dq_tbl[1]), qm_ptr,
        cf.ctypes.data, ctypes.byref(eob_out))
    eob = eob_out.value
    return eob, ret >> 16, (cf if eob >= 0 else None), ret & 0xFFFF


def _decode_coefs_tail_py(msac, coef, a, a_off, l, l_off, tx, plane,
                          chroma, tctx, tx2dszctx, tx_class, slw, slh,
                          txtp, dq_tbl, qm_tbl, bitdepth):
    t_dim = tables.txfm_info()[tx]
    is_1d = int(tx_class != TxClass.TWO_D)
    if tx2dszctx == 0:
        eob = msac.decode_symbol_adapt(coef.eob_bin_16[chroma][is_1d], 4)
    elif tx2dszctx == 1:
        eob = msac.decode_symbol_adapt(coef.eob_bin_32[chroma][is_1d], 5)
    elif tx2dszctx == 2:
        eob = msac.decode_symbol_adapt(coef.eob_bin_64[chroma][is_1d], 6)
    elif tx2dszctx == 3:
        eob = msac.decode_symbol_adapt(coef.eob_bin_128[chroma][is_1d], 7)
    elif tx2dszctx == 4:
        eob = msac.decode_symbol_adapt(coef.eob_bin_256[chroma][is_1d], 8)
    elif tx2dszctx == 5:
        eob = msac.decode_symbol_adapt(coef.eob_bin_512[chroma], 9)
    else:
        eob = msac.decode_symbol_adapt(coef.eob_bin_1024[chroma], 10)
    if eob > 1:
        eob_bin = eob - 2
        eob_hi_bit = msac.decode_bool_adapt(
            coef.eob_hi_bit[tctx][chroma][eob_bin])
        eob = ((eob_hi_bit | 2) << eob_bin) | msac.decode_bools(eob_bin)

    eob_cdf = coef.eob_base_tok[tctx][chroma]
    hi_cdf = coef.br_tok[min(tctx, 3)][chroma]
    n_coef = (4 << slw) * (4 << slh)
    cf = np.zeros(n_coef, dtype=np.int64)

    if eob:
        lo_cdf = coef.base_tok[tctx][chroma]
        if tx_class == TxClass.TWO_D:
            stride = 4 << slh
            shift, shift2 = slh + 2, 0
            mask = (4 << slh) - 1
            scan = tables.scans()[tx]
            nonsquare_tx = int(tx >= RTX_4X8)
            lo_ctx_offsets = tables.lo_ctx_offsets[
                nonsquare_tx + (tx & nonsquare_tx)]
            levels = np.zeros(stride * ((4 << slw) + 2), dtype=np.uint8)
        elif tx_class == TxClass.H:
            stride = 16
            shift, shift2 = slh + 2, 0
            mask = (4 << slh) - 1
            scan = None
            lo_ctx_offsets = None
            levels = np.zeros(stride * ((4 << slh) + 2), dtype=np.uint8)
        else:
            stride = 16
            shift, shift2 = slw + 2, slh + 2
            mask = (4 << slw) - 1
            scan = None
            lo_ctx_offsets = None
            levels = np.zeros(stride * ((4 << slw) + 2), dtype=np.uint8)

        # magnitude at the eob position (coeff_base_eob: min level 1)
        ctx = 1 + (eob > 2 << tx2dszctx) + (eob > 4 << tx2dszctx)
        tok = 1 + msac.decode_symbol_adapt(eob_cdf[ctx], 2)

        if tx_class == TxClass.TWO_D:
            rc = int(scan[eob])
            x, y = rc >> shift, rc & mask
        elif tx_class == TxClass.H:
            x, y = eob & mask, eob >> shift
            rc = eob
        else:
            x, y = eob & mask, eob >> shift
            rc = (x << shift2) | y
        if tok == 3:
            ctx = 14 if ((x | y) > 1 if tx_class == TxClass.TWO_D
                         else y != 0) else 7
            tok = msac.decode_hi_tok(hi_cdf[ctx])
        cf[rc] = tok
        nz = [rc]  # nonzero AC positions, descending scan order
        lvl_base = rc if tx_class == TxClass.TWO_D else x * stride + y
        levels[lvl_base] = tok

        # remaining AC magnitudes, reverse scan order
        for i in range(eob - 1, 0, -1):
            if tx_class == TxClass.TWO_D:
                rc_i = int(scan[i])
                x, y = rc_i >> shift, rc_i & mask
            elif tx_class == TxClass.H:
                x, y = i & mask, i >> shift
                rc_i = i
            else:
                x, y = i & mask, i >> shift
                rc_i = (x << shift2) | y
            lvl_base = rc_i if tx_class == TxClass.TWO_D else x * stride + y
            ctx, br_mag = get_lo_ctx(levels, lvl_base, tx_class,
                                     lo_ctx_offsets, x, y, stride)
            tok = msac.decode_symbol_adapt(lo_cdf[ctx], 3)
            if tok == 3:
                far = (x | y) > 1 if tx_class == TxClass.TWO_D else y > 0
                ctx = (14 if far else 7) + min(6, (br_mag + 1) >> 1)
                tok = msac.decode_hi_tok(hi_cdf[ctx])
            levels[lvl_base] = tok
            if tok:
                cf[rc_i] = tok
                nz.append(rc_i)

        # DC magnitude
        if tx_class == TxClass.TWO_D:
            ctx = 0
            br_mag = 0
        else:
            base_ctx, br_mag = get_lo_ctx(levels, 0, tx_class,
                                          lo_ctx_offsets, 0, 0, stride)
            ctx = base_ctx
        dc_tok = msac.decode_symbol_adapt(lo_cdf[ctx], 3)
        if dc_tok == 3:
            if tx_class == TxClass.TWO_D:
                br_mag = int(levels[1]) + int(levels[stride]) + \
                    int(levels[stride + 1])
            dc_tok = msac.decode_hi_tok(hi_cdf[min(6, (br_mag + 1) >> 1)])
    else:
        tok_br = msac.decode_symbol_adapt(eob_cdf[0], 2)
        dc_tok = 1 + tok_br
        if tok_br == 2:
            dc_tok = msac.decode_hi_tok(hi_cdf[0])
        nz = []

    # dequant
    dq_shift = max(0, tctx - 2)
    cf_max = (~(~127 << (8 if bitdepth == 8 else bitdepth))) & 0xFFFFFFFF

    if not dc_tok:
        cul_level = 0
        dc_sign_level = 1 << 6
        skip_dc = True
    else:
        skip_dc = False

    if not skip_dc:
        dc_sign_ctx = get_dc_sign_ctx(tx, a, a_off, l, l_off)
        dc_sign = msac.decode_bool_adapt(coef.dc_sign[chroma][dc_sign_ctx])
        dc_dq = int(dq_tbl[0])
        dc_sign_level = (dc_sign - 1) & (2 << 6)

        if qm_tbl is not None:
            dc_dq = (dc_dq * int(qm_tbl[0]) + 16) >> 5
        if dc_tok == 15:
            dc_tok = (read_golomb(msac) + 15) & 0xFFFFF
            dc_dq = (dc_dq * dc_tok) & 0xFFFFFF
        else:
            dc_dq *= dc_tok
        cul_level = dc_tok
        dc_dq >>= dq_shift
        dc_dq = min(dc_dq, cf_max + dc_sign)
        cf[0] = -dc_dq if dc_sign else dc_dq

    # AC signs + dequant, forward scan order (nz[] walked backward)
    ac_dq = int(dq_tbl[1])
    for rc in reversed(nz):
        sign = msac.decode_bool_equi()
        tok = int(cf[rc])
        dq = ((ac_dq * int(qm_tbl[rc]) + 16) >> 5) if qm_tbl is not None \
            else ac_dq
        if tok == 15:
            tok = (read_golomb(msac) + 15) & 0xFFFFF
            dq = (dq * tok) & 0xFFFFFF
        else:
            dq *= tok
        dq >>= dq_shift
        dq = min(dq, cf_max + sign)
        cul_level += tok
        cf[rc] = -dq if sign else dq

    res_ctx = min(cul_level, 63) | dc_sign_level
    return eob, cf, res_ctx


def intra_coefs_pass1(t, b, bs, bx4, by4, w4, h4, ss_hor, ss_ver,
                      has_chroma):
    """Pass-1 intra coefficient capture via ONE native call per block
    (dtpu_intra_coefs_pass1 walks every luma/chroma tx block in decode
    order); rebuilds t.cur_rec["coefs"] by replaying the same geometry.
    Returns False when the native path is unavailable (caller falls back
    to the per-tx-block walk)."""
    ts = t.ts
    f = t.f
    if not (_native is not None and isinstance(ts.msac, MsacNative)):
        return False
    hdr = f.frame_hdr
    cxe = getattr(ts, "_ncoef", None)
    if cxe is None or cxe[0] is not ts.cdf:
        global _N_COEF
        if _N_COEF is None:
            ti0 = tables.txfm_info()
            _N_COEF = [(4 << min(int(r[2]), 3)) * (4 << min(int(r[3]), 3))
                       for r in ti0]
        cx = _make_coef_ctx(ts, f)
        cxe = (ts.cdf, ctypes.byref(cx), ctypes.byref(ts.msac.s), cx)
        ts._ncoef = cxe
    _, cx_ref, msac_ref, _ = cxe

    ti = tables.txfm_info()
    tx, uvtx = b.tx, b.uvtx
    tdim, utdim = ti[tx], ti[uvtx]
    tw, th = int(tdim[0]), int(tdim[1])
    utw, uth = int(utdim[0]), int(utdim[1])
    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver
    if b.skip:
        nmax = 0
        arena = meta = None
        arena_ptr = meta_ptr = None
        stride = 0
    else:
        n_y = -(-w4 // tw) * -(-h4 // th)
        n_uv = 2 * -(-cw4 // utw) * -(-ch4 // uth) if has_chroma else 0
        nmax = n_y + n_uv
        stride = max(_N_COEF[tx], _N_COEF[uvtx] if has_chroma else 0)
        arena = np.empty((nmax, stride), dtype=np.int32)
        meta = np.empty((nmax, 2), dtype=np.int32)
        arena_ptr, meta_ptr = arena.ctypes.data, meta.ctypes.data

    seg = hdr.segmentation
    ymn = int(tables.filter_mode_to_y_mode[b.y_angle]) \
        if b.y_mode == M.FILTER_PRED else b.y_mode
    dq = ts.dq[b.seg_id]
    qm_ptrs = []
    for key in ((tx, 0), (uvtx, 1), (uvtx, 2)):
        q = f.qm.get(key)
        if q is None:
            qm_ptrs.append(None)
        else:
            if q.dtype != np.uint8:
                q = q.astype(np.uint8)
                f.qm[key] = q
            qm_ptrs.append(q.ctypes.data)

    n = _native.dtpu_intra_coefs_pass1(
        cx_ref, msac_ref,
        t.bx, t.by, w4, h4, bx4, by4, f.bw, f.bh, ss_hor, ss_ver,
        1 if has_chroma else 0, tx, uvtx, int(bs), 1 if b.skip else 0,
        ymn, b.uv_mode,
        seg.lossless[b.seg_id], 1 if seg.qidx[b.seg_id] else 0,
        hdr.reduced_txtp_set,
        int(dq[0][0]), int(dq[0][1]), int(dq[1][0]), int(dq[1][1]),
        int(dq[2][0]), int(dq[2][1]),
        qm_ptrs[0], qm_ptrs[1], qm_ptrs[2],
        t.a.lcoef.ctypes.data, t.l.lcoef.ctypes.data,
        t.a.ccoef[0].ctypes.data, t.l.ccoef[0].ctypes.data,
        t.a.ccoef[1].ctypes.data, t.l.ccoef[1].ctypes.data,
        arena_ptr, stride, meta_ptr)
    assert n == nmax, (n, nmax, w4, h4, tx, uvtx)

    if n:
        coefs = t.cur_rec["coefs"]
        ml = meta.tolist()
        ncy, ncuv = _N_COEF[tx], _N_COEF[uvtx]
        bxb, byb = t.bx, t.by
        i = 0
        for init_y in range(0, h4, 16):
            sub_h4 = min(h4, 16 + init_y)
            sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
            for init_x in range(0, w4, 16):
                sub_w4 = min(w4, init_x + 16)
                sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
                for y in range(init_y, sub_h4, th):
                    dsty = 4 * (byb + y)
                    for x in range(init_x, sub_w4, tw):
                        eob, txtp = ml[i]
                        coefs.append(
                            (eob, txtp,
                             arena[i, :ncy] if eob >= 0 else None,
                             0, tx, dsty, 4 * (bxb + x)))
                        i += 1
                if not has_chroma:
                    continue
                icx, icy = init_x >> ss_hor, init_y >> ss_ver
                for pl in range(2):
                    for y in range(icy, sub_ch4, uth):
                        dsty = 4 * ((byb + (y << ss_ver)) >> ss_ver)
                        for x in range(icx, sub_cw4, utw):
                            eob, txtp = ml[i]
                            coefs.append(
                                (eob, txtp,
                                 arena[i, :ncuv] if eob >= 0 else None,
                                 1 + pl, uvtx, dsty,
                                 4 * ((bxb + (x << ss_hor)) >> ss_hor)))
                            i += 1
    return True


def get_uv_inter_txtp(uvt_dim, ytxtp):
    """reference env.h get_uv_inter_txtp."""
    if int(uvt_dim[5]) == TxfmSize.TX_32X32:
        return TxfmType.IDTX if ytxtp == TxfmType.IDTX else TxfmType.DCT_DCT
    if int(uvt_dim[4]) == TxfmSize.TX_16X16 and (
            (1 << ytxtp) & ((1 << TxfmType.H_FLIPADST)
                            | (1 << TxfmType.V_FLIPADST)
                            | (1 << TxfmType.H_ADST)
                            | (1 << TxfmType.V_ADST))):
        return TxfmType.DCT_DCT
    return ytxtp
