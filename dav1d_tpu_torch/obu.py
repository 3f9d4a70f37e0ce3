"""OBU parsing: framing, sequence/frame headers, tile groups, metadata.

Behavioral parity with the reference parser (reference src/obu.c:72-1695,
itself AV1 spec 5.5/5.9-5.11/5.8): same field derivations (frame size,
tiling split, segmentation qidx/lossless, gmv subexp deltas, film grain),
same error conditions, same layer-filtering and show_existing_frame
semantics. The decoder context protocol it needs: seq_hdr/frame_hdr slots,
refs[8] holding previous FrameHeaders, operating point config.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .getbits import GetBits
from .headers import (
    AdaptiveBoolean, CdefInfo, ChromaSamplePosition, ContentLightLevel,
    DeltaInfo, FilmGrainData, FilmGrainInfo, FilterMode, FrameHeader,
    FrameType, ITUTT35, LoopfilterInfo, LoopfilterModeRefDeltas,
    MasteringDisplay, MAX_OPERATING_POINTS, MAX_SEGMENTS, MAX_TILE_COLS,
    MAX_TILE_ROWS, ObuType, OperatingParameterInfo, OperatingPoint,
    PixelLayout, PRIMARY_REF_NONE, QuantInfo, RestorationInfo,
    RestorationType, SegmentationData, SegmentationDataSet, SegmentationInfo,
    SequenceHeader, TilingInfo, TxfmMode, WarpedMotionParams,
    WarpedMotionType,
)


class ObuError(ValueError):
    pass


DEFAULT_MODE_REF_DELTAS = LoopfilterModeRefDeltas(
    mode_delta=[0, 0], ref_delta=[1, 0, 0, 0, -1, 0, -1, -1]
)


def get_poc_diff(order_hint_n_bits: int, poc0: int, poc1: int) -> int:
    """Circular order-hint difference (reference include/common/frame.h)."""
    if not order_hint_n_bits:
        return 0
    mask = 1 << (order_hint_n_bits - 1)
    diff = poc0 - poc1
    return (diff & (mask - 1)) - (diff & mask)


def _tile_log2(sz: int, tgt: int) -> int:
    k = 0
    while (sz << k) < tgt:
        k += 1
    return k


def parse_seq_hdr(gb: GetBits, strict: bool = False) -> SequenceHeader:
    """AV1 sequence header (reference src/obu.c:72-301)."""
    hdr = SequenceHeader()
    hdr.profile = gb.get_bits(3)
    if hdr.profile > 2:
        raise ObuError("bad profile")
    hdr.still_picture = gb.get_bit()
    hdr.reduced_still_picture_header = gb.get_bit()
    if hdr.reduced_still_picture_header and not hdr.still_picture:
        raise ObuError("reduced_still_picture_header without still_picture")

    hdr.operating_points = [OperatingPoint() for _ in range(MAX_OPERATING_POINTS)]
    hdr.operating_parameter_info = [
        OperatingParameterInfo() for _ in range(MAX_OPERATING_POINTS)
    ]
    if hdr.reduced_still_picture_header:
        hdr.num_operating_points = 1
        op = hdr.operating_points[0]
        op.major_level = gb.get_bits(3)
        op.minor_level = gb.get_bits(2)
        op.initial_display_delay = 10
    else:
        hdr.timing_info_present = gb.get_bit()
        if hdr.timing_info_present:
            hdr.num_units_in_tick = gb.get_bits(32)
            hdr.time_scale = gb.get_bits(32)
            if strict and (not hdr.num_units_in_tick or not hdr.time_scale):
                raise ObuError("bad timing info")
            hdr.equal_picture_interval = gb.get_bit()
            if hdr.equal_picture_interval:
                v = gb.get_vlc()
                if v == 0xFFFFFFFF:
                    raise ObuError("bad num_ticks_per_picture")
                hdr.num_ticks_per_picture = v + 1
            hdr.decoder_model_info_present = gb.get_bit()
            if hdr.decoder_model_info_present:
                hdr.encoder_decoder_buffer_delay_length = gb.get_bits(5) + 1
                hdr.num_units_in_decoding_tick = gb.get_bits(32)
                if strict and not hdr.num_units_in_decoding_tick:
                    raise ObuError("bad decoding tick")
                hdr.buffer_removal_delay_length = gb.get_bits(5) + 1
                hdr.frame_presentation_delay_length = gb.get_bits(5) + 1
        hdr.display_model_info_present = gb.get_bit()
        hdr.num_operating_points = gb.get_bits(5) + 1
        for i in range(hdr.num_operating_points):
            op = hdr.operating_points[i]
            op.idc = gb.get_bits(12)
            if op.idc and (not (op.idc & 0xFF) or not (op.idc & 0xF00)):
                raise ObuError("bad operating point idc")
            op.major_level = 2 + gb.get_bits(3)
            op.minor_level = gb.get_bits(2)
            if op.major_level > 3:
                op.tier = gb.get_bit()
            if hdr.decoder_model_info_present:
                op.decoder_model_param_present = gb.get_bit()
                if op.decoder_model_param_present:
                    opi = hdr.operating_parameter_info[i]
                    opi.decoder_buffer_delay = gb.get_bits(
                        hdr.encoder_decoder_buffer_delay_length)
                    opi.encoder_buffer_delay = gb.get_bits(
                        hdr.encoder_decoder_buffer_delay_length)
                    opi.low_delay_mode = gb.get_bit()
            if hdr.display_model_info_present:
                op.display_model_param_present = gb.get_bit()
            op.initial_display_delay = (
                gb.get_bits(4) + 1 if op.display_model_param_present else 10)

    hdr.width_n_bits = gb.get_bits(4) + 1
    hdr.height_n_bits = gb.get_bits(4) + 1
    hdr.max_width = gb.get_bits(hdr.width_n_bits) + 1
    hdr.max_height = gb.get_bits(hdr.height_n_bits) + 1
    if not hdr.reduced_still_picture_header:
        hdr.frame_id_numbers_present = gb.get_bit()
        if hdr.frame_id_numbers_present:
            hdr.delta_frame_id_n_bits = gb.get_bits(4) + 2
            hdr.frame_id_n_bits = gb.get_bits(3) + hdr.delta_frame_id_n_bits + 1

    hdr.sb128 = gb.get_bit()
    hdr.filter_intra = gb.get_bit()
    hdr.intra_edge_filter = gb.get_bit()
    if hdr.reduced_still_picture_header:
        hdr.screen_content_tools = AdaptiveBoolean.ADAPTIVE
        hdr.force_integer_mv = AdaptiveBoolean.ADAPTIVE
    else:
        hdr.inter_intra = gb.get_bit()
        hdr.masked_compound = gb.get_bit()
        hdr.warped_motion = gb.get_bit()
        hdr.dual_filter = gb.get_bit()
        hdr.order_hint = gb.get_bit()
        if hdr.order_hint:
            hdr.jnt_comp = gb.get_bit()
            hdr.ref_frame_mvs = gb.get_bit()
        hdr.screen_content_tools = AdaptiveBoolean(
            AdaptiveBoolean.ADAPTIVE if gb.get_bit() else gb.get_bit())
        hdr.force_integer_mv = AdaptiveBoolean(
            (AdaptiveBoolean.ADAPTIVE if gb.get_bit() else gb.get_bit())
            if hdr.screen_content_tools else 2)
        if hdr.order_hint:
            hdr.order_hint_n_bits = gb.get_bits(3) + 1
    hdr.super_res = gb.get_bit()
    hdr.cdef = gb.get_bit()
    hdr.restoration = gb.get_bit()

    hdr.hbd = gb.get_bit()
    if hdr.profile == 2 and hdr.hbd:
        hdr.hbd += gb.get_bit()
    if hdr.profile != 1:
        hdr.monochrome = gb.get_bit()
    hdr.color_description_present = gb.get_bit()
    if hdr.color_description_present:
        hdr.pri = gb.get_bits(8)
        hdr.trc = gb.get_bits(8)
        hdr.mtrx = gb.get_bits(8)
    else:
        hdr.pri = 2
        hdr.trc = 2
        hdr.mtrx = 2
    if hdr.monochrome:
        hdr.color_range = gb.get_bit()
        hdr.layout = PixelLayout.I400
        hdr.ss_hor = hdr.ss_ver = 1
        hdr.chr = ChromaSamplePosition.UNKNOWN
    elif hdr.pri == 1 and hdr.trc == 13 and hdr.mtrx == 0:
        # BT709 primaries + sRGB transfer + identity matrix => 4:4:4 RGB
        hdr.layout = PixelLayout.I444
        hdr.color_range = 1
        hdr.ss_hor = hdr.ss_ver = 0
        if hdr.profile != 1 and not (hdr.profile == 2 and hdr.hbd == 2):
            raise ObuError("RGB requires 4:4:4-capable profile")
    else:
        hdr.color_range = gb.get_bit()
        if hdr.profile == 0:
            hdr.layout = PixelLayout.I420
            hdr.ss_hor = hdr.ss_ver = 1
        elif hdr.profile == 1:
            hdr.layout = PixelLayout.I444
            hdr.ss_hor = hdr.ss_ver = 0
        else:
            if hdr.hbd == 2:
                hdr.ss_hor = gb.get_bit()
                hdr.ss_ver = gb.get_bit() if hdr.ss_hor else 0
            else:
                hdr.ss_hor = 1
                hdr.ss_ver = 0
            hdr.layout = (
                (PixelLayout.I420 if hdr.ss_ver else PixelLayout.I422)
                if hdr.ss_hor else PixelLayout.I444)
        hdr.chr = ChromaSamplePosition(
            gb.get_bits(2) if (hdr.ss_hor & hdr.ss_ver) else 0)
    if strict and hdr.mtrx == 0 and hdr.layout != PixelLayout.I444:
        raise ObuError("identity matrix requires 4:4:4")
    if not hdr.monochrome:
        hdr.separate_uv_delta_q = gb.get_bit()
    hdr.film_grain_present = gb.get_bit()

    check_trailing_bits(gb, strict)
    return hdr


def check_trailing_bits(gb: GetBits, strict: bool) -> None:
    trailing_one_bit = gb.get_bit()
    if gb.error:
        raise ObuError("overrun")
    if not strict:
        return
    if not trailing_one_bit:
        raise ObuError("bad trailing bit")
    # remaining bits of this byte must be zero, and all remaining bytes zero
    rem = (8 - (gb.pos & 7)) & 7
    if rem and gb.get_bits(rem):
        raise ObuError("nonzero trailing bits")
    while gb.pos < gb.nbits:
        if gb.get_bits(8):
            raise ObuError("nonzero trailing bytes")


def _read_frame_size(ctx, hdr: FrameHeader, seqhdr: SequenceHeader,
                     gb: GetBits, use_ref: bool) -> None:
    """reference src/obu.c:341-399."""
    if use_ref:
        for i in range(7):
            if gb.get_bit():
                ref_hdr = ctx.refs[hdr.refidx[i]].frame_hdr
                if ref_hdr is None:
                    raise ObuError("missing ref for frame size")
                hdr.width[1] = ref_hdr.width[1]
                hdr.height = ref_hdr.height
                hdr.render_width = ref_hdr.render_width
                hdr.render_height = ref_hdr.render_height
                hdr.super_res_enabled = seqhdr.super_res and gb.get_bit()
                if hdr.super_res_enabled:
                    d = hdr.super_res_width_scale_denominator = 9 + gb.get_bits(3)
                    hdr.width[0] = max((hdr.width[1] * 8 + (d >> 1)) // d,
                                       min(16, hdr.width[1]))
                else:
                    hdr.super_res_width_scale_denominator = 8
                    hdr.width[0] = hdr.width[1]
                return
    if hdr.frame_size_override:
        hdr.width[1] = gb.get_bits(seqhdr.width_n_bits) + 1
        hdr.height = gb.get_bits(seqhdr.height_n_bits) + 1
    else:
        hdr.width[1] = seqhdr.max_width
        hdr.height = seqhdr.max_height
    hdr.super_res_enabled = int(bool(seqhdr.super_res and gb.get_bit()))
    if hdr.super_res_enabled:
        d = hdr.super_res_width_scale_denominator = 9 + gb.get_bits(3)
        hdr.width[0] = max((hdr.width[1] * 8 + (d >> 1)) // d,
                           min(16, hdr.width[1]))
    else:
        hdr.super_res_width_scale_denominator = 8
        hdr.width[0] = hdr.width[1]
    hdr.have_render_size = gb.get_bit()
    if hdr.have_render_size:
        hdr.render_width = gb.get_bits(16) + 1
        hdr.render_height = gb.get_bits(16) + 1
    else:
        hdr.render_width = hdr.width[1]
        hdr.render_height = hdr.height


def parse_frame_hdr(ctx, gb: GetBits) -> FrameHeader:
    """AV1 uncompressed frame header (reference src/obu.c:409-1152)."""
    seqhdr: SequenceHeader = ctx.seq_hdr
    hdr = FrameHeader()
    hdr.operating_points = [0] * MAX_OPERATING_POINTS

    if not seqhdr.reduced_still_picture_header:
        hdr.show_existing_frame = gb.get_bit()
    if hdr.show_existing_frame:
        hdr.existing_frame_idx = gb.get_bits(3)
        if seqhdr.decoder_model_info_present and not seqhdr.equal_picture_interval:
            hdr.frame_presentation_delay = gb.get_bits(
                seqhdr.frame_presentation_delay_length)
        if seqhdr.frame_id_numbers_present:
            hdr.frame_id = gb.get_bits(seqhdr.frame_id_n_bits)
            ref_hdr = ctx.refs[hdr.existing_frame_idx].frame_hdr
            if ref_hdr is None or ref_hdr.frame_id != hdr.frame_id:
                raise ObuError("show_existing_frame id mismatch")
        return hdr

    if seqhdr.reduced_still_picture_header:
        hdr.frame_type = FrameType.KEY
        hdr.show_frame = 1
    else:
        hdr.frame_type = FrameType(gb.get_bits(2))
        hdr.show_frame = gb.get_bit()
    if hdr.show_frame:
        if seqhdr.decoder_model_info_present and not seqhdr.equal_picture_interval:
            hdr.frame_presentation_delay = gb.get_bits(
                seqhdr.frame_presentation_delay_length)
        hdr.showable_frame = int(hdr.frame_type != FrameType.KEY)
    else:
        hdr.showable_frame = gb.get_bit()
    hdr.error_resilient_mode = int(
        (hdr.frame_type == FrameType.KEY and hdr.show_frame)
        or hdr.frame_type == FrameType.SWITCH
        or seqhdr.reduced_still_picture_header or bool(gb.get_bit()))
    hdr.disable_cdf_update = gb.get_bit()
    hdr.allow_screen_content_tools = (
        gb.get_bit() if seqhdr.screen_content_tools == AdaptiveBoolean.ADAPTIVE
        else int(seqhdr.screen_content_tools))
    if hdr.allow_screen_content_tools:
        hdr.force_integer_mv = (
            gb.get_bit() if seqhdr.force_integer_mv == AdaptiveBoolean.ADAPTIVE
            else int(seqhdr.force_integer_mv))
    else:
        hdr.force_integer_mv = 0

    if hdr.frame_type.is_key_or_intra:
        hdr.force_integer_mv = 1

    if seqhdr.frame_id_numbers_present:
        hdr.frame_id = gb.get_bits(seqhdr.frame_id_n_bits)

    if not seqhdr.reduced_still_picture_header:
        hdr.frame_size_override = (
            1 if hdr.frame_type == FrameType.SWITCH else gb.get_bit())
    if seqhdr.order_hint:
        hdr.frame_offset = gb.get_bits(seqhdr.order_hint_n_bits)
    hdr.primary_ref_frame = (
        gb.get_bits(3)
        if not hdr.error_resilient_mode and hdr.frame_type.is_inter_or_switch
        else PRIMARY_REF_NONE)

    if seqhdr.decoder_model_info_present:
        hdr.buffer_removal_time_present = gb.get_bit()
        if hdr.buffer_removal_time_present:
            for i in range(seqhdr.num_operating_points):
                seqop = seqhdr.operating_points[i]
                if seqop.decoder_model_param_present:
                    in_temporal = (seqop.idc >> hdr.temporal_id) & 1
                    in_spatial = (seqop.idc >> (hdr.spatial_id + 8)) & 1
                    if not seqop.idc or (in_temporal and in_spatial):
                        hdr.operating_points[i] = gb.get_bits(
                            seqhdr.buffer_removal_delay_length)

    if hdr.frame_type.is_key_or_intra:
        hdr.refresh_frame_flags = (
            0xFF if (hdr.frame_type == FrameType.KEY and hdr.show_frame)
            else gb.get_bits(8))
        if (hdr.refresh_frame_flags != 0xFF and hdr.error_resilient_mode
                and seqhdr.order_hint):
            for _ in range(8):
                gb.get_bits(seqhdr.order_hint_n_bits)
        if (ctx.strict_std_compliance and hdr.frame_type == FrameType.INTRA
                and hdr.refresh_frame_flags == 0xFF):
            raise ObuError("intra frame with refresh 0xff")
        _read_frame_size(ctx, hdr, seqhdr, gb, False)
        if hdr.allow_screen_content_tools and not hdr.super_res_enabled:
            hdr.allow_intrabc = gb.get_bit()
    else:
        hdr.refresh_frame_flags = (
            0xFF if hdr.frame_type == FrameType.SWITCH else gb.get_bits(8))
        if hdr.error_resilient_mode and seqhdr.order_hint:
            for _ in range(8):
                gb.get_bits(seqhdr.order_hint_n_bits)
        if seqhdr.order_hint:
            hdr.frame_ref_short_signaling = gb.get_bit()
            if hdr.frame_ref_short_signaling:
                _short_ref_signaling(ctx, hdr, seqhdr, gb)
        for i in range(7):
            if not hdr.frame_ref_short_signaling:
                hdr.refidx[i] = gb.get_bits(3)
            if seqhdr.frame_id_numbers_present:
                delta = gb.get_bits(seqhdr.delta_frame_id_n_bits) + 1
                ref_frame_id = (hdr.frame_id + (1 << seqhdr.frame_id_n_bits)
                                - delta) & ((1 << seqhdr.frame_id_n_bits) - 1)
                ref_hdr = ctx.refs[hdr.refidx[i]].frame_hdr
                if ref_hdr is None or ref_hdr.frame_id != ref_frame_id:
                    raise ObuError("ref frame id mismatch")
        use_ref = not hdr.error_resilient_mode and hdr.frame_size_override
        _read_frame_size(ctx, hdr, seqhdr, gb, use_ref)
        if not hdr.force_integer_mv:
            hdr.hp = gb.get_bit()
        hdr.subpel_filter_mode = FilterMode(
            FilterMode.SWITCHABLE if gb.get_bit() else gb.get_bits(2))
        hdr.switchable_motion_mode = gb.get_bit()
        if (not hdr.error_resilient_mode and seqhdr.ref_frame_mvs
                and seqhdr.order_hint and hdr.frame_type.is_inter_or_switch):
            hdr.use_ref_frame_mvs = gb.get_bit()

    if not seqhdr.reduced_still_picture_header and not hdr.disable_cdf_update:
        hdr.refresh_context = int(not gb.get_bit())

    _parse_tiling(hdr, seqhdr, gb)
    _parse_quant(hdr, seqhdr, gb)
    _parse_segmentation(ctx, hdr, gb)
    _parse_delta(hdr, gb)
    _derive_lossless(hdr)
    _parse_loopfilter(ctx, hdr, seqhdr, gb)
    _parse_cdef(hdr, seqhdr, gb)
    _parse_restoration(hdr, seqhdr, gb)

    if not hdr.all_lossless:
        hdr.txfm_mode = TxfmMode(
            TxfmMode.SWITCHABLE if gb.get_bit() else TxfmMode.LARGEST)
    else:
        hdr.txfm_mode = TxfmMode.ONLY_4X4
    if hdr.frame_type.is_inter_or_switch:
        hdr.switchable_comp_refs = gb.get_bit()
    _derive_skip_mode(ctx, hdr, seqhdr)
    if hdr.skip_mode_allowed:
        hdr.skip_mode_enabled = gb.get_bit()
    if (not hdr.error_resilient_mode and hdr.frame_type.is_inter_or_switch
            and seqhdr.warped_motion):
        hdr.warp_motion = gb.get_bit()
    hdr.reduced_txtp_set = gb.get_bit()

    _parse_gmv(ctx, hdr, gb)
    _parse_film_grain(ctx, hdr, seqhdr, gb)
    return hdr


def _short_ref_signaling(ctx, hdr, seqhdr, gb) -> None:
    """frame_ref_short_signaling ref derivation (reference src/obu.c:525-587).
    The reference mixes signed and 32-bit-unsigned comparisons on the offset
    array; we model the 32-bit wraparound explicitly."""
    INT_MIN32 = -0x80000000

    def u32(v):
        return v & 0xFFFFFFFF

    hdr.refidx[0] = gb.get_bits(3)
    hdr.refidx[1] = hdr.refidx[2] = -1
    hdr.refidx[3] = gb.get_bits(3)
    frame_offset = [0] * 8
    earliest_ref = -1
    earliest_offset = 0x7FFFFFFF
    for i in range(8):
        refhdr = ctx.refs[i].frame_hdr
        if refhdr is None:
            raise ObuError("short signaling without full ref set")
        diff = get_poc_diff(seqhdr.order_hint_n_bits, refhdr.frame_offset,
                            hdr.frame_offset)
        frame_offset[i] = diff
        if diff < earliest_offset:
            earliest_offset = diff
            earliest_ref = i
    frame_offset[hdr.refidx[0]] = INT_MIN32
    frame_offset[hdr.refidx[3]] = INT_MIN32

    # ALTREF: latest frame (signed compare, initial threshold 0)
    refidx = -1
    latest_offset = 0
    for i in range(8):
        if frame_offset[i] >= latest_offset:
            latest_offset = frame_offset[i]
            refidx = i
    if refidx >= 0:
        frame_offset[refidx] = INT_MIN32
    hdr.refidx[6] = refidx

    # BWDREF/ALTREF2: smallest *unsigned* offset below 255, i.e. nearest
    # future frames; negatives wrap to huge values and are excluded.
    for i in range(4, 6):
        earliest_u = 0xFF
        refidx = -1
        for j in range(8):
            hint = u32(frame_offset[j])
            if hint < earliest_u:
                earliest_u = hint
                refidx = j
        if refidx >= 0:
            frame_offset[refidx] = INT_MIN32
        hdr.refidx[i] = refidx

    # Remaining refs: latest past frame first; unsigned threshold
    # 0xFFFFFF00 selects among offsets in [-256, -1].
    for i in range(1, 7):
        refidx = hdr.refidx[i]
        if refidx < 0:
            latest_u = u32(~0xFF)
            sel = -1
            for j in range(8):
                hint = u32(frame_offset[j])
                if hint >= latest_u:
                    latest_u = hint
                    sel = j
            if sel >= 0:
                frame_offset[sel] = INT_MIN32
            hdr.refidx[i] = sel if sel >= 0 else earliest_ref


def _parse_tiling(hdr, seqhdr, gb) -> None:
    """reference src/obu.c:626-691."""
    t = hdr.tiling = TilingInfo()
    t.uniform = gb.get_bit()
    sbsz_min1 = (64 << seqhdr.sb128) - 1
    sbsz_log2 = 6 + seqhdr.sb128
    sbw = (hdr.width[0] + sbsz_min1) >> sbsz_log2
    sbh = (hdr.height + sbsz_min1) >> sbsz_log2
    max_tile_width_sb = 4096 >> sbsz_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sbsz_log2)
    t.min_log2_cols = _tile_log2(max_tile_width_sb, sbw)
    t.max_log2_cols = _tile_log2(1, min(sbw, MAX_TILE_COLS))
    t.max_log2_rows = _tile_log2(1, min(sbh, MAX_TILE_ROWS))
    min_log2_tiles = max(_tile_log2(max_tile_area_sb, sbw * sbh),
                         t.min_log2_cols)
    t.col_start_sb = [0] * (MAX_TILE_COLS + 1)
    t.row_start_sb = [0] * (MAX_TILE_ROWS + 1)
    if t.uniform:
        t.log2_cols = t.min_log2_cols
        while t.log2_cols < t.max_log2_cols and gb.get_bit():
            t.log2_cols += 1
        tile_w = 1 + ((sbw - 1) >> t.log2_cols)
        t.cols = 0
        sbx = 0
        while sbx < sbw:
            t.col_start_sb[t.cols] = sbx
            sbx += tile_w
            t.cols += 1
        t.min_log2_rows = max(min_log2_tiles - t.log2_cols, 0)
        t.log2_rows = t.min_log2_rows
        while t.log2_rows < t.max_log2_rows and gb.get_bit():
            t.log2_rows += 1
        tile_h = 1 + ((sbh - 1) >> t.log2_rows)
        t.rows = 0
        sby = 0
        while sby < sbh:
            t.row_start_sb[t.rows] = sby
            sby += tile_h
            t.rows += 1
    else:
        t.cols = 0
        widest_tile = 0
        max_area = sbw * sbh
        sbx = 0
        while sbx < sbw and t.cols < MAX_TILE_COLS:
            tile_width_sb = min(sbw - sbx, max_tile_width_sb)
            tile_w = 1 + gb.get_uniform(tile_width_sb) if tile_width_sb > 1 else 1
            t.col_start_sb[t.cols] = sbx
            sbx += tile_w
            widest_tile = max(widest_tile, tile_w)
            t.cols += 1
        t.log2_cols = _tile_log2(1, t.cols)
        if min_log2_tiles:
            max_area >>= min_log2_tiles + 1
        max_tile_height_sb = max(max_area // widest_tile, 1)
        t.rows = 0
        sby = 0
        while sby < sbh and t.rows < MAX_TILE_ROWS:
            tile_height_sb = min(sbh - sby, max_tile_height_sb)
            tile_h = 1 + gb.get_uniform(tile_height_sb) if tile_height_sb > 1 else 1
            t.row_start_sb[t.rows] = sby
            sby += tile_h
            t.rows += 1
        t.log2_rows = _tile_log2(1, t.rows)
    t.col_start_sb[t.cols] = sbw
    t.row_start_sb[t.rows] = sbh
    if t.log2_cols or t.log2_rows:
        t.update = gb.get_bits(t.log2_cols + t.log2_rows)
        if t.update >= t.cols * t.rows:
            raise ObuError("bad context_update_tile_id")
        t.n_bytes = gb.get_bits(2) + 1
    else:
        t.n_bytes = t.update = 0


def _parse_quant(hdr, seqhdr, gb) -> None:
    q = hdr.quant = QuantInfo()
    q.yac = gb.get_bits(8)
    q.ydc_delta = gb.get_sbits(7) if gb.get_bit() else 0
    if not seqhdr.monochrome:
        diff_uv_delta = gb.get_bit() if seqhdr.separate_uv_delta_q else 0
        q.udc_delta = gb.get_sbits(7) if gb.get_bit() else 0
        q.uac_delta = gb.get_sbits(7) if gb.get_bit() else 0
        if diff_uv_delta:
            q.vdc_delta = gb.get_sbits(7) if gb.get_bit() else 0
            q.vac_delta = gb.get_sbits(7) if gb.get_bit() else 0
        else:
            q.vdc_delta = q.udc_delta
            q.vac_delta = q.uac_delta
    q.qm = gb.get_bit()
    if q.qm:
        q.qm_y = gb.get_bits(4)
        q.qm_u = gb.get_bits(4)
        q.qm_v = gb.get_bits(4) if seqhdr.separate_uv_delta_q else q.qm_u


def _parse_segmentation(ctx, hdr, gb) -> None:
    s = hdr.segmentation = SegmentationInfo()
    s.enabled = gb.get_bit()
    if s.enabled:
        if hdr.primary_ref_frame == PRIMARY_REF_NONE:
            s.update_map = 1
            s.update_data = 1
        else:
            s.update_map = gb.get_bit()
            if s.update_map:
                s.temporal = gb.get_bit()
            s.update_data = gb.get_bit()

        if s.update_data:
            s.seg_data = SegmentationDataSet()
            s.seg_data.last_active_segid = -1
            for i in range(MAX_SEGMENTS):
                seg = s.seg_data.d[i]
                if gb.get_bit():
                    seg.delta_q = gb.get_sbits(9)
                    s.seg_data.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_y_v = gb.get_sbits(7)
                    s.seg_data.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_y_h = gb.get_sbits(7)
                    s.seg_data.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_u = gb.get_sbits(7)
                    s.seg_data.last_active_segid = i
                if gb.get_bit():
                    seg.delta_lf_v = gb.get_sbits(7)
                    s.seg_data.last_active_segid = i
                if gb.get_bit():
                    seg.ref = gb.get_bits(3)
                    s.seg_data.last_active_segid = i
                    s.seg_data.preskip = 1
                else:
                    seg.ref = -1
                seg.skip = gb.get_bit()
                if seg.skip:
                    s.seg_data.last_active_segid = i
                    s.seg_data.preskip = 1
                seg.globalmv = gb.get_bit()
                if seg.globalmv:
                    s.seg_data.last_active_segid = i
                    s.seg_data.preskip = 1
        else:
            pri_ref = hdr.refidx[hdr.primary_ref_frame]
            ref_hdr = ctx.refs[pri_ref].frame_hdr
            if ref_hdr is None:
                raise ObuError("segmentation copy without ref")
            import copy
            s.seg_data = copy.deepcopy(ref_hdr.segmentation.seg_data)
    else:
        for i in range(MAX_SEGMENTS):
            s.seg_data.d[i].ref = -1


def _parse_delta(hdr, gb) -> None:
    d = hdr.delta = DeltaInfo()
    if hdr.quant.yac:
        d.q_present = gb.get_bit()
        if d.q_present:
            d.q_res_log2 = gb.get_bits(2)
            if not hdr.allow_intrabc:
                d.lf_present = gb.get_bit()
                if d.lf_present:
                    d.lf_res_log2 = gb.get_bits(2)
                    d.lf_multi = gb.get_bit()


def _derive_lossless(hdr) -> None:
    q = hdr.quant
    delta_lossless = (not q.ydc_delta and not q.udc_delta and not q.uac_delta
                      and not q.vdc_delta and not q.vac_delta)
    hdr.all_lossless = 1
    for i in range(MAX_SEGMENTS):
        if hdr.segmentation.enabled:
            qidx = max(0, min(255, q.yac + hdr.segmentation.seg_data.d[i].delta_q))
        else:
            qidx = q.yac
        hdr.segmentation.qidx[i] = qidx
        hdr.segmentation.lossless[i] = int(not qidx and delta_lossless)
        hdr.all_lossless &= hdr.segmentation.lossless[i]


def _parse_loopfilter(ctx, hdr, seqhdr, gb) -> None:
    lf = hdr.loopfilter = LoopfilterInfo()
    if hdr.all_lossless or hdr.allow_intrabc:
        lf.level_y = [0, 0]
        lf.level_u = lf.level_v = 0
        lf.mode_ref_delta_enabled = 1
        lf.mode_ref_delta_update = 1
        lf.mode_ref_deltas = LoopfilterModeRefDeltas(
            mode_delta=list(DEFAULT_MODE_REF_DELTAS.mode_delta),
            ref_delta=list(DEFAULT_MODE_REF_DELTAS.ref_delta))
    else:
        lf.level_y = [gb.get_bits(6), gb.get_bits(6)]
        if not seqhdr.monochrome and (lf.level_y[0] or lf.level_y[1]):
            lf.level_u = gb.get_bits(6)
            lf.level_v = gb.get_bits(6)
        lf.sharpness = gb.get_bits(3)
        if hdr.primary_ref_frame == PRIMARY_REF_NONE:
            src = DEFAULT_MODE_REF_DELTAS
        else:
            ref_hdr = ctx.refs[hdr.refidx[hdr.primary_ref_frame]].frame_hdr
            if ref_hdr is None:
                raise ObuError("loopfilter deltas copy without ref")
            src = ref_hdr.loopfilter.mode_ref_deltas
        lf.mode_ref_deltas = LoopfilterModeRefDeltas(
            mode_delta=list(src.mode_delta), ref_delta=list(src.ref_delta))
        lf.mode_ref_delta_enabled = gb.get_bit()
        if lf.mode_ref_delta_enabled:
            lf.mode_ref_delta_update = gb.get_bit()
            if lf.mode_ref_delta_update:
                for i in range(8):
                    if gb.get_bit():
                        lf.mode_ref_deltas.ref_delta[i] = gb.get_sbits(7)
                for i in range(2):
                    if gb.get_bit():
                        lf.mode_ref_deltas.mode_delta[i] = gb.get_sbits(7)


def _parse_cdef(hdr, seqhdr, gb) -> None:
    c = hdr.cdef = CdefInfo()
    if not hdr.all_lossless and seqhdr.cdef and not hdr.allow_intrabc:
        c.damping = gb.get_bits(2) + 3
        c.n_bits = gb.get_bits(2)
        for i in range(1 << c.n_bits):
            c.y_strength[i] = gb.get_bits(6)
            if not seqhdr.monochrome:
                c.uv_strength[i] = gb.get_bits(6)
    else:
        c.n_bits = 0
        c.y_strength[0] = c.uv_strength[0] = 0
        c.damping = 3


def _parse_restoration(hdr, seqhdr, gb) -> None:
    r = hdr.restoration = RestorationInfo()
    if ((not hdr.all_lossless or hdr.super_res_enabled)
            and seqhdr.restoration and not hdr.allow_intrabc):
        r.type[0] = RestorationType(gb.get_bits(2))
        if not seqhdr.monochrome:
            r.type[1] = RestorationType(gb.get_bits(2))
            r.type[2] = RestorationType(gb.get_bits(2))
        if r.type[0] or r.type[1] or r.type[2]:
            r.unit_size[0] = 6 + seqhdr.sb128
            if gb.get_bit():
                r.unit_size[0] += 1
                if not seqhdr.sb128:
                    r.unit_size[0] += gb.get_bit()
            r.unit_size[1] = r.unit_size[0]
            if ((r.type[1] or r.type[2]) and seqhdr.ss_hor == 1
                    and seqhdr.ss_ver == 1):
                r.unit_size[1] -= gb.get_bit()
        else:
            r.unit_size[0] = 8
    else:
        r.type = [RestorationType.NONE] * 3
        r.unit_size = [8, 8]


def _derive_skip_mode(ctx, hdr, seqhdr) -> None:
    """reference src/obu.c:934-995."""
    hdr.skip_mode_allowed = 0
    hdr.skip_mode_refs = [-1, -1]
    if (hdr.switchable_comp_refs and hdr.frame_type.is_inter_or_switch
            and seqhdr.order_hint):
        poc = hdr.frame_offset
        off_before = off_after = -1
        off_before_idx = off_after_idx = -1
        for i in range(7):
            ref_hdr = ctx.refs[hdr.refidx[i]].frame_hdr
            if ref_hdr is None:
                raise ObuError("skip mode derivation without ref")
            refpoc = ref_hdr.frame_offset
            diff = get_poc_diff(seqhdr.order_hint_n_bits, refpoc, poc)
            if diff > 0:
                if (off_after < 0 or get_poc_diff(seqhdr.order_hint_n_bits,
                                                  off_after, refpoc) > 0):
                    off_after = refpoc
                    off_after_idx = i
            elif diff < 0 and (off_before < 0 or get_poc_diff(
                    seqhdr.order_hint_n_bits, refpoc, off_before) > 0):
                off_before = refpoc
                off_before_idx = i
        if off_before >= 0 and off_after >= 0:
            hdr.skip_mode_refs = [min(off_before_idx, off_after_idx),
                                  max(off_before_idx, off_after_idx)]
            hdr.skip_mode_allowed = 1
        elif off_before >= 0:
            off_before2 = -1
            off_before2_idx = -1
            for i in range(7):
                refpoc = ctx.refs[hdr.refidx[i]].frame_hdr.frame_offset
                if get_poc_diff(seqhdr.order_hint_n_bits, refpoc,
                                off_before) < 0:
                    if (off_before2 < 0 or get_poc_diff(
                            seqhdr.order_hint_n_bits, refpoc, off_before2) > 0):
                        off_before2 = refpoc
                        off_before2_idx = i
            if off_before2 >= 0:
                hdr.skip_mode_refs = [min(off_before_idx, off_before2_idx),
                                      max(off_before_idx, off_before2_idx)]
                hdr.skip_mode_allowed = 1


def _parse_gmv(ctx, hdr, gb) -> None:
    """reference src/obu.c:1011-1060."""
    hdr.gmv = [WarpedMotionParams() for _ in range(7)]
    if not hdr.frame_type.is_inter_or_switch:
        return
    for i in range(7):
        g = hdr.gmv[i]
        if not gb.get_bit():
            g.type = WarpedMotionType.IDENTITY
        elif gb.get_bit():
            g.type = WarpedMotionType.ROT_ZOOM
        elif gb.get_bit():
            g.type = WarpedMotionType.TRANSLATION
        else:
            g.type = WarpedMotionType.AFFINE
        if g.type == WarpedMotionType.IDENTITY:
            continue
        if hdr.primary_ref_frame == PRIMARY_REF_NONE:
            ref_mat = [0, 0, 1 << 16, 0, 0, 1 << 16]
        else:
            ref_hdr = ctx.refs[hdr.refidx[hdr.primary_ref_frame]].frame_hdr
            if ref_hdr is None:
                raise ObuError("gmv ref missing")
            ref_mat = ref_hdr.gmv[i].matrix
        mat = g.matrix
        if g.type >= WarpedMotionType.ROT_ZOOM:
            mat[2] = (1 << 16) + 2 * gb.get_bits_subexp(
                (ref_mat[2] - (1 << 16)) >> 1, 12)
            mat[3] = 2 * gb.get_bits_subexp(ref_mat[3] >> 1, 12)
            bits, shift = 12, 10
        else:
            bits = 9 - (not hdr.hp)
            shift = 13 + (not hdr.hp)
        if g.type == WarpedMotionType.AFFINE:
            mat[4] = 2 * gb.get_bits_subexp(ref_mat[4] >> 1, 12)
            mat[5] = (1 << 16) + 2 * gb.get_bits_subexp(
                (ref_mat[5] - (1 << 16)) >> 1, 12)
        else:
            mat[4] = -mat[3]
            mat[5] = mat[2]
        mat[0] = gb.get_bits_subexp(ref_mat[0] >> shift, bits) * (1 << shift)
        mat[1] = gb.get_bits_subexp(ref_mat[1] >> shift, bits) * (1 << shift)


def _parse_film_grain(ctx, hdr, seqhdr, gb) -> None:
    """reference src/obu.c:1063-1152."""
    fg = hdr.film_grain = FilmGrainInfo()
    if not (seqhdr.film_grain_present and (hdr.show_frame or hdr.showable_frame)):
        return
    fg.present = gb.get_bit()
    if not fg.present:
        return
    seed = gb.get_bits(16)
    fg.update = int(hdr.frame_type != FrameType.INTER or gb.get_bit())
    if not fg.update:
        refidx = gb.get_bits(3)
        found = any(hdr.refidx[i] == refidx for i in range(7))
        ref_hdr = ctx.refs[refidx].frame_hdr
        if not found or ref_hdr is None:
            raise ObuError("film grain ref missing")
        import copy
        fg.data = copy.deepcopy(ref_hdr.film_grain.data)
        fg.data.seed = seed
        return
    fgd = fg.data = FilmGrainData()
    fgd.seed = seed
    fgd.num_y_points = gb.get_bits(4)
    if fgd.num_y_points > 14:
        raise ObuError("bad num_y_points")
    fgd.y_points = []
    for i in range(fgd.num_y_points):
        value = gb.get_bits(8)
        if i and fgd.y_points[i - 1][0] >= value:
            raise ObuError("y_points not increasing")
        fgd.y_points.append((value, gb.get_bits(8)))
    if not seqhdr.monochrome:
        fgd.chroma_scaling_from_luma = gb.get_bit()
    if (seqhdr.monochrome or fgd.chroma_scaling_from_luma
            or (seqhdr.ss_ver == 1 and seqhdr.ss_hor == 1
                and not fgd.num_y_points)):
        fgd.num_uv_points = [0, 0]
    else:
        for pl in range(2):
            fgd.num_uv_points[pl] = gb.get_bits(4)
            if fgd.num_uv_points[pl] > 10:
                raise ObuError("bad num_uv_points")
            pts = []
            for i in range(fgd.num_uv_points[pl]):
                value = gb.get_bits(8)
                if i and pts[i - 1][0] >= value:
                    raise ObuError("uv_points not increasing")
                pts.append((value, gb.get_bits(8)))
            fgd.uv_points[pl] = pts
    if (seqhdr.ss_hor == 1 and seqhdr.ss_ver == 1
            and bool(fgd.num_uv_points[0]) != bool(fgd.num_uv_points[1])):
        raise ObuError("inconsistent uv points in 4:2:0")
    fgd.scaling_shift = gb.get_bits(2) + 8
    fgd.ar_coeff_lag = gb.get_bits(2)
    num_y_pos = 2 * fgd.ar_coeff_lag * (fgd.ar_coeff_lag + 1)
    fgd.ar_coeffs_y = [0] * 24
    fgd.ar_coeffs_uv = [[0] * 28, [0] * 28]
    if fgd.num_y_points:
        for i in range(num_y_pos):
            fgd.ar_coeffs_y[i] = gb.get_bits(8) - 128
    for pl in range(2):
        if fgd.num_uv_points[pl] or fgd.chroma_scaling_from_luma:
            num_uv_pos = num_y_pos + (1 if fgd.num_y_points else 0)
            for i in range(num_uv_pos):
                fgd.ar_coeffs_uv[pl][i] = gb.get_bits(8) - 128
            if not fgd.num_y_points:
                fgd.ar_coeffs_uv[pl][num_uv_pos] = 0
    fgd.ar_coeff_shift = gb.get_bits(2) + 6
    fgd.grain_scale_shift = gb.get_bits(2)
    for pl in range(2):
        if fgd.num_uv_points[pl]:
            fgd.uv_mult[pl] = gb.get_bits(8) - 128
            fgd.uv_luma_mult[pl] = gb.get_bits(8) - 128
            fgd.uv_offset[pl] = gb.get_bits(9) - 256
    fgd.overlap_flag = gb.get_bit()
    fgd.clip_to_restricted_range = gb.get_bit()


# --- OBU framing -----------------------------------------------------------

@dataclass
class Obu:
    type: ObuType
    temporal_id: int
    spatial_id: int
    payload_start: int  # byte offset of payload in the buffer
    payload_end: int
    has_extension: bool


def split_obus(data: bytes):
    """Iterate OBUs in a temporal unit (length-field format)."""
    pos = 0
    n = len(data)
    while pos < n:
        gb = GetBits(data[pos:])
        gb.get_bit()  # forbidden
        ty = gb.get_bits(4)
        has_ext = gb.get_bit()
        has_len = gb.get_bit()
        gb.get_bit()  # reserved
        tid = sid = 0
        if has_ext:
            tid = gb.get_bits(3)
            sid = gb.get_bits(2)
            gb.get_bits(3)
        if has_len:
            ln = gb.get_uleb128()
            hdr_sz = gb.byte_pos()
            payload_start = pos + hdr_sz
            payload_end = payload_start + ln
            if payload_end > n or gb.error:
                raise ObuError("OBU overruns buffer")
        else:
            payload_start = pos + gb.byte_pos()
            payload_end = n
        try:
            obu_type = ObuType(ty)
        except ValueError:
            obu_type = None
        yield Obu(obu_type, tid, sid, payload_start, payload_end, bool(has_ext))
        pos = payload_end
