"""AV1 bitstream header models.

Capability parity with the reference's public header structs
(reference: include/dav1d/headers.h:203-434) but expressed as Python
dataclasses. Field names follow the AV1 specification (Section 5.5 sequence
header / 5.9 frame header semantics) so the OBU parser reads like the spec.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

MAX_CDEF_STRENGTHS = 8
MAX_OPERATING_POINTS = 32
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64
MAX_SEGMENTS = 8
NUM_REF_FRAMES = 8
PRIMARY_REF_NONE = 7
REFS_PER_FRAME = 7
TOTAL_REFS_PER_FRAME = REFS_PER_FRAME + 1


class ObuType(enum.IntEnum):
    SEQ_HDR = 1
    TD = 2
    FRAME_HDR = 3
    TILE_GRP = 4
    METADATA = 5
    FRAME = 6
    REDUNDANT_FRAME_HDR = 7
    PADDING = 15


class TxfmMode(enum.IntEnum):
    ONLY_4X4 = 0
    LARGEST = 1
    SWITCHABLE = 2


class FilterMode(enum.IntEnum):
    REGULAR_8TAP = 0
    SMOOTH_8TAP = 1
    SHARP_8TAP = 2
    BILINEAR = 3
    SWITCHABLE = 4


N_SWITCHABLE_FILTERS = 3


class AdaptiveBoolean(enum.IntEnum):
    OFF = 0
    ON = 1
    ADAPTIVE = 2


class RestorationType(enum.IntEnum):
    NONE = 0
    SWITCHABLE = 1
    WIENER = 2
    SGRPROJ = 3


class WarpedMotionType(enum.IntEnum):
    IDENTITY = 0
    TRANSLATION = 1
    ROT_ZOOM = 2
    AFFINE = 3


class PixelLayout(enum.IntEnum):
    I400 = 0  # monochrome
    I420 = 1
    I422 = 2
    I444 = 3


class FrameType(enum.IntEnum):
    KEY = 0
    INTER = 1
    INTRA = 2
    SWITCH = 3

    @property
    def is_inter_or_switch(self) -> bool:
        # Inter-coded frame types have bit 0 set (spec convention the
        # reference also exploits: IS_INTER_OR_SWITCH, src/headers ordering).
        return bool(self.value & 1)

    @property
    def is_key_or_intra(self) -> bool:
        return not (self.value & 1)


class ChromaSamplePosition(enum.IntEnum):
    UNKNOWN = 0
    VERTICAL = 1
    COLOCATED = 2


@dataclass
class WarpedMotionParams:
    type: WarpedMotionType = WarpedMotionType.IDENTITY
    matrix: list[int] = field(
        default_factory=lambda: [0, 0, 1 << 16, 0, 0, 1 << 16]
    )
    # Shear params (alpha, beta, gamma, delta), valid for ROT_ZOOM/AFFINE.
    abcd: list[int] = field(default_factory=lambda: [0, 0, 0, 0])


@dataclass
class ContentLightLevel:
    max_content_light_level: int = 0
    max_frame_average_light_level: int = 0


@dataclass
class MasteringDisplay:
    primaries: list[tuple[int, int]] = field(default_factory=list)
    white_point: tuple[int, int] = (0, 0)
    max_luminance: int = 0
    min_luminance: int = 0


@dataclass
class ITUTT35:
    country_code: int = 0
    country_code_extension_byte: int = 0
    payload: bytes = b""


@dataclass
class OperatingPoint:
    major_level: int = 0
    minor_level: int = 0
    initial_display_delay: int = 0
    idc: int = 0
    tier: int = 0
    decoder_model_param_present: int = 0
    display_model_param_present: int = 0


@dataclass
class OperatingParameterInfo:
    decoder_buffer_delay: int = 0
    encoder_buffer_delay: int = 0
    low_delay_mode: int = 0


@dataclass
class SequenceHeader:
    """AV1 sequence header (spec 5.5; reference include/dav1d/headers.h:203)."""

    profile: int = 0
    max_width: int = 0
    max_height: int = 0
    layout: PixelLayout = PixelLayout.I420
    pri: int = 2  # color primaries, UNKNOWN
    trc: int = 2  # transfer characteristics, UNKNOWN
    mtrx: int = 2  # matrix coefficients, UNKNOWN
    chr: ChromaSamplePosition = ChromaSamplePosition.UNKNOWN
    hbd: int = 0  # 0/1/2 => 8/10/12 bits per component
    color_range: int = 0

    num_operating_points: int = 1
    operating_points: list[OperatingPoint] = field(default_factory=list)

    still_picture: int = 0
    reduced_still_picture_header: int = 0
    timing_info_present: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    equal_picture_interval: int = 0
    num_ticks_per_picture: int = 0
    decoder_model_info_present: int = 0
    encoder_decoder_buffer_delay_length: int = 0
    num_units_in_decoding_tick: int = 0
    buffer_removal_delay_length: int = 0
    frame_presentation_delay_length: int = 0
    display_model_info_present: int = 0
    width_n_bits: int = 0
    height_n_bits: int = 0
    frame_id_numbers_present: int = 0
    delta_frame_id_n_bits: int = 0
    frame_id_n_bits: int = 0
    sb128: int = 0
    filter_intra: int = 0
    intra_edge_filter: int = 0
    inter_intra: int = 0
    masked_compound: int = 0
    warped_motion: int = 0
    dual_filter: int = 0
    order_hint: int = 0
    jnt_comp: int = 0
    ref_frame_mvs: int = 0
    screen_content_tools: AdaptiveBoolean = AdaptiveBoolean.OFF
    force_integer_mv: AdaptiveBoolean = AdaptiveBoolean.OFF
    order_hint_n_bits: int = 0
    super_res: int = 0
    cdef: int = 0
    restoration: int = 0
    ss_hor: int = 1
    ss_ver: int = 1
    monochrome: int = 0
    color_description_present: int = 0
    separate_uv_delta_q: int = 0
    film_grain_present: int = 0
    operating_parameter_info: list[OperatingParameterInfo] = field(
        default_factory=list
    )

    @property
    def bitdepth(self) -> int:
        return 8 + 2 * self.hbd

    @property
    def bitdepth_max(self) -> int:
        return (1 << self.bitdepth) - 1

    def equal_binary_content(self, other: "SequenceHeader") -> bool:
        """Sequence-change detection ignoring operating_parameter_info
        (spec 7.5 ordering-of-OBUs rule; reference src/obu.c:1243)."""
        a = {k: v for k, v in self.__dict__.items() if k != "operating_parameter_info"}
        b = {k: v for k, v in other.__dict__.items() if k != "operating_parameter_info"}
        return a == b


@dataclass
class SegmentationData:
    delta_q: int = 0
    delta_lf_y_v: int = 0
    delta_lf_y_h: int = 0
    delta_lf_u: int = 0
    delta_lf_v: int = 0
    ref: int = -1
    skip: int = 0
    globalmv: int = 0


@dataclass
class SegmentationDataSet:
    d: list[SegmentationData] = field(
        default_factory=lambda: [SegmentationData() for _ in range(MAX_SEGMENTS)]
    )
    preskip: int = 0
    last_active_segid: int = -1


@dataclass
class LoopfilterModeRefDeltas:
    mode_delta: list[int] = field(default_factory=lambda: [0, 0])
    ref_delta: list[int] = field(
        default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1]
    )


@dataclass
class FilmGrainData:
    seed: int = 0
    num_y_points: int = 0
    y_points: list[tuple[int, int]] = field(default_factory=list)
    chroma_scaling_from_luma: int = 0
    num_uv_points: list[int] = field(default_factory=lambda: [0, 0])
    uv_points: list[list[tuple[int, int]]] = field(
        default_factory=lambda: [[], []]
    )
    scaling_shift: int = 0
    ar_coeff_lag: int = 0
    ar_coeffs_y: list[int] = field(default_factory=list)
    ar_coeffs_uv: list[list[int]] = field(default_factory=lambda: [[], []])
    ar_coeff_shift: int = 0
    grain_scale_shift: int = 0
    uv_mult: list[int] = field(default_factory=lambda: [0, 0])
    uv_luma_mult: list[int] = field(default_factory=lambda: [0, 0])
    uv_offset: list[int] = field(default_factory=lambda: [0, 0])
    overlap_flag: int = 0
    clip_to_restricted_range: int = 0


@dataclass
class TilingInfo:
    uniform: int = 1
    n_bytes: int = 0
    min_log2_cols: int = 0
    max_log2_cols: int = 0
    log2_cols: int = 0
    cols: int = 1
    min_log2_rows: int = 0
    max_log2_rows: int = 0
    log2_rows: int = 0
    rows: int = 1
    col_start_sb: list[int] = field(default_factory=list)
    row_start_sb: list[int] = field(default_factory=list)
    update: int = 0


@dataclass
class QuantInfo:
    yac: int = 0
    ydc_delta: int = 0
    udc_delta: int = 0
    uac_delta: int = 0
    vdc_delta: int = 0
    vac_delta: int = 0
    qm: int = 0
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0


@dataclass
class SegmentationInfo:
    enabled: int = 0
    update_map: int = 0
    temporal: int = 0
    update_data: int = 0
    seg_data: SegmentationDataSet = field(default_factory=SegmentationDataSet)
    lossless: list[int] = field(default_factory=lambda: [0] * MAX_SEGMENTS)
    qidx: list[int] = field(default_factory=lambda: [0] * MAX_SEGMENTS)


@dataclass
class DeltaInfo:
    q_present: int = 0
    q_res_log2: int = 0
    lf_present: int = 0
    lf_res_log2: int = 0
    lf_multi: int = 0


@dataclass
class LoopfilterInfo:
    level_y: list[int] = field(default_factory=lambda: [0, 0])
    level_u: int = 0
    level_v: int = 0
    mode_ref_delta_enabled: int = 1
    mode_ref_delta_update: int = 0
    mode_ref_deltas: LoopfilterModeRefDeltas = field(
        default_factory=LoopfilterModeRefDeltas
    )
    sharpness: int = 0


@dataclass
class CdefInfo:
    damping: int = 3
    n_bits: int = 0
    y_strength: list[int] = field(default_factory=lambda: [0] * MAX_CDEF_STRENGTHS)
    uv_strength: list[int] = field(default_factory=lambda: [0] * MAX_CDEF_STRENGTHS)


@dataclass
class RestorationInfo:
    type: list[RestorationType] = field(
        default_factory=lambda: [RestorationType.NONE] * 3
    )
    unit_size: list[int] = field(default_factory=lambda: [8, 8])  # log2, y then uv


@dataclass
class FilmGrainInfo:
    data: FilmGrainData = field(default_factory=FilmGrainData)
    present: int = 0
    update: int = 0


@dataclass
class FrameHeader:
    """AV1 frame header (spec 5.9; reference include/dav1d/headers.h:335)."""

    film_grain: FilmGrainInfo = field(default_factory=FilmGrainInfo)
    frame_type: FrameType = FrameType.KEY
    width: list[int] = field(default_factory=lambda: [0, 0])  # coded, superres-upscaled
    height: int = 0
    frame_offset: int = 0
    temporal_id: int = 0
    spatial_id: int = 0

    show_existing_frame: int = 0
    existing_frame_idx: int = -1
    frame_id: int = 0
    frame_presentation_delay: int = 0
    show_frame: int = 0
    showable_frame: int = 0
    error_resilient_mode: int = 0
    disable_cdf_update: int = 0
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 0
    frame_size_override: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    buffer_removal_time_present: int = 0
    operating_points: list[int] = field(default_factory=list)  # buffer_removal_time
    refresh_frame_flags: int = 0
    render_width: int = 0
    render_height: int = 0
    super_res_width_scale_denominator: int = 8
    super_res_enabled: int = 0
    have_render_size: int = 0
    allow_intrabc: int = 0
    frame_ref_short_signaling: int = 0
    refidx: list[int] = field(default_factory=lambda: [-1] * REFS_PER_FRAME)
    hp: int = 0
    subpel_filter_mode: FilterMode = FilterMode.REGULAR_8TAP
    switchable_motion_mode: int = 0
    use_ref_frame_mvs: int = 0
    refresh_context: int = 0
    tiling: TilingInfo = field(default_factory=TilingInfo)
    quant: QuantInfo = field(default_factory=QuantInfo)
    segmentation: SegmentationInfo = field(default_factory=SegmentationInfo)
    delta: DeltaInfo = field(default_factory=DeltaInfo)
    all_lossless: int = 0
    loopfilter: LoopfilterInfo = field(default_factory=LoopfilterInfo)
    cdef: CdefInfo = field(default_factory=CdefInfo)
    restoration: RestorationInfo = field(default_factory=RestorationInfo)
    txfm_mode: TxfmMode = TxfmMode.ONLY_4X4
    switchable_comp_refs: int = 0
    skip_mode_allowed: int = 0
    skip_mode_enabled: int = 0
    skip_mode_refs: list[int] = field(default_factory=lambda: [-1, -1])
    warp_motion: int = 0
    reduced_txtp_set: int = 0
    gmv: list[WarpedMotionParams] = field(
        default_factory=lambda: [WarpedMotionParams() for _ in range(REFS_PER_FRAME)]
    )
