"""AV1 enum orderings and block model.

The numeric orderings are normative (they index CDFs and LUTs); they follow
the AV1 spec and match the reference's src/levels.h:36-260.
"""

from __future__ import annotations

import enum


class TxfmSize(enum.IntEnum):
    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3
    TX_64X64 = 4


N_TX_SIZES = 5


class BlockLevel(enum.IntEnum):
    BL_128X128 = 0
    BL_64X64 = 1
    BL_32X32 = 2
    BL_16X16 = 3
    BL_8X8 = 4


N_BL_LEVELS = 5

# Rectangular transform sizes extend TxfmSize.
RTX_4X8 = 5
RTX_8X4 = 6
RTX_8X16 = 7
RTX_16X8 = 8
RTX_16X32 = 9
RTX_32X16 = 10
RTX_32X64 = 11
RTX_64X32 = 12
RTX_4X16 = 13
RTX_16X4 = 14
RTX_8X32 = 15
RTX_32X8 = 16
RTX_16X64 = 17
RTX_64X16 = 18
N_RECT_TX_SIZES = 19


class TxfmType(enum.IntEnum):
    DCT_DCT = 0
    ADST_DCT = 1
    DCT_ADST = 2
    ADST_ADST = 3
    FLIPADST_DCT = 4
    DCT_FLIPADST = 5
    FLIPADST_FLIPADST = 6
    ADST_FLIPADST = 7
    FLIPADST_ADST = 8
    IDTX = 9
    V_DCT = 10
    H_DCT = 11
    V_ADST = 12
    H_ADST = 13
    V_FLIPADST = 14
    H_FLIPADST = 15
    WHT_WHT = 16


N_TX_TYPES = 16
N_TX_TYPES_PLUS_LL = 17


class TxClass(enum.IntEnum):
    TWO_D = 0
    H = 1
    V = 2


class IntraPredMode(enum.IntEnum):
    DC_PRED = 0
    VERT_PRED = 1
    HOR_PRED = 2
    DIAG_DOWN_LEFT_PRED = 3
    DIAG_DOWN_RIGHT_PRED = 4
    VERT_RIGHT_PRED = 5
    HOR_DOWN_PRED = 6
    HOR_UP_PRED = 7
    VERT_LEFT_PRED = 8
    SMOOTH_PRED = 9
    SMOOTH_V_PRED = 10
    SMOOTH_H_PRED = 11
    PAETH_PRED = 12
    CFL_PRED = 13  # uv only
    # implementation-internal modes (reference src/levels.h:125-131)
    LEFT_DC_PRED = 3
    TOP_DC_PRED = 4
    DC_128_PRED = 5
    Z1_PRED = 6
    Z2_PRED = 7
    Z3_PRED = 8
    FILTER_PRED = 13


N_INTRA_PRED_MODES = 13
N_UV_INTRA_PRED_MODES = 14
N_IMPL_INTRA_PRED_MODES = 14


class InterIntraPredMode(enum.IntEnum):
    II_DC_PRED = 0
    II_VERT_PRED = 1
    II_HOR_PRED = 2
    II_SMOOTH_PRED = 3


N_INTER_INTRA_PRED_MODES = 4


class BlockPartition(enum.IntEnum):
    NONE = 0
    H = 1
    V = 2
    SPLIT = 3
    T_TOP_SPLIT = 4
    T_BOTTOM_SPLIT = 5
    T_LEFT_SPLIT = 6
    T_RIGHT_SPLIT = 7
    H4 = 8
    V4 = 9


N_PARTITIONS = 10
N_SUB8X8_PARTITIONS = 4


class BlockSize(enum.IntEnum):
    BS_128x128 = 0
    BS_128x64 = 1
    BS_64x128 = 2
    BS_64x64 = 3
    BS_64x32 = 4
    BS_64x16 = 5
    BS_32x64 = 6
    BS_32x32 = 7
    BS_32x16 = 8
    BS_32x8 = 9
    BS_16x64 = 10
    BS_16x32 = 11
    BS_16x16 = 12
    BS_16x8 = 13
    BS_16x4 = 14
    BS_8x32 = 15
    BS_8x16 = 16
    BS_8x8 = 17
    BS_8x4 = 18
    BS_4x16 = 19
    BS_4x8 = 20
    BS_4x4 = 21


N_BS_SIZES = 22


class Filter2d(enum.IntEnum):  # order: horizontal, vertical
    REGULAR = 0
    REGULAR_SMOOTH = 1
    REGULAR_SHARP = 2
    SHARP_REGULAR = 3
    SHARP_SMOOTH = 4
    SHARP = 5
    SMOOTH_REGULAR = 6
    SMOOTH = 7
    SMOOTH_SHARP = 8
    BILINEAR = 9


N_2D_FILTERS = 10


class MVJoint(enum.IntEnum):
    ZERO = 0
    H = 1
    V = 2
    HV = 3


N_MV_JOINTS = 4


class InterPredMode(enum.IntEnum):
    NEARESTMV = 0
    NEARMV = 1
    GLOBALMV = 2
    NEWMV = 3


N_INTER_PRED_MODES = 4


class CompInterPredMode(enum.IntEnum):
    NEARESTMV_NEARESTMV = 0
    NEARMV_NEARMV = 1
    NEARESTMV_NEWMV = 2
    NEWMV_NEARESTMV = 3
    NEARMV_NEWMV = 4
    NEWMV_NEARMV = 5
    GLOBALMV_GLOBALMV = 6
    NEWMV_NEWMV = 7


N_COMP_INTER_PRED_MODES = 8


class CompInterType(enum.IntEnum):
    NONE = 0
    WEIGHTED_AVG = 1
    AVG = 2
    SEG = 3
    WEDGE = 4


class InterIntraType(enum.IntEnum):
    NONE = 0
    BLEND = 1
    WEDGE = 2


class MotionMode(enum.IntEnum):
    TRANSLATION = 0
    OBMC = 1
    WARP = 2


QINDEX_RANGE = 256

# CFL / wedge / interintra allowed block-size masks
# (reference src/tables.h:70-103)
CFL_ALLOWED_MASK = (
    (1 << BlockSize.BS_32x32) | (1 << BlockSize.BS_32x16)
    | (1 << BlockSize.BS_32x8) | (1 << BlockSize.BS_16x32)
    | (1 << BlockSize.BS_16x16) | (1 << BlockSize.BS_16x8)
    | (1 << BlockSize.BS_16x4) | (1 << BlockSize.BS_8x32)
    | (1 << BlockSize.BS_8x16) | (1 << BlockSize.BS_8x8)
    | (1 << BlockSize.BS_8x4) | (1 << BlockSize.BS_4x16)
    | (1 << BlockSize.BS_4x8) | (1 << BlockSize.BS_4x4)
)
WEDGE_ALLOWED_MASK = (
    (1 << BlockSize.BS_32x32) | (1 << BlockSize.BS_32x16)
    | (1 << BlockSize.BS_32x8) | (1 << BlockSize.BS_16x32)
    | (1 << BlockSize.BS_16x16) | (1 << BlockSize.BS_16x8)
    | (1 << BlockSize.BS_8x32) | (1 << BlockSize.BS_8x16)
    | (1 << BlockSize.BS_8x8)
)
INTERINTRA_ALLOWED_MASK = (
    (1 << BlockSize.BS_32x32) | (1 << BlockSize.BS_32x16)
    | (1 << BlockSize.BS_16x32) | (1 << BlockSize.BS_16x16)
    | (1 << BlockSize.BS_16x8) | (1 << BlockSize.BS_8x16)
    | (1 << BlockSize.BS_8x8)
)
